"""The port's metric plane against the JAX package's, on the host: the
sinks, the async writer's drop policy and host reduction, the meters, the
throughput arithmetic, the card's peak and the run manifest, all fed the
same inputs in both packages; then a tiny ``fit`` with ``log_dir``.

Tolerances: none. The same records, strings and seeded numbers go
through both packages, and every line, string and float is held equal.
"""

import dataclasses
import io
import json
import os
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from mercury_tpu.config import TrainConfig as JConfig  # noqa: E402
from mercury_tpu.obs import accounting as jacc  # noqa: E402
from mercury_tpu.obs import aggregate as jagg  # noqa: E402
from mercury_tpu.obs import manifest as jman  # noqa: E402
from mercury_tpu.obs import writer as jw  # noqa: E402
from mercury_tpu.parallel.mesh import host_cpu_mesh  # noqa: E402
from mercury_tpu.utils import meters as jmeters  # noqa: E402
from mercury_tpu_torch import TrainConfig, Trainer  # noqa: E402
from mercury_tpu_torch.models.resnet import BasicBlock, ResNet, init_weights  # noqa: E402
from mercury_tpu_torch.obs import accounting as tacc  # noqa: E402
from mercury_tpu_torch.obs import manifest as tman  # noqa: E402
from mercury_tpu_torch.obs import writer as tw  # noqa: E402
from mercury_tpu_torch.utils import meters as tmeters  # noqa: E402

PORT_FIELDS = {f.name for f in dataclasses.fields(TrainConfig)}


def _records(n=6, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        rec = {"step": 10 * (i + 1), "time": 1000.0 + i, "epoch": float(i // 3),
               "train/loss": float(rng.random() * 3), "train/acc": float(rng.random()),
               "perf/steps_per_s": float(rng.random() * 100),
               "perf/mfu": float(rng.random() * 0.05), "sampler/ess": float(rng.random()),
               "time/step": float(rng.random() * 0.02), "threads/alive": 7.0,
               "data/stall_s": float(rng.random() * 1e-3)}
        if i % 2:
            rec["obs/dropped"] = float(i)
        out.append(rec)
    return out


def test_jsonl_sinks_write_identical_lines(tmp_path):
    lines = {}
    for name, mod in (("jax", jw), ("port", tw)):
        sink = mod.JsonlSink(str(tmp_path / name), filename="m.jsonl", flush_every=4)
        for rec in _records():
            sink.write(rec)
        sink.close()
        sink.close()
        lines[name] = (tmp_path / name / "m.jsonl").read_text()
    assert lines["jax"] == lines["port"] and lines["port"].count("\n") == 6


def test_heartbeat_sink_prints_identical_lines():
    out = {}
    for name, mod in (("jax", jw), ("port", tw)):
        buf = io.StringIO()
        sink = mod.HeartbeatSink(every_steps=20, min_interval_s=0.0, stream=buf)
        for rec in _records():
            sink.write(rec)
        out[name] = buf.getvalue()
    assert out["jax"] == out["port"] and out["port"].count("\n") == 4
    assert tw.HeartbeatSink._KEYS == jw.HeartbeatSink._KEYS


def test_heartbeat_shard_sink_rotates_as_jax(tmp_path):
    files = {}
    for name, mod in (("jax", jw), ("port", tw)):
        d = tmp_path / name
        sink = mod.HeartbeatShardSink(str(d), 3, max_bytes=300)
        for rec in _records(12):
            sink.write(rec)
        rotations = sink.rotations
        sink.close()
        files[name] = (rotations, {p: (d / p).read_text() for p in sorted(os.listdir(d))})
    assert files["jax"] == files["port"]
    rotations, contents = files["port"]
    assert rotations >= 2 and set(contents) == {"heartbeat.h3.jsonl", "heartbeat.h3.jsonl.1"}
    assert tw.heartbeat_shard_filename(3) == jagg.heartbeat_shard_filename(3)
    assert tw.shard_filename(3) == jagg.shard_filename(3)


def test_tensorboard_sink_reads_back_as_jax(tmp_path):
    """One summary event a record reads back as the JAX sink's event a
    tag: the same tags, steps and values."""
    accumulator = pytest.importorskip(
        "tensorboard.backend.event_processing.event_accumulator")
    scalars = {}
    for name, mod in (("jax", jw), ("port", tw)):
        sink = mod.try_tensorboard_sink(str(tmp_path / name))
        assert sink is not None
        for rec in _records():
            sink.write(rec)
        sink.flush()
        sink.close()
        events = accumulator.EventAccumulator(str(tmp_path / name))
        events.Reload()
        scalars[name] = {tag: [(e.step, e.value) for e in events.Scalars(tag)]
                         for tag in events.Tags()["scalars"]}
    assert scalars["jax"] == scalars["port"]
    assert len(scalars["port"]) == 10 and len(scalars["port"]["train/loss"]) == 6


class _Blocked:
    """A sink whose first write blocks until released."""

    def __init__(self):
        self.entered, self.release = threading.Event(), threading.Event()
        self.records = []

    def write(self, record):
        self.entered.set()
        self.release.wait(10)
        self.records.append(record)

    def close(self):
        pass


@pytest.mark.parametrize("capacity,writes", [(1, 5), (3, 9)])
def test_writer_drops_the_oldest_as_jax(capacity, writes):
    """One record in flight in a blocked sink, then ``writes`` more into a
    queue of ``capacity``: the same records dropped and counted."""
    seen = {}
    for name, mod in (("jax", jw), ("port", tw)):
        sink = _Blocked()
        writer = mod.AsyncMetricWriter([sink], capacity=capacity)
        writer.write(0, {"x": 0.0})
        assert sink.entered.wait(10)
        for i in range(1, writes + 1):
            writer.write(i, {"x": float(i)})
        depth = writer.queue_depth()
        sink.release.set()
        writer.flush()
        writer.close()
        seen[name] = (writer.dropped, depth, [(r["step"], r.get("obs/dropped"))
                                              for r in sink.records])
    assert seen["jax"] == seen["port"]
    assert seen["port"][0] == writes - capacity


def test_writer_observers_latest_record_and_close():
    got = []
    writer = tw.AsyncMetricWriter([], capacity=4, start=False)
    writer.add_observer(lambda rec: got.append(rec["step"]))
    writer.write(5, {"a": torch.tensor(2.0)})
    assert writer.latest_record() is None and writer.queue_depth() == 1
    writer.flush()
    assert got == [5] and writer.latest_record()["a"] == 2.0
    writer.close()
    assert not writer.add_observer(print)
    writer.write(6, {"a": 1.0})  # after close: ignored
    assert writer.queue_depth() == 0


@pytest.mark.parametrize("dtype", ["float32", "int32"])
def test_host_record_reduces_a_series_to_its_mean(dtype):
    rng = np.random.default_rng(7)
    series = (rng.standard_normal(37) * 100).astype(dtype)
    scalars = {"s": series, "c": np.asarray(3.25, np.float32)}
    want = jw._to_host_record(4, 1.5, {k: jnp.asarray(v) for k, v in scalars.items()})
    got = tw._to_host_record(4, 1.5, {k: torch.from_numpy(v) for k, v in scalars.items()})
    assert got == want
    assert tw._to_host_record(4, 1.5, {"p": 0.5, "e": 2}) == jw._to_host_record(
        4, 1.5, {"p": 0.5, "e": 2})


def test_meters_match_jax():
    rng = np.random.default_rng(3)
    values = rng.standard_normal(50).astype(np.float32)
    numbers = rng.integers(1, 5, 50)
    for cls in ("Average", "EMAverage"):
        j, t = getattr(jmeters, cls)(), getattr(tmeters, cls)()
        for v, n in zip(values, numbers):
            j.update(v, int(n))
            t.update(torch.tensor(v), int(n))
        assert (j.average, str(j)) == (t.average, str(t))
        j.reset()
        t.reset()
        assert j.average == t.average == 0.0
    logits = rng.standard_normal((64, 10)).astype(np.float32)
    targets = rng.integers(0, 10, 64)
    ja, ta = jmeters.Accuracy(), tmeters.Accuracy()
    ja.update(logits, targets)
    ta.update(torch.from_numpy(logits), torch.from_numpy(targets))
    ja.update_counts(5, 9)
    ta.update_counts(torch.tensor(5), 9)
    assert (ja.accuracy, str(ja)) == (ta.accuracy, str(ta))


def test_throughput_meter_matches_jax():
    j = jacc.ThroughputMeter(examples_per_step=128, flops_per_step=4.6e11)
    t = tacc.ThroughputMeter(examples_per_step=128, flops_per_step=4.6e11)
    assert j.peak is None and t.peak is None
    for m in (j, t):
        m.reset(10, now=100.0)
    for step, now in ((20, 100.37), (30, 101.0), (30, 101.5), (55, 103.25)):
        assert j.tick(step, now=now) == t.tick(step, now=now)
    fresh = (jacc.ThroughputMeter(32, device_kind="cpu"), tacc.ThroughputMeter(32))
    assert fresh[0].tick(1, now=1.0) == fresh[1].tick(1, now=1.0) == {}
    assert fresh[0].tick(3, now=2.0) == fresh[1].tick(3, now=2.0)


def test_peak_flops_is_the_h100s():
    assert tacc.peak_flops("NVIDIA H100 80GB HBM3") == 989.4e12
    for name in (None, "", "cpu", "NVIDIA H100 PCIe", "TPU v5 lite", "NVIDIA A100-SXM4-80GB"):
        assert tacc.peak_flops(name) is None
    meter = tacc.ThroughputMeter(32, flops_per_step=4.6e11,
                                 device_kind="NVIDIA H100 80GB HBM3")
    meter.reset(0, now=0.0)
    assert meter.tick(50, now=1.0)["perf/mfu"] == pytest.approx(50 * 4.6e11 / 989.4e12)


def test_manifest_keys_match_jax(tmp_path):
    cfg = TrainConfig(dataset="synthetic", world_size=1, seed=7)
    jcfg = JConfig(**{f: getattr(cfg, f) for f in PORT_FIELDS})
    want = jman.build_run_manifest(jcfg, host_cpu_mesh(1))
    got = tman.build_run_manifest(cfg, "cpu")
    assert set(got) - {"torch_version", "cuda_version"} == (
        set(want) - {"jax_version", "jaxlib_version"})
    assert got["config"] == dataclasses.asdict(cfg)
    for key in ("schema", "run_name", "process_index", "process_count", "platform",
                "mesh_shape", "mesh_axis_names", "peak_flops", "git_sha"):
        assert got[key] == want[key], key
    assert got["device_kind"] is None and got["torch_version"] == torch.__version__
    path = tman.write_run_manifest(str(tmp_path), cfg, "cpu")
    on_disk = json.loads(open(path).read())
    assert on_disk["config"] == json.loads(json.dumps(dataclasses.asdict(cfg), default=str))


def test_fit_with_log_dir_streams_a_record_a_tick(tmp_path, capsys):
    """Six steps, a log tick every 2 and a heartbeat every 2: three records
    at steps 2, 4 and 6 with the ``perf/*`` keys in ``metrics.jsonl`` and
    rank 0's shard, the manifest, the heartbeat shard and lines; no writer
    thread after ``close()``: neither this Trainer's writer thread nor any
    other it started (a drain thread an earlier test of the same process
    left running is not this one's)."""
    before = {t for t in threading.enumerate() if t.name == "mercury-metrics"}
    log_dir = str(tmp_path / "run")
    model = ResNet([1, 1], BasicBlock, num_classes=10, num_filters=8)
    init_weights(model, torch.Generator().manual_seed(0))
    cfg = TrainConfig(dataset="synthetic", world_size=1, batch_size=4, presample_batches=4,
                      compute_dtype="float32", num_epochs=1, steps_per_epoch=6,
                      eval_every=0, log_every=2, heartbeat_every=2, seed=0, log_dir=log_dir)
    with Trainer(cfg, device="cpu", model=model) as tr:
        out = tr.fit()
        flops = tr._throughput.flops_per_step
        drain = tr.logger._thread
    assert np.isfinite(out["train/loss"]) and flops > 0
    assert drain is not None and drain.name == "mercury-metrics" and not drain.is_alive()
    assert not [t for t in threading.enumerate()
                if t.name == "mercury-metrics" and t not in before]
    assert set(os.listdir(log_dir)) >= {"run_manifest.json", "metrics.jsonl",
                                         "metrics.h0.jsonl", "heartbeat.h0.jsonl"}
    manifest = json.load(open(os.path.join(log_dir, "run_manifest.json")))
    assert manifest["config"]["log_dir"] == log_dir and manifest["platform"] == "cpu"
    for name in ("metrics.jsonl", "metrics.h0.jsonl"):
        records = [json.loads(line) for line in open(os.path.join(log_dir, name))]
        assert [r["step"] for r in records] == [2, 4, 6], name
        for r in records:
            assert {"perf/steps_per_s", "perf/examples_per_s", "perf/flops_per_step",
                    "perf/mfu", "time/step", "threads/alive", "epoch",
                    "threads/queue_depth/metrics", "train/loss", "sampler/ess"} <= set(r)
            assert r["perf/mfu"] == 0.0 and r["perf/flops_per_step"] == flops
            assert r["perf/examples_per_s"] == pytest.approx(4 * r["perf/steps_per_s"])
            assert "sampler/probs" not in r and "sampler/selected" not in r
    beats = [json.loads(line) for line in open(os.path.join(log_dir, "heartbeat.h0.jsonl"))]
    assert [b["step"] for b in beats] == [2, 4, 6]
    assert "step 2  epoch 0  loss " in capsys.readouterr().out
