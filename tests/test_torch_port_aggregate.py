"""Cross-rank aggregation (``mercury_tpu_torch/obs/aggregate.py``) against
the JAX package's (``mercury_tpu/obs/aggregate.py``).

- ``merge_host_stats`` and ``StragglerWindow`` give JAX's numbers for the
  same inputs (``==``: the same Python arithmetic).
- The same shard files (torn lines, a rotation, a rank without
  ``data/stall_s``) give the same ``host/*`` from both
  ``HostShardAggregator``\\ s, pass for pass.
- ``"auto"`` resolves as the JAX Trainer resolves it, with the world size
  in the place of the process count; an unknown mode raises JAX's message.
- Two gloo ranks gather through ``CrossHostGatherAggregator`` with
  ``data/stall_s`` missing on rank 1: rank 0's merges equal the JAX
  aggregator's, fed the float32 rows JAX's gather would give, and the
  gather does not hang (the spawn's timeout).
- Two gloo ranks ``fit`` with ``host_slow`` on rank 1 alone, under
  ``"allgather"`` and ``"files"``: rank 0's records carry the ``host/*``
  keys and a ``host/straggler_ratio`` above ``anomaly_straggler_factor``
  (1.5: at two ranks the ratio is below 2), and the straggler trigger fires
  on rank 0.
"""

import json
import math
import os
import struct

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from mercury_tpu.obs import aggregate as jagg  # noqa: E402
from mercury_tpu_torch.data import cifar  # noqa: E402
from mercury_tpu_torch.data.partition import partition_data  # noqa: E402
from mercury_tpu_torch.obs import aggregate as tagg  # noqa: E402
from mercury_tpu_torch.parallel.distributed import spawn  # noqa: E402
from test_torch_port_ranks import gather_rank, straggler_rank  # noqa: E402

SOURCES = ("time/step", "data/stall_s", "data/queue_depth")


def _records(seed, hosts=3, n=6, drop_stall_on=None):
    rng = np.random.default_rng(seed)
    out = {}
    for h in range(hosts):
        rows = []
        for i in range(n):
            rec = {"step": 10 * (i + 1), "time/step": float(rng.uniform(0.01, 0.2)),
                   "data/stall_s": float(rng.uniform(0, 0.01)),
                   "data/queue_depth": float(rng.integers(0, 3)), "note": "text"}
            if h == drop_stall_on:
                del rec["data/stall_s"]
            rows.append(rec)
        out[h] = rows
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_merge_and_straggler_window_equal_jax(seed):
    recs = _records(seed, drop_stall_on=1)
    latest = {h: {k: v for k, v in rows[-1].items() if k in SOURCES}
              for h, rows in recs.items()}
    assert tagg.merge_host_stats(latest) == jagg.merge_host_stats(latest)
    assert tagg.merge_host_stats({}) == jagg.merge_host_stats({})
    mine, theirs = tagg.StragglerWindow(4), jagg.StragglerWindow(4)
    for i in range(6):
        for h, rows in recs.items():
            for w in (mine, theirs):
                w.add(h, rows[i]["time/step"] * (3.0 if h == 2 else 1.0))
        assert mine.ratio() == theirs.ratio()
        assert mine.per_host_mean() == theirs.per_host_mean()
    for mod in (tagg, jagg):
        with pytest.raises(ValueError, match="window must be >= 1, got 0"):
            mod.StragglerWindow(0)


def _append(path, text):
    with open(path, "a") as f:
        f.write(text)


def test_shard_aggregators_equal_jax(tmp_path):
    recs = _records(3, drop_stall_on=1)
    port_dir, jax_dir = tmp_path / "a", tmp_path / "b"
    port_dir.mkdir()
    jax_dir.mkdir()
    mine = tagg.HostShardAggregator(str(port_dir), processes=3, window=3)
    theirs = jagg.HostShardAggregator(str(jax_dir), processes=3, window=3)
    assert mine.poll() == theirs.poll() == {}

    def write_all(text_of):
        for d in (port_dir, jax_dir):
            for h in range(3):
                _append(d / f"metrics.h{h}.jsonl", text_of(h))
            _append(d / "metrics.jsonl", "{}\n")   # not a shard

    for i in range(6):
        write_all(lambda h: json.dumps(recs[h][i]) + "\n")
        if i == 2:
            # A torn line: its tail arrives on the next pass.
            line = json.dumps({"time/step": 0.5, "data/queue_depth": 9.0})
            write_all(lambda h: line[:7] if h == 0 else "")
        if i == 3:
            write_all(lambda h: line[7:] + "\nnot json\n" if h == 0 else "")
        if i == 4:
            # Rank 2's shard rotated: replaced by a shorter file.
            for d in (port_dir, jax_dir):
                (d / "metrics.h2.jsonl").write_text(json.dumps(recs[2][i]) + "\n")
        rec_a, rec_b = {"step": i}, {"step": i}
        mine.observe_record(rec_a)
        theirs.observe_record(rec_b)
        assert rec_a == rec_b and "host/max/step_time_s" in rec_a, i
        assert mine.errors == theirs.errors
    assert mine.latest == theirs.latest


def test_host_time_feeds_the_port_straggler_window(tmp_path):
    """A record's ``time/host_s`` (the port Trainer's) takes the place of
    ``time/step`` in the window; the ``host/*`` merge is JAX's."""
    for h, host_s in ((0, 0.01), (1, 0.05)):
        (tmp_path / f"metrics.h{h}.jsonl").write_text(json.dumps(
            {"step": 2, "time/step": 0.1, "time/host_s": host_s}) + "\n")
    merged = tagg.HostShardAggregator(str(tmp_path)).poll()
    assert merged["host/spread/step_time_s"] == 0.0
    assert merged["host/straggler_ratio"] == 0.05 / ((0.01 + 0.05) / 2)


@pytest.mark.parametrize("mode,world,log_dir,want", [
    ("auto", 1, "d", "off"), ("auto", 2, "d", "files"), ("auto", 2, None, "off"),
    ("files", 1, "d", "files"), ("files", 4, None, "off"), ("allgather", 1, None, "allgather"),
    ("off", 4, "d", "off"),
])
def test_mode_resolves_as_the_jax_trainer(mode, world, log_dir, want):
    assert tagg.resolve_mode(mode, world, log_dir) == want


def test_unknown_mode_raises_the_jax_message():
    with pytest.raises(ValueError) as err:
        tagg.resolve_mode("gossip", 2, "d")
    assert str(err.value) == ("crosshost_telemetry='gossip': expected one of "
                              "'auto', 'off', 'files', 'allgather'")


def _f32(v):
    return struct.unpack("f", struct.pack("f", v))[0]


def test_two_rank_gather_with_a_missing_key_equals_jax(monkeypatch):
    rng = np.random.default_rng(5)
    rounds = []
    for _ in range(4):
        rounds.append([
            {"time/step": float(rng.uniform(0.01, 0.1)), "data/stall_s": float(rng.uniform()),
             "data/queue_depth": 2.0, "train/loss": torch.tensor(1.0)},
            {"time/step": float(rng.uniform(0.1, 0.3)), "data/queue_depth": 1.0},
        ])
    merged = spawn(gather_rank, 2, "gloo", rounds, timeout_s=120)
    assert all(m == {} for m in merged[1])

    fed = iter(rounds)

    def jax_gather(values):
        # JAX's gather: every process's dict, through float32.
        ranks = next(fed)
        return {p: {k: _f32(float(r[k])) for k in values if k in r or k == "time/step"}
                for p, r in enumerate(ranks)}

    monkeypatch.setattr(jagg, "allgather_host_stats", jax_gather)
    import jax

    monkeypatch.setattr(jax, "process_index", lambda: 0)
    theirs = jagg.CrossHostGatherAggregator(window=4)
    want = [theirs.update({k: v for k, v in r[0].items() if k in SOURCES}) for r in rounds]
    assert merged[0] == want
    assert "host/min/stall_s" in want[0] and want[0]["host/reporting"] == 2.0
    assert want[-1]["host/straggler_ratio"] > 1.0


def test_gather_failure_marks_unavailable():
    def broken(row):
        raise RuntimeError("no process group")

    agg = tagg.CrossHostGatherAggregator(gather=broken)
    assert agg.update({"time/step": 0.1}) == {} and agg.unavailable
    assert agg.update({"time/step": 0.1}) == {}
    assert math.isnan(tagg._host_value({"x": "text"}, "x"))


def test_two_rank_straggler_fires_on_rank_0(tmp_path):
    (x, y), (xt, yt) = cifar.synthetic_cifar(10, 64, 8, seed=0)
    shards = partition_data(y, 2, "hetero", alpha=0.5, seed=0, min_size=10)
    data = (x, y, xt, yt, shards, cifar.CIFAR10_MEAN, cifar.CIFAR10_STD)
    config_kw = dict(dataset="synthetic", world_size=2, batch_size=4, presample_batches=2,
                     compute_dtype="float32", num_epochs=1, steps_per_epoch=12,
                     eval_every=0, log_every=2, heartbeat_every=0, seed=0,
                     anomaly_straggler_factor=1.5, anomaly_cooldown_steps=1000)
    log_dirs = {mode: str(tmp_path / mode) for mode in ("allgather", "files")}
    out = spawn(straggler_rank, 2, "gloo", config_kw, data, 1,
                "host_slow@step=0,every=1,secs=0.1", 12, log_dirs, timeout_s=300)
    assert out[1] == {"allgather": None, "files": None}
    for mode, log_dir in log_dirs.items():
        assert out[0][mode].get("straggler", 0) >= 1, (mode, out[0][mode])
        records = [json.loads(line) for line in open(os.path.join(log_dir, "metrics.jsonl"))]
        ticks = [r for r in records if "host/reporting" in r]
        assert ticks, mode
        for key in ("host/min/step_time_s", "host/max/step_time_s",
                    "host/spread/step_time_s"):
            assert key in ticks[-1], (mode, key)
        assert max(r.get("host/straggler_ratio", 0.0) for r in ticks) > 1.5, mode
        shard1 = [json.loads(line) for line in open(os.path.join(log_dir, "metrics.h1.jsonl"))]
        assert all(r["time/host_s"] >= 0.1 for r in shard1 if "time/host_s" in r)
