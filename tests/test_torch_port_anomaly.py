"""The port's anomaly engine (``mercury_tpu_torch/obs/anomaly.py``) against
the JAX package's (``mercury_tpu/obs/anomaly.py``), and its place in the
port's Trainer.

Each sequence of records and step times goes through both engines with the
same settings: the same triggers in the same order, the same counts, the
same ``anomaly/triggers`` on the records, the same journal rows and the
same flight-record files with the same keys (a dump's clock readings, the
device statistics and the spans apart). The cooldown debounces dumps, not
counts; ``max_dumps`` caps the files; a trigger arms one profiler request.
In the port ``device_memory_stats`` is ``{}`` on the CPU, the profiler
window a trigger opens writes a trace, and the Trainer builds the engine
with the ``slo_*`` fields as the JAX Trainer does.
"""

import json
import math
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from mercury_tpu.obs import anomaly as janomaly  # noqa: E402
from mercury_tpu.obs import events as jevents  # noqa: E402
from mercury_tpu_torch import TrainConfig, Trainer  # noqa: E402
from mercury_tpu_torch.data import cifar  # noqa: E402
from mercury_tpu_torch.data.pipeline import make_sharded_dataset  # noqa: E402
from mercury_tpu_torch.obs import anomaly, events  # noqa: E402
from mercury_tpu_torch.train.profile import ProfilerWindow  # noqa: E402
from test_torch_port_ranks import tiny_resnet  # noqa: E402

NAN, INF = float("nan"), float("inf")
B, N_TRAIN = 4, 48
ARMED = dict(ring_steps=4, slow_step_factor=3.0, ess_floor=0.3, stall_frac_max=0.25,
             mfu_floor=0.01, straggler_factor=2.0, gini_max=0.6, starved_classes=1.0,
             var_ratio_patience=2, cooldown_steps=3, max_dumps=4, profile_steps=5)
HIST = {f"sampler_dist/w_hist/b{i:02d}": float(i) for i in range(3)}


def _rec(step, t=None, **kv):
    out = {"step": step, "time": float(step) if t is None else t}
    out.update({k.replace("__", "/"): v for k, v in kv.items()})
    return out


SEQUENCES = {
    "non_finite": [_rec(1, train__loss=1.0), _rec(2, train__loss=NAN),
                   _rec(3, train__grad_norm=INF, train__loss=1.0), _rec(4, train__loss=2.0)],
    "ess_and_mfu": [_rec(1, sampler__ess=0.9, perf__mfu=0.0),
                    _rec(2, sampler__ess=0.1, perf__mfu=0.005),
                    _rec(6, sampler__ess=0.5, perf__mfu=0.02)],
    "stall": [_rec(1, t=10.0, data__stall_s=0.0), _rec(2, t=12.0, data__stall_s=1.0),
              _rec(3, t=14.0, data__stall_s=0.2), _rec(8, t=15.0, data__stall_s=0.5)],
    "straggler": [_rec(1, host__straggler_ratio=1.5),
                  _rec(2, host__straggler_ratio=3.0, host__reporting=4.0,
                       host__max__step_time_s=0.3)],
    "sampler_health": [
        _rec(1, sampler_dist__gini=0.7, sampler_dist__frac_never_selected=0.2, **{
            k.replace("/", "__"): v for k, v in HIST.items()}),
        _rec(5, sampler_dist__class_starved=2.0, sampler_dist__class_share_min=0.01),
        _rec(9, sampler_dist__var_ratio=1.2), _rec(10, sampler_dist__var_ratio=-1.0),
        _rec(11, sampler_dist__var_ratio=1.5), _rec(12, sampler_dist__var_ratio=0.5),
        _rec(13, sampler_dist__var_ratio=1.1), _rec(14, sampler_dist__var_ratio=1.1)],
    "cooldown_and_cap": [_rec(s, train__loss=NAN) for s in (1, 2, 4, 5, 8, 12, 16, 20, 24)],
}
STEP_TIMES = [0.1] * 20 + [0.5, 0.1, 0.09, 0.6] + [0.1] * 12 + [0.45]


def _drive(mod, ev_mod, directory, kind, seq):
    journal = ev_mod.EventJournal(str(directory), 0)
    eng = mod.AnomalyEngine(**ARMED, dump_dir=str(directory / "dumps"), journal=journal,
                            context_fn=lambda: {"config": {"seed": 0}})
    out = []
    if kind == "step_times":
        for i, dt in enumerate(STEP_TIMES):
            eng.observe_step_time(i + 1, dt)
            out.append(eng.take_profile_request())
    else:
        for rec in seq:
            rec = dict(rec)
            eng.observe_record(rec)
            out.append((rec.get("anomaly/triggers"), eng.take_profile_request()))
    journal.close()
    dumps = {}
    for path in eng.dumps:
        doc = json.load(open(path))
        for key in ("timestamp", "device_memory", "spans"):
            doc.pop(key)
        dumps[os.path.basename(path)] = doc
    rows = [{k: v for k, v in r.items() if k not in ("mono_ns", "wall_s")}
            for r in ev_mod.read_journal(journal.path)]
    for r in rows:
        if r["detail"].get("flight_record"):
            r["detail"]["flight_record"] = os.path.basename(r["detail"]["flight_record"])
    return dict(out=out, triggers=eng.triggers, counts=dict(eng.trigger_counts),
                dumps=dumps, ring=list(eng.ring), journal=rows,
                median=eng._median_s)


@pytest.mark.parametrize("kind", sorted(SEQUENCES) + ["step_times"])
def test_engine_matches_the_jax_package(kind, tmp_path):
    seq = SEQUENCES.get(kind)
    mine = _drive(anomaly, events, tmp_path / "port", kind, seq)
    theirs = _drive(janomaly, jevents, tmp_path / "jax", kind, seq)
    assert mine["triggers"] > 0 or kind == "never"
    # NaN != NaN: compare through JSON, where both are the token NaN.
    for key in ("out", "triggers", "counts", "ring", "journal", "median"):
        assert json.dumps(mine[key]) == json.dumps(theirs[key]), key
    assert sorted(mine["dumps"]) == sorted(theirs["dumps"])
    assert json.dumps(mine["dumps"], sort_keys=True) == json.dumps(theirs["dumps"],
                                                                   sort_keys=True)


def test_flight_record_keys_match(tmp_path):
    docs = []
    for mod, sub in ((anomaly, "port"), (janomaly, "jax")):
        eng = mod.AnomalyEngine(ring_steps=2, dump_dir=str(tmp_path / sub))
        eng.observe_record(_rec(3, train__loss=NAN))
        (path,) = eng.dumps
        assert os.path.basename(path) == "flight_record_step3_non_finite.json"
        docs.append(json.load(open(path)))
    assert set(docs[0]) == set(docs[1])
    assert docs[0]["schema"] == janomaly.FLIGHT_RECORD_SCHEMA == anomaly.FLIGHT_RECORD_SCHEMA
    assert docs[0]["spans"] == [] and docs[0]["device_memory"] == {}


def test_cooldown_max_dumps_and_no_dir(tmp_path):
    eng = anomaly.AnomalyEngine(ring_steps=4, cooldown_steps=100, dump_dir=str(tmp_path))
    for step in (1, 2, 3):
        eng.observe_record(_rec(step, train__loss=NAN))
    assert eng.triggers == 3 and len(eng.dumps) == 1   # debounced dumps, not counts
    capped = anomaly.AnomalyEngine(ring_steps=4, cooldown_steps=0, max_dumps=2,
                                   dump_dir=str(tmp_path / "cap"))
    for step in range(1, 6):
        capped.observe_record(_rec(step, train__loss=NAN))
    assert capped.triggers == 5 and len(os.listdir(tmp_path / "cap")) == 2
    bare = anomaly.AnomalyEngine(ring_steps=4)
    rec = _rec(1, train__loss=NAN)
    bare.observe_record(rec)
    assert bare.triggers == 1 and bare.dumps == [] and rec["anomaly/triggers"] == 1.0
    with pytest.raises(ValueError, match="ring_steps must be >= 1"):
        anomaly.AnomalyEngine(ring_steps=0)


def test_dump_failure_and_context_error_never_raise(tmp_path):
    blocker = tmp_path / "file"
    blocker.write_text("")
    eng = anomaly.AnomalyEngine(ring_steps=2, dump_dir=str(blocker / "sub"))
    assert eng.dump_flight_record("x", 1) is None

    def bad():
        raise KeyError("boom")

    eng = anomaly.AnomalyEngine(ring_steps=2, dump_dir=str(tmp_path / "d"), context_fn=bad)
    doc = json.load(open(eng.dump_flight_record("x", 1)))
    assert doc["context_error"] == "KeyError: 'boom'"


def test_device_memory_stats_on_the_cpu():
    assert anomaly.device_memory_stats() == {}


def test_profiler_window(tmp_path):
    win = ProfilerWindow(str(tmp_path))
    assert not win.active and win.start(2, step=7)
    assert not win.start(2, step=8)    # one window at a time
    torch.ones(4).sum()
    win.advance()
    assert win.active
    win.advance()
    assert not win.active
    (path,) = win.written
    assert path == os.path.join(tmp_path, "profile", "trace_step7.json")
    assert json.load(open(path))
    assert win.stop() is None
    assert not ProfilerWindow(None).start(3, step=1)


def _dataset():
    (x, y), (xt, yt) = cifar.synthetic_cifar(10, N_TRAIN, 8, seed=0)
    return make_sharded_dataset((x, y), (xt, yt), [np.arange(N_TRAIN)], cifar.CIFAR10_MEAN,
                                cifar.CIFAR10_STD, 10, device=torch.device("cpu"))


def _trainer(**kw) -> Trainer:
    base = dict(dataset="synthetic", world_size=1, batch_size=B, presample_batches=2,
                compute_dtype="float32", num_epochs=1, steps_per_epoch=10, eval_every=0,
                log_every=2, heartbeat_every=0, seed=0)
    return Trainer(TrainConfig(**{**base, **kw}), dataset=_dataset(), device="cpu",
                   model=tiny_resnet(seed=0))


def test_trainer_builds_the_engine_from_the_slo_fields(tmp_path):
    tr = _trainer(slo_ess_floor=0.2, slo_selection_gini_max=0.9, slo_class_starvation_share=0.1,
                  slo_var_ratio_patience=3, anomaly_window=5, anomaly_cooldown_steps=7,
                  anomaly_dir=str(tmp_path))
    try:
        eng = tr.anomaly
        assert (eng.ring.maxlen, eng.ess_floor, eng.gini_max, eng.starved_classes,
                eng.var_ratio_patience, eng.cooldown_steps, eng.mfu_floor,
                eng.straggler_factor, eng.dump_dir) == (
            5, 0.2, 0.9, 1.0, 3, 7, 0.01, 2.0, str(tmp_path))
        # The stall budget is the host stream's only.
        assert eng.stall_frac_max == 0.0
        assert tr.logger.observers == [eng.observe_record]
    finally:
        tr.close()
    off = _trainer(anomaly_detection=False)
    try:
        assert off.anomaly is None and off.logger.observers == []
    finally:
        off.close()


def test_a_trigger_opens_the_profiler_window(tmp_path):
    tr = _trainer(log_dir=str(tmp_path), anomaly_inject_nan_step=2, anomaly_profile_steps=2,
                  sampler="scoretable", refresh_size=8)
    try:
        tr.fit(steps=8)
        tr.logger.flush()
        assert tr.anomaly.trigger_counts == {"non_finite": 1}
        assert tr._profiler.written, os.listdir(tmp_path)
        assert os.path.dirname(tr._profiler.written[0]) == os.path.join(tmp_path, "profile")
    finally:
        tr.close()
    rows = events.read_journal(os.path.join(tmp_path, "events.h0.jsonl"))
    (row,) = [r for r in rows if r["kind"] == "anomaly/triggered"]
    assert row["detail"]["trigger"] == "non_finite" and not row["detail"]["debounced"]
    assert math.isnan(json.load(open(row["detail"]["flight_record"]))["ring"][-1]["train/loss"])
