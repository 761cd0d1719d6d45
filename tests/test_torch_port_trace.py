"""The port's span tracer (``mercury_tpu_torch/obs/trace.py``) against the
JAX package's (``mercury_tpu/obs/trace.py``), and the span sites of the
port's Trainer.

- The same spans, instants and thread names, under one patched clock and
  thread id, give equal Chrome documents (but for ``otherData.tracer``, the
  module's name) and equal drop counts; so do the journal lanes and the
  offline merge.
- Every span and instant name in the ``trace.json`` of CPU port fits (the
  host stream with eval, checkpoint and restore; the supervised async
  scorer past its budget, with the NaN injection's profiler window) is a
  name the JAX package's ``span(``/``instant(`` calls give, found by
  ``ast`` over ``mercury_tpu/``.
- Tracing on or off, a step runs the same ATen operators, and the flight
  record of a traced run carries the ring.

Tiny sizes: a [1, 1]-stage ResNet of width 8, batch 4.
"""

import ast
import json
import os
import pathlib
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from mercury_tpu.obs import trace as jtrace  # noqa: E402
from mercury_tpu_torch import TrainConfig, Trainer  # noqa: E402
from mercury_tpu_torch.data import cifar  # noqa: E402
from mercury_tpu_torch.data.pipeline import make_sharded_dataset  # noqa: E402
from mercury_tpu_torch.obs import trace as ttrace  # noqa: E402
from test_torch_port_ranks import tiny_resnet  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
B, R, N_TRAIN = 4, 8, 48
COMMON = dict(dataset="synthetic", world_size=1, batch_size=B, presample_batches=2,
              compute_dtype="float32", num_epochs=1, steps_per_epoch=8, eval_every=0,
              log_every=0, heartbeat_every=0, seed=0)

EVENTS = [
    {"event_id": "e0", "parent_id": None, "kind": "fault/fired", "step": 3,
     "wall_s": 1000.5, "host": 0, "detail": {"fault": "scorer_die"}},
    {"event_id": "e1", "parent_id": "e0", "kind": "supervisor/exhausted", "step": 4,
     "wall_s": 1000.75, "host": 0, "detail": {}},
    {"event_id": "e2", "parent_id": "e1", "kind": "supervisor/degrade", "step": 4,
     "wall_s": 1001.0, "host": 0, "detail": {"to": "sync"}},
    {"event_id": "e3", "parent_id": "missing", "kind": "anomaly/triggered", "step": 6,
     "wall_s": 1002.0, "host": 0, "detail": {"trigger": "non_finite"}},
]


@pytest.fixture
def fake_clock(monkeypatch):
    """One clock and thread id for both modules: perf_counter_ns counts
    1000 ns a call, time.time is fixed, get_ident follows ``tid``."""
    tick = iter(range(10**6))
    state = {"tid": 111}
    monkeypatch.setattr(time, "perf_counter_ns", lambda: 1000 * next(tick))
    monkeypatch.setattr(time, "time", lambda: 1000.0)
    monkeypatch.setattr(threading, "get_ident", lambda: state["tid"])
    return state


def _record(mod, capacity, fake_clock):
    """A fixed script of spans, nested spans, instants and thread names."""
    tracer = mod.SpanTracer(capacity)
    fake_clock["tid"] = 111
    tracer.register_thread("train")
    with tracer.span("trainer/dispatch", cat="trainer"):
        with tracer.span("trainer/log_gate", cat="trainer", step=2):
            pass
    tracer.instant("profiler/start", cat="trainer", steps=3)
    fake_clock["tid"] = 222
    tracer.register_thread("prefetch")
    with tracer.span("stream/gather", cat="stream", rows=12):
        pass
    with pytest.raises(RuntimeError):
        with tracer.span("stream/h2d", cat="stream", bytes=4096):
            raise RuntimeError("a span that died mid-body still records")
    fake_clock["tid"] = 111
    tracer.instant("anomaly/non_finite", cat="anomaly", step=4)
    for i in range(3):
        with tracer.span("fleet/chunk", cat="scorer", tenant=i):
            pass
    return tracer


def _same_doc(port_doc, jax_doc):
    assert port_doc["otherData"].pop("tracer") == "mercury_tpu_torch.obs.trace"
    assert jax_doc["otherData"].pop("tracer") == "mercury_tpu.obs.trace"
    assert port_doc == jax_doc


@pytest.mark.parametrize("capacity", [3, 8, 64], ids=["drops", "one-short", "roomy"])
@pytest.mark.parametrize("with_events", [False, True], ids=["spans", "journal"])
def test_chrome_trace_equals_jax(fake_clock, capacity, with_events):
    port = _record(ttrace, capacity, fake_clock)
    theirs = _record(jtrace, capacity, fake_clock)
    assert port.dropped == theirs.dropped == max(9 - capacity, 0)
    assert port.snapshot() == theirs.snapshot()
    events = EVENTS if with_events else None
    _same_doc(port.chrome_trace(events=events), theirs.chrome_trace(events=events))


def test_export_writes_the_jax_document(fake_clock, tmp_path):
    port = _record(ttrace, 6, fake_clock)
    theirs = _record(jtrace, 6, fake_clock)
    a = port.export_chrome_trace(str(tmp_path / "a" / "trace.json"), events=EVENTS)
    b = theirs.export_chrome_trace(str(tmp_path / "b" / "trace.json"), events=EVENTS)
    _same_doc(json.load(open(a)), json.load(open(b)))
    assert not os.path.exists(a + ".tmp")


def test_journal_lanes_and_offline_merge_equal_jax():
    assert (ttrace.journal_lane_events(EVENTS, 1000.0, pid=7)
            == jtrace.journal_lane_events(EVENTS, 1000.0, pid=7))
    doc = {"traceEvents": [{"name": "x", "ph": "X", "ts": 0, "dur": 1, "pid": 9, "tid": 1}],
           "otherData": {"epoch_unix_s": 999.5}}
    assert (ttrace.merge_events_into_trace(json.loads(json.dumps(doc)), EVENTS)
            == jtrace.merge_events_into_trace(json.loads(json.dumps(doc)), EVENTS))


def test_null_tracer_is_the_jax_surface(tmp_path):
    for mod in (ttrace, jtrace):
        null = mod.NULL_TRACER
        assert not null.enabled and isinstance(null, mod.NullTracer)
        span = null.span("trainer/dispatch", cat="trainer", step=1)
        assert span is null.span("other") and span.__enter__() is span
        assert span.__exit__(None, None, None) is False
        assert null.instant("x") is None and null.register_thread("t") is None
        assert null.snapshot() == [] and null.export_chrome_trace(str(tmp_path / "t")) is None
    with pytest.raises(ValueError, match="capacity must be >= 1, got 0"):
        ttrace.SpanTracer(0)


def _jax_span_names():
    """The names of the JAX package's spans and instants: string literals,
    and the literal prefix of an f-string (``anomaly/{kind}``)."""
    exact, prefixes = set(), set()
    for path in (ROOT / "mercury_tpu").rglob("*.py"):
        for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
            if not (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
                    and node.func.attr in ("span", "instant") and node.args):
                continue
            arg = node.args[0]
            if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
                exact.add(arg.value)
            elif isinstance(arg, ast.JoinedStr) and isinstance(arg.values[0], ast.Constant):
                prefixes.add(arg.values[0].value)
    return exact, prefixes


def _dataset(placement="replicated"):
    (x, y), (xt, yt) = cifar.synthetic_cifar(10, N_TRAIN, 8, seed=0)
    return make_sharded_dataset((x, y), (xt, yt), [np.arange(N_TRAIN)], cifar.CIFAR10_MEAN,
                                cifar.CIFAR10_STD, 10, device=torch.device("cpu"),
                                placement=placement)


def _trainer(**kw) -> Trainer:
    cfg = TrainConfig(**{**COMMON, **kw})
    return Trainer(cfg, dataset=_dataset(cfg.data_placement), device="cpu",
                   model=tiny_resnet(seed=0))


def _traced_names(log_dir):
    doc = json.load(open(os.path.join(log_dir, "trace.json")))
    spans = [e for e in doc["traceEvents"] if e.get("cat") != "events" and e["ph"] != "M"]
    threads = {e["args"]["name"] for e in doc["traceEvents"]
               if e["ph"] == "M" and e.get("cat") != "events"}
    return doc, spans, threads


def test_fit_span_names_are_the_jax_packages(tmp_path):
    exact, prefixes = _jax_span_names()
    assert {"trainer/dispatch", "stream/gather", "fleet/chunk"} <= exact
    assert "anomaly/" in prefixes
    names = set()

    stream_dir = str(tmp_path / "stream")
    tr = _trainer(data_placement="host_stream", prefetch_depth=2, trace=True,
                  log_dir=stream_dir, log_every=2, eval_every=4,
                  checkpoint_dir=str(tmp_path / "ckpt"), checkpoint_every=4)
    try:
        tr.fit(steps=4)
        tr.restore()
        tr.fit(steps=2)
    finally:
        tr.close()
    doc, spans, threads = _traced_names(stream_dir)
    names |= {e["name"] for e in spans}
    assert {"trainer/pop", "trainer/dispatch", "trainer/push", "trainer/log_gate",
            "trainer/eval", "trainer/checkpoint", "trainer/refill_stream_pipe",
            "stream/wait_indices", "stream/gather", "stream/h2d"} <= names, names
    assert {"train", "prefetch"} <= threads
    train_tid = next(e["tid"] for e in doc["traceEvents"]
                     if e["ph"] == "M" and e["args"]["name"] == "train")
    dispatch = [e for e in spans if e["name"] == "trainer/dispatch"]
    assert len(dispatch) == 6 and {e["tid"] for e in dispatch} == {train_tid}

    async_dir = str(tmp_path / "async")
    tr = _trainer(sampler="scoretable", refresh_size=R, refresh_mode="async",
                  snapshot_every=2, trace=True, log_dir=async_dir, log_every=2,
                  supervise=True, supervisor_backoff_s=0.0, supervisor_restart_budget=0,
                  supervisor_probe_every=0, supervisor_sync_every=1,
                  fault_spec="scorer_die@step=3", anomaly_inject_nan_step=2,
                  anomaly_profile_steps=2)
    try:
        tr.fit(steps=8)
        assert tr.supervisor.level() >= 1
    finally:
        tr.close()
    doc, spans, _ = _traced_names(async_dir)
    got = {e["name"] for e in spans}
    assert {"fleet/chunk", "trainer/sync_refresh", "anomaly/non_finite",
            "profiler/start", "profiler/stop"} <= got, got
    assert doc["otherData"]["journal_events"] > 0
    assert any(e.get("cat") == "events" for e in doc["traceEvents"])
    names |= got
    unknown = {n for n in names if n not in exact
               and not any(n.startswith(p) for p in prefixes)}
    assert not unknown, unknown


def test_flight_record_carries_the_ring(tmp_path):
    tr = _trainer(sampler="scoretable", refresh_size=R, trace=True, log_dir=str(tmp_path),
                  log_every=2, anomaly_inject_nan_step=3)
    try:
        tr.fit(steps=6)
        tr.logger.flush()
    finally:
        tr.close()
    doc = json.load(open(tmp_path / "flight_record_step4_non_finite.json"))
    names = [s["name"] for s in doc["spans"]]
    assert "trainer/dispatch" in names and "anomaly/non_finite" in names
    assert all({"name", "cat", "ts", "pid", "tid", "ph"} <= set(s) for s in doc["spans"])


def _ops_of_a_step(**kw):
    """The ATen operators one step runs (after a first step), in order."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Ops(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.ops = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.ops.append(str(func))
            return func(*args, **(kwargs or {}))

    tr = _trainer(**kw)
    try:
        tr.train_step()
        with Ops() as mode:
            tr.train_step()
        return mode.ops
    finally:
        tr.close()


@pytest.mark.parametrize("kw", [dict(), dict(sampler="scoretable", refresh_size=R)],
                         ids=["pool", "scoretable"])
def test_tracing_changes_no_operator_of_the_step(kw, tmp_path):
    off = _ops_of_a_step(**kw)
    on = _ops_of_a_step(trace=True, log_dir=str(tmp_path), **kw)
    assert len(off) > 50 and on == off
