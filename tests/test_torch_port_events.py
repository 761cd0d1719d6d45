"""The port's event journal (``mercury_tpu_torch/obs/events.py``) against
the JAX package's (``mercury_tpu/obs/events.py`` and ``EVENT_KINDS`` of
``mercury_tpu/obs/registry.py``), and its producers in the port.

The same ``emit`` calls give the same ``read_journal`` rows, apart from the
two clock readings; ``validate_event``, ``parent_chain`` and ``load_events``
agree; a torn last line is skipped; the registries' keys are equal. The
producers: the metric writer's drain thread writes the journal when idle
and at close; the fault plane journals ``fault/fired`` as the JAX plane
does and hands the id to the fault it raises; checkpoints journal
``written``, ``verified`` and ``fallback``; an elastic restore its begin
and end; the scorer service its tenants, snapshots, starvation and wedge.
None of the new modules imports JAX or the JAX package.
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

from mercury_tpu import faults as jfaults  # noqa: E402
from mercury_tpu.obs import events as jevents  # noqa: E402
from mercury_tpu.obs.registry import EVENT_KINDS as JEVENT_KINDS  # noqa: E402
from mercury_tpu_torch import TrainConfig, Trainer, faults  # noqa: E402
from mercury_tpu_torch.data import cifar  # noqa: E402
from mercury_tpu_torch.data.pipeline import make_sharded_dataset  # noqa: E402
from mercury_tpu_torch.data.stream import HostStreamSource, PrefetchPipeline  # noqa: E402
from mercury_tpu_torch.obs import events  # noqa: E402
from mercury_tpu_torch.obs.writer import AsyncMetricWriter  # noqa: E402
from mercury_tpu_torch.sampling.scorer_service import ScorerService  # noqa: E402
from mercury_tpu_torch.train import checkpoint  # noqa: E402
from test_torch_port_ranks import tiny_resnet  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
NEW_MODULES = ["mercury_tpu_torch/obs/events.py", "mercury_tpu_torch/obs/anomaly.py",
               "mercury_tpu_torch/runtime/__init__.py",
               "mercury_tpu_torch/runtime/supervisor.py"]
CLOCK = ("mono_ns", "wall_s")
B, R, N_TRAIN = 4, 8, 48
COMMON = dict(dataset="synthetic", world_size=1, batch_size=B, presample_batches=2,
              compute_dtype="float32", num_epochs=1, steps_per_epoch=10, eval_every=0,
              log_every=0, heartbeat_every=0, seed=0)

EMITS = [
    ("fault/fired", 3, None, {"fault": "scorer_die", "fired": 1, "args": {}}),
    ("supervisor/exhausted", 3, 0, {"unit": "scorer", "budget": 0, "escalates": True}),
    ("supervisor/degrade", 3, 1, {"from": "async", "to": "sync", "reason": "r"}),
    ("supervisor/probe_failed", 4, 2, {"level": 1, "error": "E: x"}),
    ("supervisor/degrade", 4, 3, {"from": "sync", "to": "frozen", "reason": "r"}),
    ("scorer/snapshot", -1, None, None),
    ("anomaly/triggered", 7, None, {"trigger": "non_finite", "flight_record": None,
                                    "value": float("nan")}),
    ("checkpoint/written", 8, None, {"path": "/d/ckpt_8.pt", "obj": threading.Lock()}),
    ("elastic/reshard_end", 9, 5, {"carried": ["step"]}),
]


@pytest.fixture(autouse=True, scope="module")
def one_intra_op_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _emit_all(journal):
    ids = []
    for kind, step, parent, detail in EMITS:
        ids.append(journal.emit(kind, step, parent=None if parent is None else ids[parent],
                                detail=detail))
    return ids


def _strip(rows):
    return [{k: v for k, v in r.items() if k not in CLOCK} for r in rows]


def test_emit_and_read_match_the_jax_package(tmp_path):
    mine = events.EventJournal(str(tmp_path / "port"), 2)
    theirs = jevents.EventJournal(str(tmp_path / "jax"), 2)
    ids = _emit_all(mine)
    assert ids == _emit_all(theirs) and ids[0] == "e2-0"
    assert events.read_journal(mine.path) == []   # buffered: nothing written yet
    assert mine.flush() == theirs.flush() == len(EMITS)
    assert mine.tail(3) == [dict(e) for e in mine.tail(3)]
    assert _strip(mine.tail(4)) == _strip(theirs.tail(4))
    assert mine.counts() == theirs.counts()
    mine.close()
    theirs.close()
    got, want = events.read_journal(mine.path), jevents.read_journal(theirs.path)
    assert len(got) == len(EMITS)
    assert json.dumps(_strip(got)) == json.dumps(_strip(want))
    for row in got:
        assert events.validate_event(row, registry=events.EVENT_KINDS) == []
        assert jevents.validate_event(row, registry=JEVENT_KINDS) == []
    header = json.loads(open(mine.path).readline())
    assert header["schema"] == events.EVENT_SCHEMA == jevents.EVENT_SCHEMA
    assert events.journal_filename(2) == jevents.journal_filename(2) == "events.h2.jsonl"
    assert mine.emit("fault/fired", 1) is None   # after close: dropped


def test_event_kinds_match_the_jax_registry():
    assert set(events.EVENT_KINDS) == set(JEVENT_KINDS)
    assert events.EVENT_FIELDS == jevents.EVENT_FIELDS


def test_torn_last_line_and_capacity(tmp_path):
    for mod, sub in ((events, "port"), (jevents, "jax")):
        j = mod.EventJournal(str(tmp_path / sub), 0, capacity=4)
        for i in range(7):
            j.emit("fault/fired", i)
        assert j.counts() == {"emitted": 7, "dropped": 3, "buffered": 4}
        j.close()
        with open(j.path, "a") as f:
            f.write('{"event_id": "e0-torn", "ki')   # a crash mid-line
        assert [e["step"] for e in mod.read_journal(j.path)] == [3, 4, 5, 6]
    assert events.read_journal(str(tmp_path / "absent.jsonl")) == []


GOOD = {"event_id": "e0-0", "parent_id": None, "kind": "fault/fired", "step": 1,
        "mono_ns": 1, "wall_s": 1.0, "host": 0, "detail": {}}


@pytest.mark.parametrize("row", [
    GOOD, "nope", {}, dict(GOOD, kind="no_slash"), dict(GOOD, kind="bogus/kind"),
    dict(GOOD, event_id=""), dict(GOOD, parent_id=3), dict(GOOD, step="1"),
    dict(GOOD, mono_ns=1.5), dict(GOOD, wall_s="x"), dict(GOOD, host=None),
    dict(GOOD, detail=[]), {k: v for k, v in GOOD.items() if k != "host"},
])
def test_validate_event_matches_the_jax_package(row):
    assert events.validate_event(row) == jevents.validate_event(row)
    assert (events.validate_event(row, registry=events.EVENT_KINDS)
            == jevents.validate_event(row, registry=JEVENT_KINDS))


def test_parent_chain_and_load_events_match(tmp_path):
    j0, j1 = events.EventJournal(str(tmp_path), 0), events.EventJournal(str(tmp_path), 1)
    ids = _emit_all(j0)
    j1.emit("fault/fired", 2)
    j0.close()
    j1.close()
    rows = events.load_events(str(tmp_path))
    assert rows == jevents.load_events(str(tmp_path)) and len(rows) == len(EMITS) + 1
    for eid in ids:
        assert events.parent_chain(rows, eid) == jevents.parent_chain(rows, eid)
    chain = events.parent_chain(rows, ids[4])
    assert [e["kind"] for e in chain] == ["fault/fired", "supervisor/exhausted",
                                          "supervisor/degrade", "supervisor/probe_failed",
                                          "supervisor/degrade"]
    cycle = [{"event_id": "a", "parent_id": "b"}, {"event_id": "b", "parent_id": "a"}]
    assert len(events.parent_chain(cycle, "a")) == 2
    assert events.load_events(str(tmp_path / "absent")) == []


def test_concurrent_emitters_keep_ids_unique(tmp_path):
    j = events.EventJournal(str(tmp_path), 0)

    def emitter(n):
        for i in range(200):
            j.emit("fault/fired", i, detail={"t": n})

    threads = [threading.Thread(target=emitter, args=(n,)) for n in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    j.close()
    rows = events.read_journal(j.path)
    assert len(rows) == 800 and len({e["event_id"] for e in rows}) == 800


def test_writer_drain_thread_writes_the_journal(tmp_path):
    """The drain thread writes the journal when it goes idle; close
    writes what is left and leaves the journal open for the Trainer."""
    j = events.EventJournal(str(tmp_path), 0)
    w = AsyncMetricWriter([], journal=j)
    j.emit("fault/fired", 1)
    w.write(1, {"train/loss": 1.0})
    deadline = time.monotonic() + 10
    while not events.read_journal(j.path):
        assert time.monotonic() < deadline
        time.sleep(0.01)
    assert w._thread.name == "mercury-metrics"
    j.emit("fault/fired", 2)
    w.close()
    assert [e["step"] for e in events.read_journal(j.path)] == [1, 2]
    assert j.emit("fault/fired", 3) is not None
    j.close()


@pytest.mark.parametrize("spec", ["scorer_die@step=2,every=3;host_slow@step=1,secs=0",
                                  "prefetch_stall@step=0,every=1,secs=2.5"])
def test_fault_plane_journals_as_the_jax_plane(spec, tmp_path):
    mj = events.EventJournal(str(tmp_path / "port"), 0)
    jj = jevents.EventJournal(str(tmp_path / "jax"), 0)
    mine, theirs = faults.FaultPlane(spec, journal=mj), jfaults.FaultPlane(spec, journal=jj)
    for step in range(9):
        for plane in (mine, theirs):
            plane.note_step(step)
            for kind in sorted(faults.KNOWN_KINDS):
                plane.fire(kind)
    mj.close()
    jj.close()
    got = _strip(events.read_journal(mj.path))
    assert got and got == _strip(jevents.read_journal(jj.path))
    assert {e["kind"] for e in got} == {"fault/fired"}


def test_an_injected_fault_names_its_event(tmp_path):
    j = events.EventJournal(str(tmp_path), 0)
    plane = faults.FaultPlane("prefetch_die@step=0", journal=j)
    x = np.zeros((16, 4, 4, 3), np.uint8)
    pipe = PrefetchPipeline(HostStreamSource(x), 4, "cpu", depth=1, faults=plane)
    try:
        pipe.push(np.arange(4))
        with pytest.raises(RuntimeError, match="prefetch worker died") as err:
            pipe.pop()
        cause = err.value.__cause__
        assert isinstance(cause, faults.InjectedFault)
        assert cause.event_id == j.tail(1)[0]["event_id"]
        assert j.tail(1)[0]["detail"]["fault"] == "prefetch_die"
    finally:
        pipe.close()
        j.close()
    assert faults.FaultPlane("").injected("x").event_id is None


def _dataset():
    (x, y), (xt, yt) = cifar.synthetic_cifar(10, N_TRAIN, 8, seed=0)
    return make_sharded_dataset((x, y), (xt, yt), [np.arange(N_TRAIN)], cifar.CIFAR10_MEAN,
                                cifar.CIFAR10_STD, 10, device=torch.device("cpu"))


def _trainer(**kw) -> Trainer:
    return Trainer(TrainConfig(**{**COMMON, **kw}), dataset=_dataset(), device="cpu",
                   model=tiny_resnet(seed=0))


def test_checkpoint_and_elastic_events(tmp_path):
    log, ck = str(tmp_path / "log"), str(tmp_path / "ck")
    tr = _trainer(log_dir=log, checkpoint_dir=ck, checkpoint_every=2, sampler="scoretable",
                  refresh_size=R)
    try:
        tr.fit(steps=4)
        with open(checkpoint.checkpoint_path(ck, 4), "r+b") as f:
            f.seek(100)
            byte = f.read(1)
            f.seek(100)
            f.write(bytes([byte[0] ^ 0xFF]))
        assert tr.restore() == 2
        assert tr.restore_elastic(step=2) == 2
    finally:
        tr.close()
    rows = events.read_journal(os.path.join(log, "events.h0.jsonl"))
    kinds = [(r["kind"], r["step"]) for r in rows]
    assert kinds == [("checkpoint/written", 2), ("checkpoint/written", 4),
                     ("checkpoint/fallback", 4), ("checkpoint/verified", 2),
                     ("elastic/reshard_begin", 2), ("elastic/reshard_end", 2)]
    assert "sha256 mismatch" in rows[2]["detail"]["reason"]
    begin, end = rows[4], rows[5]
    assert end["parent_id"] == begin["event_id"]
    assert (begin["detail"]["w_old"], begin["detail"]["w_new"],
            begin["detail"]["l_old"], begin["detail"]["l_new"]) == (1, 1, N_TRAIN, N_TRAIN)
    assert "scoretable" in end["detail"]["carried"]
    for row in rows:
        assert events.validate_event(row, registry=events.EVENT_KINDS) == []


def test_scorer_service_events(tmp_path):
    j = events.EventJournal(str(tmp_path), 0)
    cfg = TrainConfig(**COMMON, sampler="scoretable", refresh_size=R, refresh_mode="async",
                      scorer_tenants=2, scorer_tenant_weights="3,1", scorer_workers=1,
                      slo_score_staleness_max=2)
    plane = faults.FaultPlane("scorer_wedge@step=0,tenant=1", journal=j)
    svc = ScorerService(_dataset(), tiny_resnet(seed=0), cfg, "cpu", faults=plane, journal=j)
    try:
        svc.snapshot(tiny_resnet(seed=0), 0)
        deadline = time.monotonic() + 20
        while svc.summary()["tenants"][0]["chunks_scored"] == 0:
            assert time.monotonic() < deadline
            time.sleep(0.01)
        svc.drain_for_step(0)
        assert svc.slo_status(1) is None
        assert svc.slo_status(9) is not None   # rising edge: starved
        assert svc.slo_status(10) is not None  # latched: no second event
    finally:
        svc.close()
        j.close()
    rows = events.read_journal(j.path)
    kinds = [r["kind"] for r in rows]
    assert kinds[:2] == ["scorer/tenant_admitted"] * 2
    assert [r["detail"]["tenant"] for r in rows[:2]] == ["t0", "t1"]
    assert rows[0]["detail"] == {"tenant": "t0", "weight": 3.0, "queue_max": 2,
                                 "backend": "host"}
    snaps = [r for r in rows if r["kind"] == "scorer/snapshot"]
    assert [(r["step"], r["detail"]) for r in snaps] == [(0, {"epoch": 1, "tenants": 2})]
    starved = [r for r in rows if r["kind"] == "scorer/starved"]
    assert [(r["step"], r["detail"]["tenant"]) for r in starved] == [(9, "t0")]
    wedged = [r for r in rows if r["kind"] == "scorer/wedged"]
    assert [r["detail"] for r in wedged] == [{"tenant": "t1"}]
    fired = [r for r in rows if r["kind"] == "fault/fired"]
    assert [r["detail"]["fault"] for r in fired] == ["scorer_wedge"]


def test_no_journal_without_log_dir_or_when_off(tmp_path):
    tr = _trainer()
    off = _trainer(log_dir=str(tmp_path), event_journal=False)
    try:
        assert tr._journal is None and off._journal is None
        assert not any(n.startswith("events.h") for n in os.listdir(tmp_path))
    finally:
        tr.close()
        off.close()


@pytest.mark.parametrize("path", NEW_MODULES)
def test_new_modules_import_nothing_of_jax(path):
    tree = ast.parse((ROOT / path).read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in ("jax", "jaxlib", "flax", "optax",
                                              "mercury_tpu"), (path, name)
