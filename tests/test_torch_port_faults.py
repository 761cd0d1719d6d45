"""The port's fault plane (``mercury_tpu_torch/faults.py``) against the JAX
package's (``mercury_tpu/faults.py``), and its hook sites in the port.

Every spec of the JAX package's ``tests/test_faults.py`` (and a few more)
goes through both planes on the same clock: the parsed entries, the firing
sequence of every kind (twice a step, as a retry within one step fires) and
``stats()``/``summary()`` are equal, exactly. Malformed specs raise the same
message. The hooks fire where the JAX package's do: ``prefetch_die`` kills
the port's prefetch worker and raises at the next ``pop``, naming itself;
``prefetch_stall`` delays a batch and hands over the same bits; a
``scorer_nan`` chunk is rejected by the trainer; ``scorer_die`` without a
supervisor raises at the next drain; ``scorer_wedge`` stops a tenant;
``sink_wedge`` stalls the metric drain; ``host_slow`` stalls ``fit``; a run
with ``fault_spec=""`` builds no plane and is bit-equal to one whose plane
never fires. Tiny sizes: a [1, 1]-stage ResNet of width 8, batch 4.
"""

import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from mercury_tpu import faults as jfaults  # noqa: E402
from mercury_tpu_torch import TrainConfig, Trainer, faults  # noqa: E402
from mercury_tpu_torch.data import cifar  # noqa: E402
from mercury_tpu_torch.data.pipeline import make_sharded_dataset  # noqa: E402
from mercury_tpu_torch.data.stream import HostStreamSource, PrefetchPipeline  # noqa: E402
from mercury_tpu_torch.obs.writer import AsyncMetricWriter  # noqa: E402
from mercury_tpu_torch.sampling.scorer_service import ScorerService  # noqa: E402
from test_torch_port_ranks import state_tensors, tiny_resnet  # noqa: E402

SPECS = [
    "scorer_die@step=40",
    "prefetch_stall@step=10,secs=2",
    "ckpt_io_error@step=0,every=1",
    "scorer_die@step=5;scorer_die@step=9",
    "host_slow@step=2,every=3,secs=0",
    "prefetch_stall@step=0,every=1,secs=2.5",
    "scorer_die@step=1;prefetch_die@step=9",
    "ckpt_io_error@step=0;ckpt_io_error@step=0",
    "scorer_wedge@step=3,tenant=1;sink_wedge@step=0,every=4,secs=0.5",
    " ; scorer_nan@step=2 ; ",
    "",
]
MALFORMED = [
    ("scorer_die", "expected 'kind@step=N"),
    ("tpu_melt@step=1", "unknown fault kind"),
    ("scorer_die@step=soon", "not numeric"),
    ("scorer_die@secs=2", "missing the mandatory 'step=N'"),
    ("scorer_die@step=1,oops", "malformed param"),
]
B, R, N_TRAIN = 4, 8, 48
COMMON = dict(dataset="synthetic", world_size=1, batch_size=B, presample_batches=2,
              compute_dtype="float32", num_epochs=1, steps_per_epoch=10, eval_every=0,
              log_every=0, seed=0)
ASYNC = dict(sampler="scoretable", refresh_size=R, refresh_mode="async", snapshot_every=2)


@pytest.fixture(autouse=True, scope="module")
def one_intra_op_thread():
    """One intra-op thread: the tiny steps run 30-50× slower with torch's
    thread pool on cores the test workers share."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _dataset(placement="replicated"):
    (x, y), (xt, yt) = cifar.synthetic_cifar(10, N_TRAIN, 8, seed=0)
    return make_sharded_dataset((x, y), (xt, yt), [np.arange(N_TRAIN)], cifar.CIFAR10_MEAN,
                                cifar.CIFAR10_STD, 10, device=torch.device("cpu"),
                                placement=placement)


def _trainer(**kw) -> Trainer:
    cfg = TrainConfig(**{**COMMON, **kw})
    return Trainer(cfg, dataset=_dataset(cfg.data_placement), device="cpu",
                   model=tiny_resnet(seed=0))


def _entries(entries):
    return [(e.kind, e.step, e.every, e.args) for e in entries]


# ------------------------------------------------------------- the grammar
@pytest.mark.parametrize("spec", SPECS)
def test_parse_matches_the_jax_package(spec):
    assert _entries(faults.parse_fault_spec(spec)) == _entries(jfaults.parse_fault_spec(spec))


@pytest.mark.parametrize("spec", SPECS)
def test_firing_matches_the_jax_package(spec):
    """Both planes on one clock, every kind fired twice a step: the same
    sequence of firings and arguments, and the same stats and summary."""
    mine, theirs = faults.FaultPlane(spec), jfaults.FaultPlane(spec)
    kinds = sorted(faults.KNOWN_KINDS)
    assert kinds == sorted(jfaults.KNOWN_KINDS)
    got, want = [], []
    for step in range(46):
        for plane, out in ((mine, got), (theirs, want)):
            plane.note_step(step)
            out.append([plane.fire(kind) for kind in kinds for _ in range(2)])
        assert mine.stats() == theirs.stats(), step
    assert got == want
    assert mine.summary() == theirs.summary()


@pytest.mark.parametrize("bad,msg", MALFORMED)
def test_malformed_specs_raise_as_in_the_jax_package(bad, msg):
    with pytest.raises(ValueError, match=msg) as mine:
        faults.parse_fault_spec(bad)
    with pytest.raises(ValueError) as theirs:
        jfaults.parse_fault_spec(bad)
    assert str(mine.value) == str(theirs.value)


def test_a_malformed_spec_refuses_the_trainer():
    with pytest.raises(ValueError, match="unknown fault kind 'tpu_melt'"):
        _trainer(fault_spec="tpu_melt@step=1")


def test_racing_workers_consume_a_one_shot_once():
    plane = faults.FaultPlane("scorer_die@step=1")
    plane.note_step(1)
    hits = []
    barrier = threading.Barrier(8)

    def worker():
        barrier.wait()
        got = plane.fire("scorer_die")
        if got is not None:
            hits.append(got)

    threads = [threading.Thread(target=worker) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert hits == [{}]
    assert plane.stats() == {"fault/injected": 1.0, "fault/armed": 0.0}


# ------------------------------------------------------------ prefetch hooks
def _pipe(plane):
    x = np.broadcast_to(np.arange(64, dtype=np.uint8)[:, None, None], (64, 3, 2)).copy()
    return PrefetchPipeline(HostStreamSource(x), 4, "cpu", depth=2, faults=plane)


def test_prefetch_die_raises_at_the_next_pop_naming_itself():
    pipe = _pipe(faults.FaultPlane("prefetch_die@step=0"))
    try:
        pipe.push(np.array([0, 1, 2, 3]))
        with pytest.raises(RuntimeError, match="prefetch worker died") as err:
            pipe.pop()
        assert "prefetch_die: injected prefetch-worker death" in str(err.value)
        assert isinstance(err.value.__cause__, faults.InjectedFault)
        assert not pipe.alive()
    finally:
        pipe.close()


def test_prefetch_stall_delays_and_delivers_the_same_rows():
    pipe = _pipe(faults.FaultPlane("prefetch_stall@step=0,secs=0.3"))
    try:
        t0 = time.monotonic()
        pipe.push(np.array([4, 5, 6, 7]))
        batch = pipe.pop()
        assert time.monotonic() - t0 >= 0.3
        assert torch.equal(batch[:, 0, 0], torch.tensor([4, 5, 6, 7], dtype=torch.uint8))
        pipe.push(np.array([8, 9, 10, 11]))
        assert torch.equal(pipe.pop()[:, 0, 0], torch.arange(8, 12, dtype=torch.uint8))
        assert pipe.alive()
    finally:
        pipe.close()


def test_host_stream_run_with_a_stall_is_bit_equal():
    """A stalled gather delays the batch, and the run is the same bits."""
    plain = _trainer(data_placement="host_stream")
    stalled = _trainer(data_placement="host_stream", fault_spec="prefetch_stall@step=2,secs=0.2")
    try:
        plain.fit(steps=5)
        stalled.fit(steps=5)
        assert stalled._faults.stats()["fault/injected"] == 1.0
        a, b = state_tensors(plain.state), state_tensors(stalled.state)
        assert a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)
    finally:
        plain.close()
        stalled.close()


def test_host_stream_prefetch_die_raises_in_fit():
    tr = _trainer(data_placement="host_stream", fault_spec="prefetch_die@step=2")
    try:
        with pytest.raises(RuntimeError, match="prefetch_die"):
            tr.fit(steps=8)
        assert 2 <= tr.state.step < 8
    finally:
        tr.close()


# -------------------------------------------------------------- scorer hooks
def _stopped_fleet_trainer(spec, **kw):
    """An async Trainer whose fleet workers are stopped, so the test scores
    on its own thread."""
    tr = _trainer(**ASYNC, fault_spec=spec, **kw)
    fleet = tr._scorer_fleet
    fleet._closed = True
    for t in fleet._threads:
        t.join(timeout=10)
    fleet._closed = False
    return tr


def test_scorer_nan_chunk_is_rejected_and_counted():
    tr = _stopped_fleet_trainer("scorer_nan@step=0")
    try:
        before = tr.state.scoretable.scores.clone()
        chunk = tr._scorer_fleet.score_once()
        assert torch.isnan(chunk.scores).all()
        tr._apply_chunks([chunk], tr.state.step)
        assert tr._chunks_rejected == 1
        assert torch.equal(tr.state.scoretable.scores, before)
        good = tr._scorer_fleet.score_once()   # one-shot: the next is finite
        assert torch.isfinite(good.scores).all()
        assert tr.scorer_stats()["sampler/chunks_rejected"] == 1.0
    finally:
        tr.close()


def test_scorer_die_without_a_supervisor_raises():
    tr = _stopped_fleet_trainer("scorer_die@step=0")
    try:
        with pytest.raises(faults.InjectedFault, match="scorer_die"):
            tr._scorer_fleet.score_once()
    finally:
        tr.close()
    live = _trainer(**ASYNC, fault_spec="scorer_die@step=0")
    try:
        deadline = time.monotonic() + 30
        while live._scorer_fleet.alive():
            assert time.monotonic() < deadline
            time.sleep(0.01)
        with pytest.raises(RuntimeError, match="scorer fleet worker died") as err:
            live.fit(steps=3)
        assert isinstance(err.value.__cause__, faults.InjectedFault)
    finally:
        live.close()


def test_scorer_service_hooks():
    """The service: ``scorer_wedge`` stops scheduling tenant 1, and
    ``scorer_die`` raises at the drain."""
    tr = _trainer(**ASYNC, scorer_tenants=2, fault_spec="scorer_wedge@step=0,tenant=1")
    try:
        svc = tr._scorer_fleet
        assert isinstance(svc, ScorerService)
        deadline = time.monotonic() + 30
        while not svc.summary()["tenants"][1]["wedged"]:
            assert time.monotonic() < deadline
            time.sleep(0.01)
        scored = svc.summary()["tenants"][1]["chunks_scored"]
        tr.fit(steps=4)
        tenants = svc.summary()["tenants"]
        assert tenants[1]["chunks_scored"] <= scored + 1 and not tenants[0]["wedged"]
    finally:
        tr.close()
    dead = _trainer(**ASYNC, scorer_backend="device", fault_spec="scorer_die@step=0")
    try:
        deadline = time.monotonic() + 30
        while dead._scorer_fleet.alive():
            assert time.monotonic() < deadline
            time.sleep(0.01)
        with pytest.raises(RuntimeError, match="scorer service worker died"):
            dead.fit(steps=3)
    finally:
        dead.close()


# ------------------------------------------------- the writer and the loop
def test_sink_wedge_stalls_the_drain_and_delivers():
    records = []
    writer = AsyncMetricWriter([], observers=[records.append],
                               faults=faults.FaultPlane("sink_wedge@step=0,secs=0.3"))
    try:
        t0 = time.monotonic()
        writer.write(1, {"a": 1.0})
        writer.write(2, {"a": 2.0})
        writer.flush()
        assert time.monotonic() - t0 >= 0.3
        assert [r["a"] for r in records] == [1.0, 2.0]
    finally:
        writer.close()


def test_host_slow_stalls_fit_and_shows_in_the_record():
    tr = _trainer(fault_spec="host_slow@step=1,secs=0.3", log_every=3)
    try:
        t0 = time.monotonic()
        tr.fit(steps=3)
        assert time.monotonic() - t0 >= 0.3
        tr.logger.flush()
        record = tr.logger.latest_record()
        assert record["step"] == 3
        assert (record["fault/injected"], record["fault/armed"]) == (1.0, 0.0)
        assert "checkpoint/write_failures" not in record
    finally:
        tr.close()


def test_empty_spec_builds_no_plane_and_an_idle_plane_changes_nothing():
    """``fault_spec=""``: no plane anywhere. A plane whose one entry is
    never due leaves the run bit-equal (host_stream: the prefetch hook; a
    log record a step: the writer's)."""
    kw = dict(data_placement="host_stream", log_every=1)
    plain, armed = _trainer(**kw), _trainer(**kw, fault_spec="scorer_die@step=1000")
    try:
        assert plain._faults is None and plain._stream_pipe._faults is None
        assert plain.logger._faults is None
        assert armed._stream_pipe._faults is armed._faults is armed.logger._faults
        plain.fit(steps=4)
        armed.fit(steps=4)
        a, b = state_tensors(plain.state), state_tensors(armed.state)
        assert a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)
        assert armed._faults.stats() == {"fault/injected": 0.0, "fault/armed": 1.0}
    finally:
        plain.close()
        armed.close()
    async_tr = _trainer(**ASYNC)
    try:
        assert async_tr._scorer_fleet._faults is None
    finally:
        async_tr.close()
