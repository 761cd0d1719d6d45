"""The scorer service in the port (``sampling/scorer_service.py``) at one
rank: ``scorer_backend="device"``, tenants with weighted round-robin, the
scoring SLOs, and the Trainer's choice of service or fleet.

Held to the JAX package's ``ScorerService`` on the CPU:

- the composition refusals of ``validate_scorer_composition`` (both refuse
  or both accept; the port's message names the field);
- the pick order of ``_next_tenant`` (JAX's called unbound on a stand-in
  holding JAX ``_Tenant``\\ s), and the weights' exact shares over 40 picks;
- ``score_once`` for tenants 0 and 1, with JAX's crops and flips of
  ``fold_in(fold_in(key(seed), 0x5C0), t·0x100000 + seq)`` fed in (loss
  and grad_norm scores, rtol 1e-5);
- ``slo_status``'s text and latch, and the key sets of ``stats()`` and
  ``summary()``;
- the Trainer's choice of service or fleet, for five configs.

And the port's own contract: the device backend's chunks are the host
fleet's bits, tenant 1 draws from ``chunk_seed(seed, 0x100000 + seq)``,
the device backend is paced by snapshots, and a live Trainer applies,
discards, restores and closes as it should. Tiny sizes: the [1, 1]-stage
ResNet of width 8, 64 images, windows of 8.
"""

import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from mercury_tpu.config import TrainConfig as JConfig  # noqa: E402
from mercury_tpu.sampling import scorer_fleet as jfleet_mod  # noqa: E402
from mercury_tpu.sampling import scorer_service as jsvc_mod  # noqa: E402
from mercury_tpu_torch import TrainConfig, Trainer  # noqa: E402
from mercury_tpu_torch.sampling import scorer_fleet  # noqa: E402
from mercury_tpu_torch.sampling import scorer_service as svc_mod  # noqa: E402
from mercury_tpu_torch.sampling.scorer_fleet import ScorerFleet, chunk_seed  # noqa: E402
from mercury_tpu_torch.sampling.scorer_service import ScorerService  # noqa: E402

from test_torch_port_async_scoring import (  # noqa: E402, F401
    COMMON,
    MEAN,
    N_TRAIN,
    R,
    STD,
    _augment,
    _data,
    _dataset,
    _jax_model,
    _port_model,
    jax_weights,
    one_intra_op_thread,
)
from test_torch_port_ranks import tiny_resnet  # noqa: E402

STRIDE = 0x100000


def _wait(cond, what, timeout=60.0):
    deadline = time.monotonic() + timeout
    while not cond():
        assert time.monotonic() < deadline, what
        time.sleep(0.01)


def _svc_threads():
    return [t for t in threading.enumerate() if t.name.startswith("mercury-scorer-svc-")]


# ---------------------------------------------------------------- composition
@pytest.mark.parametrize("kw,world,field", [
    (dict(scorer_backend="host"), 1, None),
    (dict(scorer_backend="device"), 1, None),
    (dict(scorer_backend="tpu"), 1, "scorer_backend"),
    (dict(scorer_tenants=0), 1, "scorer_tenants"),
    (dict(scorer_tenants=1), 1, None),
    (dict(scorer_tenants=4), 1, None),
    (dict(scorer_tenants=5), 1, "scorer_tenants"),
    (dict(scorer_tenants=2, scorer_tenant_weights=""), 1, None),
    (dict(scorer_tenants=2, scorer_tenant_weights="3,1"), 1, None),
    (dict(scorer_tenants=2, scorer_tenant_weights="1"), 1, "scorer_tenant_weights"),
    (dict(scorer_tenants=2, scorer_tenant_weights="a,b"), 1, "scorer_tenant_weights"),
    (dict(scorer_tenants=2, scorer_tenant_weights="1,-1"), 1, "scorer_tenant_weights"),
    (dict(scorer_backend="device", scorer_throttle_s=0.1), 1, "scorer_throttle_s"),
    (dict(scorer_backend="host"), 2, "refresh_mode"),
    (dict(scorer_backend="device"), 2, None),
    (dict(scorer_backend="device", scorer_tenants=2), 2, "scorer_tenants"),
    (dict(scorer_backend="device", scorer_workers=2), 2, "scorer_workers"),
], ids=lambda v: str(v))
def test_composition_matches_jax(kw, world, field):
    """JAX's ``validate_scorer_composition(config, W)`` and the port's
    ``TrainConfig`` refuse or accept alike; the port names the field."""
    try:
        jsvc_mod.validate_scorer_composition(JConfig(**{**COMMON, **kw}), world)
        jax_refuses = False
    except ValueError:
        jax_refuses = True
    assert jax_refuses == (field is not None)
    if field is None:
        assert TrainConfig(**{**COMMON, **kw, "world_size": world}).world_size == world
        return
    with pytest.raises(ValueError, match=f"TrainConfig.{field}=") as err:
        TrainConfig(**{**COMMON, **kw, "world_size": world})
    if world > 1 and kw["scorer_backend"] == "host":
        assert "single-controller" in str(err.value)


@pytest.mark.parametrize("kw,field", [
    (dict(scorer_tenants=2, refresh_mode="sync"), "scorer_tenants"),
    (dict(scorer_backend="device", refresh_mode="sync"), "scorer_backend"),
])
def test_tenants_and_backend_need_async(kw, field):
    """The JAX step's refusals: the backend and the tenants belong to the
    async scorer."""
    from mercury_tpu.train.state import make_optimizer
    from mercury_tpu.train.step import make_train_step
    from mercury_tpu.parallel.mesh import host_cpu_mesh

    with pytest.raises(ValueError, match=field):
        make_train_step(_jax_model(), make_optimizer("adam", 0.001, 10),
                        JConfig(**{**COMMON, **kw}), host_cpu_mesh(1), MEAN, STD)
    with pytest.raises(ValueError, match=f"TrainConfig.{field}="):
        TrainConfig(**{**COMMON, **kw})


# ------------------------------------------------------------------- the picks
class _JaxStandin:
    """What JAX's ``_next_tenant`` reads of its service."""

    _eligible_locked = jsvc_mod.ScorerService._eligible_locked

    def __init__(self, weights, backend, cap):
        self._lock = threading.Lock()
        self._tenants = [jsvc_mod._Tenant(i, w, cap) for i, w in enumerate(weights)]
        self._backend, self._epoch_cap = backend, cap


class _PortStandin:
    _eligible_locked = ScorerService._eligible_locked

    def __init__(self, weights, backend, cap):
        self._lock = threading.Lock()
        self._work = threading.Event()
        self._tenants = [svc_mod._Tenant(i, w, cap) for i, w in enumerate(weights)]
        self._backend, self._epoch_cap = backend, cap


def _picks(standin, next_tenant, n):
    """``n`` picks, each tenant's reserved slot released after its pick."""
    out = []
    for _ in range(n):
        t = next_tenant(standin)
        out.append(None if t is None else t.idx)
        if t is not None:
            t.inflight -= 1
    return out


@pytest.mark.parametrize("weights", [[1.0], [3.0, 1.0], [2.0, 1.0, 1.0], [1.0] * 4],
                         ids=lambda w: ",".join(f"{x:g}" for x in w))
def test_pick_order_matches_jax(weights):
    """Smooth weighted round-robin: 40 picks with every tenant eligible
    (the exact shares), then tenant 0's queue full, then the device
    backend's epoch cap."""
    orders = {}
    for name, cls, nxt in (("jax", _JaxStandin, jsvc_mod.ScorerService._next_tenant),
                           ("port", _PortStandin, ScorerService._next_tenant)):
        s = cls(weights, "host", 2)
        for t in s._tenants:
            t.snap = object()
        free = _picks(s, nxt, 40)
        for _ in range(2):
            s._tenants[0].ready.put_nowait(None)
        full = _picks(s, nxt, 8)
        s = cls(weights, "device", 2)
        for t in s._tenants:
            t.snap = object()
        capped = _picks(s, nxt, 2 * len(weights) + 2)
        orders[name] = (free, full, capped)
    assert orders["port"] == orders["jax"]
    free, full, capped = orders["port"]
    total = sum(weights)
    assert [free.count(i) for i in range(len(weights))] == [40 * w / total for w in weights]
    assert 0 not in full and (full == [None] * 8) == (len(weights) == 1)
    assert [capped.count(i) for i in range(len(weights))] == [2] * len(weights)
    assert capped[-2:] == [None, None]


# ------------------------------------------------------------------ the chunks
def test_device_chunks_equal_the_fleets():
    """From one snapshot, workers stopped: the device backend's two chunks
    are the host fleet's, bit for bit."""
    model = tiny_resnet(seed=0)
    fleet = ScorerFleet(_dataset(), model, TrainConfig(**COMMON), "cpu")
    svc = ScorerService(_dataset(), model, TrainConfig(**COMMON, scorer_backend="device"),
                        "cpu")
    fleet.close()
    svc.close()
    assert svc.summary()["program"] == {"backend": "device", "device": "cpu",
                                        "dedicated_slice": False}
    fleet.snapshot(model, 3)
    svc.snapshot(model, 3)
    for k in range(2):
        a, b = fleet.score_once(), svc.score_once()
        assert a.step == b.step == 3
        assert torch.equal(a.slots, b.slots) and torch.equal(a.scores, b.scores), k
        assert torch.equal(b.slots, torch.arange(k * R, (k + 1) * R))


def test_tenant_streams(monkeypatch):
    """Tenant 0 is the fleet's stream, bit for bit; tenant 1's chunk
    ``seq`` draws from ``chunk_seed(seed, 0x100000 + seq)`` over its own
    window cursor."""
    seeds = []
    draw = scorer_fleet.draw_augment

    def recorded(gen, n, config):
        seeds.append(gen.initial_seed())
        return draw(gen, n, config)

    monkeypatch.setattr(scorer_fleet, "draw_augment", recorded)
    model = tiny_resnet(seed=0)
    fleet = ScorerFleet(_dataset(), model, TrainConfig(**COMMON), "cpu")
    svc = ScorerService(_dataset(), model, TrainConfig(**COMMON, scorer_tenants=2), "cpu")
    fleet.close()
    svc.close()
    fleet.snapshot(model, 0)
    svc.snapshot(model, 0)
    f = [fleet.score_once() for _ in range(2)]
    t0 = [svc.score_once(0) for _ in range(2)]
    t1 = [svc.score_once(1) for _ in range(2)]
    assert seeds == [chunk_seed(0, 0), chunk_seed(0, 1)] * 2 + [
        chunk_seed(0, STRIDE), chunk_seed(0, STRIDE + 1)]
    for a, b in zip(f, t0):
        assert torch.equal(a.scores, b.scores) and torch.equal(a.slots, b.slots)
    for a, b in zip(t0, t1):
        assert torch.equal(a.slots, b.slots) and not torch.equal(a.scores, b.scores)
    tenants = svc.summary()["tenants"]
    assert [t["chunks_scored"] for t in tenants] == [2, 2]


@pytest.mark.parametrize("score", ["loss", "grad_norm"])
def test_score_once_matches_jax_service(score, jax_weights, monkeypatch):
    """Two chunks of tenants 0 and 1 from one snapshot at step 5, the port
    fed JAX's crops and flips of each chunk's key."""
    js, params, stats = jax_weights
    (x, y), _ = _data()
    jcfg = JConfig(model="resnet18", telemetry=False, importance_score=score,
                   scorer_tenants=2, **COMMON)
    jsvc = jsvc_mod.ScorerService(x, y, np.arange(N_TRAIN)[None], _jax_model(), MEAN, STD,
                                  jcfg)
    jsvc.close()
    jsvc.snapshot(js.params, js.batch_stats, step=5)
    jchunks = [jsvc.score_once(t) for t in (0, 0, 1, 1)]

    base = jax.random.fold_in(jax.random.key(jcfg.seed), 0x5C0)
    augs = iter([_augment(jax.random.split(jax.random.fold_in(base, t * STRIDE + k), 1)[0], R)
                 for t in (0, 1) for k in range(2)])
    monkeypatch.setattr(scorer_fleet, "draw_augment", lambda gen, n, config: next(augs))
    svc = ScorerService(_dataset(), _port_model(params, stats),
                        TrainConfig(importance_score=score, scorer_tenants=2, **COMMON), "cpu")
    svc.close()
    svc.snapshot(_port_model(params, stats), 5)
    chunks = [svc.score_once(t) for t in (0, 0, 1, 1)]
    for k, (c, jc) in enumerate(zip(chunks, jchunks)):
        assert c.step == jc.step == 5
        np.testing.assert_array_equal(c.slots.numpy(), jc.slots[0])
        np.testing.assert_allclose(c.scores.numpy(), jc.scores[0], rtol=1e-5, err_msg=str(k))
    assert not np.array_equal(chunks[0].scores.numpy(), chunks[2].scores.numpy())


# ------------------------------------------------------------------- pacing
@pytest.mark.parametrize("backend,workers", [("device", 1), ("device", 2), ("host", 1)])
def test_pacing(backend, workers):
    """The device backend scores at most ``max(2·workers, 2)`` chunks a
    snapshot epoch, however the queue is drained; the host backend scores
    on after a drain."""
    model = tiny_resnet(seed=0)
    cfg = TrainConfig(**COMMON, scorer_backend=backend, scorer_workers=workers)
    svc = ScorerService(_dataset(), model, cfg, "cpu")
    cap = max(2 * workers, 2)

    def scored():
        return svc.summary()["tenants"][0]["chunks_scored"]

    try:
        for epoch in range(2):
            svc.snapshot(model, epoch)
            _wait(lambda: scored() >= cap * (epoch + 1), f"{scored()} chunks scored")
            if backend == "host":
                before = scored()
                svc.drain_for_step(epoch)
                _wait(lambda: scored() > before, "the host backend stopped after a drain")
                continue
            for _ in range(3):
                svc.drain_for_step(epoch)
                time.sleep(0.05)
            assert scored() == cap * (epoch + 1)
    finally:
        svc.close()
    assert svc.summary()["closed"] and not _svc_threads()


# ---------------------------------------------------------------------- SLOs
def _slo_sequence(svc, snapshot, queue_of, set_delivered):
    """One scripted sequence of deliveries and ``slo_status`` calls; the
    statuses and tenant 0's breach count after each."""
    out = []

    def status(step):
        out.append((svc.slo_status(step), svc.stats()["scorer/slo_breaches/t0"]))

    status(10)                                     # nothing delivered yet
    snapshot(0)
    queue_of(0).put_nowait(svc.score_once(0))
    set_delivered(0, 0)
    status(2)                                      # healthy
    status(5)                                      # staleness 5 > 3: a breach
    status(6)                                      # still, latched
    svc.drain_for_step(6)
    snapshot(6)
    queue_of(0).put_nowait(svc.score_once(0))
    set_delivered(0, 6)
    status(7)                                      # recovered
    queue_of(0).put_nowait(svc.score_once(0))
    status(8)                                      # queue depth 2 >= 2
    status(20)                                     # both
    queue_of(1).put_nowait(svc.score_once(1))
    set_delivered(1, 6)
    status(20)
    out.append(sorted(svc.stats()))
    return out


def test_slo_status_matches_jax(jax_weights):
    """Staleness and high-water breaches: JAX's text, the rising-edge
    latch, a second count after a recovery, and
    ``scorer/slo_breaches/t{i}``."""
    js, params, stats = jax_weights
    (x, y), _ = _data()
    kw = dict(COMMON, scorer_tenants=2, slo_score_staleness_max=3, scorer_queue_highwater=2)
    jsvc = jsvc_mod.ScorerService(x, y, np.arange(N_TRAIN)[None], _jax_model(), MEAN, STD,
                                  JConfig(model="resnet18", **kw))
    jsvc.close()

    def jset(t, step):
        jsvc._tenants[t].last_delivered_step = step

    jout = _slo_sequence(jsvc, lambda s: jsvc.snapshot(js.params, js.batch_stats, s),
                         lambda t: jsvc._tenants[t].ready, jset)
    model = _port_model(params, stats)
    svc = ScorerService(_dataset(), model, TrainConfig(**kw), "cpu")
    svc.close()

    def pset(t, step):
        svc._tenants[t].last_delivered_step = step

    out = _slo_sequence(svc, lambda s: svc.snapshot(model, s), lambda t: svc._tenants[t].ready,
                        pset)
    assert out == jout
    assert out[2] == ("t0: staleness 5 > 3", 1.0) and out[3][1] == 1.0
    assert out[4] == (None, 1.0) and out[5] == ("t0: queue depth 2 >= 2", 2.0)
    assert svc.summary()["tenants"][0]["slo_breaches"] == 2


@pytest.mark.parametrize("tenants", [1, 4])
def test_stats_and_summary_keys_match_jax(tenants):
    (x, y), _ = _data()
    kw = dict(COMMON, scorer_tenants=tenants)
    jsvc = jsvc_mod.ScorerService(x, y, np.arange(N_TRAIN)[None], _jax_model(), MEAN, STD,
                                  JConfig(model="resnet18", **kw))
    svc = ScorerService(_dataset(), tiny_resnet(seed=0), TrainConfig(**kw), "cpu")
    try:
        assert set(svc.stats()) == set(jsvc.stats())
        summary, jsummary = svc.summary(), jsvc.summary()
        assert set(summary) == set(jsummary)
        assert [set(t) for t in summary["tenants"]] == [set(t) for t in jsummary["tenants"]]
        assert len(summary["tenants"]) == tenants
    finally:
        svc.close()
        jsvc.close()


# ----------------------------------------------------------------- the Trainer
CHOICES = [dict(), dict(scorer_backend="device"), dict(scorer_tenants=2),
           dict(slo_score_staleness_max=4), dict(scorer_queue_highwater=2)]


def test_trainer_chooses_as_jax(monkeypatch):
    """The JAX Trainer's choice of service or fleet (its scorers stubbed)
    and the port's, for five configs."""
    from mercury_tpu.parallel.mesh import host_cpu_mesh
    from mercury_tpu.train.trainer import Trainer as JTrainer

    built = []

    class Stub:
        def __init__(self, *args, **kwargs):
            built.append(self.kind)

        def snapshot(self, *args, **kwargs):
            pass

        def close(self, *args, **kwargs):
            pass

    monkeypatch.setattr(jsvc_mod, "ScorerService", type("S", (Stub,), {"kind": "service"}))
    monkeypatch.setattr(jfleet_mod, "ScorerFleet", type("F", (Stub,), {"kind": "fleet"}))
    for kw in CHOICES:
        jcfg = JConfig(model="smallcnn", dataset="synthetic", world_size=1, batch_size=8,
                       presample_batches=2, num_epochs=1, steps_per_epoch=2, eval_every=0,
                       log_every=0, heartbeat_every=0, checkpoint_every=0,
                       compute_dtype="float32", seed=0, sampler="scoretable",
                       refresh_size=8, refresh_mode="async", **kw)
        JTrainer(jcfg, mesh=host_cpu_mesh(1)).close()
        tr = _trainer(**kw)
        try:
            kind = "service" if isinstance(tr._scorer_fleet, ScorerService) else "fleet"
            assert kind == built[-1], kw
        finally:
            tr.close()
    assert built == ["fleet"] + ["service"] * 4


def _trainer(**kw):
    cfg = TrainConfig(**{**COMMON, "eval_every": 0, "log_every": 0, **kw})
    return Trainer(cfg, dataset=_dataset(), device="cpu", model=tiny_resnet(seed=0))


def test_fit_with_the_device_backend():
    """Eight steps, a snapshot every 4: the loss finite, every applied
    chunk at most 4 + the queue's depth steps old, none rejected."""
    tr = _trainer(scorer_backend="device", snapshot_every=4, log_every=8)
    ages = []
    note = tr._scorer_fleet.note_applied
    tr._scorer_fleet.note_applied = lambda age: (ages.append(age), note(age))
    try:
        out = tr.fit(steps=8)
        assert np.isfinite(out["train/loss"]) and out["sampler/chunks_rejected"] == 0.0
        assert ages and max(ages) <= 4 + 2, ages
        summary = tr._scorer_fleet.summary()
        assert summary["snapshots"] == 3 and summary["snapshot_step"] == 8
        assert summary["program"]["backend"] == "device" and not summary["lockstep"]
        assert summary["chunks_applied"] == len(ages)
        # Paced: at most a queue's worth a snapshot epoch.
        assert summary["chunks_scored"] <= 2 * summary["snapshots"]
        for key in ("scorer/throughput/t0", "scorer/staleness", "sampler/refresh_lag_chunks",
                    "sampler/score_staleness_max"):
            assert np.isfinite(out[key]), key
        assert torch.isfinite(tr.state.scoretable.scores).all()
        assert tr.state.scoretable.cursor == 0
    finally:
        tr.close()


def test_two_tenants_discard_what_tenant_1_gets():
    tr = _trainer(scorer_tenants=2, scorer_tenant_weights="3,1", snapshot_every=2)
    try:
        svc = tr._scorer_fleet
        _wait(lambda: svc.summary()["tenants"][1]["chunks_scored"] >= 1, "tenant 1 scored none")
        tr.fit(steps=6)
        tenants = svc.summary()["tenants"]
        assert tenants[0]["delivered"] == svc.summary()["chunks_applied"] >= 1
        assert tenants[0]["discarded"] == 0
        assert tenants[1]["delivered"] >= 1
        assert tenants[1]["discarded"] == tenants[1]["delivered"]
    finally:
        tr.close()


def test_restore_empties_every_tenant_queue(tmp_path):
    tr = _trainer(checkpoint_dir=str(tmp_path), scorer_tenants=2, scorer_throttle_s=30.0)
    try:
        tr.fit(steps=3)   # saves at its end
        tr.train_step()
        svc = tr._scorer_fleet
        for t in (0, 1):
            svc._tenants[t].ready.put(svc.score_once(t))
        assert svc.summary()["queue_depth"] >= 2
        assert tr.restore() == 3
        summary = svc.summary()
        assert summary["queue_depth"] == 0 and summary["snapshot_step"] == 3
        assert all(t["queue_depth"] == 0 for t in summary["tenants"])
        assert summary["generation"] == 1
        assert np.isfinite(float(tr.train_step()["train/loss"]))
    finally:
        tr.close()


def test_close_twice_leaves_no_service_thread():
    tr = _trainer(scorer_backend="device", scorer_workers=2)
    assert len(_svc_threads()) == 2
    tr.close()
    tr.close()
    assert not _svc_threads() and not tr._scorer_fleet.alive()


# ------------------------------------------------------------ the scorer's card
@pytest.mark.parametrize("own,in_use,visible,want", [
    (0, [0], 1, 0),
    (0, [0], 2, 1),
    (0, [0], 8, 1),
    (0, [0, 1], 1, 0),
    (0, [0, 1], 2, 0),
    (0, [0, 1], 8, 2),
    (1, [0, 1], 2, 1),
    (3, [1, 3], 4, 0),
], ids=lambda v: str(v))
def test_reserve_scorer_device(own, in_use, visible, want):
    """The first visible card no rank of the host trains on, else the
    rank's own (JAX's ``reserve_scorer_slice``)."""
    from mercury_tpu_torch.parallel.distributed import cards_in_use, reserve_scorer_device

    card = torch.device("cuda", own)
    assert reserve_scorer_device(card, in_use, visible=visible) == torch.device("cuda", want)
    # Without a process group the host's cards in use are the rank's own.
    assert cards_in_use(card) == [own]
