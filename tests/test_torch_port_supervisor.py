"""The port's supervisor (``mercury_tpu_torch/runtime/supervisor.py``)
against the JAX package's (``mercury_tpu/runtime/supervisor.py``), and the
supervised Trainer.

(a) Parity: each script of unit deaths and revivals, ticks, restart
requests, failures, probe outcomes and SLO breaches and releases drives
both supervisors through fake units of the same behaviour; ``stats()``,
``model_state()``, ``summary()`` (its transitions included; it holds no
clock reading) and each journal's kinds, steps, details and parent links
(as indices) are equal. The backoff is 0, so no script depends on time.

(a') The agreed ladder: two port supervisors, one a rank in threads of one
process with ``agree`` an exchange of maxima, walk each script exactly as
one JAX supervisor that sees both ranks' deaths, failures, probes and SLOs
(the level after every tick and the transitions).

(b) The Trainer, as the JAX package's ``tests/test_supervisor.py``: a
scorer death restarted within the budget (``-r1`` threads, level 0); a
chaos run past the budget ending green at uniform sampling, whose
flattened table draws as JAX's ``table_refresh_draw`` (interpret mode) does
from the same uniforms; a prefetch restart bit-equal to an uninterrupted
run, and its budget's exhaustion raising; the scorer service's SLO walking
one level; the NaN injection's flight record; the W=2 async ladder agreed
across two gloo ranks; the starvation share reaching the sampler monitor;
the 21 fields on the command line. Tiny sizes: a [1, 1]-stage ResNet of width 8, batch 4.
"""

import dataclasses
import json
import os
import threading
import time
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from mercury_tpu.config import TrainConfig as JConfig  # noqa: E402
from mercury_tpu.obs import events as jevents  # noqa: E402
from mercury_tpu.obs.sampler_health import SamplerHealthMonitor as JMonitor  # noqa: E402
from mercury_tpu.ops import table_refresh_draw_pallas  # noqa: E402
from mercury_tpu.runtime import supervisor as jsup  # noqa: E402
from mercury_tpu_torch import TrainConfig, Trainer, cli  # noqa: E402
from mercury_tpu_torch.data import cifar  # noqa: E402
from mercury_tpu_torch.data.partition import partition_data  # noqa: E402
from mercury_tpu_torch.data.pipeline import make_sharded_dataset  # noqa: E402
from mercury_tpu_torch.obs import events  # noqa: E402
from mercury_tpu_torch.ops import reference  # noqa: E402
from mercury_tpu_torch.parallel.distributed import spawn  # noqa: E402
from mercury_tpu_torch.runtime import supervisor as tsup  # noqa: E402
from test_torch_port_ranks import ladder_rank, state_tensors, tiny_resnet  # noqa: E402

B, R, N_TRAIN = 4, 8, 48
COMMON = dict(dataset="synthetic", world_size=1, batch_size=B, presample_batches=2,
              compute_dtype="float32", num_epochs=1, steps_per_epoch=10, eval_every=0,
              log_every=0, heartbeat_every=0, seed=0, supervise=True,
              supervisor_backoff_s=0.0)
ASYNC = dict(sampler="scoretable", refresh_size=R, refresh_mode="async", snapshot_every=2)
STREAM = dict(data_placement="host_stream", prefetch_depth=2)

#: The 21 fields this slice brings, with the JAX package's names.
RUNTIME_FIELDS = (
    "supervise", "supervisor_restart_budget", "supervisor_backoff_s",
    "supervisor_probe_every", "supervisor_poll_s", "supervisor_sync_every",
    "event_journal",
    "anomaly_detection", "anomaly_window", "anomaly_slow_step_factor",
    "anomaly_cooldown_steps", "anomaly_profile_steps", "anomaly_dir",
    "anomaly_inject_nan_step", "anomaly_straggler_factor",
    "slo_mfu_floor", "slo_ess_floor", "slo_stall_frac_max", "slo_selection_gini_max",
    "slo_class_starvation_share", "slo_var_ratio_patience",
)


@pytest.fixture(autouse=True, scope="module")
def one_intra_op_thread():
    """One intra-op thread: the tiny steps run far slower with torch's
    thread pool on cores the test workers share."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# ------------------------------------------------------------ (a) parity
class FakeUnit:
    """A supervisable fleet with scripted liveness and restarts."""

    def __init__(self, fail_restarts=0):
        self.up = True
        self.restarts = 0
        self.fail_restarts = fail_restarts   # the first N restarts raise

    def alive(self):
        return self.up

    def restart(self):
        self.restarts += 1
        if self.restarts <= self.fail_restarts:
            raise RuntimeError("injected restart failure")
        self.up = True


class Rig:
    """One supervisor with its fake units, probe, revive and SLOs, a
    journal of its own package, all driven by a script."""

    def __init__(self, mod, journal, units, budget, probe_every, slos):
        self.sup = mod.HostSupervisor(restart_budget=budget, backoff_s=0.0,
                                      probe_every=probe_every, journal=journal)
        self.units = {}
        for name, escalates, fail in units:
            unit = FakeUnit(fail)
            self.units[name] = unit
            self.sup.register_unit(name, unit.alive, unit.restart, escalates=escalates)
        self.probe_ok = True
        self.calls = []
        self.sup.set_ladder(probe=self._probe, revive=lambda: self.calls.append("revive"))
        self.slo = {name: None for name in slos}
        for name in slos:
            self.sup.register_slo(name, lambda name=name: self.slo[name])
        self.results = []

    def _probe(self):
        self.calls.append("probe")
        if not self.probe_ok:
            raise RuntimeError("still broken")

    def run(self, op):
        kind, *args = op
        if kind == "down":
            self.units[args[0]].up = False
        elif kind == "tick":
            self.sup.tick(args[0])
        elif kind == "request":
            self.results.append(self.sup.request_restart(args[0], args[1]))
        elif kind == "fail":
            self.sup.report_failure(args[0], args[1], RuntimeError("x"))
        elif kind == "probe":
            self.probe_ok = args[0]
        elif kind == "slo":
            self.slo[args[0]] = args[1]
        elif kind == "record":
            self.sup.observe_record({"step": args[0]})
        self.results.append((self.sup.level(), self.sup.stats()))


SCRIPTS = {
    "restart_within_budget": dict(
        units=[("scorer", True, 0)], budget=3, probe_every=0, slos=[],
        ops=[("down", "scorer"), ("tick", 1), ("tick", 2), ("down", "scorer"), ("tick", 3)]),
    "escalating_exhaustion": dict(
        units=[("scorer", True, 0)], budget=1, probe_every=0, slos=[],
        ops=[("down", "scorer"), ("tick", 1), ("down", "scorer"), ("tick", 2), ("tick", 3)]),
    "non_escalating_exhaustion": dict(
        units=[("prefetch", False, 0)], budget=0, probe_every=0, slos=[],
        ops=[("down", "prefetch"), ("tick", 1), ("request", "prefetch", 1), ("tick", 2)]),
    "request_restart_budget": dict(
        units=[("prefetch", False, 0)], budget=2, probe_every=0, slos=[],
        ops=[("request", "prefetch", 1), ("request", "prefetch", 2),
             ("request", "prefetch", 3), ("request", "unknown", 3)]),
    "failed_restarts": dict(
        units=[("scorer", True, 5)], budget=1, probe_every=0, slos=[],
        ops=[("down", "scorer"), ("tick", 1), ("down", "scorer"), ("tick", 2), ("tick", 3)]),
    "ladder_order_and_uniform": dict(
        units=[], budget=3, probe_every=0, slos=[],
        ops=[("fail", "a", 0), ("fail", "b", 1), ("fail", "c", 2), ("fail", "d", 3)]),
    "probe_climbs_and_revives": dict(
        units=[], budget=3, probe_every=1, slos=[],
        ops=[("fail", "a", 0), ("fail", "b", 0), ("tick", 1), ("tick", 2), ("tick", 3)]),
    "probe_failure_walks_down": dict(
        units=[], budget=3, probe_every=1, slos=[],
        ops=[("probe", False), ("fail", "a", 0), ("tick", 1), ("tick", 2), ("tick", 3),
             ("probe", True), ("tick", 4), ("tick", 5), ("tick", 6), ("tick", 7)]),
    "recovery_resets_budget": dict(
        units=[("scorer", True, 0), ("prefetch", False, 0)], budget=1, probe_every=1,
        slos=[], ops=[("down", "scorer"), ("tick", 1), ("down", "scorer"), ("tick", 2),
                      ("tick", 3), ("down", "prefetch"), ("tick", 4), ("down", "prefetch"),
                      ("tick", 5)]),
    "probe_cadence": dict(
        units=[], budget=3, probe_every=3, slos=[],
        ops=[("probe", False), ("fail", "a", 0), ("tick", 1), ("tick", 2), ("tick", 3),
             ("probe", True), ("tick", 4), ("tick", 5), ("tick", 6), ("tick", 7)]),
    "slo_breach_latch_and_release": dict(
        units=[("scorer_service", True, 0)], budget=3, probe_every=1,
        slos=["scorer_service", "other"],
        ops=[("slo", "scorer_service", "t0: staleness 9 > 4"), ("tick", 1), ("tick", 2),
             ("slo", "other", "queue depth 4 >= 2"), ("tick", 3),
             ("slo", "scorer_service", None), ("tick", 4), ("slo", "other", None),
             ("tick", 5), ("tick", 6), ("slo", "scorer_service", "again"), ("tick", 7),
             ("record", 7), ("slo", "scorer_service", None), ("tick", 8), ("tick", 9)]),
}


def _journal_rows(rows):
    """Kinds, steps, details and parent links as indices (no ids, no
    clock readings)."""
    index = {r["event_id"]: i for i, r in enumerate(rows)}
    return [(r["kind"], r["step"], r["detail"],
             None if r["parent_id"] is None else index[r["parent_id"]]) for r in rows]


def _drive(mod, ev_mod, directory, script):
    journal = ev_mod.EventJournal(str(directory), 0)
    rig = Rig(mod, journal, script["units"], script["budget"], script["probe_every"],
              script["slos"])
    for op in script["ops"]:
        rig.run(op)
    out = dict(results=rig.results, calls=rig.calls, stats=rig.sup.stats(),
               model_state=rig.sup.model_state(), summary=rig.sup.summary(),
               restarts=[u.restarts for u in rig.units.values()])
    journal.close()
    out["journal"] = _journal_rows(ev_mod.read_journal(journal.path))
    return out


@pytest.mark.parametrize("name", sorted(SCRIPTS))
def test_supervisor_matches_the_jax_package(name, tmp_path):
    mine = _drive(tsup, events, tmp_path / "port", SCRIPTS[name])
    theirs = _drive(jsup, jevents, tmp_path / "jax", SCRIPTS[name])
    for key in ("results", "calls", "stats", "model_state", "summary", "restarts",
                "journal"):
        assert mine[key] == theirs[key], key
    assert mine["summary"]["transitions"] == theirs["summary"]["transitions"]


def test_names_and_buckets_match_the_jax_package():
    assert tsup.LEVEL_NAMES == jsup.LEVEL_NAMES == ("async", "sync", "frozen", "uniform")
    assert tsup.BUDGET_BUCKETS == jsup.BUDGET_BUCKETS
    assert set(tsup.HostSupervisor().stats()) == set(jsup.HostSupervisor().stats())


def test_cause_parents_the_unit_events(tmp_path):
    """The port's one addition: a unit's ``cause`` parents its restart and
    its exhaustion; without it the events are the JAX supervisor's."""
    journal = events.EventJournal(str(tmp_path), 0)
    root = journal.emit("fault/fired", 1, detail={"fault": "scorer_die"})
    sup = tsup.HostSupervisor(restart_budget=1, backoff_s=0.0, probe_every=0,
                              journal=journal)
    unit = FakeUnit()
    sup.register_unit("scorer", unit.alive, unit.restart, escalates=True,
                      cause=lambda: root)
    unit.up = False
    sup.tick(1)   # restart 1/1
    unit.up = False
    sup.tick(2)   # exhausted → sync
    journal.close()
    rows = events.read_journal(journal.path)
    kinds = [r["kind"] for r in rows]
    assert kinds == ["fault/fired", "supervisor/restart", "supervisor/exhausted",
                     "supervisor/degrade"]
    chain = events.parent_chain(rows, rows[-1]["event_id"])
    assert [r["kind"] for r in chain] == ["fault/fired", "supervisor/exhausted",
                                          "supervisor/degrade"]
    assert rows[1]["parent_id"] == root


def test_poll_thread_stamps_a_death_and_stops():
    sup = tsup.HostSupervisor(poll_s=0.01)
    unit = FakeUnit()
    sup.register_unit("scorer", unit.alive, unit.restart)
    assert sup._thread is not None and sup._thread.name == "mercury-supervisor"
    assert sup._thread.daemon
    unit.up = False
    deadline = time.monotonic() + 5.0
    while not sup.summary()["units"][0]["down"]:
        assert time.monotonic() < deadline
        time.sleep(0.01)
    # The poll thread only stamps the death: restarts stay on tick().
    assert unit.restarts == 0 and sup.stats()["supervisor/units_down"] == 1.0
    sup.close()
    sup.close()
    assert not sup._thread.is_alive()
    assert tsup.HostSupervisor()._thread is None


# ------------------------------------------------ (a') the agreed ladder
class Exchange:
    """The ranks' agreement in one process: each rank's thread hands its
    integers in, and every rank gets the elementwise maximum."""

    def __init__(self, ranks):
        self.barrier = threading.Barrier(ranks)
        self.slots = [None] * ranks

    def agree_fn(self, rank):
        def agree(values):
            self.slots[rank] = list(values)
            self.barrier.wait(timeout=30)
            out = [max(col) for col in zip(*self.slots)]
            self.barrier.wait(timeout=30)
            return out
        return agree


#: Each script: per step, each rank's ops before its tick (rank → ops); a
#: unit is ``scorer`` (escalates) on every rank. One JAX supervisor sees
#: them all: a unit down on any rank, a probe that fails on any rank, an
#: SLO breached on any rank, every rank's reported failure.
AGREED = {
    "exhaustion_on_one_rank": dict(budget=0, probe_every=2, steps=12, ops={
        3: {1: [("down",), ("probe", False)]},
        7: {1: [("probe", True)]}}),
    "probe_fails_on_the_other_rank": dict(budget=0, probe_every=1, steps=8, ops={
        2: {0: [("down",)], 1: [("probe", False)]},
        5: {1: [("probe", True)]}}),
    "restarts_within_budget": dict(budget=2, probe_every=1, steps=6, ops={
        2: {0: [("down",)]}, 4: {1: [("down",)]}}),
    "reported_failure": dict(budget=3, probe_every=3, steps=9, ops={
        2: {1: [("probe", False), ("fail",)]}, 6: {1: [("probe", True)]}}),
    "slo_pins_every_rank": dict(budget=3, probe_every=1, steps=9, ops={
        2: {0: [("slo", "t0: staleness 9 > 4")]}, 6: {0: [("slo", None)]}}),
}


class RankRig:
    """One rank's supervisor (the port's, with ``agree``) or the one JAX
    supervisor, its ``scorer`` unit, probe, revive and SLO."""

    def __init__(self, mod, budget, probe_every, agree=None):
        kw = {} if agree is None else {"agree": agree}
        self.sup = mod.HostSupervisor(restart_budget=budget, backoff_s=0.0,
                                      probe_every=probe_every, **kw)
        self.unit = FakeUnit()
        self.sup.register_unit("scorer", self.unit.alive, self.unit.restart, escalates=True)
        self.probe_ok, self.slo = True, None
        self.sup.set_ladder(probe=self._probe, revive=lambda: None)
        self.sup.register_slo("scorer_service", lambda: self.slo)
        self.levels = []

    def _probe(self):
        if not self.probe_ok:
            raise RuntimeError("still broken")

    def apply(self, op, step):
        if op[0] == "down":
            self.unit.up = False
        elif op[0] == "probe":
            self.probe_ok = op[1]
        elif op[0] == "slo":
            self.slo = op[1]
        elif op[0] == "fail":
            self.sup.report_failure("sync refresh", step, RuntimeError("x"))

    def tick(self, step):
        self.sup.tick(step)
        self.levels.append(self.sup.level())

    def transitions(self):
        return [(t["step"], t["from"], t["to"]) for t in self.sup.summary()["transitions"]]


def _run_rank(rig, script, rank):
    for step in range(1, script["steps"] + 1):
        for op in script["ops"].get(step, {}).get(rank, []):
            rig.apply(op, step)
        rig.tick(step)


@pytest.mark.parametrize("name", sorted(AGREED))
def test_agreed_ladder_is_one_jax_supervisor(name):
    script = AGREED[name]
    exchange = Exchange(2)
    rigs = [RankRig(tsup, script["budget"], script["probe_every"], exchange.agree_fn(r))
            for r in range(2)]
    threads = [threading.Thread(target=_run_rank, args=(rigs[r], script, r))
               for r in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)

    one = RankRig(jsup, script["budget"], script["probe_every"])
    state = [dict(probe=True, slo=None) for _ in range(2)]
    for step in range(1, script["steps"] + 1):
        for rank in range(2):
            for op in script["ops"].get(step, {}).get(rank, []):
                if op[0] in ("down", "fail"):
                    one.apply(op, step)
                else:
                    state[rank][op[0]] = op[1]
        one.probe_ok = all(s["probe"] for s in state)
        one.slo = next((s["slo"] for s in state if s["slo"] is not None), None)
        one.tick(step)
    assert rigs[0].levels == rigs[1].levels == one.levels, name
    assert rigs[0].transitions() == rigs[1].transitions() == one.transitions(), name
    assert max(one.levels) > 0 or name == "restarts_within_budget"


def test_w2_async_ladder_is_agreed():
    """Two gloo ranks, the device backend's lockstep, ``supervise=True`` at
    budget 0 and ``scorer_die`` on rank 1 alone: both ranks act on the same
    level at every step and walk the same transitions, those of one JAX
    supervisor fed the death at the step rank 1 saw it; with probes off the
    ladder stays at sync and both ranks leave the lockstep; the fits end
    within their time (no rank waits at a barrier)."""
    # Unsupervised, the lockstep runs; supervised, the sync scoretable and
    # the host stream run at W>1; supervised async now builds too.
    TrainConfig(**{**COMMON, **ASYNC, "world_size": 2, "scorer_backend": "device",
                   "supervise": False})
    TrainConfig(**{**COMMON, "sampler": "scoretable", "world_size": 2})
    TrainConfig(**{**COMMON, **STREAM, "world_size": 2})
    (x, y), (xt, yt) = cifar.synthetic_cifar(10, 64, 8, seed=0)
    shards = partition_data(y, 2, "hetero", alpha=0.5, seed=0, min_size=10)
    data = (x, y, xt, yt, shards, cifar.CIFAR10_MEAN, cifar.CIFAR10_STD)
    for probe_every in (0, 3):
        config_kw = {**COMMON, **ASYNC, "world_size": 2, "scorer_backend": "device",
                     "supervisor_restart_budget": 0, "supervisor_probe_every": probe_every,
                     "supervisor_sync_every": 1}
        ranks = spawn(ladder_rank, 2, "gloo", config_kw, data, 10, 1, 3, timeout_s=300)
        assert ranks[0]["levels"] == ranks[1]["levels"], probe_every
        assert ranks[0]["acted"] == ranks[1]["acted"], probe_every
        moves = [[(t["step"], t["from"], t["to"]) for t in r["transitions"]] for r in ranks]
        assert moves[0] == moves[1] and moves[0], probe_every
        assert "exhausted" in ranks[1]["transitions"][0]["reason"]
        assert "agreed across the ranks" in ranks[0]["transitions"][0]["reason"]
        assert all(r["elapsed"] < 120 for r in ranks)
        died = moves[0][0][0]
        one = RankRig(jsup, 0, probe_every)
        # The climb to async revives the scorer, as restart_workers does.
        one.sup.set_ladder(probe=one._probe, revive=lambda: setattr(one.unit, "up", True))
        for step in range(1, 11):
            if step == died:
                one.unit.up = False
            one.tick(step)
        assert [lvl for _, lvl in ranks[0]["levels"]] == one.levels, probe_every
        assert moves[0] == one.transitions(), probe_every
        if probe_every == 0:
            assert max(one.levels) == 1 and all(r["released"] for r in ranks)
            assert [lvl for _, lvl in ranks[0]["acted"]][-1] == 1


# ------------------------------------------------------------ (b) trainer
def _dataset(placement="replicated"):
    (x, y), (xt, yt) = cifar.synthetic_cifar(10, N_TRAIN, 8, seed=0)
    return make_sharded_dataset((x, y), (xt, yt), [np.arange(N_TRAIN)], cifar.CIFAR10_MEAN,
                                cifar.CIFAR10_STD, 10, device=torch.device("cpu"),
                                placement=placement)


def _trainer(**kw) -> Trainer:
    cfg = TrainConfig(**{**COMMON, **kw})
    return Trainer(cfg, dataset=_dataset(cfg.data_placement), device="cpu",
                   model=tiny_resnet(seed=0))


def test_scorer_death_restarted_within_budget():
    """A one-shot death is restarted by tick(): level 0, one restart, the
    new workers named ``-r1``, the fleet alive."""
    tr = _trainer(**ASYNC, fault_spec="scorer_die@step=1")
    try:
        fleet = tr._scorer_fleet
        tr._faults.note_step(1)
        deadline = time.monotonic() + 20.0
        while fleet.alive():
            assert time.monotonic() < deadline
            fleet.drain()   # frees a worker parked on the full queue
            time.sleep(0.01)
        assert tr.supervisor.stats()["supervisor/units_down"] == 0.0
        tr.supervisor.tick(2)
        assert fleet.alive()
        assert fleet.summary()["restarts"] == 1 and fleet.summary()["generation"] == 1
        assert [t.name for t in fleet._threads] == ["mercury-scorer-0-r1"]
        stats = tr.supervisor.stats()
        assert stats["supervisor/restarts"] == 1.0 and stats["supervisor/level"] == 0.0
        tr.fit(steps=4)   # the restarted workers feed the table
        assert tr.supervisor.level() == 0
    finally:
        tr.close()
    assert not any(t.is_alive() for t in fleet._threads)


def _level3_draw_matches_jax(tr):
    """The step's draw on the flattened table: the port's plain sentinel
    draw (the kernel route's inputs) and the JAX TPU kernel in interpret
    mode, from the same uniforms: the same slots, p = 1/L, weights 1."""
    cfg = tr.config
    table = tr.state.scoretable.scores.clone()
    ema = tr.state.ema.value.clone()
    n = table.numel()
    key = jax.random.key(7)
    u = np.array(jax.random.uniform(key, (1, B), jnp.float32))
    sent = ema + (table[:1] - ema) * cfg.table_decay
    new_t, probs_t, sel_t, scaled_t = reference.table_refresh_draw(
        table, torch.zeros(1, dtype=torch.int64), sent, ema, torch.from_numpy(u[0]),
        cfg.is_alpha, cfg.table_decay)
    new_j, probs_j, sel_j, scaled_j = (np.asarray(a) for a in table_refresh_draw_pallas(
        key, jnp.asarray(table.numpy()), jnp.zeros(1, jnp.int32), jnp.asarray(sent.numpy()),
        jnp.asarray(ema.numpy()), B, alpha=cfg.is_alpha, decay=cfg.table_decay))
    np.testing.assert_array_equal(sel_t.numpy(), sel_j.reshape(-1))
    np.testing.assert_allclose(probs_t.numpy(), probs_j.reshape(-1), rtol=1e-6)
    np.testing.assert_allclose(probs_t.numpy(), np.full(n, 1.0 / n), rtol=1e-6)
    np.testing.assert_allclose(scaled_t.numpy(), np.ones(B), rtol=1e-6)
    np.testing.assert_allclose(scaled_j.reshape(-1), np.ones(B), rtol=1e-6)


def test_chaos_past_budget_ends_uniform(tmp_path):
    """Budget 0, a probe and a sync refresh every step, two every-step
    scorer deaths and a slow host: fit ends green at uniform sampling
    (``sampler/is_active=0``), the table constant, each descent's journal
    chain rooted at a ``fault/fired``, and the flattened table's draw as
    JAX's."""
    tr = _trainer(**ASYNC, steps_per_epoch=30, log_every=10, log_dir=str(tmp_path),
                  fault_spec=("scorer_die@step=1,every=1;scorer_die@step=1,every=1;"
                              "host_slow@step=1,every=1,secs=0.02"),
                  supervisor_restart_budget=0, supervisor_probe_every=1,
                  supervisor_sync_every=1)
    try:
        out = tr.fit()
        assert np.isfinite(out["train/loss"])
        stats = tr.supervisor.stats()
        assert stats["supervisor/level"] == 3.0, tr.supervisor.summary()
        assert stats["sampler/is_active"] == 0.0
        assert stats["supervisor/degradations"] >= 3.0
        table = tr.state.scoretable.scores
        assert torch.isfinite(table).all() and bool((table == table[0]).all())
        assert tr._actuated_level == 3
        assert [t["to"] for t in tr.supervisor.summary()["transitions"]][-1] == "uniform"
        _level3_draw_matches_jax(tr)
    finally:
        tr.close()
    rows = events.read_journal(os.path.join(tmp_path, "events.h0.jsonl"))
    degrades = [r for r in rows if r["kind"] == "supervisor/degrade"]
    assert [r["detail"]["to"] for r in degrades][-3:] == ["sync", "frozen", "uniform"]
    for r in degrades:
        assert events.parent_chain(rows, r["event_id"])[0]["kind"] == "fault/fired"
    summary = json.load(open(os.path.join(tmp_path, "supervisor_summary.json")))
    assert summary["level_name"] == "uniform"
    with open(os.path.join(tmp_path, "metrics.jsonl")) as f:
        records = [json.loads(line) for line in f]
    assert records[-1]["sampler/is_active"] == 0.0 and records[-1]["supervisor/level"] == 3.0


def test_recovery_probe_climbs_back_and_revives():
    """Budget 0 and a one-shot death: the run descends to sync, the probe
    revives the workers and climbs back to async with a fresh budget."""
    tr = _trainer(**ASYNC, fault_spec="scorer_die@step=1", supervisor_restart_budget=0,
                  supervisor_probe_every=2)
    try:
        fleet = tr._scorer_fleet
        tr._faults.note_step(1)
        deadline = time.monotonic() + 20.0
        while fleet.alive():
            assert time.monotonic() < deadline
            fleet.drain()
            time.sleep(0.01)
        tr.fit(steps=6)
        names = [(t["from"], t["to"]) for t in tr.supervisor.summary()["transitions"]]
        assert names == [("async", "sync"), ("sync", "async")]
        assert tr.supervisor.level() == 0 and fleet.alive()
        assert fleet.summary()["restarts"] == 1
        assert tr.supervisor.model_state()["budget_bucket"] == "fresh"
    finally:
        tr.close()


def test_prefetch_restart_resumes_bitwise():
    """A prefetch death mid-run: the supervisor rebuilds the pipeline from
    the ring, and the state is bit-equal to an uninterrupted run's."""
    kw = dict(**STREAM, steps_per_epoch=8)
    ref = _trainer(**kw, supervise=False)
    try:
        ref.fit()
        want = state_tensors(ref.state)
    finally:
        ref.close()
    tr = _trainer(**kw, fault_spec="prefetch_die@step=2")
    try:
        tr.fit()
        assert tr.supervisor.stats()["supervisor/restarts"] >= 1.0
        assert tr._stream_gen >= 1
        assert tr._stream_pipe._thread.name == f"mercury-prefetch-r{tr._stream_gen}"
        got = state_tensors(tr.state)
        assert sorted(got) == sorted(want)
        for k in want:
            assert torch.equal(got[k], want[k]), k
    finally:
        tr.close()


def test_prefetch_budget_exhaustion_raises():
    tr = _trainer(**STREAM, steps_per_epoch=8, supervisor_restart_budget=0,
                  fault_spec="prefetch_die@step=2")
    try:
        with pytest.raises(RuntimeError, match="prefetch worker died"):
            tr.fit()
    finally:
        tr.close()


def test_service_slo_walks_one_level():
    """A wedged tenant's staleness breaches the service's SLO: one descent
    (the latch), the probes pinned while it lasts."""
    tr = _trainer(**ASYNC, steps_per_epoch=20, slo_score_staleness_max=3,
                  supervisor_probe_every=1, fault_spec="scorer_wedge@step=2,tenant=0")
    try:
        assert type(tr._scorer_fleet).__name__ == "ScorerService"
        fleet = tr._scorer_fleet
        deadline = time.monotonic() + 20.0
        while fleet.summary()["tenants"][0]["chunks_scored"] == 0:
            assert time.monotonic() < deadline
            time.sleep(0.01)
        tr.fit()
        stats = tr.supervisor.stats()
        assert stats["supervisor/level"] == 1.0, tr.supervisor.summary()
        assert stats["supervisor/degradations"] == 1.0
        assert stats["supervisor/slo_latched"] == 1.0 and stats["supervisor/probe_pinned"] == 1.0
        assert tr.supervisor.summary()["slos"][0]["breaches"] == 1
        assert fleet.summary()["tenants"][0]["wedged"]
    finally:
        tr.close()


def test_nan_injection_writes_a_flight_record(tmp_path):
    tr = _trainer(**ASYNC, log_every=2, log_dir=str(tmp_path), anomaly_inject_nan_step=3)
    try:
        tr.fit(steps=6)
        tr.logger.flush()
        path = os.path.join(tmp_path, "flight_record_step4_non_finite.json")
        assert os.path.exists(path), sorted(os.listdir(tmp_path))
        doc = json.load(open(path))
        assert doc["trigger"]["kind"] == "non_finite"
        assert doc["trigger"]["detail"]["key"] == "train/loss"
        assert doc["device_memory"] == {} and doc["spans"] == []
        assert doc["config"]["anomaly_inject_nan_step"] == 3
        assert {"manifest", "scorer_fleet", "supervisor"} <= set(doc)
        assert tr.anomaly.trigger_counts == {"non_finite": 1}
        assert tr.logger.latest_record()["anomaly/triggers"] == 1.0
    finally:
        tr.close()


def test_starvation_share_reaches_the_monitor():
    """``slo_class_starvation_share`` is the monitor's share (0 leaves it
    at 0.2), as the JAX Trainer passes it; the same ledger gives the same
    starved-class count as the JAX monitor at that share."""
    rng = np.random.default_rng(0)
    ds = _dataset()
    shard = ds.shard_indices.numpy()
    labels = ds.y_train.numpy()
    counts = rng.integers(0, 3, size=shard.shape).astype(np.int32)
    counts[0, :10] = 40
    scores = rng.uniform(0.5, 2.0, size=shard.shape).astype(np.float32)
    ema = np.array([1.0], np.float32)
    for share, want in ((0.0, 0.2), (0.45, 0.45)):
        tr = _trainer(sampler="scoretable", refresh_size=R, slo_class_starvation_share=share)
        try:
            assert tr.sampler_monitor._starvation_share == want
            mine = tr.sampler_monitor.stats_of(counts, scores, ema)
        finally:
            tr.close()
        jcfg = JConfig(slo_class_starvation_share=share)
        theirs = JMonitor(shard, labels, 10, 0.5,
                          starvation_share=jcfg.slo_class_starvation_share or 0.2)
        assert theirs._starvation_share == want
        jstate = SimpleNamespace(sel_counts=counts, scoretable=SimpleNamespace(scores=scores),
                                 ema=SimpleNamespace(value=ema))
        jstats = theirs.stats(jstate)
        for key in ("sampler_dist/class_starved", "sampler_dist/class_share_min",
                    "sampler_dist/class_share_max"):
            assert mine[key] == pytest.approx(jstats[key], rel=1e-6), key


def test_runtime_fields_match_the_jax_package():
    jfields = {f.name: f.default for f in dataclasses.fields(JConfig)}
    tfields = {f.name: f.default for f in dataclasses.fields(TrainConfig)}
    for name in RUNTIME_FIELDS:
        assert tfields[name] == jfields[name], name
    assert len(RUNTIME_FIELDS) == 21 and len(tfields) == 106
    # JAX's one check of them: the anomaly ring must hold a record.
    with pytest.raises(ValueError, match="ring_steps must be >= 1"):
        _trainer(anomaly_window=0)


def test_command_line_shows_the_runtime_fields(capsys):
    assert cli.main(["--supervise", "true", "--supervisor-restart-budget", "1",
                     "--anomaly-dir", "/x", "--slo-mfu-floor", "0.5", "--event-journal",
                     "false", "--world-size", "1", "--print-config"]) == 0
    doc = json.loads(capsys.readouterr().out)
    config = doc.get("config", doc)
    for name in RUNTIME_FIELDS:
        assert name in config, name
    assert (config["supervise"], config["supervisor_restart_budget"], config["anomaly_dir"],
            config["slo_mfu_floor"], config["event_journal"]) == (True, 1, "/x", 0.5, False)
