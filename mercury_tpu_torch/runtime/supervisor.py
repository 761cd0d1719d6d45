"""HostSupervisor: the port's own copy of
``mercury_tpu/runtime/supervisor.py``, the half of the control loop that
acts on failure.

It watches the liveness of each supervised host thread fleet (the scorer
fleet or service, the prefetch pipeline), restarts a dead one with
exponential backoff under a restart budget and, once the scorer's budget
is spent, walks the importance sampler down a ladder instead of ending
the run:

    level 0  ASYNC    the scorer's workers refresh the table off the step
    level 1  SYNC     the training thread scores a window itself
                      (``score_once``, no worker threads)
    level 2  FROZEN   no refresh; the step's decay flattens the table
                      toward the EMA mean
    level 3  UNIFORM  the table is pinned to a constant, so the step's
                      inverse-CDF draw is uniform (``sampler/is_active=0``)

No level changes the step: only which host path feeds the table (0, 1),
whether any does (2), or whether its contents are constant (3). When the
importance estimates cannot be trusted, sample uniformly.

A probe every ``probe_every`` steps (a scoring round on the training
thread) climbs back: each success climbs one level, and the climb into
level 0 first revives the workers, whose units then get a fresh budget.
A probe that fails at a degraded level descends one more, so a lasting
fault walks the ladder to uniform and stays there, probing, until it
clears. A registered SLO's breach descends one level on its rising edge
and holds the probes back while it lasts.

Every transition is logged, counted in :meth:`HostSupervisor.stats`,
dumped as a flight record by the anomaly engine and journaled with its
cause as parent. Decisions and restarts happen on the training thread, in
:meth:`HostSupervisor.tick`, :meth:`~HostSupervisor.request_restart` and
:meth:`~HostSupervisor.report_failure`; the optional ``mercury-supervisor``
thread (``poll_s > 0``) only timestamps a death between ticks.

**The ladder across ranks.** The JAX package runs W ranks in one process,
with one supervisor that sees every rank's faults; the port runs a process
a rank, each with its own supervisor. With ``agree`` (the Trainer's at
W > 1: an all-reduce MAX of a few integers over the ranks) the ranks act
as that one supervisor: at every :meth:`HostSupervisor.tick`, after its own
units and SLOs, each rank agrees its ``[level, probe pinned]`` with the
others and descends to the highest level any rank reached (each level a
``supervisor/degrade`` of its own, as the one supervisor would descend), so
every rank acts on the same level at every step. The probes then fall on
the same steps, and a probe's climb needs every rank's probe to succeed
(one more agreement, on a probe's tick only): a failure on any rank
descends them all.

Two additions to the JAX supervisor: the agreement above, and: a unit may name its death's cause
(``register_unit(..., cause=)``, the journal id of the fault that killed
it), which its restart, failed restart and exhaustion events take as
parent, so a chaos run's ladder walk reads back to the ``fault/fired``
that began it. Without ``cause`` every event is the JAX supervisor's.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Callable, Dict, List, Optional

from mercury_tpu_torch.utils.logging import get_logger

_log = get_logger(__name__)

__all__ = ["HostSupervisor", "LEVEL_NAMES", "BUDGET_BUCKETS"]

#: The ladder's level names, index = level.
LEVEL_NAMES = ("async", "sync", "frozen", "uniform")

#: A unit's restart budget, in the order it is used up: ``fresh`` (no
#: attempt), ``partial`` (some), ``spent`` (all, the exhaustion not yet
#: handled), ``exhausted`` (handled once). :meth:`HostSupervisor.summary`
#: reports the worst escalating unit's.
BUDGET_BUCKETS = ("fresh", "partial", "spent", "exhausted")


class _Slo:
    """One registered service-level objective and its breach latch."""

    __slots__ = ("name", "check_fn", "breached", "breaches", "episode_event")

    def __init__(self, name: str, check_fn: Callable[[], Optional[str]]) -> None:
        self.name = name
        self.check_fn = check_fn
        self.breached = False   # rising-edge latch: one descent a breach
        self.breaches = 0
        # The breach event that opened the episode: the descent it causes
        # and the release both name it as parent.
        self.episode_event: Optional[str] = None


class _Unit:
    """One supervised thread fleet and its restart state."""

    __slots__ = ("name", "alive_fn", "restart_fn", "escalates", "cause_fn",
                 "restarts_used", "next_restart_t", "exhausted_handled",
                 "last_alive_t", "down_since_t", "last_fail_event")

    def __init__(self, name: str, alive_fn: Callable[[], bool],
                 restart_fn: Callable[[], None], escalates: bool,
                 cause_fn: Optional[Callable[[], Optional[str]]]) -> None:
        self.name = name
        self.alive_fn = alive_fn
        self.restart_fn = restart_fn
        self.escalates = escalates
        self.cause_fn = cause_fn
        self.restarts_used = 0
        self.next_restart_t = 0.0
        self.exhausted_handled = False
        self.last_alive_t = time.monotonic()
        self.down_since_t: Optional[float] = None
        # The latest failed restart's event: the parent of an exhaustion.
        self.last_fail_event: Optional[str] = None


class HostSupervisor:
    """Liveness, restarts and the degradation ladder.

    The Trainer registers each unit with an ``alive`` probe and a
    ``restart`` action, gives the ladder a ``probe`` (one scoring round on
    the training thread) and a ``revive`` (restart the workers), calls
    :meth:`tick` once a step of ``fit`` and merges :meth:`stats` into its
    log records; :meth:`level` says which refresh path the step takes. The
    metric writer's drain thread feeds :meth:`observe_record`.
    ``anomaly`` (an :class:`~mercury_tpu_torch.obs.anomaly.AnomalyEngine`)
    dumps a flight record at every transition; ``journal`` records them.
    ``agree`` takes this rank's list of integers and returns their
    elementwise maximum over the ranks (every rank calls it at the same
    tick); None at one rank."""

    def __init__(self, *, restart_budget: int = 3, backoff_s: float = 0.5,
                 probe_every: int = 200, poll_s: float = 0.0,
                 anomaly=None, journal=None,
                 agree: Optional[Callable[[List[int]], List[int]]] = None) -> None:
        self._budget = max(int(restart_budget), 0)
        self._backoff_s = max(float(backoff_s), 0.0)
        self._probe_every = max(int(probe_every), 0)
        self._anomaly = anomaly
        self._journal = journal
        # The ranks' agreement (elementwise MAX over the ranks), or None.
        self._agree = agree
        # A peer rank's latched SLO pins the probes here too.
        self._peer_pinned = False
        # The latest descent's event: the parent of the probes after it.
        self._last_degrade_event: Optional[str] = None
        self._units: List[_Unit] = []
        self._slos: List[_Slo] = []
        self._probe_fn: Optional[Callable[[], None]] = None
        self._revive_fn: Optional[Callable[[], None]] = None
        # One lock over all mutable state: tick() (training thread),
        # observe_record() (drain thread) and the poll thread touch it.
        self._lock = threading.Lock()
        self._level = 0
        self._next_probe_step = 0
        self._restarts = 0
        self._degradations = 0
        self._recoveries = 0
        self._last_record_step = -1
        self._last_record_t = 0.0
        self._transitions: List[Dict[str, Any]] = []
        self._closed = False
        self._poll_s = max(float(poll_s), 0.0)
        self._thread: Optional[threading.Thread] = None
        if self._poll_s > 0.0:
            self._thread = threading.Thread(target=self._poll_loop,
                                            name="mercury-supervisor", daemon=True)
            self._thread.start()

    # ------------------------------------------------------------- wiring
    def register_unit(self, name: str, alive: Callable[[], bool],
                      restart: Callable[[], None], escalates: bool = False,
                      cause: Optional[Callable[[], Optional[str]]] = None) -> None:
        """Supervise a thread fleet. ``escalates=True``: past its budget
        the ladder takes over (the scorer); False: past its budget its
        failure reaches the caller (the prefetch worker: no step runs
        without input). ``cause`` returns the journal id of what killed
        it, if known."""
        with self._lock:
            self._units.append(_Unit(name, alive, restart, escalates, cause))

    def register_slo(self, name: str, check: Callable[[], Optional[str]]) -> None:
        """Register an SLO: ``check`` returns a breach's description, or
        None while healthy, at every :meth:`tick`. A breach descends one
        level on its rising edge (latched: a lasting breach does not fall
        through to uniform) and holds the probes back until it clears."""
        with self._lock:
            self._slos.append(_Slo(name, check))

    def set_ladder(self, probe: Callable[[], None], revive: Callable[[], None]) -> None:
        """``probe`` scores a round on the training thread (raises on
        failure); ``revive`` restarts the workers for the climb to 0."""
        with self._lock:
            self._probe_fn = probe
            self._revive_fn = revive

    # ------------------------------------------------------------- queries
    def level(self) -> int:
        """The ladder's level (0-3): one int, read without the lock."""
        return self._level

    def level_name(self) -> str:
        return LEVEL_NAMES[self.level()]

    def sampler_active(self) -> bool:
        """False once at uniform sampling."""
        return self.level() < 3

    # ---------------------------------------------------------------- tick
    def tick(self, step: int) -> None:
        """Once a step, on the training thread: check each unit, restart
        under the budget and backoff, escalate past it, check the SLOs and
        probe on the cadence."""
        now = time.monotonic()
        with self._lock:
            units = list(self._units)
        for unit in units:
            if self._safe_alive(unit):
                with self._lock:
                    unit.last_alive_t = now
                    unit.down_since_t = None
                continue
            self._handle_down(unit, step, now)
        self._check_slos(step)
        if self._agree is not None:
            self._agree_level(step)
        self._maybe_probe(step)

    def _agree_level(self, step: int) -> None:
        """Agree ``[level, probe pinned]`` with the other ranks and descend
        to the highest level any rank is at, one level a transition."""
        with self._lock:
            mine = [self._level, int(any(s.breached for s in self._slos))]
        level, pinned = self._agree(mine)
        with self._lock:
            self._peer_pinned = bool(pinned)
        for _ in range(level - self.level()):
            self._degrade(step, f"agreed across the ranks: a rank is at {LEVEL_NAMES[level]}")

    def _check_slos(self, step: int) -> None:
        with self._lock:
            slos = list(self._slos)
        for slo in slos:
            try:
                status = slo.check_fn()
            except Exception as exc:
                _log.warning("supervisor: SLO check %s raised: %s", slo.name, exc)
                continue
            with self._lock:
                rising = status is not None and not slo.breached
                falling = status is None and slo.breached
                slo.breached = status is not None
                if rising:
                    slo.breaches += 1
                episode = slo.episode_event
                if falling:
                    slo.episode_event = None
            if rising:
                _log.warning("supervisor: SLO %s breached at step %d: %s",
                             slo.name, step, status)
                self._flight("supervisor_slo_breach", step,
                             {"slo": slo.name, "status": status})
                breach_eid = self._journal_emit("supervisor/slo_breach", step,
                                                detail={"slo": slo.name, "status": status})
                with self._lock:
                    slo.episode_event = breach_eid
                self._degrade(step, f"SLO {slo.name} breached: {status}", parent=breach_eid)
            elif falling:
                self._journal_emit("supervisor/slo_release", step, parent=episode,
                                   detail={"slo": slo.name})

    def request_restart(self, name: str, step: int) -> bool:
        """Restart one unit now (a failed ``pop``: no step runs without
        input), under the budget, sleeping out the backoff. False when the
        budget is spent or no unit has the name."""
        with self._lock:
            unit = self._find(name)
        if unit is None:
            return False
        if unit.restarts_used >= self._budget:
            self._note_exhausted(unit, step)
            return False
        wait = unit.next_restart_t - time.monotonic()
        if wait > 0:
            time.sleep(wait)
        return self._try_restart(unit, step)

    def report_failure(self, source: str, step: int, exc: BaseException,
                       parent: Optional[str] = None) -> None:
        """A degraded path failed on the training thread (the sync refresh
        raised): descend one level. ``parent`` names the event that caused
        it."""
        self._degrade(step, f"{source} failed: {type(exc).__name__}: {exc}", parent=parent)

    # ------------------------------------------------------ unit handling
    def _find(self, name: str) -> Optional[_Unit]:
        for u in self._units:  # the caller holds the lock
            if u.name == name:
                return u
        return None

    def _safe_alive(self, unit: _Unit) -> bool:
        try:
            return bool(unit.alive_fn())
        except Exception as exc:
            _log.warning("supervisor: alive probe for %s raised: %s", unit.name, exc)
            return False

    def _cause(self, unit: _Unit) -> Optional[str]:
        if unit.cause_fn is None:
            return None
        try:
            return unit.cause_fn()
        except Exception:
            return None

    def _handle_down(self, unit: _Unit, step: int, now: float) -> None:
        with self._lock:
            if unit.down_since_t is None:
                unit.down_since_t = now
            exhausted = unit.restarts_used >= self._budget
            backing_off = now < unit.next_restart_t
        if exhausted:
            self._note_exhausted(unit, step)
            return
        if backing_off:
            return
        self._try_restart(unit, step)

    def _try_restart(self, unit: _Unit, step: int) -> bool:
        cause = self._cause(unit)
        with self._lock:
            unit.restarts_used += 1
            attempt = unit.restarts_used
            # Exponential backoff before the next attempt may run.
            unit.next_restart_t = time.monotonic() + self._backoff_s * (2 ** (attempt - 1))
            self._restarts += 1
        try:
            unit.restart_fn()
        except Exception as exc:
            error = f"{type(exc).__name__}: {exc}"
            _log.warning("supervisor: restart %d/%d of %s FAILED: %s",
                         attempt, self._budget, unit.name, error)
            self._flight("supervisor_restart_failed", step,
                         {"unit": unit.name, "attempt": attempt, "budget": self._budget,
                          "error": error})
            fail_eid = self._journal_emit(
                "supervisor/restart_failed", step, parent=cause,
                detail={"unit": unit.name, "attempt": attempt, "budget": self._budget,
                        "error": error})
            with self._lock:
                unit.last_fail_event = fail_eid
            return False
        with self._lock:
            unit.down_since_t = None
            unit.exhausted_handled = False
        _log.warning("supervisor: restarted %s (attempt %d/%d) at step %d",
                     unit.name, attempt, self._budget, step)
        self._flight("supervisor_restart", step,
                     {"unit": unit.name, "attempt": attempt, "budget": self._budget})
        self._journal_emit("supervisor/restart", step, parent=cause,
                           detail={"unit": unit.name, "attempt": attempt,
                                   "budget": self._budget})
        return True

    def _note_exhausted(self, unit: _Unit, step: int) -> None:
        with self._lock:
            if unit.exhausted_handled:
                return
            unit.exhausted_handled = True
            escalates = unit.escalates
            fail_eid = unit.last_fail_event
        if fail_eid is None:
            fail_eid = self._cause(unit)
        exhausted_eid = self._journal_emit(
            "supervisor/exhausted", step, parent=fail_eid,
            detail={"unit": unit.name, "budget": self._budget, "escalates": escalates})
        if escalates:
            self._degrade(step, f"{unit.name} restart budget ({self._budget}) exhausted",
                          parent=exhausted_eid)
        else:
            _log.warning("supervisor: %s is down with its restart budget (%d) exhausted: "
                         "its next failure reaches the caller", unit.name, self._budget)
            self._flight("supervisor_exhausted", step,
                         {"unit": unit.name, "budget": self._budget})

    # ------------------------------------------------------------- ladder
    def _degrade(self, step: int, reason: str, parent: Optional[str] = None) -> None:
        with self._lock:
            if self._level >= len(LEVEL_NAMES) - 1:
                return
            src = self._level
            self._level = dst = src + 1
            self._degradations += 1
            self._transitions.append({"step": step, "from": LEVEL_NAMES[src],
                                      "to": LEVEL_NAMES[dst], "reason": reason})
        _log.warning("supervisor: DEGRADE %s -> %s at step %d (%s)",
                     LEVEL_NAMES[src], LEVEL_NAMES[dst], step, reason)
        self._flight("supervisor_degrade", step,
                     {"from": LEVEL_NAMES[src], "to": LEVEL_NAMES[dst], "reason": reason})
        eid = self._journal_emit("supervisor/degrade", step, parent=parent,
                                 detail={"from": LEVEL_NAMES[src], "to": LEVEL_NAMES[dst],
                                         "reason": reason})
        with self._lock:
            self._last_degrade_event = eid

    def _recover(self, step: int, reason: str, parent: Optional[str] = None) -> None:
        with self._lock:
            if self._level <= 0:
                return
            src = self._level
            self._level = dst = src - 1
            self._recoveries += 1
            if dst == 0:
                # Back at nominal: the escalating units earn a fresh budget.
                for u in self._units:
                    if u.escalates:
                        u.restarts_used = 0
                        u.exhausted_handled = False
                        u.next_restart_t = 0.0
            self._transitions.append({"step": step, "from": LEVEL_NAMES[src],
                                      "to": LEVEL_NAMES[dst], "reason": reason})
        _log.warning("supervisor: RECOVER %s -> %s at step %d (%s)",
                     LEVEL_NAMES[src], LEVEL_NAMES[dst], step, reason)
        self._flight("supervisor_recover", step,
                     {"from": LEVEL_NAMES[src], "to": LEVEL_NAMES[dst], "reason": reason})
        self._journal_emit("supervisor/recover", step, parent=parent,
                           detail={"from": LEVEL_NAMES[src], "to": LEVEL_NAMES[dst],
                                   "reason": reason})

    def _maybe_probe(self, step: int) -> None:
        with self._lock:
            # A breaching SLO pins the ladder: climbing while it lasts would
            # oscillate (recover, breach again, descend).
            slo_pinned = any(s.breached for s in self._slos) or self._peer_pinned
            due = (self._level > 0 and self._probe_every > 0
                   and not slo_pinned and step >= self._next_probe_step)
            if due:
                self._next_probe_step = step + self._probe_every
            probe, revive, level = self._probe_fn, self._revive_fn, self._level
            degrade_eid = self._last_degrade_event
        if not due or probe is None:
            return
        error: Optional[BaseException] = None
        try:
            if level == 1 and revive is not None:
                # The last climb needs live workers: revive them, then
                # check that scoring works.
                revive()
            probe()
        except Exception as exc:
            error = exc
        # Across ranks the climb needs every rank's probe.
        peer_failed = (self._agree is not None
                       and self._agree([0 if error is None else 1])[0] > 0)
        if error is not None:
            peid = self._journal_emit(
                "supervisor/probe_failed", step, parent=degrade_eid,
                detail={"level": level, "level_name": LEVEL_NAMES[level],
                        "error": f"{type(error).__name__}: {error}"})
            self.report_failure("recovery probe", step, error, parent=peid)
            return
        if peer_failed:
            peid = self._journal_emit(
                "supervisor/probe_failed", step, parent=degrade_eid,
                detail={"level": level, "level_name": LEVEL_NAMES[level],
                        "error": "the probe failed on another rank"})
            self._degrade(step, "recovery probe failed on another rank", parent=peid)
            return
        peid = self._journal_emit("supervisor/probe_ok", step, parent=degrade_eid,
                                  detail={"level": level, "level_name": LEVEL_NAMES[level]})
        self._recover(step, "recovery probe succeeded", parent=peid)

    # ------------------------------------------------- observer / monitor
    def observe_record(self, record: Dict[str, float]) -> None:
        """The metric writer's observer (drain thread): note the latest
        record, the metric plane's heartbeat. Never raises."""
        try:
            with self._lock:
                self._last_record_step = int(record.get("step", -1))
                self._last_record_t = time.monotonic()
        except Exception:
            pass

    def _poll_loop(self) -> None:
        """The poll thread: timestamp each unit's liveness between ticks;
        restarts and ladder moves stay on the training thread."""
        while not self._closed:
            now = time.monotonic()
            with self._lock:
                units = list(self._units)
            for unit in units:
                alive = self._safe_alive(unit)
                with self._lock:
                    if alive:
                        unit.last_alive_t = now
                    elif unit.down_since_t is None:
                        unit.down_since_t = now
            deadline = time.monotonic() + self._poll_s
            while not self._closed:
                left = deadline - time.monotonic()
                if left <= 0:
                    break
                time.sleep(min(left, 0.05))

    def close(self, timeout: float = 5.0) -> None:
        """Stop the poll thread; a second call does nothing."""
        if self._closed:
            return
        self._closed = True
        if self._thread is not None:
            self._thread.join(timeout=timeout)

    # ----------------------------------------------------------- telemetry
    def _journal_emit(self, kind: str, step: int, parent: Optional[str] = None,
                      detail: Optional[Dict[str, Any]] = None) -> Optional[str]:
        """Journal one event and return its id (None without a journal);
        never raises."""
        if self._journal is None:
            return None
        try:
            return self._journal.emit(kind, step, parent=parent, detail=detail)
        except Exception as exc:
            _log.warning("supervisor: journal emit %s failed: %s", kind, exc)
            return None

    def _flight(self, kind: str, step: int, detail: Dict[str, Any]) -> None:
        if self._anomaly is None:
            return
        try:
            self._anomaly.dump_flight_record(kind, step, detail)
        except Exception as exc:
            _log.warning("supervisor: flight record %s failed: %s", kind, exc)

    def stats(self) -> Dict[str, float]:
        """The log record's ``supervisor/*`` keys and ``sampler/is_active``."""
        with self._lock:
            down = sum(1 for u in self._units if u.down_since_t is not None)
            latched = sum(1 for s in self._slos if s.breached)
            return {
                "supervisor/level": float(self._level),
                "supervisor/restarts": float(self._restarts),
                "supervisor/degradations": float(self._degradations),
                "supervisor/recoveries": float(self._recoveries),
                "supervisor/units_down": float(down),
                "supervisor/slo_breaches": float(sum(s.breaches for s in self._slos)),
                "supervisor/slo_latched": float(latched),
                "supervisor/probe_pinned": 1.0 if latched else 0.0,
                "sampler/is_active": 0.0 if self._level >= 3 else 1.0,
            }

    def _unit_bucket_locked(self, unit: _Unit) -> str:
        if unit.exhausted_handled:
            return BUDGET_BUCKETS[3]
        if unit.restarts_used > 0 and unit.restarts_used >= self._budget:
            return BUDGET_BUCKETS[2]
        if unit.restarts_used > 0:
            return BUDGET_BUCKETS[1]
        return BUDGET_BUCKETS[0]

    def _model_state_locked(self) -> Dict[str, Any]:
        """The (level, budget bucket, latched SLOs, pin) state, with the
        JAX package's ``state_id``: the worst escalating unit's bucket,
        the latched SLOs as ``slo<i>`` in registration order."""
        bucket = BUDGET_BUCKETS[0]
        for u in self._units:  # the caller holds the lock
            if not u.escalates:
                continue
            b = self._unit_bucket_locked(u)
            if BUDGET_BUCKETS.index(b) > BUDGET_BUCKETS.index(bucket):
                bucket = b
        latched = [s.name for s in self._slos if s.breached]
        slots = [f"slo{i}" for i, s in enumerate(self._slos) if s.breached]
        pinned = bool(latched)
        latch = "+".join(slots) if slots else "none"
        pin = "pinned" if pinned else "free"
        return {"level": self._level, "level_name": LEVEL_NAMES[self._level],
                "budget_bucket": bucket, "latched_slos": latched, "probe_pinned": pinned,
                "state_id": f"L{self._level}/{bucket}/{latch}/{pin}"}

    def model_state(self) -> Dict[str, Any]:
        with self._lock:
            return self._model_state_locked()

    def summary(self) -> Dict[str, Any]:
        """Everything so far, for flight records and
        ``supervisor_summary.json``. ``plan`` is the JAX auto-planner's
        decision: None, as there without a planner (the port has none)."""
        with self._lock:
            return {
                "plan": None,
                "level": self._level,
                "level_name": LEVEL_NAMES[self._level],
                "model_state": self._model_state_locked(),
                "restart_budget": self._budget,
                "restarts": self._restarts,
                "degradations": self._degradations,
                "recoveries": self._recoveries,
                "last_record_step": self._last_record_step,
                "transitions": list(self._transitions),
                "units": [{"name": u.name, "restarts_used": u.restarts_used,
                           "down": u.down_since_t is not None} for u in self._units],
                "slos": [{"name": s.name, "breached": s.breached, "breaches": s.breaches}
                         for s in self._slos],
            }
