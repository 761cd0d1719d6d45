"""Scoring as a service: the multi-tenant front over the scorer's chunks,
with the device backend's placement, pacing and lockstep — the PyTorch
counterpart of ``mercury_tpu/sampling/scorer_service.py``.

The ``Trainer`` builds a :class:`ScorerService` in place of the
:class:`~mercury_tpu_torch.sampling.scorer_fleet.ScorerFleet` when
``scorer_backend="device"``, ``scorer_tenants > 1`` or a scoring SLO is
armed. It keeps the fleet's contract — ``(slots, scores, step)``
:class:`~mercury_tpu_torch.sampling.scorer_fleet.ScoreChunk`\\ s over
bounded queues, ``snapshot``/``drain``/``score_once``/``note_applied``/
``reset``/``close`` — and scores a window with the fleet's own
:class:`~mercury_tpu_torch.sampling.scorer_fleet.ChunkScorer`, so the
Trainer's apply is the same and a chunk is the fleet's bits. On top:

- **Placement.** ``"device"`` scores on the card
  ``parallel.distributed.reserve_scorer_device`` gives: a card no rank of
  this host trains on, else the rank's own, where each worker scores on a
  CUDA stream of its own beside the step. ``"host"`` scores on the
  training device, as the fleet.
- **Pacing.** The device backend is paced by snapshots: each snapshot
  opens an epoch of at most a queue's worth of chunks a tenant
  (``max(2·workers, 2)``), so ``snapshot_every`` bounds its duty cycle
  and ``scorer_throttle_s`` must be 0. The host backend scores on as the
  fleet does, throttled by ``scorer_throttle_s``.
- **Tenants.** ``scorer_tenants`` consumers, each with a bounded queue, a
  cursor, a stream of chunk seeds (tenant ``i``'s chunk ``seq`` draws
  from ``chunk_seed(seed, i·0x100000 + seq)``, so tenant 0's are the
  fleet's) and the snapshot. Chunks go to tenants by smooth weighted
  round-robin over ``scorer_tenant_weights``, skipping a tenant whose
  queue is full. Tenant 0 feeds the Trainer's table; the others are
  drained and discarded after accounting.
- **SLOs.** :meth:`ScorerService.slo_status` reports a tenant's staleness
  above ``slo_score_staleness_max`` and a queue at or above
  ``scorer_queue_highwater``, each breach counted on its rising edge.

At ``world_size > 1`` (one process a rank) only the device backend runs,
with one tenant and one worker a rank, in lockstep: chunk ``q`` is scored
from snapshot ``q`` and delivered when snapshot ``q+1`` is installed, on
every rank, so each rank applies the same chunk at the same age in every
run. Each rank scores its own row of JAX's ``[W, R]`` chunk. At a
snapshot the trainer thread waits for its own scorer only (at most
``LOCKSTEP_BARRIER_S``), never for another rank.

Idle workers park on an event that a snapshot sets (and, for the host
backend, a drain that freed a queue slot); none polls. :meth:`reset` (a
restore) drops every queue, a chunk begun before it and a lockstep chunk
in flight, and rewinds the windows and seeds, so a restored run goes on
as a fresh one restored from the same checkpoint. The ``scorer_*``
faults (``faults``, a :class:`~mercury_tpu_torch.faults.FaultPlane`) hook
in where the JAX service's do: ``scorer_die`` and ``scorer_nan`` in
:meth:`_score_chunk`, ``scorer_wedge`` (a tenant no longer scheduled) in a
worker's loop. :meth:`ScorerService.restart_workers` replaces the workers
(the supervisor's restart); a dead worker the supervisor does not restart
raises at the next drain. With ``journal`` (an
:class:`~mercury_tpu_torch.obs.events.EventJournal`) the service journals
each tenant's admission, each snapshot, a tenant's starvation (the rising
edge of its SLO breach) and a wedge. ``tracer`` (``obs/trace.py``) records
a ``fleet/chunk`` span a chunk a worker scores, on its ``scorer-svc<i>``
track.

A descent of the supervisor's ladder out of level 0 calls
:meth:`ScorerService.release_lockstep`: the trainer no longer drains the
lockstep's chunks, so the service stops arming rounds and no snapshot
waits at the delivery barrier; the workers' restart for the climb back
(:meth:`ScorerService.restart_workers`) arms it again. The ladder's level
is agreed across the ranks (``runtime/supervisor.py``), so every rank
releases at the same step.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

import torch

from mercury_tpu_torch.config import (  # noqa: F401 (the JAX module's names)
    MAX_TENANTS,
    TrainConfig,
    parse_tenant_weights,
    validate_scorer_composition,
)
from mercury_tpu_torch.data.pipeline import ShardedDataset
from mercury_tpu_torch.obs.trace import NULL_TRACER
from mercury_tpu_torch.parallel.distributed import cards_in_use, reserve_scorer_device
from mercury_tpu_torch.sampling.scorer_fleet import (
    ChunkScorer,
    ScoreChunk,
    Snapshot,
    chunk_seed,
    with_index,
)
from mercury_tpu_torch.utils.logging import get_logger

_log = get_logger(__name__)

# Tenant i's chunk seq draws from chunk id i·_TENANT_KEY_STRIDE + seq: the
# tenants' streams never meet, and tenant 0's is the fleet's.
_TENANT_KEY_STRIDE = 0x100000

# How long a snapshot waits for the lockstep chunk before skipping it.
LOCKSTEP_BARRIER_S = 60.0


class _Tenant:
    """One consumer: its bounded queue, cursor, seed counter, snapshot,
    scheduler credit and SLO accounting. The owning service's lock guards
    every field but the queue (its own lock) and ``snap`` (replaced
    whole)."""

    def __init__(self, idx: int, weight: float, queue_max: int) -> None:
        self.idx = idx
        self.name = f"t{idx}"
        self.weight = float(weight)
        self.ready: "queue.Queue[ScoreChunk]" = queue.Queue(maxsize=queue_max)
        self.snap: Optional[Snapshot] = None
        self.cursor = 0            # the next window's start
        self.seq = 0               # the next chunk's seed counter
        self.credit = 0.0          # smooth weighted round-robin credit
        self.inflight = 0          # queue slots reserved by scoring workers
        self.scored_in_epoch = 0   # device pacing: chunks this snapshot epoch
        self.chunks_scored = 0
        self.rows_scored = 0
        self.tick_rows = 0         # stats()'s marker
        self.delivered = 0         # chunks drained
        self.discarded = 0         # tenants 1 and up: drained and dropped
        self.last_delivered_step: Optional[int] = None
        self.staleness = 0         # steps since the last delivered chunk's snapshot
        self.slo_latched = False   # rising-edge latch of a breach
        self.slo_breaches = 0
        self.wedged = False        # the scorer_wedge fault's latch


class ScorerService:
    """The multi-tenant scorer (module docstring): ``config.scorer_workers``
    daemon threads ``mercury-scorer-svc-<i>`` over ``config.scorer_tenants``
    queues. ``device`` is the training device; the device backend on the
    card scores on the card ``reserve_scorer_device`` gives (from the
    cards ``in_use``, which the Trainer gathers on every rank; by default
    ``cards_in_use``, a collective of every rank), anything else on
    ``device``. ``faults`` arms the ``scorer_*`` hooks; ``journal``
    records the service's decisions."""

    def __init__(self, dataset: ShardedDataset, model: torch.nn.Module,
                 config: TrainConfig, device, faults=None, journal=None,
                 tracer=None, in_use: Optional[List[int]] = None) -> None:
        device = with_index(torch.device(device))
        self._backend = config.scorer_backend
        scorer_device = device
        if self._backend == "device" and device.type == "cuda":
            scorer_device = reserve_scorer_device(
                device, cards_in_use(device) if in_use is None else in_use)
        self._scorer = ChunkScorer(dataset, model, config, device, self._backend,
                                   scorer_device)
        self._L, self._R = self._scorer.L, self._scorer.R
        self._seed = int(config.seed)
        self._rank = int(dataset.rank)
        self._workers = int(config.scorer_workers)
        self._throttle = float(config.scorer_throttle_s)
        self._config = config
        self._faults = faults
        self._journal = journal
        self._tracer = tracer if tracer is not None else NULL_TRACER
        # Kernel launches of the service's scoring, apart from the step's.
        self.launch_counts: Dict[str, int] = self._scorer.launch_counts

        queue_max = max(2 * self._workers, 2)
        # Device pacing: a queue's worth of chunks a tenant an epoch.
        self._epoch_cap = queue_max
        weights = parse_tenant_weights(config)
        self._tenants = [_Tenant(i, weights[i], queue_max)
                         for i in range(int(config.scorer_tenants))]
        for t in self._tenants:
            self._emit("scorer/tenant_admitted", -1,
                       {"tenant": t.name, "weight": t.weight, "queue_max": queue_max,
                        "backend": self._backend})

        # Lockstep at W>1 (one tenant, one worker: the config's checks).
        self._lockstep = self._backend == "device" and config.world_size > 1
        self._ls_req = threading.Event()    # trainer → worker: score one
        self._ls_done = threading.Event()   # worker → trainer: chunk ready
        self._ls_chunk: Optional[Tuple[int, Optional[ScoreChunk]]] = None
        self._ls_ticket = 0                 # bumped at every arm and reset
        self._ls_armed: Optional[int] = None
        # Set by release_lockstep (a ladder descent), cleared by a restart:
        # no round is armed or delivered while set.
        self._ls_released = False
        # The trainer's wait at each lockstep snapshot, in ms.
        self.barrier_waits_ms: List[float] = []

        self._lock = threading.Lock()
        # Set, under the lock, when scoring may have become possible: a
        # snapshot, a host-backend drain that freed a slot, close. A worker
        # finds nothing eligible and clears it under the same lock, so no
        # wake-up is lost.
        self._work = threading.Event()
        self._chunks_scored = 0
        self._rows_scored = 0
        self._applied_chunks = 0
        self._snapshots = 0
        self._last_step = 0
        self._ages: List[float] = []
        self._tick_rows = 0
        self._tick_t = time.perf_counter()
        # Bumped by reset() and restart_workers(): a chunk begun before is
        # dropped.
        self._generation = 0
        self._restarts = 0
        self._exc: Optional[BaseException] = None
        self._closed = False
        self._spawn_workers()

    def _spawn_workers(self) -> None:
        """Start a set of workers with a stop event of their own, named
        ``mercury-scorer-svc-<i>``, or ``…-r<N>`` after the N-th restart."""
        suffix = f"-r{self._restarts}" if self._restarts else ""
        self._stop = stop = threading.Event()
        self._threads = [threading.Thread(target=self._run, args=(i, stop), daemon=True,
                                          name=f"mercury-scorer-svc-{i}{suffix}")
                         for i in range(self._workers)]
        for t in self._threads:
            t.start()

    def _emit(self, kind: str, step: int, detail: Dict[str, Any]) -> None:
        if self._journal is not None:
            self._journal.emit(kind, step, detail=detail)

    # ---------------------------------------------------------- scheduling
    def _eligible_locked(self, t: _Tenant) -> bool:
        if t.wedged or t.snap is None:
            return False
        if t.ready.qsize() + t.inflight >= t.ready.maxsize:
            return False  # backpressure: the consumer's queue is full
        if self._backend == "device" and t.scored_in_epoch >= self._epoch_cap:
            return False  # snapshot pacing: the epoch's budget is spent
        return True

    def _next_tenant(self) -> Optional[_Tenant]:
        """Smooth weighted round-robin over the eligible tenants, with a
        queue slot reserved for the pick, so the put after scoring never
        blocks. None clears the work event (under the lock)."""
        with self._lock:
            eligible = [t for t in self._tenants if self._eligible_locked(t)]
            if not eligible:
                self._work.clear()
                return None
            for t in eligible:
                t.credit += t.weight
            pick = max(eligible, key=lambda t: t.credit)
            pick.credit -= sum(t.weight for t in eligible)
            pick.inflight += 1
            if self._backend == "device":
                pick.scored_in_epoch += 1
            return pick

    # ------------------------------------------------------------- scoring
    def _score_chunk(self, t: _Tenant) -> Tuple[int, Optional[ScoreChunk]]:
        """Tenant ``t``'s next window scored on the calling thread, and the
        generation it was begun in; no chunk without a snapshot."""
        with self._lock:
            snap, generation = t.snap, self._generation
        if snap is None:
            return generation, None
        faults = self._faults
        if faults is not None and faults.fire("scorer_die") is not None:
            raise faults.injected("scorer_die: injected scorer death")
        with self._lock:
            start = t.cursor
            t.cursor = (start + self._R) % self._L
            seq = t.seq
            t.seq += 1
        chunk = self._scorer.score(
            snap, start, chunk_seed(self._seed, t.idx * _TENANT_KEY_STRIDE + seq, self._rank))
        if faults is not None and faults.fire("scorer_nan") is not None:
            chunk.scores.fill_(float("nan"))
        with self._lock:
            t.chunks_scored += 1
            t.rows_scored += self._R
            self._chunks_scored += 1
            self._rows_scored += self._R
        return generation, chunk

    def score_once(self, tenant: int = 0) -> ScoreChunk:
        """Score tenant ``tenant``'s next window on the calling thread (no
        queue): the deterministic path for tests."""
        chunk = self._score_chunk(self._tenants[tenant])[1]
        if chunk is None:
            raise RuntimeError("scorer service has no snapshot yet: call snapshot() "
                               "before score_once()")
        return chunk

    def _run(self, idx: int, stop: threading.Event) -> None:
        self._tracer.register_thread(f"scorer-svc{idx}")
        try:
            while not (self._closed or stop.is_set()):
                if self._lockstep:
                    self._lockstep_round(stop)
                    continue
                faults = self._faults
                if faults is not None:
                    args = faults.fire("scorer_wedge")
                    if args is not None:
                        wedge_idx = int(args.get("tenant", 0))
                        with self._lock:
                            self._tenants[wedge_idx].wedged = True
                            last_step = self._last_step
                        _log.warning("scorer_wedge injected: tenant t%d frozen", wedge_idx)
                        self._emit("scorer/wedged", last_step, {"tenant": f"t{wedge_idx}"})
                t = self._next_tenant()
                if t is None:
                    self._work.wait()
                    continue
                try:
                    with self._tracer.span("fleet/chunk", cat="scorer", tenant=t.idx):
                        generation, chunk = self._score_chunk(t)
                finally:
                    with self._lock:
                        t.inflight -= 1
                with self._lock:
                    # The reserved slot makes the put safe: only the
                    # consumer takes from the queue.
                    if chunk is not None and generation == self._generation:
                        t.ready.put_nowait(chunk)
                        t.last_delivered_step = chunk.step
                if self._throttle > 0:
                    stop.wait(self._throttle)
        except BaseException as exc:  # raised again at the next drain
            if stop.is_set():
                return  # a worker of a retired generation dies without a word
            self._exc = exc
            self._ls_done.set()   # a lockstep snapshot need not wait it out
            _log.warning("scorer service worker %d died: %s: %s", idx,
                         type(exc).__name__, exc)

    def _lockstep_round(self, stop: threading.Event) -> None:
        """Wait for the request a snapshot arms, score chunk ``q`` from
        snapshot ``q`` and hand it over for delivery at snapshot ``q+1``."""
        self._ls_req.wait()
        if self._closed or stop.is_set():
            return
        with self._lock:
            self._ls_req.clear()
            ticket = self._ls_ticket
        with self._tracer.span("fleet/chunk", cat="scorer", tenant=0):
            generation, chunk = self._score_chunk(self._tenants[0])
        with self._lock:
            if generation != self._generation:
                chunk = None
        self._ls_chunk = (ticket, chunk)
        self._ls_done.set()

    # ----------------------------------------------------------- lifecycle
    def snapshot(self, model, step: int) -> None:
        """Install a copy of the parameters (``model``: a module, or its
        tensors by name) for every tenant and open a
        pacing epoch; the caller does not wait for the copy. In lockstep
        this is also the delivery barrier: the previous epoch's chunk is
        collected (waiting for this rank's scorer) and queued before the
        new snapshot arms the next request."""
        snap = self._scorer.snapshot(model, step)
        if self._lockstep and not self._ls_released:
            self._lockstep_deliver()
        with self._lock:
            for t in self._tenants:
                t.snap = snap
                t.scored_in_epoch = 0
            self._snapshots += 1
            snapshots = self._snapshots
            self._last_step = int(step)
            self._work.set()
            if (self._lockstep and self._exc is None and not self._closed
                    and not self._ls_released):
                self._ls_ticket += 1
                self._ls_armed = self._ls_ticket
                self._ls_done.clear()
                self._ls_req.set()
        self._emit("scorer/snapshot", int(step),
                   {"epoch": snapshots, "tenants": len(self._tenants)})

    def _lockstep_deliver(self) -> None:
        armed, self._ls_armed = self._ls_armed, None
        if armed is None:
            return
        t0 = time.perf_counter()
        ok = self._ls_done.wait(timeout=LOCKSTEP_BARRIER_S)
        self.barrier_waits_ms.append((time.perf_counter() - t0) * 1e3)
        if not ok:
            if self._exc is None:
                _log.warning("lockstep scorer missed the snapshot barrier (%.0f s): "
                             "chunk skipped; drain() raises if the worker died",
                             LOCKSTEP_BARRIER_S)
            return
        self._ls_done.clear()
        # The event orders it: the worker wrote the slot before setting it.
        got, self._ls_chunk = self._ls_chunk, None
        with self._lock:
            ticket = self._ls_ticket
        # The round is over either way, so the drop is the same on every
        # rank: a reset since the request (the ticket moved on) drops the
        # old trajectory's chunk, however early it was ready.
        if got is None or got[1] is None or not got[0] == armed == ticket:
            return   # a dead worker, no snapshot, or a reset since the request
        chunk = got[1]
        t0 = self._tenants[0]
        try:
            t0.ready.put_nowait(chunk)
        except queue.Full:
            # The consumer stopped draining: dropped, the same on every rank.
            return
        with self._lock:
            t0.last_delivered_step = chunk.step

    def release_lockstep(self) -> None:
        """Leave the lockstep (a ladder descent): disarm the round in flight,
        drop its chunk (the ticket moves on) and arm no more until
        :meth:`restart_workers`, so no snapshot waits at the delivery
        barrier. Nothing without lockstep."""
        if not self._lockstep:
            return
        with self._lock:
            self._ls_released = True
            self._ls_armed = None
            self._ls_ticket += 1
            self._ls_req.clear()

    def drain_for_step(self, step: int) -> List[ScoreChunk]:
        """Tenant 0's ready chunks (the Trainer applies them); the other
        tenants' queues are emptied into their accounting. Advances every
        tenant's staleness against ``step``. Raises if a worker died."""
        if self._exc is not None:
            raise RuntimeError("scorer service worker died") from self._exc
        out: List[ScoreChunk] = []
        freed = False
        with self._lock:
            self._last_step = int(step)
        for t in self._tenants:
            while True:
                try:
                    chunk = t.ready.get_nowait()
                except queue.Empty:
                    break
                freed = True
                with self._lock:
                    t.delivered += 1
                    if t.idx != 0:
                        t.discarded += 1
                if t.idx == 0:
                    out.append(chunk)
            with self._lock:
                if t.last_delivered_step is not None:
                    t.staleness = max(int(step) - t.last_delivered_step, 0)
        # Freed slots wake the host backend's workers; the device backend
        # keeps its scoring next to the snapshot.
        if freed and self._backend == "host":
            with self._lock:
                self._work.set()
        return out

    def drain(self) -> List[ScoreChunk]:
        """The fleet's drain, at the last step seen."""
        with self._lock:
            step = self._last_step
        return self.drain_for_step(step)

    def slo_status(self, step: int) -> Optional[str]:
        """The SLO breaches now, or None: a tenant's staleness above
        ``slo_score_staleness_max``, or its queue depth at or above
        ``scorer_queue_highwater``. Each tenant's breach count rises on the
        rising edge only (``scorer/slo_breaches/t{i}``)."""
        stale_max = int(self._config.slo_score_staleness_max)
        highwater = int(self._config.scorer_queue_highwater)
        breaches: List[str] = []
        starved: List[Dict[str, Any]] = []
        with self._lock:
            for t in self._tenants:
                reasons = []
                if stale_max > 0 and t.last_delivered_step is not None:
                    staleness = max(int(step) - t.last_delivered_step, 0)
                    t.staleness = staleness
                    if staleness > stale_max:
                        reasons.append(f"staleness {staleness} > {stale_max}")
                if highwater > 0 and t.ready.qsize() >= highwater:
                    reasons.append(f"queue depth {t.ready.qsize()} >= {highwater}")
                if reasons:
                    if not t.slo_latched:
                        t.slo_latched = True
                        t.slo_breaches += 1
                        # The starvation decision: the rising edge only.
                        starved.append({"tenant": t.name, "reasons": list(reasons),
                                        "wedged": t.wedged})
                    breaches.append(f"{t.name}: " + ", ".join(reasons))
                else:
                    t.slo_latched = False
        for detail in starved:
            self._emit("scorer/starved", int(step), detail)
        return "; ".join(breaches) if breaches else None

    def note_applied(self, age: int) -> None:
        """Record an applied chunk's age, in steps, for :meth:`stats`."""
        with self._lock:
            self._applied_chunks += 1
            self._ages.append(float(max(age, 0)))

    def reset(self) -> None:
        """Drop every tenant's queue and snapshot (after a restore they
        belong to another trajectory), a chunk being scored now and a
        lockstep chunk in flight, and rewind every tenant's window cursor
        and chunk seeds to 0. The caller snapshots again: the chunks that
        follow depend on the restored state alone, as those of a fresh
        service restored from the same checkpoint (the JAX service keeps
        its cursor running across a restore)."""
        with self._lock:
            self._generation += 1
            self._ls_ticket += 1
            self._ages = []
            for t in self._tenants:
                t.snap = None
                t.cursor = t.seq = 0
                while True:
                    try:
                        t.ready.get_nowait()
                    except queue.Empty:
                        break

    def alive(self) -> bool:
        """False once a worker of the live set died or exited, or the
        service is closed."""
        if self._closed or self._exc is not None:
            return False
        return all(t.is_alive() for t in self._threads)

    def death_event(self) -> Optional[str]:
        """The journal id of the injected fault that killed a worker, if
        one did (the supervisor's cause of the death)."""
        return getattr(self._exc, "event_id", None)

    def restart_workers(self, timeout: float = 5.0) -> int:
        """Retire the workers (their stop event ends the live ones, parked
        ones are woken; the dead ones just join), clear the death, the
        queue-slot reservations and a lockstep round in flight, drop a
        chunk a retired worker began (the generation moves on) and start a
        full set named ``-r<N>``; return N, the restart's number. The
        queued chunks stay. A worker still running after ``timeout``
        seconds is left to end on its stop event."""
        if self._closed:
            raise RuntimeError("restart_workers() on a closed ScorerService")
        self._stop.set()
        self._ls_req.set()
        with self._lock:
            self._work.set()
        deadline = time.perf_counter() + timeout
        for t in self._threads:
            t.join(timeout=max(0.0, deadline - time.perf_counter()))
        wedged = [t.name for t in self._threads if t.is_alive()]
        if wedged:
            _log.warning("scorer service restart: threads of the retired workers still "
                         "alive %.0f s after stop, left to end (daemons): %s",
                         timeout, ", ".join(wedged))
        with self._lock:
            self._exc = None
            self._ls_req.clear()
            self._ls_done.clear()
            self._ls_chunk = None
            self._ls_armed = None
            self._ls_released = False
            self._ls_ticket += 1
            self._generation += 1
            self._restarts += 1
            for t in self._tenants:
                t.inflight = 0  # the reservations died with their workers
        self._spawn_workers()
        _log.warning("scorer service restarted (restart %d, %d workers)",
                     self._restarts, self._workers)
        return self._restarts

    def close(self, timeout: float = 30.0) -> None:
        """Stop the workers and join them, at most ``timeout`` seconds in
        all (a worker still running is left, a daemon, and logged); a
        second call does nothing."""
        if self._closed:
            return
        self._closed = True
        self._stop.set()
        self._ls_req.set()
        with self._lock:
            self._work.set()
        deadline = time.perf_counter() + timeout
        for t in self._threads:
            t.join(timeout=max(0.0, deadline - time.perf_counter()))
        wedged = [t.name for t in self._threads if t.is_alive()]
        if wedged:
            _log.warning("scorer service threads still alive %.0f s after close(): %s",
                         timeout, ", ".join(wedged))

    # ----------------------------------------------------------- telemetry
    def stats(self) -> Dict[str, float]:
        """Since the previous call: the fleet's keys (rows scored a second,
        the applied chunks' staleness, the queue's depth), the service's
        totals and each tenant's. Host numbers only."""
        now = time.perf_counter()
        out: Dict[str, float] = {}
        with self._lock:
            rows = self._rows_scored - self._tick_rows
            self._tick_rows = self._rows_scored
            dt = max(now - self._tick_t, 1e-9)
            self._tick_t = now
            ages, self._ages = self._ages, []
            depth_total = 0
            for t in self._tenants:
                t_rows = t.rows_scored - t.tick_rows
                t.tick_rows = t.rows_scored
                depth = t.ready.qsize()
                depth_total += depth
                out[f"scorer/throughput/{t.name}"] = t_rows / dt
                out[f"scorer/queue_depth/{t.name}"] = float(depth)
                out[f"scorer/staleness/{t.name}"] = float(t.staleness)
                out[f"scorer/slo_breaches/{t.name}"] = float(t.slo_breaches)
            staleness_max = max(t.staleness for t in self._tenants)
            breaches = sum(t.slo_breaches for t in self._tenants)
            t0_depth = self._tenants[0].ready.qsize()
        out["scorer/throughput"] = rows / dt
        out["scorer/queue_depth"] = float(depth_total)
        out["scorer/staleness"] = float(staleness_max)
        out["scorer/slo_breaches"] = float(breaches)
        out["sampler/refresh_lag_chunks"] = float(t0_depth)
        out["threads/queue_depth/scorer"] = float(depth_total)
        out["sampler/score_staleness_mean"] = sum(ages) / len(ages) if ages else 0.0
        out["sampler/score_staleness_max"] = max(ages) if ages else 0.0
        return out

    def summary(self) -> Dict[str, Any]:
        """The running totals, the fleet's and each tenant's (reading them
        moves nothing). ``chunk_shape`` is this rank's row of JAX's
        ``[W, R]``; ``generation`` counts resets and restarts."""
        alive = sum(1 for t in self._threads if t.is_alive())
        with self._lock:
            tenants = [{"name": t.name, "weight": t.weight,
                        "chunks_scored": t.chunks_scored, "delivered": t.delivered,
                        "discarded": t.discarded, "queue_depth": t.ready.qsize(),
                        "staleness": t.staleness, "slo_breaches": t.slo_breaches,
                        "wedged": t.wedged}
                       for t in self._tenants]
            snap0 = self._tenants[0].snap
            return {
                "workers": self._workers,
                "workers_alive": alive,
                "generation": self._generation,
                "restarts": self._restarts,
                "chunk_shape": [1, self._R],
                "chunks_scored": self._chunks_scored,
                "rows_scored": self._rows_scored,
                "chunks_applied": self._applied_chunks,
                "snapshots": self._snapshots,
                "snapshot_step": None if snap0 is None else snap0.step,
                "queue_depth": sum(t["queue_depth"] for t in tenants),
                "closed": self._closed,
                "lockstep": self._lockstep,
                "program": self._scorer.program.describe(),
                "tenants": tenants,
            }
