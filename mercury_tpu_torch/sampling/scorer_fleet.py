"""Background scorer fleet for ``refresh_mode="async"``: the scoretable's
refresh forward off the training step — the PyTorch counterpart of
``mercury_tpu/sampling/scorer_fleet.py`` (its host backend).

``scorer_workers`` daemon threads each take the next round-robin window of
``refresh_size`` shard slots, ``(cursor + arange(R)) % L``, score it against
the latest parameter snapshot and hand the ``(slots, scores, step)`` chunk
on through a bounded queue. The Trainer drains the queue after every step
and scatters each chunk into the table with its age's weight
(:func:`~mercury_tpu_torch.sampling.scoretable.apply_async_chunk`): a chunk
scored ``a`` steps ago enters as ``μ + γ^a·(score − μ)``, the value it
would have now had it been applied then and decayed since.

On the card each worker runs its chunk on a CUDA stream of its own: the
gather of the window's rows (on the device where the pixels are there,
from a pinned host buffer where they stay on the host), the unfused ingest,
the train-mode scoring forward and the per-sample score, whose kernel
(``nll_fwd``) launches on that stream. The copy of the scores to pinned
host memory synchronizes that stream only; the training step never waits
for the fleet. A snapshot is a copy of the parameters made on the trainer's
stream, with an event the workers' streams wait on before they read it; it
is replaced whole, never written in place, and a worker drops its
reference only after that synchronizing copy, so the caching allocator
cannot hand its blocks to the trainer's stream while a worker still reads
them. The fleet's kernel launches count into its own ``launch_counts``,
apart from the step's.

Random numbers are inputs, as in the step: chunk ``k``'s crop offsets and
flips come from a generator of its own, seeded from ``(seed, 0x5C0, k)``,
never from the rank's generator, so the step's draws do not depend on the
fleet.

The window's rows, the thread's stream, the snapshot and the scoring of a
window are :class:`ChunkScorer`'s, which the scorer service
(``sampling/scorer_service.py``: the device backend, tenants, the SLOs
and the lockstep at W>1) shares, so a chunk of either is the same bits.

The fleet is one process's (the host backend at ``world_size=1``): its
chunk stream has no protocol across processes. Under a second mesh axis
one fleet serves a model group, on its first rank, scoring an unsharded
copy of the model against the whole parameters the group gathers at each
snapshot; the Trainer broadcasts the chunks it applies to the group. A worker that raises is
reported at the next :meth:`ScorerFleet.drain`, unless the supervisor
(``runtime/supervisor.py``) finds it dead first and calls
:meth:`ScorerFleet.restart_workers`.
"""

from __future__ import annotations

import contextlib
import copy
import queue
import threading
import time
from typing import Any, Dict, List, Mapping, NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch.func import functional_call

from mercury_tpu_torch.config import TrainConfig
from mercury_tpu_torch.data.pipeline import ShardedDataset, normalize_images
from mercury_tpu_torch.models.resnet import set_sync_batch_norm
from mercury_tpu_torch.obs.trace import NULL_TRACER
from mercury_tpu_torch.ops import mercury_kernels as mk
from mercury_tpu_torch.ops import reference
from mercury_tpu_torch.sampling.importance import per_sample_grad_norm_bound, per_sample_loss
from mercury_tpu_torch.train.state import Augment
from mercury_tpu_torch.train.step import augment_images, draw_augment, scoring_forward
from mercury_tpu_torch.utils.logging import get_logger

_log = get_logger(__name__)

FLEET_STREAM = 0x5C0  # the fleet's augmentation stream, apart from the step's


def chunk_seed(seed: int, chunk_id: int, rank: int = 0) -> int:
    """The seed of chunk ``chunk_id``'s generator: ``(seed, 0x5C0,
    chunk_id)`` mixed by numpy's ``SeedSequence``; a rank ``r > 0`` (the
    lockstep service at W>1) mixes ``r`` in too, so each rank draws its
    own crops and flips and rank 0 draws those of W=1."""
    entropy = [seed, FLEET_STREAM, chunk_id] + ([rank] if rank else [])
    words = np.random.SeedSequence(entropy).generate_state(2)
    return int(words[0]) << 32 | int(words[1])


class Snapshot(NamedTuple):
    """A copy of the model's parameters and buffers, by name, views of one
    flat tensor on the scorer's device; ``ready`` the event after the copy
    (None on the CPU)."""

    tensors: Dict[str, torch.Tensor]
    ready: Optional[Any]
    step: int


class ScoreChunk(NamedTuple):
    """One scored window of this rank's shard (the JAX chunk's one row):
    host tensors, pinned on the card."""

    slots: torch.Tensor   # [R] int64 shard slots
    scores: torch.Tensor  # [R] float32 fresh scores (unweighted)
    step: int             # the step of the snapshot that scored them


class ScoringProgram:
    """The fleet's scoring computation on rows it was given: the unfused
    ingest (normalize, then the augmentation from ``aug``, whatever
    ``fused_input`` says, as the JAX fleet), the train-mode scoring forward
    with the running statistics left alone, through
    ``torch.func.functional_call`` on a local-BN copy of the model with the
    snapshot's tensors, and the step's per-sample score: ``per_sample_nll``
    (the ``nll_fwd`` kernel on the card; the plain version on the CPU or
    under ``use_pallas=False``; the smoothed loss under
    ``label_smoothing``), or under ``importance_score="grad_norm"`` the
    gradient-norm bound. Each thread scores with its own copy of the model
    (``functional_call`` swaps a module's tensors while it runs).

    ``backend`` and ``device`` say where it scores: ``"host"`` on the
    training device, ``"device"`` on the card
    ``parallel.distributed.reserve_scorer_device`` gave, ``dedicated``
    when no rank of this host trains on it (:meth:`describe`). The math is
    the same on both."""

    def __init__(self, model: torch.nn.Module, mean, std, config: TrainConfig,
                 backend: str = "host", device=None, dedicated: bool = False) -> None:
        self._template = set_sync_batch_norm(copy.deepcopy(model), False)
        if device is not None:
            self._template.to(device)
        self._mean, self._std = mean, std
        self._config = config
        self._local = threading.local()
        self.backend, self.device, self.dedicated = backend, device, dedicated

    def _module(self) -> torch.nn.Module:
        module = getattr(self._local, "module", None)
        if module is None:
            module = self._local.module = copy.deepcopy(self._template)
        return module

    @torch.no_grad()
    def __call__(self, snapshot: Dict[str, torch.Tensor], rows: torch.Tensor,
                 labels: torch.Tensor, aug: Augment) -> torch.Tensor:
        """``[R]`` float32 scores of ``[R, H, W, C]`` uint8 rows."""
        config = self._config
        images = augment_images(normalize_images(rows, self._mean, self._std), aug, config)
        module = self._module()

        def model(x, **kw):
            return functional_call(module, snapshot, (x,), kw)

        logits = scoring_forward(model, images, config).float()
        if config.importance_score == "grad_norm":
            return per_sample_grad_norm_bound(logits, labels, config.label_smoothing)
        if config.label_smoothing != 0.0:
            return per_sample_loss(logits, labels, config.label_smoothing)
        if config.use_pallas is False:
            return reference.nll_forward(logits, labels)
        return mk.per_sample_nll(logits, labels)

    def describe(self) -> Dict[str, Any]:
        return {"backend": self.backend, "device": str(self.device),
                "dedicated_slice": self.dedicated}


class ChunkScorer:
    """What the fleet and the scorer service share: the window's rows, a
    CUDA stream for each scoring thread, the snapshot, and the scoring of
    one window into a :class:`ScoreChunk`. So a chunk of either, from the
    same snapshot, window and seed, is the same bits.

    ``device`` is where the step trains and the rows lie; ``scorer_device``
    (default ``device``) where the chunk is scored. When they differ (a
    spare card), the snapshot and the window's rows are copied to it."""

    def __init__(self, dataset: ShardedDataset, model: torch.nn.Module,
                 config: TrainConfig, device, backend: str = "host",
                 scorer_device=None) -> None:
        self.device = with_index(torch.device(device))
        self.scorer_device = (self.device if scorer_device is None
                              else with_index(torch.device(scorer_device)))
        self.cuda = self.device.type == "cuda"
        rank = dataset.rank
        self._host_pixels = dataset.host_pixels
        if self._host_pixels:
            # host_stream (an np.memmap too): gathered on the host.
            self._x = dataset.x_train
            self._rows_np = dataset.shard_indices[rank].cpu().numpy()
            self._y, self._shard_row = dataset.y_train, dataset.shard_indices[rank]
        elif dataset.x_shard is not None:
            # Sharded placement: the rank's own rows, indexed by slot.
            self._x, self._y, self._shard_row = dataset.x_shard, dataset.y_shard, None
        else:
            self._x, self._y = dataset.x_train, dataset.y_train
            self._shard_row = dataset.shard_indices[rank]
        self.L = dataset.shard_len
        self.R = int(config.refresh_size)
        self._config = config
        self.program = ScoringProgram(model, dataset.mean, dataset.std, config, backend,
                                      self.scorer_device,
                                      dedicated=self.scorer_device != self.device)
        self._local = threading.local()   # .stream: the thread's CUDA stream
        # Kernel launches of this scorer's chunks (ops.mercury_kernels).
        self.launch_counts: Dict[str, int] = {k: 0 for k in mk.KERNELS}

    def stream(self):
        """The calling thread's CUDA stream on the scorer's device (None on
        the CPU)."""
        if not self.cuda:
            return None
        stream = getattr(self._local, "stream", None)
        if stream is None:
            stream = self._local.stream = torch.cuda.Stream(self.scorer_device)
        return stream

    def gather(self, start: int):
        """The window at ``start``: its uint8 rows and labels on the
        scorer's device."""
        slots = (start + torch.arange(self.R, device=self.device)) % self.L
        if not self._host_pixels:
            rows = slots if self._shard_row is None else self._shard_row[slots]
            return self._x[rows].to(self.scorer_device), self._y[rows].to(self.scorer_device)
        gidx = self._rows_np[(start + np.arange(self.R)) % self.L]
        host = torch.from_numpy(np.ascontiguousarray(self._x[gidx]))
        if self.cuda:
            # Pinned, so the copy is a DMA on this thread's stream; the
            # buffer lives until the scores' copy back has synchronized it.
            host = host.pin_memory()
        return (host.to(self.scorer_device, non_blocking=True),
                self._y[self._shard_row[slots]].to(self.scorer_device))

    def snapshot(self, model, step: int) -> Snapshot:
        """Copy the model's parameters and buffers (``model``: a module, or
        its tensors by name, as ``parallel/mesh.full_state_dict`` gathers
        a sharded one): one ``cat`` on the
        trainer's stream (the tensors are views of it), copied on to a
        spare scorer card, and an event after it; the caller does not
        wait. A copy between cards runs on the source's current stream and
        the destination's current stream waits for it (PyTorch's ordering),
        so the source ``cat`` is freed in stream order after the copy has
        read it, and the event on the destination covers the copy."""
        named = (list(model.items()) if isinstance(model, Mapping)
                 else [*model.named_parameters(), *model.named_buffers()])
        flat = torch.cat([t.detach().reshape(-1) for _, t in named])
        if self.scorer_device != self.device:
            flat = flat.to(self.scorer_device)
        tensors = {name: v.view(t.shape) for (name, t), v in
                   zip(named, flat.split([t.numel() for _, t in named]))}
        ready = None
        if self.cuda:
            ready = torch.cuda.Event()
            ready.record(torch.cuda.current_stream(self.scorer_device))
        return Snapshot(tensors, ready, int(step))

    def score(self, snap: Snapshot, start: int, seed: int) -> ScoreChunk:
        """The window at ``start`` scored on the calling thread's stream
        against ``snap``, its crops and flips drawn from a generator seeded
        ``seed``. Returns once the scores are in pinned host memory: the
        snapshot, rows and scores are then no longer read."""
        stream = self.stream()
        with contextlib.ExitStack() as ctx:
            if stream is not None:
                ctx.enter_context(torch.cuda.device(self.scorer_device))
                ctx.enter_context(torch.cuda.stream(stream))
                stream.wait_event(snap.ready)
            ctx.enter_context(mk.counting_into(self.launch_counts))
            rows, labels = self.gather(start)
            gen = torch.Generator(device=self.scorer_device).manual_seed(seed)
            scores = self.program(snap.tensors, rows, labels,
                                  draw_augment(gen, self.R, self._config))
            out = torch.empty(self.R, dtype=torch.float32, pin_memory=self.cuda)
            # Synchronizes this thread's stream.
            out.copy_(scores)
        slots_h = torch.empty(self.R, dtype=torch.int64, pin_memory=self.cuda)
        slots_h.copy_(torch.from_numpy((start + np.arange(self.R)) % self.L))
        return ScoreChunk(slots=slots_h, scores=out, step=snap.step)


def with_index(device: torch.device) -> torch.device:
    """A CUDA device with its index (the current card's when none)."""
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


class ScorerFleet:
    """``config.scorer_workers`` daemon threads scoring round-robin windows
    of this rank's shard against the latest snapshot (:meth:`snapshot`).

    :meth:`drain` takes every ready chunk without waiting and raises if a
    worker died; :meth:`note_applied` records an applied chunk's age for
    :meth:`stats`; :meth:`reset` drops the queued chunks (a restore);
    :meth:`close` stops the workers (a second call does nothing);
    :meth:`score_once` scores the next window on the calling thread;
    :meth:`restart_workers` replaces the workers (the supervisor). The
    ready queue holds ``max(2·workers, 2)`` chunks, and a worker waits on a
    full queue, so the fleet idles when the trainer is not draining. Unlike
    the JAX fleet's, :meth:`reset` also drops a chunk begun before it, so
    no chunk of the old trajectory reaches the queue after a restore.
    ``faults`` (a :class:`~mercury_tpu_torch.faults.FaultPlane`) arms the
    ``scorer_die`` and ``scorer_nan`` hooks of :meth:`_next_chunk`.
    ``tracer`` (``obs/trace.py``) records a ``fleet/chunk`` span a chunk a
    worker scores (the chunk's host time: its launches and the copy back of
    its scores), on the worker's ``scorer<i>`` track."""

    def __init__(self, dataset: ShardedDataset, model: torch.nn.Module,
                 config: TrainConfig, device, faults=None, tracer=None) -> None:
        self._scorer = ChunkScorer(dataset, model, config, device)
        self._L, self._R = self._scorer.L, self._scorer.R
        self._seed = int(config.seed)
        self._workers = int(config.scorer_workers)
        self._throttle = float(config.scorer_throttle_s)
        self._faults = faults
        self._tracer = tracer if tracer is not None else NULL_TRACER
        # Kernel launches of this fleet's scoring (ops.mercury_kernels).
        self.launch_counts: Dict[str, int] = self._scorer.launch_counts

        self._snap: Optional[Snapshot] = None  # replaced whole by snapshot()
        self._lock = threading.Lock()
        self._cursor = 0
        self._chunk_seq = 0
        self._chunks_scored = 0
        self._rows_scored = 0
        self._applied_chunks = 0
        self._snapshots = 0
        self._ages: List[float] = []
        self._tick_rows = 0
        self._tick_t = time.perf_counter()

        self._ready: "queue.Queue[ScoreChunk]" = queue.Queue(maxsize=max(2 * self._workers, 2))
        # Bumped by reset() and restart_workers(): a chunk begun before is
        # dropped.
        self._generation = 0
        self._restarts = 0
        self._exc: Optional[BaseException] = None
        self._closed = False
        self._spawn_workers()

    def _spawn_workers(self) -> None:
        """Start a set of workers with a stop event of their own, named
        ``mercury-scorer-<i>``, or ``…-r<N>`` after the N-th restart."""
        suffix = f"-r{self._restarts}" if self._restarts else ""
        self._stop = stop = threading.Event()
        self._threads = [threading.Thread(target=self._run, args=(i, stop), daemon=True,
                                          name=f"mercury-scorer-{i}{suffix}")
                         for i in range(self._workers)]
        for t in self._threads:
            t.start()

    # ------------------------------------------------------------- scoring
    def _next_chunk(self) -> Tuple[int, Optional[ScoreChunk]]:
        """The next window scored on the calling thread, and the generation
        it was begun in."""
        with self._lock:
            snap, generation = self._snap, self._generation
        if snap is None:
            return generation, None
        faults = self._faults
        if faults is not None and faults.fire("scorer_die") is not None:
            # Kills the thread that scores: a worker, or score_once's caller.
            raise faults.injected("scorer_die: injected scorer death")
        with self._lock:
            start = self._cursor
            self._cursor = (start + self._R) % self._L
            chunk_id = self._chunk_seq
            self._chunk_seq += 1
        chunk = self._scorer.score(snap, start, chunk_seed(self._seed, chunk_id))
        if faults is not None and faults.fire("scorer_nan") is not None:
            # The trainer's check must reject the chunk.
            chunk.scores.fill_(float("nan"))
        with self._lock:
            self._chunks_scored += 1
            self._rows_scored += self._R
        return generation, chunk

    def _offer(self, generation: int, chunk: ScoreChunk, stop: threading.Event) -> None:
        """Queue ``chunk`` unless a reset or restart came since it was
        begun; while the queue is full, wait (backpressure), with an escape
        on the worker's stop event."""
        while not (self._closed or stop.is_set()):
            with self._lock:
                if generation != self._generation:
                    return
                if not self._ready.full():
                    self._ready.put_nowait(chunk)
                    return
            time.sleep(0.002)

    def score_once(self) -> ScoreChunk:
        """Score the next window on the calling thread (no queue): the
        deterministic path for tests."""
        chunk = self._next_chunk()[1]
        if chunk is None:
            raise RuntimeError("scorer fleet has no snapshot yet: call snapshot() "
                               "before score_once()")
        return chunk

    def _run(self, idx: int, stop: threading.Event) -> None:
        self._tracer.register_thread(f"scorer{idx}")
        try:
            while not (self._closed or stop.is_set()):
                if self._snap is None:
                    stop.wait(0.005)
                    continue
                with self._tracer.span("fleet/chunk", cat="scorer"):
                    generation, chunk = self._next_chunk()
                if chunk is not None:
                    self._offer(generation, chunk, stop)
                if self._throttle > 0:
                    stop.wait(self._throttle)
        except BaseException as exc:  # raised again at the next drain()
            if not stop.is_set():
                # A worker of a retired generation dies without a word.
                self._exc = exc
            _log.warning("scorer worker %d died: %s: %s", idx, type(exc).__name__, exc)

    # ----------------------------------------------------------- lifecycle
    def snapshot(self, model, step: int) -> None:
        """Copy the model's parameters and buffers (a module, or its
        tensors by name) for the chunks scored from now on
        (:meth:`ChunkScorer.snapshot`); the caller does not wait."""
        snap = self._scorer.snapshot(model, step)
        with self._lock:
            self._snap = snap
            self._snapshots += 1

    def drain(self) -> List[ScoreChunk]:
        """Every chunk ready now, without waiting. Raises if a worker
        died."""
        if self._exc is not None:
            raise RuntimeError("scorer fleet worker died") from self._exc
        out: List[ScoreChunk] = []
        while True:
            try:
                out.append(self._ready.get_nowait())
            except queue.Empty:
                return out

    def note_applied(self, age: int) -> None:
        """Record an applied chunk's age, in steps, for :meth:`stats`."""
        with self._lock:
            self._applied_chunks += 1
            self._ages.append(float(max(age, 0)))

    def reset(self) -> None:
        """Drop the queued chunks and the snapshot (after a restore they
        belong to another trajectory); a chunk being scored now is dropped
        too. The caller snapshots again."""
        with self._lock:
            self._generation += 1
            self._snap = None
            self._ages = []
            while True:
                try:
                    self._ready.get_nowait()
                except queue.Empty:
                    break

    def alive(self) -> bool:
        """False once a worker of the live set died or exited, or the fleet
        is closed."""
        if self._closed or self._exc is not None:
            return False
        return all(t.is_alive() for t in self._threads)

    def death_event(self) -> Optional[str]:
        """The journal id of the injected fault that killed a worker, if
        one did (the supervisor's cause of the death)."""
        return getattr(self._exc, "event_id", None)

    def restart_workers(self, timeout: float = 5.0) -> int:
        """Retire the workers (their stop event ends the live ones; the
        dead ones just join), clear the death, drop a chunk a retired
        worker began (the generation moves on) and start a full set named
        ``-r<N>``; return N, the restart's number. The queued chunks stay:
        they were scored from a valid snapshot. A worker still running
        after ``timeout`` seconds is left to end on its stop event."""
        if self._closed:
            raise RuntimeError("restart_workers() on a closed ScorerFleet")
        self._stop.set()
        deadline = time.perf_counter() + timeout
        for t in self._threads:
            t.join(timeout=max(0.0, deadline - time.perf_counter()))
        wedged = [t.name for t in self._threads if t.is_alive()]
        if wedged:
            _log.warning("scorer restart: threads of the retired workers still alive "
                         "%.0f s after stop, left to end (daemons): %s",
                         timeout, ", ".join(wedged))
        with self._lock:
            self._exc = None
            self._generation += 1
            self._restarts += 1
        self._spawn_workers()
        _log.warning("scorer fleet restarted (restart %d, %d workers)",
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
        deadline = time.perf_counter() + timeout
        for t in self._threads:
            t.join(timeout=max(0.0, deadline - time.perf_counter()))
        wedged = [t.name for t in self._threads if t.is_alive()]
        if wedged:
            _log.warning("scorer threads still alive %.0f s after close(): %s",
                         timeout, ", ".join(wedged))

    # ----------------------------------------------------------- telemetry
    def stats(self) -> Dict[str, float]:
        """Since the previous call: rows scored a second, the ages of the
        chunks applied (mean and max, in steps); and the queue's depth
        now. Host numbers only."""
        now = time.perf_counter()
        with self._lock:
            rows = self._rows_scored - self._tick_rows
            self._tick_rows = self._rows_scored
            dt = max(now - self._tick_t, 1e-9)
            self._tick_t = now
            ages, self._ages = self._ages, []
        depth = float(self._ready.qsize())
        return {
            "scorer/throughput": rows / dt,
            "sampler/refresh_lag_chunks": depth,
            "threads/queue_depth/scorer": depth,
            "sampler/score_staleness_mean": sum(ages) / len(ages) if ages else 0.0,
            "sampler/score_staleness_max": max(ages) if ages else 0.0,
        }

    def summary(self) -> Dict[str, Any]:
        """The running totals (reading them moves nothing)."""
        snap = self._snap
        alive = sum(1 for t in self._threads if t.is_alive())
        with self._lock:
            return {
                "workers": self._workers,
                "workers_alive": alive,
                "generation": self._generation,
                "restarts": self._restarts,
                "chunk_rows": self._R,
                "chunks_scored": self._chunks_scored,
                "rows_scored": self._rows_scored,
                "chunks_applied": self._applied_chunks,
                "snapshots": self._snapshots,
                "snapshot_step": None if snap is None else snap.step,
                "queue_depth": self._ready.qsize(),
                "closed": self._closed,
            }
