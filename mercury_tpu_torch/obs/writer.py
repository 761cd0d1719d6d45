"""Non-blocking metric streaming: a bounded queue drained off the training
thread — the PyTorch counterpart of ``mercury_tpu/obs/writer.py``.

The trainer's log tick enqueues the step's metric tensors as they are, on
the device, and returns. :meth:`AsyncMetricWriter.write` records a
``torch.cuda.Event`` on the caller's stream when a value lies on the card;
the drain thread waits for that event (the step that produced the values
has finished), copies the values to the host on a stream of its own and
fans the host record out to the sinks. So a log tick costs the training
thread no ``.item()``, no synchronization and no filesystem write.

Backpressure is drop-oldest with a counted ``dropped`` stat: a slow sink
can never stall training, and the loss is visible in the stream itself
(``obs/dropped``).

Sinks implement ``write(record: dict) -> None`` and ``close() -> None``;
records are flat ``tag → float`` dicts carrying ``step`` and ``time``.
Provided: :class:`JsonlSink` (buffered), :class:`TensorBoardSink` (when
``torch.utils.tensorboard`` imports), :class:`HeartbeatShardSink` (a
rank's liveness shard) and :class:`HeartbeatSink` (a rate-limited stdout
line).
"""

from __future__ import annotations

import collections
import json
import os
import sys
import threading
import time
from typing import Dict, Iterable, Optional

import numpy as np
import torch

from mercury_tpu_torch.utils.logging import _try_tensorboard_writer, get_logger

# Drain-thread failures never raise into training: they are counted
# (``.errors``) and logged with lazy %-style arguments.
_log = get_logger("mercury_tpu_torch.obs.writer")


def shard_filename(process_index: int) -> str:
    """A rank's metric shard in ``log_dir``."""
    return f"metrics.h{int(process_index)}.jsonl"


def heartbeat_shard_filename(process_index: int) -> str:
    """A rank's heartbeat shard in ``log_dir``."""
    return f"heartbeat.h{int(process_index)}.jsonl"


def _host_arrays(scalars: Dict, copy_streams: Optional[Dict] = None) -> Dict:
    """Each value of ``scalars`` as a numpy array (or a Python number as
    is). The tensors on a card are read back with one ``cat`` and one copy
    a (card, dtype), on a stream of the card's in ``copy_streams`` (made
    on first use), not on the caller's."""
    host: Dict = {}
    groups: Dict = {}
    for k, v in scalars.items():
        if isinstance(v, torch.Tensor):
            v = v.detach()
            if v.dtype == torch.bfloat16:
                v = v.float()
            if v.is_cuda:
                groups.setdefault((v.device, v.dtype), []).append((k, v))
            else:
                host[k] = v.numpy()
        else:
            host[k] = v
    for (device, _), items in groups.items():
        with torch.cuda.device(device):
            if copy_streams is None:
                stream = torch.cuda.current_stream()
            else:
                stream = copy_streams.get(device)
                if stream is None:
                    stream = copy_streams[device] = torch.cuda.Stream(device)
            with torch.cuda.stream(stream):
                flat = torch.cat([v.reshape(-1) for _, v in items]).cpu().numpy()
        at = 0
        for k, v in items:
            n = v.numel()
            host[k] = flat[at:at + n].reshape(v.shape)
            at += n
    return host


def _to_host_record(step: int, t: float, scalars: Dict,
                    copy_streams: Optional[Dict] = None) -> Dict[str, float]:
    """The host record of one enqueued dict: each value becomes one float,
    a ``[K]`` series its mean (``np.mean`` in the value's dtype, as the JAX
    package reduces a scanned chunk's series)."""
    record: Dict[str, float] = {"step": int(step), "time": float(t)}
    for k, v in _host_arrays(scalars, copy_streams).items():
        record[k] = float(np.mean(np.asarray(v)))
    return record


class AsyncMetricWriter:
    """Bounded-queue, background-thread metric writer.

    ``write(step, scalars)`` enqueues the scalar dict (tensors on the card
    welcome) and returns; the drain thread converts it to a host record and
    fans it out to every sink, in enqueue order. When the queue is full the
    OLDEST pending record is dropped and counted (``.dropped``); the count
    is attached to later records as ``obs/dropped``.

    ``close()`` drains what is queued, closes the sinks and is idempotent;
    the writer is also a context manager. The drain thread
    (``mercury-metrics``, a daemon) starts on the first :meth:`write`;
    ``start=False`` never starts it, so records queue and only
    :meth:`flush`/:meth:`close` drain them, on the caller's thread.

    ``observers`` are callables given each HOST record on the drain thread
    before the sinks; one may change the record in place, and the sinks
    see the change. Their exceptions are counted, never raised.

    ``faults`` (a :class:`~mercury_tpu_torch.faults.FaultPlane`) arms the
    ``sink_wedge`` hook: the drain thread sleeps ``secs`` before a record.
    ``journal`` (an :class:`~mercury_tpu_torch.obs.events.EventJournal`) is
    written where the sinks are flushed: by the drain thread when it goes
    idle, and at :meth:`flush` and :meth:`close` (the Trainer closes it).
    """

    def __init__(self, sinks: Iterable, capacity: int = 256,
                 start: bool = True, observers: Iterable = (), faults=None,
                 journal=None) -> None:
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.sinks = [s for s in sinks if s is not None]
        # The latest fanned-out host record; written by the drain thread.
        self._latest: Optional[Dict[str, float]] = None
        # Copy-on-write: add_observer() swaps in a new list under _lock.
        self.observers = [o for o in observers if o is not None]
        self.capacity = capacity
        self.dropped = 0
        self.errors = 0
        self._q: collections.deque = collections.deque()
        self._lock = threading.Lock()
        self._have_work = threading.Condition(self._lock)
        self._stop = False
        self._closed = False
        self._busy = False
        self._autostart = start
        self._thread: Optional[threading.Thread] = None
        self._copy_streams: Dict = {}
        self._faults = faults
        self._journal = journal

    # -------------------------------------------------------------- plumbing
    def start(self) -> None:
        if self._thread is None and not self._closed:
            self._thread = threading.Thread(
                target=self._drain_loop, name="mercury-metrics", daemon=True)
            self._thread.start()

    def write(self, step: int, scalars: Dict) -> None:
        """Enqueue one step's scalar dict and return: no read of the card,
        no filesystem write. When a value lies on the card, an event is
        recorded on the caller's current stream for the drain thread to
        wait on."""
        if self._closed:
            return
        ready = None
        cuda = next((v.device for v in scalars.values()
                     if isinstance(v, torch.Tensor) and v.is_cuda), None)
        if cuda is not None:
            ready = torch.cuda.Event()
            ready.record(torch.cuda.current_stream(cuda))
        if self._thread is None and self._autostart:
            self.start()
        with self._have_work:
            if len(self._q) >= self.capacity:
                self._q.popleft()
                self.dropped += 1
            self._q.append((int(step), time.time(), scalars, ready))
            self._have_work.notify()

    def log_scalars(self, step: int, scalars: Dict) -> None:
        """``MetricsLogger``-compatible alias for :meth:`write`."""
        self.write(step, scalars)

    def add_observer(self, observer) -> bool:
        """Register an observer after construction (copy-on-write). Returns
        False, and registers nothing, once the writer is closed."""
        with self._lock:
            if self._closed:
                _log.warning("observer %r registered after close(); ignored", observer)
                return False
            self.observers = self.observers + [observer]
            return True

    def queue_depth(self) -> int:
        """Records enqueued but not yet fanned out to the sinks."""
        with self._lock:
            return len(self._q) + (1 if self._busy else 0)

    def latest_record(self) -> Optional[Dict[str, float]]:
        """A copy of the most recent host record after the observers; None
        until the first record drains."""
        with self._lock:
            return dict(self._latest) if self._latest is not None else None

    def flush(self, timeout: float = 60.0) -> None:
        """Block until every record enqueued so far is written to the sinks
        (and ask buffered sinks to reach the filesystem)."""
        deadline = time.monotonic() + timeout
        if self._thread is None:
            self._drain_pending()
        else:
            while time.monotonic() < deadline:
                with self._lock:
                    if not self._q and not self._busy:
                        break
                time.sleep(0.005)
        self._flush_sinks("flush")

    def close(self, timeout: float = 60.0) -> None:
        """Drain, stop the thread, close every sink. Idempotent. Joins the
        drain thread for at most ``timeout`` s and logs, never hangs on, a
        wedged one (a daemon, so it cannot block interpreter exit)."""
        with self._have_work:
            if self._closed:
                return
            self._closed = True
            self._stop = True
            self._have_work.notify()
        if self._thread is not None:
            self._thread.join(timeout=timeout)
            if self._thread.is_alive():
                _log.warning("metric drain thread %r still alive %.0fs after close() — "
                             "abandoning it wedged (daemon)", self._thread.name, timeout)
        self._drain_pending()
        for s in self.sinks:
            try:
                s.close()
            except Exception as exc:
                self._note_error("sink %s close failed: %s", type(s).__name__, exc)
        # Producers may still emit during the Trainer's teardown, so the
        # journal outlives the writer: written here, closed by the Trainer.
        self._flush_journal()

    def __enter__(self) -> "AsyncMetricWriter":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # ----------------------------------------------------------------- drain
    def _note_error(self, msg: str, *log_args) -> None:
        """Count and log a swallowed failure (from either thread)."""
        with self._lock:
            self.errors += 1
        _log.warning(msg, *log_args)

    def _flush_sinks(self, what: str) -> None:
        for s in self.sinks:
            flush = getattr(s, "flush", None)
            if flush is not None:
                try:
                    flush()
                except Exception as exc:
                    self._note_error("sink %s %s failed: %s", type(s).__name__, what, exc)
        self._flush_journal()

    def _flush_journal(self) -> None:
        if self._journal is not None:
            try:
                self._journal.flush()
            except Exception as exc:
                self._note_error("event journal flush failed: %s", exc)

    def _emit(self, item) -> None:
        step, t, scalars, ready = item
        if self._faults is not None:
            wedge = self._faults.fire("sink_wedge")
            if wedge is not None:
                # The drain thread, not a sink: writes keep queueing and the
                # drop-oldest policy absorbs the stall.
                time.sleep(float(wedge.get("secs", 1.0)))
        with self._lock:
            dropped = self.dropped
            observers = self.observers
        try:
            if ready is not None:
                ready.synchronize()
            record = _to_host_record(step, t, scalars, self._copy_streams)
            if dropped:
                record["obs/dropped"] = float(dropped)
        except Exception as exc:
            self._note_error("metric record for step %d failed on host conversion: %s",
                             step, exc)
            return
        for ob in observers:
            try:
                ob(record)
            except Exception as exc:
                self._note_error("observer %r failed at step %d: %s", ob, step, exc)
        for s in self.sinks:
            try:
                s.write(record)
            except Exception as exc:
                self._note_error("sink %s write failed at step %d: %s",
                                 type(s).__name__, step, exc)
        with self._lock:
            self._latest = record

    def _drain_pending(self) -> None:
        while True:
            with self._lock:
                if not self._q:
                    return
                item = self._q.popleft()
            self._emit(item)

    def _drain_loop(self) -> None:
        while True:
            with self._have_work:
                while not self._q and not self._stop:
                    self._have_work.wait(timeout=0.5)
                if not self._q and self._stop:
                    return
                item = self._q.popleft()
                self._busy = True
            try:
                self._emit(item)
            finally:
                with self._lock:
                    self._busy = False
                    idle = not self._q
            # Flush on idle: under load the sinks' buffers batch the
            # filesystem work; once the queue drains the records are durable.
            if idle:
                self._flush_sinks("idle-flush")


def host_thread_stats() -> Dict[str, float]:
    """Census of the host threads, cheap enough for every log tick:
    ``threads/alive`` (every live Python thread, main included) and
    ``threads/daemon`` (the workers: prefetch, metric drain, scorers)."""
    alive = threading.enumerate()
    return {
        "threads/alive": float(len(alive)),
        "threads/daemon": float(sum(1 for t in alive if t.daemon)),
    }


# ------------------------------------------------------------------- sinks
class JsonlSink:
    """Buffered JSONL: one record a line, flushed every ``flush_every``
    records or on ``flush()``/``close()``, not per record."""

    def __init__(self, log_dir: str, filename: str = "metrics.jsonl",
                 flush_every: int = 32) -> None:
        os.makedirs(log_dir, exist_ok=True)
        self._f = open(os.path.join(log_dir, filename), "a")
        self._since_flush = 0
        self.flush_every = max(int(flush_every), 1)

    def write(self, record: Dict[str, float]) -> None:
        if self._f is None:
            return
        self._f.write(json.dumps(record) + "\n")
        self._since_flush += 1
        if self._since_flush >= self.flush_every:
            self.flush()

    def flush(self) -> None:
        if self._f is not None:
            self._f.flush()
            self._since_flush = 0

    def close(self) -> None:
        if self._f is not None:
            self._f.close()
            self._f = None


class TensorBoardSink:
    """Scalars to a TensorBoard event file. Build it with
    :func:`try_tensorboard_sink`: TensorBoard is optional.

    A record's scalars go out as ONE summary event holding a value a tag:
    TensorBoard reads the same tags, steps and values as from one
    ``add_scalar`` a tag, which makes an event a tag and, beside a training
    thread that holds the GIL, keeps the drain thread (and the GIL) busy
    many times longer (``chip_smoke.py`` phase 15 (d) times each sink)."""

    def __init__(self, tb_writer) -> None:
        self._tb = tb_writer

    def write(self, record: Dict[str, float]) -> None:
        from tensorboard.compat.proto.summary_pb2 import Summary

        step = int(record["step"])
        summary = Summary(value=[Summary.Value(tag=tag, simple_value=float(value))
                                 for tag, value in record.items()
                                 if tag not in ("step", "time")])
        self._tb._get_file_writer().add_summary(summary, step)

    def flush(self) -> None:
        self._tb.flush()

    def close(self) -> None:
        self._tb.close()


def try_tensorboard_sink(log_dir: str) -> Optional[TensorBoardSink]:
    """A :class:`TensorBoardSink` on ``log_dir``, or None where
    ``torch.utils.tensorboard`` does not import."""
    tb = _try_tensorboard_writer(log_dir)
    return TensorBoardSink(tb) if tb is not None else None


class HeartbeatShardSink:
    """A rank's liveness shard, ``heartbeat.h{p}.jsonl``: one short line a
    logged record (the liveness keys only), flushed on EVERY write, so a
    rank that stops leaves its last logged step behind.

    When the shard would pass ``max_bytes`` it is rotated to
    ``<name>.1`` (one older generation kept) and a fresh shard started.
    ``0`` disables rotation."""

    _KEYS = ("time/step", "data/stall_s", "data/queue_depth",
             "obs/dropped", "anomaly/triggers", "host/straggler_ratio",
             "threads/alive")

    #: Rotation threshold: ~2 × 20k rows of ~200 bytes a rank.
    DEFAULT_MAX_BYTES = 4 * 1024 * 1024

    def __init__(self, log_dir: str, process_index: int,
                 max_bytes: int = DEFAULT_MAX_BYTES) -> None:
        os.makedirs(log_dir, exist_ok=True)
        self.process_index = int(process_index)
        self.max_bytes = int(max_bytes)
        self.rotations = 0
        self._path = os.path.join(log_dir, heartbeat_shard_filename(self.process_index))
        self._f = open(self._path, "a")
        try:
            self._size = os.path.getsize(self._path)
        except OSError:
            self._size = 0

    def _rotate(self) -> None:
        self._f.close()
        try:
            os.replace(self._path, self._path + ".1")
        except OSError:
            pass  # best effort: keep appending regardless
        self._f = open(self._path, "a")
        self._size = 0
        self.rotations += 1

    def write(self, record: Dict[str, float]) -> None:
        if self._f is None:
            return
        row = {"step": int(record.get("step", -1)),
               "time": float(record.get("time", 0.0)),
               "host": self.process_index}
        for key in self._KEYS:
            if key in record:
                row[key] = record[key]
        line = json.dumps(row) + "\n"
        if (self.max_bytes > 0 and self._size > 0
                and self._size + len(line) > self.max_bytes):
            self._rotate()
        self._f.write(line)
        self._f.flush()
        self._size += len(line)

    def close(self) -> None:
        if self._f is not None:
            self._f.close()
            self._f = None


class HeartbeatSink:
    """Rate-limited stdout line: at most once every ``every_steps`` steps
    AND at most once every ``min_interval_s`` seconds."""

    _KEYS = ("train/loss", "train/acc", "perf/steps_per_s",
             "perf/examples_per_s", "perf/mfu", "sampler/ess",
             "sampler/is_active", "data/stall_s", "obs/dropped",
             "anomaly/triggers", "scorer/throughput", "scorer/staleness",
             "scorer/slo_breaches")

    def __init__(self, every_steps: int = 100, min_interval_s: float = 1.0,
                 stream=None) -> None:
        self.every_steps = max(int(every_steps), 1)
        self.min_interval_s = float(min_interval_s)
        self._stream = stream if stream is not None else sys.stdout
        self._last_step: Optional[int] = None
        self._last_t = 0.0

    def write(self, record: Dict[str, float]) -> None:
        step = int(record["step"])
        if self._last_step is not None:
            if step // self.every_steps <= self._last_step // self.every_steps:
                return
            if time.monotonic() - self._last_t < self.min_interval_s:
                return
        self._last_step, self._last_t = step, time.monotonic()
        parts = [f"step {step}"]
        if "epoch" in record:
            parts.append(f"epoch {int(record['epoch'])}")
        for key in self._KEYS:
            if key in record:
                short = key.split("/")[-1]
                parts.append(f"{short} {record[key]:.4g}")
        print("  ".join(parts), file=self._stream, flush=True)

    def close(self) -> None:
        pass
