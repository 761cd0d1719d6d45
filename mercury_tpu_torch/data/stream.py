"""Host-streamed input: row sources and the prefetch pipeline of
``data_placement="host_stream"``.

The PyTorch counterpart of ``mercury_tpu/data/stream.py``. The pixels stay
in host memory; the step draws the selection of step t+depth at step t and
returns its global row ids as a device tensor, and a worker thread gathers
those rows into a staging slab and sends them to the device while the
steps in between run. Only the labels and the ``[L]`` score table must be
on the device.

Two sources share one protocol (``row_shape``, ``dtype``, ``len``,
``gather(gidx, out)``, ``close()``):

- :class:`HostStreamSource`: rows of a numpy array or an ``np.memmap``
  (the OS pages rows in as the gather reads them);
- :class:`ImageFolderSource`: ``root/<class>/<image>`` rows, decoded only
  when gathered.

Both split a gather over ``decode_workers`` threads when asked.

On the card, :class:`PrefetchPipeline` keeps ``depth + 1`` pinned staging
slabs. ``push(idx)`` records a CUDA event after the step that made ``idx``
and returns at once; the worker waits on that event, copies the indices to
pinned memory on a side stream, gathers the rows into the next slab and
copies it to the device with ``non_blocking=True`` on the side stream,
then records an event. The worker's events are blocking ones
(``cudaEventBlockingSync``): it sleeps on them instead of polling beside
the training thread's launches. ``pop()`` makes the current stream wait on that
event and marks the batch as used there (``record_stream``), so the
training thread never waits for the indices or the copy. On the CPU the
same code runs with plain copies.
"""

from __future__ import annotations

import queue
import threading
import time
import traceback
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from mercury_tpu_torch.obs.trace import NULL_TRACER
from mercury_tpu_torch.utils.logging import get_logger

__all__ = ["HostStreamSource", "ImageFolderSource", "PrefetchPipeline"]

_log = get_logger(__name__)


class _Threads:
    """An optional pool of ``workers`` threads for a source's gather."""

    def __init__(self, workers: int, name: str) -> None:
        self.workers = max(int(workers), 0)
        self._pool = None
        if self.workers > 0:
            from concurrent.futures import ThreadPoolExecutor

            self._pool = ThreadPoolExecutor(self.workers, thread_name_prefix=name)

    def map(self, fn, items) -> None:
        if self._pool is None:
            for item in items:
                fn(item)
            return
        # list() re-raises a thread's exception here, on the caller.
        list(self._pool.map(fn, items))

    def close(self) -> None:
        if self._pool is not None:
            self._pool.shutdown(wait=True)
            self._pool = None


class HostStreamSource:
    """Rows of a host ``[N, ...]`` array (an ``np.ndarray`` or an
    ``np.memmap``) that the device never holds. With ``decode_workers > 0``
    the gather is cut into that many chunks, one a thread (numpy's copy
    and memmap page-ins release the GIL)."""

    def __init__(self, x, decode_workers: int = 0) -> None:
        if getattr(x, "ndim", 0) < 1:
            raise ValueError("HostStreamSource needs an [N, ...] array")
        self._x = x
        self.row_shape: Tuple[int, ...] = tuple(x.shape[1:])
        self.dtype = np.dtype(x.dtype)
        self._threads = _Threads(decode_workers, "mercury-gather")

    def __len__(self) -> int:
        return int(self._x.shape[0])

    def gather(self, gidx: np.ndarray, out: np.ndarray) -> None:
        """``out[i] = x[gidx[i]]`` for global row ids ``gidx``."""
        n = int(gidx.shape[0])
        chunk = -(-n // max(self._threads.workers, 1))

        def fill(lo: int) -> None:
            hi = min(lo + chunk, n)
            out[lo:hi] = self._x[gidx[lo:hi]]

        self._threads.map(fill, range(0, n, chunk))

    def close(self) -> None:
        self._threads.close()


class ImageFolderSource:
    """``root/<class>/<image>`` rows, decoded and resized to ``image_size``
    only when a step gathers them: global row ``i`` is row ``i`` of
    ``data/imagefolder.py``'s eager arrays. ``decode_workers`` threads
    decode one image each at a time."""

    def __init__(self, root: str, image_size: int = 32, decode_workers: int = 0) -> None:
        from mercury_tpu_torch.data.imagefolder import list_image_folder

        if image_size is None:
            raise ValueError("ImageFolderSource needs a fixed image_size (the staging "
                             "slabs are allocated before any decode)")
        self._paths, self.labels, self.classes = list_image_folder(root)
        self._size = int(image_size)
        self.row_shape = (self._size, self._size, 3)
        self.dtype = np.dtype(np.uint8)
        self._threads = _Threads(decode_workers, "mercury-decode")

    def __len__(self) -> int:
        return len(self._paths)

    def gather(self, gidx: np.ndarray, out: np.ndarray) -> None:
        from mercury_tpu_torch.data.imagefolder import load_image

        def decode(i: int) -> None:
            out[i] = load_image(self._paths[int(gidx[i])], self._size)

        self._threads.map(decode, range(int(gidx.shape[0])))

    def close(self) -> None:
        self._threads.close()


_STOP = object()
_FAILED = object()


class PrefetchPipeline:
    """Bounded host → device prefetch of ``rows`` rows a batch from
    ``source`` to ``device``.

    ``push(idx)`` hands the worker one selection's ``[rows]`` global row
    ids (a device tensor, usually not computed yet, or a host array) and
    never blocks. ``pop()`` returns the oldest batch, ``[rows, *row_shape]``
    on ``device``. With ``depth`` selections in flight (the prime pushes
    ``depth``), the gather and copy for step t+depth overlap steps
    t … t+depth−1. The ready queue holds at most ``depth`` batches, and
    ``depth + 1`` slabs rotate, so memory does not grow with the dataset.

    ``total_wait_s`` adds up the time ``pop`` blocked; ``total_stall_s``
    the part of it due to the input, the worker's gather and copy after
    the indices were ready (the wait for the step that makes the indices
    is the pipeline's normal cadence). A worker that dies re-raises its
    exception, with its traceback, at the next ``pop``. ``faults`` (a
    :class:`~mercury_tpu_torch.faults.FaultPlane`) arms the ``prefetch_die``
    and ``prefetch_stall`` hooks before each gather. ``generation`` > 0
    names the worker ``mercury-prefetch-r<generation>``: a pipeline the
    supervisor built in place of a dead one. ``tracer`` (``obs/trace.py``)
    records the worker's ``stream/*`` spans on its ``prefetch`` track.
    """

    def __init__(self, source, rows: int, device, depth: int = 2,
                 pop_timeout_s: float = 300.0, faults=None, generation: int = 0,
                 tracer=None) -> None:
        if depth < 1:
            raise ValueError(f"depth must be >= 1, got {depth}")
        self.source = source
        self.depth = int(depth)
        self.rows = int(rows)
        self.device = torch.device(device)
        self._cuda = self.device.type == "cuda"
        if self._cuda and self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        self._pop_timeout_s = float(pop_timeout_s)
        self._faults = faults
        self._tracer = tracer if tracer is not None else NULL_TRACER
        dtype = torch.from_numpy(np.empty(0, source.dtype)).dtype
        shape = (self.rows,) + tuple(source.row_shape)
        self._staging = [torch.empty(shape, dtype=dtype, pin_memory=self._cuda)
                         for _ in range(self.depth + 1)]
        self._idx_host = [torch.empty(self.rows, dtype=torch.int64, pin_memory=self._cuda)
                          for _ in range(self.depth + 1)]
        # The event after each slab's last copy to the device: the worker
        # waits on it before it writes the slab again.
        self._copied: list = [None] * (self.depth + 1)
        self._slot = 0
        self._copy_stream = torch.cuda.Stream(self.device) if self._cuda else None
        self._work: "queue.Queue[Any]" = queue.Queue()
        self._ready: "queue.Queue[Any]" = queue.Queue(maxsize=self.depth)
        self._generation = 0
        self._exc: Optional[BaseException] = None
        self._exc_tb: Optional[str] = None
        self.total_stall_s = 0.0
        self.total_wait_s = 0.0
        self.total_h2d_bytes = 0
        self.pops = 0
        self._last_stall_s = 0.0
        self._last_h2d_bytes = 0
        self._closed = False
        suffix = f"-r{int(generation)}" if generation else ""
        self._thread = threading.Thread(target=self._loop, name=f"mercury-prefetch{suffix}",
                                        daemon=True)
        self._thread.start()

    # ------------------------------------------------------------ driving
    def push(self, idx) -> None:
        """Queue one selection's ``[rows]`` global row ids. On the card the
        event recorded here after the step that makes ``idx`` is what the
        worker waits on; this call does not wait."""
        if self._closed:
            raise RuntimeError("push() on a closed PrefetchPipeline")
        ready = None
        if isinstance(idx, torch.Tensor) and idx.is_cuda:
            ready = torch.cuda.Event()
            ready.record(torch.cuda.current_stream(idx.device))
        self._work.put((self._generation, idx, ready))

    def pop(self) -> torch.Tensor:
        """The oldest batch; blocks while the worker catches up."""
        if self._exc is not None:
            raise self._worker_death()
        t0 = time.monotonic()
        while True:
            try:
                item = self._ready.get(timeout=self._pop_timeout_s)
            except queue.Empty:
                if self._exc is not None:
                    raise self._worker_death() from None
                raise TimeoutError(f"no prefetched batch within {self._pop_timeout_s:.0f} s "
                                   "(was every pop matched by a push?)") from None
            if item is _FAILED:
                raise self._worker_death()
            generation, batch, copied, host_lag_s = item
            if generation == self._generation:
                break  # else a batch of the trajectory before reset(): dropped
        waited = time.monotonic() - t0
        self.total_wait_s += waited
        self.total_stall_s += min(waited, host_lag_s)
        self.pops += 1
        if copied is not None:
            stream = torch.cuda.current_stream(self.device)
            stream.wait_event(copied)
            batch.record_stream(stream)
        return batch

    def _worker_death(self) -> RuntimeError:
        err = RuntimeError("prefetch worker died:\n" + (self._exc_tb or "<no traceback>"))
        err.__cause__ = self._exc
        return err

    def alive(self) -> bool:
        return not self._closed and self._exc is None and self._thread.is_alive()

    def stats(self) -> Dict[str, float]:
        """Since the previous call: ``data/stall_s`` and ``data/h2d_bytes``;
        and the ready queue's depth now."""
        stall = self.total_stall_s - self._last_stall_s
        h2d = self.total_h2d_bytes - self._last_h2d_bytes
        self._last_stall_s, self._last_h2d_bytes = self.total_stall_s, self.total_h2d_bytes
        depth = float(self._ready.qsize())
        return {"data/stall_s": stall, "data/queue_depth": depth,
                "data/h2d_bytes": float(h2d), "threads/queue_depth/prefetch": depth}

    def summary(self) -> Dict[str, float]:
        """The running totals (unlike :meth:`stats`, reading them moves
        nothing)."""
        return {"depth": float(self.depth), "queue_depth": float(self._ready.qsize()),
                "pops": float(self.pops), "total_stall_s": self.total_stall_s,
                "total_wait_s": self.total_wait_s,
                "total_h2d_bytes": float(self.total_h2d_bytes)}

    def reset(self) -> None:
        """Drop every queued selection and batch (a restore re-seeds the
        pipeline from its ring). A batch the worker is making now belongs
        to the old generation, and ``pop`` drops it."""
        self._generation += 1
        self._drain(self._work)
        self._drain(self._ready)

    @staticmethod
    def _drain(q: "queue.Queue[Any]") -> None:
        while True:
            try:
                q.get_nowait()
            except queue.Empty:
                return

    def close(self, timeout: float = 30.0) -> None:
        """Stop the worker and close the source; a second call does
        nothing."""
        if self._closed:
            return
        self._closed = True
        self._work.put(_STOP)
        self._drain(self._ready)  # room for a worker parked in _publish
        self._thread.join(timeout=timeout)
        if self._thread.is_alive():
            _log.warning("prefetch worker still running %.0f s after close(): left to "
                         "end with the process (a daemon thread)", timeout)
        self.source.close()

    # ------------------------------------------------------------- worker
    def _publish(self, item) -> bool:
        while not self._closed:
            try:
                self._ready.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def _indices(self, idx, ready, host: torch.Tensor) -> np.ndarray:
        """The selection's row ids on the host: a device tensor copied to
        the pinned ``host`` on the side stream once the step that makes it
        is done, waited for here, on the worker."""
        if ready is None:
            host.copy_(torch.as_tensor(np.asarray(idx)).reshape(-1))
            return host.numpy()
        with torch.cuda.stream(self._copy_stream):
            self._copy_stream.wait_event(ready)
            host.copy_(idx.reshape(-1), non_blocking=True)
            got = torch.cuda.Event(blocking=True)
            got.record(self._copy_stream)
        got.synchronize()
        return host.numpy()

    def _loop(self) -> None:
        if self._cuda:
            torch.cuda.set_device(self.device)
        tracer = self._tracer
        tracer.register_thread("prefetch")
        while True:
            item = self._work.get()
            if item is _STOP:
                return
            generation, idx, ready = item
            try:
                if self._faults is not None:
                    if self._faults.fire("prefetch_die") is not None:
                        raise self._faults.injected("prefetch_die: injected prefetch-worker death")
                    stall = self._faults.fire("prefetch_stall")
                    if stall is not None:
                        time.sleep(float(stall.get("secs", 1.0)))
                slot = self._slot
                self._slot = (slot + 1) % len(self._staging)
                slab = self._staging[slot]
                if self._copied[slot] is not None:
                    # depth + 1 slabs back: a fence, all but never a wait.
                    with tracer.span("stream/slab_fence", cat="stream"):
                        self._copied[slot].synchronize()
                # The wait this thread exists to absorb: the step that makes
                # the indices, so the training thread never waits for it.
                with tracer.span("stream/wait_indices", cat="stream"):
                    gidx = self._indices(idx, ready, self._idx_host[slot])
                if gidx.shape[0] != self.rows:
                    raise ValueError(f"a selection of {gidx.shape[0]} rows; the pipeline "
                                     f"streams {self.rows}")
                t_ready = time.monotonic()
                with tracer.span("stream/gather", cat="stream", rows=int(gidx.size)):
                    self.source.gather(gidx, slab.numpy())
                copied = None
                # The copy's enqueue on the side stream (on the card), not
                # the copy itself.
                with tracer.span("stream/h2d", cat="stream",
                                 bytes=int(slab.numel() * slab.element_size())):
                    if self._cuda:
                        with torch.cuda.stream(self._copy_stream):
                            batch = slab.to(self.device, non_blocking=True)
                            copied = torch.cuda.Event(blocking=True)
                            copied.record(self._copy_stream)
                        self._copied[slot] = copied
                    else:
                        batch = slab.clone()
                self.total_h2d_bytes += slab.numel() * slab.element_size()
                self._publish((generation, batch, copied, time.monotonic() - t_ready))
            except BaseException as exc:  # raised again at the next pop()
                self._exc_tb = traceback.format_exc()
                self._exc = exc
                self._publish(_FAILED)
                return
