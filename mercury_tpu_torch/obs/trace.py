"""Host-side step-timeline tracing: where the wall-clock went — the
port's own copy of ``mercury_tpu/obs/trace.py`` (standard library only).

Everything around the step's launches is host code: the prefetch pop
waits, the gathers and copies of the host stream, the step's dispatch, the
async scorer's chunks, the evaluation, the checkpoint writes and the log
tick. :class:`SpanTracer` records named spans from any thread into a ring
of fixed capacity (memory and cost bounded whatever the run's length) and
exports them as Chrome trace-event JSON, loadable in Perfetto
(https://ui.perfetto.dev) or ``chrome://tracing``.

A span times host work only, and never synchronizes the card: a span
around the step times its launches (the host's enqueue of the kernels),
not the kernels, which run on after it closes. The kernels' own times are
``torch.profiler``'s (``train/profile.py``, ``obs/profile_parse.py``).

Overhead:

- **enabled**: one ``perf_counter_ns`` pair and a deque append a span;
- **disabled**: :data:`NULL_TRACER` returns one shared no-op context
  manager, so an instrumented call site costs an attribute lookup and two
  empty method calls and allocates nothing. The step's launches are the
  same either way.

Span schema (one Chrome ``"ph": "X"`` complete event a span)::

    {"name": "stream/gather", "cat": "stream", "ph": "X",
     "ts": <µs since tracer epoch>, "dur": <µs>,
     "pid": <os pid>, "tid": <thread id>, "args": {...}}

The span names are the JAX package's: ``trainer/*`` (the training
thread), ``stream/*`` (the prefetch worker), ``fleet/chunk`` (the scorer's
workers), ``anomaly/<kind>`` and ``profiler/{start,stop}`` instants.
"""

from __future__ import annotations

import json
import os
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional

__all__ = ["SpanTracer", "NULL_TRACER", "NullTracer",
           "journal_lane_events", "merge_events_into_trace"]

#: ``otherData.tracer`` of an exported trace.
TRACER_NAME = "mercury_tpu_torch.obs.trace"

#: Synthetic Chrome ``tid`` base for the per-subsystem journal lanes.
#: Real thread ids on linux are pthread addresses (very large), so a
#: small fixed base cannot collide with a recorded span's tid.
_EVENT_LANE_TID_BASE = 0xE000


def journal_lane_events(events: List[Dict[str, Any]],
                        epoch_unix_s: float,
                        pid: Optional[int] = None) -> List[Dict[str, Any]]:
    """Convert control-plane journal rows (``obs/events.py``) into Chrome
    trace events: one instant per event on a synthetic per-subsystem
    lane (``events/supervisor``, ``events/fault``, ...), plus a flow
    arrow (``ph:"s"``/``ph:"f"``) for every ``parent_id`` link — so
    Perfetto draws the causal chain breach → degrade → probe → recover
    on top of the span timeline.

    ``epoch_unix_s`` is the span tracer's wall-clock epoch
    (``otherData.epoch_unix_s`` of an exported trace): journal events
    carry absolute ``wall_s`` and are aligned into the tracer's
    microsecond timebase here. Pure stdlib — usable offline against an
    exported ``trace.json`` + journal file (see
    :func:`merge_events_into_trace`)."""
    pid = os.getpid() if pid is None else pid
    out: List[Dict[str, Any]] = []
    lanes: Dict[str, int] = {}
    placed: Dict[str, tuple] = {}  # event_id -> (ts_us, tid)
    for evt in events:
        kind = str(evt.get("kind", "?/?"))
        subsystem = kind.split("/", 1)[0]
        tid = lanes.setdefault(subsystem,
                               _EVENT_LANE_TID_BASE + len(lanes))
        ts = (float(evt.get("wall_s", epoch_unix_s)) - epoch_unix_s) * 1e6
        eid = evt.get("event_id")
        if isinstance(eid, str):
            placed[eid] = (ts, tid)
        out.append({
            "name": kind, "cat": "events", "ph": "i", "s": "p",
            "ts": ts, "pid": pid, "tid": tid,
            "args": {"event_id": eid,
                     "parent_id": evt.get("parent_id"),
                     "step": evt.get("step"),
                     "host": evt.get("host"),
                     "detail": evt.get("detail")},
        })
    flows = 0
    for evt in events:
        parent, eid = evt.get("parent_id"), evt.get("event_id")
        if not (isinstance(parent, str) and parent in placed
                and isinstance(eid, str) and eid in placed):
            continue
        p_ts, p_tid = placed[parent]
        c_ts, c_tid = placed[eid]
        flows += 1
        fid = f"evt-flow-{flows}"
        out.append({"name": "causes", "cat": "events", "ph": "s",
                    "id": fid, "ts": p_ts, "pid": pid, "tid": p_tid})
        out.append({"name": "causes", "cat": "events", "ph": "f",
                    "bp": "e", "id": fid, "ts": c_ts, "pid": pid,
                    "tid": c_tid})
    for subsystem, tid in lanes.items():
        out.append({"name": "thread_name", "ph": "M", "pid": pid,
                    "tid": tid, "args": {"name": f"events/{subsystem}"}})
    return out


def merge_events_into_trace(doc: Dict[str, Any],
                            events: List[Dict[str, Any]]
                            ) -> Dict[str, Any]:
    """Offline merge: append journal lanes to an already-exported Chrome
    trace document (mutates and returns ``doc``). The document must
    carry ``otherData.epoch_unix_s`` (every SpanTracer export does)."""
    other = doc.setdefault("otherData", {})
    epoch = float(other.get("epoch_unix_s", 0.0))
    pids = [e.get("pid") for e in doc.get("traceEvents", [])
            if e.get("pid") is not None]
    pid = pids[0] if pids else None
    doc.setdefault("traceEvents", []).extend(
        journal_lane_events(events, epoch, pid=pid))
    other["journal_events"] = len(events)
    return doc


class _NullSpan:
    """Shared reusable no-op context manager — the entire disabled path."""

    __slots__ = ()

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc) -> bool:
        return False


_NULL_SPAN = _NullSpan()


class NullTracer:
    """Disabled tracer: same surface as :class:`SpanTracer`, no state.

    Call sites keep their instrumentation unconditionally and pay only
    the shared no-op context manager when tracing is off — no branches
    at the call site, no per-span allocation."""

    enabled = False

    def span(self, name: str, cat: str = "trainer", **args) -> _NullSpan:
        return _NULL_SPAN

    def instant(self, name: str, cat: str = "trainer", **args) -> None:
        return None

    def register_thread(self, name: str) -> None:
        return None

    def snapshot(self) -> List[Dict[str, Any]]:
        return []

    def export_chrome_trace(self, path: str,
                            events: Optional[List[Dict[str, Any]]] = None
                            ) -> Optional[str]:
        return None


#: The process-wide disabled tracer. ``tracer or NULL_TRACER`` is the
#: idiom for optional-tracer parameters.
NULL_TRACER = NullTracer()


class _Span:
    """One live span: measures ``perf_counter_ns`` across the body and
    appends a ring tuple on exit. Exceptions propagate (the span still
    records — a span that died mid-body is exactly what a post-mortem
    wants to see)."""

    __slots__ = ("_tracer", "_name", "_cat", "_args", "_t0")

    def __init__(self, tracer: "SpanTracer", name: str, cat: str,
                 args: Optional[Dict[str, Any]]) -> None:
        self._tracer = tracer
        self._name = name
        self._cat = cat
        self._args = args

    def __enter__(self) -> "_Span":
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> bool:
        t1 = time.perf_counter_ns()
        tr = self._tracer
        # deque.append is atomic under the GIL: spans land from the
        # training thread, the prefetch worker, and the metric drain
        # thread without a lock on the hot path.
        tr._ring.append((self._name, self._cat, threading.get_ident(),
                         self._t0, t1 - self._t0, self._args))
        tr._total += 1
        return False


class SpanTracer:
    """Ring-buffered host span tracer with Chrome-trace export.

    ``capacity`` bounds memory and export size: a week-long run keeps
    the *last* ``capacity`` spans (the flight recorder's post-mortem
    window), and ``dropped`` says how many rotated out."""

    enabled = True

    def __init__(self, capacity: int = 4096) -> None:
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = int(capacity)
        self._ring: deque = deque(maxlen=self.capacity)
        self._total = 0
        self._epoch_ns = time.perf_counter_ns()
        self._epoch_unix = time.time()
        self._thread_names: Dict[int, str] = {}

    # ------------------------------------------------------------ recording
    def span(self, name: str, cat: str = "trainer", **args) -> _Span:
        """Context manager timing its body as one complete event."""
        return _Span(self, name, cat, args or None)

    def instant(self, name: str, cat: str = "trainer", **args) -> None:
        """Zero-duration marker event (trigger points, mode switches)."""
        self._ring.append((name, cat, threading.get_ident(),
                           time.perf_counter_ns(), -1, args or None))
        self._total += 1

    def register_thread(self, name: str) -> None:
        """Name the calling thread in the exported trace's track list."""
        self._thread_names[threading.get_ident()] = name

    @property
    def dropped(self) -> int:
        """Spans rotated out of the ring since construction."""
        return self._total - len(self._ring)

    # -------------------------------------------------------------- export
    def snapshot(self) -> List[Dict[str, Any]]:
        """Ring contents as Chrome trace events (oldest first). A point-
        in-time copy — safe while other threads keep recording."""
        pid = os.getpid()
        events: List[Dict[str, Any]] = []
        for name, cat, tid, t0_ns, dur_ns, args in list(self._ring):
            ev: Dict[str, Any] = {
                "name": name,
                "cat": cat,
                "ts": (t0_ns - self._epoch_ns) / 1e3,  # µs, tracer epoch
                "pid": pid,
                "tid": tid,
            }
            if dur_ns < 0:
                ev["ph"] = "i"
                ev["s"] = "t"  # instant scoped to its thread
            else:
                ev["ph"] = "X"
                ev["dur"] = dur_ns / 1e3
            if args:
                ev["args"] = dict(args)
            events.append(ev)
        return events

    def chrome_trace(self, events: Optional[List[Dict[str, Any]]] = None
                     ) -> Dict[str, Any]:
        """The full trace document: spans + thread-name metadata, plus —
        when ``events`` (control-plane journal rows) is given — one
        instant-event lane per subsystem and flow arrows for causal
        ``parent_id`` links, all on the tracer's shared timebase."""
        pid = os.getpid()
        trace_events = self.snapshot()
        for tid, name in list(self._thread_names.items()):
            trace_events.append({
                "name": "thread_name", "ph": "M", "pid": pid, "tid": tid,
                "args": {"name": name},
            })
        other: Dict[str, Any] = {
            "tracer": TRACER_NAME,
            "epoch_unix_s": self._epoch_unix,
            "span_capacity": self.capacity,
            "spans_recorded": self._total,
            "spans_dropped": self.dropped,
        }
        if events:
            trace_events.extend(
                journal_lane_events(events, self._epoch_unix, pid=pid))
            other["journal_events"] = len(events)
        return {
            "traceEvents": trace_events,
            "displayTimeUnit": "ms",
            "otherData": other,
        }

    def export_chrome_trace(self, path: str,
                            events: Optional[List[Dict[str, Any]]] = None
                            ) -> str:
        """Write the trace JSON atomically; returns the path. The file
        loads as-is in Perfetto / ``chrome://tracing``."""
        doc = self.chrome_trace(events=events)
        directory = os.path.dirname(os.path.abspath(path))
        os.makedirs(directory, exist_ok=True)
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(doc, f)
            f.write("\n")
        os.replace(tmp, path)
        return path
