"""The event journal: the control plane's decisions, each with its cause —
the port's own copy of ``mercury_tpu/obs/events.py`` and of the
``EVENT_KINDS`` registry of ``mercury_tpu/obs/registry.py``.

The supervisor's ladder moves, restarts and SLO latches, the scorer
service's tenants, snapshots, starvation and wedges, the fault plane's
firings, checkpoint generations, elastic reshards and the anomaly
engine's triggers are appended to ``events.h{r}.jsonl`` (one file a rank,
a schema header first). Each event carries a ``parent_id`` naming the
event that caused it, so a walk down the ladder reads back as one chain
(:func:`parent_chain`) rooted at the breach or fault that began it.

- **Producers do no IO.** :meth:`EventJournal.emit` serializes the event
  under a lock that takes no other lock (safe inside the fault plane's
  and the supervisor's) into a bounded buffer; :meth:`EventJournal.flush`
  writes it, on the metric writer's drain thread when it goes idle and
  once more at close.
- **Whole lines.** A crash can tear the last line only, and
  :func:`read_journal` skips it.
- **Host only, standard library only.**
"""

from __future__ import annotations

import json
import os
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional

#: Schema tag of the header line of every journal file.
EVENT_SCHEMA = "mercury_events_v1"

#: The fields of every event row, in order.
EVENT_FIELDS = ("event_id", "parent_id", "kind", "step", "mono_ns",
                "wall_s", "host", "detail")

#: The buffer's bound: decisions are rare, so this guards a runaway only.
#: The oldest events go first, counted as dropped.
DEFAULT_CAPACITY = 8192

#: Every event kind, ``subsystem/name``, with its meaning: the JAX
#: package's registry, key for key. ``plan/*``, ``elastic/replan`` and
#: ``checkpoint/schema_drift`` belong to modules the port has not taken
#: yet, and nothing of the port emits them.
EVENT_KINDS: Dict[str, str] = {
    # supervisor/* — ladder and restarts (runtime/supervisor.py)
    "supervisor/slo_breach":
        "a registered SLO latched (rising edge); roots a breach episode",
    "supervisor/slo_release":
        "a latched SLO stopped breaching; parent = the breach event",
    "supervisor/degrade":
        "one-level ladder descent; parent = breach/exhaustion/probe event",
    "supervisor/recover":
        "one-level ladder ascent; parent = the successful probe",
    "supervisor/restart": "a dead host unit was restarted successfully",
    "supervisor/restart_failed": "a unit restart attempt raised",
    "supervisor/exhausted":
        "a unit ran out of restart budget; parent = the failed restart",
    "supervisor/probe_ok":
        "recovery probe succeeded; parent = the degrade it is probing",
    "supervisor/probe_failed":
        "recovery probe raised; parent = the degrade it is probing",
    # scorer/* — the scorer service (sampling/scorer_service.py)
    "scorer/tenant_admitted": "a tenant queue was admitted at startup",
    "scorer/wedged": "a tenant was wedged by the scorer_wedge fault",
    "scorer/starved":
        "a tenant's staleness/queue SLO latched (starvation decision)",
    "scorer/snapshot": "a new params snapshot opened a scoring epoch",
    # fault/* — the injection plane (faults.py)
    "fault/fired": "a scheduled fault fired at its hook point",
    # elastic/* — restores across world sizes (train/elastic.py)
    "elastic/reshard_begin": "elastic restore started; detail has old/new W,L",
    "elastic/reshard_end": "elastic restore finished; parent = reshard_begin",
    "elastic/replan":
        "auto-planner re-evaluated the plan after a (W, L) change; "
        "detail carries both scored tables",
    # plan/* — the auto-planner's decision
    "plan/selected":
        "plan resolution at construction; detail carries the scored table",
    # checkpoint/* — durable generations (train/checkpoint.py)
    "checkpoint/written": "a checkpoint generation was written durably",
    "checkpoint/verified": "a generation passed manifest verification",
    "checkpoint/fallback":
        "restore rejected a generation and fell back to an older one",
    "checkpoint/schema_drift":
        "a restored manifest's state_schema_sha differs from HEAD's",
    # anomaly/* — the flight recorder (obs/anomaly.py)
    "anomaly/triggered":
        "an anomaly trigger fired; detail carries the flight-record path",
}


def journal_filename(process_index: int) -> str:
    """The journal file of one rank."""
    return f"events.h{int(process_index)}.jsonl"


class EventJournal:
    """An append-only journal of one rank: :meth:`emit` buffers from any
    thread, :meth:`flush` writes (the metric writer's drain thread),
    :meth:`close` belongs to the Trainer."""

    def __init__(self, log_dir: str, host: int = 0, *,
                 capacity: int = DEFAULT_CAPACITY) -> None:
        self._host = int(host)
        self._capacity = int(capacity)
        self._lock = threading.Lock()  # a leaf: takes no other lock
        self._seq = 0
        self._buf: deque = deque()
        # The last 64 events, kept across flushes for status readers.
        self._recent: deque = deque(maxlen=64)
        self._emitted = 0
        self._dropped = 0
        self._closed = False
        os.makedirs(log_dir, exist_ok=True)
        self.path = os.path.join(log_dir, journal_filename(self._host))
        self._f = open(self.path, "a")
        self._f.write(json.dumps({"schema": EVENT_SCHEMA, "host": self._host,
                                  "wall_s": time.time()}) + "\n")
        self._f.flush()

    def emit(self, kind: str, step: int = -1, *, parent: Optional[str] = None,
             detail: Optional[Dict[str, Any]] = None) -> Optional[str]:
        """Buffer one event and return its ``event_id`` (a later event's
        ``parent``), or None once the journal is closed. ``step`` is the
        step the decision belongs to (-1: none). A ``detail`` that JSON
        cannot encode is kept as its ``repr``, never raised on."""
        mono_ns = time.monotonic_ns()
        wall_s = time.time()
        with self._lock:
            if self._closed:
                return None
            eid = f"e{self._host}-{self._seq}"
            self._seq += 1
            evt = {"event_id": eid, "parent_id": parent, "kind": str(kind),
                   "step": int(step), "mono_ns": mono_ns, "wall_s": wall_s,
                   "host": self._host, "detail": detail if detail is not None else {}}
            try:
                line = json.dumps(evt, default=str)
            except (TypeError, ValueError):
                evt["detail"] = {"unserializable": repr(detail)}
                line = json.dumps(evt, default=str)
            if len(self._buf) >= self._capacity:
                self._buf.popleft()
                self._dropped += 1
            self._buf.append(line)
            self._recent.append(evt)
            self._emitted += 1
            return eid

    def flush(self) -> int:
        """Write every buffered event as whole lines; return how many."""
        with self._lock:
            if self._f is None or not self._buf:
                return 0
            n = len(self._buf)
            self._f.write("\n".join(self._buf) + "\n")
            self._buf.clear()
            self._f.flush()
            return n

    def close(self) -> None:
        """Write what is buffered and close the file; later emits are
        dropped. A second call does nothing."""
        with self._lock:
            self._closed = True
            if self._f is None:
                return
            if self._buf:
                self._f.write("\n".join(self._buf) + "\n")
                self._buf.clear()
            self._f.flush()
            self._f.close()
            self._f = None

    def tail(self, n: int = 20) -> List[Dict[str, Any]]:
        """The last ``n`` events emitted (the newest last), written or not."""
        with self._lock:
            recent = list(self._recent)
        n = max(int(n), 0)
        return recent[-n:] if n else []

    def counts(self) -> Dict[str, int]:
        with self._lock:
            return {"emitted": self._emitted, "dropped": self._dropped,
                    "buffered": len(self._buf)}


def read_journal(path: str) -> List[Dict[str, Any]]:
    """Every event written to one journal file, in order; the header,
    blank lines and a torn last line are skipped, and nothing raises (an
    unreadable file gives [])."""
    events: List[Dict[str, Any]] = []
    try:
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    row = json.loads(line)
                except json.JSONDecodeError:
                    continue  # a torn line
                if isinstance(row, dict) and "schema" not in row:
                    events.append(row)
    except OSError:
        return []
    return events


def load_events(run_dir: str) -> List[Dict[str, Any]]:
    """Every rank's journal in ``run_dir``, merged by wall clock (stable
    within a rank)."""
    merged: List[Dict[str, Any]] = []
    try:
        names = sorted(os.listdir(run_dir))
    except OSError:
        return []
    for name in names:
        if name.startswith("events.h") and name.endswith(".jsonl"):
            merged.extend(read_journal(os.path.join(run_dir, name)))
    merged.sort(key=lambda e: (e.get("wall_s", 0.0), str(e.get("event_id"))))
    return merged


def validate_event(evt: Dict[str, Any], *,
                   registry: Optional[Dict[str, str]] = None) -> List[str]:
    """The problems of one event row ([] when it is valid); with
    ``registry`` (:data:`EVENT_KINDS`) an unregistered kind is one."""
    if not isinstance(evt, dict):
        return ["event is not an object"]
    problems = [f"missing field {field!r}" for field in EVENT_FIELDS if field not in evt]
    if problems:
        return problems
    if not isinstance(evt["event_id"], str) or not evt["event_id"]:
        problems.append("event_id must be a non-empty string")
    if evt["parent_id"] is not None and not isinstance(evt["parent_id"], str):
        problems.append("parent_id must be null or a string")
    kind = evt["kind"]
    if not isinstance(kind, str) or kind.count("/") != 1:
        problems.append(f"kind {kind!r} must be 'subsystem/name'")
    elif registry is not None and kind not in registry:
        problems.append(f"kind {kind!r} not in EVENT_KINDS registry")
    for field, types, what in (("step", int, "an int"), ("mono_ns", int, "an int"),
                               ("wall_s", (int, float), "a number"),
                               ("host", int, "an int"), ("detail", dict, "an object")):
        if not isinstance(evt[field], types):
            problems.append(f"{field} must be {what}")
    return problems


def parent_chain(events: List[Dict[str, Any]], event_id: str) -> List[Dict[str, Any]]:
    """The ``parent_id`` links from ``event_id`` back to its root, root
    first; a cycle (a corrupt journal) ends the walk."""
    by_id = {e["event_id"]: e for e in events if "event_id" in e}
    chain: List[Dict[str, Any]] = []
    seen: set = set()
    cur = by_id.get(event_id)
    while cur is not None and cur["event_id"] not in seen:
        seen.add(cur["event_id"])
        chain.append(cur)
        parent = cur.get("parent_id")
        cur = by_id.get(parent) if parent else None
    chain.reverse()
    return chain
