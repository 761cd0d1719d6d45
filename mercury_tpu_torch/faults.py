"""Deterministic fault injection for the port's host runtime: the port's
own copy of ``mercury_tpu/faults.py``, with the same grammar, kinds and
firing rules. A firing counts into :meth:`FaultPlane.stats` and
:meth:`FaultPlane.summary` and, with a journal, is journaled as
``fault/fired``; the hook sites that raise put that event's id on the
:class:`InjectedFault`, so what the death caused (a restart, a ladder
step) names it as its parent.

Spec grammar (``TrainConfig.fault_spec``)::

    spec  := entry (';' entry)*
    entry := kind '@' param (',' param)*
    param := key '=' number

    "scorer_die@step=40"                     # one-shot at step 40
    "prefetch_stall@step=10,secs=2"          # stall the gather 2 s once
    "ckpt_io_error@step=0,every=1"           # every checkpoint write fails
    "scorer_die@step=5;scorer_die@step=9"    # two scheduled deaths

``step`` is mandatory: the entry arms at the first clock reading >= it.
``fit`` advances the clock (:meth:`FaultPlane.note_step`, with the step
count before the step it is about to take); worker threads only read it, so
firing is deterministic in step space although the workers run on their
own. ``every=K`` repeats the entry K steps after each firing; without it
the entry fires once. The other ``key=value`` pairs go to the hook site
(``secs`` of a stall, ``tenant`` of a wedge).

Kinds and their hook sites in the port:

==================  =====================================================
``scorer_die``      ``ScorerFleet._next_chunk`` and
                    ``ScorerService._score_chunk`` raise, killing the
                    worker (raised again at the trainer's next drain)
``scorer_nan``      the chunk's scores become NaN (the trainer rejects it)
``scorer_wedge``    ``ScorerService`` stops scheduling tenant ``tenant``
                    (default 0)
``prefetch_die``    ``PrefetchPipeline``'s worker raises (raised again at
                    the next ``pop``)
``prefetch_stall``  the prefetch worker sleeps ``secs`` before gathering
``sink_wedge``      the metric writer's drain thread sleeps ``secs``
``ckpt_io_error``   the checkpoint write raises ``OSError`` before it
                    opens the file
``host_slow``       ``fit`` sleeps ``secs`` on the training thread
==================  =====================================================

Every hook site tests ``if faults is not None`` on a plain attribute, so a
run without a spec pays nothing, and no hook touches the step.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional

__all__ = ["FaultPlane", "InjectedFault", "KNOWN_KINDS", "parse_fault_spec"]

#: Every injectable kind; a spec naming another is refused when parsed.
KNOWN_KINDS = frozenset({
    "scorer_die",
    "scorer_nan",
    "scorer_wedge",
    "prefetch_die",
    "prefetch_stall",
    "sink_wedge",
    "ckpt_io_error",
    "host_slow",
})


class InjectedFault(RuntimeError):
    """An injected failure: told apart from an organic one in logs, handled
    the same way by the runtime. ``event_id`` is its ``fault/fired``
    event's id (None without a journal)."""

    def __init__(self, message: str, event_id: Optional[str] = None) -> None:
        super().__init__(message)
        self.event_id = event_id


class _Entry:
    """One scheduled fault and its firing state."""

    __slots__ = ("kind", "step", "every", "args", "fired", "next_due")

    def __init__(self, kind: str, step: int, every: int,
                 args: Dict[str, float]) -> None:
        self.kind = kind
        self.step = step
        self.every = every            # 0: one-shot
        self.args = args              # the hook site's extra parameters
        self.fired = 0
        self.next_due = step

    def pending(self) -> bool:
        return self.every > 0 or self.fired == 0

    def spec(self) -> Dict[str, float]:
        out = {"step": float(self.step), **self.args}
        if self.every:
            out["every"] = float(self.every)
        return out


def parse_fault_spec(spec: str) -> List[_Entry]:
    """Parse ``kind@k=v,...;kind@...``; a malformed entry raises
    ``ValueError`` quoting it."""
    entries: List[_Entry] = []
    for raw in spec.split(";"):
        raw = raw.strip()
        if not raw:
            continue
        if "@" not in raw:
            raise ValueError(
                f"fault_spec entry {raw!r}: expected 'kind@step=N[,k=v...]'")
        kind, _, params = raw.partition("@")
        kind = kind.strip()
        if kind not in KNOWN_KINDS:
            raise ValueError(
                f"fault_spec entry {raw!r}: unknown fault kind {kind!r} "
                f"(known: {', '.join(sorted(KNOWN_KINDS))})")
        args: Dict[str, float] = {}
        for pair in params.split(","):
            pair = pair.strip()
            if not pair:
                continue
            if "=" not in pair:
                raise ValueError(
                    f"fault_spec entry {raw!r}: malformed param {pair!r} "
                    "(expected key=number)")
            key, _, val = pair.partition("=")
            try:
                args[key.strip()] = float(val)
            except ValueError:
                raise ValueError(
                    f"fault_spec entry {raw!r}: param {pair!r} is not "
                    "numeric") from None
        if "step" not in args:
            raise ValueError(
                f"fault_spec entry {raw!r}: missing the mandatory "
                "'step=N' param")
        step = int(args.pop("step"))
        every = int(args.pop("every", 0))
        entries.append(_Entry(kind, step, every, args))
    return entries


class FaultPlane:
    """The armed schedule and the step clock the hook sites fire against.

    :meth:`note_step` runs on the training thread once a step of ``fit``;
    :meth:`fire` runs there and on the worker threads (prefetch, scorer,
    metric drain). One lock guards all firing state, so an entry due once
    fires once however many workers race for it. With ``journal`` every
    firing is journaled (its ``emit`` takes only its own lock)."""

    def __init__(self, spec: str = "", journal=None) -> None:
        self._entries = parse_fault_spec(spec)
        self._lock = threading.Lock()
        self._step = 0
        self._fired_total = 0
        self._journal = journal
        self._local = threading.local()   # .event: the thread's last firing's id

    def note_step(self, step: int) -> None:
        """Advance the clock (training thread, once a step)."""
        with self._lock:
            self._step = int(step)

    def fire(self, kind: str) -> Optional[Dict[str, float]]:
        """Consume the next due entry of ``kind`` at the clock's step.

        Returns the entry's extra parameters (perhaps empty, still ``is not
        None``) when one is due, else None. A one-shot entry fires once;
        ``every=K`` re-arms K steps after each firing."""
        with self._lock:
            step = self._step
            for entry in self._entries:
                if entry.kind != kind or not entry.pending():
                    continue
                if step < entry.next_due:
                    continue
                entry.fired += 1
                if entry.every:
                    entry.next_due = step + entry.every
                self._fired_total += 1
                self._local.event = None
                if self._journal is not None:
                    try:
                        self._local.event = self._journal.emit(
                            "fault/fired", step,
                            detail={"fault": entry.kind, "fired": entry.fired,
                                    "args": dict(entry.args)})
                    except Exception:
                        pass  # the plane fires even when the journal fails
                return dict(entry.args)
        return None

    def injected(self, message: str) -> InjectedFault:
        """The :class:`InjectedFault` of the calling thread's latest
        firing, with its journal id (None without a journal): what a hook
        site that raises names as the cause."""
        return InjectedFault(message, getattr(self._local, "event", None))

    def stats(self) -> Dict[str, float]:
        """``fault/injected`` and ``fault/armed`` for a log record."""
        with self._lock:
            armed = sum(1 for e in self._entries if e.pending())
            return {
                "fault/injected": float(self._fired_total),
                "fault/armed": float(armed),
            }

    def summary(self) -> Dict[str, object]:
        """The clock, the firings so far and every entry's state."""
        with self._lock:
            return {
                "step": self._step,
                "fired_total": self._fired_total,
                "entries": [
                    {"kind": e.kind, "fired": e.fired,
                     "pending": e.pending(), **e.spec()}
                    for e in self._entries
                ],
            }
