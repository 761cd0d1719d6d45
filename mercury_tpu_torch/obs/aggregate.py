"""Cross-rank telemetry aggregation: merge the ranks' metric shards — the
port's own copy of ``mercury_tpu/obs/aggregate.py``.

Every rank writes its own ``metrics.h{rank}.jsonl`` shard
(``obs/writer.py``). This module turns those back into one cross-rank view
on rank 0, as ``host/{min,max,spread}/*`` and ``host/straggler_ratio`` on
its records (the JAX package's "hosts" are the port's ranks: one process
each):

- :class:`HostShardAggregator` (``crosshost_telemetry="files"``): a writer
  observer on rank 0, so it rides the drain thread. Each time rank 0 logs
  a record it tails every shard from where it stopped, takes each rank's
  latest ``time/step``, ``data/stall_s`` and ``data/queue_depth`` and adds
  the merged keys to the record in flight. No collective: a wedged rank's
  shard just stops advancing.
- :class:`CrossHostGatherAggregator` (``"allgather"``): for ranks that
  share no file system, an all-gather at the log tick, on every rank (the
  tick is the same step on every rank). It gathers a vector of fixed width,
  one float32 a source key (the JAX gather's dtype) with NaN for a key the
  rank's record lacks, so
  every rank sends the same shape whatever its record holds and the gather
  cannot hang on a mismatch; NaN entries are dropped before the merge,
  which then equals the JAX package's for the same values.
- :class:`StragglerWindow`: a rolling window of step times a rank; the
  straggler signal is ``max(rank mean) / median(rank mean)``, which the
  anomaly engine holds to ``anomaly_straggler_factor``. At two ranks the
  median is the mean of the two, so the ratio stays below 2.

One difference from the JAX package: the window reads a rank's
``time/host_s`` where its records carry it (the port's Trainer logs it: the
training thread's seconds a step outside the step's dispatch), and its
``time/step`` otherwise, as the JAX aggregator always does. The port runs a
process a rank, and the step's collectives hold every rank to the slowest:
each rank's wall time a step, ``time/step``, is the same, and only the host
work a rank does apart from the step tells the rank the others wait for.
The ``host/{min,max,spread}/*`` keys are the JAX package's, from
``time/step``.

Everything but the gather (``parallel/collectives.allgather_floats``) is
standard library only.
"""

from __future__ import annotations

import json
import math
import os
import re
import statistics
from collections import deque
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from mercury_tpu_torch.utils.logging import get_logger

_log = get_logger(__name__)

#: Shard filename of one rank's metric stream (``obs/writer.shard_filename``).
SHARD_PATTERN = re.compile(r"^metrics\.h(\d+)\.jsonl$")

#: The modes of ``crosshost_telemetry``.
MODES = ("auto", "off", "files", "allgather")

#: A rank's host seconds a step outside the step's dispatch: the straggler
#: window's input where a record carries it.
HOST_TIME_KEY = "time/host_s"

#: Source key a rank -> the ``host/{min,max,spread}`` keys it merges into.
AGG_KEYS: Dict[str, Tuple[str, str, str]] = {
    "time/step": ("host/min/step_time_s", "host/max/step_time_s",
                  "host/spread/step_time_s"),
    "data/stall_s": ("host/min/stall_s", "host/max/stall_s",
                     "host/spread/stall_s"),
    "data/queue_depth": ("host/min/queue_depth", "host/max/queue_depth",
                         "host/spread/queue_depth"),
}


def resolve_mode(mode: str, world_size: int, log_dir: Optional[str]) -> str:
    """The mode a Trainer runs, as the JAX Trainer resolves it: ``"auto"``
    is ``"files"`` at more than one rank (the JAX package's process count)
    and ``"off"`` at one; ``"files"`` without a ``log_dir`` is ``"off"``.
    An unknown mode raises the JAX Trainer's ``ValueError``."""
    if mode not in MODES:
        raise ValueError(
            f"crosshost_telemetry={mode!r}: expected one of "
            "'auto', 'off', 'files', 'allgather'")
    if mode == "auto":
        mode = "files" if world_size > 1 else "off"
    if mode == "files" and not log_dir:
        mode = "off"  # file aggregation needs shards to tail
    return mode


def merge_host_stats(latest: Dict[int, Dict[str, float]]) -> Dict[str, float]:
    """Fold each rank's latest source values into the ``host/*`` metric
    dict. A rank missing a key does not contribute to it; a key no rank
    reports is left out."""
    out: Dict[str, float] = {"host/reporting": float(len(latest))}
    for src, (k_min, k_max, k_spread) in AGG_KEYS.items():
        values = [h[src] for h in latest.values() if src in h]
        if not values:
            continue
        lo, hi = min(values), max(values)
        out[k_min] = float(lo)
        out[k_max] = float(hi)
        out[k_spread] = float(hi - lo)
    return out


class StragglerWindow:
    """Rolling step-time window a rank → straggler ratio.

    ``ratio() = max(rank mean) / median(rank mean)`` over the last
    ``window`` samples of each rank. The median (not the min) is the
    denominator, so one fast outlier cannot make a straggler; it needs two
    ranks with data (0.0 otherwise: one rank never triggers)."""

    def __init__(self, window: int = 8) -> None:
        if window < 1:
            raise ValueError(f"window must be >= 1, got {window}")
        self.window = int(window)
        self._times: Dict[int, deque] = {}

    def add(self, host: int, step_time_s: float) -> None:
        if step_time_s <= 0:
            return
        q = self._times.get(host)
        if q is None:
            q = self._times[host] = deque(maxlen=self.window)
        q.append(float(step_time_s))

    def per_host_mean(self) -> Dict[int, float]:
        return {h: sum(q) / len(q) for h, q in self._times.items() if q}

    def ratio(self) -> float:
        means = self.per_host_mean()
        if len(means) < 2:
            return 0.0
        med = statistics.median(means.values())
        if med <= 0:
            return 0.0
        return max(means.values()) / med


class HostShardAggregator:
    """Tail the ranks' metric shards and attach ``host/*`` aggregates.

    A writer observer on rank 0: ``observe_record(record)`` runs on the
    drain thread once a logged record and adds to the record in place (the
    observers after it, the anomaly engine's, see the keys). Each pass
    reads only what appeared since the last (byte offsets a shard); a line
    torn by a concurrent append is read again on the next pass, and no
    failure reaches the writer (it is counted and logged)."""

    def __init__(self, log_dir: str, processes: int = 0, window: int = 8) -> None:
        self.log_dir = log_dir
        self.processes = int(processes)
        self.straggler = StragglerWindow(window=window)
        self.latest: Dict[int, Dict[str, float]] = {}
        self.errors = 0
        self._offsets: Dict[str, int] = {}
        self._partial: Dict[str, str] = {}

    def _shard_paths(self) -> List[Tuple[int, str]]:
        try:
            names = os.listdir(self.log_dir)
        except OSError:
            return []
        out = []
        for name in names:
            m = SHARD_PATTERN.match(name)
            if m:
                out.append((int(m.group(1)), os.path.join(self.log_dir, name)))
        return sorted(out)

    def _tail_shard(self, host: int, path: str) -> None:
        offset = self._offsets.get(path, 0)
        try:
            size = os.path.getsize(path)
            if size < offset:
                # The shard shrank (a rotation replaced it): start again from
                # byte 0 and drop the partial line of the old file.
                offset = 0
                self._offsets[path] = 0
                self._partial.pop(path, None)
            if size <= offset:
                return
            with open(path, "r") as f:
                f.seek(offset)
                chunk = f.read()
                self._offsets[path] = f.tell()
        except OSError:
            self.errors += 1
            return
        # A line torn by a concurrent append waits for its newline.
        chunk = self._partial.pop(path, "") + chunk
        if not chunk.endswith("\n"):
            chunk, _, rest = chunk.rpartition("\n")
            self._partial[path] = rest
            if not chunk:
                return
        for line in chunk.splitlines():
            line = line.strip()
            if not line:
                continue
            try:
                record = json.loads(line)
            except ValueError:
                self.errors += 1
                continue
            if not isinstance(record, dict):
                continue
            self.latest.setdefault(host, {}).update(
                {k: float(v) for k, v in record.items() if isinstance(v, (int, float))})
            ts = record.get(HOST_TIME_KEY, record.get("time/step"))
            if isinstance(ts, (int, float)):
                self.straggler.add(host, float(ts))

    def poll(self) -> Dict[str, float]:
        """One pass: tail every shard and return the merged ``host/*`` dict
        (empty while no shard has data)."""
        for host, path in self._shard_paths():
            self._tail_shard(host, path)
        if not self.latest:
            return {}
        merged = merge_host_stats(self.latest)
        ratio = self.straggler.ratio()
        if ratio > 0:
            merged["host/straggler_ratio"] = ratio
        return merged

    def observe_record(self, record: Dict[str, float]) -> None:
        """The writer observer (drain thread): adds to the record; never
        raises into the writer."""
        try:
            record.update(self.poll())
        except Exception as exc:  # pragma: no cover - defensive
            self.errors += 1
            _log.warning("host-shard aggregation failed: %s", exc)


def _host_value(record: Dict, key: str) -> float:
    """A source key's value a rank sends: its float, or NaN when the record
    lacks it (or holds something else)."""
    v = record.get(key)
    if isinstance(v, bool) or not isinstance(v, (int, float)):
        return math.nan
    return float(v)


class CrossHostGatherAggregator:
    """The log tick's aggregation for ``crosshost_telemetry="allgather"``.

    ``update(record)`` runs at the log tick on every rank (the gather
    needs them all); only rank 0 gets a non-empty merge back, which the
    Trainer adds to its record before enqueueing it. ``gather`` takes this
    rank's row of floats and returns every rank's, in rank order
    (``parallel/collectives.allgather_floats``), and ``rank`` is this
    rank's index. A gather that raises marks the aggregator unavailable
    (logged once; no retry of a dead collective)."""

    _SOURCES = ("time/step", "data/stall_s", "data/queue_depth", HOST_TIME_KEY)

    def __init__(self, window: int = 8, *,
                 gather: Callable[[Sequence[float]], List[List[float]]],
                 rank: int = 0) -> None:
        self.straggler = StragglerWindow(window=window)
        self.unavailable = False
        self._gather = gather
        self._rank = int(rank)

    def update(self, record: Dict) -> Dict[str, float]:
        if self.unavailable:
            return {}
        row = [_host_value(record, k) for k in self._SOURCES]
        if math.isnan(row[0]):
            row[0] = 0.0  # the JAX aggregator's setdefault("time/step", 0.0)
        try:
            rows = self._gather(row)
        except Exception as exc:
            _log.warning("crosshost allgather unavailable: %s", exc)
            self.unavailable = True
            return {}
        if self._rank != 0:
            return {}
        per_host = {p: {k: v for k, v in zip(self._SOURCES, vals) if not math.isnan(v)}
                    for p, vals in enumerate(rows)}
        for host, vals in per_host.items():
            ts = vals.get(HOST_TIME_KEY, vals.get("time/step", 0.0))
            if ts > 0:
                self.straggler.add(host, ts)
        merged = merge_host_stats(per_host)
        ratio = self.straggler.ratio()
        if ratio > 0:
            merged["host/straggler_ratio"] = ratio
        return merged
