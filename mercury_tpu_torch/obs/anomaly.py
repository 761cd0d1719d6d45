"""The anomaly engine and its flight recorder — the port's own copy of
``mercury_tpu/obs/anomaly.py``.

A ring of the last logged records (host floats, kept on the metric
writer's drain thread at no cost to the training thread), dumped as one
``flight_record_*.json`` when a trigger fires:

- **non_finite**: ``train/loss`` or ``train/grad_norm`` is NaN or infinite;
- **slow_step**: a step took over ``slow_step_factor`` × the rolling median
  step time (fed by ``fit`` each step; armed after 16 samples, so the
  kernel build and cuDNN's first calls do not fire it);
- **ess_collapse**: ``sampler/ess`` below its floor;
- **stall_breach**: the host stream's stall share of a log interval above
  its budget;
- **mfu_floor**: ``perf/mfu`` below its floor (0.0 means the card's peak is
  unknown: no breach);
- **straggler**: ``host/straggler_ratio`` above its factor; the cross-rank
  aggregator (``obs/aggregate.py``, ``crosshost_telemetry``) attaches that
  key at W > 1, before this engine sees the record;
- **selection_collapse**: ``sampler_dist/gini`` above its ceiling, the
  histograms attached;
- **class_starvation**: ``sampler_dist/class_starved`` at or above its
  threshold;
- **is_losing**: ``sampler_dist/var_ratio`` >= 1 for ``var_ratio_patience``
  logged probes in a row (the off-cadence −1.0 neither counts nor resets).

A dump holds the ring, the step times, the trigger counts, the run's
context (``context_fn``: the config, the manifest, the pipeline's,
scorer's, supervisor's and fault plane's summaries) and each local card's
allocator statistics (:func:`device_memory_stats`) and ``spans``, the
tracer's ring (``obs/trace.py``; empty with the disabled tracer). Each
trigger also marks an ``anomaly/<kind>`` instant on the tracer. With ``profile_steps > 0`` a trigger also
asks ``fit`` for a ``torch.profiler`` window of that many steps
(:meth:`AnomalyEngine.take_profile_request`). Dumps are debounced
(``cooldown_steps`` between them, ``max_dumps`` a run); every trigger,
debounced or not, counts into ``anomaly/triggers`` on the records that
follow and, with a journal, is journaled. Without a dump directory the
engine still detects and counts.
"""

from __future__ import annotations

import json
import math
import os
import statistics
import threading
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional

from mercury_tpu_torch.utils.logging import get_logger

_log = get_logger(__name__)

#: Schema tag of ``flight_record_*.json``.
FLIGHT_RECORD_SCHEMA = "mercury_flight_record_v1"


def device_memory_stats() -> Dict[str, Dict[str, int]]:
    """``torch.cuda.memory_stats`` of each local card, keyed ``cuda:<i>``
    (numbers only); ``{}`` without CUDA. Never raises."""
    out: Dict[str, Dict[str, int]] = {}
    try:
        import torch

        if not torch.cuda.is_available():
            return out
        for i in range(torch.cuda.device_count()):
            try:
                stats = torch.cuda.memory_stats(i)
            except Exception:
                stats = None
            if stats:
                out[f"cuda:{i}"] = {k: int(v) for k, v in stats.items()
                                    if isinstance(v, (int, float))}
    except Exception:
        pass
    return out


def _sampler_histograms(record: Dict[str, float]) -> Dict[str, float]:
    """The record's sampler histogram bins, attached to a sampler-health
    dump."""
    return {k: record[k] for k in sorted(record)
            if k.startswith("sampler_dist/score_hist/") or k.startswith("sampler_dist/w_hist/")}


class AnomalyEngine:
    """The triggers and the dumps. :meth:`observe_step_time` runs on the
    training thread once a step (a few float operations);
    :meth:`observe_record` runs on the drain thread once a logged record,
    as a writer observer. ``context_fn`` is called only when a dump is
    written."""

    #: Step times needed before slow_step arms.
    MIN_STEP_SAMPLES = 16

    def __init__(self, *, ring_steps: int = 64, slow_step_factor: float = 3.0,
                 ess_floor: float = 0.0, stall_frac_max: float = 0.0,
                 mfu_floor: float = 0.0, straggler_factor: float = 0.0,
                 gini_max: float = 0.0, starved_classes: float = 0.0,
                 var_ratio_patience: int = 0, cooldown_steps: int = 200,
                 max_dumps: int = 8, dump_dir: Optional[str] = None,
                 context_fn: Optional[Callable[[], Dict[str, Any]]] = None,
                 profile_steps: int = 0, journal=None, tracer=None) -> None:
        if ring_steps < 1:
            raise ValueError(f"ring_steps must be >= 1, got {ring_steps}")
        self.ring: deque = deque(maxlen=int(ring_steps))
        self.slow_step_factor = float(slow_step_factor)
        self.ess_floor = float(ess_floor)
        self.stall_frac_max = float(stall_frac_max)
        self.mfu_floor = float(mfu_floor)
        self.straggler_factor = float(straggler_factor)
        self.gini_max = float(gini_max)
        self.starved_classes = float(starved_classes)
        self.var_ratio_patience = int(var_ratio_patience)
        self.cooldown_steps = int(cooldown_steps)
        self.max_dumps = int(max_dumps)
        self.dump_dir = dump_dir
        self.context_fn = context_fn
        self.profile_steps = int(profile_steps)
        self.journal = journal
        self.tracer = tracer

        self.triggers = 0
        self.trigger_counts: Dict[str, int] = {}
        self.dumps: List[str] = []
        self._last_trigger_step: Optional[int] = None
        self._lock = threading.Lock()
        # slow_step (training thread only).
        self._step_times: deque = deque(maxlen=128)
        self._median_s: Optional[float] = None
        self._since_median = 0
        # stall_breach (drain thread only).
        self._prev_record_time: Optional[float] = None
        # is_losing (drain thread only): logged probes in a row at >= 1.
        self._var_ratio_breaches = 0
        # The profiler window a trigger asked for (set under the lock).
        self._profile_pending = 0

    # ----------------------------------------------------- training thread
    def observe_step_time(self, step: int, dt_s: float, steps: int = 1) -> None:
        """One iteration's wall time (``steps`` > 1: its mean a step)."""
        per_step = dt_s / max(int(steps), 1)
        self._step_times.append(per_step)
        self._since_median += 1
        # The median is refreshed every 16 samples, or while unknown.
        if self._median_s is None or self._since_median >= 16:
            if len(self._step_times) >= self.MIN_STEP_SAMPLES:
                self._median_s = statistics.median(self._step_times)
            self._since_median = 0
        if (self.slow_step_factor > 0 and self._median_s is not None
                and len(self._step_times) >= self.MIN_STEP_SAMPLES
                and per_step > self.slow_step_factor * self._median_s):
            self._trigger("slow_step", step,
                          {"step_time_s": per_step, "rolling_median_s": self._median_s,
                           "factor": per_step / max(self._median_s, 1e-12)})

    def take_profile_request(self) -> int:
        """The profiler window's steps the latest trigger asked for, once
        (polled by ``fit`` each step; the first read skips the lock)."""
        if not self._profile_pending:
            return 0
        with self._lock:
            n, self._profile_pending = self._profile_pending, 0
        return n

    # ------------------------------------------------------- drain thread
    def observe_record(self, record: Dict[str, float]) -> None:
        """Ring a host record and check the triggers over it; once any has
        fired, set ``record["anomaly/triggers"]`` (the sinks see it)."""
        step = int(record.get("step", -1))
        self.ring.append(dict(record))

        for key in ("train/loss", "train/grad_norm"):
            v = record.get(key)
            if v is not None and not math.isfinite(v):
                self._trigger("non_finite", step, {"key": key, "value": v})
                break

        ess = record.get("sampler/ess")
        if self.ess_floor > 0 and ess is not None and ess < self.ess_floor:
            self._trigger("ess_collapse", step, {"ess": ess, "floor": self.ess_floor})

        stall = record.get("data/stall_s")
        now = record.get("time")
        if stall is not None and now is not None:
            prev = self._prev_record_time
            self._prev_record_time = now
            if self.stall_frac_max > 0 and prev is not None and now > prev:
                frac = stall / (now - prev)
                if frac > self.stall_frac_max:
                    self._trigger("stall_breach", step,
                                  {"stall_frac": frac, "budget": self.stall_frac_max})

        mfu = record.get("perf/mfu")
        if self.mfu_floor > 0 and mfu and mfu < self.mfu_floor:
            self._trigger("mfu_floor", step, {"mfu": mfu, "floor": self.mfu_floor})

        ratio = record.get("host/straggler_ratio")
        if self.straggler_factor > 0 and ratio is not None and ratio > self.straggler_factor:
            detail: Dict[str, Any] = {"ratio": ratio, "factor": self.straggler_factor}
            for key in ("host/min/step_time_s", "host/max/step_time_s",
                        "host/spread/step_time_s", "host/reporting"):
                if key in record:
                    detail[key] = record[key]
            self._trigger("straggler", step, detail)

        gini = record.get("sampler_dist/gini")
        if self.gini_max > 0 and gini is not None and gini > self.gini_max:
            detail = {"gini": gini, "ceiling": self.gini_max}
            cov = record.get("sampler_dist/frac_never_selected")
            if cov is not None:
                detail["frac_never_selected"] = cov
            detail.update(_sampler_histograms(record))
            self._trigger("selection_collapse", step, detail)

        starved = record.get("sampler_dist/class_starved")
        if (self.starved_classes > 0 and starved is not None
                and starved >= self.starved_classes):
            detail = {"class_starved": starved, "threshold": self.starved_classes}
            for key in ("sampler_dist/class_share_min", "sampler_dist/class_share_max"):
                if key in record:
                    detail[key] = record[key]
            detail.update(_sampler_histograms(record))
            self._trigger("class_starvation", step, detail)

        ratio = record.get("sampler_dist/var_ratio")
        if self.var_ratio_patience > 0 and ratio is not None:
            if ratio >= 1.0:
                self._var_ratio_breaches += 1
                if self._var_ratio_breaches >= self.var_ratio_patience:
                    detail = {"var_ratio": ratio,
                              "consecutive_breaches": self._var_ratio_breaches,
                              "patience": self.var_ratio_patience}
                    detail.update(_sampler_histograms(record))
                    self._var_ratio_breaches = 0
                    self._trigger("is_losing", step, detail)
            elif ratio >= 0.0:
                self._var_ratio_breaches = 0

        with self._lock:
            triggers = self.triggers
        if triggers:
            record["anomaly/triggers"] = float(triggers)

    # ----------------------------------------------------------- triggering
    def _trigger(self, kind: str, step: int, detail: Dict[str, Any]) -> None:
        with self._lock:
            self.triggers += 1
            self.trigger_counts[kind] = self.trigger_counts.get(kind, 0) + 1
            last = self._last_trigger_step
            debounced = ((last is not None and step >= 0
                          and step - last < self.cooldown_steps)
                         or len(self.dumps) >= self.max_dumps)
            if not debounced:
                self._last_trigger_step = step
                if self.profile_steps > 0:
                    self._profile_pending = self.profile_steps
        _log.warning("anomaly trigger %s at step %d: %s", kind, step, detail)
        if self.tracer is not None:
            self.tracer.instant(f"anomaly/{kind}", cat="anomaly", step=step)
        path = None
        if not debounced:
            path = self.dump_flight_record(kind, step, detail)
            if path:
                _log.warning("flight record written: %s", path)
        if self.journal is not None:
            try:
                # A debounced trigger is journaled too: "fired, suppressed"
                # is a decision.
                self.journal.emit("anomaly/triggered", step,
                                  detail={"trigger": kind, "debounced": bool(debounced),
                                          "flight_record": path})
            except Exception:
                pass

    def dump_flight_record(self, kind: str, step: int,
                           detail: Optional[Dict[str, Any]] = None) -> Optional[str]:
        """Write ``flight_record_step<step>_<kind>.json``; return its path,
        or None without a dump directory. Never raises."""
        if not self.dump_dir:
            return None
        try:
            with self._lock:
                trigger_counts = dict(self.trigger_counts)
                triggers_total = self.triggers
            doc: Dict[str, Any] = {
                "schema": FLIGHT_RECORD_SCHEMA,
                "timestamp": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
                "trigger": {"kind": kind, "step": int(step), "detail": detail or {}},
                "trigger_counts": trigger_counts,
                "triggers_total": triggers_total,
                "ring": list(self.ring),
                "spans": self.tracer.snapshot() if self.tracer is not None else [],
                "step_time_window_s": [round(t, 6) for t in self._step_times],
                "rolling_median_step_s": self._median_s,
                "device_memory": device_memory_stats(),
            }
            if self.context_fn is not None:
                try:
                    doc.update(self.context_fn())
                except Exception as exc:
                    doc["context_error"] = f"{type(exc).__name__}: {exc}"
            os.makedirs(self.dump_dir, exist_ok=True)
            path = os.path.join(self.dump_dir, f"flight_record_step{max(step, 0)}_{kind}.json")
            tmp = path + ".tmp"
            with open(tmp, "w") as f:
                json.dump(doc, f, indent=2, default=str)
                f.write("\n")
            os.replace(tmp, path)
            with self._lock:
                self.dumps.append(path)
            return path
        except Exception as exc:
            _log.warning("flight-record dump failed: %s: %s", type(exc).__name__, exc)
            return None
