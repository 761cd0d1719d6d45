"""Observability of the port, the PyTorch counterpart of
``mercury_tpu/obs/``:

1. :mod:`.diagnostics` and :mod:`.sampler_health`: the step's
   sampler-health scalars and histograms, and the host-side ledger monitor.
2. :mod:`.writer`: the async metric writer and its sinks (``metrics.jsonl``,
   the ranks' ``metrics.h{r}.jsonl`` shards, heartbeats, TensorBoard).
3. :mod:`.manifest` and :mod:`.accounting`: the run manifest; steps/s,
   FLOPs and MFU.
4. :mod:`.trace` and :mod:`.anomaly`: the host span tracer (Chrome trace,
   Perfetto) and the anomaly engine with its flight recorder.
5. :mod:`.events` and :mod:`.serve`: the event journal and the
   ``/healthz`` ``/statusz`` ``/metricsz`` status server.
6. :mod:`.aggregate`, :mod:`.profile_parse` and :mod:`.report`: cross-rank
   aggregation (``host/*``, the straggler ratio), the device-time
   attribution of profiler captures, and the run report and regression diff
   (``python -m mercury_tpu_torch.obs.report``).

Imports here are lazy (PEP 562): :mod:`.report`, :mod:`.profile_parse`,
:mod:`.trace`, :mod:`.serve` and :mod:`.events` are standard library only
and run where torch is not installed, so importing this package loads no
submodule; ``from mercury_tpu_torch.obs import SpanTracer`` loads its own
on first use.
"""

import importlib

_LAZY_ATTRS = {
    "FLIGHT_RECORD_SCHEMA": "anomaly",
    "AnomalyEngine": "anomaly",
    "device_memory_stats": "anomaly",
    "NULL_TRACER": "trace",
    "NullTracer": "trace",
    "SpanTracer": "trace",
    "journal_lane_events": "trace",
    "merge_events_into_trace": "trace",
    "EVENT_KINDS": "events",
    "EVENT_SCHEMA": "events",
    "EventJournal": "events",
    "journal_filename": "events",
    "load_events": "events",
    "parent_chain": "events",
    "read_journal": "events",
    "validate_event": "events",
    "OPENMETRICS_CONTENT_TYPE": "serve",
    "StatusServer": "serve",
    "metric_name": "serve",
    "parse_openmetrics": "serve",
    "render_openmetrics": "serve",
    "PEAK_FLOPS": "accounting",
    "ThroughputMeter": "accounting",
    "flops_per_step": "accounting",
    "peak_flops": "accounting",
    "build_run_manifest": "manifest",
    "git_revision": "manifest",
    "write_run_manifest": "manifest",
    "AsyncMetricWriter": "writer",
    "HeartbeatSink": "writer",
    "HeartbeatShardSink": "writer",
    "JsonlSink": "writer",
    "TensorBoardSink": "writer",
    "try_tensorboard_sink": "writer",
    "CrossHostGatherAggregator": "aggregate",
    "HostShardAggregator": "aggregate",
    "StragglerWindow": "aggregate",
    "merge_host_stats": "aggregate",
    "BREAKDOWN_SCHEMA": "profile_parse",
    "attribute_device_time": "profile_parse",
    "parse_profile": "profile_parse",
    "scope_frac_metrics": "profile_parse",
    "write_breakdown": "profile_parse",
    "diff_runs": "report",
    "load_run": "report",
    "render_html": "report",
    "render_markdown": "report",
}

__all__ = sorted(_LAZY_ATTRS)


def __getattr__(name: str):
    module = _LAZY_ATTRS.get(name)
    if module is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    value = getattr(importlib.import_module(f"{__name__}.{module}"), name)
    globals()[name] = value  # cached: the next access skips __getattr__
    return value


def __dir__():
    return sorted(set(globals()) | set(__all__))
