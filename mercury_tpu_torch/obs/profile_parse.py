"""Offline device-time attribution of profiler captures — the port's own
copy of ``mercury_tpu/obs/profile_parse.py`` (standard library only), with
``torch.profiler``'s Chrome traces added.

It parses a capture (Chrome-trace JSON, gzipped or not, or a raw
``*.xplane.pb`` through a minimal wire-format reader), buckets the device
time by the step's named scopes (``mercury_scoring``,
``mercury_grad_sync``, ``mercury_augmentation``, ``mercury_input_fuse``,
``mercury_optimizer``) and emits ``device_time_breakdown.json``:

- the device-time fraction of each scope (every unmatched event lands in
  an explicit ``unattributed`` bucket: no time is dropped, so
  ``attributed_frac`` is 1.0);
- the H2D overlap fraction: how much of the copy time is hidden under
  device compute;
- idle gaps: the device lanes' span minus their busy time.

Two kinds of capture:

- **XLA** (the JAX package's captures, and the same fixture files): the
  events of the device lanes' op lane, each matched by the scope names in
  its name and arguments, exactly as the JAX module does.
- **torch.profiler** (the port's anomaly-armed window,
  ``profile/trace_step<N>.json``): a device's lanes are its streams. The
  kernels (``cat: kernel``) and memsets are the compute, the copies
  (``gpu_memcpy``) the H2D set. The step's ``record_function`` scopes are
  ``user_annotation`` ranges on the launching thread, and a kernel's
  ``correlation`` names the runtime call that launched it: the kernel goes
  to the scope whose range on that thread contains the launch (the first
  of :data:`SCOPES` when ranges nest); a kernel whose launch the window
  did not record is ``unattributed``. The trace also projects ranges onto
  the card as ``gpu_user_annotation``, but only the innermost annotation
  of a kernel (one of ``Optimizer.step#Adam.step`` inside
  ``mercury_optimizer`` shows the former), so those are not used. No range
  is device time: counting them would count each microsecond twice.

The Trainer folds the result into the metric stream as
``prof/scope_frac/*`` after a capture window closes. The CLI:

    python -m mercury_tpu_torch.obs.profile_parse CAPTURE \\
        --out device_time_breakdown.json

where CAPTURE is a trace file or a profile directory (the newest capture
inside is found).
"""

from __future__ import annotations

import bisect
import glob
import gzip
import json
import os
import sys
from typing import Any, Dict, Iterable, Iterator, List, Optional, Tuple

#: Schema tag for ``device_time_breakdown.json``; bump on shape changes.
BREAKDOWN_SCHEMA = "mercury_device_time_breakdown_v1"

#: Scope buckets, in match priority order — the named-scope anchors the
#: step factories emit (lint/audit.py::SCOPES plus the augmentation and
#: optimizer scopes). First substring hit wins, so a nested
#: ``mercury_scoring/mercury_augmentation`` event attributes to the
#: outer anchor listed first.
SCOPES: Tuple[str, ...] = (
    "mercury_scoring",
    "mercury_grad_sync",
    "mercury_augmentation",
    "mercury_input_fuse",
    "mercury_optimizer",
)

#: The explicit catch-all bucket: device-lane time that matched no scope
#: is still counted, never dropped.
UNATTRIBUTED = "unattributed"

#: Breakdown bucket -> metric key (pure literals: graftlint Layer M
#: checks emitted keys against the registry by AST, and f-string-built
#: keys would be invisible to it).
_SCOPE_METRIC_KEYS: Dict[str, str] = {
    "mercury_scoring": "prof/scope_frac/mercury_scoring",
    "mercury_grad_sync": "prof/scope_frac/mercury_grad_sync",
    "mercury_augmentation": "prof/scope_frac/mercury_augmentation",
    "mercury_input_fuse": "prof/scope_frac/mercury_input_fuse",
    "mercury_optimizer": "prof/scope_frac/mercury_optimizer",
    UNATTRIBUTED: "prof/scope_frac/unattributed",
}

_H2D_MARKERS = ("memcpy", "infeed", "h2d", "hosttodevice", "transfer")

#: ``torch.profiler``'s categories: the kernels and memsets (compute), the
#: copies, the ``record_function`` ranges on the host and projected onto
#: each stream (which marks a trace as torch's), and the runtime calls that
#: launch kernels.
TORCH_COMPUTE_CATS = ("kernel", "gpu_memset")
TORCH_COPY_CAT = "gpu_memcpy"
TORCH_ANNOTATION_CAT = "gpu_user_annotation"
TORCH_HOST_ANNOTATION_CAT = "user_annotation"
TORCH_LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


# --------------------------------------------------------------- loading
def _read_maybe_gz(path: str) -> bytes:
    with open(path, "rb") as f:
        data = f.read()
    if data[:2] == b"\x1f\x8b":
        data = gzip.decompress(data)
    return data


def load_chrome_events(path: str) -> List[dict]:
    """Raw Chrome trace events from ``path`` (``.json`` / ``.json.gz``;
    either the ``{"traceEvents": [...]}`` envelope or a bare list)."""
    doc = json.loads(_read_maybe_gz(path).decode("utf-8"))
    if isinstance(doc, dict):
        events = doc.get("traceEvents", [])
    else:
        events = doc
    return [e for e in events if isinstance(e, dict)]


# ------------------------------------------------- xplane.pb wire reader
# A minimal protobuf wire-format walker — enough of
# tsl/profiler/protobuf/xplane.proto to pull (plane name, line name,
# event name, timestamp, duration) out of a raw capture without any
# protobuf runtime. Field numbers are stable public API of the profiler.
def _varint(buf: memoryview, pos: int) -> Tuple[int, int]:
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7
        if shift > 70:
            raise ValueError("malformed varint")


def _wire_fields(buf: memoryview) -> Iterator[Tuple[int, int, Any]]:
    """Yield ``(field_number, wire_type, value)``; length-delimited
    values come back as memoryviews, scalars as ints."""
    pos = 0
    end = len(buf)
    while pos < end:
        key, pos = _varint(buf, pos)
        field, wtype = key >> 3, key & 0x7
        if wtype == 0:  # varint
            value, pos = _varint(buf, pos)
        elif wtype == 1:  # fixed64
            value = int.from_bytes(buf[pos:pos + 8], "little")
            pos += 8
        elif wtype == 2:  # length-delimited
            length, pos = _varint(buf, pos)
            value = buf[pos:pos + length]
            pos += length
        elif wtype == 5:  # fixed32
            value = int.from_bytes(buf[pos:pos + 4], "little")
            pos += 4
        else:
            raise ValueError(f"unsupported wire type {wtype}")
        yield field, wtype, value


def _decode_xevent(buf: memoryview) -> Dict[str, int]:
    ev = {"metadata_id": 0, "offset_ps": 0, "duration_ps": 0}
    for field, _, value in _wire_fields(buf):
        if field == 1:
            ev["metadata_id"] = int(value)
        elif field == 2:
            ev["offset_ps"] = int(value)
        elif field == 3:
            ev["duration_ps"] = int(value)
    return ev


def _decode_xline(buf: memoryview) -> Dict[str, Any]:
    line: Dict[str, Any] = {"name": "", "timestamp_ns": 0, "events": []}
    for field, _, value in _wire_fields(buf):
        if field == 2:
            line["name"] = bytes(value).decode("utf-8", "replace")
        elif field == 3:
            line["timestamp_ns"] = int(value)
        elif field == 4:
            line["events"].append(_decode_xevent(value))
        elif field == 11 and not line["name"]:
            line["name"] = bytes(value).decode("utf-8", "replace")
    return line


def _decode_metadata_entry(buf: memoryview) -> Tuple[int, str]:
    """One ``map<int64, XEventMetadata>`` entry -> ``(id, name)``."""
    key = 0
    name = ""
    for field, _, value in _wire_fields(buf):
        if field == 1:
            key = int(value)
        elif field == 2:
            for f2, _, v2 in _wire_fields(value):
                if f2 == 2:
                    name = bytes(v2).decode("utf-8", "replace")
    return key, name


def _decode_xplane(buf: memoryview) -> Dict[str, Any]:
    plane: Dict[str, Any] = {"name": "", "lines": [], "event_names": {}}
    for field, _, value in _wire_fields(buf):
        if field == 2:
            plane["name"] = bytes(value).decode("utf-8", "replace")
        elif field == 3:
            plane["lines"].append(_decode_xline(value))
        elif field == 4:
            k, name = _decode_metadata_entry(value)
            plane["event_names"][k] = name
    return plane


def load_xplane_events(path: str) -> List[dict]:
    """Normalized events (Chrome-shaped dicts) from a raw
    ``*.xplane.pb`` capture."""
    buf = memoryview(_read_maybe_gz(path))
    events: List[dict] = []
    pid = 0
    for field, _, value in _wire_fields(buf):
        if field != 1:  # XSpace.planes
            continue
        plane = _decode_xplane(value)
        pid += 1
        tid = 0
        for line in plane["lines"]:
            tid += 1
            t0_us = line["timestamp_ns"] / 1e3
            for ev in line["events"]:
                name = plane["event_names"].get(ev["metadata_id"], "")
                events.append({
                    "ph": "X",
                    "name": name,
                    "ts": t0_us + ev["offset_ps"] / 1e6,
                    "dur": ev["duration_ps"] / 1e6,
                    "pid": pid,
                    "tid": tid,
                    "_pname": plane["name"],
                    "_tname": line["name"],
                })
    return events


# ----------------------------------------------------------- discovery
#: The JAX package's names, and the port's profiler window's
#: ``trace_step<N>.json`` (``train/profile.py``).
_CHROME_PATTERNS = ("*.trace.json.gz", "*.trace.json", "trace.json",
                    "trace.json.gz", "trace_step*.json")
_XPLANE_PATTERNS = ("*.xplane.pb",)


def discover_capture_files(root: str) -> List[str]:
    """Capture files under a profile directory, newest capture first.
    Chrome traces win over xplane when both exist (same data, cheaper
    parse); multiple same-format files (one per host) all return."""
    for patterns in (_CHROME_PATTERNS, _XPLANE_PATTERNS):
        found: List[str] = []
        for pat in patterns:
            found.extend(glob.glob(os.path.join(root, "**", pat),
                                   recursive=True))
        if found:
            found = sorted(set(found), key=os.path.getmtime, reverse=True)
            newest_dir = os.path.dirname(found[0])
            return sorted(f for f in found
                          if os.path.dirname(f) == newest_dir)
    return []


def load_events(path: str) -> Tuple[List[dict], str]:
    """Events + the resolved source description for ``path`` (a capture
    file or a directory to search)."""
    if os.path.isdir(path):
        files = discover_capture_files(path)
        if not files:
            raise FileNotFoundError(
                f"no trace capture (*.trace.json[.gz] or *.xplane.pb) "
                f"under {path}")
    else:
        files = [path]
    events: List[dict] = []
    for f in files:
        if f.endswith(".xplane.pb"):
            events.extend(load_xplane_events(f))
        else:
            events.extend(load_chrome_events(f))
    return events, ";".join(files)


# --------------------------------------------------------- normalization
def _lane_names(events: Iterable[dict]) -> Tuple[Dict[int, str],
                                                 Dict[Tuple[int, int], str]]:
    """``pid -> process_name`` and ``(pid, tid) -> thread_name`` from
    Chrome metadata events (xplane-normalized events carry their names
    inline instead)."""
    pnames: Dict[int, str] = {}
    tnames: Dict[Tuple[int, int], str] = {}
    for e in events:
        if e.get("ph") == "M":
            name = (e.get("args") or {}).get("name", "")
            if e.get("name") == "process_name":
                pnames[e.get("pid", 0)] = name
            elif e.get("name") == "thread_name":
                tnames[(e.get("pid", 0), e.get("tid", 0))] = name
    return pnames, tnames


def _is_device_lane(pname: str) -> bool:
    low = pname.lower()
    return ("/device:" in low or low.startswith("tpu")
            or low.startswith("gpu"))


def _merged_busy(intervals: List[Tuple[float, float]]) -> float:
    """Total covered time of possibly-overlapping ``(start, end)``."""
    if not intervals:
        return 0.0
    intervals = sorted(intervals)
    total = 0.0
    cur_s, cur_e = intervals[0]
    for s, e in intervals[1:]:
        if s > cur_e:
            total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    return total + (cur_e - cur_s)


def _overlap(a: List[Tuple[float, float]],
             b: List[Tuple[float, float]]) -> float:
    """Total time where interval sets ``a`` and ``b`` overlap."""
    a, b = sorted(a), sorted(b)
    i = j = 0
    total = 0.0
    while i < len(a) and j < len(b):
        s = max(a[i][0], b[j][0])
        e = min(a[i][1], b[j][1])
        if e > s:
            total += e - s
        if a[i][1] <= b[j][1]:
            i += 1
        else:
            j += 1
    return total


def _searchable_text(event: dict) -> str:
    parts = [str(event.get("name", ""))]
    args = event.get("args")
    if isinstance(args, dict):
        parts.extend(str(v) for v in args.values()
                     if isinstance(v, (str, int)))
    return " ".join(parts).lower()


# ----------------------------------------------------------- attribution
def attribute_device_time(events: List[dict],
                          scopes: Tuple[str, ...] = SCOPES
                          ) -> Dict[str, Any]:
    """Bucket device-lane time by named scope; every microsecond of
    device-lane busy time lands in a scope bucket or ``unattributed``
    (the accounting identity ``attributed_frac == 1.0`` is part of the
    contract — tests pin it). A ``torch.profiler`` capture goes to
    :func:`attribute_torch_device_time`."""
    if is_torch_capture(events):
        return attribute_torch_device_time(events, scopes)
    pnames, tnames = _lane_names(events)

    complete = [e for e in events if e.get("ph") == "X"
                and float(e.get("dur", 0)) > 0]
    for e in complete:  # xplane events carry names inline
        e.setdefault("_pname", pnames.get(e.get("pid", 0), ""))
        e.setdefault("_tname", tnames.get(
            (e.get("pid", 0), e.get("tid", 0)), ""))

    device = [e for e in complete if _is_device_lane(e["_pname"])]

    def _is_h2d(e: dict) -> bool:
        text = (e["_tname"] + " " + str(e.get("name", ""))).lower()
        return any(m in text for m in _H2D_MARKERS)

    h2d = [e for e in complete if _is_h2d(e)]
    h2d_ids = {id(e) for e in h2d}
    device_compute = [e for e in device if id(e) not in h2d_ids]

    # The op-level lane ("XLA Ops" in both jax and TF exports) is the
    # attribution target; step/module container lanes would double-count
    # every nanosecond. When no lane is tagged, fall back to the busiest
    # single lane — deterministic, and honest about granularity.
    op_lanes = [e for e in device_compute if "xla ops" in e["_tname"].lower()]
    if op_lanes:
        compute = op_lanes
        lane_note = "xla_ops"
    elif device_compute:
        by_lane: Dict[Tuple[int, int], float] = {}
        for e in device_compute:
            key = (e.get("pid", 0), e.get("tid", 0))
            by_lane[key] = by_lane.get(key, 0.0) + float(e["dur"])
        busiest = max(by_lane, key=lambda k: by_lane[k])
        compute = [e for e in device_compute
                   if (e.get("pid", 0), e.get("tid", 0)) == busiest]
        lane_note = "busiest_device_lane"
    else:
        compute = []
        lane_note = "none"

    bucket_us: Dict[str, float] = {s: 0.0 for s in scopes}
    bucket_us[UNATTRIBUTED] = 0.0
    for e in compute:
        text = _searchable_text(e)
        for scope in scopes:
            if scope in text:
                bucket_us[scope] += float(e["dur"])
                break
        else:
            bucket_us[UNATTRIBUTED] += float(e["dur"])

    total_us = sum(float(e["dur"]) for e in compute)
    attributed_us = sum(bucket_us.values())

    compute_iv = [(float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                  for e in compute]
    h2d_iv = [(float(e["ts"]), float(e["ts"]) + float(e["dur"]))
              for e in h2d]
    h2d_total = _merged_busy(h2d_iv)
    h2d_overlap = _overlap(compute_iv, h2d_iv)

    busy_us = _merged_busy(compute_iv)
    span_us = ((max(e[1] for e in compute_iv)
                - min(e[0] for e in compute_iv)) if compute_iv else 0.0)
    idle_us = max(span_us - busy_us, 0.0)

    return {
        "schema": BREAKDOWN_SCHEMA,
        "scopes": {
            name: {"time_us": round(us, 3),
                   "frac": (us / total_us if total_us else 0.0)}
            for name, us in bucket_us.items()
        },
        "total_device_time_us": round(total_us, 3),
        "attributed_frac": (attributed_us / total_us if total_us else 0.0),
        "h2d": {
            "total_us": round(h2d_total, 3),
            "overlap_us": round(h2d_overlap, 3),
            "overlap_frac": (h2d_overlap / h2d_total if h2d_total else 0.0),
        },
        "idle": {
            "span_us": round(span_us, 3),
            "busy_us": round(busy_us, 3),
            "idle_us": round(idle_us, 3),
            "idle_frac": (idle_us / span_us if span_us else 0.0),
        },
        "counts": {
            "events": len(events),
            "device_events": len(compute),
            "h2d_events": len(h2d),
            "lane": lane_note,
        },
    }


def is_torch_capture(events: List[dict]) -> bool:
    """True for a ``torch.profiler`` Chrome trace: it has device-lane
    events of torch's categories."""
    cats = TORCH_COMPUTE_CATS + (TORCH_COPY_CAT, TORCH_ANNOTATION_CAT)
    return any(e.get("ph") == "X" and e.get("cat") in cats for e in events)


def _scope_of(starts: List[float], ranges: List[Tuple[float, float, str]],
              ts: float, scopes: Tuple[str, ...]) -> Optional[str]:
    """The scope at time ``ts`` of a lane whose annotation ranges (sorted
    by start, ``starts`` their starts) are ``ranges``: the first of
    ``scopes`` named by a range that contains ``ts``; None when none
    does."""
    names = [name for s, e, name in ranges[:bisect.bisect_right(starts, ts)]
             if s <= ts < e]
    for scope in scopes:
        if any(scope in n for n in names):
            return scope
    return None


def _range_index(events: List[dict], cat: str
                 ) -> Dict[Tuple[Any, Any], Tuple[List[float], list]]:
    """The ``cat`` ranges of each ``(pid, tid)`` lane, sorted by start, with
    their starts (for :func:`_scope_of`)."""
    lanes: Dict[Tuple[Any, Any], List[Tuple[float, float, str]]] = {}
    for e in events:
        if e.get("cat") == cat:
            t0 = float(e.get("ts", 0.0))
            lanes.setdefault((e.get("pid"), e.get("tid")), []).append(
                (t0, t0 + float(e.get("dur", 0.0)), str(e.get("name", "")).lower()))
    index = {}
    for key, ranges in lanes.items():
        ranges.sort()
        index[key] = ([r[0] for r in ranges], ranges)
    return index


def attribute_torch_device_time(events: List[dict],
                                scopes: Tuple[str, ...] = SCOPES
                                ) -> Dict[str, Any]:
    """:func:`attribute_device_time` of a ``torch.profiler`` capture: every
    kernel and memset of every stream is device time, bucketed by the scope
    ranges (``user_annotation``) around its launch on the launching thread,
    found through its ``correlation`` (``unattributed`` when the trace does
    not hold the launch). The copies are the H2D set; no range is counted.
    Same schema as the XLA breakdown, ``counts.lane`` =
    ``"torch_streams"``, and ``counts.by_launch`` the kernels whose launch
    was found."""
    complete = [e for e in events if e.get("ph") == "X"]
    compute = [e for e in complete if e.get("cat") in TORCH_COMPUTE_CATS
               and float(e.get("dur", 0)) > 0]
    h2d = [e for e in complete if e.get("cat") == TORCH_COPY_CAT
           and float(e.get("dur", 0)) > 0]
    launches: Dict[Any, Tuple[Any, Any, float]] = {}
    for e in complete:
        if e.get("cat") in TORCH_LAUNCH_CATS:
            corr = (e.get("args") or {}).get("correlation")
            if corr is not None:
                launches[corr] = (e.get("pid"), e.get("tid"), float(e.get("ts", 0.0)))
    host = _range_index(complete, TORCH_HOST_ANNOTATION_CAT)

    bucket_us: Dict[str, float] = {s: 0.0 for s in scopes}
    bucket_us[UNATTRIBUTED] = 0.0
    by_launch = 0
    for e in compute:
        launch = launches.get((e.get("args") or {}).get("correlation"))
        scope = None
        if launch is not None:
            by_launch += 1
            lane = host.get(launch[:2])
            if lane is not None:
                scope = _scope_of(lane[0], lane[1], launch[2], scopes)
        bucket_us[scope or UNATTRIBUTED] += float(e["dur"])

    # Every event went to exactly one bucket, so the buckets' sum is the
    # total (summed in one order, attributed_frac is exactly 1.0).
    total_us = attributed_us = sum(bucket_us.values())
    compute_iv = [(float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                  for e in compute]
    h2d_iv = [(float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in h2d]
    h2d_total = _merged_busy(h2d_iv)
    h2d_overlap = _overlap(compute_iv, h2d_iv)
    busy_us = _merged_busy(compute_iv)
    span_us = ((max(e[1] for e in compute_iv)
                - min(e[0] for e in compute_iv)) if compute_iv else 0.0)
    idle_us = max(span_us - busy_us, 0.0)
    return {
        "schema": BREAKDOWN_SCHEMA,
        "scopes": {
            name: {"time_us": round(us, 3),
                   "frac": (us / total_us if total_us else 0.0)}
            for name, us in bucket_us.items()
        },
        "total_device_time_us": round(total_us, 3),
        "attributed_frac": (attributed_us / total_us if total_us else 0.0),
        "h2d": {
            "total_us": round(h2d_total, 3),
            "overlap_us": round(h2d_overlap, 3),
            "overlap_frac": (h2d_overlap / h2d_total if h2d_total else 0.0),
        },
        "idle": {
            "span_us": round(span_us, 3),
            "busy_us": round(busy_us, 3),
            "idle_us": round(idle_us, 3),
            "idle_frac": (idle_us / span_us if span_us else 0.0),
        },
        "counts": {
            "events": len(events),
            "device_events": len(compute),
            "h2d_events": len(h2d),
            "by_launch": by_launch,
            "annotation_ranges": sum(len(r[1]) for r in host.values()),
            "lane": "torch_streams",
        },
    }


def parse_profile(path: str,
                  scopes: Tuple[str, ...] = SCOPES) -> Dict[str, Any]:
    """Load + attribute in one call; ``path`` is a capture file or a
    profile directory."""
    events, source = load_events(path)
    breakdown = attribute_device_time(events, scopes=scopes)
    breakdown["source"] = source
    return breakdown


def scope_frac_metrics(breakdown: Dict[str, Any]) -> Dict[str, float]:
    """Flatten a breakdown into registered ``prof/*`` metric floats —
    what the trainer enqueues after a capture window closes."""
    out: Dict[str, float] = {}
    for name, stats in breakdown.get("scopes", {}).items():
        key = _SCOPE_METRIC_KEYS.get(name)
        if key is not None:
            out[key] = float(stats["frac"])
    out["prof/h2d_overlap_frac"] = float(
        breakdown.get("h2d", {}).get("overlap_frac", 0.0))
    out["prof/idle_frac"] = float(
        breakdown.get("idle", {}).get("idle_frac", 0.0))
    return out


def write_breakdown(breakdown: Dict[str, Any], path: str) -> str:
    """Atomic-write the breakdown JSON; returns ``path``."""
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(breakdown, f, indent=2, sort_keys=True)
        f.write("\n")
    os.replace(tmp, path)
    return path


# ------------------------------------------------------------------- CLI
def main(argv: Optional[List[str]] = None) -> int:
    import argparse

    p = argparse.ArgumentParser(
        prog="python -m mercury_tpu_torch.obs.profile_parse",
        description="Attribute profiler-capture device time to named "
                    "scopes (offline, standard library only).")
    p.add_argument("capture", help="trace file (.trace.json[.gz], "
                   ".xplane.pb, trace.json) or profile directory")
    p.add_argument("--out", default="device_time_breakdown.json",
                   help="output JSON path (default: %(default)s)")
    args = p.parse_args(argv)
    try:
        breakdown = parse_profile(args.capture)
    except (OSError, ValueError, json.JSONDecodeError) as exc:
        print(f"error: cannot parse {args.capture}: {exc}",
              file=sys.stderr)
        return 2
    write_breakdown(breakdown, args.out)
    total = breakdown["total_device_time_us"]
    print(f"device time: {total / 1e3:.3f} ms over "
          f"{breakdown['counts']['device_events']} events "
          f"({breakdown['counts']['lane']} lane)")
    for name, stats in sorted(breakdown["scopes"].items(),
                              key=lambda kv: -kv[1]["time_us"]):
        print(f"  {name:24s} {stats['frac']:7.2%}  "
              f"{stats['time_us'] / 1e3:10.3f} ms")
    print(f"h2d overlap: {breakdown['h2d']['overlap_frac']:.2%}   "
          f"idle: {breakdown['idle']['idle_frac']:.2%}")
    print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
