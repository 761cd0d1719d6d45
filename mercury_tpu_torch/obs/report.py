"""Offline run report and regression diff — the port's own copy of
``mercury_tpu/obs/report.py`` (standard library only).

A run with observability on leaves a directory of artifacts:
``run_manifest.json``, ``metrics.jsonl`` and the ranks' ``metrics.h{r}.jsonl``
shards, ``heartbeat.h{r}.jsonl``, ``events.h{r}.jsonl`` (the event
journal), ``supervisor_summary.json``, ``trace.json`` (the span timeline),
``flight_record_*.json`` (anomaly post-mortems) and
``device_time_breakdown.json`` (``obs/profile_parse.py``). This module
renders them as one report and compares two runs against per-metric
tolerance rules:

    python -m mercury_tpu_torch.obs.report RUN_DIR [--out report.md] [--html]
    python -m mercury_tpu_torch.obs.report --diff RUN_A RUN_B

``--diff`` exits 1 naming every regressed metric. The rules are
``obs/report_tolerances.json`` (a copy of the JAX package's; override with
``--tolerances``): a direction a metric key (``higher_better`` /
``lower_better``) and a relative and/or absolute tolerance; a change beyond
it in the bad direction is a regression, an improvement never fails. The
values compared are the mean over each run's last ``window`` records
carrying the key.

The report is the JAX module's, section for section, with the manifest's
``torch_version`` and ``cuda_version`` as two more rows. No torch and no
numpy: it runs on a machine that only holds the run directory.
"""

from __future__ import annotations

import glob
import html as _html
import json
import os
import sys
from typing import Any, Dict, List, Optional, Sequence, Tuple

# Standard library only, as this module.
from mercury_tpu_torch.obs.events import load_events, parent_chain

#: Schema tag for the tolerance-rule file.
TOLERANCES_SCHEMA = "mercury_report_tolerances_v1"

_DEFAULT_WINDOW = 10


def default_tolerances_path() -> str:
    return os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "report_tolerances.json")


# --------------------------------------------------------------- ingest
def _read_json(path: str) -> Optional[Any]:
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


def read_jsonl(path: str) -> List[Dict[str, Any]]:
    records: List[Dict[str, Any]] = []
    try:
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    rec = json.loads(line)
                except ValueError:
                    continue  # torn tail line of a live run
                if isinstance(rec, dict):
                    records.append(rec)
    except OSError:
        pass
    return records


def load_run(run_dir: str) -> Dict[str, Any]:
    """Ingest one run directory into a plain dict. Every artifact is
    optional — a report over a partial directory is still a report."""
    metrics = read_jsonl(os.path.join(run_dir, "metrics.jsonl"))
    shards: Dict[int, List[Dict[str, Any]]] = {}
    for path in sorted(glob.glob(os.path.join(run_dir,
                                              "metrics.h*.jsonl"))):
        name = os.path.basename(path)
        try:
            host = int(name[len("metrics.h"):-len(".jsonl")])
        except ValueError:
            continue
        shards[host] = read_jsonl(path)
    if not metrics and shards:
        # No canonical stream (e.g. host 0's file was lost): fall back
        # to host 0's shard, else the lowest-numbered one.
        metrics = shards.get(0) or shards[min(shards)]
    flight = []
    for path in sorted(glob.glob(os.path.join(run_dir,
                                              "flight_record_*.json"))):
        doc = _read_json(path)
        if isinstance(doc, dict):
            doc["_path"] = path
            flight.append(doc)
    trace = _read_json(os.path.join(run_dir, "trace.json"))
    return {
        "dir": os.path.abspath(run_dir),
        "manifest": _read_json(os.path.join(run_dir,
                                            "run_manifest.json")) or {},
        "metrics": metrics,
        "shards": shards,
        "flight_records": flight,
        "events": load_events(run_dir),
        "supervisor_summary": _read_json(os.path.join(
            run_dir, "supervisor_summary.json")),
        "breakdown": _read_json(os.path.join(
            run_dir, "device_time_breakdown.json")),
        "trace_events": (len(trace.get("traceEvents", []))
                         if isinstance(trace, dict) else None),
    }


# -------------------------------------------------------- summarization
def metric_series(records: Sequence[Dict[str, Any]],
                  key: str) -> List[float]:
    return [float(r[key]) for r in records
            if isinstance(r.get(key), (int, float))]


def metric_keys(records: Sequence[Dict[str, Any]]) -> List[str]:
    keys = set()
    for r in records:
        keys.update(k for k, v in r.items()
                    if "/" in k and isinstance(v, (int, float)))
    return sorted(keys)


def summarize_metric(records: Sequence[Dict[str, Any]], key: str,
                     window: int = _DEFAULT_WINDOW
                     ) -> Optional[Dict[str, float]]:
    series = metric_series(records, key)
    if not series:
        return None
    tail = series[-window:]
    return {
        "n": float(len(series)),
        "last": series[-1],
        "mean_tail": sum(tail) / len(tail),
        "min": min(series),
        "max": max(series),
    }


def comparison_value(records: Sequence[Dict[str, Any]], key: str,
                     window: int = _DEFAULT_WINDOW) -> Optional[float]:
    """The value the diff judges: mean over the last ``window`` records
    carrying the key."""
    s = summarize_metric(records, key, window=window)
    return None if s is None else s["mean_tail"]


# ------------------------------------------------- sampler-health section
#: Bin count of the in-graph histograms (obs/sampler_health.HIST_BINS —
#: mirrored literally: this module must import nothing from the package).
_HIST_BINS = 16

_SPARK_BLOCKS = "▁▂▃▄▅▆▇█"


def _sparkline(values: Sequence[float]) -> str:
    """Pure-stdlib twin of ``obs.sampler_health.sparkline`` (that one is
    numpy; this module renders on machines with nothing installed)."""
    top = max(values) if values else 0.0
    if top <= 0:
        return _SPARK_BLOCKS[0] * len(values)
    hi = len(_SPARK_BLOCKS) - 1
    return "".join(_SPARK_BLOCKS[min(int(v / top * hi), hi)]
                   for v in values)


def _hist_last(records: Sequence[Dict[str, Any]], family: str
               ) -> Tuple[Optional[List[float]], Optional[int]]:
    """Latest complete per-bin histogram of ``family``, newest first."""
    keys = [f"sampler_dist/{family}/b{i:02d}" for i in range(_HIST_BINS)]
    for rec in reversed(records):
        if all(isinstance(rec.get(k), (int, float)) for k in keys):
            return [float(rec[k]) for k in keys], int(rec.get("step", -1))
    return None, None


def _sampler_health_blocks(records: Sequence[Dict[str, Any]]
                           ) -> List[Block]:
    """The "Sampler health" section: histogram sparklines, the ledger's
    coverage table, the grad-variance probe summary and the
    inclusion-bias verdict. Empty when the run emitted no
    ``sampler_dist/*`` keys (uniform baseline, telemetry off)."""
    blocks: List[Block] = []
    hist_rows = []
    for family, label, span in (
            ("score_hist", "score table", "[1e-6, 1e2)"),
            ("w_hist", "IS weights (L·p)", "[1e-4, 1e4)")):
        counts, step = _hist_last(records, family)
        if counts is not None:
            hist_rows.append([label, _sparkline(counts),
                              int(sum(counts)), span, step])
    cov = []
    for key, label in (
            ("sampler_dist/frac_never_selected", "never selected"),
            ("sampler_dist/gini", "selection Gini"),
            ("sampler_dist/class_share_min", "class share min"),
            ("sampler_dist/class_share_max", "class share max"),
            ("sampler_dist/class_starved", "classes starved")):
        s = summarize_metric(records, key)
        if s is not None:
            cov.append([label, _fmt(s["last"]), _fmt(s["min"]),
                        _fmt(s["max"])])
    probes = [v for v in metric_series(records, "sampler_dist/var_ratio")
              if v >= 0.0]  # -1.0 == off-cadence sentinel
    chi2 = summarize_metric(records, "sampler_dist/bias_chi2")
    ok = summarize_metric(records, "sampler_dist/bias_ok")
    if not (hist_rows or cov or probes or chi2):
        return blocks
    blocks.append(("h", 2, "Sampler health"))
    if hist_rows:
        blocks.append(("table",
                       ["distribution", "histogram (log bins)", "count",
                        "range", "step"], hist_rows))
    if cov:
        blocks.append(("table",
                       ["coverage", "last", "min", "max"], cov))
    if probes:
        losing = sum(1 for v in probes if v >= 1.0)
        blocks.append(("kv", [
            ("variance probe (last)", probes[-1]),
            ("probe records", len(probes)),
            ("probes with IS losing (ratio ≥ 1)",
             f"{losing}/{len(probes)}")]))
    if chi2 is not None:
        verdict = "UNKNOWN"
        if ok is not None:
            verdict = ("within threshold" if ok["last"] >= 1.0
                       else "BIASED — draws drifted from table probs")
        blocks.append(("kv", [
            ("inclusion-bias χ²/slot (last)", chi2["last"]),
            ("bias-audit verdict", verdict)]))
    return blocks


# ------------------------------------------------- scorer-service section
def _scorer_service_blocks(records: Sequence[Dict[str, Any]]
                           ) -> List[Block]:
    """The "Scorer service" section: service aggregates plus the
    per-tenant throughput/backpressure/SLO table
    (``scorer/{throughput,queue_depth,staleness,slo_breaches}/t{i}``).
    Empty when the run used the plain fleet or no async scorer at all
    (the service keys are absent)."""
    blocks: List[Block] = []
    agg = []
    for key, label in (
            ("scorer/throughput", "rows scored / s"),
            ("scorer/queue_depth", "ready chunks queued"),
            ("scorer/staleness", "max tenant staleness (steps)"),
            ("scorer/slo_breaches", "SLO breach events")):
        s = summarize_metric(records, key)
        if s is not None:
            agg.append((label, _fmt(s["last"])))
    tenants = []
    for i in range(4):
        tput = summarize_metric(records, f"scorer/throughput/t{i}")
        if tput is None:
            continue
        depth = summarize_metric(records, f"scorer/queue_depth/t{i}")
        stale = summarize_metric(records, f"scorer/staleness/t{i}")
        slo = summarize_metric(records, f"scorer/slo_breaches/t{i}")
        tenants.append([
            f"t{i}", _fmt(tput["last"]), _fmt(tput["mean_tail"]),
            _fmt(depth["last"]) if depth else "-",
            _fmt(stale["last"]) if stale else "-",
            _fmt(slo["last"]) if slo else "-"])
    if not tenants:
        # Aggregates without tenant streams = the plain fleet; the
        # Metrics table already covers scorer/throughput there.
        return blocks
    blocks.append(("h", 2, "Scorer service"))
    if agg:
        blocks.append(("kv", agg))
    blocks.append(("table",
                   ["tenant", "rows/s (last)",
                    f"rows/s (mean last {_DEFAULT_WINDOW})",
                    "queue depth", "staleness", "slo breaches"], tenants))
    return blocks


# --------------------------------------------------- run-timeline section
def _walk_label(evt: Dict[str, Any]) -> str:
    """One hop of a causal walk: ``kind[to]@step`` (the ``to`` rides on
    ladder transitions; other kinds render as plain ``kind@step``)."""
    detail = evt.get("detail") or {}
    qualifier = detail.get("to") or detail.get("fault") or detail.get(
        "trigger") or detail.get("slo")
    kind = evt.get("kind", "?")
    if qualifier:
        kind = f"{kind}[{qualifier}]"
    step = evt.get("step", -1)
    return f"{kind}@{step}" if isinstance(step, int) and step >= 0 else kind


def _elastic_history_blocks(events: List[Dict[str, Any]]) -> List[Block]:
    """The "Elastic history" section: one row per reshard, pairing each
    ``elastic/reshard_begin`` with its ``elastic/reshard_end`` (matched
    by ``parent_id``) — old/new mesh, the carried fields, wall-clock
    duration, and the state-schema sha the restoring build was linted
    against (so a post-resume trajectory shift can be tied to a schema
    change, not just a topology one)."""
    begins = [e for e in events if e.get("kind") == "elastic/reshard_begin"]
    if not begins:
        return []
    ends_by_parent = {e.get("parent_id"): e for e in events
                      if e.get("kind") == "elastic/reshard_end"
                      and e.get("parent_id")}
    blocks: List[Block] = [("h", 2, "Elastic history")]
    blocks.append(("p", f"{len(begins)} reshard(s) recorded in the "
                   "event journal"))
    rows = []
    for b in begins:
        d = b.get("detail") or {}
        end = ends_by_parent.get(b.get("event_id"))
        mesh = (f"W {d.get('w_old', '?')}→{d.get('w_new', '?')}, "
                f"L {d.get('l_old', '?')}→{d.get('l_new', '?')}")
        if end is not None and isinstance(end.get("wall_s"), (int, float)) \
                and isinstance(b.get("wall_s"), (int, float)):
            wall = f"{end['wall_s'] - b['wall_s']:.2f}s"
        else:
            wall = "incomplete" if end is None else "—"
        carried = ((end.get("detail") or {}).get("carried")
                   if end is not None else None)
        sha = d.get("state_schema_sha")
        rows.append([b.get("step", "—"), mesh,
                     ", ".join(carried) if carried else "—", wall,
                     (str(sha)[:12] if sha else "—")])
    blocks.append(("table",
                   ["step", "mesh", "carried fields", "wall-clock",
                    "schema sha"], rows))
    return blocks


def _fmt_est(value: Any) -> str:
    return f"{value:.1f}" if isinstance(value, (int, float)) else "—"


def _plan_table_rows(table: List[Dict[str, Any]]) -> List[List[Any]]:
    rows = []
    for c in table or []:
        reasons = "; ".join(
            r.get("rule", "?") for r in (c.get("reasons") or [])) or "—"
        mem = c.get("memory_bytes")
        rows.append([
            c.get("plan", "?"),
            "yes" if c.get("feasible") else "no",
            _fmt_est(c.get("est_steps_per_s")),
            (f"{mem / (1024.0 ** 2):.1f}" if isinstance(mem, (int, float))
             else c.get("memory_status", "—")),
            reasons,
        ])
    return rows


_PLAN_HEADERS = ["plan", "feasible", "est steps/s", "peak MiB", "rejected by"]


def _plan_selection_blocks(events: List[Dict[str, Any]]) -> List[Block]:
    """The "Plan selection" section: the auto-planner's construction-time
    decision table (``plan/selected``) and every mid-run elastic re-plan
    (``elastic/replan``) — which plan won, which candidates were
    excluded, and by which machine-readable rule."""
    selected = [e for e in events if e.get("kind") == "plan/selected"]
    replans = [e for e in events if e.get("kind") == "elastic/replan"]
    if not selected and not replans:
        return []
    blocks: List[Block] = [("h", 2, "Plan selection")]
    for evt in selected:
        d = evt.get("detail") or {}
        blocks.append(("kv", [
            ("selected plan", d.get("selected", "—")),
            ("world size", d.get("world_size", "—")),
            ("memory budget",
             d.get("memory_budget_bytes") or "unbounded"),
            ("device kind", d.get("device_kind", "—")),
            ("candidates considered", d.get("candidates_considered", "—")),
        ]))
        blocks.append(("table", _PLAN_HEADERS,
                       _plan_table_rows(d.get("table") or [])))
    if replans:
        blocks.append(("h", 3, "Elastic re-plans"))
        blocks.append(("p", f"{len(replans)} re-plan evaluation(s) "
                       "journaled across mesh changes"))
        for evt in replans:
            d = evt.get("detail") or {}
            verdict = ("switched" if d.get("changed") else "kept")
            blocks.append(("p", f"step {evt.get('step', '—')}: "
                           f"W {d.get('w_old', '?')}→{d.get('w_new', '?')}"
                           f": {d.get('plan_old', '?')} → "
                           f"{d.get('plan_new', '?')} ({verdict})"))
            blocks.append(("table", _PLAN_HEADERS,
                           _plan_table_rows(d.get("new_table") or [])))
    return blocks


def _event_timeline_blocks(events: List[Dict[str, Any]]) -> List[Block]:
    """The "Run timeline" section from the control-plane event journal:
    a kind census, the causal DAG's linked events, and one reconstructed
    ``parent_id`` walk per degrade episode (how the ladder was walked —
    the journal's whole reason to exist)."""
    blocks: List[Block] = []
    if not events:
        return blocks
    hosts = sorted({e.get("host", 0) for e in events})
    blocks.append(("h", 2, "Run timeline"))
    blocks.append(("p", f"{len(events)} control-plane events from "
                   f"{len(hosts)} host(s) (events.h*.jsonl)"))

    census: Dict[str, Dict[str, Any]] = {}
    for e in events:
        kind = e.get("kind", "?")
        row = census.setdefault(kind, {"n": 0, "first": None, "last": None})
        row["n"] += 1
        step = e.get("step", -1)
        if isinstance(step, int) and step >= 0:
            row["first"] = step if row["first"] is None else row["first"]
            row["last"] = step
    blocks.append(("table", ["kind", "events", "first step", "last step"],
                   [[k, census[k]["n"],
                     census[k]["first"] if census[k]["first"] is not None
                     else "—",
                     census[k]["last"] if census[k]["last"] is not None
                     else "—"]
                    for k in sorted(census)]))

    # Episode walks: for every supervisor/degrade, walk parent_id back
    # to the episode root (SLO breach, exhaustion, probe failure chain);
    # keep the LONGEST walk per root — that is the full ladder descent.
    episodes: Dict[str, List[Dict[str, Any]]] = {}
    for e in events:
        if e.get("kind") != "supervisor/degrade":
            continue
        chain = parent_chain(events, e["event_id"])
        root = chain[0]["event_id"] if chain else e["event_id"]
        if len(chain) > len(episodes.get(root, [])):
            episodes[root] = chain
    if episodes:
        blocks.append(("h", 3, "Degrade episodes"))
        rows = []
        for i, root in enumerate(sorted(
                episodes, key=lambda r: episodes[r][0].get("wall_s", 0))):
            chain = episodes[root]
            walk = " → ".join(_walk_label(e) for e in chain)
            rows.append([f"ep{i}", len(chain), walk])
        blocks.append(("table", ["episode", "events", "causal walk"],
                       rows))

    # The DAG's linked events (parents or children), newest last — the
    # census above already covers unlinked singletons like fault/fired.
    parents = {e.get("parent_id") for e in events if e.get("parent_id")}
    linked = [e for e in events
              if e.get("parent_id") or e.get("event_id") in parents]
    if linked:
        cap = 60
        shown = linked[-cap:]
        blocks.append(("h", 3, "Causally linked events"))
        if len(linked) > len(shown):
            blocks.append(("p", f"last {len(shown)} of {len(linked)} "
                           "linked events"))
        blocks.append(("table",
                       ["event", "kind", "step", "host", "parent"],
                       [[e.get("event_id"), e.get("kind"),
                         e.get("step"), e.get("host"),
                         e.get("parent_id") or "—"] for e in shown]))
    return blocks


# ------------------------------------------------------------ rendering
# Reports are built as a neutral block list so markdown and HTML render
# from the same structure: ("h", level, text) | ("p", text) |
# ("kv", [(k, v)...]) | ("table", headers, rows).
Block = Tuple


def _fmt(v: Any) -> str:
    if isinstance(v, float):
        return f"{v:.6g}"
    return str(v)


def _run_blocks(run: Dict[str, Any]) -> List[Block]:
    blocks: List[Block] = [("h", 1, f"Run report: {run['dir']}")]
    man = run["manifest"]
    if man:
        cfg = man.get("config", {})
        kv = [("model", cfg.get("model")), ("dataset", cfg.get("dataset")),
              ("world_size", cfg.get("world_size")),
              ("sampler", cfg.get("sampler")),
              ("device_kind", man.get("device_kind")),
              ("processes", man.get("process_count")),
              ("jax", man.get("jax_version")),
              ("torch", man.get("torch_version")),
              ("cuda", man.get("cuda_version")),
              ("git", man.get("git_revision")),
              ("started", man.get("timestamp"))]
        blocks.append(("h", 2, "Manifest"))
        blocks.append(("kv", [(k, v) for k, v in kv if v is not None]))
    records = run["metrics"]
    if records:
        steps = metric_series(records, "step")
        blocks.append(("h", 2, "Metrics"))
        blocks.append(("p", f"{len(records)} records"
                       + (f", steps {int(steps[0])}–{int(steps[-1])}"
                          if steps else "")))
        rows = []
        for key in metric_keys(records):
            s = summarize_metric(records, key)
            rows.append([key, _fmt(s["last"]), _fmt(s["mean_tail"]),
                         _fmt(s["min"]), _fmt(s["max"]), int(s["n"])])
        blocks.append(("table",
                       ["metric", "last", f"mean(last {_DEFAULT_WINDOW})",
                        "min", "max", "n"], rows))
        blocks.extend(_sampler_health_blocks(records))
        blocks.extend(_scorer_service_blocks(records))
    if run["shards"]:
        blocks.append(("h", 2, "Per-host shards"))
        rows = []
        for host in sorted(run["shards"]):
            recs = run["shards"][host]
            last_step = (int(recs[-1].get("step", -1)) if recs else None)
            st = summarize_metric(recs, "time/step")
            stall = summarize_metric(recs, "data/stall_s")
            rows.append([f"h{host}", len(recs), last_step,
                         _fmt(st["mean_tail"]) if st else "—",
                         _fmt(stall["mean_tail"]) if stall else "—"])
        blocks.append(("table",
                       ["host", "records", "last step",
                        "step_time_s (tail mean)", "stall_s (tail mean)"],
                       rows))
    bd = run["breakdown"]
    if isinstance(bd, dict) and bd.get("scopes"):
        blocks.append(("h", 2, "Device-time breakdown"))
        total = bd.get("total_device_time_us", 0.0)
        blocks.append(("p", f"{total / 1e3:.3f} ms of device-lane time "
                       f"({bd.get('counts', {}).get('device_events', '?')} "
                       f"events); source: {bd.get('source', '?')}"))
        rows = [[name, f"{s['frac']:.2%}", _fmt(s["time_us"] / 1e3)]
                for name, s in sorted(bd["scopes"].items(),
                                      key=lambda kv: -kv[1]["time_us"])]
        blocks.append(("table", ["scope", "fraction", "ms"], rows))
        blocks.append(("kv", [
            ("h2d overlap", f"{bd['h2d']['overlap_frac']:.2%}"),
            ("idle fraction", f"{bd['idle']['idle_frac']:.2%}")]))
    blocks.extend(_plan_selection_blocks(run["events"]))
    blocks.extend(_elastic_history_blocks(run["events"]))
    blocks.extend(_event_timeline_blocks(run["events"]))
    summary = run.get("supervisor_summary")
    if isinstance(summary, dict):
        blocks.append(("h", 2, "Supervisor summary"))
        blocks.append(("kv", [
            ("final level",
             f"{summary.get('level')} ({summary.get('level_name')})"),
            ("restarts", summary.get("restarts")),
            ("degradations", summary.get("degradations")),
            ("recoveries", summary.get("recoveries"))]))
        transitions = summary.get("transitions") or []
        if transitions:
            blocks.append(("table",
                           ["step", "from", "to", "reason"],
                           [[t.get("step"), t.get("from"), t.get("to"),
                             t.get("reason")] for t in transitions]))
    if run["flight_records"]:
        blocks.append(("h", 2, "Flight records"))
        rows = [[os.path.basename(fr.get("_path", "?")),
                 fr.get("trigger", {}).get("kind", "?"),
                 fr.get("trigger", {}).get("step", "?"),
                 fr.get("timestamp", "?")]
                for fr in run["flight_records"]]
        blocks.append(("table", ["file", "trigger", "step", "when"], rows))
    if run["trace_events"]:
        blocks.append(("p", f"Span trace: {run['trace_events']} events "
                       "(trace.json — load in ui.perfetto.dev)"))
    return blocks


def render_markdown(blocks: List[Block]) -> str:
    out: List[str] = []
    for block in blocks:
        kind = block[0]
        if kind == "h":
            out.append("#" * block[1] + " " + block[2])
        elif kind == "p":
            out.append(block[1])
        elif kind == "kv":
            out.extend(f"- **{k}**: {_fmt(v)}" for k, v in block[1])
        elif kind == "table":
            headers, rows = block[1], block[2]
            out.append("| " + " | ".join(headers) + " |")
            out.append("|" + "---|" * len(headers))
            out.extend("| " + " | ".join(_fmt(c) for c in row) + " |"
                       for row in rows)
        out.append("")
    return "\n".join(out).rstrip() + "\n"


def render_html(blocks: List[Block]) -> str:
    e = _html.escape
    body: List[str] = []
    for block in blocks:
        kind = block[0]
        if kind == "h":
            body.append(f"<h{block[1]}>{e(block[2])}</h{block[1]}>")
        elif kind == "p":
            body.append(f"<p>{e(block[1])}</p>")
        elif kind == "kv":
            items = "".join(f"<li><b>{e(str(k))}</b>: {e(_fmt(v))}</li>"
                            for k, v in block[1])
            body.append(f"<ul>{items}</ul>")
        elif kind == "table":
            headers = "".join(f"<th>{e(h)}</th>" for h in block[1])
            rows = "".join(
                "<tr>" + "".join(f"<td>{e(_fmt(c))}</td>" for c in row)
                + "</tr>" for row in block[2])
            body.append(f"<table><tr>{headers}</tr>{rows}</table>")
    style = ("body{font:14px/1.5 system-ui,sans-serif;margin:2em;"
             "max-width:72em}table{border-collapse:collapse}"
             "td,th{border:1px solid #ccc;padding:2px 8px;"
             "text-align:left}")
    return ("<!doctype html><html><head><meta charset='utf-8'>"
            f"<style>{style}</style></head><body>"
            + "".join(body) + "</body></html>\n")


# ----------------------------------------------------------------- diff
def load_tolerances(path: Optional[str] = None) -> Dict[str, Any]:
    path = path or default_tolerances_path()
    with open(path) as f:
        doc = json.load(f)
    if doc.get("schema") != TOLERANCES_SCHEMA:
        raise ValueError(
            f"{path}: expected schema {TOLERANCES_SCHEMA!r}, "
            f"got {doc.get('schema')!r}")
    return doc


def diff_runs(run_a: Dict[str, Any], run_b: Dict[str, Any],
              tolerances: Dict[str, Any]
              ) -> Tuple[List[str], List[str]]:
    """Judge run B (candidate) against run A (baseline). Returns
    ``(regressions, notes)`` — formatted lines; any regression means a
    non-zero exit. Only metrics with a committed rule can regress."""
    window = int(tolerances.get("window", _DEFAULT_WINDOW))
    regressions: List[str] = []
    notes: List[str] = []
    for key, rule in sorted(tolerances.get("rules", {}).items()):
        a = comparison_value(run_a["metrics"], key, window=window)
        b = comparison_value(run_b["metrics"], key, window=window)
        if a is None or b is None:
            which = ("both" if a is None and b is None
                     else "baseline" if a is None else "candidate")
            notes.append(f"skip {key}: absent in {which}")
            continue
        higher_better = rule.get("direction",
                                 "higher_better") == "higher_better"
        delta = b - a  # >0 == candidate larger
        bad = -delta if higher_better else delta
        rel_tol = rule.get("rel_tol")
        abs_tol = rule.get("abs_tol")
        allowed = max(
            abs(a) * rel_tol if rel_tol is not None else 0.0,
            abs_tol if abs_tol is not None else 0.0,
        )
        if bad > allowed:
            rel = bad / abs(a) if a else float("inf")
            regressions.append(
                f"REGRESSION {key}: {a:.6g} -> {b:.6g} "
                f"({'-' if higher_better else '+'}{rel:.1%} "
                f"{'worse' if higher_better else 'higher'}, "
                f"tolerance {allowed:.6g})")
        else:
            notes.append(f"ok {key}: {a:.6g} -> {b:.6g}")
    return regressions, notes


def _diff_blocks(run_a: Dict[str, Any], run_b: Dict[str, Any],
                 regressions: List[str], notes: List[str]) -> List[Block]:
    blocks: List[Block] = [
        ("h", 1, "Run diff"),
        ("kv", [("baseline", run_a["dir"]), ("candidate", run_b["dir"]),
                ("verdict", "REGRESSED" if regressions else "OK")]),
    ]
    if regressions:
        blocks.append(("h", 2, "Regressions"))
        blocks.extend(("p", line) for line in regressions)
    blocks.append(("h", 2, "Checked metrics"))
    blocks.extend(("p", line) for line in notes)
    return blocks


# ------------------------------------------------------------------- CLI
def main(argv: Optional[List[str]] = None) -> int:
    import argparse

    p = argparse.ArgumentParser(
        prog="python -m mercury_tpu_torch.obs.report",
        description="Render a run report, or diff two runs against "
                    "committed tolerance rules (offline, standard library only).")
    p.add_argument("runs", nargs="+", metavar="RUN_DIR",
                   help="one run directory (report) or, with --diff, "
                        "BASELINE CANDIDATE")
    p.add_argument("--diff", action="store_true",
                   help="compare two runs; exit 1 on regression")
    p.add_argument("--tolerances", default=None,
                   help="tolerance-rule JSON (default: committed "
                        "obs/report_tolerances.json)")
    p.add_argument("--out", default=None,
                   help="write the report here (default: stdout)")
    p.add_argument("--html", action="store_true",
                   help="render HTML instead of markdown")
    args = p.parse_args(argv)

    if args.diff:
        if len(args.runs) != 2:
            p.error("--diff needs exactly two run directories")
        for d in args.runs:
            if not os.path.isdir(d):
                print(f"error: {d} is not a directory", file=sys.stderr)
                return 2
        try:
            tolerances = load_tolerances(args.tolerances)
        except (OSError, ValueError) as exc:
            print(f"error: {exc}", file=sys.stderr)
            return 2
        run_a, run_b = load_run(args.runs[0]), load_run(args.runs[1])
        regressions, notes = diff_runs(run_a, run_b, tolerances)
        blocks = _diff_blocks(run_a, run_b, regressions, notes)
        rc = 1 if regressions else 0
    else:
        regressions = []
        if len(args.runs) != 1:
            p.error("report mode takes exactly one run directory "
                    "(use --diff to compare two)")
        if not os.path.isdir(args.runs[0]):
            print(f"error: {args.runs[0]} is not a directory",
                  file=sys.stderr)
            return 2
        blocks = _run_blocks(load_run(args.runs[0]))
        rc = 0

    text = render_html(blocks) if args.html else render_markdown(blocks)
    if args.out:
        d = os.path.dirname(os.path.abspath(args.out))
        os.makedirs(d, exist_ok=True)
        with open(args.out, "w") as f:
            f.write(text)
        print(f"wrote {args.out}")
    else:
        print(text, end="")
    for line in regressions:  # regressions always reach stderr, even
        print(line, file=sys.stderr)  # when the report went to a file
    if regressions:
        print(f"{len(regressions)} regression(s) — failing",
              file=sys.stderr)
    return rc


if __name__ == "__main__":
    raise SystemExit(main())
