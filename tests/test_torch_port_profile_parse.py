"""Device-time attribution (``mercury_tpu_torch/obs/profile_parse.py``)
against the JAX package's (``mercury_tpu/obs/profile_parse.py``), and its
``torch.profiler`` path.

- The JAX package's fixtures (the committed capture, hand-built XLA lanes,
  the hand-encoded ``xplane.pb``, a gzipped trace, a directory to search)
  give equal breakdowns and equal ``prof/*`` metrics in both packages.
- A hand-built ``torch.profiler`` trace (kernels and a memset on three
  streams launched from two threads, nested host ranges, the ranges the
  trace projects onto the card, copies) attributes each kernel to the host
  scope around its launch (found by ``correlation``; the first of
  ``SCOPES`` where ranges nest; an outer ``mercury_optimizer`` over the
  ``Optimizer.step#Adam.step`` that the card shows), a kernel whose launch
  the window lacks to ``unattributed``; it counts no range as device time
  and gives ``attributed_frac == 1.0``.
- The CLI writes the same file for the fixture and parses the torch trace.
"""

import gzip
import json

import pytest

from mercury_tpu.obs import profile_parse as jpp
from mercury_tpu_torch.obs import profile_parse as tpp
from test_profile_parse import FIXTURE, encode_xplane_capture, meta_events, op


def _both(fn, *args, **kwargs):
    mine = getattr(tpp, fn)(*args, **kwargs)
    theirs = getattr(jpp, fn)(*args, **kwargs)
    assert mine == theirs
    return mine


def test_constants_equal_jax():
    assert tpp.SCOPES == jpp.SCOPES and tpp.UNATTRIBUTED == jpp.UNATTRIBUTED
    assert tpp.BREAKDOWN_SCHEMA == jpp.BREAKDOWN_SCHEMA


def test_fixture_breakdown_equals_jax():
    bd = _both("parse_profile", FIXTURE)
    assert bd["attributed_frac"] >= 0.95
    assert tpp.scope_frac_metrics(bd) == jpp.scope_frac_metrics(bd)


XLA_CASES = {
    "priority": meta_events() + [op("mercury_scoring/mercury_augmentation/x", 0, 10),
                                 op("mercury_optimizer/adam", 10, 5),
                                 op("fusion.3", 20, 5)],
    "args": meta_events() + [dict(op("custom-call", 0, 4),
                                  args={"long_name": "mercury_grad_sync/all-reduce"})],
    "host-lanes": meta_events() + meta_events(pid=2, pname="/host:CPU",
                                              lanes=((1, "python"),))
    + [op("mercury_scoring/a", 0, 3), op("mercury_scoring/b", 0, 30, pid=2, tid=1)],
    "busiest": meta_events(lanes=((3, "Steps"), (4, "Modules")))
    + [op("mercury_scoring/a", 0, 3, tid=3), op("mercury_optimizer/b", 0, 8, tid=4),
       op("x", 9, 8, tid=4)],
    "h2d-idle": meta_events(lanes=((3, "XLA Ops"), (5, "MemcpyH2D")))
    + [op("mercury_scoring/a", 0, 10), op("fusion", 30, 10),
       op("transfer", 5, 20, tid=5)],
    "empty": [],
}


@pytest.mark.parametrize("name", sorted(XLA_CASES))
def test_xla_events_attribute_as_jax(name):
    events = XLA_CASES[name]
    mine = tpp.attribute_device_time(json.loads(json.dumps(events)))
    theirs = jpp.attribute_device_time(json.loads(json.dumps(events)))
    assert mine == theirs
    assert tpp.scope_frac_metrics(mine) == jpp.scope_frac_metrics(theirs)


def test_xplane_and_gzip_and_directory_equal_jax(tmp_path):
    (tmp_path / "prof" / "run").mkdir(parents=True)
    pb = tmp_path / "prof" / "run" / "host0.xplane.pb"
    pb.write_bytes(encode_xplane_capture())
    assert tpp.load_xplane_events(str(pb)) == jpp.load_xplane_events(str(pb))
    _both("parse_profile", str(pb))
    _both("parse_profile", str(tmp_path / "prof"))
    gz = tmp_path / "t.trace.json.gz"
    gz.write_bytes(gzip.compress(open(FIXTURE, "rb").read()))
    _both("parse_profile", str(gz))
    assert tpp.discover_capture_files(str(tmp_path)) == jpp.discover_capture_files(
        str(tmp_path))
    with pytest.raises(FileNotFoundError):
        tpp.parse_profile(str(tmp_path / "prof" / "none"))


def _kernel(name, ts, dur, stream, corr=None, cat="kernel"):
    args = {"device": 0, "stream": stream}
    if corr is not None:
        args["correlation"] = corr
    return {"ph": "X", "cat": cat, "name": name, "pid": 0, "tid": stream, "ts": ts,
            "dur": dur, "args": args}


def _host(name, ts, dur, tid=1, cat="user_annotation", **args):
    return {"ph": "X", "cat": cat, "name": name, "pid": 4242, "tid": tid, "ts": ts,
            "dur": dur, "args": args}


def _launch(corr, ts, tid=1):
    return _host("cudaLaunchKernel", ts, 2.0, tid=tid, cat="cuda_runtime", correlation=corr)


def torch_trace():
    """A ``torch.profiler``-shaped capture: the process and stream metadata;
    on the host, the scope ranges of two threads and the launches; on the
    card, kernels and a memset on three streams, copies, and the ranges the
    trace projects onto the card (the innermost annotation only)."""
    return [
        {"ph": "M", "name": "process_name", "pid": 0, "tid": 0, "args": {"name": "python3"}},
        {"ph": "M", "name": "thread_name", "pid": 0, "tid": 7, "args": {"name": "stream 7 "}},
        {"ph": "M", "name": "process_name", "pid": 4242, "tid": 0,
         "args": {"name": "python3"}},
        _host("aten::conv2d", 0.0, 500.0, cat="cpu_op"),
        _host("mercury_scoring", 0.0, 90.0),
        _host("mercury_augmentation", 2.0, 8.0),       # nested in scoring
        _host("mercury_optimizer", 100.0, 50.0),
        _host("Optimizer.step#Adam.step", 110.0, 30.0),
        _host("mercury_grad_sync", 160.0, 10.0, tid=2),
        _launch(1, 3.0), _launch(2, 20.0), _launch(3, 120.0), _launch(4, 125.0),
        _launch(5, 95.0), _launch(6, 165.0, tid=2), _launch(7, 165.0),
        # Projected ranges: not used (the Adam kernels' shows Adam's, not ours).
        {"ph": "X", "cat": "gpu_user_annotation", "name": "mercury_scoring", "pid": 0,
         "tid": 7, "ts": 10.0, "dur": 40.0},
        {"ph": "X", "cat": "gpu_user_annotation", "name": "Optimizer.step#Adam.step",
         "pid": 0, "tid": 7, "ts": 200.0, "dur": 30.0},
        _kernel("aug_kernel", 12.0, 4.0, 7, 1),            # scoring (nested: first of SCOPES)
        _kernel("conv_fwd", 20.0, 25.0, 7, 2),             # scoring
        _kernel("adam_inner", 200.0, 20.0, 7, 3),          # optimizer, outside Adam's range
        _kernel("memset_buf", 222.0, 2.0, 7, 4, cat="gpu_memset"),   # optimizer
        _kernel("bn_fwd", 240.0, 10.0, 7, 5),              # no scope at its launch
        _kernel("allreduce", 260.0, 6.0, 20, 6),           # grad_sync, thread 2's range
        _kernel("other_thread", 262.0, 4.0, 21, 7),        # thread 1 has no range at 165
        _kernel("orphan", 300.0, 5.0, 7),                  # launch not in the window
        _kernel("Memcpy HtoD (Pinned -> Device)", 30.0, 10.0, 9, cat="gpu_memcpy"),
        _kernel("Memcpy DtoH (Device -> Pinned)", 400.0, 5.0, 9, cat="gpu_memcpy"),
    ]


def test_torch_trace_attributes_by_launch():
    bd = tpp.attribute_device_time(torch_trace())
    us = {k: v["time_us"] for k, v in bd["scopes"].items()}
    assert us == {"mercury_scoring": 29.0, "mercury_grad_sync": 6.0,
                  "mercury_augmentation": 0.0, "mercury_input_fuse": 0.0,
                  "mercury_optimizer": 22.0, "unattributed": 19.0}
    assert bd["total_device_time_us"] == 76.0 and bd["attributed_frac"] == 1.0
    assert bd["counts"] == {"events": 28, "device_events": 8, "h2d_events": 2,
                            "by_launch": 7, "annotation_ranges": 5,
                            "lane": "torch_streams"}
    assert bd["h2d"] == {"total_us": 15.0, "overlap_us": 10.0, "overlap_frac": 10.0 / 15.0}
    # Busy: [12, 16) ∪ [20, 45) ∪ [200, 220) ∪ [222, 224) ∪ [240, 250)
    # ∪ [260, 266) ∪ [300, 305) over [12, 305).
    assert bd["idle"] == {"span_us": 293.0, "busy_us": 72.0, "idle_us": 221.0,
                          "idle_frac": 221.0 / 293.0}
    metrics = tpp.scope_frac_metrics(bd)
    assert metrics["prof/scope_frac/mercury_scoring"] == 29.0 / 76.0
    assert set(metrics) == set(jpp.scope_frac_metrics(bd))


def test_torch_trace_detection():
    assert tpp.is_torch_capture(torch_trace())
    assert not tpp.is_torch_capture(XLA_CASES["priority"])
    only_ranges = [e for e in torch_trace() if e.get("cat") != "kernel"
                   and e.get("cat") != "gpu_memset"]
    bd = tpp.attribute_device_time(only_ranges)
    assert bd["total_device_time_us"] == 0.0 and bd["attributed_frac"] == 0.0


def test_cli_on_the_fixture_and_a_torch_trace(tmp_path, capsys):
    mine, theirs = str(tmp_path / "a.json"), str(tmp_path / "b.json")
    assert tpp.main([FIXTURE, "--out", mine]) == jpp.main([FIXTURE, "--out", theirs]) == 0
    assert open(mine).read() == open(theirs).read()
    trace = tmp_path / "profile" / "trace_step5.json"
    trace.parent.mkdir()
    trace.write_text(json.dumps({"traceEvents": torch_trace()}))
    out = str(tmp_path / "c.json")
    assert tpp.main([str(tmp_path / "profile"), "--out", out]) == 0
    assert json.load(open(out))["counts"]["lane"] == "torch_streams"
    bad = tmp_path / "bad.json"
    bad.write_text("{nope")
    assert tpp.main([str(bad), "--out", out]) == 2
    assert "torch_streams" in capsys.readouterr().out
