"""Measurements of the selection kernels (``score_and_draw``,
``table_refresh_draw``) on the card, beside ``chip_smoke.py``.

    python3 -m mercury_tpu_torch.ops.select_sweep geometry
    python3 -m mercury_tpu_torch.ops.select_sweep ablate
    python3 -m mercury_tpu_torch.ops.select_sweep compare --parent DIR

- ``geometry``: the kernels at chosen (K, threads, run) splits through the
  C entry points, each checked against the plain version, then timed: the
  sweep that chose ``draw_geometry``'s rule.
- ``ablate``: copies of ``csrc/mercury_kernels.cu`` with one part left out
  (the draws; the cluster exchange), built beside the real one and timed
  at ``draw_geometry``'s splits. Their outputs are wrong by design; only
  their times are read, to see what each part costs.
- ``compare``: the wrappers of another checkout (``--parent``, e.g. an
  unpacked ``git archive`` of the parent commit) and of this one at the
  two paths' shapes and at 50,000, in turns parent, this, this, parent,
  each in its own process that builds its own kernels.

Needs one CUDA card and ``nvcc``. Times are CUDA-graph replays (the median
of 20 replays of 50 captured calls), printed with the card's name and
power limit, and written to ``chiprun_out/select_sweep_<mode>.json``.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
OUT_DIR = ROOT / "chiprun_out"
SIZES = (320, 5000, 50000)
# (n, K, threads, run) splits of the geometry sweep.
SPLITS = [(320, 1, 64, 8), (320, 1, 96, 4), (320, 1, 320, 1), (1000, 1, 128, 8),
          (1000, 1, 1024, 1), (5000, 1, 640, 8), (5000, 1, 320, 16), (8192, 1, 1024, 8),
          (8192, 2, 512, 8), (16384, 2, 1024, 8), (16384, 4, 512, 8), (50000, 8, 800, 8),
          (50000, 8, 416, 16), (50000, 4, 800, 16), (50000, 16, 416, 8),
          (1_000_000, 16, 1024, 8), (1_000_000, 8, 1024, 8), (1_000_000, 16, 1024, 64),
          (2_000_001, 16, 1024, 8), (5_000_000, 16, 1024, 12)]
# Text left out of the source for each ablation.
ABLATIONS = {
    "no_draws": [("for (int base = warp * kWarp; base < a.b; base += nthreads) {",
                  "for (int base = warp * kWarp; base < 0; base += nthreads) {")],
    "no_exchange": [("  if constexpr (kCluster) cluster_arrive_relaxed();\n", ""),
                    ("    cluster_wait();  // every block has started\n", ""),
                    ("    if (warp == 0 && lane < nblocks) *cluster.map_shared_rank(&sums[rank], lane) = bsum;\n", ""),
                    ("    cluster.sync();\n", "")],
}


def card_name() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "unknown card"


def graph_us(torch, fn, calls: int = 50, replays: int = 20) -> float:
    """Device µs of one call: ``calls`` calls captured in a CUDA graph,
    replayed between CUDA events; the median over ``replays``."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(replays):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) * 1e3 / calls)
    return statistics.median(times)


def inputs(torch, n: int, seed: int = 0):
    """Losses (or a table), a window of 64 slots wrapping the end, their
    scores, the EMA and 32 uniforms, on the card, from ``seed``."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    vals = torch.rand(n, generator=g, device=dev) * 4 + 0.1
    slots = (n - 20 + torch.arange(64, device=dev)) % n
    rscores = -torch.log(torch.rand(64, generator=g, device=dev))
    return vals, slots, rscores, torch.tensor([0.9], device=dev), torch.rand(32, generator=g, device=dev)


def launcher(torch, lib, n: int, geo, table: bool):
    """A call of one selection entry point of ``lib`` at geometry ``geo``
    (clusters, threads, per_block, run, smem) on fixed inputs."""
    vals, slots, rscores, ema, u = inputs(torch, n)
    dev = vals.device

    def call():
        probs = torch.empty(n, device=dev)
        sel = torch.empty(32, dtype=torch.int32, device=dev)
        scaled = torch.empty(32, device=dev)
        stream = torch.cuda.current_stream().cuda_stream
        if table:
            new_table = torch.empty(n, device=dev)
            err = lib.mercury_table_refresh_draw(
                vals.data_ptr(), slots.data_ptr(), rscores.data_ptr(), ema.data_ptr(),
                u.data_ptr(), 0.5, 0.98, n, 64, 32, *geo, new_table.data_ptr(),
                probs.data_ptr(), sel.data_ptr(), scaled.data_ptr(), stream)
        else:
            new_table = None
            err = lib.mercury_score_and_draw(
                vals.data_ptr(), ema.data_ptr(), u.data_ptr(), 0.5, n, 32, *geo,
                probs.data_ptr(), sel.data_ptr(), scaled.data_ptr(), stream)
        if err != 0:
            raise RuntimeError(f"launch refused: cudaError {err} at {geo}")
        return new_table, probs, sel

    return call, (vals, slots, rscores, ema, u)


def geometry_mode(torch, card: str):
    from mercury_tpu_torch.ops import _build, reference
    from mercury_tpu_torch.ops.mercury_kernels import _round_up, _ceil_div, draw_smem

    lib = _build.load()
    rows = []
    for n, k, t, r in SPLITS:
        per_block = _round_up(_ceil_div(n, k), 4)
        for table in (False, True):
            geo = (k, t, per_block, r, draw_smem(t, per_block, r, 64 if table else None))
            call, (vals, slots, rscores, ema, u) = launcher(torch, lib, n, geo, table)
            new_table, probs, _ = call()
            if table:
                t_ref, p_ref, _, _ = reference.table_refresh_draw(vals, slots, rscores, ema[0], u, 0.5, 0.98)
                assert torch.equal(new_table, t_ref), f"table at {geo}"
            else:
                p_ref, _, _ = reference.score_and_draw(vals, ema[0], u, 0.5)
            assert torch.allclose(probs, p_ref, rtol=1e-5, atol=0), f"probs at {geo}"
            us = graph_us(torch, call)
            name = "table_refresh_draw" if table else "score_and_draw"
            print(f"{name} n={n} K={k} threads={t} run={r}: {us:.3f} us [{card}]", flush=True)
            rows.append(dict(kernel=name, n=n, clusters=k, threads=t, run=r, us=us))
    return rows


def ablate_mode(torch, card: str):
    from mercury_tpu_torch.ops import _build
    from mercury_tpu_torch.ops.mercury_kernels import cluster_limit, draw_geometry

    src = (_build.CSRC / "mercury_kernels.cu").read_text()
    build = _build.BUILD_DIR / "ablate"
    build.mkdir(parents=True, exist_ok=True)
    variants = {"full": src}
    for name, cuts in ABLATIONS.items():
        text = src
        for old, new in cuts:
            if old not in text:
                raise RuntimeError(f"ablation {name}: {old!r} is not in the source")
            text = text.replace(old, new)
        variants[name] = text
    procs = {}
    for name, text in variants.items():
        (build / f"{name}.cu").write_text(text)
        procs[name] = subprocess.Popen(
            [_build.find_nvcc(), *_build.ARCH_FLAGS, *_build.NVCC_FLAGS, "-o",
             str(build / f"{name}.so"), str(build / f"{name}.cu")])
    libs = {}
    for name, proc in procs.items():
        if proc.wait() != 0:
            raise RuntimeError(f"nvcc failed on the {name} variant")
        lib = ctypes.CDLL(str(build / f"{name}.so"))
        for fn, argtypes in _build.SIGNATURES.items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        libs[name] = lib
    rows = []
    for n in SIZES:
        for table in (False, True):
            geo = draw_geometry(n, 64 if table else None, max_cluster=cluster_limit())
            for name, lib in libs.items():
                if name == "no_exchange" and geo.clusters == 1:
                    continue
                us = graph_us(torch, launcher(torch, lib, n, geo, table)[0])
                kernel = "table_refresh_draw" if table else "score_and_draw"
                print(f"{kernel} n={n} K={geo.clusters} {name}: {us:.3f} us [{card}]", flush=True)
                rows.append(dict(kernel=kernel, n=n, clusters=geo.clusters, variant=name, us=us))
    return rows


def wrappers_mode(torch, card: str):
    """This process's checkout's wrappers (the same API in every version of
    the port) at the paths' shapes and at 50,000."""
    from mercury_tpu_torch.ops import mercury_kernels as mk

    rows = []
    for n in SIZES:
        vals, slots, rscores, ema, u = inputs(torch, n)
        for name in ("score_and_draw", "table_refresh_draw"):
            if name == "score_and_draw":
                fn = lambda: mk.score_and_draw_kernel(vals, ema, u, 0.5)  # noqa: E731
            else:
                fn = lambda: mk.table_refresh_draw_kernel(  # noqa: E731
                    vals, slots, rscores, ema, u, 0.5, 0.98)
            rows.append(dict(kernel=name, n=n, us=graph_us(torch, fn)))
    return rows


def compare_mode(parent: Path, card: str):
    """Parent, this, this, parent: each run in its own process from its own
    checkout, so each builds and loads its own kernels."""
    runs = []
    for label, tree in (("parent", parent), ("this", ROOT), ("this", ROOT), ("parent", parent)):
        out = subprocess.run([sys.executable, str(Path(__file__).resolve()), "wrappers",
                              "--tree", str(tree)], capture_output=True, text=True, cwd=tree)
        if out.returncode != 0:
            raise RuntimeError(f"{label} run failed:\n{out.stderr[-4000:]}")
        rows = json.loads(out.stdout.strip().splitlines()[-1])
        for row in rows:
            print(f"{label:>6} {row['kernel']} n={row['n']}: {row['us']:.3f} us [{card}]", flush=True)
        runs.append(dict(label=label, rows=rows))
    return runs


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("mode", choices=("geometry", "ablate", "compare", "wrappers"))
    ap.add_argument("--parent", type=Path, help="compare: the other checkout's root")
    ap.add_argument("--tree", type=Path, help="wrappers: import the port from this root")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("select_sweep: no CUDA device", file=sys.stderr)
        return 1
    if args.mode == "wrappers":
        sys.path.insert(0, str(args.tree or ROOT))
        print(json.dumps(wrappers_mode(torch, "")))
        return 0
    sys.path.insert(0, str(ROOT))
    card = card_name()
    if args.mode == "compare":
        if args.parent is None:
            ap.error("compare needs --parent")
        result = compare_mode(args.parent.resolve(), card)
    else:
        result = {"geometry": geometry_mode, "ablate": ablate_mode}[args.mode](torch, card)
    OUT_DIR.mkdir(exist_ok=True)
    (OUT_DIR / f"select_sweep_{args.mode}.json").write_text(
        json.dumps({"card": card, "result": result}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
