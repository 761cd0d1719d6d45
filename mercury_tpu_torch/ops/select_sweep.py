"""Measurements of the selection kernels (``score_and_draw``,
``table_refresh_draw``), the ingest (``augment_normalize``) and the NLL
kernels (``nll_fwd``, ``nll_bwd``) on the card, beside ``chip_smoke.py``.

    python3 -m mercury_tpu_torch.ops.select_sweep geometry [--kernels select|ingest|nll]
    python3 -m mercury_tpu_torch.ops.select_sweep ablate [--kernels select|ingest|nll]
    python3 -m mercury_tpu_torch.ops.select_sweep compare --parent DIR [--kernels ...]

- ``geometry``: the selections at chosen (K, threads, run) splits, the
  ingest at chosen (threads, band, copy) splits, at [32], [64] and [320]
  in f32 and bf16, and ``nll_fwd`` and ``nll_bwd`` at every (lanes,
  threads, vec) split (vec the widest load or one value) at [32,10],
  [64,10], [320,10] and [4096,100] in f32 and bf16, through the C entry
  points, each checked against the plain version, then timed: the sweeps
  that chose ``draw_geometry``'s, ``ingest_geometry``'s and
  ``nll_geometry``'s rules. Then the ingest's ``rows`` form against the ``x[rows]`` gather
  followed by the kernel.
- ``ablate``: copies of ``csrc/mercury_kernels.cu`` with one part left
  out (of the selections: the draws, the cluster exchange; of the
  ingest: the table, the copy, the lookups, the stores, a barrier, all
  past a point; of ``nll_fwd``: all of it, all after the loads, the
  exponentials; of ``nll_bwd``: all of it, all after the loads, the
  divisions, the float64 sum), built beside the real one and timed at the default
  geometries. Their outputs are wrong by design; only their times are
  read, to see what each part costs.
- ``compare``: the wrappers of another checkout (``--parent``, e.g. an
  unpacked ``git archive`` of the parent commit) and of this one, the
  selections at the two paths' shapes and at 50,000, the ingest at
  [32], [64] and [320] in f32 and bf16 (without ``rows``, which older
  checkouts lack), the step's ingest of shard rows (``step_ingest``:
  the kernel's own gather where the checkout has ``rows``, else the
  ``x[rows]`` gather and the kernel), and ``nll_fwd`` and ``nll_bwd`` at
  the sweep's four shapes in f32 and bf16, beside
  ``F.cross_entropy(reduction="none")`` and the 2 ATen calls of its
  gradient (:func:`aten_nll_backward`), in turns parent, this, this,
  parent, each in its own process that builds its own kernels. For
  ``nll_bwd`` it also counts, over several inputs, the gradients outside
  ``chip_smoke.py``'s limit of the plain version and those one bf16 ulp
  off it (:func:`nll_bwd_misses`).

Needs one CUDA card and ``nvcc``. Times are CUDA-graph replays (the median
of 20 replays of 50 captured calls), printed with the card's name and
power limit, and written to ``chiprun_out/select_sweep_<mode>.json``.
"""

from __future__ import annotations

import argparse
import ctypes
import inspect
import json
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
OUT_DIR = ROOT / "chiprun_out"
SIZES = (320, 5000, 50000)
INGEST_SIZES = (32, 64, 320)  # the batch, the window, the fused pool
INGEST_ROWS = 5000            # images the ingest's rows index (the synthetic shard)
# (n, K, threads, run) splits of the selections' geometry sweep.
SPLITS = [(320, 1, 64, 8), (320, 1, 96, 4), (320, 1, 320, 1), (1000, 1, 128, 8),
          (1000, 1, 1024, 1), (5000, 1, 640, 8), (5000, 1, 320, 16), (8192, 1, 1024, 8),
          (8192, 2, 512, 8), (16384, 2, 1024, 8), (16384, 4, 512, 8), (50000, 8, 800, 8),
          (50000, 8, 416, 16), (50000, 4, 800, 16), (50000, 16, 416, 8),
          (1_000_000, 16, 1024, 8), (1_000_000, 8, 1024, 8), (1_000_000, 16, 1024, 64),
          (2_000_001, 16, 1024, 8), (5_000_000, 16, 1024, 12)]
# (threads, band, copy) splits of the ingest's geometry sweep; copy 0 byte
# loads, 1 one bulk async copy.
INGEST_SPLITS = [(256, 32, 1), (256, 32, 0), (128, 32, 1), (384, 32, 1), (512, 32, 1),
                 (256, 16, 1), (384, 16, 1), (256, 8, 1), (128, 8, 1)]
# Text left out of the source for each ablation of the selections.
ABLATIONS = {
    "no_draws": [("for (int base = warp * kWarp; base < a.b; base += nthreads) {",
                  "for (int base = warp * kWarp; base < 0; base += nthreads) {")],
    "no_exchange": [("  if constexpr (kCluster) cluster_arrive_relaxed();\n", ""),
                    ("    cluster_wait();  // every block has started\n", ""),
                    ("    if (warp == 0 && lane < nblocks) *cluster.map_shared_rank(&sums[rank], lane) = bsum;\n", ""),
                    ("    cluster.sync();\n", "")],
}

# ... and of the ingest, the specialized 32×32×3 kernel: all of it (empty,
# it returns at entry); the table's arithmetic; the staging copy; the
# lookups; the stores; the first barrier; all after that barrier
# (stop_after_sync) or after the copy's wait (stop_after_wait).
RETURN = "  if (a.m > 0) return;\n"  # always taken; the compiler cannot tell
SYNC = "  __syncthreads();\n  if (oy < 0"
WAIT = "  if constexpr (kCopy == kCopyBulk) bulk_wait(&bar);\n"
INGEST_ABLATIONS = {
    "empty": [("  __shared__ uint64_t bar;\n", "  __shared__ uint64_t bar;\n" + RETURN)],
    "no_table": [("            __fdiv_rn(__fmaf_rn(static_cast<float>(v), kInv255, -mu[ch]), "
                  "sd[ch]);", "            v + ch;")],
    "no_copy": [("    if (tid == 0) bulk_copy(stage, src, nbytes, &bar);\n", ""), (WAIT, "")],
    "no_lookup": [("              const float t = table[ch * kLevels + px[ch]];",
                   "              const float t = static_cast<float>(sx + ch);")],
    "no_stores": [("        __stcg(reinterpret_cast<uint4*>(out) + k, obuf[k]);",
                   "        if (obuf[k].x == 12345u) __stcg(reinterpret_cast<uint4*>(out) + k, "
                   "obuf[k]);")],
    "no_sync": [(SYNC, "  if (oy < 0")],
    "stop_after_sync": [(SYNC, "  __syncthreads();\n" + RETURN + "  if (oy < 0")],
    "stop_after_wait": [(WAIT, WAIT + RETURN)],
}
INGEST_ABLATION_SPLITS = [(256, 32, 1)]

# nll_fwd: the step's scoring and train forwards ([320,10], [32,10]), the
# scoretable window ([64,10]) and a CIFAR-100-sized call ([4096,100]).
NLL_SHAPES = ((32, 10), (64, 10), (320, 10), (4096, 100))
NLL_LANES = (1, 2, 4, 8, 16, 32)
NLL_THREADS = (32, 64, 128, 256)
# ... and its ablations at the default geometry: all of it (it returns at
# entry); all after the row's loads (their values kept alive); the
# exponentials (a subtraction in their place).
NLL_LOADED = "    load_vectors<T, V, kHeld>(z, g, lanes, nvec, v);\n"
NLL_ABLATIONS = {
    "empty": [("  const bool live = row < n;  // dead lanes still take part in the shuffles\n",
               "  const bool live = row < n;  // dead lanes still take part in the shuffles\n"
               "  if (n > 0) return;\n")],
    "stop_after_loads": [(NLL_LOADED, NLL_LOADED + "    if (n > 0) {\n      float t = y;\n"
                          "      for (int i = 0; i < kHeld * V; ++i) t += v[i];\n"
                          "      if (t == 1234.5f) out[row] = t;\n      return;\n    }\n")],
    "no_exp": [("        *s += expf(x - m);\n", "        *s += x - m;\n")],
}
# ... and of nll_bwd: all of it (it returns at entry); all after the row's
# loads (their values kept alive); the divisions (e·s in place of e / s);
# the float64 sum of the exponentials (a float32 sum in the lanes' order
# in its place: what the correctly rounded sum costs).
NLL_BWD_IN_ROWS = "  const bool in_rows = row < n;  // lanes past N run on: only memory is guarded\n"
NLL_BWD_LOADED = "    load_vectors<T, V, kHeld>(z, lane, lanes, nvec, v);\n"
NLL_BWD_ABLATIONS = {
    "empty": [(NLL_BWD_IN_ROWS, NLL_BWD_IN_ROWS + "  if (n > 0) return;\n")],
    "stop_after_loads": [(NLL_BWD_LOADED, NLL_BWD_LOADED + "    if (n > 0) {\n"
                          "      float t = y + gi;\n"
                          "      for (int i = 0; i < kHeld * V; ++i) t += v[i];\n"
                          "      if (t == 1234.5f) store_from_f32(out, t);\n      return;\n    }\n")],
    "no_division": [("r[i] = (e[k * V + i] / s - ", "r[i] = (e[k * V + i] * s - ")],
    "float32_sum": [("int nvec, double* s) {", "int nvec, float* s) {"),
                    ("  double s = 0.0;\n", "  float s = 0.f;\n")],
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


def ingest_inputs(torch, n: int, seed: int = 0):
    """INGEST_ROWS uint8 CIFAR-shaped images, CIFAR-10's mean and std, ``n``
    crop offsets, flips and rows (int64, into the images), on the card."""
    from mercury_tpu_torch.data.cifar import CIFAR10_MEAN, CIFAR10_STD

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    raw = torch.randint(0, 256, (INGEST_ROWS, 32, 32, 3), generator=g, device=dev,
                        dtype=torch.uint8)
    crop = torch.randint(0, 9, (n, 2), generator=g, device=dev, dtype=torch.int32)
    flip = torch.rand(n, generator=g, device=dev) < 0.5
    rows = torch.randint(0, INGEST_ROWS, (n,), generator=g, device=dev)
    return (raw, torch.tensor(CIFAR10_MEAN, device=dev), torch.tensor(CIFAR10_STD, device=dev),
            crop, flip, rows)


def bits(t):
    """The bit patterns of a float32 or bfloat16 tensor, for exact equality."""
    import torch

    return t.view(torch.int32 if t.element_size() == 4 else torch.int16)


def ingest_launcher(torch, lib, raw, mean, std, crop, flip, out, geo):
    """A call of ``lib``'s ingest entry point at geometry ``geo`` (threads,
    band, copy, smem) on ``raw`` (no rows) into ``out``."""
    n, h, w, c = raw.shape
    dtype = 0 if out.dtype == torch.float32 else 1

    def call():
        err = lib.mercury_augment_normalize(
            raw.data_ptr(), None, mean.data_ptr(), std.data_ptr(), crop.data_ptr(),
            flip.data_ptr(), out.data_ptr(), n, n, h, w, c, 4, *geo, dtype,
            torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"launch refused: cudaError {err} at {geo}")

    return call


def ingest_geometry_mode(torch, card: str):
    from mercury_tpu_torch.ops import _build, reference
    from mercury_tpu_torch.ops import mercury_kernels as mk

    lib = _build.load()
    rows = []
    for n in INGEST_SIZES:
        raw_all, mean, std, crop, flip, idx = ingest_inputs(torch, n)
        raw = raw_all[:n]
        for dtype in (torch.float32, torch.bfloat16):
            want = reference.augment_normalize(raw, mean, std, crop, flip, 4, dtype)
            out = torch.empty_like(want)
            for threads, band, copy in INGEST_SPLITS:
                geo = mk.IngestGeometry(threads, band, copy, mk.ingest_smem(
                    32, 32, 3, band, 4, out.element_size()))
                call = ingest_launcher(torch, lib, raw, mean, std, crop, flip, out, geo)
                out.zero_()
                call()
                torch.cuda.synchronize()
                assert torch.equal(bits(out), bits(want)), f"ingest [{n}] {dtype} at {geo}"
                us = graph_us(torch, call)
                name = str(dtype)[6:]
                print(f"augment_normalize [{n}] {name} threads={threads} band={band} "
                      f"copy={copy}: {us:.3f} us [{card}]", flush=True)
                rows.append(dict(kernel="augment_normalize", n=n, dtype=name, threads=threads,
                                 band=band, copy=copy, us=us))
        # The rows form against the x[rows] gather and the kernel.
        fused = lambda: mk.augment_normalize_kernel(  # noqa: E731
            raw_all, mean, std, crop, flip, 4, torch.float32, rows=idx)
        pair = lambda: mk.augment_normalize_kernel(  # noqa: E731
            raw_all[idx], mean, std, crop, flip, 4, torch.float32)
        assert torch.equal(bits(fused()), bits(pair())), f"rows form at [{n}]"
        row = dict(kernel="augment_normalize_rows", n=n, dtype="float32",
                   us=graph_us(torch, fused), pair_us=graph_us(torch, pair))
        print(f"augment_normalize [{n}] float32 rows: {row['us']:.3f} us, gather + kernel "
              f"{row['pair_us']:.3f} us [{card}]", flush=True)
        rows.append(row)
    return rows


def nll_inputs(torch, n: int, c: int, dtype, seed: int = 0):
    """``[n, c]`` logits of N(0, 3²) in ``dtype`` and ``[n]`` int32 labels
    in ``[0, c)``, on the card."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    z = (torch.randn(n, c, generator=g, device=dev) * 3).to(dtype)
    y = torch.randint(0, c, (n,), generator=g, device=dev, dtype=torch.int32)
    return z, y


def nll_launcher(torch, lib, z, y, out, geo, g=None):
    """A call of ``lib``'s ``nll_fwd`` entry point at geometry ``geo``
    (lanes, threads, vec) into ``out``; of ``nll_bwd`` with ``g``."""
    n, c = z.shape
    dtype = 0 if z.dtype == torch.float32 else 1

    def call():
        stream = torch.cuda.current_stream().cuda_stream
        if g is None:
            err = lib.mercury_nll_fwd(z.data_ptr(), y.data_ptr(), out.data_ptr(), n, c, *geo,
                                      dtype, stream)
        else:
            err = lib.mercury_nll_bwd(z.data_ptr(), y.data_ptr(), g.data_ptr(), out.data_ptr(),
                                      n, c, *geo, dtype, stream)
        if err != 0:
            raise RuntimeError(f"launch refused: cudaError {err} at {geo}")

    return call


def nll_bwd_inputs(torch, n: int, seed: int = 1):
    """``[n]`` float32 g_i in [0.1, 1.1) on the card."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    return torch.rand(n, generator=g, device="cuda") + 0.1


def bf16_ulps(torch, got, want):
    """|got − want| in bf16 ulps of ``want`` (float32), for a bf16 ``got``."""
    _, e = torch.frexp(want.abs())
    return (got.float() - want).abs() / torch.ldexp(torch.ones_like(want), e - 8)


def nll_bwd_misfits(torch, got, want, want32=None):
    """nll_bwd's gradient ``got`` against the plain version's ``want`` (its
    float32 gradient before the cast, ``want32``, for bf16), as
    ``chip_smoke.py`` holds it: ``(misfits, one_ulp, max_abs_err)``. f32:
    misfits are the elements outside rtol 1e-5, atol 1e-6. bf16: the
    elements more than one bf16 ulp from ``want32`` (:func:`bf16_ulps` > 1;
    the JAX package's own ``_vjp_bwd`` keeps within it,
    ``tests/test_torch_port_ops.py``), and ``one_ulp`` counts the elements
    that differ from ``want`` (each by one ulp)."""
    err = float((got.float() - want.float()).abs().max()) if got.numel() else 0.0
    if want32 is None:
        return int((~torch.isclose(got, want, rtol=1e-5, atol=1e-6)).sum()), 0, err
    return (int((bf16_ulps(torch, got, want32) > 1).sum()), int((got != want).sum()), err)


# Inputs over which `compare` counts nll_bwd's gradients outside the
# smoke's limit of the plain version, at each shape and dtype.
NLL_MISS_SEEDS = 16


def nll_bwd_misses(torch, mk, reference, n: int, c: int, dtype) -> tuple[int, int]:
    """``(misfits, one_ulp)`` of ``mk.nll_bwd_kernel`` against
    ``reference.nll_backward`` as :func:`nll_bwd_misfits` counts them (the
    smoke's limit), summed over ``NLL_MISS_SEEDS`` inputs drawn as
    ``chip_smoke.py`` draws them. In bf16, a gradient whose float32 value
    lies near a rounding midpoint rounds the other way when the kernel's
    Σexp and the plain version's differ by an ulp: one of ``one_ulp``,
    inside the limit."""
    misfits = one_ulp = 0
    for seed in range(NLL_MISS_SEEDS):
        gen = torch.Generator(device="cuda").manual_seed(seed)
        z = (torch.randn(n, c, generator=gen, device="cuda") * 3).to(dtype)
        y = torch.randint(0, c, (n,), generator=gen, device="cuda", dtype=torch.int32)
        g = torch.rand(n, generator=gen, device="cuda") + 0.1
        want32 = None if dtype == torch.float32 else reference.nll_backward(z.float(), y, g)
        m, o, _ = nll_bwd_misfits(torch, mk.nll_bwd_kernel(z, y, g),
                                  reference.nll_backward(z, y, g), want32)
        misfits, one_ulp = misfits + m, one_ulp + o
    return misfits, one_ulp


def aten_nll_backward(torch, z, y64, g):
    """The 2 ATen calls that PyTorch's autograd of ``F.cross_entropy(z, y,
    reduction="none")`` runs for the gradient of ``[N, C]`` logits ``z``
    (``nll_loss_backward``, then ``_log_softmax_backward_data``), as one
    call. ``log_softmax(z)`` and the forward's total weight are made here,
    outside the call: the yardstick of ``nll_bwd``, used nowhere in the
    port."""
    logp = torch.nn.functional.log_softmax(z, 1)
    gz = g.to(z.dtype)
    total = torch.ops.aten.nll_loss_forward(logp, y64, None, 0, -100)[1]

    def call():
        return torch.ops.aten._log_softmax_backward_data(
            torch.ops.aten.nll_loss_backward(gz, logp, y64, None, 0, -100, total),
            logp, 1, z.dtype)

    return call


def nll_geometry_mode(torch, card: str):
    from mercury_tpu_torch.ops import _build, reference
    from mercury_tpu_torch.ops import mercury_kernels as mk

    lib = _build.load()
    rows = []
    for kernel in ("nll_fwd", "nll_bwd"):
        for n, c in NLL_SHAPES:
            for dtype in (torch.float32, torch.bfloat16):
                z, y = nll_inputs(torch, n, c, dtype)
                if kernel == "nll_fwd":
                    g = None
                    want = reference.nll_forward(z, y)
                else:
                    # Held against the plain version's float32 gradient: in
                    # bf16 a split that sums in another order may round a
                    # value the other way, one ulp (counted as `flips`).
                    g = nll_bwd_inputs(torch, n)
                    want = reference.nll_backward(z.float(), y, g)
                out = torch.empty(want.shape, dtype=z.dtype if g is not None else want.dtype,
                                  device=z.device)
                for vec in sorted({1, mk.nll_vec(c, z.element_size())}):
                    for lanes in NLL_LANES:
                        for threads in NLL_THREADS:
                            geo = mk.NllGeometry(lanes, threads, vec)
                            call = nll_launcher(torch, lib, z, y, out, geo, g)
                            out.fill_(float("nan"))
                            call()
                            torch.cuda.synchronize()
                            flips = 0
                            if g is not None:
                                want32 = want if dtype == torch.bfloat16 else None
                                misfits, flips, _ = nll_bwd_misfits(
                                    torch, out, want.to(dtype), want32)
                                assert misfits == 0, f"{kernel} [{n},{c}] {dtype} at {geo}"
                            else:
                                assert torch.allclose(out, want, rtol=1e-5, atol=1e-5), \
                                    f"{kernel} [{n},{c}] {dtype} at {geo}"
                            us = graph_us(torch, call)
                            name = str(dtype)[6:]
                            print(f"{kernel} [{n},{c}] {name} lanes={lanes} threads={threads} "
                                  f"vec={vec}: {us:.3f} us [{card}]"
                                  + (f" ({flips} bf16 flips)" if flips else ""), flush=True)
                            rows.append(dict(kernel=kernel, n=n, c=c, dtype=name, lanes=lanes,
                                             threads=threads, vec=vec, us=us, flips=flips))
    return rows


def build_variants(table: str, cuts_by_name):
    """Copies of ``csrc/mercury_kernels.cu``, the full one and one with each
    entry's cuts made, built side by side with ``nvcc`` in a directory of
    their ``table``'s own; their libraries. (Tables share variant names, and
    ``dlopen`` of a path already loaded returns the library loaded first.)"""
    from mercury_tpu_torch.ops import _build

    src = (_build.CSRC / "mercury_kernels.cu").read_text()
    build = _build.BUILD_DIR / "ablate" / table
    build.mkdir(parents=True, exist_ok=True)
    variants = {"full": src}
    for name, cuts in cuts_by_name.items():
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
    return libs


def ablate_mode(torch, card: str, kernels: str):
    from mercury_tpu_torch.ops import mercury_kernels as mk

    rows = []
    if kernels in ("all", "select"):
        libs = build_variants("select", ABLATIONS)
        for n in SIZES:
            for table in (False, True):
                geo = mk.draw_geometry(n, 64 if table else None, max_cluster=mk.cluster_limit())
                for name, lib in libs.items():
                    if name == "no_exchange" and geo.clusters == 1:
                        continue
                    us = graph_us(torch, launcher(torch, lib, n, geo, table)[0])
                    kernel = "table_refresh_draw" if table else "score_and_draw"
                    print(f"{kernel} n={n} K={geo.clusters} {name}: {us:.3f} us [{card}]",
                          flush=True)
                    rows.append(dict(kernel=kernel, n=n, clusters=geo.clusters, variant=name,
                                     us=us))
    if kernels in ("all", "ingest"):
        libs = build_variants("ingest", INGEST_ABLATIONS)
        for n in INGEST_SIZES:
            raw, mean, std, crop, flip, _ = ingest_inputs(torch, n)
            raw = raw[:n]
            out = torch.empty((n, 32, 32, 3), device=raw.device)
            for threads, band, copy in INGEST_ABLATION_SPLITS:
                geo = mk.IngestGeometry(threads, band, copy, mk.ingest_smem(32, 32, 3, band, 4, 4))
                for name, lib in libs.items():
                    call = ingest_launcher(torch, lib, raw, mean, std, crop, flip, out, geo)
                    us = graph_us(torch, call)
                    print(f"augment_normalize [{n}] float32 threads={threads} band={band} "
                          f"copy={copy} {name}: {us:.3f} us [{card}]", flush=True)
                    rows.append(dict(kernel="augment_normalize", n=n, threads=threads,
                                     band=band, copy=copy, variant=name, us=us))
    if kernels in ("all", "nll"):
        for kernel, cuts in (("nll_fwd", NLL_ABLATIONS), ("nll_bwd", NLL_BWD_ABLATIONS)):
            libs = build_variants(kernel, cuts)
            for n, c in NLL_SHAPES:
                for dtype in (torch.float32, torch.bfloat16):
                    z, y = nll_inputs(torch, n, c, dtype)
                    g = nll_bwd_inputs(torch, n) if kernel == "nll_bwd" else None
                    out = torch.empty(n, device=z.device) if g is None else torch.empty_like(z)
                    geo = mk.nll_geometry(n, c, z.element_size())
                    for name, lib in libs.items():
                        us = graph_us(torch, nll_launcher(torch, lib, z, y, out, geo, g))
                        print(f"{kernel} [{n},{c}] {str(dtype)[6:]} lanes={geo.lanes} "
                              f"threads={geo.threads} vec={geo.vec} {name}: {us:.3f} us "
                              f"[{card}]", flush=True)
                        rows.append(dict(kernel=kernel, n=n, c=c, dtype=str(dtype)[6:],
                                         lanes=geo.lanes, threads=geo.threads, vec=geo.vec,
                                         variant=name, us=us))
    return rows


def wrappers_mode(torch, card: str, kernels: str):
    """This process's checkout's wrappers (the same API in every version of
    the port) at the paths' shapes, the selections also at 50,000."""
    from mercury_tpu_torch.ops import mercury_kernels as mk
    from mercury_tpu_torch.ops import reference

    rows = []
    for n in SIZES if kernels in ("all", "select") else ():
        vals, slots, rscores, ema, u = inputs(torch, n)
        for name in ("score_and_draw", "table_refresh_draw"):
            if name == "score_and_draw":
                fn = lambda: mk.score_and_draw_kernel(vals, ema, u, 0.5)  # noqa: E731
            else:
                fn = lambda: mk.table_refresh_draw_kernel(  # noqa: E731
                    vals, slots, rscores, ema, u, 0.5, 0.98)
            rows.append(dict(kernel=name, n=n, us=graph_us(torch, fn)))
    fused_gather = "rows" in inspect.signature(mk.augment_normalize_kernel).parameters
    for n in INGEST_SIZES if kernels in ("all", "ingest") else ():
        raw_all, mean, std, crop, flip, idx = ingest_inputs(torch, n)
        raw = raw_all[:n]
        for dtype in (torch.float32, torch.bfloat16):
            fn = lambda: mk.augment_normalize_kernel(  # noqa: E731
                raw, mean, std, crop, flip, 4, dtype)
            rows.append(dict(kernel="augment_normalize", n=n, dtype=str(dtype)[6:],
                             us=graph_us(torch, fn)))
        # The step's ingest of n shard rows: the kernel's own gather where
        # the checkout has it, the x[rows] gather and the kernel otherwise.
        if fused_gather:
            fn = lambda: mk.augment_normalize_kernel(  # noqa: E731
                raw_all, mean, std, crop, flip, 4, torch.float32, rows=idx)
        else:
            fn = lambda: mk.augment_normalize_kernel(  # noqa: E731
                raw_all[idx], mean, std, crop, flip, 4, torch.float32)
        rows.append(dict(kernel="step_ingest", n=n, dtype="float32", us=graph_us(torch, fn)))
    for n, c in NLL_SHAPES if kernels in ("all", "nll") else ():
        for dtype in (torch.float32, torch.bfloat16):
            z, y = nll_inputs(torch, n, c, dtype)
            y64 = y.long()
            g = nll_bwd_inputs(torch, n)
            rows.append(dict(
                kernel="nll_fwd", n=n, c=c, dtype=str(dtype)[6:],
                us=graph_us(torch, lambda: mk.nll_fwd_kernel(z, y)),
                library_us=graph_us(torch, lambda: torch.nn.functional.cross_entropy(
                    z, y64, reduction="none")), library='F.cross_entropy(reduction="none")'))
            rows.append(dict(
                kernel="nll_bwd", n=n, c=c, dtype=str(dtype)[6:],
                us=graph_us(torch, lambda: mk.nll_bwd_kernel(z, y, g)),
                library_us=graph_us(torch, aten_nll_backward(torch, z, y64, g)),
                library="2 ATen calls",
                **dict(zip(("misses", "one_ulp"),
                           nll_bwd_misses(torch, mk, reference, n, c, dtype)))))
    return rows


def compare_mode(parent: Path, card: str, kernels: str):
    """Parent, this, this, parent: each run in its own process from its own
    checkout, so each builds and loads its own kernels."""
    runs = []
    for label, tree in (("parent", parent), ("this", ROOT), ("this", ROOT), ("parent", parent)):
        out = subprocess.run([sys.executable, str(Path(__file__).resolve()), "wrappers",
                              "--tree", str(tree), "--kernels", kernels],
                             capture_output=True, text=True, cwd=tree)
        if out.returncode != 0:
            raise RuntimeError(f"{label} run failed:\n{out.stderr[-4000:]}")
        rows = json.loads(out.stdout.strip().splitlines()[-1])
        for row in rows:
            print(f"{label:>6} {row['kernel']} n={row['n']}"
                  + (f" c={row['c']}" if "c" in row else "")
                  + f" {row.get('dtype', '')}: {row['us']:.3f} us"
                  + (f", library {row['library_us']:.3f} us ({row['library']})"
                     if "library_us" in row else "")
                  + (f", {row['misses']} gradients outside the smoke's limit over "
                     f"{NLL_MISS_SEEDS} inputs" if "misses" in row else "")
                  + (f", {row['one_ulp']} one ulp off" if "one_ulp" in row else "")
                  + f" [{card}]", flush=True)
        runs.append(dict(label=label, rows=rows))
    return runs


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("mode", choices=("geometry", "ablate", "compare", "wrappers"))
    ap.add_argument("--parent", type=Path, help="compare: the other checkout's root")
    ap.add_argument("--tree", type=Path, help="wrappers: import the port from this root")
    ap.add_argument("--kernels", choices=("all", "select", "ingest", "nll"), default="all",
                    help="which kernels to measure")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("select_sweep: no CUDA device", file=sys.stderr)
        return 1
    if args.mode == "wrappers":
        sys.path.insert(0, str(args.tree or ROOT))
        print(json.dumps(wrappers_mode(torch, "", args.kernels)))
        return 0
    sys.path.insert(0, str(ROOT))
    card = card_name()
    if args.mode == "compare":
        if args.parent is None:
            ap.error("compare needs --parent")
        result = compare_mode(args.parent.resolve(), card, args.kernels)
    elif args.mode == "geometry":
        result = []
        if args.kernels in ("all", "select"):
            result += geometry_mode(torch, card)
        if args.kernels in ("all", "ingest"):
            result += ingest_geometry_mode(torch, card)
        if args.kernels in ("all", "nll"):
            result += nll_geometry_mode(torch, card)
    else:
        result = ablate_mode(torch, card, args.kernels)
    OUT_DIR.mkdir(exist_ok=True)
    (OUT_DIR / f"select_sweep_{args.mode}.json").write_text(
        json.dumps({"card": card, "result": result}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
