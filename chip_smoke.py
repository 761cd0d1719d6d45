#!/usr/bin/env python3
"""On-card smoke test of the PyTorch port (``mercury_tpu_torch``).

    python3 chip_smoke.py [--profile]

Needs one CUDA card, ``nvcc`` and ``nvidia-smi``. In order:

1. prints the card (``torch.cuda.get_device_name`` and ``nvidia-smi``'s
   name and power limit);
2. builds the CUDA kernels from ``mercury_tpu_torch/ops/csrc/`` (timed,
   with ``ptxas``'s register and spill report);
3. holds each kernel against its plain PyTorch version on the card at the
   main path's shapes and a few larger ones, and times kernel, plain version
   and (where one exists) the one-call PyTorch equivalent;
4. drives the main path: ``Trainer(TrainConfig(model="resnet18",
   dataset="synthetic", world_size=1))`` at full width (batch 32, pool 320,
   bf16, importance sampling on) for 30 steps, with the kernels' launch
   counts zeroed just before and read just after; checks the losses are
   finite, the launch counts, that the scoring forward leaves the BN
   running statistics alone, and one step with kernels against the same
   step with the plain versions.

``--profile`` adds a ``torch.profiler`` window over a few main-path steps
and the uniform-sampling arm's step rate (see :func:`profile_phase`).

Any failed check exits non-zero. The second-to-last line of stdout is the
``kernels`` JSON object, the last ``{"ok": true, "device": {...}}``. The
per-case details go to ``chiprun_out/chip_smoke.json``.
"""

from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
OUT_DIR = ROOT / "chiprun_out"

# H100 SXM data sheet: HBM3 rate and float32 (non-tensor-core) peak.
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12

MAIN_STEPS = 30
WARMUP_STEPS = 3
TIMED_CALLS = 50      # kernel calls captured in one CUDA graph
TIMED_REPLAYS = 20    # replays of that graph, median taken
SOURCE = "mercury_tpu_torch/ops/csrc/mercury_kernels.cu"
REPLACES = {
    "nll_fwd": "mercury_tpu/ops/mercury_kernels.py:82",
    "nll_bwd": "mercury_tpu/ops/mercury_kernels.py:127",
    "score_and_draw": "mercury_tpu/ops/mercury_kernels.py:279",
}


class SmokeFailure(Exception):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the GPU only",
              file=sys.stderr)
        return 1
    # Fails here when the script stands alone, without the package.
    from mercury_tpu_torch.ops import _build

    card = run_phase("device", device_phase, torch)
    build_s, ptxas = run_phase("build", build_phase, _build)
    print(f"build: {build_s:.1f} s (nvcc, sm_90a)")
    for line in ptxas.splitlines():
        if "registers" in line or "spill" in line:
            print(f"  ptxas: {line.strip()}")
    kernels, cases = run_phase("kernels", kernel_phase, torch, card)
    main_path = run_phase("main path", main_path_phase, torch, card, kernels)

    OUT_DIR.mkdir(exist_ok=True)
    (OUT_DIR / "chip_smoke.json").write_text(json.dumps(
        {"card": card, "build_s": build_s, "kernels": kernels,
         "cases": cases, "main_path": main_path}, indent=1))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def run_phase(name, fn, *args):
    print(f"== {name}", flush=True)
    t0 = time.perf_counter()
    out = fn(*args)
    print(f"   {name}: passed in {time.perf_counter() - t0:.1f} s", flush=True)
    return out


# ------------------------------------------------------------------ phase 1
def device_phase(torch) -> str:
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.device_count()} device(s), "
          f"device 0: {torch.cuda.get_device_name(0)}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    card = smi.stdout.strip().splitlines()[0].strip()
    print(card)
    return card


# ------------------------------------------------------------------ phase 2
def build_phase(_build):
    t0 = time.perf_counter()
    _build.build(verbose=True)
    _build.load()
    return time.perf_counter() - t0, _build.build_log


# ------------------------------------------------------------------ phase 3
def graph_ms(torch, fn) -> float:
    """Device time of one call: TIMED_CALLS calls captured in a CUDA graph
    and replayed between CUDA events, so the host's launch cost is out of
    the number; median over TIMED_REPLAYS replays."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(TIMED_CALLS):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(TIMED_REPLAYS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / TIMED_CALLS)
    return statistics.median(times)


def eager_ms(torch, fn, calls: int = 200) -> float:
    """Time per call on the stream when called one by one from Python:
    what the eager main path pays, host launch cost included."""
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(calls):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / calls


def bound(bytes_moved: float, ops: float):
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def within(got, want, rtol: float, atol: float) -> float:
    """Max |got − want|; fails unless |got − want| ≤ atol + rtol·|want|."""
    got, want = got.float(), want.float()
    err = (got - want).abs()
    check(bool((err <= atol + rtol * want.abs()).all()),
          f"max |err| {float(err.max()):.3e} over atol {atol} + rtol {rtol}")
    return float(err.max()) if err.numel() else 0.0


def kernel_phase(torch, card: str):
    import torch.nn.functional as F

    from mercury_tpu_torch.ops import mercury_kernels as mk
    from mercury_tpu_torch.ops import reference

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    cases = []

    def logits_case(n, c, dtype):
        z = (torch.randn(n, c, generator=gen, device=dev) * 3).to(dtype)
        y = torch.randint(0, c, (n,), generator=gen, device=dev, dtype=torch.int32)
        return z, y

    # nll_fwd: expf/logf against ATen's exp/log, reductions in another
    # order; losses are O(10).
    fwd_tol = dict(rtol=1e-5, atol=1e-5)
    for n, c, dtype in [(320, 10, torch.float32), (32, 10, torch.float32),
                        (4096, 100, torch.float32), (320, 10, torch.bfloat16),
                        (32, 10, torch.bfloat16), (4096, 100, torch.bfloat16)]:
        z, y = logits_case(n, c, dtype)
        err = within(mk.nll_fwd_kernel(z, y), reference.nll_forward(z, y), **fwd_tol)
        y64 = y.long()
        case = dict(kernel="nll_fwd", shape=[n, c], dtype=str(dtype)[6:],
                    max_abs_err=err, tol=fwd_tol,
                    ms=graph_ms(torch, lambda: mk.nll_fwd_kernel(z, y)),
                    eager_ms=eager_ms(torch, lambda: mk.nll_fwd_kernel(z, y)),
                    plain_ms=graph_ms(torch, lambda: reference.nll_forward(z, y)),
                    library_ms=graph_ms(torch, lambda: F.cross_entropy(
                        z, y64, reduction="none")))
        esize = z.element_size()
        case["bound_ms"], case["bound_by"] = bound(n * c * esize + 8 * n,
                                                   5 * n * c + 2 * n)
        cases.append(case)

    # nll_bwd: f32 to ~1 ulp of softmax; bf16 output rounds once more
    # (one bf16 ulp, 2^-8 relative).
    for n, c, dtype in [(32, 10, torch.float32), (4096, 100, torch.float32),
                        (32, 10, torch.bfloat16), (4096, 100, torch.bfloat16)]:
        z, y = logits_case(n, c, dtype)
        g = torch.rand(n, generator=gen, device=dev) + 0.1
        tol = (dict(rtol=1e-5, atol=1e-6) if dtype == torch.float32
               else dict(rtol=2 ** -8, atol=1e-6))
        got = mk.nll_bwd_kernel(z, y, g)
        check(got.dtype == dtype, f"nll_bwd returned {got.dtype}, not {dtype}")
        err = within(got, reference.nll_backward(z, y, g), **tol)
        case = dict(kernel="nll_bwd", shape=[n, c], dtype=str(dtype)[6:],
                    max_abs_err=err, tol=tol,
                    ms=graph_ms(torch, lambda: mk.nll_bwd_kernel(z, y, g)),
                    eager_ms=eager_ms(torch, lambda: mk.nll_bwd_kernel(z, y, g)),
                    plain_ms=graph_ms(torch, lambda: reference.nll_backward(z, y, g)),
                    library_ms=None)
        esize = z.element_size()
        case["bound_ms"], case["bound_by"] = bound(2 * n * c * esize + 8 * n,
                                                   7 * n * c + 2 * n)
        cases.append(case)

    # The autograd route: per_sample_nll(...).backward runs the bwd kernel.
    z, y = logits_case(32, 10, torch.float32)
    zk = z.clone().requires_grad_()
    mk.per_sample_nll(zk, y).mean().backward()
    within(zk.grad, reference.nll_backward(z, y, torch.full((32,), 1 / 32, device=dev)),
           rtol=1e-5, atol=1e-7)

    for n, skew in [(320, False), (1000, False), (50000, False), (320, True)]:
        cases.append(draw_case(torch, mk, reference, gen, n, 32, skew))

    for c in cases:
        print(f"{c['kernel']:>14} {str(c['shape']):>12} {c.get('dtype', ''):>8}: "
              f"max|err| {c['max_abs_err']:.2e}"
              + (f", {c['in_band']} u in band {c['band']:.1e}, "
                 f"{c['mismatches']} index mismatches" if "band" in c else "")
              + f"; kernel {c['ms'] * 1e3:.2f} us (eager {c['eager_ms'] * 1e3:.2f} us), "
              f"plain {c['plain_ms'] * 1e3:.2f} us, library "
              + (f"{c['library_ms'] * 1e3:.2f} us" if c["library_ms"] else "none")
              + f", bound {c['bound_ms'] * 1e3:.4f} us ({c['bound_by']}) [{card}]")

    # One entry per kernel at the main path's shape: [320, 10] f32 logits
    # (scoring; the [32, 10] train forward is the smaller call), [32, 10]
    # f32 for the backward, a pool of 320 drawn to 32.
    main_shape = {"nll_fwd": [320, 10], "nll_bwd": [32, 10],
                  "score_and_draw": [320, 32]}
    kernels = []
    for name in mk.KERNELS:
        c = next(c for c in cases if c["kernel"] == name
                 and c["shape"] == main_shape[name]
                 and c.get("dtype", "float32") == "float32" and not c.get("skew"))
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCE,
            "replaces": REPLACES[name], "launches": None,
            "max_abs_err": c["max_abs_err"], "ms": c["ms"],
            "plain_ms": c["plain_ms"], "bound_ms": c["bound_ms"],
            "bound_by": c["bound_by"], "library_ms": c["library_ms"],
            "shape": c["shape"], "eager_ms": c["eager_ms"],
        })
    return kernels, cases


def draw_case(torch, mk, reference, gen, n: int, b: int, skew: bool):
    """score_and_draw against cumsum + searchsorted(right) + clamp on the
    card. probs: the total is summed in another order (rtol 1e-5 at up to
    50000 terms). Indices: equal, except that a u within δ of a CDF value
    may land one index over, δ = max(1e-6, 4·max|cdf_f32 − cdf_f64|)."""
    dev = torch.device("cuda")
    if skew:
        losses = torch.zeros(n, device=dev)
        losses[0] = 100.0
        ema, alpha = torch.zeros((), device=dev), 0.0
        u = torch.rand(b, generator=gen, device=dev)
        u[-2], u[-1] = 1.0 - 2 ** -24, 1.0
    else:
        losses = -torch.log(torch.rand(n, generator=gen, device=dev))
        ema, alpha = torch.tensor(0.8, device=dev), 0.5
        u = torch.rand(b, generator=gen, device=dev)
    ema1 = ema.reshape(1)
    probs, sel, scaled = mk.score_and_draw_kernel(losses, ema1, u, alpha)
    p_ref, s_ref, c_ref = reference.score_and_draw(losses, ema, u, alpha)
    err = within(probs, p_ref, rtol=1e-5, atol=0.0)

    cdf64 = torch.cumsum(probs.double(), 0)
    cdf32 = torch.cumsum(probs, 0)
    band = max(1e-6, 4 * float((cdf32.double() - cdf64).abs().max()))
    dist = (cdf64[None, :] - u.double()[:, None]).abs().min(dim=1).values
    in_band = int((dist < band).sum())
    differ = sel != s_ref
    for k in differ.nonzero().flatten().tolist():
        a, c = int(sel[k]), int(s_ref[k])
        check(abs(a - c) == 1 and abs(float(cdf64[min(a, c)]) - float(u[k])) < band,
              f"score_and_draw N={n}: draw {k} gave {a}, plain {c}, u={float(u[k])!r}")
    check(int(sel.min()) >= 0 and int(sel.max()) < n, "index out of the pool")
    same = ~differ
    err = max(err, within(scaled[same], c_ref[same], rtol=1e-5, atol=0.0))
    if skew:
        check(sel[:-1].eq(0).all().item() and int(sel[-1]) == n - 1,
              f"skewed pool: expected 0s then the clamp to {n - 1}, got {sel.tolist()}")

    fn = lambda: mk.score_and_draw_kernel(losses, ema1, u, alpha)  # noqa: E731
    case = dict(kernel="score_and_draw", shape=[n, b], skew=skew,
                max_abs_err=err, band=band, in_band=in_band,
                mismatches=int(differ.sum()),
                ms=graph_ms(torch, fn), eager_ms=eager_ms(torch, fn),
                plain_ms=graph_ms(torch, lambda: reference.score_and_draw(
                    losses, ema, u, alpha)),
                library_ms=None)
    search = b * math.ceil(math.log2(n + 1))
    case["bound_ms"], case["bound_by"] = bound(8 * n + 4 + 12 * b, 4 * n + 2 * search)
    return case


# ------------------------------------------------------------------ phase 4
def main_path_phase(torch, card: str, kernels):
    from mercury_tpu_torch import Trainer, TrainConfig
    from mercury_tpu_torch.ops import mercury_kernels as mk
    from mercury_tpu_torch.train.step import make_draws, to_nchw
    from mercury_tpu_torch.data.pipeline import normalize_images

    config = TrainConfig(model="resnet18", dataset="synthetic", world_size=1)
    check(config.candidate_pool_size == 320 and config.batch_size == 32
          and config.compute_dtype == "bfloat16" and config.use_importance_sampling,
          f"unexpected default config {config}")
    t0 = time.perf_counter()
    trainer = Trainer(config)
    model = trainer.state.model
    n_params = sum(p.numel() for p in model.parameters())
    check(n_params == 11_173_962, f"ResNet-18 has {n_params} parameters")
    print(f"Trainer built in {time.perf_counter() - t0:.1f} s on "
          f"{trainer.device}: ResNet-18, {n_params} parameters")

    # The scoring forward (train-mode, keep_stats=False) at the pool's
    # shape leaves the running statistics alone; a train step moves them.
    def running_stats():
        return {k: v.clone() for k, v in model.state_dict().items() if "running_" in k}

    before = running_stats()
    ds = trainer.dataset
    with torch.no_grad(), torch.autocast("cuda", dtype=torch.bfloat16):
        raw = ds.x_train[:config.candidate_pool_size]
        model(to_nchw(normalize_images(raw, ds.mean, ds.std)), train=True,
              keep_stats=False)
    check(all(torch.equal(v, before[k]) for k, v in running_stats().items()),
          "the scoring forward changed BN running statistics")

    trainer.fit(WARMUP_STEPS)
    after = running_stats()
    check(all(not torch.equal(v, before[k]) for k, v in after.items()
              if k.endswith("running_mean")),
          "train steps left some BN running mean unchanged")

    mk.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses = [trainer.train_step()["train/loss"] for _ in range(MAIN_STEPS)]
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = dict(mk.launch_counts)
    losses = torch.stack(losses).float().cpu()
    check(bool(torch.isfinite(losses).all()), f"non-finite losses {losses.tolist()}")
    want = {"nll_fwd": 2 * MAIN_STEPS, "nll_bwd": MAIN_STEPS,
            "score_and_draw": MAIN_STEPS}
    check(counts == want, f"launch counts {counts}, expected {want}")
    for k in kernels:
        k["launches"] = counts[k["name"]]
    steps_s = MAIN_STEPS / dt
    print(f"main path: {MAIN_STEPS} steps in {dt:.3f} s = {steps_s:.2f} steps/s, "
          f"{steps_s * config.batch_size:.1f} trained images/s, "
          f"{steps_s * config.candidate_pool_size:.1f} scored candidates/s [{card}]")
    print(f"losses: first {losses[0].item():.4f}, last {losses[-1].item():.4f}, "
          f"launches {counts}")

    # One step from the same state and draws, kernels against plain
    # versions on the card. The bf16 forwards are the same calls on the
    # same inputs on both sides; the f32 NLL and draw arithmetic differ in
    # the last bits, so the losses agree to rtol 1e-4 and the draws match.
    draws = make_draws(trainer.state, config)
    state = trainer.state
    results = {}
    for use_kernels in (True, False):
        trainer.state = state.clone()
        results[use_kernels] = trainer.train_step(draws, use_kernels=use_kernels)
    trainer.state = state
    k_m, p_m = results[True], results[False]
    check(torch.equal(k_m["sampler/selected"], p_m["sampler/selected"]),
          "kernel and plain steps drew different batches")
    step_err = {}
    for key in ("train/loss", "train/pool_loss"):
        a, b = float(k_m[key]), float(p_m[key])
        step_err[key] = abs(a - b)
        check(math.isfinite(a) and abs(a - b) <= 1e-4 * abs(b),
              f"{key}: kernel step {a!r}, plain step {b!r}")
    print(f"kernel step vs plain step: |d loss| {step_err['train/loss']:.2e}, "
          f"|d pool_loss| {step_err['train/pool_loss']:.2e}, same draws")
    if "--profile" in sys.argv:
        profile_phase(torch, card, trainer, config, dt / MAIN_STEPS * 1e6)
    return {"steps": MAIN_STEPS, "seconds": dt, "steps_per_s": steps_s,
            "images_per_s": steps_s * config.batch_size,
            "candidates_per_s": steps_s * config.candidate_pool_size,
            "launches": counts, "first_loss": losses[0].item(),
            "last_loss": losses[-1].item(), "kernel_vs_plain": step_err,
            "card": card}


def profile_phase(torch, card: str, trainer, config, step_us: float) -> None:
    """``--profile`` only: where a main-path step's time goes
    (``torch.profiler`` over ten steps: device busy share, kernel
    launches per step, device time by kernel), and the uniform-sampling
    arm's step rate beside the importance-sampled one. Written to
    ``chiprun_out/chip_smoke_profile.json``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from mercury_tpu_torch import Trainer

    steps = 10
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            trainer.train_step()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    # Kernels only: the CPU ops that launched them, and user annotations
    # such as ``Optimizer.step#Adam.step`` on the device track, carry the
    # same device time again.
    rows = [(e.key, e.count, e.self_device_time_total)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0
            and not getattr(e, "is_user_annotation", False)]
    rows.sort(key=lambda r: -r[2])
    device_us = sum(r[2] for r in rows)
    launches = sum(r[1] for r in rows)
    print(f"profile: {steps} steps, wall {wall_us / steps:.1f} us/step, device busy "
          f"{device_us / steps:.1f} us/step ({100 * device_us / wall_us:.1f}% busy), "
          f"{launches / steps:.1f} kernels/step; against the unprofiled "
          f"{step_us:.1f} us/step the device is busy "
          f"{100 * device_us / steps / step_us:.1f}% [{card}]")
    for key, count, us in rows[:12]:
        print(f"  {us / steps:9.1f} us/step {count / steps:6.1f}/step  {key[:90]}")

    # The two arms in turns (is, uniform, uniform, is) on one card.
    arms = {"is": [], "uniform": []}
    for use_is in (True, False, False, True):
        arm = Trainer(config.replace(use_importance_sampling=use_is))
        arm.fit(WARMUP_STEPS)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        arm.fit(MAIN_STEPS)
        torch.cuda.synchronize()
        arms["is" if use_is else "uniform"].append(
            MAIN_STEPS / (time.perf_counter() - t0))
    print(f"arms (steps/s, in turns): importance sampling {arms['is']}, "
          f"uniform {arms['uniform']} [{card}]")
    OUT_DIR.mkdir(exist_ok=True)
    (OUT_DIR / "chip_smoke_profile.json").write_text(json.dumps({
        "card": card, "steps": steps, "wall_us_per_step": wall_us / steps,
        "device_us_per_step": device_us / steps, "busy_share": device_us / wall_us,
        "unprofiled_us_per_step": step_us,
        "busy_share_unprofiled": device_us / steps / step_us,
        "kernels_per_step": launches / steps, "arms_steps_per_s": arms,
        "by_kernel": [{"key": k, "count": c, "device_us": u} for k, c, u in rows],
    }, indent=1))


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke: FAIL: {e}", file=sys.stderr)
        sys.exit(1)
