"""Public wrappers of the port's CUDA kernels.

- :func:`per_sample_nll` — per-sample cross-entropy ``[N]`` of ``[N, C]``
  logits, differentiable: a ``torch.autograd.Function`` whose backward is
  the ``nll_bwd`` kernel (the TPU package's custom VJP).
- :func:`score_and_draw` — smoothing, normalization, inverse-CDF draw and
  ``p·N`` gather of the pool selection, in one kernel.

Each wrapper dispatches on the device of its tensors: a CUDA tensor goes to
the kernel (built at first use by ``ops/_build.py``), a CPU tensor to the
plain version in ``ops/reference.py``. There is no fallback: a CUDA tensor
the kernel does not take, a failed build or a refused launch raises.

``launch_counts`` counts kernel launches by name, one per launch and
nowhere else, so a run can show that its main path went through the
kernels; :func:`reset_launch_counts` zeroes it.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from mercury_tpu_torch.ops import reference

KERNELS = ("nll_fwd", "nll_bwd", "score_and_draw")
launch_counts: Dict[str, int] = {k: 0 for k in KERNELS}

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def reset_launch_counts() -> None:
    for k in KERNELS:
        launch_counts[k] = 0


def _check(name: str, t: torch.Tensor, dtypes, ndim: int) -> None:
    if not t.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype not in dtypes:
        raise TypeError(f"{name}: dtype {t.dtype} not in {dtypes}")
    if t.dim() != ndim:
        raise ValueError(f"{name}: expected {ndim}-d, got shape {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: tensor must be contiguous")


def _launched(name: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: cudaError {err}")
    launch_counts[name] += 1


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _on_cpu(*tensors: torch.Tensor) -> bool:
    devices = {t.device.type for t in tensors}
    if devices == {"cpu"}:
        return True
    if devices == {"cuda"}:
        return False
    raise ValueError(f"tensors on {sorted(devices)}: expected all CPU or all CUDA")


def nll_fwd_kernel(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Launch ``nll_fwd``: ``[N, C]`` f32/bf16 logits, ``[N]`` int32 labels
    → ``[N]`` float32."""
    from mercury_tpu_torch.ops import _build

    _check("logits", logits, tuple(_DTYPE_CODES), 2)
    _check("labels", labels, (torch.int32,), 1)
    n, c = logits.shape
    if labels.shape[0] != n:
        raise ValueError(f"labels {tuple(labels.shape)} do not match logits {(n, c)}")
    out = torch.empty(n, dtype=torch.float32, device=logits.device)
    if n == 0:
        return out
    with torch.cuda.device(logits.device):
        err = _build.load().mercury_nll_fwd(
            logits.data_ptr(), labels.data_ptr(), out.data_ptr(), n, c,
            _DTYPE_CODES[logits.dtype], _stream(logits))
    _launched("nll_fwd", err)
    return out


def nll_bwd_kernel(logits: torch.Tensor, labels: torch.Tensor,
                   g: torch.Tensor) -> torch.Tensor:
    """Launch ``nll_bwd``: ``(softmax − onehot)·g`` in the logits' dtype."""
    from mercury_tpu_torch.ops import _build

    _check("logits", logits, tuple(_DTYPE_CODES), 2)
    _check("labels", labels, (torch.int32,), 1)
    _check("g", g, (torch.float32,), 1)
    n, c = logits.shape
    if labels.shape[0] != n or g.shape[0] != n:
        raise ValueError("labels and g must have one entry per logits row")
    grad = torch.empty_like(logits)
    if n == 0:
        return grad
    with torch.cuda.device(logits.device):
        err = _build.load().mercury_nll_bwd(
            logits.data_ptr(), labels.data_ptr(), g.data_ptr(), grad.data_ptr(),
            n, c, _DTYPE_CODES[logits.dtype], _stream(logits))
    _launched("nll_bwd", err)
    return grad


def score_and_draw_kernel(losses: torch.Tensor, ema_value: torch.Tensor,
                          uniforms: torch.Tensor, alpha: float
                          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch ``score_and_draw`` on ``[N]`` float32 losses, a one-element
    float32 EMA on the device (read there: no host sync) and ``[B]``
    float32 uniforms."""
    from mercury_tpu_torch.ops import _build

    _check("losses", losses, (torch.float32,), 1)
    _check("uniforms", uniforms, (torch.float32,), 1)
    if not ema_value.is_cuda or ema_value.dtype != torch.float32 or ema_value.numel() != 1:
        raise ValueError("ema_value must be a one-element float32 CUDA tensor")
    n, b = losses.shape[0], uniforms.shape[0]
    if n == 0:
        raise ValueError("score_and_draw needs a non-empty pool")
    dev = losses.device
    probs = torch.empty(n, dtype=torch.float32, device=dev)
    cdf = torch.empty(n, dtype=torch.float32, device=dev)  # scratch
    selected = torch.empty(b, dtype=torch.int32, device=dev)
    scaled = torch.empty(b, dtype=torch.float32, device=dev)
    if b == 0:
        return probs, selected, scaled
    with torch.cuda.device(dev):
        err = _build.load().mercury_score_and_draw(
            losses.data_ptr(), ema_value.data_ptr(), uniforms.data_ptr(),
            float(alpha), n, b, probs.data_ptr(), cdf.data_ptr(),
            selected.data_ptr(), scaled.data_ptr(), _stream(losses))
    _launched("score_and_draw", err)
    return probs, selected, scaled


class _PerSampleNLL(torch.autograd.Function):
    @staticmethod
    def forward(ctx, logits, labels):
        ctx.save_for_backward(logits, labels)
        if _on_cpu(logits, labels):
            return reference.nll_forward(logits, labels)
        return nll_fwd_kernel(logits, labels)

    @staticmethod
    def backward(ctx, g):
        logits, labels = ctx.saved_tensors
        # The incoming gradient may be a broadcast view (e.g. of a mean).
        g = g.to(torch.float32).contiguous()
        if _on_cpu(logits, labels):
            return reference.nll_backward(logits, labels, g), None
        return nll_bwd_kernel(logits, labels, g), None


def per_sample_nll(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Per-sample cross-entropy ``[N]`` float32 of ``[N, C]`` logits (f32 or
    bf16) and ``[N]`` int32 labels; differentiable in the logits."""
    return _PerSampleNLL.apply(logits, labels)


def score_and_draw(losses: torch.Tensor, ema_value, uniforms: torch.Tensor,
                   alpha: float = 0.5
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Pool selection from per-candidate losses and the updated EMA: returns
    ``(probs [N], selected [B] int32, scaled_probs [B] = p·N)``. ``uniforms``
    (``[B]`` or ``[1, B]``) are the draw's U(0,1) variates."""
    uniforms = uniforms.reshape(-1)
    ema_value = torch.as_tensor(ema_value, dtype=torch.float32,
                                device=losses.device)
    if _on_cpu(losses, uniforms):
        return reference.score_and_draw(losses, ema_value, uniforms, alpha)
    return score_and_draw_kernel(losses, ema_value.reshape(1), uniforms, alpha)
