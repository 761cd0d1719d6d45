"""Throughput and MFU accounting on the log cadence — the PyTorch
counterpart of ``mercury_tpu/obs/accounting.py``.

- :data:`PEAK_FLOPS` and :func:`peak_flops`: the card's dense bf16 peak,
  by the name ``torch.cuda.get_device_name`` gives.
- :func:`flops_per_step`: one step's FLOPs, counted by
  ``torch.utils.flop_counter.FlopCounterMode`` on a ``meta`` copy of the
  model, so nothing of the trainer moves (the counterpart of the JAX
  package's ``analytic_flops_per_step``, which asks XLA's cost model).
- :class:`ThroughputMeter`: steps/s, examples/s and MFU between log
  ticks, as host floats ready to merge into the metric record.
"""

from __future__ import annotations

import copy
import time
from typing import Dict, List, Optional, Tuple

import torch

from mercury_tpu_torch.utils.logging import get_logger

_log = get_logger(__name__)

# Dense bf16 tensor-core peak, FLOP/s, by device name: the H100 SXM5 card
# (80 GB HBM3, 700 W) of NVIDIA's H100 data sheet, 989.4 TFLOP/s without
# sparsity.
PEAK_FLOPS = {
    "NVIDIA H100 80GB HBM3": 989.4e12,
}


def peak_flops(device_kind: Optional[str]) -> Optional[float]:
    """Peak FLOP/s of the card named ``device_kind``, or None for any name
    not in :data:`PEAK_FLOPS` (the CPU, another card): MFU then reads
    0.0."""
    if not device_kind:
        return None
    return PEAK_FLOPS.get(device_kind)


def scoring_forwards(config) -> List[Tuple[int, float]]:
    """The step's no-grad forwards as ``(rows, share of steps)``: the
    scoring forward of the pool (pool, pipelined, groupwise; under
    ``score_refresh_every=K`` on one step of K) or of the refresh window
    (the sync scoretable); none on the uniform arm or the async scoretable,
    whose scorer runs off the step. The probe adds a forward of the batch
    on one step of ``variance_probe_every``."""
    out: List[Tuple[int, float]] = []
    if config.use_importance_sampling and not config.use_async:
        if config.use_scoretable:
            out.append((config.refresh_size, 1.0))
        else:
            out.append((config.candidate_pool_size, 1.0 / config.score_refresh_every))
    if config.use_probe:
        out.append((config.batch_size, 1.0 / config.variance_probe_every))
    return out


def _meta_copy(model: torch.nn.Module) -> torch.nn.Module:
    """A copy of ``model`` whose parameters and buffers are ``meta``
    tensors of the same shapes: no memory copied, nothing of ``model``
    touched; its batch norm is local (no collective)."""
    from mercury_tpu_torch.models.resnet import set_sync_batch_norm

    memo = {}
    for p in model.parameters():
        memo[id(p)] = torch.nn.Parameter(torch.empty_like(p, device="meta"),
                                         requires_grad=p.requires_grad)
    for b in model.buffers():
        memo[id(b)] = torch.empty_like(b, device="meta")
    meta = copy.deepcopy(model, memo)
    set_sync_batch_norm(meta, False)
    return meta


def _conv_backward_flop(grad_out_shape, x_shape, w_shape, _bias, _stride,
                        _padding, _dilation, transposed, _output_padding, groups,
                        output_mask, out_shape=None, **kwargs) -> int:
    """``aten.convolution_backward``'s FLOPs with the weight gradient
    divided by ``groups``: PyTorch's own formula counts a grouped
    convolution's weight gradient as a dense one's, so a depthwise 3×3
    (MobileNetV2's) would count ``channels`` times its work."""
    from torch.utils.flop_counter import conv_flop_count

    def t(shape):
        return [shape[1], shape[0]] + list(shape[2:])

    count = 0
    if output_mask[0]:
        count += conv_flop_count(grad_out_shape, w_shape, x_shape, not transposed)
    if output_mask[1]:
        lhs, rhs = (grad_out_shape, x_shape) if transposed else (x_shape, grad_out_shape)
        count += conv_flop_count(t(lhs), t(rhs), t(w_shape), transposed=False) // groups
    return count


def flops_per_step(trainer) -> Optional[float]:
    """FLOPs of one of ``trainer``'s steps (a microstep under
    ``grad_accum_steps``), as ``FlopCounterMode`` counts them: the
    convolutions and matrix products at 2 FLOPs a multiply-add, of the
    no-grad forwards of :func:`scoring_forwards` (the scoring forward at
    the pool ``[P]``) and of the training forward and backward at the
    batch ``[B]`` (the backward computes no gradient of the images or
    sequences, so the first layer's input gradient is not counted; a grouped
    convolution's weight gradient counts its groups' work alone, as its
    forward does). Elementwise work, batch norm, the NLL and the selection
    are not counted, so the count is not XLA's ``cost_analysis``.

    The count runs a ``meta`` copy of the model at those shapes: the
    trainer's parameters, running statistics, EMA, step and generators stay
    as they were, and nothing runs on the card. The count depends on
    shapes alone, not on the step's dtype. At W>1 it is this rank's count
    (its batch and pool), so MFU is per card. None if counting fails."""
    from torch.utils.flop_counter import FlopCounterMode

    from mercury_tpu_torch.train.step import to_nchw

    config = trainer.config
    try:
        model = _meta_copy(trainer.state.model)
        sample = tuple(trainer.dataset.x_test.shape[1:])
        if config.augmentation == "iid":
            sample = (32, 32, sample[-1])

        def images(n: int) -> torch.Tensor:
            return to_nchw(torch.empty((n, *sample), dtype=torch.float32, device="meta"))

        total = 0.0
        mapping = {torch.ops.aten.convolution_backward: _conv_backward_flop}
        for rows, share in scoring_forwards(config):
            with FlopCounterMode(display=False, custom_mapping=mapping) as counter, \
                    torch.no_grad():
                model(images(rows), train=True, keep_stats=False)
            total += counter.get_total_flops() * share
        x = images(config.batch_size)
        with FlopCounterMode(display=False, custom_mapping=mapping) as counter:
            logits = model(x, train=True, keep_stats=True)
            logits.float().sum().backward()
        total += counter.get_total_flops()
    except Exception as exc:
        _log.warning("FLOP count failed, perf/mfu reads 0.0: %s: %s",
                     type(exc).__name__, exc)
        return None
    return float(total) if total > 0 else None


class ThroughputMeter:
    """Rolling steps/s, examples/s and MFU between log ticks.

    ``tick(step, now)`` returns the ``perf/*`` and ``time/*`` scalars of
    the interval since the previous tick (or :meth:`reset`): host floats,
    no device work. ``examples_per_step`` is the global batch
    (``batch_size × world_size``). MFU is ``flops_per_step × steps/s``
    over the card's peak (:func:`peak_flops` of ``device_kind``); when
    either is unknown it reads 0.0, and the manifest's ``peak_flops:
    null`` marks it."""

    def __init__(self, examples_per_step: float,
                 flops_per_step: Optional[float] = None,
                 device_kind: Optional[str] = None) -> None:
        self.examples_per_step = float(examples_per_step)
        self.flops_per_step = flops_per_step
        self.peak = peak_flops(device_kind)
        self._last_step: Optional[int] = None
        self._last_t = 0.0

    def reset(self, step: int, now: Optional[float] = None) -> None:
        self._last_step = int(step)
        self._last_t = time.perf_counter() if now is None else now

    def tick(self, step: int, now: Optional[float] = None) -> Dict[str, float]:
        now = time.perf_counter() if now is None else now
        if self._last_step is None:
            self.reset(step, now)
            return {}
        dt = max(now - self._last_t, 1e-9)
        steps = max(step - self._last_step, 1)
        self._last_step, self._last_t = int(step), now
        steps_per_s = steps / dt
        out = {
            "perf/steps_per_s": steps_per_s,
            "perf/examples_per_s": steps_per_s * self.examples_per_step,
            "time/step": dt / steps,
            "time/images_per_sec": steps_per_s * self.examples_per_step,
        }
        if self.flops_per_step:
            out["perf/flops_per_step"] = self.flops_per_step
        mfu = 0.0
        if self.flops_per_step and self.peak:
            mfu = self.flops_per_step * steps_per_s / self.peak
        out["perf/mfu"] = mfu
        return out
