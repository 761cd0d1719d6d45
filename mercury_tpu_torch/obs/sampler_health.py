"""Distribution-level sampler observability: the PyTorch counterpart of
``mercury_tpu/obs/sampler_health.py``.

The in-step half is torch on the device, and the step calls it only under
``config.telemetry``:

- :func:`log_bin_histogram`: a histogram over ``HIST_BINS`` log-spaced
  bins, the ends clamped, so its counts always total ``x.numel()``. The
  step returns the IS weights' histogram (``sampler_dist/w_hist/bNN``) and,
  on the scoretable path, the table's (``sampler_dist/score_hist/bNN``), a
  scalar a bin (:func:`hist_keys`);
- :func:`variance_probe_ratio`: the grad-variance probe's estimator of
  ``sampler_dist/var_ratio``.

The host half is numpy on arrays fetched at a log tick, a copy of the JAX
package's (whose package ``__init__`` imports JAX): the selection-count
ledger (``MercuryState.sel_counts``) summed to samples, a selection Gini,
the per-class selection spread and an inclusion-bias audit against the
table's current probabilities, merged into the log record by
:class:`SamplerHealthMonitor`.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Optional

import numpy as np
import torch

from mercury_tpu_torch.sampling.importance import SCORE_FLOOR

# --- in-step half -----------------------------------------------------------

#: Bins of every histogram; each bin is a metric key of its own.
HIST_BINS = 16
#: Edges of the score table's histogram: per-sample losses, floored at
#: 1e-12 and rarely above 1e2.
SCORE_HIST_LO, SCORE_HIST_HI = 1e-6, 1e2
#: Edges of the IS-weight histogram: ``scaled_probs = N·p``, 1.0 for the
#: uniform weight.
WEIGHT_HIST_LO, WEIGHT_HIST_HI = 1e-4, 1e4


def log_bin_histogram(x: torch.Tensor, lo: float, hi: float,
                      bins: int = HIST_BINS) -> torch.Tensor:
    """int32 counts of ``x`` over ``bins`` log-spaced bins spanning
    ``[lo, hi)``: bin ``floor((log(max(x, lo)) − log lo)/(log hi − log lo)
    ·bins)`` in float32, in the JAX package's order of operations, clamped
    to ``[0, bins)`` (so below ``lo`` counts in bin 0, ``hi`` and above and
    +inf in the last, NaN in bin 0, as in ``log_bin_histogram_np``). Built
    by ``index_add_`` into zeros: no ``bincount``, which reads its maximum
    back to the host on CUDA."""
    x = x.to(torch.float32).reshape(-1)
    lo_l, hi_l = math.log(lo), math.log(hi)
    pos = torch.floor((torch.log(torch.clamp(x, min=lo)) - lo_l) / (hi_l - lo_l) * bins)
    idx = torch.nan_to_num(pos.clamp_(0, bins - 1), nan=0.0).to(torch.int64)
    counts = torch.zeros(bins, dtype=torch.int32, device=x.device)
    return counts.index_add_(0, idx, torch.ones_like(idx, dtype=torch.int32))


def hist_keys(family: str, bins: int = HIST_BINS):
    """The metric keys of a histogram family, in bin order."""
    return tuple(f"sampler_dist/{family}/b{i:02d}" for i in range(bins))


def variance_probe_ratio(grad_norms: torch.Tensor, scaled_probs: torch.Tensor,
                         eps: float = 1e-30,
                         mean: Callable[[torch.Tensor], torch.Tensor] = torch.mean
                         ) -> torch.Tensor:
    """``sampler_dist/var_ratio`` of one IS-drawn batch: per-example
    gradient-norm bounds ``g_i`` and the draw's ``scaled_probs_i = N·p_i``.
    ``mean((g/(N·p))²)`` estimates the IS estimator's second moment and
    ``mean(g²/(N·p))`` the uniform one's; their ratio is < 1 where
    importance sampling wins, and exactly 1 for unit weights. ``mean`` is
    the step's pool mean at W>1, so both moments are pooled over the ranks
    before the ratio."""
    g = grad_norms.to(torch.float32)
    sp = torch.clamp(scaled_probs.to(torch.float32), min=eps)
    m_is = mean(torch.square(g / sp))
    m_unif = mean(torch.square(g) / sp)
    return m_is / torch.clamp(m_unif, min=eps)


# --- host half --------------------------------------------------------------


def log_bin_histogram_np(x, lo: float, hi: float, bins: int = HIST_BINS) -> np.ndarray:
    """Numpy reference of :func:`log_bin_histogram`: the same float32
    arithmetic and clamps."""
    x = np.asarray(x, np.float32).reshape(-1)
    lo_l, hi_l = math.log(lo), math.log(hi)
    idx_f = np.floor(
        (np.log(np.maximum(x, np.float32(lo))) - np.float32(lo_l))
        / np.float32(hi_l - lo_l) * np.float32(bins)
    )
    # Clip before the int cast: a float → int32 cast of +inf wraps in numpy.
    idx = np.nan_to_num(np.clip(idx_f, 0, bins - 1), nan=0.0).astype(np.int32)
    return np.bincount(idx, minlength=bins).astype(np.int32)


def hist_bin_edges(lo: float, hi: float, bins: int = HIST_BINS) -> np.ndarray:
    """The ``bins + 1`` log-spaced edges of the histograms, for axes."""
    return np.exp(np.linspace(math.log(lo), math.log(hi), bins + 1))


def ledger_global_counts(counts_wl: np.ndarray, shard_indices: np.ndarray,
                         n_samples: int) -> np.ndarray:
    """The ``[W, L]`` per-slot ledger summed to per-sample counts ``[n]``:
    a sample that owns several slots (cyclic tiling) or appears in several
    shards sums them."""
    out = np.zeros((n_samples,), np.int64)
    np.add.at(out, np.asarray(shard_indices).reshape(-1),
              np.asarray(counts_wl, np.int64).reshape(-1))
    return out


def gini(counts: np.ndarray) -> float:
    """Gini coefficient of the selection counts: 0 when every sample is
    drawn equally often, towards 1 when the draws fall on a vanishing
    share."""
    c = np.sort(np.asarray(counts, np.float64))
    n = c.size
    total = c.sum()
    if n == 0 or total <= 0:
        return 0.0
    cum = np.cumsum(c)
    return float((n + 1 - 2.0 * cum.sum() / total) / n)


def class_spread(counts_global: np.ndarray, labels: np.ndarray, num_classes: int,
                 starvation_share: float = 0.2) -> Dict[str, float]:
    """Each class's share of the draws over its share of the data (1.0:
    drawn in proportion); a class below ``starvation_share`` is starved."""
    labels = np.asarray(labels)
    counts_global = np.asarray(counts_global, np.float64)
    total = counts_global.sum()
    sel_per_class = np.zeros((num_classes,), np.float64)
    np.add.at(sel_per_class, labels, counts_global)
    data_per_class = np.bincount(labels, minlength=num_classes).astype(np.float64)
    present = data_per_class > 0
    if total <= 0 or not present.any():
        return {"class_share_min": 1.0, "class_share_max": 1.0, "class_starved": 0.0}
    ratio = (sel_per_class[present] / total) / (data_per_class[present] / labels.size)
    return {
        "class_share_min": float(ratio.min()),
        "class_share_max": float(ratio.max()),
        "class_starved": float(np.sum(ratio < starvation_share)),
    }


def bias_audit(counts_wl: np.ndarray, probs_wl: np.ndarray,
               threshold: float = 5.0) -> Dict[str, float]:
    """Observed per-slot selection counts against the table's current
    probabilities: ``mean((obs − exp)² / max(exp, 1))`` with ``exp =
    draws_w·p_w[slot]`` a rank row, about 1 while the draws track the
    table; ``bias_ok`` is 1.0 below ``threshold``."""
    counts = np.asarray(counts_wl, np.float64)
    probs = np.asarray(probs_wl, np.float64)
    if counts.ndim == 1:
        counts, probs = counts[None], probs[None]
    draws = counts.sum(axis=1, keepdims=True)
    if counts.size == 0 or draws.sum() <= 0:
        return {"bias_chi2": 0.0, "bias_ok": 1.0}
    exp = draws * probs
    stat = float(np.mean(np.square(counts - exp) / np.maximum(exp, 1.0)))
    return {"bias_chi2": stat, "bias_ok": 1.0 if stat < threshold else 0.0}


def table_probs_np(scores: np.ndarray, ema_value: np.ndarray, alpha: float) -> np.ndarray:
    """The table's draw probabilities a rank row (smoothed, floored,
    normalized) in float64: ``scores`` ``[W, L]``, ``ema_value`` ``[W]``."""
    smoothed = np.asarray(scores, np.float64) + alpha * np.asarray(
        ema_value, np.float64)[:, None]
    clipped = np.maximum(smoothed, SCORE_FLOOR)
    return clipped / clipped.sum(axis=1, keepdims=True)


def sparkline(values, width: Optional[int] = None) -> str:
    """A histogram as a Unicode sparkline (▁▂▃▄▅▆▇█); all-zero is flat."""
    blocks = "▁▂▃▄▅▆▇█"
    v = np.asarray(list(values), np.float64)
    if width is not None and v.size > width:
        v = v[:width]
    if v.size == 0:
        return ""
    top = v.max()
    if top <= 0:
        return blocks[0] * v.size
    idx = np.minimum((v / top * (len(blocks) - 1)).astype(int), len(blocks) - 1)
    return "".join(blocks[i] for i in idx)


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


class SamplerHealthMonitor:
    """The seven ledger-derived keys of a log record: the share of
    samples never selected, the selection Gini, the per-class spread and
    the bias audit. ``shard_indices`` is ``[W, L]`` (every rank's shard),
    ``labels`` the train split's."""

    def __init__(self, shard_indices: np.ndarray, labels: np.ndarray,
                 num_classes: int, is_alpha: float,
                 starvation_share: float = 0.2, bias_threshold: float = 5.0):
        self._sidx = np.asarray(shard_indices)
        self._labels = np.asarray(labels)
        self._n = int(self._labels.size)
        self._num_classes = int(num_classes)
        self._alpha = float(is_alpha)
        self._starvation_share = float(starvation_share)
        self._bias_threshold = float(bias_threshold)

    def stats(self, state) -> Dict[str, float]:
        """The keys of ``state``'s ledger, score table and EMA: a port
        ``MercuryState`` at one rank, or any object with ``sel_counts``
        ``[W, L]``, ``scoretable.scores`` ``[W, L]`` and ``ema.value``
        ``[W]`` (tensors or numpy arrays). No ledger: no keys."""
        if state.sel_counts is None:
            return {}
        table = state.scoretable
        return self.stats_of(_host(state.sel_counts),
                             None if table is None else _host(table.scores),
                             _host(state.ema.value))

    def stats_of(self, counts: np.ndarray, scores: Optional[np.ndarray] = None,
                 ema: Optional[np.ndarray] = None) -> Dict[str, float]:
        """The keys of a ``[W, L]`` (or one rank's ``[L]``) ledger; with the
        table's ``scores`` and the ``ema`` values also the bias audit."""
        counts = np.asarray(counts).reshape(-1, self._sidx.shape[-1])
        out: Dict[str, float] = {}
        global_counts = ledger_global_counts(counts, self._sidx, self._n)
        out["sampler_dist/frac_never_selected"] = float(np.mean(global_counts == 0))
        out["sampler_dist/gini"] = gini(global_counts)
        spread = class_spread(global_counts, self._labels, self._num_classes,
                              self._starvation_share)
        out["sampler_dist/class_share_min"] = spread["class_share_min"]
        out["sampler_dist/class_share_max"] = spread["class_share_max"]
        out["sampler_dist/class_starved"] = spread["class_starved"]
        if scores is not None:
            scores = np.asarray(scores).reshape(counts.shape)
            ema = np.asarray(ema).reshape(counts.shape[0])
            audit = bias_audit(counts, table_probs_np(scores, ema, self._alpha),
                               self._bias_threshold)
            out["sampler_dist/bias_chi2"] = audit["bias_chi2"]
            out["sampler_dist/bias_ok"] = audit["bias_ok"]
        return out
