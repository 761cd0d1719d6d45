"""Weights and sampler state carried across from the JAX package.

``params_from_flax`` maps the Flax ResNet's variables — nested dicts of
arrays under Flax's automatic names (``Conv_0``, ``BatchNorm_0``,
``BasicBlock_3``, ``Dense_0``, …) — onto the state dict of the port's
:class:`~mercury_tpu_torch.models.resnet.ResNet`. Conv kernels go HWIO →
OIHW, Dense kernels ``[in, out]`` → ``[out, in]``, BatchNorm
``scale/bias/mean/var`` → ``weight/bias/running_mean/running_var``.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Mapping

import numpy as np
import torch

from mercury_tpu_torch.sampling.scoretable import ScoreTableState

# Flax auto-names inside each block, in creation order, → port module names.
_BLOCK_NAMES = {
    "BasicBlock": {"Conv_0": "conv1", "BatchNorm_0": "bn1",
                   "Conv_1": "conv2", "BatchNorm_1": "bn2",
                   "Conv_2": "down_conv", "BatchNorm_2": "down_bn"},
    "Bottleneck": {"Conv_0": "conv1", "BatchNorm_0": "bn1",
                   "Conv_1": "conv2", "BatchNorm_1": "bn2",
                   "Conv_2": "conv3", "BatchNorm_2": "bn3",
                   "Conv_3": "down_conv", "BatchNorm_3": "down_bn"},
}
_TOP_NAMES = {"Conv_0": "conv", "BatchNorm_0": "bn", "Dense_0": "fc"}


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _layer(out: Dict[str, torch.Tensor], prefix: str, flax_name: str,
           params: Mapping[str, Any], stats: Mapping[str, Any]) -> None:
    if flax_name.startswith("Conv_"):
        out[f"{prefix}.weight"] = _t(params["kernel"]).permute(3, 2, 0, 1).contiguous()
    elif flax_name.startswith("Dense_"):
        out[f"{prefix}.weight"] = _t(params["kernel"]).T.contiguous()
        out[f"{prefix}.bias"] = _t(params["bias"])
    elif flax_name.startswith("BatchNorm_"):
        out[f"{prefix}.weight"] = _t(params["scale"])
        out[f"{prefix}.bias"] = _t(params["bias"])
        out[f"{prefix}.running_mean"] = _t(stats["mean"])
        out[f"{prefix}.running_var"] = _t(stats["var"])
    else:
        raise KeyError(f"no port counterpart for Flax layer {flax_name!r}")


def scoretable_from_jax(scores, cursor, device=None) -> ScoreTableState:
    """The port's score table from the JAX package's ``ScoreTableState``
    of one worker: ``scores`` ``[L]`` and ``cursor`` as numpy values."""
    return ScoreTableState(
        scores=torch.tensor(np.asarray(scores, dtype=np.float32), device=device),
        cursor=int(np.asarray(cursor)))


def params_from_flax(params: Mapping[str, Any],
                     batch_stats: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """State dict of the port's ResNet from the Flax ResNet's ``params``
    and ``batch_stats`` collections."""
    out: Dict[str, torch.Tensor] = {}
    for name, sub in params.items():
        stats = batch_stats.get(name, {})
        m = re.fullmatch(r"(BasicBlock|Bottleneck)_(\d+)", name)
        if m:
            names = _BLOCK_NAMES[m.group(1)]
            for layer, layer_params in sub.items():
                _layer(out, f"blocks.{m.group(2)}.{names[layer]}", layer,
                       layer_params, stats.get(layer, {}))
        elif name in _TOP_NAMES:
            _layer(out, _TOP_NAMES[name], name, sub, stats)
        else:
            raise KeyError(f"no port counterpart for Flax module {name!r}")
    return out
