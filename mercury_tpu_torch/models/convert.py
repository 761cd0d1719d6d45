"""Weights and sampler state carried across from the JAX package.

``params_from_flax`` maps the Flax ResNet's variables — nested dicts of
arrays under Flax's automatic names (``Conv_0``, ``BatchNorm_0``,
``BasicBlock_3``, ``Dense_0``, …) — onto the state dict of the port's
:class:`~mercury_tpu_torch.models.resnet.ResNet`. Conv kernels go HWIO →
OIHW, Dense kernels ``[in, out]`` → ``[out, in]``, BatchNorm
``scale/bias/mean/var`` → ``weight/bias/running_mean/running_var``.

``jax_flat_order`` goes the other way for the parameters as one vector:
the index that puts the port's concatenated parameters in the order of
``ravel_pytree`` of the Flax ``params``, which the JAX package's ZeRO
chunks and int8 rows are cut from.
"""

from __future__ import annotations

import re
from typing import Any, Dict, List, Mapping, Tuple

import numpy as np
import torch

from mercury_tpu_torch.sampling.groupwise import GroupwiseState
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
# Port parameter name → Flax leaf name, by Flax layer kind.
_LEAVES = {("Conv", "weight"): "kernel", ("Dense", "weight"): "kernel",
           ("Dense", "bias"): "bias", ("BatchNorm", "weight"): "scale",
           ("BatchNorm", "bias"): "bias"}


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


def groupwise_from_jax(importance, group, cursor, generation,
                       device=None) -> GroupwiseState:
    """The port's groupwise state from the JAX package's ``GroupwiseState``
    of one worker: ``importance`` ``[L]``, ``group`` ``[L]``, ``cursor``
    and ``generation`` as numpy values."""
    return GroupwiseState(
        importance=torch.tensor(np.asarray(importance, dtype=np.float32), device=device),
        group=torch.tensor(np.asarray(group, dtype=np.int32), device=device),
        cursor=int(np.asarray(cursor)), generation=int(np.asarray(generation)))


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


def _flax_path(name: str, block: str) -> Tuple[str, ...]:
    """The Flax ``params`` path of the port's parameter ``name`` in a
    ResNet of ``block`` ("BasicBlock" or "Bottleneck") blocks."""
    *modules, leaf = name.split(".")
    if modules[0] == "blocks":
        layer = {v: k for k, v in _BLOCK_NAMES[block].items()}[modules[2]]
        path: Tuple[str, ...] = (f"{block}_{modules[1]}", layer)
    else:
        layer = {v: k for k, v in _TOP_NAMES.items()}[modules[0]]
        path = (layer,)
    return path + (_LEAVES[layer.split("_")[0], leaf],)


def jax_flat_order(model: torch.nn.Module) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(order, inverse)``, int64 ``[n]`` on the model's device:
    ``port_vec[order]`` is ``ravel_pytree`` of the Flax ResNet's ``params``
    and ``jax_vec[inverse]`` the port's vector back, where ``port_vec`` is
    ``torch.cat([p.reshape(-1) for p in model.parameters()])``.

    ``ravel_pytree`` takes the leaves in sorted-key order at every level
    (``BasicBlock_10`` before ``BasicBlock_2``; ``BatchNorm_*`` before
    ``Conv_*``; ``bias`` before ``kernel`` and ``scale``), each raveled in
    its Flax layout: conv kernels HWIO, the Dense kernel ``[in, out]``."""
    block = type(model.blocks[0]).__name__
    leaves: List[Tuple[Tuple[str, ...], torch.Tensor]] = []
    offset = 0
    for name, p in model.named_parameters():
        path = _flax_path(name, block)
        idx = torch.arange(offset, offset + p.numel()).view(p.shape)
        if path[-2].startswith("Conv_"):
            idx = idx.permute(2, 3, 1, 0)  # OIHW → HWIO
        elif idx.dim() == 2:
            idx = idx.T  # [out, in] → [in, out]
        leaves.append((path, idx.reshape(-1)))
        offset += p.numel()
    order = torch.cat([idx for _, idx in sorted(leaves, key=lambda leaf: leaf[0])])
    inverse = torch.empty_like(order)
    inverse[order] = torch.arange(offset)
    device = next(model.parameters()).device
    return order.to(device), inverse.to(device)
