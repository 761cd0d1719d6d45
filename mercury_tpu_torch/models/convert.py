"""Weights and sampler state carried across from the JAX package.

``params_from_flax`` maps a Flax image model's variables — nested dicts of
arrays under Flax's automatic names (``Conv_0``, ``BatchNorm_0``,
``BasicBlock_3``, ``InvertedResidual_10``, ``Dense_0``, …) — onto the state
dict of the port's model of the same family. Conv kernels go HWIO → OIHW
(a depthwise ``[3, 3, 1, C]`` to ``[C, 1, 3, 3]``), Dense kernels ``[in,
out]`` → ``[out, in]``, BatchNorm ``scale/bias/mean/var`` →
``weight/bias/running_mean/running_var``.

``jax_flat_order`` goes the other way for the parameters as one vector:
the index that puts the port's concatenated parameters in the order of
``ravel_pytree`` of the Flax ``params``, which the JAX package's ZeRO
chunks and int8 rows are cut from.

Both read one table a family (:data:`FLAX_NAMES`).
"""

from __future__ import annotations

import re
from typing import Any, Dict, List, Mapping, Tuple

import numpy as np
import torch

from mercury_tpu_torch.sampling.groupwise import GroupwiseState
from mercury_tpu_torch.sampling.scoretable import ScoreTableState

_LAYERS = ("Conv", "BatchNorm", "Dense")
_RESNET_TOP = (("conv", "Conv_0"), ("bn", "BatchNorm_0"), ("fc", "Dense_0"))


def _resnet_blocks(block: str, names) -> tuple:
    return tuple((f"blocks.{{i}}.{name}", f"{block}_{{i}}/{layer}_{n}")
                 for n, (conv, bn) in enumerate(names)
                 for name, layer in ((conv, "Conv"), (bn, "BatchNorm")))


# Port module name → Flax module path, by family: the class of the
# model's ``blocks`` (ResNet, MobileNetV2), "" for a model without blocks
# (SmallCNN, VGG). ``{i}``/``{j}`` stand for an index, the same on both
# sides. Flax numbers each layer kind in creation order within its module.
FLAX_NAMES: Dict[str, Tuple[Tuple[str, str], ...]] = {
    "BasicBlock": _RESNET_TOP + _resnet_blocks("BasicBlock", (
        ("conv1", "bn1"), ("conv2", "bn2"), ("down_conv", "down_bn"))),
    "Bottleneck": _RESNET_TOP + _resnet_blocks("Bottleneck", (
        ("conv1", "bn1"), ("conv2", "bn2"), ("conv3", "bn3"), ("down_conv", "down_bn"))),
    # The block's convs/bns are its Conv_j/BatchNorm_j: two at expand 1,
    # three otherwise.
    "InvertedResidual": (
        ("stem_conv", "Conv_0"), ("stem_bn", "BatchNorm_0"),
        ("blocks.{i}.convs.{j}", "InvertedResidual_{i}/Conv_{j}"),
        ("blocks.{i}.bns.{j}", "InvertedResidual_{i}/BatchNorm_{j}"),
        ("head_conv", "Conv_1"), ("head_bn", "BatchNorm_1"), ("fc", "Dense_0")),
    "": (("convs.{i}", "Conv_{i}"), ("bns.{i}", "BatchNorm_{i}"), ("fcs.{i}", "Dense_{i}")),
}
# Port parameter name → Flax leaf name, by Flax layer kind.
_LEAVES = {("Conv", "weight"): "kernel", ("Dense", "weight"): "kernel",
           ("Dense", "bias"): "bias", ("BatchNorm", "weight"): "scale",
           ("BatchNorm", "bias"): "bias"}


def _translate(name: str, table, src: int) -> str:
    """``name`` (a port module name for ``src=0``, a "/"-joined Flax path
    for ``src=1``) in the other column of ``table``; KeyError if no row
    matches."""
    for row in table:
        pattern = re.escape(row[src]).replace(r"\{i\}", r"(?P<i>\d+)").replace(
            r"\{j\}", r"(?P<j>\d+)")
        m = re.fullmatch(pattern, name)
        if m:
            return row[1 - src].format(**m.groupdict())
    raise KeyError(f"no counterpart for {name!r} in the family's table")


def _kind(flax_name: str) -> str:
    return flax_name.rsplit("_", 1)[0]


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
    """State dict of the port's model from a Flax model's ``params`` and
    ``batch_stats`` collections; the family is told by the names of its
    blocks (none for SmallCNN and VGG)."""
    kinds = {_kind(n) for n in params} - set(_LAYERS)
    family = kinds.pop() if len(kinds) == 1 else ""
    if kinds or family not in FLAX_NAMES:
        blocks = sorted(n for n in params if _kind(n) not in _LAYERS)
        raise KeyError(f"no port counterpart for Flax modules {blocks}")
    out: Dict[str, torch.Tensor] = {}
    for name, sub in params.items():
        stats = batch_stats.get(name, {})
        layers = ([(name, name, sub, stats)] if _kind(name) in _LAYERS else
                  [(f"{name}/{k}", k, v, stats.get(k, {})) for k, v in sub.items()])
        for path, layer, layer_params, layer_stats in layers:
            _layer(out, _translate(path, FLAX_NAMES[family], 1), layer, layer_params,
                   layer_stats)
    return out


def _family(model: torch.nn.Module) -> str:
    blocks = getattr(model, "blocks", None)
    return type(blocks[0]).__name__ if blocks else ""


def jax_flat_order(model: torch.nn.Module) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(order, inverse)``, int64 ``[n]`` on the model's device:
    ``port_vec[order]`` is ``ravel_pytree`` of the Flax model's ``params``
    and ``jax_vec[inverse]`` the port's vector back, where ``port_vec`` is
    ``torch.cat([p.reshape(-1) for p in model.parameters()])``.

    ``ravel_pytree`` takes the leaves in sorted-key order at every level
    (``BasicBlock_10`` before ``BasicBlock_2``; ``BatchNorm_*`` before
    ``Conv_*``; ``bias`` before ``kernel`` and ``scale``), each raveled in
    its Flax layout: conv kernels HWIO, Dense kernels ``[in, out]``."""
    table = FLAX_NAMES[_family(model)]
    leaves: List[Tuple[Tuple[str, ...], torch.Tensor]] = []
    offset = 0
    for name, p in model.named_parameters():
        module, leaf = name.rsplit(".", 1)
        path = tuple(_translate(module, table, 0).split("/"))
        kind = _kind(path[-1])
        idx = torch.arange(offset, offset + p.numel()).view(p.shape)
        if kind == "Conv":
            idx = idx.permute(2, 3, 1, 0)  # OIHW → HWIO
        elif idx.dim() == 2:
            idx = idx.T  # [out, in] → [in, out]
        leaves.append((path + (_LEAVES[kind, leaf],), idx.reshape(-1)))
        offset += p.numel()
    order = torch.cat([idx for _, idx in sorted(leaves, key=lambda leaf: leaf[0])])
    inverse = torch.empty_like(order)
    inverse[order] = torch.arange(offset)
    device = next(model.parameters()).device
    return order.to(device), inverse.to(device)
