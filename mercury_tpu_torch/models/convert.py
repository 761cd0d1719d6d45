"""Weights and sampler state carried across from the JAX package.

``params_from_flax`` maps a Flax model's variables — nested dicts of
arrays under Flax's names (``Conv_0``, ``BatchNorm_0``, ``BasicBlock_3``,
``InvertedResidual_10``, ``Dense_0``, ``OptimizedLSTMCell_2/hf``,
``block1/query``, ``pos_embed``, the experts' ``block0/moe/w_up``, …) —
onto the state dict of the unsharded port model of the same family
(``parallel/mesh.load_full_state_dict`` cuts it to a sharded rank's
slices, ``full_state_dict`` gathers them back; ``expert_shard`` cuts the
experts to an expert-parallel rank's). Conv kernels
go HWIO → OIHW (a depthwise ``[3, 3, 1, C]`` to ``[C, 1, 3, 3]``), Dense
kernels ``[in, out]`` → ``[out, in]``, BatchNorm ``scale/bias/mean/var``
→ ``weight/bias/running_mean/running_var``, LayerNorm ``scale/bias`` →
``weight/bias``; bare arrays (``pos_embed``, the experts' stacked
kernels and biases) as they are.

``jax_flat_order`` goes the other way for the parameters as one vector:
the index that puts the port's concatenated parameters in the order of
``ravel_pytree`` of the Flax ``params``, which the JAX package's ZeRO
chunks and int8 rows are cut from.

Both read one table a family (:data:`FLAX_NAMES`).
"""

from __future__ import annotations

import re
from typing import Any, Dict, List, Mapping, Optional, Tuple

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
# model's ``blocks`` (ResNet, MobileNetV2, Transformer), else the model's
# class where it has a row (the BiLSTM), else "" (SmallCNN, VGG). ``{i}``/
# ``{j}`` stand for an index and ``{g}`` for a lower-case name, the same on
# both sides; the first row that matches is taken. Flax numbers each layer
# kind in creation order within its module.
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
    # Flax creates the cells in call order: layer 1 forward, layer 1
    # backward, then layer 2's; {g} is a gate's kernel (ii … ho).
    "BiLSTMAttention": (
        ("cells.{i}.{g}", "OptimizedLSTMCell_{i}/{g}"),
        ("attn{i}.denses.{j}", "attn{i}/Dense_{j}"), ("fcs.{i}", "Dense_{i}")),
    # {g} is query, key, value or proj; {w} one of the experts' four bare
    # arrays (w_up, b_up, w_down, b_down).
    "TransformerBlock": (
        ("embed", "embed"), ("pos_embed", "pos_embed"),
        ("blocks.{i}.ln1", "block{i}/LayerNorm_0"), ("blocks.{i}.ln2", "block{i}/LayerNorm_1"),
        ("blocks.{i}.fc1", "block{i}/Dense_0"), ("blocks.{i}.fc2", "block{i}/Dense_1"),
        ("blocks.{i}.moe.gate", "block{i}/moe/gate"), ("blocks.{i}.moe.{w}", "block{i}/moe/{w}"),
        ("blocks.{i}.{g}", "block{i}/{g}"), ("norm", "LayerNorm_0"), ("head", "head")),
    "": (("convs.{i}", "Conv_{i}"), ("bns.{i}", "BatchNorm_{i}"), ("fcs.{i}", "Dense_{i}")),
}
# A Flax top-level name that tells a family without blocks of its own
# kind apart.
_MARKERS = {"OptimizedLSTMCell_0": "BiLSTMAttention", "pos_embed": "TransformerBlock"}
_PLACEHOLDERS = {"i": r"\d+", "j": r"\d+", "g": r"[a-z]+", "w": r"[wb]_(?:up|down)"}


def _match(name: str, table, src: int) -> Optional[str]:
    """``name`` (a port module name for ``src=0``, a "/"-joined Flax path
    for ``src=1``) in the other column of ``table``; None if no row
    matches."""
    for row in table:
        pattern = re.escape(row[src])
        for key, rx in _PLACEHOLDERS.items():
            pattern = pattern.replace(rf"\{{{key}\}}", f"(?P<{key}>{rx})")
        m = re.fullmatch(pattern, name)
        if m:
            return row[1 - src].format(**m.groupdict())
    return None


def _translate(name: str, table, src: int) -> str:
    """:func:`_match`, with KeyError if no row matches."""
    out = _match(name, table, src)
    if out is None:
        raise KeyError(f"no counterpart for {name!r} in the family's table")
    return out


def _kind(flax_name: str) -> str:
    return flax_name.rsplit("_", 1)[0]


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _flax_layers(tree: Mapping[str, Any], path: Tuple[str, ...] = ()):
    """``(path, leaves)`` of every layer of a Flax ``params`` tree: a dict
    of arrays (``kernel``, ``bias``, ``scale``), or a bare array (the
    Transformer's ``pos_embed``, the experts' ``w_up`` …)."""
    for name, sub in tree.items():
        if isinstance(sub, Mapping) and any(isinstance(v, Mapping) for v in sub.values()):
            yield from _flax_layers(sub, path + (name,))
        else:
            yield path + (name,), sub


def _layer(out: Dict[str, torch.Tensor], prefix: str, params, stats) -> None:
    """The port's tensors of one Flax layer: a conv kernel HWIO → OIHW, a
    Dense kernel ``[in, out]`` → ``[out, in]``, a norm's ``scale`` →
    ``weight``, BatchNorm's ``mean``/``var`` → ``running_mean``/
    ``running_var``, a bare array as it is."""
    if not isinstance(params, Mapping):
        out[prefix] = _t(params)
        return
    if "kernel" in params:
        k = _t(params["kernel"])
        out[f"{prefix}.weight"] = (k.permute(3, 2, 0, 1) if k.dim() == 4 else k.T).contiguous()
    if "scale" in params:
        out[f"{prefix}.weight"] = _t(params["scale"])
    if "bias" in params:
        out[f"{prefix}.bias"] = _t(params["bias"])
    if stats:
        out[f"{prefix}.running_mean"] = _t(stats["mean"])
        out[f"{prefix}.running_var"] = _t(stats["var"])


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
    blocks (none for SmallCNN and VGG) or by a marker (the BiLSTM's cells,
    the Transformer's ``pos_embed``)."""
    marked = [f for n, f in _MARKERS.items() if n in params]
    kinds = {_kind(n) for n in params} - set(_LAYERS)
    family = marked[0] if marked else (kinds.pop() if len(kinds) == 1 else "")
    if (kinds and not marked) or family not in FLAX_NAMES:
        blocks = sorted(n for n in params if _kind(n) not in _LAYERS)
        raise KeyError(f"no port counterpart for Flax modules {blocks}")
    out: Dict[str, torch.Tensor] = {}
    for path, layer_params in _flax_layers(params):
        stats = batch_stats
        for name in path:
            stats = stats.get(name, {})
        _layer(out, _translate("/".join(path), FLAX_NAMES[family], 1), layer_params, stats)
    return out


def expert_shard(state: Mapping[str, torch.Tensor], rank: int, size: int
                 ) -> Dict[str, torch.Tensor]:
    """``state`` (the state dict of a whole model or of a pipeline's
    stage) with each MoE layer's stacked expert leaves (``….moe.w_up``,
    ``b_up``, ``w_down``, ``b_down``) cut to the experts of rank ``rank``
    of an expert group of ``size``, ``[rank·E/size, (rank+1)·E/size)``:
    what ``models.moe.bind_expert_group`` leaves the rank (JAX's
    ``P(ep)`` on the expert axis of the leaves it names by their place in
    a ``moe`` module)."""
    from mercury_tpu_torch.models.moe import EXPERT_LEAVES, expert_slice

    def cut(name: str, v: torch.Tensor) -> torch.Tensor:
        module, _, leaf = name.rpartition(".")
        if module.rpartition(".")[2] == "moe" and leaf in EXPERT_LEAVES:
            return expert_slice(v, rank, size)
        return v

    return {k: cut(k, v) for k, v in state.items()}


def _family(model: torch.nn.Module) -> str:
    blocks = getattr(model, "blocks", None)
    if blocks:
        return type(blocks[0]).__name__
    # The class or the nearest base with a row (a subclass keeps its table).
    return next((cls.__name__ for cls in type(model).__mro__ if cls.__name__ in FLAX_NAMES), "")


def flax_leaves(model: torch.nn.Module) -> List[Tuple[str, Tuple[str, ...], Tuple[int, ...]]]:
    """``(name, flax_path, axes)`` of each parameter in
    ``model.named_parameters()`` order: its path in the Flax ``params``
    tree (``("block0", "query", "kernel")``, ``("pos_embed",)``) and, for
    each dimension of the Flax leaf, the torch dimension it is: conv
    kernels HWIO ← OIHW ``(2, 3, 1, 0)``, Dense kernels ``[in, out]`` ←
    ``[out, in]`` ``(1, 0)``, every other leaf as it is."""
    table = FLAX_NAMES[_family(model)]
    out = []
    for name, p in model.named_parameters():
        module, _, leaf = name.rpartition(".")
        bare = _match(name, table, 0)
        if bare is not None:
            # A bare parameter (the positional embedding, the experts'
            # stacked arrays), in Flax's layout already.
            out.append((name, tuple(bare.split("/")), tuple(range(p.dim()))))
            continue
        path = tuple(_translate(module, table, 0).split("/"))
        axes = {4: (2, 3, 1, 0), 2: (1, 0)}.get(p.dim(), tuple(range(p.dim())))
        weighted = isinstance(model.get_submodule(module), (torch.nn.Conv2d, torch.nn.Linear))
        flax_leaf = "bias" if leaf == "bias" else ("kernel" if weighted else "scale")
        out.append((name, path + (flax_leaf,), axes))
    return out


def jax_flat_order(model: torch.nn.Module) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(order, inverse)``, int64 ``[n]`` on the model's device:
    ``port_vec[order]`` is ``ravel_pytree`` of the Flax model's ``params``
    and ``jax_vec[inverse]`` the port's vector back, where ``port_vec`` is
    ``torch.cat([p.reshape(-1) for p in model.parameters()])``.

    ``ravel_pytree`` takes the leaves in sorted-key order at every level
    (``BasicBlock_10`` before ``BasicBlock_2``; ``BatchNorm_*`` before
    ``Conv_*``; ``bias`` before ``kernel`` and ``scale``; an LSTM cell's
    ``hf, hg, hi, ho, if, ig, ii, io``), each raveled in its Flax layout:
    conv kernels HWIO, Dense kernels ``[in, out]``."""
    leaves: List[Tuple[Tuple[str, ...], torch.Tensor]] = []
    offset = 0
    params = dict(model.named_parameters())
    for name, path, axes in flax_leaves(model):
        p = params[name]
        idx = torch.arange(offset, offset + p.numel()).view(p.shape)
        offset += p.numel()
        leaves.append((path, idx.permute(*axes).reshape(-1)))
    order = torch.cat([idx for _, idx in sorted(leaves, key=lambda leaf: leaf[0])])
    inverse = torch.empty_like(order)
    inverse[order] = torch.arange(offset)
    device = next(model.parameters()).device
    return order.to(device), inverse.to(device)
