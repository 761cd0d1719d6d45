"""The Transformer sequence classifier of ``mercury_tpu/models/transformer.py``
and its vision mode (ViT): a pre-LN encoder over ``[B, T, F]`` features (or
an image's patches), mean-pooled into a linear head.

As the Flax modules: LayerNorm with epsilon 1e-6 (statistics in float32,
output in the input's dtype), separate ``query``/``key``/``value`` Denses,
the tanh-approximated GELU, a learned ``pos_embed`` ``[max_len, d_model]``
sliced to T, and the final LayerNorm before the mean pool. With
``patch_size`` a 4-D image is cut into ``p×p`` patches in row-major patch
order, each flattened ``(py, px, c)`` as the JAX package does on NHWC; the
port's step hands the model NCHW, whose channels go last again first.
``remat`` recomputes each block's activations in the backward
(``torch.utils.checkpoint``), with the same numbers.

With ``moe_experts`` each block's MLP is the Switch mixture of experts
(``models/moe.py``, Flax's ``block{i}/moe``), and the model's
load-balancing loss is the float32 sum of the blocks' (the JAX package
sums the sowed ``"losses"``): ``forward(..., return_aux=True)`` returns it
beside the logits, 0.0 without experts. Each block hands its loss out with
its output, so a block recomputed under ``remat`` adds nothing twice.

Under ``tensor_parallel`` (``parallel/tensor.py``) each block holds its
model group as ``tp`` and this rank's Megatron shards: ``num_heads / T``
heads of ``query``/``key``/``value`` and the matching columns of ``proj``,
a ``1/T`` slice of ``fc1``'s outputs and of ``fc2``'s inputs. The block
then runs ``f`` before each column-parallel product and ``g`` after each
row-parallel one, whose bias is added after the all-reduce.

With ``sp_axis`` (sequence parallelism, ``parallel/sequence.py``) the
model takes this rank's block ``[B, T/S, F]`` of a sequence split over a
group of S ranks, bound by ``parallel.sequence.bind_sequence_group`` as
``sp`` on the model and its blocks (unbound, the forward raises). Every
attention then runs over the group as ``sp_impl`` says (``"ring"``,
``"zigzag"``, ``"ulysses"``), the positional embedding is the block's
global positions (rank i's slice, or under ``"zigzag"`` the chunks ``(i,
2S−1−i)``), the global length ``T/S · S`` is held to ``max_len``, and the
mean pool is completed over the group by ``collectives.AllReduceMean``,
whose backward is the ranks' gradients summed and divided by S: as every
rank's copy of the loss sends the same gradient back, a rank's gradient
comes out S times the share of its tokens, as the JAX step's ``pmean``
transposes with its replication checks off (``train/sp_step.py`` divides
once). With experts
each rank routes its own tokens, and the load-balancing loss is the mean
of the ranks' (JAX's ``lax.pmean`` over the sequence axis), by the same
all-reduce. The parameters do not change with ``sp_axis``.

``forward`` is three public pieces in a row, as the Flax model's
``embed``, blocks and ``head``: :meth:`TransformerClassifier.embed_tokens`,
``run_blocks`` (each block built by ``make_block``) and ``pool_head``.
Pipeline parallelism (``parallel/pipeline.py``) runs the same pieces
through its schedule, on a model that ``shard_stacked_blocks`` has cut to
one stage's blocks; such a model's ``forward`` raises.

With ``moe_ep_axis`` (expert parallelism, ``models/moe.py``) the model
takes this rank's slice of the batch, and
``models.moe.bind_expert_group`` hands each block's experts the expert
group (unbound, the forward raises) and keeps the rank's ``E/W`` of them;
the router loss is the same on every rank of the group. After the
backward, the caller sums every gradient but the experts'
(``models.moe.expert_leaf_names``) over the group
(``parallel.collectives.sum_grads_``).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from mercury_tpu_torch.models.moe import MoEMLP
from mercury_tpu_torch.parallel.collectives import all_reduce_mean
from mercury_tpu_torch.parallel.sequence import attention
from mercury_tpu_torch.parallel.tensor import copy_to_model, reduce_from_model


class LayerNorm(nn.LayerNorm):
    """Flax's LayerNorm: epsilon 1e-6, float32 statistics, the output in
    the input's dtype."""

    def __init__(self, features: int):
        super().__init__(features, eps=1e-6)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x.float(), self.normalized_shape, self.weight, self.bias,
                            self.eps).to(x.dtype)


class TransformerBlock(nn.Module):
    """Pre-LN encoder block: multi-head self-attention, then a GELU MLP (or,
    with ``moe_experts``, the mixture of experts ``moe``), each added back
    to its input. ``ln1``/``ln2`` and ``fc1``/``fc2`` are Flax's
    ``LayerNorm_0/1`` and ``Dense_0/1``. ``forward`` returns the output and
    the experts' load-balancing loss (None without experts). ``tp``, the
    model group under tensor parallelism, is set by
    ``parallel.tensor.shard_model_tp``; ``sp``, the sequence's group under
    ``sp_axis``, by ``parallel.sequence.bind_sequence_group``."""

    tp = None
    sp = None

    def __init__(self, d_model: int, num_heads: int, mlp_ratio: int = 4,
                 causal: bool = False, moe_experts: Optional[int] = None,
                 moe_capacity_factor: float = 1.25, moe_ep_axis: Optional[str] = None,
                 sp_axis: Optional[str] = None, sp_impl: str = "ring"):
        super().__init__()
        self.num_heads, self.causal = num_heads, causal
        self.sp_axis, self.sp_impl = sp_axis, sp_impl
        self.ln1 = LayerNorm(d_model)
        self.query = nn.Linear(d_model, d_model)
        self.key = nn.Linear(d_model, d_model)
        self.value = nn.Linear(d_model, d_model)
        self.proj = nn.Linear(d_model, d_model)
        self.ln2 = LayerNorm(d_model)
        if moe_experts is None:
            self.fc1 = nn.Linear(d_model, mlp_ratio * d_model)
            self.fc2 = nn.Linear(mlp_ratio * d_model, d_model)
        else:
            self.moe = MoEMLP(moe_experts, d_model, mlp_ratio, moe_capacity_factor,
                              moe_ep_axis)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        b, t, d = x.shape
        h = self._column_input(self.ln1(x))
        heads = self.num_heads // (1 if self.tp is None else self.tp.size)
        shape = (b, t, heads, d // self.num_heads)
        out = attention(self.query(h).view(shape), self.key(h).view(shape),
                        self.value(h).view(shape), causal=self.causal,
                        sp_axis=self.sp_axis, sp_impl=self.sp_impl, group=self.sp)
        x = x + self._row(self.proj, out.reshape(b, t, -1))
        if hasattr(self, "moe"):
            h, aux = self.moe(self.ln2(x))
            return x + h, aux
        h = F.gelu(self.fc1(self._column_input(self.ln2(x))), approximate="tanh")
        return x + self._row(self.fc2, h), None

    def _column_input(self, h: torch.Tensor) -> torch.Tensor:
        """Megatron's ``f`` before a column-parallel product."""
        return h if self.tp is None else copy_to_model(h, self.tp)

    def _row(self, linear: nn.Linear, h: torch.Tensor) -> torch.Tensor:
        """A row-parallel product: the partial products summed over the
        model group (``g``), then the bias, once."""
        if self.tp is None:
            return linear(h)
        y = reduce_from_model(F.linear(h, linear.weight), self.tp)
        return y + linear.bias.to(y.dtype)


class TransformerClassifier(nn.Module):
    """Encoder stack over ``[B, T, F]`` (or, with ``patch_size``, NCHW
    images), mean-pooled into a linear head; float32 logits.
    ``in_features`` is F, or the image's channels in vision mode. ``sp``
    is the sequence's group under ``sp_axis`` (module docstring)."""

    sp = None

    def __init__(self, num_classes: int = 10, in_features: int = 16, d_model: int = 128,
                 num_heads: int = 4, num_layers: int = 2, mlp_ratio: int = 4,
                 max_len: int = 2048, causal: bool = False,
                 patch_size: Optional[int] = None, sp_axis: Optional[str] = None,
                 sp_impl: str = "ring", moe_experts: Optional[int] = None,
                 moe_capacity_factor: float = 1.25, moe_ep_axis: Optional[str] = None,
                 remat: bool = False):
        super().__init__()
        self.patch_size, self.max_len, self.remat = patch_size, max_len, remat
        self.sp_axis, self.sp_impl, self.moe_experts = sp_axis, sp_impl, moe_experts
        self.d_model, self.num_heads, self.num_layers = d_model, num_heads, num_layers
        self.mlp_ratio, self.causal = mlp_ratio, causal
        self.moe_capacity_factor, self.moe_ep_axis = moe_capacity_factor, moe_ep_axis
        token = in_features * patch_size ** 2 if patch_size else in_features
        self.embed = nn.Linear(token, d_model)
        self.pos_embed = nn.Parameter(torch.zeros(max_len, d_model))
        self.blocks = nn.ModuleList(self.make_block() for _ in range(num_layers))
        self.norm = LayerNorm(d_model)
        self.head = nn.Linear(d_model, num_classes)

    def make_block(self) -> TransformerBlock:
        """One encoder block of this model's configuration: the blocks of
        ``__init__`` and the pipeline's stages (``parallel/pipeline.py``)
        are built by it alone."""
        return TransformerBlock(self.d_model, self.num_heads, self.mlp_ratio, self.causal,
                                self.moe_experts, self.moe_capacity_factor, self.moe_ep_axis,
                                self.sp_axis, self.sp_impl)

    @torch.no_grad()
    def flax_init(self, generator: Optional[torch.Generator]) -> None:
        """Flax's ``normal(0.02)`` for the positional embedding."""
        nn.init.normal_(self.pos_embed, 0.0, 0.02, generator=generator)

    def patchify(self, x: torch.Tensor) -> torch.Tensor:
        """NCHW images → ``[B, (H/p)·(W/p), p·p·C]`` tokens in the JAX
        package's order (patches row-major, each ``(py, px, c)``)."""
        if self.patch_size is None:
            raise ValueError("4-D (image) input needs patch_size set (ViT mode)")
        p = self.patch_size
        b, c, h, w = x.shape
        if h % p or w % p:
            raise ValueError(f"image size {h}x{w} not divisible by patch_size {p}")
        x = x.permute(0, 2, 3, 1).reshape(b, h // p, p, w // p, p, c)
        return x.permute(0, 1, 3, 2, 4, 5).reshape(b, (h // p) * (w // p), p * p * c)

    def forward(self, x: torch.Tensor, train: Optional[bool] = None,
                keep_stats: bool = True, return_aux: bool = False):
        """The float32 logits, and with ``return_aux`` the float32 sum of
        the blocks' load-balancing losses beside them. ``train`` and
        ``keep_stats`` change nothing (no batch norm)."""
        if len(self.blocks) != self.num_layers:
            raise ValueError(f"this model holds {len(self.blocks)} of its {self.num_layers} "
                             "blocks (a pipeline stage): run it through "
                             "parallel.pipeline.make_pp_apply")
        x, aux = self.run_blocks(self.embed_tokens(x))
        logits = self.pool_head(x)
        if not return_aux:
            return logits
        if aux is None:
            return logits, torch.zeros((), device=logits.device)
        return logits, self.seq_mean(aux)

    def embed_tokens(self, x: torch.Tensor) -> torch.Tensor:
        """The blocks' input: ``[B, T, F]`` features (or NCHW images,
        patchified) through ``embed``, plus the positional embedding (Flax's
        ``embed`` method)."""
        if x.dim() == 4:
            if self.patch_size is not None and self.sp_axis is not None:
                raise ValueError(
                    "sequence parallelism over raw images is unsupported: "
                    "patchify first, then shard the token sequence")
            x = self.patchify(x)
        x = self.embed(x)
        return x + self.positions(x.shape[1]).to(x.dtype)

    def run_blocks(self, x: torch.Tensor) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """``x`` through the blocks this model holds, each recomputed in the
        backward under ``remat``: the output and the float32 sum of the
        blocks' load-balancing losses (None without experts)."""
        aux = None
        for block in self.blocks:
            if self.remat and torch.is_grad_enabled():
                x, block_aux = checkpoint(block, x, use_reentrant=False)
            else:
                x, block_aux = block(x)
            if block_aux is not None:
                aux = block_aux.float() if aux is None else aux + block_aux.float()
        return x, aux

    def pool_head(self, x: torch.Tensor) -> torch.Tensor:
        """The blocks' output ``[B, T, D]`` → float32 logits: the final
        norm, the mean pool (completed over the sequence's group) and
        ``head`` (Flax's ``head`` method)."""
        return self.head(self.seq_mean(self.norm(x).mean(dim=1))).float()

    def seq_mean(self, x: torch.Tensor) -> torch.Tensor:
        """``x``'s mean over the sequence's group under ``sp_axis`` (the
        backward as the module docstring says); ``x`` otherwise."""
        if self.sp_axis is None or self.sp.size == 1:
            return x
        return all_reduce_mean(x, self.sp.group)

    def positions(self, t: int) -> torch.Tensor:
        """The positional embedding of a block of ``t`` tokens: the first
        ``t`` rows, or under ``sp_axis`` this rank's global positions."""
        if self.sp_axis is None:
            if t > self.max_len:
                raise ValueError(f"sequence length {t} exceeds max_len={self.max_len}")
            return self.pos_embed[:t]
        if self.sp is None:
            raise ValueError(f"sp_axis={self.sp_axis!r} needs its sequence group bound "
                             "(parallel.sequence.bind_sequence_group)")
        w, i = self.sp.size, self.sp.rank
        if t * w > self.max_len:
            raise ValueError(f"sequence length {t * w} exceeds max_len={self.max_len}")
        if self.sp_impl != "zigzag":
            return self.pos_embed[i * t:(i + 1) * t]
        # The zigzag layout: rank i's block is global chunks (i, 2W−1−i).
        if t % 2 != 0:
            raise ValueError(f"zigzag layout needs an even local length, got {t}")
        c = t // 2
        j = 2 * w - 1 - i
        return torch.cat([self.pos_embed[i * c:(i + 1) * c], self.pos_embed[j * c:(j + 1) * c]])
