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

Not ported yet: sequence parallelism (``sp_axis``, the zigzag layout) and
the mixture-of-experts MLP (``moe_experts``); each raises ``ValueError``.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from mercury_tpu_torch.parallel.sequence import SP_NOT_PORTED, attention

MOE_NOT_PORTED = "the mixture-of-experts MLP (moe_experts) is not ported: ROADMAP.md, Queue 1 item 5"


class LayerNorm(nn.LayerNorm):
    """Flax's LayerNorm: epsilon 1e-6, float32 statistics, the output in
    the input's dtype."""

    def __init__(self, features: int):
        super().__init__(features, eps=1e-6)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x.float(), self.normalized_shape, self.weight, self.bias,
                            self.eps).to(x.dtype)


class TransformerBlock(nn.Module):
    """Pre-LN encoder block: multi-head self-attention, then a GELU MLP,
    each added back to its input. ``ln1``/``ln2`` and ``fc1``/``fc2`` are
    Flax's ``LayerNorm_0/1`` and ``Dense_0/1``."""

    def __init__(self, d_model: int, num_heads: int, mlp_ratio: int = 4,
                 causal: bool = False):
        super().__init__()
        self.num_heads, self.causal = num_heads, causal
        self.ln1 = LayerNorm(d_model)
        self.query = nn.Linear(d_model, d_model)
        self.key = nn.Linear(d_model, d_model)
        self.value = nn.Linear(d_model, d_model)
        self.proj = nn.Linear(d_model, d_model)
        self.ln2 = LayerNorm(d_model)
        self.fc1 = nn.Linear(d_model, mlp_ratio * d_model)
        self.fc2 = nn.Linear(mlp_ratio * d_model, d_model)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, t, d = x.shape
        h = self.ln1(x)
        shape = (b, t, self.num_heads, d // self.num_heads)
        out = attention(self.query(h).view(shape), self.key(h).view(shape),
                        self.value(h).view(shape), causal=self.causal)
        x = x + self.proj(out.reshape(b, t, d))
        h = self.fc2(F.gelu(self.fc1(self.ln2(x)), approximate="tanh"))
        return x + h


class TransformerClassifier(nn.Module):
    """Encoder stack over ``[B, T, F]`` (or, with ``patch_size``, NCHW
    images), mean-pooled into a linear head; float32 logits.
    ``in_features`` is F, or the image's channels in vision mode."""

    def __init__(self, num_classes: int = 10, in_features: int = 16, d_model: int = 128,
                 num_heads: int = 4, num_layers: int = 2, mlp_ratio: int = 4,
                 max_len: int = 2048, causal: bool = False,
                 patch_size: Optional[int] = None, sp_axis: Optional[str] = None,
                 sp_impl: str = "ring", moe_experts: Optional[int] = None,
                 remat: bool = False):
        super().__init__()
        if sp_axis is not None or sp_impl == "zigzag":
            raise ValueError(f"{SP_NOT_PORTED} (sp_axis={sp_axis!r}, sp_impl={sp_impl!r})")
        if moe_experts is not None:
            raise ValueError(f"{MOE_NOT_PORTED} (moe_experts={moe_experts})")
        self.patch_size, self.max_len, self.remat = patch_size, max_len, remat
        token = in_features * patch_size ** 2 if patch_size else in_features
        self.embed = nn.Linear(token, d_model)
        self.pos_embed = nn.Parameter(torch.zeros(max_len, d_model))
        self.blocks = nn.ModuleList(TransformerBlock(d_model, num_heads, mlp_ratio, causal)
                                    for _ in range(num_layers))
        self.norm = LayerNorm(d_model)
        self.head = nn.Linear(d_model, num_classes)

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
                keep_stats: bool = True) -> torch.Tensor:
        """``train`` and ``keep_stats`` change nothing (no batch norm)."""
        if x.dim() == 4:
            x = self.patchify(x)
        t = x.shape[1]
        if t > self.max_len:
            raise ValueError(f"sequence length {t} exceeds max_len={self.max_len}")
        x = self.embed(x)
        x = x + self.pos_embed[:t].to(x.dtype)
        for block in self.blocks:
            if self.remat and torch.is_grad_enabled():
                x = checkpoint(block, x, use_reentrant=False)
            else:
                x = block(x)
        return self.head(self.norm(x).mean(dim=1)).float()
