"""The BiLSTM + additive-attention sequence classifier of
``mercury_tpu/models/lstm.py``: two stacked bidirectional LSTMs, each
attention-pooled, the two pooled vectors concatenated into a 2-layer MLP.

The cell is written out (not ``nn.LSTM``) so that its parameters are Flax
``OptimizedLSTMCell``'s: per gate an input kernel without bias (``ii``,
``if``, ``ig``, ``io``) and a hidden kernel with a bias (``hi``, ``hf``,
``hg``, ``ho``); ``c' = f·c + i·g``, ``h' = o·tanh(c')``. Each layer
projects its inputs once for all time steps, then runs both directions in
one loop over T as a batched product: the backward direction reads the
sequence reversed (within each ``lengths``, as Flax's ``flip_sequences``)
and writes its outputs back in input order, after the forward direction's
(Flax ``nn.Bidirectional``).

Under bf16 autocast the input is rounded to bf16 and the cells run in
float32, as the Flax cells (no ``dtype``) promote to their float32
parameters; the attention Denses and the head run in bf16, the attention
weights are rounded to bf16, and the pooled vector ``weights·h`` is
float32.
"""

from __future__ import annotations

import contextlib
from typing import Optional

import torch
import torch.nn as nn

GATES = "ifgo"


def _float32(device: torch.device):
    """A region without autocast on ``device`` (a no-op where autocast does
    not exist, as on the meta device of a FLOP count)."""
    if torch.amp.is_autocast_available(device.type):
        return torch.autocast(device.type, enabled=False)
    return contextlib.nullcontext()


class LSTMCell(nn.Module):
    """Flax ``OptimizedLSTMCell``'s parameters under its names."""

    def __init__(self, in_features: int, hidden: int):
        super().__init__()
        self.hidden = hidden
        for g in GATES:
            self.add_module(f"i{g}", nn.Linear(in_features, hidden, bias=False))
        for g in GATES:
            self.add_module(f"h{g}", nn.Linear(hidden, hidden))

    def kernels(self):
        """``[F, 4H]``, ``[H, 4H]`` and ``[4H]``: the four gates' input and
        hidden kernels and hidden biases side by side, as Flax concatenates
        them."""
        wi = torch.cat([getattr(self, f"i{g}").weight for g in GATES]).T
        wh = torch.cat([getattr(self, f"h{g}").weight for g in GATES]).T
        bh = torch.cat([getattr(self, f"h{g}").bias for g in GATES])
        return wi, wh, bh

    @torch.no_grad()
    def flax_init(self, generator: Optional[torch.Generator]) -> None:
        """Flax's orthogonal initializer for each gate's hidden kernel."""
        for g in GATES:
            nn.init.orthogonal_(getattr(self, f"h{g}").weight, generator=generator)


def flip_sequences(x: torch.Tensor, lengths: Optional[torch.Tensor]) -> torch.Tensor:
    """Reverse ``[..., B, T, F]`` along T, each sequence within its length
    (the padding reversed after it), as Flax's ``flip_sequences``; its own
    inverse."""
    t = x.shape[-2]
    if lengths is None:
        return x.flip(-2)
    idx = (torch.arange(t - 1, -1, -1, device=x.device)[None, :]
           + lengths.to(x.device).long()[:, None]) % t  # [B, T]
    idx = idx[..., None].expand(*x.shape[-3:-1], x.shape[-1])
    return torch.gather(x, -2, idx.expand(x.shape))


def bilstm(x: torch.Tensor, fwd: LSTMCell, bwd: LSTMCell,
           lengths: Optional[torch.Tensor]) -> torch.Tensor:
    """One bidirectional layer in float32: ``[B, T, F]`` → ``[B, T, 2H]``,
    the forward direction's outputs then the backward's."""
    b, t, f = x.shape
    kernels = [c.kernels() for c in (fwd, bwd)]
    wi = torch.stack([k[0] for k in kernels])            # [2, F, 4H]
    wh = torch.stack([k[1] for k in kernels])            # [2, H, 4H]
    bh = torch.stack([k[2] for k in kernels])[:, None]   # [2, 1, 4H]
    xs = torch.stack([x, flip_sequences(x, lengths)])    # [2, B, T, F]
    proj = torch.bmm(xs.reshape(2, b * t, f), wi).view(2, b, t, -1)
    hidden = fwd.hidden
    c = None
    outs = []
    for step in range(t):
        # (h·Kh + bh) + x·Ki, Flax's order; h and c start at zero.
        gates = (bh if c is None else torch.baddbmm(bh, h, wh)) + proj[:, :, step]
        i, f_, g, o = gates.split(hidden, dim=-1)
        i, f_, o = torch.sigmoid(i), torch.sigmoid(f_), torch.sigmoid(o)
        ig = i * torch.tanh(g)
        c = ig if c is None else f_ * c + ig
        h = o * torch.tanh(c)
        outs.append(h)
    out = torch.stack(outs, dim=2)                       # [2, B, T, H]
    return torch.cat([out[0], flip_sequences(out[1], lengths)], dim=-1)


class AdditiveAttention(nn.Module):
    """Length-masked additive attention pooling: ``score_t = v·tanh(W
    h_t)``, positions at or past the length set to -inf, softmax over T;
    returns the weighted sum ``[B, D]`` (float32) and the weights."""

    def __init__(self, in_features: int, attention_dim: int = 128):
        super().__init__()
        self.denses = nn.ModuleList([nn.Linear(in_features, attention_dim),
                                     nn.Linear(attention_dim, 1, bias=False)])

    def forward(self, h: torch.Tensor, lengths: Optional[torch.Tensor] = None):
        scores = self.denses[1](torch.tanh(self.denses[0](h)))[..., 0]  # [B, T]
        if lengths is not None:
            t = torch.arange(h.shape[1], device=h.device)[None, :]
            scores = torch.where(t < lengths.to(h.device)[:, None], scores, -torch.inf)
        # The softmax in the scores' dtype (bf16 under autocast), as Flax's.
        weights = torch.softmax(scores.float(), dim=-1).to(scores.dtype)
        with _float32(h.device):
            pooled = torch.einsum("bt,btd->bd", weights.float(), h.float())
        return pooled, weights


class BiLSTMAttention(nn.Module):
    """``MyLSTM``: two stacked BiLSTMs, each attention-pooled; the pooled
    vectors concatenated into a 2-layer MLP head. ``cells`` holds Flax's
    ``OptimizedLSTMCell_0..3``: layer 1 forward and backward, then layer
    2's."""

    # ``bilstm`` reads the cells' weights without calling the cells, so
    # under FSDP the model's own call gathers them (``parallel/fsdp.py``).
    fsdp_gather_at = {"cells.": ""}

    def __init__(self, num_classes: int = 10, in_features: int = 16,
                 hidden_dim: int = 128, attention_dim: int = 128, mlp_dim: int = 128):
        super().__init__()
        h2 = 2 * hidden_dim
        self.cells = nn.ModuleList([LSTMCell(in_features, hidden_dim),
                                    LSTMCell(in_features, hidden_dim),
                                    LSTMCell(h2, hidden_dim), LSTMCell(h2, hidden_dim)])
        self.attn1 = AdditiveAttention(h2, attention_dim)
        self.attn2 = AdditiveAttention(h2, attention_dim)
        self.fcs = nn.ModuleList([nn.Linear(2 * h2, mlp_dim), nn.Linear(mlp_dim, num_classes)])

    def forward(self, x: torch.Tensor, lengths: Optional[torch.Tensor] = None,
                train: Optional[bool] = None, keep_stats: bool = True) -> torch.Tensor:
        """``x`` ``[B, T, F]``, ``lengths`` ``[B]`` or None (all of T);
        float32 logits. ``train`` and ``keep_stats`` change nothing (no
        batch norm)."""
        dev = x.device.type
        if torch.amp.is_autocast_available(dev) and torch.is_autocast_enabled(dev):
            x = x.to(torch.get_autocast_dtype(dev))
        with _float32(x.device):
            h1 = bilstm(x.float(), self.cells[0], self.cells[1], lengths)
        pooled1, _ = self.attn1(h1, lengths)
        with _float32(x.device):
            h2 = bilstm(h1, self.cells[2], self.cells[3], lengths)
        pooled2, _ = self.attn2(h2, lengths)
        z = torch.relu(self.fcs[0](torch.cat([pooled1, pooled2], dim=-1)))
        return self.fcs[1](z).float()
