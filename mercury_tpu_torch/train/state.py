"""Training state of the port: the model, its optimizer and learning-rate
schedule, and the Mercury sampler state (EMA, presampling stream, score
table, random generator) — the PyTorch counterpart of
``mercury_tpu/train/state.py`` at one worker.

The optimizers follow optax's: ``optax.adam``/``adamw``/``sgd(momentum=0.9)``
under ``cosine_decay_schedule(lr, total_steps)`` (optionally after a linear
warmup). optax's update count starts at 0, so the first update uses the
full ``lr``; here the step sets the learning rate of update ``k`` to
``lr_schedule(k)`` before ``optimizer.step()``.
"""

from __future__ import annotations

import copy
import dataclasses
import math
from typing import Callable, Iterable, Optional, Tuple

import torch

from mercury_tpu_torch.data.pipeline import ShardStream, init_shard_streams
from mercury_tpu_torch.sampling.importance import EMAState, init_ema
from mercury_tpu_torch.sampling.scoretable import ScoreTableState, init_score_table

Schedule = Callable[[int], float]


def cosine_decay_schedule(lr: float, decay_steps: int) -> Schedule:
    """``lr·½(1 + cos(π·min(k, T)/T))`` (optax, ``alpha=0``)."""
    def schedule(k: int) -> float:
        frac = min(k, decay_steps) / decay_steps
        return lr * 0.5 * (1.0 + math.cos(math.pi * frac))
    return schedule


def warmup_cosine_decay_schedule(lr: float, warmup_steps: int,
                                 decay_steps: int) -> Schedule:
    """Linear 0 → ``lr`` over ``warmup_steps``, then cosine to 0 at
    ``decay_steps`` (which counts the warmup, as optax's does)."""
    cosine = cosine_decay_schedule(lr, decay_steps - warmup_steps)

    def schedule(k: int) -> float:
        if k < warmup_steps:
            return lr * k / warmup_steps
        return cosine(k - warmup_steps)
    return schedule


def make_optimizer(name: str, params: Iterable[torch.nn.Parameter], lr: float,
                   total_steps: int, weight_decay: float = 0.0,
                   warmup_steps: int = 0
                   ) -> Tuple[torch.optim.Optimizer, Schedule]:
    """Optimizer and its per-update learning rate, as
    ``mercury_tpu.train.state.make_optimizer`` builds them: Adam (L2 decay
    added to the gradient, as ``optax.add_decayed_weights`` before Adam),
    AdamW (decoupled decay) or SGD with momentum 0.9."""
    updates = max(total_steps, 1)
    if warmup_steps > 0:
        if warmup_steps >= updates:
            raise ValueError(
                f"warmup_steps ({warmup_steps}) must be < total steps ({updates})")
        schedule = warmup_cosine_decay_schedule(lr, warmup_steps, updates)
    else:
        schedule = cosine_decay_schedule(lr, updates)
    params = list(params)
    if name == "adam":
        opt = torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                               weight_decay=weight_decay)
    elif name == "adamw":
        opt = torch.optim.AdamW(params, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                                weight_decay=weight_decay)
    elif name == "sgd":
        opt = torch.optim.SGD(params, lr=lr, momentum=0.9)
    else:
        raise ValueError(f"unknown optimizer {name!r}")
    return opt, schedule


@dataclasses.dataclass
class MercuryState:
    """Everything one step reads and advances."""

    step: int                        # updates applied so far
    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    lr_schedule: Schedule
    ema: EMAState                    # on the device
    stream: ShardStream              # perm on the device, cursor on the host
    generator: torch.Generator       # the step's draws, on the device
    # sampler="scoretable" only: the [L] table on the device, cursor on the host
    scoretable: Optional[ScoreTableState] = None

    def clone(self) -> "MercuryState":
        """An independent copy: the model and its optimizer are copied
        together, so the copy's optimizer state points at the copy's
        parameters."""
        model, optimizer = copy.deepcopy((self.model, self.optimizer))
        gen = torch.Generator(device=self.generator.device)
        gen.set_state(self.generator.get_state())
        table = self.scoretable
        if table is not None:
            table = ScoreTableState(table.scores.clone(), table.cursor)
        return dataclasses.replace(
            self, model=model, optimizer=optimizer, generator=gen,
            ema=EMAState(self.ema.value.clone(), self.ema.count.clone()),
            stream=ShardStream(self.stream.perm.clone(), self.stream.cursor),
            scoretable=table,
        )


def create_state(model: torch.nn.Module, device: torch.device, seed: int,
                 shard_len: int, optimizer: str, lr: float, total_steps: int,
                 weight_decay: float = 0.0,
                 warmup_steps: int = 0,
                 with_scoretable: bool = False) -> MercuryState:
    """Move ``model`` to ``device`` and build its optimizer, a fresh EMA,
    the worker's stream and a generator seeded with ``seed``; with
    ``with_scoretable`` also a score table of ones over the shard, cursor
    0."""
    device = torch.device(device)
    model = model.to(device)
    if device.type == "cuda":
        model = model.to(memory_format=torch.channels_last)
    opt, schedule = make_optimizer(optimizer, model.parameters(), lr,
                                   total_steps, weight_decay, warmup_steps)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    stream = init_shard_streams(gen, 1, shard_len)[0]
    table = init_score_table(shard_len, device) if with_scoretable else None
    return MercuryState(step=0, model=model, optimizer=opt,
                        lr_schedule=schedule, ema=init_ema(device),
                        stream=stream, generator=gen, scoretable=table)
