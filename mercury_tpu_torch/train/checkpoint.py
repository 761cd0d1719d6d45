"""Checkpoints of the port: the whole training state of a run as one file,
``<directory>/ckpt_<step>.pt``, from which the run resumes bit for bit.

The PyTorch counterpart of ``save_checkpoint``, ``_prune_old``,
``all_steps``, ``latest_step`` and ``restore_checkpoint`` of
``mercury_tpu/train/checkpoint.py``, in a format of its own (``torch.save``
of a dict of tensors and numbers). Not ported: the sha256 manifest and its
verification, the fall back to an older file, async writes, write retries
and elastic restore (a different world size).

The file holds the replicated state once (the model's parameters and BN
buffers, the optimizer's state, the step counters and the gradient
accumulator) and a row of sampler state for each rank (the EMA, the stream
permutation and cursor, the generator's state and, with
``sampler="scoretable"``, the table and its cursor and, under telemetry, the
selection-count ledger; under ``host_stream``, the ring of selections in
flight with its draws; the pool sampler's step modes' carried state: the
pipelined batch in flight, the cached pool, the groupwise importance). At W>1 every rank sends its row to rank 0, rank 0
alone writes, and a barrier follows, so no rank reads before the file
exists; a restore reads the file on every rank, and each rank takes its own
row. A file without a ledger (saved with ``telemetry=False``) restores into
a zero ledger; a ledger restored into a run without telemetry is dropped.
A file without a ring (saved by a replicated run) restores into a
host_stream run without one, and the Trainer primes the ring anew from the
restored generator and stream, as the JAX package's ``_upgrade_v1_to_v2``
drops the ring; a ring does not restore into a run of another placement.

A file restores only into a run of the same step mode: one with a pending
batch, a cached pool or a groupwise state into a run that keeps the same.

Under ``zero_sharding`` each rank's optimizer state and accumulator are
its own chunk's, so they go into its row and each rank restores its own;
such a file restores only into a ZeRO run of the same ``world_size`` (the
JAX package's elastic resharding of the chunks is not ported).

A file is written to ``ckpt_<step>.pt.tmp``, flushed to disk and renamed,
so a torn write never carries a checkpoint's name.
"""

from __future__ import annotations

import os
import re
from typing import Any, Dict, List, Optional

import torch
import torch.distributed as dist

from mercury_tpu_torch.config import TrainConfig
from mercury_tpu_torch.data.pipeline import ShardStream
from mercury_tpu_torch.parallel.collectives import gather_to_rank0, rank, world
from mercury_tpu_torch.sampling.importance import EMAState
from mercury_tpu_torch.sampling.scoretable import ScoreTableState
from mercury_tpu_torch.sampling.groupwise import GroupwiseState
from mercury_tpu_torch.train.state import (
    CachedPool,
    MercuryState,
    PendingBatch,
    carried_from_host,
    pending_from_host,
    pending_to_host,
)

# The step modes' carried state: the row's key, the state's field, its
# type and the config field that turns it on.
_CARRIED = (("pending_batch", PendingBatch, "pipelined_scoring"),
            ("cached_pool", CachedPool, "score_refresh_every"),
            ("groupwise", GroupwiseState, "sampler"))

FORMAT = 1
_NAME = re.compile(r"ckpt_(\d+)\.pt")


def checkpoint_path(directory: str, step: int) -> str:
    return os.path.join(directory, f"ckpt_{step}.pt")


def all_steps(directory: str) -> List[int]:
    """The steps of the checkpoints in ``directory``, ascending (a
    ``.tmp`` file is not a checkpoint)."""
    if not os.path.isdir(directory):
        return []
    return sorted(int(m.group(1)) for m in map(_NAME.fullmatch, os.listdir(directory))
                  if m)


def latest_step(directory: str) -> Optional[int]:
    """The newest checkpoint's step in ``directory``, or None."""
    steps = all_steps(directory)
    return steps[-1] if steps else None


def _cpu(t: torch.Tensor) -> torch.Tensor:
    return t.detach().cpu()


def _optimizer_on_host(optimizer: torch.optim.Optimizer) -> Dict[str, Any]:
    sd = optimizer.state_dict()
    return {"param_groups": sd["param_groups"],
            "state": {i: {k: _cpu(v) if torch.is_tensor(v) else v for k, v in st.items()}
                      for i, st in sd["state"].items()}}


def _rank_row(state: MercuryState, zero: bool) -> Dict[str, Any]:
    """This rank's sampler state, and under ZeRO its chunk's optimizer
    state and accumulator, on the host."""
    table = state.scoretable
    own = {}
    if zero:
        own = {"optimizer": _optimizer_on_host(state.optimizer),
               "accum": None if state.accum is None else [_cpu(a) for a in state.accum]}
    return {**own,
        "ema_value": _cpu(state.ema.value), "ema_count": _cpu(state.ema.count),
        "perm": _cpu(state.stream.perm), "cursor": state.stream.cursor,
        "generator": state.generator.get_state(),
        "table": None if table is None else _cpu(table.scores),
        "table_cursor": None if table is None else table.cursor,
        "sel_counts": None if state.sel_counts is None else _cpu(state.sel_counts),
        "pending": None if state.pending is None else pending_to_host(state.pending),
        **{key: None if getattr(state, key) is None else pending_to_host(getattr(state, key))
           for key, _, _ in _CARRIED},
    }


def _write(path: str, payload: Dict[str, Any]) -> None:
    tmp = path + ".tmp"
    try:
        with open(tmp, "wb") as f:
            torch.save(payload, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def prune(directory: str, keep: int) -> None:
    """Keep the newest ``keep`` checkpoints (``keep <= 0`` keeps all)."""
    if keep <= 0:
        return
    for step in all_steps(directory)[:-keep]:
        os.unlink(checkpoint_path(directory, step))


def save_checkpoint(directory: str, state: MercuryState, config: TrainConfig,
                    keep: int = 0) -> str:
    """Write ``state`` to ``directory/ckpt_<state.step>.pt`` and prune to
    the newest ``keep``; return the path. Called by every rank at W>1:
    rank 0 writes, and every rank returns once the file exists."""
    zero = config.zero_sharding
    rows = gather_to_rank0(_rank_row(state, zero))
    path = checkpoint_path(directory, state.step)
    if rank() == 0:
        os.makedirs(directory, exist_ok=True)
        _write(path, {
            "format": FORMAT,
            "step": state.step, "updates": state.updates, "mini_step": state.mini_step,
            "world_size": config.world_size, "grad_accum_steps": config.grad_accum_steps,
            "zero_sharding": zero, "device": state.stream.perm.device.type,
            "model": {k: _cpu(v) for k, v in state.model.state_dict().items()},
            # Under ZeRO both are in the rank rows.
            "optimizer": None if zero else _optimizer_on_host(state.optimizer),
            "accum": None if zero or state.accum is None else [_cpu(a) for a in state.accum],
            "ranks": rows,
        })
        prune(directory, keep)
    if world() > 1:
        dist.barrier()
    return path


def restore_checkpoint(directory: str, state: MercuryState, config: TrainConfig,
                       step: Optional[int] = None) -> int:
    """Load ``directory/ckpt_<step>.pt`` (default: the newest) into
    ``state`` in place, this rank's row of sampler state included; return
    the step. A checkpoint saved at another ``world_size``, another
    ``grad_accum_steps``, another ``zero_sharding`` or on another device
    type raises ``ValueError`` naming the field."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(
                f"no checkpoint ckpt_<step>.pt in {directory!r} (TrainConfig.checkpoint_dir)")
    path = checkpoint_path(directory, step)
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    device = state.stream.perm.device
    for field, have in (("format", FORMAT), ("world_size", config.world_size),
                        ("zero_sharding", config.zero_sharding),
                        ("grad_accum_steps", config.grad_accum_steps),
                        ("device", device.type)):
        saved = ckpt.get(field, False)
        if saved != have:
            raise ValueError(
                f"{path} was saved with {field}={saved!r}, this run has {field}={have!r}: "
                "the port restores only into the same one (it does not reshard "
                "zero_sharding's optimizer chunks)")
    row = ckpt["ranks"][rank()]
    if (row["table"] is None) != (state.scoretable is None):
        raise ValueError(f"{path} and this run differ in sampler: one keeps a "
                         "score table, the other does not")
    for key, _, field in _CARRIED:
        if (row.get(key) is None) != (getattr(state, key) is None):
            raise ValueError(f"{path} and this run differ in {field}: one carries "
                             f"a {key}, the other does not")
    if row.get("pending") is not None and not config.host_stream:
        raise ValueError(f"{path} was saved by a data_placement='host_stream' run (its "
                         "stream and generator are depth steps ahead): restore it into one")
    state.model.load_state_dict(ckpt["model"])
    own = row if config.zero_sharding else ckpt
    state.optimizer.load_state_dict(own["optimizer"])
    if state.accum is not None:
        for acc, saved in zip(state.accum, own["accum"]):
            acc.copy_(saved)
    state.step, state.updates, state.mini_step = (
        ckpt["step"], ckpt["updates"], ckpt["mini_step"])
    state.ema = EMAState(row["ema_value"].to(device), row["ema_count"].to(device))
    state.stream = ShardStream(row["perm"].to(device), row["cursor"])
    state.generator.set_state(row["generator"])
    if state.scoretable is not None:
        state.scoretable = ScoreTableState(row["table"].to(device), row["table_cursor"])
    if state.sel_counts is not None:
        saved = row.get("sel_counts")
        state.sel_counts = (torch.zeros_like(state.sel_counts) if saved is None
                            else saved.to(device))
    saved = row.get("pending")
    if saved is not None and len(saved["draws"]) != config.prefetch_depth:
        raise ValueError(f"{path} was saved with prefetch_depth={len(saved['draws'])}, "
                         f"this run has prefetch_depth={config.prefetch_depth}")
    state.pending = None if saved is None else pending_from_host(saved, device)
    for key, cls, _ in _CARRIED:
        setattr(state, key, carried_from_host(cls, row.get(key), device))
    return step
