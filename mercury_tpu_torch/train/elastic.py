"""Elastic resume: restore a checkpoint saved at one world size into a run
at another (a preemption shrank the job, or it grew back) — the port's
counterpart of ``mercury_tpu/train/elastic.py``.

What carries over, and what the new run derives afresh:

- **The model** (parameters and BN buffers) and the counters ``step``,
  ``updates`` and ``mini_step`` do not depend on the world size: restored
  exactly.
- **The optimizer** and the accumulator: exact when replicated. Under
  ZeRO each old rank's row holds its ``[chunk]`` of the flat parameters in
  the JAX order, so W→W′ is concatenate, trim to P, re-pad, re-chunk, and
  the moments carry exactly too; a per-chunk scalar (Adam's ``step``)
  takes its first, identical, entry.
- **The EMA** of the pool loss is a statistic across ranks: the new ranks
  start from the old ranks' mean and their largest count.
- **The score table, the selection-count ledger and the cursors**
  (``config.stream_checkpoint_cursor``, on by default): a table entry
  scores the dataset row ``shard_indices[w, l]``, and the partition is
  deterministic in ``(labels, W, seed)``, so the old and the new ``[W, L]``
  index matrices are recomputed on the host and the scores repartitioned by
  the new ranks' ownership (a row the old run never held starts at the EMA
  mean); the ledger is summed a sample and put at each sample's first slot;
  the stream and table cursors carry as fractions of the epoch.
- **Everything else** keeps the new Trainer's fresh state: the streams over
  the new shards, the groupwise, cached-pool and pending-batch state, and
  the host_stream ring, which ``Trainer.restore_elastic`` primes anew.
- **The generator** of each rank is seeded from ``(rank_seed(seed, rank),
  restored step)`` (the JAX package folds the step into its keys), so a
  resumed run never replays the draws of step 0.

Under ``tensor_parallel`` or ``fsdp_parallel`` the file's rows are data
workers, as the checkpoint writes them: ``w_old`` is the file's row count
and ``w_new`` the new run's ``world_size``, each rank's generator and
carried sampler state are its data rank's (a model group draws alike),
and each rank loads its slices of the whole model, moments and
accumulator (``parallel/mesh.load_full_state_dict``,
``local_optimizer_state``); the file may come from any layout. ZeRO
cannot be on under a second axis.

A different model, another ``zero_sharding`` or another
``grad_accum_steps`` raises ``ValueError`` naming the field. With the
Trainer's event journal the restore is journaled as
``elastic/reshard_begin`` and ``elastic/reshard_end`` (its parent).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from mercury_tpu_torch.data.partition import partition_data
from mercury_tpu_torch.data.pipeline import ShardStream
from mercury_tpu_torch.parallel.mesh import (
    full_shapes,
    load_full_state_dict,
    local_like_params,
    local_optimizer_state,
)
from mercury_tpu_torch.sampling.importance import EMAState
from mercury_tpu_torch.sampling.scoretable import ScoreTableState
from mercury_tpu_torch.train import checkpoint as ckpt
from mercury_tpu_torch.train.state import rank_seed
from mercury_tpu_torch.utils.tree import zero_chunk_size


def probe_checkpoint(directory: str, step: Optional[int] = None, strict: bool = False
                     ) -> Tuple[Optional[Dict[str, Any]], Optional[int]]:
    """Read the newest (or ``step``'s) checkpoint's payload once, as the
    JAX probe does: unverified. Returns ``(raw, step)``; with
    ``strict=False`` a missing or unreadable file gives ``(None, None)``,
    with ``strict=True`` its error is raised."""
    if step is None:
        step = ckpt.latest_step(directory)
        if step is None:
            if strict:
                raise FileNotFoundError(f"no checkpoint ckpt_<step>.pt in {directory!r}")
            return None, None
    try:
        raw = ckpt.load_checkpoint(directory, step, verify=False)
    except Exception:
        if strict:
            raise
        return None, None
    return raw, step


def world_size_of_raw(raw: Optional[Dict[str, Any]]) -> Optional[int]:
    """The world size a payload was saved at, or None when unreadable."""
    try:
        return int(raw["world_size"])
    except Exception:
        return None


def elastic_seed(seed: int, rank: int, step: int) -> int:
    """The generator seed of ``rank`` resumed at ``step``: drawn from
    ``(rank_seed(seed, rank), step)``."""
    return int(np.random.SeedSequence([rank_seed(seed, rank), int(step)])
               .generate_state(1, np.uint64)[0] >> 1)


def _rechunk(chunks: Sequence[torch.Tensor], w_new: int, n: int) -> List[torch.Tensor]:
    """The ``[chunk]`` tensors of the old ranks, concatenated, trimmed to
    the ``n`` real elements, re-padded with zeros and cut into ``w_new``
    chunks."""
    full = torch.cat([c.reshape(-1) for c in chunks])[:n]
    c_new = zero_chunk_size(n, w_new)
    return [c.clone() for c in F.pad(full, (0, w_new * c_new - n)).view(w_new, c_new)]


def _reshard_zero_opt(old: Sequence[Dict[str, Any]], w_new: int, n_params: int
                      ) -> List[Dict[str, Any]]:
    """ZeRO's per-chunk optimizer state (each old rank's, e.g. Adam's
    ``{"step", "exp_avg", "exp_avg_sq"}``) resharded to ``w_new`` ranks:
    the chunk-shaped tensors re-chunked exactly, a scalar (Adam's ``step``,
    the same on every rank) broadcast from the first."""
    if not old or not old[0]:
        return [{} for _ in range(w_new)]
    out: List[Dict[str, Any]] = [{} for _ in range(w_new)]
    for key, first in old[0].items():
        if torch.is_tensor(first) and first.dim() >= 1:
            for r, chunk in enumerate(_rechunk([o[key] for o in old], w_new, n_params)):
                out[r][key] = chunk
        else:
            for r in range(w_new):
                out[r][key] = first.clone() if torch.is_tensor(first) else first
    return out


def _labels(trainer) -> np.ndarray:
    y = trainer.dataset.y_train
    return y.cpu().numpy() if torch.is_tensor(y) else np.asarray(y)


def _shard_index_matrix(trainer, n_workers: int) -> np.ndarray:
    """The ``[W, L]`` shard index matrix an ``n_workers``-rank run of this
    config builds: ``partition_data`` from the labels and the seed, each
    shard tiled cyclically to the longest, as ``make_sharded_dataset``
    tiles it."""
    cfg = trainer.config
    shards = partition_data(
        _labels(trainer), n_workers,
        mode="hetero" if cfg.noniid else "homo",
        alpha=cfg.dirichlet_alpha, seed=cfg.seed,
        min_size=cfg.min_shard_size,
    )
    max_len = max(len(s) for s in shards)
    rows = [np.tile(s, int(np.ceil(max_len / len(s))))[:max_len] for s in shards]
    return np.stack(rows).astype(np.int64)


def _carry_streamed_state(trainer, rows: Sequence[Dict[str, Any]], w_old: int,
                          w_new: int, ema_val: float) -> Dict[str, Any]:
    """This rank's carried stream cursor, score table and ledger (the
    replacements of ``trainer.state``'s ``stream``, ``scoretable`` and
    ``sel_counts``) from the old ranks' ``rows``; see the module
    docstring."""
    state = trainer.state
    r = trainer.rank
    dev = state.stream.perm.device
    extra: Dict[str, Any] = {}
    if len(rows) == w_old:
        l_old = int(rows[0]["perm"].numel())
        l_new = int(state.stream.perm.numel())
        frac = float(np.mean(np.asarray([row["cursor"] for row in rows], np.float64))
                     / max(l_old, 1))
        extra["stream"] = ShardStream(state.stream.perm, min(int(frac * l_new), l_new))
    if rows[0].get("table") is None or state.scoretable is None:
        return extra
    old_scores = np.stack([row["table"].numpy() for row in rows]).astype(np.float32)
    l_old = int(old_scores.shape[1])
    l_new = int(state.scoretable.scores.numel())
    old_sidx = _shard_index_matrix(trainer, w_old)
    new_sidx = _shard_index_matrix(trainer, w_new)
    if old_sidx.shape != (w_old, l_old) or new_sidx.shape != (w_new, l_new):
        # The recomputed partition disagrees with the saved shapes: the
        # fresh table stays.
        return extra
    n = int(_labels(trainer).size)
    # Rows the old run never held start at the EMA mean; a tiled duplicate
    # writes last (their scores differ only by refresh age).
    global_scores = np.full((n,), ema_val, np.float32)
    global_scores[old_sidx.reshape(-1)] = old_scores.reshape(-1)
    frac = float(np.mean(np.asarray([row["table_cursor"] for row in rows], np.float64))
                 / max(l_old, 1))
    extra["scoretable"] = ScoreTableState(
        torch.from_numpy(global_scores[new_sidx[r]].copy()).to(dev),
        int(frac * l_new) % max(l_new, 1))
    if rows[0].get("sel_counts") is not None and state.sel_counts is not None:
        old_counts = np.stack([row["sel_counts"].numpy() for row in rows]).astype(np.int64)
        if old_counts.shape == (w_old, l_old):
            # Additive: duplicates sum into the sample's count, which goes to
            # its first slot of the new matrix (later duplicates start at 0).
            global_counts = np.zeros((n,), np.int64)
            np.add.at(global_counts, old_sidx.reshape(-1), old_counts.reshape(-1))
            flat = new_sidx.reshape(-1)
            uniq, first_idx = np.unique(flat, return_index=True)
            new_counts = np.zeros((flat.size,), np.int64)
            new_counts[first_idx] = global_counts[uniq]
            extra["sel_counts"] = torch.from_numpy(
                new_counts.reshape(new_sidx.shape)[r].astype(np.int32)).to(dev)
    return extra


def _check_same(old: Dict[str, torch.Tensor], new: Dict[str, torch.Size], what: str
                ) -> None:
    """The file's tensors ``old`` against this run's whole shapes ``new``
    (by name)."""
    bad = sorted(set(old) ^ set(new)) or [k for k in new if old[k].shape != new[k]]
    if bad:
        raise ValueError(f"{what} differs from the checkpoint's at {bad[:3]}: an elastic "
                         "resume needs the same model and optimizer")


def elastic_restore(directory: str, trainer, step: Optional[int] = None,
                    raw: Optional[Dict[str, Any]] = None) -> int:
    """Restore ``directory``'s checkpoint (the newest, or ``step``'s; or
    ``raw``, a payload already read, with its ``step``), saved at any world
    size, into ``trainer`` built at its own; return the restored step. See
    the module docstring for what carries over. Every rank calls it; each
    reads the file itself and takes what belongs to its rank."""
    if raw is None:
        raw, step = probe_checkpoint(directory, step, strict=True)
    config, state = trainer.config, trainer.state
    r = trainer.rank
    for field in ("format", "zero_sharding", "grad_accum_steps"):
        saved = raw.get(field)
        have = ckpt.FORMAT if field == "format" else getattr(config, field)
        if saved != have:
            raise ValueError(f"checkpoint {step} in {directory} was saved with "
                             f"{field}={saved!r}, this run has {field}={have!r}: an "
                             "elastic resume keeps it")
    rows = raw["ranks"]
    w_old, w_new = len(rows), config.world_size
    journal = getattr(trainer, "_journal", None)
    begin_eid = None
    if journal is not None:
        table_old = rows[0].get("table")
        begin_eid = journal.emit(
            "elastic/reshard_begin", int(step),
            detail={"w_old": w_old, "w_new": w_new,
                    "l_old": None if table_old is None else int(table_old.numel()),
                    "l_new": (None if state.scoretable is None
                              else int(state.scoretable.scores.numel())),
                    "directory": directory})
    # A sharded model is held to the file's whole shapes.
    _check_same(raw["model"], full_shapes(state.model), "model")
    if config.zero_sharding:
        n = sum(p.numel() for p in state.model.parameters())
        old_opt = [row["optimizer"] for row in rows]
        chunk_states = _reshard_zero_opt([o["state"].get(0, {}) for o in old_opt], w_new, n)
        own = {"param_groups": old_opt[0]["param_groups"],
               "state": {0: chunk_states[r]} if chunk_states[r] else {}}
        accum = (None if rows[0]["accum"] is None else
                 [_rechunk([row["accum"][i] for row in rows], w_new, n)[r]
                  for i in range(len(rows[0]["accum"]))])
    else:
        own, accum = raw["optimizer"], raw["accum"]
    groups = [sorted(g) for g in own["param_groups"]]
    if groups != [sorted(g) for g in state.optimizer.state_dict()["param_groups"]]:
        raise ValueError(f"optimizer differs from the checkpoint's (param groups {groups}): "
                         "an elastic resume needs the same model and optimizer")
    # Under a second axis each rank takes its slices of the whole model,
    # moments and accumulator.
    load_full_state_dict(state.model, raw["model"])
    state.optimizer.load_state_dict(local_optimizer_state(state.model, own))
    if state.accum is not None:
        if not config.zero_sharding:
            accum = local_like_params(state.model, accum)
        for acc, saved in zip(state.accum, accum):
            acc.copy_(saved)
    state.step, state.updates, state.mini_step = raw["step"], raw["updates"], raw["mini_step"]
    dev = state.stream.perm.device
    ema_val = float(np.mean(np.asarray([row["ema_value"].item() for row in rows],
                                       np.float32)))
    ema_cnt = int(max(int(row["ema_count"].item()) for row in rows))
    state.ema = EMAState(torch.tensor(ema_val, dtype=torch.float32, device=dev),
                         torch.tensor(ema_cnt, dtype=torch.int32, device=dev))
    state.generator.manual_seed(elastic_seed(config.seed, r, state.step))
    carried = ["step", "model", "optimizer", "ema", "generator"]
    if config.stream_checkpoint_cursor:
        for field, value in _carry_streamed_state(trainer, rows, w_old, w_new,
                                                  ema_val).items():
            setattr(state, field, value)
            carried.append(field)
    # The ring holds selections of the old shards: the Trainer primes anew.
    state.pending = None
    if journal is not None:
        journal.emit("elastic/reshard_end", int(step), parent=begin_eid,
                     detail={"w_old": w_old, "w_new": w_new, "carried": sorted(carried)})
    return int(step)
