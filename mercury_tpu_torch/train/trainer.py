"""A minimal trainer for the port: build the dataset on the device, build
the model and state, step, fit and evaluate.

The PyTorch counterpart of the core of ``mercury_tpu/train/trainer.py``.
It runs on the card: ``device=None`` means this rank's card (the current
CUDA device), and a machine without CUDA raises rather than training
somewhere else, unless the caller asked for the CPU (``device="cpu"``, as
the tests do).

At ``world_size=W>1`` every rank builds its own ``Trainer`` inside a
process group of W ranks (``torchrun --nproc_per_node=W`` with
``parallel.distributed.init_distributed``, or
``parallel.distributed.spawn``); without one the constructor raises
``ValueError``. The ranks start from the same weights (the model is seeded
by ``config.seed``), train on their own shards with their own draws and
keep their parameters equal through the step's collectives.

Beyond training: ``save``/``restore`` (``train/checkpoint.py``; ``fit``
saves every ``checkpoint_every`` steps and at its end when
``checkpoint_dir`` is set, and ``auto_resume`` restores the newest
checkpoint there at construction), ``predict`` (logits of raw images) and
``per_class_accuracy``.

With the scoretable sampler and ``telemetry`` the Trainer keeps a
``SamplerHealthMonitor`` (``obs/sampler_health.py``): at every
``log_every`` tick ``fit`` merges its seven ledger-derived keys into the
logged record (:meth:`Trainer.sampler_health`), and into its returned
dict when its last step is a tick. At W>1 rank 0 gathers every rank's
ledger, table and EMA for them at the tick; the other ranks log without.
"""

from __future__ import annotations

import logging
import math
from typing import Dict, Optional

import numpy as np
import torch

from mercury_tpu_torch.config import TrainConfig
from mercury_tpu_torch.data import cifar
from mercury_tpu_torch.data.partition import partition_data
from mercury_tpu_torch.data.pipeline import (
    ShardedDataset,
    eval_batches,
    make_sharded_dataset,
    normalize_images,
)
from mercury_tpu_torch.data.transforms import EVAL_RESIZE, IID_CROP, eval_transform_iid
from mercury_tpu_torch.models import create_model
from mercury_tpu_torch.models.resnet import set_sync_batch_norm
from mercury_tpu_torch.obs.sampler_health import SamplerHealthMonitor
from mercury_tpu_torch.ops.mercury_kernels import per_sample_nll
from mercury_tpu_torch.parallel import distributed
from mercury_tpu_torch.parallel.collectives import gather_to_rank0
from mercury_tpu_torch.train import checkpoint
from mercury_tpu_torch.train.state import MercuryState, create_state
from mercury_tpu_torch.train.step import Draws, make_train_step, to_nchw

_log = logging.getLogger(__name__)
EVAL_BATCH = 256


def resolve_device(device=None) -> torch.device:
    """``None`` → this rank's card; no card and no explicit device
    raises."""
    return distributed.device() if device is None else torch.device(device)


def build_dataset(config: TrainConfig, device, rank: int = 0) -> ShardedDataset:
    """Load, partition and place the dataset for worker ``rank``, as the JAX
    package's ``build_dataset`` does from the same config: every rank
    partitions the same way from the seed."""
    train, test, info = cifar.load_dataset(config.dataset, data_dir=config.data_dir,
                                           seed=config.seed)
    shards = partition_data(
        train[1], config.world_size,
        mode="hetero" if config.noniid else "homo",
        alpha=config.dirichlet_alpha, seed=config.seed,
        min_size=config.min_shard_size,
    )
    return make_sharded_dataset(
        train, test, shards, info["mean"], info["std"], info["num_classes"],
        device=torch.device(device), synthetic=info["synthetic"],
        rank=rank, placement=config.data_placement,
    )


class Trainer:
    """``Trainer(config)`` builds everything on the card; ``model`` may be
    passed in (the tests pass a small one), with the same weights on every
    rank."""

    def __init__(self, config: TrainConfig, device=None,
                 model: Optional[torch.nn.Module] = None) -> None:
        self.config = config
        self.rank = distributed.rank()
        self.device = resolve_device(device)
        self.dataset = build_dataset(config, self.device, self.rank)
        if config.num_classes is not None and config.num_classes != self.dataset.num_classes:
            raise ValueError(
                f"config.num_classes={config.num_classes} but dataset "
                f"{config.dataset!r} has {self.dataset.num_classes} classes")
        # Refuses a world_size that the process group does not have, and
        # label smoothing where the kernels would run.
        self._step_fn = make_train_step(config, self.dataset)
        # The IID evaluation's crop offsets, the same for every batch, as
        # the JAX package crops every batch with one fixed key (its offsets
        # differ from these: threefry is not Philox).
        self.eval_crop = torch.randint(
            0, EVAL_RESIZE - IID_CROP + 1, (EVAL_BATCH, 2),
            generator=torch.Generator().manual_seed(0), dtype=torch.int32).to(self.device)
        if model is None:
            gen = torch.Generator().manual_seed(config.seed)
            model = create_model(config.model, self.dataset.num_classes, gen)
        set_sync_batch_norm(model, config.batch_norm == "sync" and config.world_size > 1)
        self.steps_per_epoch = config.steps_per_epoch or max(
            self.dataset.n_train // config.batch_size, 1)
        self.total_steps = self.steps_per_epoch * config.num_epochs
        self.state: MercuryState = create_state(
            model, self.device, config.seed, self.dataset.shard_len,
            config.optimizer, config.lr, self.total_steps,
            config.weight_decay, config.warmup_steps,
            with_scoretable=config.use_scoretable, rank=self.rank,
            grad_accum_steps=config.grad_accum_steps,
            with_sel_counts=config.use_ledger,
        )
        self.sampler_monitor: Optional[SamplerHealthMonitor] = None
        if config.use_ledger:
            # The JAX Trainer's starvation share, until the SLO fields are
            # ported.
            self.sampler_monitor = SamplerHealthMonitor(
                self.dataset.shard_indices.cpu().numpy(),
                self.dataset.y_train.cpu().numpy(), self.dataset.num_classes,
                config.is_alpha, starvation_share=0.2)
        # Crash or preemption recovery: the newest checkpoint, sampler state
        # included; the first fit() then runs on to the original
        # total_steps.
        self._auto_resumed = False
        if (config.auto_resume and config.checkpoint_dir
                and checkpoint.latest_step(config.checkpoint_dir) is not None):
            step = self.restore()
            self._auto_resumed = True
            _log.info("auto-resumed from the checkpoint at step %d", step)

    def train_step(self, draws: Optional[Draws] = None,
                   use_kernels: bool = True) -> Dict[str, torch.Tensor]:
        """One step; metrics stay on the device."""
        return self._step_fn(self.state, draws, use_kernels)

    def fit(self, num_epochs: Optional[int] = None, *,
            steps: Optional[int] = None) -> Dict[str, float]:
        """Train ``num_epochs`` (default ``config.num_epochs``) epochs of
        ``steps_per_epoch`` steps from the current step, as the JAX
        package's ``fit`` does: the first call after an actual
        ``auto_resume`` runs to the absolute end of the schedule instead,
        and every call stops after the first step at which
        ``step × world_size`` exceeds ``step_budget``. ``steps=k`` runs
        ``k`` steps from here (under the same budget).

        Logs every ``log_every``, evaluates every ``eval_every`` and, with a
        ``checkpoint_dir``, saves every ``checkpoint_every`` steps and at
        the end. Returns the final evaluation (the last eval tick's, else a
        fresh :meth:`evaluate`), the last step's scalar metrics and, when
        the last step is a log tick, the sampler-health keys."""
        cfg = self.config
        start = self.state.step
        if steps is not None:
            target = start + steps
        elif self._auto_resumed:
            target = self.steps_per_epoch * (num_epochs or cfg.num_epochs)
        else:
            target = start + self.steps_per_epoch * (num_epochs or cfg.num_epochs)
        # The absolute horizon is the first call's only.
        self._auto_resumed = False
        end = min(target, int(cfg.step_budget // cfg.world_size) + 1)
        evaluation: Dict[str, float] = {}
        metrics: Dict[str, torch.Tensor] = {}
        health: Dict[str, float] = {}
        saved = None
        while self.state.step < end:
            metrics = self.train_step()
            step = self.state.step
            health = {}
            if cfg.log_every and step % cfg.log_every == 0:
                health = self.sampler_health()
                _log.info("step %d: %s", step, {**_scalars(metrics), **health})
            if cfg.eval_every and step % cfg.eval_every == 0:
                evaluation = self.evaluate()
            if cfg.checkpoint_dir and cfg.checkpoint_every and step % cfg.checkpoint_every == 0:
                self.save()
                saved = step
        if cfg.checkpoint_dir and saved != self.state.step:
            self.save()
        if not evaluation:
            evaluation = self.evaluate()
        return {**evaluation, **_scalars(metrics), **health}

    def sampler_health(self) -> Dict[str, float]:
        """The sampler-health monitor's keys of the ledger so far (none
        without a ledger). At W>1 every rank must call it at the same step:
        rank 0 gathers the rows and returns the keys of the ``[W, L]``
        ledger, the other ranks return none."""
        if self.sampler_monitor is None:
            return {}
        st = self.state
        rows = gather_to_rank0(tuple(t.cpu().numpy() for t in (
            st.sel_counts, st.scoretable.scores, st.ema.value)))
        if rows is None:
            return {}
        counts, scores, ema = (np.stack(col) for col in zip(*rows))
        return self.sampler_monitor.stats_of(counts, scores, ema)

    def _directory(self, directory: Optional[str]) -> str:
        directory = directory or self.config.checkpoint_dir
        if not directory:
            raise ValueError("TrainConfig.checkpoint_dir is None: set it or pass "
                             "a directory")
        return directory

    def save(self, directory: Optional[str] = None) -> str:
        """Save the whole state to ``directory`` (default
        ``checkpoint_dir``) as ``ckpt_<step>.pt``, keeping the newest
        ``checkpoint_keep``; return its path. At W>1 every rank calls it."""
        return checkpoint.save_checkpoint(self._directory(directory), self.state,
                                          self.config, keep=self.config.checkpoint_keep)

    def restore(self, directory: Optional[str] = None, step: Optional[int] = None) -> int:
        """Restore the checkpoint at ``step`` (default: the newest) from
        ``directory`` (default ``checkpoint_dir``); return its step."""
        return checkpoint.restore_checkpoint(self._directory(directory), self.state,
                                             self.config, step)

    def _logits(self, raw: torch.Tensor) -> torch.Tensor:
        """Inference-mode logits of ``EVAL_BATCH`` raw NHWC images on this
        device, normalized with the dataset's statistics (``/255`` for
        uint8 only) and, under ``augmentation="iid"``, resized to 33 and
        cropped at ``eval_crop``; under the step's autocast."""
        ds = self.dataset
        images = normalize_images(raw.to(self.device), ds.mean, ds.std)
        if self.config.augmentation == "iid":
            images = eval_transform_iid(images, self.eval_crop)
        with torch.autocast(device_type=self.device.type, dtype=torch.bfloat16,
                            enabled=(self.config.compute_dtype == "bfloat16"
                                     and self.device.type == "cuda")):
            return self.state.model(to_nchw(images), train=False)

    @torch.no_grad()
    def predict(self, inputs) -> torch.Tensor:
        """Float32 logits ``[N, num_classes]`` on the host of ``[N, H, W, C]``
        images (uint8 or float; a numpy array or a tensor; a single
        ``[H, W, C]`` image is one of one), in ``evaluate``'s batches of
        ``EVAL_BATCH`` (the last padded by wrapping, as there)."""
        x = torch.as_tensor(inputs)
        if x.dim() == self.dataset.x_test.dim() - 1:
            x = x[None]
        n = int(x.shape[0])
        out = torch.empty((n, self.dataset.num_classes), dtype=torch.float32)
        for idx_np, valid in eval_batches(n, EVAL_BATCH):
            logits = self._logits(x[torch.as_tensor(idx_np, device=x.device)])
            out[torch.as_tensor(idx_np[:valid])] = logits[:valid].float().cpu()
        return out

    def per_class_accuracy(self, train: bool = False) -> torch.Tensor:
        """Accuracy of each class over the test (or train) split, float64
        ``[num_classes]`` on the host; NaN for a class absent from the
        split."""
        ds = self.dataset
        x, y = (ds.x_train, ds.y_train) if train else (ds.x_test, ds.y_test)
        labels = y.cpu().long()
        hits = labels[self.predict(x).argmax(-1) == labels]
        totals = torch.bincount(labels, minlength=ds.num_classes).double()
        right = torch.bincount(hits, minlength=ds.num_classes).double()
        return torch.where(totals > 0, right / totals.clamp(min=1), math.nan)

    @torch.no_grad()
    def _eval_split(self, train: bool) -> Dict[str, float]:
        """Every rank evaluates the whole split with the same parameters
        and running statistics, and so reports the same numbers. Under
        sharded placement the train split is read from the host."""
        ds = self.dataset
        x, y = (ds.x_train, ds.y_train) if train else (ds.x_test, ds.y_test)
        n = int(x.shape[0])
        loss_sum = torch.zeros((), dtype=torch.float32, device=self.device)
        correct = torch.zeros((), dtype=torch.float32, device=self.device)
        for idx_np, valid in eval_batches(n, EVAL_BATCH):
            idx = torch.as_tensor(idx_np, device=x.device)
            mask = torch.as_tensor(np.arange(EVAL_BATCH) < valid,
                                   device=self.device)
            labels = y[idx].to(self.device)
            logits = self._logits(x[idx])
            loss_sum += torch.where(mask, per_sample_nll(logits, labels), 0.0).sum()
            correct += ((logits.argmax(-1) == labels) & mask).sum()
        prefix = "train" if train else "test"
        return {f"{prefix}/eval_loss": float(loss_sum) / n,
                f"{prefix}/eval_acc": float(correct) / n}

    def evaluate(self, include_train: bool = True) -> Dict[str, float]:
        """Inference-mode pass over the test split (and the train split)."""
        out: Dict[str, float] = {}
        if include_train:
            out.update(self._eval_split(train=True))
        out.update(self._eval_split(train=False))
        return out


def _scalars(metrics: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(v) for k, v in metrics.items() if v.numel() == 1}
