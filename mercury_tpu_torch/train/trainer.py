"""A minimal trainer for the port: build the dataset on the device, build
the model and state, step, fit and evaluate.

The PyTorch counterpart of the core of ``mercury_tpu/train/trainer.py`` at
one worker. It runs on the card: ``device=None`` means ``"cuda"``, and a
machine without CUDA raises rather than training somewhere else, unless the
caller asked for the CPU (``device="cpu"``, as the tests do).
"""

from __future__ import annotations

import logging
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
from mercury_tpu_torch.models import create_model
from mercury_tpu_torch.ops.mercury_kernels import per_sample_nll
from mercury_tpu_torch.train.state import MercuryState, create_state
from mercury_tpu_torch.train.step import Draws, make_train_step, to_nchw

_log = logging.getLogger(__name__)
EVAL_BATCH = 256


def resolve_device(device=None) -> torch.device:
    """``None`` → the card; no card and no explicit device raises."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: the port trains on the GPU. Pass "
                "device='cpu' to run on the CPU deliberately.")
        return torch.device("cuda")
    return torch.device(device)


def build_dataset(config: TrainConfig, device) -> ShardedDataset:
    """Load, partition and place the dataset, as the JAX package's
    ``build_dataset`` does from the same config."""
    train, test, info = cifar.load_dataset(config.dataset, seed=config.seed)
    shards = partition_data(
        train[1], config.world_size,
        mode="hetero" if config.noniid else "homo",
        alpha=config.dirichlet_alpha, seed=config.seed,
        min_size=config.min_shard_size,
    )
    return make_sharded_dataset(
        train, test, shards, info["mean"], info["std"], info["num_classes"],
        device=torch.device(device), synthetic=info["synthetic"],
    )


class Trainer:
    """``Trainer(config)`` builds everything on the card; ``model`` may be
    passed in (the tests pass a small one)."""

    def __init__(self, config: TrainConfig, device=None,
                 model: Optional[torch.nn.Module] = None) -> None:
        self.config = config
        self.device = resolve_device(device)
        self.dataset = build_dataset(config, self.device)
        if model is None:
            gen = torch.Generator().manual_seed(config.seed)
            model = create_model(config.model, self.dataset.num_classes, gen)
        self.steps_per_epoch = config.steps_per_epoch or max(
            self.dataset.n_train // config.batch_size, 1)
        self.total_steps = self.steps_per_epoch * config.num_epochs
        self.state: MercuryState = create_state(
            model, self.device, config.seed, self.dataset.shard_len,
            config.optimizer, config.lr, self.total_steps,
            config.weight_decay, config.warmup_steps,
            with_scoretable=config.use_scoretable,
        )
        self._step_fn = make_train_step(config, self.dataset)

    def train_step(self, draws: Optional[Draws] = None,
                   use_kernels: bool = True) -> Dict[str, torch.Tensor]:
        """One step; metrics stay on the device."""
        return self._step_fn(self.state, draws, use_kernels)

    def fit(self, steps: Optional[int] = None) -> Dict[str, float]:
        """Run ``steps`` steps (default: the whole schedule), logging every
        ``log_every`` and evaluating every ``eval_every`` steps. Returns the
        last step's scalar metrics and the last evaluation."""
        steps = self.total_steps - self.state.step if steps is None else steps
        out: Dict[str, float] = {}
        metrics: Dict[str, torch.Tensor] = {}
        for _ in range(steps):
            metrics = self.train_step()
            step = self.state.step
            if self.config.log_every and step % self.config.log_every == 0:
                _log.info("step %d: %s", step, _scalars(metrics))
            if self.config.eval_every and step % self.config.eval_every == 0:
                out.update(self.evaluate())
        out.update(_scalars(metrics))
        return out

    @torch.no_grad()
    def _eval_split(self, train: bool) -> Dict[str, float]:
        ds = self.dataset
        x, y = (ds.x_train, ds.y_train) if train else (ds.x_test, ds.y_test)
        n = int(x.shape[0])
        loss_sum = torch.zeros((), dtype=torch.float32, device=self.device)
        correct = torch.zeros((), dtype=torch.float32, device=self.device)
        bf16 = self.config.compute_dtype == "bfloat16"
        for idx_np, valid in eval_batches(n, EVAL_BATCH):
            idx = torch.as_tensor(idx_np, device=self.device)
            mask = torch.as_tensor(np.arange(EVAL_BATCH) < valid,
                                   device=self.device)
            images = normalize_images(x[idx], ds.mean, ds.std)
            with torch.autocast(device_type=self.device.type,
                                dtype=torch.bfloat16,
                                enabled=bf16 and self.device.type == "cuda"):
                logits = self.state.model(to_nchw(images), train=False)
            loss_sum += torch.where(mask, per_sample_nll(logits, y[idx]), 0.0).sum()
            correct += ((logits.argmax(-1) == y[idx]) & mask).sum()
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
