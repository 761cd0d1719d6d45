"""Run configuration of the PyTorch port.

The fields are those of ``mercury_tpu.config.TrainConfig`` that the
importance-sampled pool step reads, under the same names and with the same
defaults, so a configuration written for one package means the same run in
the other. A value the port does not implement yet raises ``ValueError``
naming the field, instead of silently training something else.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

_MODELS = ("resnet18", "resnet34", "resnet50")
_DATASETS = ("cifar10", "synthetic")


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Knobs of a Mercury run: ResNet-18 on CIFAR-10, batch 32, Adam at
    0.001×world_size with cosine decay, a 10×32 candidate pool drawn down
    to 32 by importance sampling."""

    # Model / data
    model: str = "resnet18"
    dataset: str = "cifar10"          # real files if present, else synthetic
    world_size: int = 4               # the port runs world_size=1 only

    # Optimization
    batch_size: int = 32
    base_lr: float = 0.001            # scaled by world_size
    optimizer: str = "adam"           # "adam" | "adamw" | "sgd"
    num_epochs: int = 100
    steps_per_epoch: Optional[int] = None  # None → n_train // batch_size
    weight_decay: float = 0.0
    warmup_steps: int = 0             # linear warmup, then cosine

    # Importance sampling
    use_importance_sampling: bool = True
    sampler: str = "pool"
    presample_batches: int = 10       # candidate pool = 10×batch
    is_alpha: float = 0.5             # score = loss + alpha·EMA
    ema_alpha: float = 0.9

    # Augmentation and partition
    augmentation: str = "noniid"      # pad-4 crop + hflip, or "none"
    noniid: bool = True
    dirichlet_alpha: float = 0.5
    min_shard_size: int = 10
    batch_norm: str = "sync"          # "sync" | "local": the same at W=1

    # Bookkeeping
    seed: int = 102
    eval_every: int = 200
    log_every: int = 100

    # Precision
    compute_dtype: str = "bfloat16"   # autocast dtype on the card
    param_dtype: str = "float32"

    # Kernels: the fused uint8 ingest kernel is not ported yet.
    fused_input: bool = False

    def __post_init__(self) -> None:
        def bad(field: str, why: str) -> None:
            raise ValueError(
                f"TrainConfig.{field}={getattr(self, field)!r}: {why}"
            )

        if self.model not in _MODELS:
            bad("model", f"the port builds {', '.join(_MODELS)}")
        if self.dataset not in _DATASETS:
            bad("dataset", f"the port loads {', '.join(_DATASETS)}")
        if self.world_size != 1:
            bad("world_size", "data parallelism (W>1) is not ported yet")
        if self.sampler != "pool":
            bad("sampler", "only the pool sampler is ported")
        if self.fused_input:
            bad("fused_input", "the fused ingest kernel is not ported yet")
        if self.augmentation not in ("noniid", "none"):
            bad("augmentation", "use 'noniid' or 'none'")
        if self.optimizer not in ("adam", "adamw", "sgd"):
            bad("optimizer", "use 'adam', 'adamw' or 'sgd'")
        if self.batch_norm not in ("sync", "local"):
            bad("batch_norm", "use 'sync' or 'local'")
        if self.compute_dtype not in ("bfloat16", "float32"):
            bad("compute_dtype", "use 'bfloat16' or 'float32'")
        if self.param_dtype != "float32":
            bad("param_dtype", "parameters are kept in float32")
        if self.batch_size < 1:
            bad("batch_size", "must be >= 1")
        if self.presample_batches < 1:
            bad("presample_batches", "must be >= 1")
        if self.warmup_steps < 0:
            bad("warmup_steps", "must be >= 0")

    @property
    def lr(self) -> float:
        """Linear-scaling rule: base_lr × world_size."""
        return self.base_lr * self.world_size

    @property
    def candidate_pool_size(self) -> int:
        """Per-step importance candidate count (10×32 = 320 by default)."""
        return self.presample_batches * self.batch_size

    def replace(self, **kw) -> "TrainConfig":
        return dataclasses.replace(self, **kw)
