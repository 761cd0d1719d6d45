"""The Mercury pool step of the port, at one worker.

The PyTorch counterpart of the pool branch of
``mercury_tpu.train.step.make_train_step`` and of its ``train_update``.
One step:

1. takes the next ``P = presample_batches × batch_size`` slots of the
   worker's shuffled stream (``next_pool``);
2. gathers their uint8 rows from the device-resident dataset, normalizes
   and augments them (crop with pad 4, horizontal flip);
3. runs a train-mode scoring forward over the pool — batch statistics, the
   running statistics left as they were — without gradients;
4. scores every candidate by its per-sample NLL (``nll_fwd`` kernel);
5. updates the EMA of the mean pool loss, then smooths, normalizes and
   draws the batch by inverse CDF (``score_and_draw`` kernel);
6. trains on the drawn batch with the reweighted loss ``mean(loss/(N·p))``
   (``nll_fwd`` forward, ``nll_bwd`` backward) and applies the optimizer.

At one worker the gradient and BN-statistic means over workers are the
identity, so there are no collectives. With ``use_importance_sampling=False``
the step is the uniform control arm: the streamed batch itself, weight 1.

The step's random numbers are one :class:`Draws`: by default made from the
state's generator on the device; tests pass the JAX package's draws instead.
On the card, with ``compute_dtype="bfloat16"``, forwards run under bf16
autocast and the logits come back in float32.
"""

from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Optional

import torch

from mercury_tpu_torch.config import TrainConfig
from mercury_tpu_torch.data.pipeline import (
    ShardedDataset,
    augment_batch,
    next_pool,
    normalize_images,
)
from mercury_tpu_torch.ops import reference
from mercury_tpu_torch.ops.mercury_kernels import per_sample_nll, score_and_draw
from mercury_tpu_torch.sampling.importance import (
    ema_update,
    pool_mean,
    reweighted_loss,
)
from mercury_tpu_torch.train.state import MercuryState

CROP_PAD = 4


def to_nchw(images: torch.Tensor) -> torch.Tensor:
    """The model's NCHW view of NHWC images: channels_last in memory on
    the card; a contiguous copy on the CPU, where the backward through this
    network from a channels_last input aborted with heap corruption
    (torch 2.13.0+cpu)."""
    x = images.permute(0, 3, 1, 2)
    return x if x.is_cuda else x.contiguous()


class Draws(NamedTuple):
    """The random numbers of one step."""

    perm: Optional[torch.Tensor]  # [L] reshuffle permutation; read only if the stream wraps
    crop: torch.Tensor            # [P, 2] int crop offsets in [0, 2·pad]
    flip: torch.Tensor            # [P] bool horizontal flips
    uniforms: Optional[torch.Tensor]  # [1, B] float32 U(0,1) of the draw (IS only)


def pool_size(config: TrainConfig) -> int:
    return (config.candidate_pool_size if config.use_importance_sampling
            else config.batch_size)


def make_draws(state: MercuryState, config: TrainConfig) -> Draws:
    """One step's draws from the state's generator, on its device."""
    gen = state.generator
    dev = gen.device
    p = pool_size(config)
    length = state.stream.perm.shape[0]
    perm = None
    if state.stream.cursor + p > length:
        perm = torch.randperm(length, generator=gen, device=dev)
    crop = torch.randint(0, 2 * CROP_PAD + 1, (p, 2), generator=gen, device=dev)
    flip = torch.rand(p, generator=gen, device=dev) < 0.5
    uniforms = None
    if config.use_importance_sampling:
        uniforms = torch.rand((1, config.batch_size), generator=gen, device=dev)
    return Draws(perm=perm, crop=crop, flip=flip, uniforms=uniforms)


def make_train_step(
    config: TrainConfig, dataset: ShardedDataset,
) -> Callable[..., Dict[str, torch.Tensor]]:
    """Build ``step_fn(state, draws=None, use_kernels=True) → metrics``.

    ``step_fn`` advances ``state`` in place (model, optimizer, EMA, stream,
    step) and returns the step's metrics as device tensors — scalars, and
    the ``[B]`` pool positions drawn — so a caller that does not read them
    never waits for the device.
    ``use_kernels=False`` swaps the kernels for their plain versions on the
    same device — for holding one against the other, not for training."""
    use_is = config.use_importance_sampling
    p_size = pool_size(config)
    batch_size = config.batch_size
    bf16 = config.compute_dtype == "bfloat16"

    def ingest(raw: torch.Tensor, draws: Draws) -> torch.Tensor:
        images = normalize_images(raw, dataset.mean, dataset.std)
        if config.augmentation == "noniid":
            images = augment_batch(images, draws.crop, draws.flip, CROP_PAD)
        return images

    def step_fn(state: MercuryState, draws: Optional[Draws] = None,
                use_kernels: bool = True) -> Dict[str, torch.Tensor]:
        if draws is None:
            draws = make_draws(state, config)
        nll = per_sample_nll if use_kernels else reference.nll_forward
        select = score_and_draw if use_kernels else reference.score_and_draw
        model = state.model
        dev = state.stream.perm.device
        autocast = torch.autocast(device_type=dev.type, dtype=torch.bfloat16,
                                  enabled=bf16 and dev.type == "cuda")

        def need_perm() -> torch.Tensor:
            if draws.perm is None:
                raise ValueError("the stream wraps this step: draws.perm is required")
            return draws.perm

        stream, slots = next_pool(state.stream, p_size, need_perm)
        gidx = dataset.shard_indices[0][slots]
        images = ingest(dataset.x_train[gidx], draws)   # [P, H, W, C] float32
        labels = dataset.y_train[gidx]                  # [P] int32

        if use_is:
            with torch.no_grad(), autocast:
                pool_logits = model(to_nchw(images), train=True,
                                    keep_stats=False)
                pool_losses = nll(pool_logits, labels)
            avg_pool_loss = pool_mean(pool_losses)
            ema = ema_update(state.ema, avg_pool_loss, config.ema_alpha)
            _, selected, scaled_probs = select(
                pool_losses, ema.value, draws.uniforms, config.is_alpha)
            selected = selected.long()
            sel_images, sel_labels = images[selected], labels[selected]
        else:
            ema = state.ema
            selected = torch.arange(batch_size, device=dev)
            sel_images, sel_labels = images[:batch_size], labels[:batch_size]
            scaled_probs = torch.ones(batch_size, dtype=torch.float32, device=dev)
            avg_pool_loss = torch.zeros((), dtype=torch.float32, device=dev)

        # --- train update: reweighted forward/backward, optimizer step.
        lr = state.lr_schedule(state.step)
        for group in state.optimizer.param_groups:
            group["lr"] = lr
        state.optimizer.zero_grad(set_to_none=True)
        with autocast:
            logits = model(to_nchw(sel_images), train=True,
                           keep_stats=True)
        loss = reweighted_loss(nll(logits, sel_labels), scaled_probs)
        loss.backward()
        state.optimizer.step()

        state.step += 1
        state.ema = ema
        state.stream = stream
        with torch.no_grad():
            acc = (logits.argmax(dim=-1) == sel_labels).float().mean()
        return {
            "train/loss": loss.detach(),
            "train/acc": acc,
            "train/pool_loss": avg_pool_loss,
            "sampler/selected": selected,  # [B] pool positions trained on
        }

    return step_fn
