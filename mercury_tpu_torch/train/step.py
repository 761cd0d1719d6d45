"""The Mercury step of the port: one rank's share of a data-parallel step.

The PyTorch counterpart of the pool and sync-scoretable branches of
``mercury_tpu.train.step.make_train_step`` and of its ``train_update``.
A pool step (``sampler="pool"``):

1. takes the next ``P = presample_batches × batch_size`` slots of the
   worker's shuffled stream (``next_pool``);
2. gathers their uint8 rows from the device-resident dataset and ingests
   them (:func:`ingest`: normalize, then under ``augmentation="noniid"``
   crop with pad 4, horizontal flip and, with ``cutout``, cutout; under
   ``"iid"`` the IID transform of ``data/transforms.py``);
3. runs a train-mode scoring forward over the pool — batch statistics, the
   running statistics left as they were — without gradients;
4. scores every candidate by its per-sample NLL (``nll_fwd`` kernel), or
   under ``importance_score="grad_norm"`` by the norm of the loss's
   gradient with respect to its logits (then ``train/pool_loss`` takes one
   more ``nll_fwd`` over the same logits);
5. updates the EMA of the mean score, then smooths, normalizes and
   draws the batch by inverse CDF (``score_and_draw`` kernel);
6. trains on the drawn batch with the reweighted loss ``mean(loss/(N·p))``
   (``nll_fwd`` forward, ``nll_bwd`` backward) and applies the optimizer;
   at ``grad_accum_steps=A > 1`` it folds the gradient into the
   accumulator instead and applies the update every A-th step
   (:func:`accumulate`). The BN running statistics, the EMA and the stream
   or score table advance every step either way.

A scoretable step (``sampler="scoretable"``) keeps a score for every slot
of the shard instead of a stream:

1. the refresh window ``(cursor + arange(R)) % L``: gather, ingest, scoring
   forward and ``nll_fwd`` as above, over ``R`` rows;
2. the EMA update from the window's mean score;
3. decay, scatter of the window's scores, normalization and draw over the
   whole table (``table_refresh_draw`` kernel);
4. gather and ingest of the drawn slots, and the same reweighted update
   (``p·L`` in place of ``p·N``);
5. the write-back: the trained batch's per-sample losses, already computed
   for the loss, are scatter-averaged into the table (no third ``nll_fwd``
   launch; under ``"grad_norm"`` their gradient norms), and the cursor
   advances by ``R``. The stream is not read.

With ``fused_input`` every ingest is one ``augment_normalize`` kernel
launch that gathers the uint8 rows itself (its ``rows``): no separate
gather of the images. With ``use_importance_sampling=False`` the step is
the uniform control arm: the streamed batch itself, weight 1.

At ``world_size=W>1`` each rank runs this step on its own shard (row
``dataset.rank`` of the partition) with its own draws, in a process group
of W ranks, and these cross the ranks (``parallel/collectives.py``):

- with ``batch_norm="sync"``, every BN layer's batch statistics, in the
  scoring forward, the train forward and the backward (one all-reduce a
  layer in each);
- with ``sync_importance_stats``, the pool mean feeding the EMA (a sum and
  a count);
- the gradients, as one bucket before the optimizer step;
- the BN running statistics, as one bucket after it (under ``"local"``
  too);
- the metrics: ``train/loss`` and ``train/pool_loss`` as means over the
  ranks, ``train/acc`` as the global correct count over the global count.

At W=1 the step issues no collective and needs no process group.

With ``config.telemetry`` (the default, as in the JAX package) the step
also returns the sampler's health (``obs/``): ``sampler/ess``,
``sampler/clip_frac``, ``sampler/ema_drift``, ``train/grad_norm`` (after the
all-reduce, before the optimizer or the accumulator) and, with importance
sampling, the IS weights' histogram ``sampler_dist/w_hist/b00..b15``; on the
scoretable path also ``sampler/table_age_{min,mean,max}``, the refreshed
table's histogram ``sampler_dist/score_hist/b00..b15``, and it adds each
trained slot to the ledger ``state.sel_counts``. With
``variance_probe_every=K > 0`` every K-th step runs one more no-grad forward
of the drawn batch through the pre-update model for
``sampler_dist/var_ratio`` (−1.0 on the other steps). At W>1 the scalars are
means over the ranks and the histograms sums, carried by the metrics'
all-reduce. With ``telemetry=False`` none of this is computed.

With ``label_smoothing`` the per-sample loss is the smoothed cross-entropy
of the plain PyTorch ops: the step needs ``use_pallas=False`` on the card.

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
from mercury_tpu_torch.data.transforms import (
    IID_CROP,
    IID_RESIZE,
    MAX_ROTATE_DEG,
    SCALE_RANGE,
    augment_batch_iid,
)
from mercury_tpu_torch.obs.diagnostics import (
    clip_fraction,
    ema_drift,
    ess_fraction,
    global_grad_norm,
    table_age_summary,
)
from mercury_tpu_torch.obs.sampler_health import (
    HIST_BINS,
    SCORE_HIST_HI,
    SCORE_HIST_LO,
    WEIGHT_HIST_HI,
    WEIGHT_HIST_LO,
    hist_keys,
    log_bin_histogram,
    variance_probe_ratio,
)
from mercury_tpu_torch.ops import reference
from mercury_tpu_torch.ops.mercury_kernels import (
    augment_normalize,
    per_sample_nll,
    score_and_draw,
    table_refresh_draw,
)
from mercury_tpu_torch.parallel.collectives import allreduce_mean_, allreduce_sum
from mercury_tpu_torch.parallel.distributed import require_world
from mercury_tpu_torch.sampling.importance import (
    ema_update,
    per_sample_grad_norm_bound,
    per_sample_loss,
    pool_mean,
    reweighted_loss,
)
from mercury_tpu_torch.sampling.scoretable import (
    ScoreTableState,
    advance_cursor,
    refresh_window,
    scatter_mean,
)
from mercury_tpu_torch.train.state import MercuryState

CROP_PAD = 4
IMAGE_SIZE = 32  # CIFAR's side: the range of the cutout centres


def to_nchw(images: torch.Tensor) -> torch.Tensor:
    """The model's NCHW view of NHWC images: channels_last in memory on
    the card; a contiguous copy on the CPU, where the backward through this
    network from a channels_last input aborted with heap corruption
    (torch 2.13.0+cpu)."""
    x = images.permute(0, 3, 1, 2)
    return x if x.is_cuda else x.contiguous()


class Augment(NamedTuple):
    """The random numbers of one ingest of ``n`` images."""

    crop: torch.Tensor                    # [n, 2] int32 offsets in [0, 2·pad] (iid: [0, 3])
    flip: torch.Tensor                    # [n] bool horizontal flips
    theta: Optional[torch.Tensor] = None  # [n] float32 radians (iid only)
    scale: Optional[torch.Tensor] = None  # [n] float32 (iid only)
    cut: Optional[torch.Tensor] = None    # [n, 2] int32 cutout centres (noniid cutout only)


class Draws(NamedTuple):
    """The random numbers of one step. ``aug`` augments the rows scored
    first — the pool, or the scoretable's refresh window (the JAX step's
    ``k_aug``); ``aug2`` the drawn train batch of the scoretable step,
    which gathers its rows anew (``k_aug2``)."""

    perm: Optional[torch.Tensor]  # [L] reshuffle permutation; read only if the stream wraps
    aug: Augment                  # P or R images
    uniforms: Optional[torch.Tensor]  # [1, B] float32 U(0,1) of the draw (IS only)
    aug2: Optional[Augment] = None    # B images (scoretable only)


def pool_size(config: TrainConfig) -> int:
    return (config.candidate_pool_size if config.use_importance_sampling
            else config.batch_size)


def make_draws(state: MercuryState, config: TrainConfig) -> Draws:
    """One step's draws from the state's generator, on its device."""
    gen = state.generator
    dev = gen.device

    iid = config.augmentation == "iid"

    def uniform(n: int, lo: float, hi: float) -> torch.Tensor:
        return lo + (hi - lo) * torch.rand(n, generator=gen, device=dev)

    def augment_draws(n: int) -> Augment:
        """The crop offsets and flips of ``n`` images, then the IID
        transform's angles and scales, or the cutout centres."""
        hi = IID_RESIZE - IID_CROP if iid else 2 * CROP_PAD
        aug = Augment(torch.randint(0, hi + 1, (n, 2), generator=gen, device=dev,
                                    dtype=torch.int32),
                      torch.rand(n, generator=gen, device=dev) < 0.5)
        if iid:
            theta = torch.deg2rad(uniform(n, -MAX_ROTATE_DEG, MAX_ROTATE_DEG))
            return aug._replace(theta=theta, scale=uniform(n, *SCALE_RANGE))
        if config.cutout and config.augmentation == "noniid":
            return aug._replace(cut=torch.randint(0, IMAGE_SIZE, (n, 2), generator=gen,
                                                  device=dev, dtype=torch.int32))
        return aug

    def uniforms():
        return torch.rand((1, config.batch_size), generator=gen, device=dev)

    if config.use_scoretable:
        aug = augment_draws(config.refresh_size)
        return Draws(perm=None, aug=aug, uniforms=uniforms(),
                     aug2=augment_draws(config.batch_size))
    p = pool_size(config)
    length = state.stream.perm.shape[0]
    perm = None
    if state.stream.cursor + p > length:
        perm = torch.randperm(length, generator=gen, device=dev)
    aug = augment_draws(p)
    return Draws(perm=perm, aug=aug,
                 uniforms=uniforms() if config.use_importance_sampling else None)


def set_lr(state: MercuryState) -> None:
    """The learning rate of the next update, ``lr_schedule(updates)``."""
    lr = state.lr_schedule(state.updates)
    for group in state.optimizer.param_groups:
        group["lr"] = lr


@torch.no_grad()
def accumulate(state: MercuryState, accum_steps: int) -> None:
    """optax.MultiSteps for one microstep: fold the gradients into the
    running mean ``acc + (g − acc) / (mini_step + 1)`` (its ``_acc_update``;
    a sum divided at the end would round otherwise), and on the
    ``accum_steps``-th microstep apply the mean as the gradient at
    ``lr_schedule(updates)`` and zero the accumulator. Between updates the
    parameters and the optimizer state do not change."""
    params = list(state.model.parameters())
    diff = torch._foreach_sub([p.grad for p in params], state.accum)
    torch._foreach_div_(diff, float(state.mini_step + 1))
    torch._foreach_add_(state.accum, diff)
    state.mini_step += 1
    if state.mini_step < accum_steps:
        return
    for p, acc in zip(params, state.accum):
        p.grad = acc
    set_lr(state)
    state.optimizer.step()
    state.optimizer.zero_grad(set_to_none=True)
    torch._foreach_zero_(state.accum)
    state.mini_step = 0
    state.updates += 1


def make_train_step(
    config: TrainConfig, dataset: ShardedDataset,
) -> Callable[..., Dict[str, torch.Tensor]]:
    """Build ``step_fn(state, draws=None, use_kernels=True) → metrics``.

    ``step_fn`` advances ``state`` in place (model, optimizer, EMA, stream
    or score table, step, and the accumulator at ``grad_accum_steps > 1``)
    and returns the step's metrics as device tensors
    — scalars, the ``[B]`` pool positions or table slots drawn and the
    distribution they were drawn from — so a caller that does not read
    them never waits for the device. The three table ages, which the host
    knows from the cursor, are float32 CPU scalars.
    ``use_kernels=False`` swaps the kernels for their plain versions on the
    same device — for holding one against the other, not for training;
    ``config.use_pallas=False`` does so for every step.
    At W>1 the process group must have ``config.world_size`` ranks.

    ``config.label_smoothing`` needs the plain versions (the NLL kernels
    compute the plain NLL): it raises ``ValueError`` where the kernels
    would run, that is with ``use_pallas=True``, or ``None`` on the card."""
    require_world(config.world_size)
    world_size = config.world_size
    use_is = config.use_importance_sampling
    use_table = config.use_scoretable
    sync_stats = use_is and config.sync_importance_stats and world_size > 1
    p_size = pool_size(config)
    batch_size = config.batch_size
    refresh_size = config.refresh_size
    bf16 = config.compute_dtype == "bfloat16"
    accum_steps = config.grad_accum_steps
    telemetry = config.telemetry
    if telemetry and use_table:
        # The ages are a rotation of the same L values at every cursor.
        ages = {f"sampler/table_age_{name}": torch.tensor(value, dtype=torch.float32)
                for name, value in zip(("min", "mean", "max"),
                                       table_age_summary(dataset.shard_len, refresh_size))}
    if dataset.x_shard is not None:
        # Sharded placement: the rank's own rows, indexed by slot.
        x_rows, y_rows, shard_row = dataset.x_shard, dataset.y_shard, None
    else:
        x_rows, y_rows = dataset.x_train, dataset.y_train
        shard_row = dataset.shard_indices[dataset.rank]
    smoothing = config.label_smoothing
    # use_pallas, resolved once: False is the plain versions, on the card
    # too; True or None the wrappers, which launch the kernels on CUDA
    # tensors and run the plain versions on CPU ones. Smoothing is refused
    # wherever a kernel would launch (the kernels compute the plain NLL).
    kernels = config.use_pallas is not False
    if smoothing != 0.0 and kernels and (config.use_pallas or x_rows.device.type == "cuda"):
        raise ValueError("use_pallas requires label_smoothing == 0")
    grad_norm_scores = config.importance_score == "grad_norm"
    mean_t = torch.as_tensor(dataset.mean, dtype=torch.float32, device=x_rows.device)
    std_t = torch.as_tensor(dataset.std, dtype=torch.float32, device=x_rows.device)

    def gather(slots: torch.Tensor):
        """The rows of ``x_rows`` that hold shard ``slots``, and their
        labels."""
        rows = slots if shard_row is None else shard_row[slots]
        return rows, y_rows[rows]

    def ingest(gidx: torch.Tensor, use_kernels: bool, aug: Augment) -> torch.Tensor:
        """Rows ``gidx`` of ``x_rows`` → augmented, normalized float32 NHWC
        images: with ``fused_input`` one ``augment_normalize`` launch that
        gathers the uint8 rows itself, the gather and the op chain
        otherwise."""
        if config.fused_input:
            if use_kernels:
                return augment_normalize(x_rows, mean_t, std_t, aug.crop, aug.flip,
                                         CROP_PAD, rows=gidx)
            return reference.augment_normalize(x_rows[gidx], mean_t, std_t,
                                               aug.crop, aug.flip, CROP_PAD)
        images = normalize_images(x_rows[gidx], dataset.mean, dataset.std)
        # As the JAX step's _augment: cutout rides on the noniid crop and
        # flip only; under "iid" and "none" the flag is ignored.
        if config.augmentation == "noniid":
            images = augment_batch(images, aug.crop, aug.flip, CROP_PAD,
                                   _need(aug.cut, "cut") if config.cutout else None)
        elif config.augmentation == "iid":
            images = augment_batch_iid(images, aug.crop, aug.flip, _need(aug.theta, "theta"),
                                       _need(aug.scale, "scale"))
        return images

    def step_fn(state: MercuryState, draws: Optional[Draws] = None,
                use_kernels: bool = True) -> Dict[str, torch.Tensor]:
        if draws is None:
            draws = make_draws(state, config)
        use_kernels = use_kernels and kernels
        if smoothing != 0.0:
            def loss_of(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
                return per_sample_loss(logits, labels, smoothing)
        else:
            loss_of = per_sample_nll if use_kernels else reference.nll_forward

        def score_of(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
            """The candidates' scores: the JAX step's ``_score_per_sample``."""
            if grad_norm_scores:
                return per_sample_grad_norm_bound(logits.float(), labels, smoothing)
            return loss_of(logits, labels)

        model = state.model
        dev = state.stream.perm.device
        autocast = torch.autocast(device_type=dev.type, dtype=torch.bfloat16,
                                  enabled=bf16 and dev.type == "cuda")

        def score(images: torch.Tensor, labels: torch.Tensor):
            """Train-mode scoring forward (running statistics left alone)
            and the per-sample scores, without gradients; returns the
            scores and the logits."""
            with torch.no_grad(), autocast:
                logits = model(to_nchw(images), train=True, keep_stats=False)
                return score_of(logits, labels), logits

        def pool_loss(logits: torch.Tensor, labels: torch.Tensor,
                      score_avg: torch.Tensor) -> torch.Tensor:
            """``train/pool_loss``: the mean loss of the scored rows, the
            scores' mean unless the scores are gradient norms (the JAX
            step's ``_pool_loss_metric``)."""
            if not grad_norm_scores:
                return score_avg
            with torch.no_grad():
                return pool_mean(loss_of(logits, labels), sync_stats)

        def probe_var_ratio(images: torch.Tensor, labels: torch.Tensor,
                            scaled_probs: torch.Tensor) -> torch.Tensor:
            """The grad-variance probe: the drawn batch through the
            pre-update model (train mode, running statistics left alone,
            no gradients), the gradient-norm bounds of its logits and
            their two moments, pooled over the ranks before the ratio."""
            with torch.no_grad():
                with autocast:
                    logits = model(to_nchw(images), train=True, keep_stats=False)
                g = per_sample_grad_norm_bound(logits.float(), labels, smoothing)
                return variance_probe_ratio(
                    g, scaled_probs, mean=lambda v: pool_mean(v, sync_stats))

        stream, ema, table = state.stream, state.ema, state.scoretable
        if use_table:
            r_slots = refresh_window(table, refresh_size)
            r_rows, r_labels = gather(r_slots)
            r_scores, r_logits = score(
                ingest(r_rows, use_kernels, draws.aug), r_labels)
            score_avg = pool_mean(r_scores, sync_stats)
            ema_prev = ema.value
            ema = ema_update(ema, score_avg, config.ema_alpha)
            refresh_draw = (table_refresh_draw if use_kernels
                            else reference.table_refresh_draw)
            new_scores, probs, selected, scaled_probs = refresh_draw(
                table.scores, r_slots, r_scores, ema.value, draws.uniforms,
                config.is_alpha, config.table_decay)
            selected = selected.long()
            if telemetry:
                # Over the whole refreshed table, before the write-back:
                # what the draw normalized.
                clip = clip_fraction(new_scores, ema.value, config.is_alpha)
                drift = ema_drift(score_avg, ema_prev)
            avg_pool_loss = pool_loss(r_logits, r_labels, score_avg)
            sel_rows, sel_labels = gather(selected)
            sel_images = ingest(sel_rows, use_kernels, draws.aug2)
        else:
            def need_perm() -> torch.Tensor:
                if draws.perm is None:
                    raise ValueError("the stream wraps this step: draws.perm is required")
                return draws.perm

            stream, slots = next_pool(stream, p_size, need_perm)
            rows, labels = gather(slots)
            images = ingest(rows, use_kernels, draws.aug)  # [P, H, W, C]
            if use_is:
                pool_scores, pool_logits = score(images, labels)
                score_avg = pool_mean(pool_scores, sync_stats)
                ema_prev = ema.value
                ema = ema_update(ema, score_avg, config.ema_alpha)
                select = score_and_draw if use_kernels else reference.score_and_draw
                probs, selected, scaled_probs = select(
                    pool_scores, ema.value, draws.uniforms, config.is_alpha)
                selected = selected.long()
                sel_images, sel_labels = images[selected], labels[selected]
                if telemetry:
                    clip = clip_fraction(pool_scores, ema.value, config.is_alpha)
                    drift = ema_drift(score_avg, ema_prev)
                avg_pool_loss = pool_loss(pool_logits, labels, score_avg)
            else:
                probs = None
                selected = torch.arange(batch_size, device=dev)
                sel_images, sel_labels = images[:batch_size], labels[:batch_size]
                scaled_probs = torch.ones(batch_size, dtype=torch.float32, device=dev)
                avg_pool_loss = torch.zeros((), dtype=torch.float32, device=dev)
                if telemetry:
                    # Nothing scored: nothing clips or drifts.
                    clip = drift = torch.zeros((), dtype=torch.float32, device=dev)

        # The probe's cadence counts the steps after this one, as the JAX
        # step's metric records do.
        probe = config.use_probe and (state.step + 1) % config.variance_probe_every == 0
        if probe:
            var_ratio = probe_var_ratio(sel_images, sel_labels, scaled_probs)

        # --- train update: reweighted forward/backward, optimizer step (at
        # A > 1 the gradient is folded into the accumulator instead, and
        # every A-th microstep applies it).
        if state.accum is None:
            set_lr(state)
        state.optimizer.zero_grad(set_to_none=True)
        with autocast:
            logits = model(to_nchw(sel_images), train=True,
                           keep_stats=True)
        train_losses = loss_of(logits, sel_labels)
        loss = reweighted_loss(train_losses, scaled_probs)
        loss.backward()
        grads = [p.grad for p in model.parameters() if p.grad is not None]
        if world_size > 1:
            allreduce_mean_(grads)
        if telemetry:
            # This (micro)step's gradient, equal on every rank.
            grad_norm = global_grad_norm(grads)
        if state.accum is None:
            state.optimizer.step()
            state.updates += 1
        else:
            accumulate(state, accum_steps)
        if world_size > 1:
            # Averaged under "sync" (already equal) and "local" alike, as
            # the JAX step averages batch_stats.
            allreduce_mean_([b for name, b in model.named_buffers()
                             if name.endswith(("running_mean", "running_var"))])

        if use_table:
            # Write-back: the trained slots' fresh scores, duplicates
            # averaged — under "loss" the loss's own per-sample values of
            # the float32 logits (the numbers the JAX step recomputes from
            # the same logits, no third NLL), under "grad_norm" the norms.
            with torch.no_grad():
                fresh = (score_of(logits.detach(), sel_labels) if grad_norm_scores
                         else train_losses.detach())
                scores = scatter_mean(new_scores, selected, fresh)
                if config.use_ledger:
                    if state.sel_counts is None:  # a state built without one
                        state.sel_counts = torch.zeros_like(scores, dtype=torch.int32)
                    # One count an occurrence: a slot drawn twice counts twice.
                    state.sel_counts.index_add_(
                        0, selected, torch.ones_like(selected, dtype=torch.int32))
            table = ScoreTableState(scores, advance_cursor(table, refresh_size))
        state.step += 1
        state.ema = ema
        state.stream = stream
        state.scoretable = table
        means: Dict[str, torch.Tensor] = {}  # telemetry scalars, averaged at W>1
        hists: Dict[str, torch.Tensor] = {}  # telemetry histograms, summed at W>1
        with torch.no_grad():
            if telemetry:
                means = {"sampler/ess": ess_fraction(scaled_probs),
                         "sampler/clip_frac": clip, "sampler/ema_drift": drift}
                if probe:
                    means["sampler_dist/var_ratio"] = var_ratio
                if use_is:
                    hists["w_hist"] = log_bin_histogram(scaled_probs, WEIGHT_HIST_LO,
                                                        WEIGHT_HIST_HI)
                if use_table:
                    # The table after the write-back: what the next draw reads.
                    hists["score_hist"] = log_bin_histogram(table.scores, SCORE_HIST_LO,
                                                            SCORE_HIST_HI)
            hits = logits.argmax(dim=-1) == sel_labels
            loss = loss.detach()
            if world_size == 1:
                acc = hits.float().mean()
            else:
                # One all-reduce: [Σ loss, Σ pool loss, Σ correct, Σ count],
                # then the telemetry's scalars and its histograms' counts in
                # float32 (exact below 2²⁴).
                flat = torch.stack([loss, avg_pool_loss, hits.float().sum(),
                                    loss.new_full((), hits.numel()), *means.values()])
                if hists:
                    flat = torch.cat([flat, *(h.float() for h in hists.values())])
                sums = allreduce_sum(flat)
                loss, avg_pool_loss = sums[0] / world_size, sums[1] / world_size
                acc = sums[2] / sums[3]
                at = 4
                for key in means:
                    means[key] = sums[at] / world_size
                    at += 1
                for key in hists:
                    hists[key] = sums[at:at + HIST_BINS].to(torch.int32)
                    at += HIST_BINS
        metrics = {
            "train/loss": loss,
            "train/acc": acc,
            "train/pool_loss": avg_pool_loss,
            # [B] pool positions, or table slots, trained on
            "sampler/selected": selected,
        }
        if probs is not None:
            metrics["sampler/probs"] = probs  # [P] or [L]: what the batch was drawn from
        if telemetry:
            metrics.update(means)
            metrics["train/grad_norm"] = grad_norm
            if use_table:
                metrics.update(ages)
            for family, counts in hists.items():
                metrics.update(zip(hist_keys(family), counts))
            if config.use_probe and not probe:
                metrics["sampler_dist/var_ratio"] = torch.full(
                    (), -1.0, dtype=torch.float32, device=dev)
        return metrics

    return step_fn


def _need(value: Optional[torch.Tensor], name: str) -> torch.Tensor:
    if value is None:
        raise ValueError(f"this configuration's step needs the draws' {name}")
    return value
