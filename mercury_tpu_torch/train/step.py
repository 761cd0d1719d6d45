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

Under ``refresh_mode="async"`` (the JAX step's async branch) a scorer fleet
rescores the windows off the step (``sampling/scorer_fleet.py``, applied by
the Trainer), so the step scores nothing: it decays, normalizes and draws
over the whole table — the kernel route through ``table_refresh_draw``
with a one-slot window that writes slot 0's own decayed value back (a
no-op, so one kernel serves both modes), the plain route by
``decay_scores``, ``table_probs`` and ``table_draw_inverse_cdf`` — then
trains, updates the EMA from the trained batch's scores reweighted to the
shard's mean (``mean(s/(L·p))``), writes them back and keeps the cursor.
``train/pool_loss`` is 0 and the table ages are not reported.

The pool sampler has three step modes (the JAX step's pipelined, cadence
and groupwise branches):

- ``pipelined_scoring``: the step trains on the batch it selected the step
  before (``state.pending_batch``: the scored images, labels and ``p·P``)
  and scores the next pool (steps 1-5 above, ``score_and_draw`` included)
  before the optimizer step, so with the pre-update weights. Step 0 first
  scores a boot pool with ``draws.boot`` and trains on its draw, so the
  stream and the EMA advance twice. The clip share and drift are the next
  pool's; the ESS and the weights' histogram the trained batch's;
- ``score_refresh_every=K > 1``: on steps with ``step % K == 0`` the step
  takes a pool off the stream, scores it (a scorer-only ingest: bf16 under
  ``scoring_dtype="bfloat16"``), updates the EMA and caches the pool's
  slots, ``importance_probs`` and pool loss (``state.cached_pool``). Every
  step draws B from the cached distribution (plain inverse CDF), gathers
  and ingests those slots with ``aug2`` and weighs them by the cached
  ``p·P``. Between refreshes the clip share and drift are 0 and
  ``train/pool_loss`` is the cached one;
- ``sampler="groupwise"``: the next window of ``P`` slots of the shard, in
  order (``sampling/groupwise.py``; the stream is not read), is scored
  (scorer-only ingest), written into the shard's importance as the newest
  group, and B drawn from that group (plain inverse CDF), gathered and
  ingested with ``aug2``, weighed by ``p·M`` (M the group's size). The EMA
  is updated after the draw: it feeds the telemetry only.

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
  a count; twice on a pipelined step 0, none on a cadence step that
  reuses its pool);
- the gradients, as one bucket before the optimizer step;
- the BN running statistics, as one bucket after it (under ``"local"``
  too);
- the metrics: ``train/loss`` and ``train/pool_loss`` as means over the
  ranks, ``train/acc`` as the global correct count over the global count.

At W=1 the step issues no collective and needs no process group.

Under ``tensor_parallel=T`` or ``fsdp_parallel=F`` (``parallel/mesh.py``)
the process group has ``W × T`` (or ``× F``) ranks, and every collective
above runs over the rank's data group, between the replicas of one model
shard. The ranks of a model group are one worker: they score, draw and
select the same indices, and the model's own collectives run inside its
forward and backward (``parallel/tensor.py``, ``parallel/fsdp.py``). The
gradient's norm sums its shards' squares over the model group
(:func:`grad_norm_of`).

The gradient path (:func:`sync_and_step`, the JAX ``train_update``'s
middle) has two options. ``grad_compression="stochastic"`` quantizes each
rank's gradient per parameter before the sync (``utils/quantize.py``;
``train/sparse_rate`` is the share of nonzeros, 1.0 without it).
``grad_compression="int8"`` syncs the gradient as the JAX package's flat
vector (``ravel_pytree`` order, ``state.flat``) with int8 on both halves
of the wire. ``zero_sharding`` reduce-scatters that flat vector, steps the
optimizer on this rank's chunk (under ``"int8"`` the compressed
reduce-scatter), all-gathers the chunk's update (compressed under
``"int8"``) and adds it to the parameters; at A > 1 the chunk is
accumulated, and a microstep that applies nothing still gathers its zero
update, as the JAX step does. Under ZeRO the two halves (int8 or not) run
at W=1 too, where they issue no collective but the int8 ones quantize.
Under a second mesh axis (no ZeRO there) the int8 wire is the JAX step's
per-leaf path: each gradient leaf in its Flax layout through
``compressed_pmean_tree_sharded`` on the data group, chunked along a dim
its sharding does not claim, with this shard's part of the whole leaf's
uniforms (``Draws.wire_leaves``); ``"stochastic"`` quantizes each shard
with the whole leaf's ``max|g|`` and counts the sparse rate over whole
leaves (:func:`_quantize_sharded`).

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

With ``moe_experts`` (the Transformer and ViT) the train forward also
returns the experts' load-balancing loss, and the objective is the
reweighted loss plus ``moe_aux_weight · aux`` (so is ``train/loss``); the
scoring forward's is discarded. Every step reports ``train/moe_aux``, the
mean over the ranks (0.0 without experts), carried by the metrics'
all-reduce.

``make_train_step(..., scan_steps=K)`` returns a chunk of K steps a call:
the same step body K times in a row, each metric stacked into ``[K]``, so
the state ends as K single calls leave it (the JAX package runs the chunk
as one ``lax.scan``).

Under ``data_placement="host_stream"`` (the JAX step's ``hs_body``) the
step takes the rows a prefetch pipeline gathered for it, ``x_stream``, and
returns the global row ids of the selection it draws for step t+depth.
The state's ring (``state.pending``) holds the slots, weights and draws of
steps t … t+depth−1:

- pool: the streamed rows are the pool the lookahead drew; they are
  ingested without a gather (``augment_normalize`` without ``rows`` under
  ``fused_input``), scored, drawn from and trained on as above; the
  lookahead takes the next pool of the stream, which runs depth pools
  ahead of the step. Uniform: the rows themselves. Both are bit-equal to
  the replicated step;
- scoretable: rows ``0:R`` are this step's window, scored as above, the
  EMA updated and the table decayed and the window scattered in with
  plain ops; rows ``R:`` the batch drawn depth steps ago, trained with its
  weights from the ring; after the write-back one ``score_and_draw`` over
  the ``L`` slots draws step t+depth's batch (``p·L`` its weights), after
  that step's window, ``depth`` windows on. The ledger counts at train
  time. Under async the stream carries the batch alone: nothing is
  scored, the table decays, the EMA follows the trained batch before the
  lookahead draws, and the ring's slots are the draw.

The draws of step t+depth are drawn at step t from the one generator, so
its sequence is the replicated run's. :func:`prime_host_stream` fills the
ring of a fresh state.

With ``scoring_dtype`` the scoring forward and the probe run in that
precision (:func:`scoring_forward`): ``"bfloat16"`` under bf16 autocast
wherever the step runs, and the scoretable's refresh window is ingested
straight to bf16.

The step's random numbers are one :class:`Draws`: by default made from the
state's generator on the device; tests pass the JAX package's draws instead.
On the card, with ``compute_dtype="bfloat16"``, forwards run under bf16
autocast and the logits come back in float32.

The JAX step's named scopes are ``record_function`` ranges
(``train/scopes.py``): ``mercury_scoring`` (the scoring forward and its
scores), ``mercury_augmentation`` or ``mercury_input_fuse`` (an ingest),
``mercury_variance_probe``, ``mercury_grad_sync`` (the gradient's and the
running statistics' collectives) and ``mercury_optimizer`` (the update).
They open only while a profiler window captures; otherwise each site is a
test of one host bool, and the step launches what it launched without
them.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence, Tuple

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
from mercury_tpu_torch.parallel.collectives import (
    all_gather_flat,
    allreduce_mean_,
    allreduce_quantizes,
    allreduce_sum,
    compressed_all_gather,
    compressed_allreduce_mean,
    compressed_pmean_tree_sharded,
    compressed_psum_scatter_mean,
    model_group_max_,
    psum_scatter_mean,
)
from mercury_tpu_torch.parallel.collectives import world as collectives_world
from mercury_tpu_torch.parallel.distributed import require_world
from mercury_tpu_torch.parallel.mesh import Mesh, full_shapes, sharding_of
from mercury_tpu_torch.sampling.groupwise import draw as groupwise_draw
from mercury_tpu_torch.sampling.groupwise import update_importance, window_indices
from mercury_tpu_torch.sampling.importance import (
    draw_with_replacement,
    ema_update,
    importance_probs,
    per_sample_grad_norm_bound,
    per_sample_loss,
    pool_mean,
    reweighted_loss,
)
from mercury_tpu_torch.sampling.scoretable import (
    ScoreTableState,
    advance_cursor,
    decay_scores,
    refresh_window,
    scatter_mean,
    table_draw_inverse_cdf,
    table_probs,
)
from mercury_tpu_torch.train.scopes import scope
from mercury_tpu_torch.train.state import (
    Augment,
    CachedPool,
    Draws,
    MercuryState,
    PendingBatch,
    PendingSelection,
    flat_layout,
    wire_layout,
)
from mercury_tpu_torch.utils.quantize import nonzeros, sparsity, stochastic_quantize
from mercury_tpu_torch.utils.tree import pad_to_chunks

CROP_PAD = 4
IMAGE_SIZE = 32  # CIFAR's side: the range of the cutout centres


def to_nchw(images: torch.Tensor) -> torch.Tensor:
    """The model's input: the NCHW view of NHWC images, channels_last in
    memory on the card, a contiguous copy on the CPU, where the backward
    through this network from a channels_last input aborted with heap
    corruption (torch 2.13.0+cpu); any other batch (``[B, T, F]``
    sequences) as it is."""
    if images.dim() != 4:
        return images
    x = images.permute(0, 3, 1, 2)
    return x if x.is_cuda else x.contiguous()


def pool_size(config: TrainConfig) -> int:
    return (config.candidate_pool_size if config.use_importance_sampling
            else config.batch_size)


def make_draws(state: MercuryState, config: TrainConfig) -> Draws:
    """One step's draws from the state's generator, on its device: the
    sampler's, then the gradient quantizers' where their option is on (so
    with both off the generator's sequence is the step's without them).
    Under a second mesh axis the quantizers' uniforms are the whole
    leaves', so a model group's ranks, which share the worker's
    generator, draw what one unsharded rank draws; the per-leaf int8
    wire's in the JAX leaf order, ``u1`` then ``u2`` a leaf."""
    draws = _sampler_draws(state, config)
    gen = state.generator
    dev = gen.device
    group = data_group(state)
    if config.grad_compression == "stochastic":
        shapes = full_shapes(state.model)
        draws = draws._replace(grad_uniforms=tuple(
            torch.rand(shapes[name], generator=gen, device=dev)
            for name, _ in state.model.named_parameters()))
    elif _int8_wire(config, group) and group is not None:
        wire = wire_layout(state)
        pairs = [None] * len(wire)
        w = collectives_world(group)
        for i in sorted(range(len(wire)), key=lambda i: wire[i].path):
            if wire[i].dim is not None:
                s1, s2 = wire[i].uniform_shapes(w)
                pairs[i] = (torch.rand(s1, generator=gen, device=dev),
                            torch.rand(s2, generator=gen, device=dev))
        draws = draws._replace(wire_leaves=tuple(pairs))
    elif _int8_wire(config, group):
        flat = flat_layout(state)
        draws = draws._replace(
            wire_u1=torch.rand((flat.world, flat.chunk), generator=gen, device=dev),
            wire_u2=torch.rand(flat.chunk, generator=gen, device=dev))
    return draws


def data_group(state: MercuryState):
    """The group of the step's data-parallel collectives: the mesh's data
    group under a second axis, else None (the default group)."""
    return None if state.mesh is None else state.mesh.data_group


def draw_augment(gen: torch.Generator, n: int, config: TrainConfig) -> Augment:
    """The random numbers of one ingest of ``n`` images from ``gen``, on its
    device: the crop offsets and flips, then the IID transform's angles and
    scales, or the cutout centres."""
    dev = gen.device
    iid = config.augmentation == "iid"

    def uniform(lo: float, hi: float) -> torch.Tensor:
        return lo + (hi - lo) * torch.rand(n, generator=gen, device=dev)

    hi = IID_RESIZE - IID_CROP if iid else 2 * CROP_PAD
    aug = Augment(torch.randint(0, hi + 1, (n, 2), generator=gen, device=dev,
                                dtype=torch.int32),
                  torch.rand(n, generator=gen, device=dev) < 0.5)
    if iid:
        theta = torch.deg2rad(uniform(-MAX_ROTATE_DEG, MAX_ROTATE_DEG))
        return aug._replace(theta=theta, scale=uniform(*SCALE_RANGE))
    if config.cutout and config.augmentation == "noniid":
        return aug._replace(cut=torch.randint(0, IMAGE_SIZE, (n, 2), generator=gen,
                                              device=dev, dtype=torch.int32))
    return aug


def augment_images(images: torch.Tensor, aug: Augment, config: TrainConfig) -> torch.Tensor:
    """The unfused augmentation of normalized images. As the JAX step's
    _augment: cutout rides on the noniid crop and flip only; under "iid"
    and "none" the flag is ignored."""
    if config.augmentation == "noniid":
        return augment_batch(images, aug.crop, aug.flip, CROP_PAD,
                             _need(aug.cut, "cut") if config.cutout else None)
    if config.augmentation == "iid":
        return augment_batch_iid(images, aug.crop, aug.flip, _need(aug.theta, "theta"),
                                 _need(aug.scale, "scale"))
    return images


def _sampler_draws(state: MercuryState, config: TrainConfig) -> Draws:
    gen = state.generator
    dev = gen.device

    def augment_draws(n: int) -> Augment:
        return draw_augment(gen, n, config)

    def uniforms():
        return torch.rand((1, config.batch_size), generator=gen, device=dev)

    if config.use_async:
        # No refresh window: the fleet scores the table's windows itself.
        return Draws(perm=None, aug=None, uniforms=uniforms(),
                     aug2=augment_draws(config.batch_size))
    if config.use_scoretable:
        aug = augment_draws(config.refresh_size)
        return Draws(perm=None, aug=aug, uniforms=uniforms(),
                     aug2=augment_draws(config.batch_size))
    p = pool_size(config)
    length = state.stream.perm.shape[0]

    def reshuffle(cursor: int) -> Optional[torch.Tensor]:
        """The stream's next permutation when a pool from ``cursor``
        wraps it."""
        if cursor + p > length:
            return torch.randperm(length, generator=gen, device=dev)
        return None

    if config.use_groupwise:
        # The window is read in order: no stream, no permutation.
        return Draws(perm=None, aug=augment_draws(p), uniforms=uniforms(),
                     aug2=augment_draws(config.batch_size))
    if config.use_cadence:
        # Only a refresh step reads the stream and scores a pool.
        perm = aug = None
        if state.step % config.score_refresh_every == 0:
            perm = reshuffle(state.stream.cursor)
            aug = augment_draws(p)
        return Draws(perm=perm, aug=aug, uniforms=uniforms(),
                     aug2=augment_draws(config.batch_size))
    cursor, boot = state.stream.cursor, None
    if config.use_pipelined and state.step == 0:
        # The boot pool comes first off the stream; the step's pool after it.
        boot_perm = reshuffle(cursor)
        boot = Draws(perm=boot_perm, aug=augment_draws(p), uniforms=uniforms())
        cursor = (0 if boot_perm is not None else cursor) + p
    perm = reshuffle(cursor)
    aug = augment_draws(p)
    return Draws(perm=perm, aug=aug,
                 uniforms=uniforms() if config.use_importance_sampling else None, boot=boot)


def scoring_forward(model: torch.nn.Module, images: torch.Tensor,
                    config: TrainConfig) -> torch.Tensor:
    """The candidate-scoring forward: train mode with the running
    statistics left alone, no gradients, float32 logits. Its precision is
    ``config.scoring_dtype``'s: ``"bfloat16"`` casts the input to bf16 and
    runs under bf16 autocast on any device (the caller asked for it, as the
    JAX package's bf16 ``scoring_model``); ``"float32"`` runs without
    autocast; ``None`` in the training precision (bf16 autocast on the card
    under ``compute_dtype="bfloat16"``)."""
    dev = images.device
    if config.scoring_dtype is None:
        enabled = config.compute_dtype == "bfloat16" and dev.type == "cuda"
    else:
        enabled = config.scoring_dtype == "bfloat16"
    with torch.no_grad(), torch.autocast(device_type=dev.type, dtype=torch.bfloat16,
                                         enabled=enabled):
        if config.scoring_dtype == "bfloat16":
            images = images.to(torch.bfloat16)
        return model(to_nchw(images), train=True, keep_stats=False)


def set_lr(state: MercuryState) -> None:
    """The learning rate of the next update, ``lr_schedule(updates)``."""
    lr = state.lr_schedule(state.updates)
    for group in state.optimizer.param_groups:
        group["lr"] = lr


@torch.no_grad()
def accumulate(state: MercuryState, accum_steps: int,
               params: Optional[Sequence[torch.Tensor]] = None) -> None:
    """optax.MultiSteps for one microstep: fold the gradients of ``params``
    (default: the model's; under ZeRO the chunk the optimizer holds) into
    the running mean ``acc + (g − acc) / (mini_step + 1)`` (its
    ``_acc_update``; a sum divided at the end would round otherwise), and on
    the ``accum_steps``-th microstep apply the mean as the gradient at
    ``lr_schedule(updates)`` and zero the accumulator. Between updates the
    parameters and the optimizer state do not change."""
    params = list(state.model.parameters()) if params is None else list(params)
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


def apply_update(state: MercuryState, accum_steps: int,
                 params: Optional[Sequence[torch.Tensor]] = None) -> None:
    """The optimizer step, or at ``grad_accum_steps > 1`` :func:`accumulate`
    of ``params``' gradients."""
    if state.accum is None:
        state.optimizer.step()
        state.updates += 1
    else:
        accumulate(state, accum_steps, params)


@torch.no_grad()
def sync_and_step(state: MercuryState, config: TrainConfig, draws: Draws,
                  telemetry: bool, group=None):
    """The gradient path after the backward, the JAX ``train_update``'s
    middle, in its order: the optional ``"stochastic"`` quantization; the
    sync (the all-reduced bucket, the int8 all-reduce of the flat vector,
    or ZeRO's reduce-scatter, chunk update and all-gather of the update,
    int8 or not); the gradient's norm (under ``telemetry``; ZeRO's from its
    chunks); the optimizer step or the accumulation. Returns the norm
    (None without telemetry) and this rank's ``train/sparse_rate`` (None
    unless ``"stochastic"``). The gradient bucket is averaged over
    ``group`` (None: the default group; the data group under a second mesh
    axis), and a sharded model's norm sums its shards' squares over the
    model group (:func:`grad_norm_of`)."""
    params = list(state.model.parameters())
    sh = sharding_of(state.model)
    sparse_rate = grad_norm = None
    if config.grad_compression == "stochastic":
        uniforms = _need(draws.grad_uniforms, "grad_uniforms")
        if sh is not None:
            sparse_rate = _quantize_sharded(state.model, sh, uniforms)
        else:
            grads = [stochastic_quantize(u, p.grad) for u, p in zip(uniforms, params)]
            total = float(sum(g.numel() for g in grads))
            sparse_rate = torch.stack([sparsity(g) * (g.numel() / total) for g in grads]).sum()
            for p, g in zip(params, grads):
                p.grad = g
    if config.zero_sharding:
        return _zero_step(state, config, draws, params, telemetry), sparse_rate
    grads = [p.grad for p in params if p.grad is not None]
    with scope("mercury_grad_sync"):
        if _int8_wire(config, group) and sh is not None:
            _leaf_wire_sync(state, sh, _need(draws.wire_leaves, "wire_leaves"), group)
        elif _int8_wire(config, group):
            flat = flat_layout(state)
            vec = torch.cat([g.reshape(-1) for g in grads])[flat.order]
            vec = compressed_allreduce_mean(vec, _need(draws.wire_u1, "wire_u1"),
                                            _need(draws.wire_u2, "wire_u2"))[flat.inverse]
            for g, part in zip(grads, vec.split([g.numel() for g in grads])):
                g.copy_(part.view_as(g))
        elif config.world_size > 1:
            allreduce_mean_(grads, group)
    if telemetry:
        # This (micro)step's gradient, equal on every rank.
        grad_norm = grad_norm_of(state.model)
    with scope("mercury_optimizer"):
        apply_update(state, config.grad_accum_steps)
    return grad_norm, sparse_rate


def _quantize_sharded(model: torch.nn.Module, sh, uniforms: Sequence[torch.Tensor]
                      ) -> torch.Tensor:
    """``"stochastic"`` on a sharded model's gradient, in place: each
    shard quantized with its part of the whole leaf's uniforms and the
    whole leaf's ``max|g|`` (one MAX all-reduce over the model group for
    the split leaves), as GSPMD quantizes JAX's logical leaves. Returns the
    sparse rate over whole leaves: the split leaves' nonzeros summed over
    the group (one all-reduce), each leaf's share weighted by its whole
    size."""
    named = [(name, p) for name, p in model.named_parameters()]
    dims = [sh.dims.get(name) for name, _ in named]
    split = [d is not None for d in dims]
    local_u = [u if d is None else u.chunk(sh.size, d)[sh.rank] for u, d in zip(uniforms, dims)]
    amax = torch.stack([p.grad.abs().max() for _, p in named])[:, None]
    model_group_max_(amax, split, sh.group)
    grads = [stochastic_quantize(u, p.grad, m[0]) for u, (_, p), m in zip(local_u, named, amax)]
    counts = torch.stack([nonzeros(g) for g in grads])
    rows = [i for i, s in enumerate(split) if s]
    if rows:
        counts[rows] = allreduce_sum(counts[rows].contiguous(), sh.group.group)
    sizes = [g.numel() * (sh.size if s else 1) for g, s in zip(grads, split)]
    total = float(sum(sizes))
    sparse_rate = torch.stack([(c / n) * (n / total) for c, n in zip(counts, sizes)]).sum()
    for (_, p), g in zip(named, grads):
        p.grad = g
    return sparse_rate


def _leaf_wire_sync(state: MercuryState, sh, pairs, group) -> None:
    """The int8 wire of a sharded model's gradient, in place: each leaf in
    its Flax layout through ``compressed_pmean_tree_sharded`` on the data
    group, chunked along a dim its sharding does not claim, with this
    shard's part of the whole leaf's uniforms (JAX's per-leaf path)."""
    wire = wire_layout(state)
    grads = [p.grad for p in state.model.parameters()]
    keep = [i for i, g in enumerate(grads) if g is not None]
    xs = [grads[i].permute(wire[i].axes) for i in keep]
    u1s, u2s = [], []
    for i in keep:
        pair = pairs[i]
        u1s.append(None if pair is None else wire[i].local(pair[0], sh.rank, sh.size))
        u2s.append(None if pair is None else wire[i].local(pair[1], sh.rank, sh.size))
    out = compressed_pmean_tree_sharded(xs, u1s, u2s, [wire[i].spec for i in keep], group,
                                        sh.group)
    for i, o in zip(keep, out):
        inverse = sorted(range(len(wire[i].axes)), key=lambda t: wire[i].axes[t])
        grads[i].copy_(o.permute(*inverse))


def grad_norm_of(model: torch.nn.Module) -> torch.Tensor:
    """The L2 norm of the model's gradient. A sharded model's is the whole
    gradient's: its shards' squares summed over the model group (one
    all-reduce), its replicated leaves counted once."""
    sh = sharding_of(model)
    grads = [(name, p.grad) for name, p in model.named_parameters() if p.grad is not None]
    if sh is None:
        return global_grad_norm([g for _, g in grads])
    split = [g for name, g in grads if name in sh.dims]
    whole = [g for name, g in grads if name not in sh.dims]

    def squares(gs):
        if not gs:
            return torch.zeros((), dtype=torch.float32, device=grads[0][1].device)
        return global_grad_norm(gs).square()

    return torch.sqrt(allreduce_sum(squares(split), sh.group.group) + squares(whole))


def _zero_step(state: MercuryState, config: TrainConfig, draws: Draws,
               params: Sequence[torch.Tensor], telemetry: bool) -> Optional[torch.Tensor]:
    """ZeRO-1 (the JAX step's ``zero`` branch): this rank's chunk of the
    mean flat gradient by reduce-scatter, the optimizer over the chunk of
    the flat parameters (the update is the chunk's change), the updates
    all-gathered and added to the parameters through the inverse order.
    Returns the gradient's norm under ``telemetry``: the root of the
    all-reduced sum of the chunks' squares (the padding is zeros)."""
    flat = flat_layout(state)
    int8 = config.grad_compression == "int8"
    gvec = torch.cat([p.grad.reshape(-1) for p in params])[flat.order]
    rows = pad_to_chunks(gvec, flat.world)
    with scope("mercury_grad_sync"):
        if int8:
            gchunk = compressed_psum_scatter_mean(rows, _need(draws.wire_u1, "wire_u1"))
        else:
            gchunk = psum_scatter_mean(rows)
    grad_norm = None
    if telemetry:
        grad_norm = torch.sqrt(allreduce_sum(gchunk.to(torch.float32).square().sum()))
    pvec = torch.cat([p.reshape(-1) for p in params])[flat.order]
    pchunk = pad_to_chunks(pvec, flat.world)[flat.rank]
    chunk = state.optimizer.param_groups[0]["params"][0]
    chunk.copy_(pchunk)
    chunk.grad = gchunk
    with scope("mercury_optimizer"):
        apply_update(state, config.grad_accum_steps, [chunk])
    # Zero on a microstep that applies nothing, gathered all the same.
    update = chunk - pchunk
    with scope("mercury_grad_sync"):
        if int8:
            uvec = compressed_all_gather(update, _need(draws.wire_u2, "wire_u2"))
        else:
            uvec = all_gather_flat(update)
    uvec = uvec[:flat.n][flat.inverse]
    torch._foreach_add_(params, [u.view_as(p) for p, u in zip(
        params, uvec.split([p.numel() for p in params]))])
    return grad_norm


def make_train_step(
    config: TrainConfig, dataset: ShardedDataset, scan_steps: int = 1,
    mesh: Optional[Mesh] = None,
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

    Under ``data_placement="host_stream"`` it builds the host-stream step
    instead, ``step_fn(state, x_stream, draws=None, use_kernels=True) →
    (metrics, next_gidx)`` (:func:`make_host_stream_step` has the details).

    ``config.label_smoothing`` needs the plain versions (the NLL kernels
    compute the plain NLL): it raises ``ValueError`` where the kernels
    would run, that is with ``use_pallas=True``, or ``None`` on the card.

    ``scan_steps=K > 1`` builds ``chunk_fn(state, draws=None,
    use_kernels=True) → metrics`` instead: K steps, ``draws`` (when given)
    a sequence of K, every metric ``[K, ...]``. It refuses the variance
    probe and host_stream, as the JAX step does.

    ``mesh`` (``train/trainer.build_mesh``'s, which refuses what a second
    axis does not run and checks for ``world_size × T`` (or ``× F``)
    ranks) places the step under ``tensor_parallel`` or
    ``fsdp_parallel``, where it is required: the step's collectives run
    over the mesh's data group, and the model arrives sharded over its
    model group."""
    if scan_steps > 1 and config.use_probe:
        raise ValueError(
            "variance_probe_every > 0 requires scan_steps == 1: scanned "
            "chunks mean their metrics, which would blend the probe's "
            "-1.0 off-step sentinel into the ratio")
    if scan_steps > 1 and config.host_stream:
        raise ValueError(
            "host_stream requires scan_steps == 1: each step consumes "
            "one host-prefetched batch and emits the next indices — a "
            "scanned chunk would need the streamed batches mid-graph")
    if config.second_axis is None:
        require_world(config.world_size)
    elif mesh is None:
        # build_mesh makes the refusals and checks the process group.
        raise ValueError("a step under tensor_parallel or fsdp_parallel needs the mesh: "
                         "pass mesh=train.trainer.build_mesh(config)")
    # The data-parallel collectives' group: the default group, or the
    # mesh's data group under a second axis.
    dgroup = None if mesh is None else mesh.data_group
    world_size = config.world_size
    use_is = config.use_importance_sampling
    use_table = config.use_scoretable
    async_refresh = config.use_async
    host_stream = config.host_stream
    depth = config.prefetch_depth
    sync_stats = use_is and config.sync_importance_stats and world_size > 1
    p_size = pool_size(config)
    batch_size = config.batch_size
    refresh_size = config.refresh_size
    bf16 = config.compute_dtype == "bfloat16"
    telemetry = config.telemetry
    use_pipelined, use_cadence, use_groupwise = (
        config.use_pipelined, config.use_cadence, config.use_groupwise)
    if telemetry and use_table and not async_refresh:
        # The ages are a rotation of the same L values at every cursor.
        ages = {f"sampler/table_age_{name}": torch.tensor(value, dtype=torch.float32)
                for name, value in zip(("min", "mean", "max"),
                                       table_age_summary(dataset.shard_len, refresh_size))}
    if host_stream:
        # The pixels arrive as the step's x_stream; only the labels are here.
        x_rows, y_rows = None, dataset.y_train
        shard_row = dataset.shard_indices[dataset.rank]
    elif dataset.x_shard is not None:
        # Sharded placement: the rank's own rows, indexed by slot.
        x_rows, y_rows, shard_row = dataset.x_shard, dataset.y_shard, None
    else:
        x_rows, y_rows = dataset.x_train, dataset.y_train
        shard_row = dataset.shard_indices[dataset.rank]
    if host_stream and dataset.x_shard is not None:
        raise ValueError("a sharded dataset under data_placement='host_stream'")
    data_dev = y_rows.device
    smoothing = config.label_smoothing
    # use_pallas, resolved once: False is the plain versions, on the card
    # too; True or None the wrappers, which launch the kernels on CUDA
    # tensors and run the plain versions on CPU ones. Smoothing is refused
    # wherever a kernel would launch (the kernels compute the plain NLL).
    kernels = config.use_pallas is not False
    if smoothing != 0.0 and kernels and (config.use_pallas or data_dev.type == "cuda"):
        raise ValueError("use_pallas requires label_smoothing == 0")
    grad_norm_scores = config.importance_score == "grad_norm"
    # scoring_dtype="bfloat16": the scorer-only ingest (the refresh window,
    # whose images are never trained on) emits bf16 directly.
    scorer_in_dtype = torch.bfloat16 if config.scoring_dtype == "bfloat16" else None
    mean_t = torch.as_tensor(dataset.mean, dtype=torch.float32, device=data_dev)
    std_t = torch.as_tensor(dataset.std, dtype=torch.float32, device=data_dev)

    def gather(slots: torch.Tensor):
        """The rows of the train split that hold shard ``slots``, and their
        labels."""
        rows = slots if shard_row is None else shard_row[slots]
        return rows, y_rows[rows]

    def ingest(gidx: Optional[torch.Tensor], use_kernels: bool, aug: Augment,
               out_dtype: Optional[torch.dtype] = None,
               raw: Optional[torch.Tensor] = None) -> torch.Tensor:
        """uint8 rows → augmented, normalized NHWC images in float32 (or
        ``out_dtype``, cast last): rows ``gidx`` of the train split, or the
        rows ``raw`` already gathered (the host stream's slab). With
        ``fused_input`` one ``augment_normalize`` launch (that gathers the
        rows ``gidx`` itself), the gather and the op chain otherwise."""
        dtype = out_dtype or torch.float32
        if config.fused_input:
            with scope("mercury_input_fuse"):
                if use_kernels:
                    if raw is not None:
                        return augment_normalize(raw, mean_t, std_t, aug.crop, aug.flip,
                                                 CROP_PAD, out_dtype=dtype)
                    return augment_normalize(x_rows, mean_t, std_t, aug.crop, aug.flip,
                                             CROP_PAD, out_dtype=dtype, rows=gidx)
                return reference.augment_normalize(x_rows[gidx] if raw is None else raw,
                                                   mean_t, std_t, aug.crop, aug.flip,
                                                   CROP_PAD, dtype)
        with scope("mercury_augmentation"):
            raw = x_rows[gidx] if raw is None else raw
            images = augment_images(normalize_images(raw, dataset.mean, dataset.std), aug,
                                    config)
            return images if out_dtype is None else images.to(out_dtype)

    # train/sparse_rate without "stochastic": one 1.0, the same tensor every
    # step (no op a step, no collective); train/moe_aux without experts a 0.0.
    dense_rate = torch.ones((), dtype=torch.float32, device=data_dev)
    no_aux = torch.zeros((), dtype=torch.float32, device=data_dev)
    moe = config.moe_experts is not None

    def train_update(state: MercuryState, sel_images: torch.Tensor, sel_labels: torch.Tensor,
                     scaled_probs: torch.Tensor, draws: Draws, loss_of):
        """The train back end every step path shares (the JAX step's
        ``train_update``): the reweighted forward and backward, then
        :func:`sync_and_step` (at A > 1 the gradient is folded into the
        accumulator instead, and every A-th microstep applies it), then the
        BN running statistics' mean over the ranks. Returns the logits, the
        per-sample losses, the objective (with the experts' term), the
        experts' loss (None without them), the gradient's norm and this
        rank's sparse rate."""
        model = state.model
        if state.accum is None:
            set_lr(state)
        state.optimizer.zero_grad(set_to_none=True)
        if config.zero_sharding:
            # The optimizer holds the flat chunk, not the model's parameters.
            model.zero_grad(set_to_none=True)
        aux = None
        with torch.autocast(device_type=data_dev.type, dtype=torch.bfloat16,
                            enabled=bf16 and data_dev.type == "cuda"):
            if moe:
                logits, aux = model(to_nchw(sel_images), train=True, keep_stats=True,
                                    return_aux=True)
            else:
                logits = model(to_nchw(sel_images), train=True, keep_stats=True)
        train_losses = loss_of(logits, sel_labels)
        loss = reweighted_loss(train_losses, scaled_probs)
        if moe:
            # The Switch load-balancing term, summed over the blocks.
            loss = loss + config.moe_aux_weight * aux
        loss.backward()
        grad_norm, sparse_rate = sync_and_step(state, config, draws, telemetry, dgroup)
        if world_size > 1:
            # Averaged under "sync" (already equal) and "local" alike, as
            # the JAX step averages batch_stats; a model without batch norm
            # has none, and no all-reduce is issued.
            with scope("mercury_grad_sync"):
                allreduce_mean_([b for name, b in model.named_buffers()
                                 if name.endswith(("running_mean", "running_var"))], dgroup)
        return logits, train_losses, loss, aux, grad_norm, sparse_rate

    def step_fn(state: MercuryState, draws: Optional[Draws] = None,
                use_kernels: bool = True, x_stream: Optional[torch.Tensor] = None):
        if host_stream:
            if x_stream is None:
                raise ValueError("the host-stream step takes the popped rows, x_stream")
            if state.pending is None:
                raise ValueError("the host-stream step needs the primed ring "
                                 "(prime_host_stream)")
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
        dev = data_dev

        def score(images: torch.Tensor, labels: torch.Tensor):
            """The scoring forward and the per-sample scores; returns the
            scores and the logits."""
            with scope("mercury_scoring"):
                logits = scoring_forward(model, images, config)
                with torch.no_grad():
                    return score_of(logits, labels), logits

        def pool_loss(logits: torch.Tensor, labels: torch.Tensor,
                      score_avg: torch.Tensor) -> torch.Tensor:
            """``train/pool_loss``: the mean loss of the scored rows, the
            scores' mean unless the scores are gradient norms (the JAX
            step's ``_pool_loss_metric``)."""
            if not grad_norm_scores:
                return score_avg
            with torch.no_grad():
                return pool_mean(loss_of(logits, labels), sync_stats, dgroup)

        def probe_var_ratio(images: torch.Tensor, labels: torch.Tensor,
                            scaled_probs: torch.Tensor) -> torch.Tensor:
            """The grad-variance probe: the drawn batch through the
            pre-update model in the scoring precision, the gradient-norm
            bounds of its logits and their two moments, pooled over the
            ranks before the ratio."""
            with scope("mercury_variance_probe"):
                logits = scoring_forward(model, images, config)
                with torch.no_grad():
                    g = per_sample_grad_norm_bound(logits.float(), labels, smoothing)
                    return variance_probe_ratio(
                        g, scaled_probs, mean=lambda v: pool_mean(v, sync_stats, dgroup))

        def select_from(images: torch.Tensor, labels: torch.Tensor, ema, uniforms):
            """Score a pool, update the EMA and draw the batch: the selected
            positions, the batch, its ``p·P``, the pool's distribution, the
            new EMA, the pool loss and the clip share and drift."""
            pool_scores, pool_logits = score(images, labels)
            score_avg = pool_mean(pool_scores, sync_stats, dgroup)
            ema_prev = ema.value
            ema = ema_update(ema, score_avg, config.ema_alpha)
            select = score_and_draw if use_kernels else reference.score_and_draw
            probs, selected, scaled_probs = select(
                pool_scores, ema.value, uniforms, config.is_alpha)
            selected = selected.long()
            clip = drift = None
            if telemetry:
                clip = clip_fraction(pool_scores, ema.value, config.is_alpha)
                drift = ema_drift(score_avg, ema_prev)
            return (selected, images[selected], labels[selected], scaled_probs, probs, ema,
                    pool_loss(pool_logits, labels, score_avg), clip, drift)

        def uniform_batch(images: torch.Tensor, labels: torch.Tensor):
            """The uniform arm: the first B rows, weight 1."""
            selected = torch.arange(batch_size, device=dev)
            sel_images, sel_labels = images[:batch_size], labels[:batch_size]
            scaled_probs = torch.ones(batch_size, dtype=torch.float32, device=dev)
            avg_pool_loss = torch.zeros((), dtype=torch.float32, device=dev)
            clip = drift = None
            if telemetry:
                # Nothing scored: nothing clips or drifts.
                clip = drift = torch.zeros((), dtype=torch.float32, device=dev)
            return (selected, sel_images, sel_labels, scaled_probs, None, avg_pool_loss,
                    clip, drift)

        def score_next(stream, ema, d: Draws):
            """The pipelined step's next pool: its slots off the stream,
            scored, the EMA updated and B drawn (``score_and_draw``); the
            drawn images, labels and ``p·P`` are the next step's batch."""
            stream, slots = next_pool(stream, p_size, lambda: _perm(d))
            rows, labels = gather(slots)
            (selected, sel_images, sel_labels, scaled_probs, probs, ema, avg_pool_loss,
             clip, drift) = select_from(ingest(rows, use_kernels, d.aug), labels, ema,
                                        d.uniforms)
            return (stream, ema, PendingBatch(sel_images, sel_labels, scaled_probs),
                    selected, probs, avg_pool_loss, clip, drift)

        stream, ema, table = state.stream, state.ema, state.scoretable
        pending_batch, cached_pool, groupwise = (
            state.pending_batch, state.cached_pool, state.groupwise)
        if host_stream:
            pending = state.pending
            front, front_draws = pending.slots[0], pending.draws[0]
        clip = drift = None
        if async_refresh and host_stream:
            # The streamed rows are the batch drawn depth steps ago, and
            # nothing is scored: the table only decays; the EMA follows the
            # trained batch, before the lookahead draws.
            selected = front
            new_scores = decay_scores(table.scores.to(torch.float32), ema.value,
                                      config.table_decay)
            probs = None
            scaled_probs = pending.scaled_probs[0]
            sel_labels = gather(front)[1]
            sel_images = ingest(None, use_kernels, front_draws.aug2, raw=x_stream)
            avg_pool_loss = torch.zeros((), dtype=torch.float32, device=dev)
        elif async_refresh:
            # No refresh window: the fleet rescored the table between
            # steps. Decay, normalize and draw over the whole table (the JAX
            # step's async branch): the kernel with a one-slot window that
            # writes slot 0's own decayed value back, a no-op, or the plain
            # decay, probs and inverse-CDF draw.
            n_slots = table.scores.shape[0]
            if use_kernels:
                sent = ema.value + (table.scores[:1] - ema.value) * config.table_decay
                new_scores, probs, selected, scaled_probs = table_refresh_draw(
                    table.scores, torch.zeros(1, dtype=torch.int64, device=dev), sent,
                    ema.value, draws.uniforms, config.is_alpha, config.table_decay)
            else:
                new_scores = decay_scores(table.scores.to(torch.float32), ema.value,
                                          config.table_decay)
                probs = table_probs(new_scores, ema.value, config.is_alpha)
                selected = table_draw_inverse_cdf(probs, draws.uniforms).long()
                scaled_probs = probs[selected] * n_slots
            selected = selected.long()
            if telemetry:
                clip = clip_fraction(new_scores, ema.value, config.is_alpha)
            avg_pool_loss = torch.zeros((), dtype=torch.float32, device=dev)
            sel_rows, sel_labels = gather(selected)
            sel_images = ingest(sel_rows, use_kernels, draws.aug2)
        elif use_table and host_stream:
            # Rows 0:R of x_stream are this step's refresh window, rows R:
            # the batch drawn depth steps ago (the JAX hs_body): decay and
            # scatter with plain ops; the draw is the lookahead's, below.
            r_slots, t_slots = front[:refresh_size], front[refresh_size:]
            r_labels = gather(r_slots)[1]
            r_scores, r_logits = score(
                ingest(None, use_kernels, front_draws.aug, scorer_in_dtype,
                       raw=x_stream[:refresh_size]), r_labels)
            score_avg = pool_mean(r_scores, sync_stats, dgroup)
            ema_prev = ema.value
            ema = ema_update(ema, score_avg, config.ema_alpha)
            new_scores = scatter_mean(
                decay_scores(table.scores.to(torch.float32), ema.value, config.table_decay),
                r_slots, r_scores)
            probs = None
            selected = t_slots
            scaled_probs = pending.scaled_probs[0]
            sel_labels = gather(t_slots)[1]
            sel_images = ingest(None, use_kernels, front_draws.aug2,
                                raw=x_stream[refresh_size:])
            avg_pool_loss = pool_loss(r_logits, r_labels, score_avg)
            if telemetry:
                drift = ema_drift(score_avg, ema_prev)
        elif use_table:
            r_slots = refresh_window(table, refresh_size)
            r_rows, r_labels = gather(r_slots)
            r_scores, r_logits = score(
                ingest(r_rows, use_kernels, draws.aug, scorer_in_dtype), r_labels)
            score_avg = pool_mean(r_scores, sync_stats, dgroup)
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
        elif use_pipelined:
            # Train on the batch selected last step; score the next pool
            # with the same weights before the update (the JAX step's
            # pipelined branch). Step 0 boots: a pool scored first, its
            # draw trained on now.
            if state.step == 0:
                boot = _need(draws.boot, "boot")
                stream, ema, current = score_next(stream, ema, boot)[:3]
            else:
                current = state.pending_batch
            (stream, ema, pending_batch, selected, probs, avg_pool_loss, clip,
             drift) = score_next(stream, ema, draws)
            sel_images, sel_labels, scaled_probs = current
        elif use_cadence:
            # Every K-th step scores a fresh pool and caches its
            # distribution; every step draws B from the cache and gathers
            # and ingests those slots anew (the JAX step's cadence branch).
            if state.step % config.score_refresh_every == 0:
                stream, slots = next_pool(stream, p_size, lambda: _perm(draws))
                rows, labels = gather(slots)
                pool_scores, pool_logits = score(
                    ingest(rows, use_kernels, _need(draws.aug, "aug"), scorer_in_dtype),
                    labels)
                score_avg = pool_mean(pool_scores, sync_stats, dgroup)
                ema_prev = ema.value
                ema = ema_update(ema, score_avg, config.ema_alpha)
                cached_pool = CachedPool(
                    slots, importance_probs(pool_scores, ema.value, config.is_alpha),
                    pool_loss(pool_logits, labels, score_avg))
                if telemetry:
                    clip = clip_fraction(pool_scores, ema.value, config.is_alpha)
                    drift = ema_drift(score_avg, ema_prev)
            elif telemetry:
                # Nothing scored this step: nothing clips or drifts.
                clip = drift = torch.zeros((), dtype=torch.float32, device=dev)
            probs = cached_pool.probs
            selected = draw_with_replacement(probs, draws.uniforms)
            scaled_probs = probs[selected] * p_size
            sel_rows, sel_labels = gather(cached_pool.slots[selected])
            sel_images = ingest(sel_rows, use_kernels, _need(draws.aug2, "aug2"))
            avg_pool_loss = cached_pool.pool_loss
        elif use_groupwise:
            # The next window of the shard, in order: scored, written into
            # the importance as the newest group, and the batch drawn from
            # that group, gathered and ingested anew (the JAX step's
            # groupwise branch). The EMA follows for telemetry only.
            slots = window_indices(groupwise, p_size)
            rows, labels = gather(slots)
            pool_scores, pool_logits = score(
                ingest(rows, use_kernels, draws.aug, scorer_in_dtype), labels)
            groupwise = update_importance(groupwise, slots, pool_scores)
            selected, scaled_probs, probs = groupwise_draw(groupwise, draws.uniforms)
            sel_rows, sel_labels = gather(selected)
            sel_images = ingest(sel_rows, use_kernels, _need(draws.aug2, "aug2"))
            score_avg = pool_mean(pool_scores, sync_stats, dgroup)
            ema_prev = ema.value
            ema = ema_update(ema, score_avg, config.ema_alpha)
            avg_pool_loss = pool_loss(pool_logits, labels, score_avg)
            if telemetry:
                clip = clip_fraction(pool_scores, ema.value, config.is_alpha)
                drift = ema_drift(score_avg, ema_prev)
        else:
            if host_stream:
                # The streamed rows are the pool the lookahead drew, with
                # this step's draws: the replicated step's exactly.
                labels = gather(front)[1]
                images = ingest(None, use_kernels, front_draws.aug, raw=x_stream)
                uniforms = front_draws.uniforms
            else:
                stream, slots = next_pool(stream, p_size, lambda: _perm(draws))
                rows, labels = gather(slots)
                images = ingest(rows, use_kernels, draws.aug)  # [P, H, W, C]
                uniforms = draws.uniforms
            if use_is:
                (selected, sel_images, sel_labels, scaled_probs, probs, ema,
                 avg_pool_loss, clip, drift) = select_from(images, labels, ema, uniforms)
            else:
                (selected, sel_images, sel_labels, scaled_probs, probs,
                 avg_pool_loss, clip, drift) = uniform_batch(images, labels)

        # The probe's cadence counts the steps after this one, as the JAX
        # step's metric records do.
        probe = config.use_probe and (state.step + 1) % config.variance_probe_every == 0
        if probe:
            var_ratio = probe_var_ratio(sel_images, sel_labels, scaled_probs)

        # Under host_stream the trained batch is step t's, drawn with the
        # ring's front: its quantizers' uniforms are that step's too.
        logits, train_losses, loss, aux, grad_norm, sparse_rate = train_update(
            state, sel_images, sel_labels, scaled_probs,
            front_draws if host_stream else draws, loss_of)

        if use_table:
            # Write-back: the trained slots' fresh scores, duplicates
            # averaged — under "loss" the loss's own per-sample values of
            # the float32 logits (the numbers the JAX step recomputes from
            # the same logits, no third NLL), under "grad_norm" the norms.
            with torch.no_grad():
                fresh = (score_of(logits.detach(), sel_labels) if grad_norm_scores
                         else train_losses.detach())
                if async_refresh:
                    # No window scored: the EMA follows the trained batch's
                    # scores reweighted to the shard's mean, E[s/(L·p)].
                    score_avg = pool_mean(fresh / scaled_probs, sync_stats, dgroup)
                    ema_prev = ema.value
                    ema = ema_update(ema, score_avg, config.ema_alpha)
                    if telemetry:
                        drift = ema_drift(score_avg, ema_prev)
                scores = scatter_mean(new_scores, selected, fresh)
                if config.use_ledger:
                    if state.sel_counts is None:  # a state built without one
                        state.sel_counts = torch.zeros_like(scores, dtype=torch.int32)
                    # One count an occurrence, at train time: a slot drawn
                    # twice counts twice; the ring in flight is not counted.
                    state.sel_counts.index_add_(
                        0, selected, torch.ones_like(selected, dtype=torch.int32))
            cursor = table.cursor
            # Async: the fleet owns the sweep and the cursor stays put.
            table = ScoreTableState(scores, cursor if async_refresh
                                    else advance_cursor(table, refresh_size))

        next_gidx = None
        if host_stream:
            # The lookahead: the selection of step t+depth, with that step's
            # draws (drawn now, in step order).
            if use_table:
                # One score_and_draw over the L slots of the table after the
                # write-back: the JAX step's table_probs, draw and
                # probs_next[next_sel]·L.
                n_slots = table.scores.shape[0]
                select = score_and_draw if use_kernels else reference.score_and_draw
                probs, next_sel, next_scaled = select(
                    table.scores, ema.value, draws.uniforms, config.is_alpha)
                if async_refresh:
                    # The stream carries the draw alone.
                    next_slots = next_sel.long()
                else:
                    # The window of step t+depth is depth R-sized advances on.
                    window = (cursor + depth * refresh_size
                              + torch.arange(refresh_size, device=dev)) % n_slots
                    next_slots = torch.cat([window, next_sel.long()])
                if telemetry:
                    # Over the table the next draw normalizes.
                    clip = clip_fraction(table.scores, ema.value, config.is_alpha)
            else:
                stream, next_slots = next_pool(stream, p_size,
                                               lambda: _perm(draws))
                next_scaled = torch.ones(batch_size, dtype=torch.float32, device=dev)
            state.pending = PendingSelection(
                slots=torch.cat([pending.slots[1:], next_slots[None]]),
                scaled_probs=torch.cat([pending.scaled_probs[1:], next_scaled[None]]),
                draws=pending.draws[1:] + (draws._replace(perm=None),))
            next_gidx = shard_row[next_slots]
        state.step += 1
        state.ema = ema
        state.stream = stream
        state.scoretable = table
        state.pending_batch, state.cached_pool, state.groupwise = (
            pending_batch, cached_pool, groupwise)
        # The telemetry's scalars and the sparse rate, averaged at W>1.
        means: Dict[str, torch.Tensor] = {}
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
            if sparse_rate is not None:
                means["train/sparse_rate"] = sparse_rate
            if aux is not None:
                means["train/moe_aux"] = aux.detach()
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
                sums = allreduce_sum(flat, dgroup)
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
            # [B]: positions in the pool trained on, or drawn this step in
            # the next pool (pipelined), or in the cached pool (cadence);
            # shard slots (scoretable, groupwise)
            "sampler/selected": selected,
        }
        if probs is not None:
            # [P] or [L]: what the batch was drawn from (host-stream
            # scoretable: what step t+depth's batch was drawn from;
            # pipelined: the next pool's; cadence: the cached pool's;
            # groupwise: the newest group's over the shard)
            metrics["sampler/probs"] = probs
        if sparse_rate is None:
            metrics["train/sparse_rate"] = dense_rate
        if aux is None:
            metrics["train/moe_aux"] = no_aux
        metrics.update(means)
        if telemetry:
            metrics["train/grad_norm"] = grad_norm
            if use_table and not async_refresh:
                metrics.update(ages)
            for family, counts in hists.items():
                metrics.update(zip(hist_keys(family), counts))
            if config.use_probe and not probe:
                metrics["sampler_dist/var_ratio"] = torch.full(
                    (), -1.0, dtype=torch.float32, device=dev)
        if host_stream:
            return metrics, next_gidx
        return metrics

    if scan_steps > 1:
        def chunk_fn(state: MercuryState, draws: Optional[Sequence[Draws]] = None,
                     use_kernels: bool = True) -> Dict[str, torch.Tensor]:
            steps = [step_fn(state, None if draws is None else draws[i], use_kernels)
                     for i in range(scan_steps)]
            return {k: torch.stack([m[k] for m in steps]) for k in steps[0]}

        return chunk_fn
    if not host_stream:
        return step_fn

    def hs_step_fn(state: MercuryState, x_stream: torch.Tensor,
                   draws: Optional[Draws] = None, use_kernels: bool = True):
        return step_fn(state, draws, use_kernels, x_stream=x_stream)

    return hs_step_fn


def second_ranks(config: TrainConfig) -> Optional[Tuple[str, int]]:
    """``("tensor_parallel", T)`` or ``("fsdp_parallel", F)`` for
    ``require_world``; None on a data-only mesh."""
    if config.second_axis is None:
        return None
    field = "tensor_parallel" if config.tensor_parallel > 1 else "fsdp_parallel"
    return field, config.second_axis[1]


def refuse_on_second_axis(config: TrainConfig) -> None:
    """What a step with a second mesh axis does not run: ZeRO and
    host_stream (the JAX step's refusals, with its messages)."""
    if config.zero_sharding:
        raise ValueError(
            "zero_sharding flattens params to a vector, which would force "
            "an all-gather of the sharded params; use fsdp_parallel or "
            "plain allreduce when a second mesh axis shards the params")
    if config.host_stream:
        raise ValueError(
            "host_stream requires a data-only mesh (no tensor/fsdp "
            "axis); drop tensor_parallel/fsdp_parallel")


def uniform_slots(uniforms: torch.Tensor, n: int) -> torch.Tensor:
    """Uniform draws with replacement from ``[0, n)``: ``⌊u·n⌋`` of each
    uniform, the inverse CDF of the flat distribution."""
    return (uniforms.reshape(-1) * n).long().clamp_(max=n - 1)


def prime_host_stream(state: MercuryState, config: TrainConfig, dataset: ShardedDataset,
                      draws: Optional[Sequence[Draws]] = None) -> torch.Tensor:
    """Fill the ring of a fresh host-stream state with the selections of
    steps 0 … depth−1 (the JAX package's ``make_host_stream_prime``) and
    return their ``[depth, S]`` global row ids, one prefetch push a row.

    Pool and uniform: the pools the replicated run takes at those steps,
    with their draws (``draws``, or drawn from the state's generator in
    step order), so the run matches the replicated one from step 0; the
    stream advances through them. Scoretable: uniform draws with
    replacement (the table knows nothing yet) from each step's uniforms,
    after the round-robin windows; every ``scaled_probs`` is 1."""
    depth = config.prefetch_depth
    dev = state.stream.perm.device
    shard_row = dataset.shard_indices[dataset.rank]
    slots_steps, kept = [], []
    for i in range(depth):
        d = draws[i] if draws is not None else make_draws(state, config)
        if config.use_async:
            # The draw alone, by the async step's inverse CDF of the flat
            # distribution: the fleet scores the windows.
            n = state.scoretable.scores.shape[0]
            flat = torch.full((n,), 1.0 / n, dtype=torch.float32, device=dev)
            slots_i = table_draw_inverse_cdf(flat, d.uniforms.to(dev)).long()
        elif config.use_scoretable:
            table = state.scoretable
            n = table.scores.shape[0]
            window = (table.cursor + i * config.refresh_size
                      + torch.arange(config.refresh_size, device=dev)) % n
            slots_i = torch.cat([window, uniform_slots(d.uniforms, n).to(dev)])
        else:
            state.stream, slots_i = next_pool(state.stream, pool_size(config),
                                              lambda: _perm(d))
        slots_steps.append(slots_i)
        kept.append(d._replace(perm=None))
    slots = torch.stack(slots_steps)
    state.pending = PendingSelection(
        slots=slots,
        scaled_probs=torch.ones((depth, config.batch_size), dtype=torch.float32, device=dev),
        draws=tuple(kept))
    return shard_row[slots]


def _perm(draws: Draws) -> torch.Tensor:
    if draws.perm is None:
        raise ValueError("the stream wraps this step: draws.perm is required")
    return draws.perm


def _int8_wire(config: TrainConfig, group=None) -> bool:
    """The int8 collectives quantize: ZeRO's two halves at any world size,
    the all-reduce (or the per-leaf wire) where :func:`allreduce_quantizes`
    says of the data-parallel ``group``."""
    return config.grad_compression == "int8" and (config.zero_sharding
                                                  or allreduce_quantizes(group))


def _need(value: Optional[torch.Tensor], name: str) -> torch.Tensor:
    if value is None:
        raise ValueError(f"this configuration's step needs the draws' {name}")
    return value
