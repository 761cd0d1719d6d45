"""Run configuration of the PyTorch port.

The fields are those of ``mercury_tpu.config.TrainConfig`` that the
importance-sampled pool (with its step modes), groupwise and scoretable
(sync or async) steps read, under the same names and with the same
defaults, so a configuration written for one package means the same run
in the other. A value the port does not implement yet raises
``ValueError`` naming the field, instead of silently training something
else.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

_MODELS = ("resnet18", "resnet34", "resnet50", "resnet101", "resnet152", "smallcnn",
           "vgg11", "vgg13", "vgg16", "vgg19", "mobilenetv2", "mobilenet_v2",
           "bilstm_attention", "mylstm", "lstm", "transformer", "vit")
_DATASETS = ("cifar10", "cifar100", "synthetic", "synthetic_tail", "synthetic_hard",
             "digits", "digits_imb", "digits_seq", "digits_seq_imb", "synthetic_seq",
             "synthetic_seq_hard", "imagefolder")
_SAMPLERS = ("pool", "scoretable", "groupwise")

# The most scorer tenants (their metric keys are t0..t3).
MAX_TENANTS = 4


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Knobs of a Mercury run: ResNet-18 on CIFAR-10, batch 32, Adam at
    0.001×world_size with cosine decay, a 10×32 candidate pool drawn down
    to 32 by importance sampling."""

    # Model / data: a ResNet, "smallcnn", a VGG, MobileNetV2, the
    # sequence models "bilstm_attention" ("mylstm", "lstm") and
    # "transformer", or "vit" (the Transformer over 4×4 image patches).
    model: str = "resnet18"
    # "cifar10" or "cifar100": real files if present, else synthetic;
    # "synthetic", "synthetic_tail", "synthetic_hard": the stand-ins;
    # "digits", "digits_imb": scikit-learn's handwritten digits;
    # "digits_seq", "digits_seq_imb" (the digits as [64, 1] scanlines),
    # "synthetic_seq", "synthetic_seq_hard": float32 [N, T, F] sequences,
    # trained with augmentation="none";
    # "imagefolder": data_dir/<class>/<image> (or data_dir/train/... and
    # data_dir/test/...), decoded with PIL and resized to image_size.
    dataset: str = "cifar10"
    num_classes: Optional[int] = None  # None: the dataset's; set: must equal it
    image_size: int = 32              # the imagefolder resize
    world_size: int = 4               # data-parallel ranks, one process each
    mesh_axis: str = "data"           # the data axis's name (manifest, messages)
    # A second axis inside each data worker, one process a rank, so a run
    # takes world_size × tensor_parallel (or × fsdp_parallel) ranks; the
    # two are mutually exclusive (parallel/mesh.py). tensor_parallel splits
    # every transformer block Megatron-style over its ranks
    # (parallel/tensor.py; the transformer family, num_heads divisible);
    # fsdp_parallel shards every parameter of at least 1024 elements along
    # its largest divisible dimension and gathers it for each forward
    # (parallel/fsdp.py; any model). Adam's moments follow the shards.
    tensor_parallel: int = 1
    model_axis: str = "model"         # the tensor-parallel axis's name
    fsdp_parallel: int = 1
    fsdp_axis: str = "fsdp"           # the FSDP axis's name
    # "replicated": every rank holds the whole train split on its device and
    # gathers its shard's rows by global index; "sharded": a rank holds only
    # its own shard's rows; "host_stream": the pixels stay in host memory
    # (numpy or np.memmap) and a prefetch pipeline (data/stream.py) sends
    # each step's rows to the device while the steps before it run: the
    # step draws its selection prefetch_depth steps ahead.
    data_placement: str = "replicated"
    # host_stream: batches in flight (the lookahead of the draw); the first
    # prefetch_depth are primed (pool and uniform: the draws the replicated
    # run makes; scoretable: uniform draws).
    prefetch_depth: int = 2
    # host_stream: threads that split each gather (0: the prefetch thread
    # gathers alone).
    decode_workers: int = 0
    # host_stream: "local" (each rank's pipeline gathers its own rows),
    # "replicated" (one pipeline gathers the whole [W, S] slab: one process,
    # so W=1 here) or "auto" (local at W>1, replicated at W=1). Every rank
    # is its own process in the port, so the two gather the same rows.
    stream_shard_mode: str = "auto"
    # restore_elastic (train/elastic.py): carry the score table, repartitioned
    # by the new ranks' ownership, and the stream and table cursors as
    # fractions of the epoch; False starts them fresh at the restored step.
    # A restore at the same world_size always carries them exactly.
    stream_checkpoint_cursor: bool = True

    # Optimization
    batch_size: int = 32
    base_lr: float = 0.001            # scaled by world_size
    optimizer: str = "adam"           # "adam" | "adamw" | "sgd"
    num_epochs: int = 100
    steps_per_epoch: Optional[int] = None  # None → n_train // batch_size
    weight_decay: float = 0.0
    warmup_steps: int = 0             # linear warmup, then cosine
    # fit stops after the first step at which step×world_size exceeds this.
    step_budget: float = 1e7
    # Cross-entropy against (1−ls)·onehot + ls/C. The NLL kernels compute
    # the plain NLL, so a nonzero value needs use_pallas=False on the card.
    label_smoothing: float = 0.0
    # Gradient accumulation (optax.MultiSteps): each step folds its gradient
    # into a running mean and every A-th step applies the update. The log,
    # eval and checkpoint cadences still count steps (microsteps).
    grad_accum_steps: int = 1
    # ZeRO-1: each rank owns 1/W of the flattened parameter vector (the JAX
    # package's ravel_pytree order) and keeps the optimizer state of that
    # chunk only. The gradient is reduce-scattered, the chunk's update
    # all-gathered and added to the replicated parameters: a reduce-scatter
    # and an all-gather move what one all-reduce would.
    zero_sharding: bool = False
    # "stochastic": each rank's gradient becomes sign(g)·max|g|·Bernoulli(
    # |g|/max|g|) per parameter before the sync (an unbiased estimator; the
    # wire still carries dense float32; train/sparse_rate is its share of
    # nonzeros). "int8": both halves of the sync (all-to-all reduce-scatter
    # and all-gather) carry int8 with one scale a row and stochastic
    # rounding, 4× fewer bytes; at one rank it runs only under
    # zero_sharding, whose two halves quantize even then.
    grad_compression: str = "none"

    # Importance sampling
    use_importance_sampling: bool = True
    # "pool": score a fresh candidate pool each step and draw from it;
    # "scoretable": see below; "groupwise": a score for every slot of the
    # shard, rescored by a sliding window of the pool's size a step, the
    # batch drawn from the newest window only (sampling/groupwise.py).
    sampler: str = "pool"
    presample_batches: int = 10       # candidate pool = 10×batch
    is_alpha: float = 0.5             # score = loss + alpha·EMA
    # The candidates' score: "loss" (the per-sample loss) or "grad_norm",
    # ‖softmax − target‖₂, the norm of the loss's gradient with respect to
    # the logits (Katharopoulos & Fleuret). The EMA smooths the mean score;
    # train/pool_loss stays the mean loss either way.
    importance_score: str = "loss"
    ema_alpha: float = 0.9
    # At W>1 the pool mean feeding the EMA is the global one (a sum and a
    # count all-reduced), so every rank keeps the same EMA.
    sync_importance_stats: bool = True
    # Score-refresh cadence (pool sampler): score a fresh pool every K-th
    # step and cache its distribution; the K−1 steps between redraw their
    # batch from the cache (fresh draws and augmentation, the same probs),
    # weighted by the cached p. 1: a fresh pool every step.
    score_refresh_every: int = 1

    # Scoretable sampler: a persistent score per shard slot; each step
    # rescores a round-robin window of refresh_size slots, decays the rest
    # toward the EMA by table_decay and draws from the whole table.
    refresh_size: int = 64
    table_decay: float = 0.98
    # "sync": the step rescores the window itself; "async": a scorer fleet
    # (sampling/scorer_fleet.py) of scorer_workers threads, each on its own
    # CUDA stream, rescores round-robin windows against a copy of the
    # parameters taken every snapshot_every steps, and the Trainer scatters
    # each chunk into the table between steps, weighted by
    # table_decay**age; the step only decays, normalizes and draws. At
    # world_size > 1 only with scorer_backend="device" (lockstep).
    refresh_mode: str = "sync"
    scorer_workers: int = 1
    snapshot_every: int = 16
    # Idle seconds a host-backend scorer worker waits between chunks (0:
    # none); must be 0 under scorer_backend="device".
    scorer_throttle_s: float = 0.0
    # Where and how the async scorer runs (sampling/scorer_service.py):
    # "host": threads of this process score continuously, paced by
    # scorer_throttle_s; "device": the workers score on a card no rank of
    # this host trains on, else on their own streams of the rank's card
    # (parallel/distributed.reserve_scorer_device), paced by snapshots: a
    # snapshot opens at most a queue's worth of chunks a tenant. At
    # world_size > 1 the device backend runs in lockstep: one tenant, one
    # worker, chunk q scored from snapshot q and applied after q+1.
    scorer_backend: str = "host"
    # Scorer tenants (1..4): a queue each, chunks scheduled by smooth
    # weighted round-robin over scorer_tenant_weights ("" = equal; "3,1":
    # tenant 0 gets 3/4). Tenant 0 feeds this trainer's table; the others
    # model co-hosted consumers, drained and discarded after accounting.
    scorer_tenants: int = 1
    scorer_tenant_weights: str = ""
    # Scoring SLOs (ScorerService.slo_status; 0 disables): a tenant's
    # staleness in steps above slo_score_staleness_max, or its queue depth
    # at or above scorer_queue_highwater, is a breach.
    slo_score_staleness_max: int = 0
    scorer_queue_highwater: int = 0

    # Augmentation and partition
    # "noniid": pad-4 crop + hflip; "iid": resize 35, crop 32, hflip and a
    # random rotation and scale (evaluation: resize 33, crop 32); "none".
    augmentation: str = "noniid"
    cutout: bool = False              # a 16×16 zeroed square, noniid only
    noniid: bool = True
    dirichlet_alpha: float = 0.5
    min_shard_size: int = 10
    # "sync": batch statistics averaged over the ranks; "local": each rank's
    # own. The same at W=1. The running statistics are averaged either way.
    batch_norm: str = "sync"

    # Bookkeeping
    seed: int = 102
    eval_every: int = 200
    log_every: int = 100
    # fit's metric stream (obs/writer.py): every log_every steps a record
    # goes to the async writer; with log_dir, rank 0 writes the run
    # manifest, metrics.jsonl and TensorBoard, and every rank its own
    # metrics.h{r}.jsonl and heartbeat.h{r}.jsonl shards. heartbeat_every
    # paces a one-line stdout summary on rank 0 (0 disables it).
    log_dir: Optional[str] = None
    heartbeat_every: int = 100
    # Checkpoints (train/checkpoint.py): fit saves every checkpoint_every
    # steps (0: never) and at its end when checkpoint_dir is set, keeping the
    # newest checkpoint_keep files (0: all); auto_resume restores the newest
    # checkpoint in checkpoint_dir when the Trainer is built (elastically
    # when it was saved at another world_size).
    checkpoint_dir: Optional[str] = None
    checkpoint_every: int = 1000
    # fit's cadence saves on a writer thread (the copy to the host stays on
    # the training thread); one write in flight. At W>1 saves stay
    # synchronous.
    async_checkpoint: bool = False
    checkpoint_keep: int = 3
    auto_resume: bool = False
    # A write that raises OSError is tried again this many times, after
    # backoff·2^k seconds; every failed attempt counts into
    # checkpoint/write_failures.
    checkpoint_write_retries: int = 2
    checkpoint_retry_backoff_s: float = 0.25
    # A sha256 sidecar (ckpt_<step>.pt.manifest.json: the file's digest and
    # each tensor's) beside every checkpoint, checked on restore: a file
    # that fails it is passed over for the next-older one, as a torn file is.
    checkpoint_manifest: bool = True
    checkpoint_verify: bool = True
    # Deterministic fault schedule (faults.py grammar), e.g.
    # "scorer_die@step=40;ckpt_io_error@step=100,every=50"; "" arms nothing.
    fault_spec: str = ""
    # The host supervisor (runtime/supervisor.py): fit checks the scorer's
    # and the prefetch worker's liveness each step, restarts a dead one
    # with exponential backoff under a budget of supervisor_restart_budget
    # restarts, and past the scorer's budget walks the ladder async → sync
    # → frozen → uniform instead of raising. A probe every
    # supervisor_probe_every steps (0: never) climbs back a level; at the
    # sync level the training thread scores a window every
    # supervisor_sync_every steps; supervisor_poll_s > 0 starts a thread
    # that timestamps deaths between steps.
    supervise: bool = False
    supervisor_restart_budget: int = 3
    supervisor_backoff_s: float = 0.5
    supervisor_probe_every: int = 200
    supervisor_poll_s: float = 0.0
    supervisor_sync_every: int = 16
    # The event journal (obs/events.py): with log_dir, every rank appends
    # the supervisor's, scorer's, fault plane's, checkpoints' and anomaly
    # engine's decisions, each with its cause's id, to events.h{r}.jsonl,
    # written by the metric writer's drain thread.
    event_journal: bool = True
    # The anomaly engine (obs/anomaly.py), rank 0: nine triggers over the
    # logged records (non-finite loss or gradient norm, ESS, stall share,
    # MFU, straggler, selection Gini, starved classes, var_ratio) and the
    # step times (slow_step: over factor × the rolling median, armed after
    # 16 steps); a trigger writes flight_record_*.json (the last
    # anomaly_window records) to anomaly_dir (None: log_dir), at most one
    # in anomaly_cooldown_steps, and arms a torch.profiler window of
    # anomaly_profile_steps steps. anomaly_inject_nan_step poisons the host
    # record's train/loss at the first log tick at or after it (0: never).
    anomaly_detection: bool = True
    anomaly_window: int = 64
    anomaly_slow_step_factor: float = 3.0
    anomaly_cooldown_steps: int = 200
    anomaly_profile_steps: int = 0
    anomaly_dir: Optional[str] = None
    anomaly_inject_nan_step: int = 0
    anomaly_straggler_factor: float = 2.0
    # Host span tracing (obs/trace.py): named spans of the training thread,
    # the prefetch worker and the scorer's workers into a ring of the last
    # trace_capacity; at close rank 0 writes log_dir/trace.json with the
    # event journal merged in. A span times host work (a step's launches,
    # not its kernels) and never synchronizes the card; with trace=False
    # every site is one shared no-op.
    trace: bool = False
    trace_capacity: int = 4096
    # Cross-rank telemetry (obs/aggregate.py): host/{min,max,spread}/* and
    # host/straggler_ratio on rank 0's records, over a window of
    # crosshost_window steps a rank. "files" tails the ranks' shards in
    # log_dir on rank 0's drain thread; "allgather" gathers at the log tick
    # on every rank; "auto" is "files" at W > 1 and "off" at one rank.
    crosshost_telemetry: str = "auto"
    crosshost_window: int = 8
    # The status server (obs/serve.py) on rank 0 at this port: /healthz,
    # /statusz and /metricsz (the writer's latest record). 0: none.
    serve_port: int = 0
    # The triggers' floors and ceilings (0 disarms each): perf/mfu (read
    # only where the card's peak is known), sampler/ess, the host stream's
    # stall share of a log interval, sampler_dist/gini, any class below
    # slo_class_starvation_share of its data share (also the sampler
    # monitor's starvation share; 0 leaves the monitor at 0.2), and
    # slo_var_ratio_patience logged probes in a row with var_ratio >= 1.
    slo_mfu_floor: float = 0.01
    slo_ess_floor: float = 0.0
    slo_stall_frac_max: float = 0.25
    slo_selection_gini_max: float = 0.0
    slo_class_starvation_share: float = 0.0
    slo_var_ratio_patience: int = 0
    # Telemetry (obs/diagnostics.py, obs/sampler_health.py): the step also
    # returns the sampler-health scalars (ESS of the importance weights,
    # score-clip fraction, EMA drift, the gradient's norm and, on the
    # scoretable path, the table's ages), the IS-weight histogram and, on
    # the scoretable path, the table's histogram and the selection-count
    # ledger. With telemetry=False none of it is computed.
    telemetry: bool = True
    # Every K-th step one extra no-grad forward of the trained batch gives
    # sampler_dist/var_ratio, the IS-vs-uniform gradient second-moment
    # ratio (< 1: importance sampling wins); other steps carry -1.0. 0 off.
    variance_probe_every: int = 0

    # Pool sampler: train on the batch selected the step before and score
    # the next pool with the same, pre-update weights (the reference's
    # update_samples runs before optimizer.step). Step 0 scores a boot pool
    # first.
    pipelined_scoring: bool = False

    # Mixture of experts (transformer family only): the Switch experts of
    # each block's MLP (None: the dense MLP); the router's load-balancing
    # loss enters the objective scaled by moe_aux_weight (the Switch
    # paper's alpha).
    moe_experts: Optional[int] = None
    moe_aux_weight: float = 0.01

    # Activation rematerialization (transformer family only): each block's
    # activations are recomputed in the backward instead of kept.
    remat: bool = False

    # Precision
    compute_dtype: str = "bfloat16"   # autocast dtype on the card
    param_dtype: str = "float32"
    # The candidate-scoring forward's precision: None scores with
    # compute_dtype; "bfloat16" scores in bf16 (on the CPU too) even when
    # training runs in float32, and the scorer-only ingest (the scoretable's
    # refresh window) emits bf16. Needs importance sampling.
    scoring_dtype: Optional[str] = None

    # Kernels: uint8 rows → normalized, cropped, flipped images in one
    # kernel (augment_normalize) instead of the unfused op chain.
    fused_input: bool = False
    # None: the kernels when the step runs on the card, their plain
    # versions on the CPU; False: the plain versions on the card too; True:
    # the kernels. The kernels need label_smoothing == 0.
    use_pallas: Optional[bool] = None

    # Data
    data_dir: Optional[str] = None    # CIFAR files (None: the search path); the image folder

    # Dispatch: fit advances scan_steps steps a call (make_train_step's
    # chunk), each metric a [scan_steps] series; single steps finish the
    # tail. Needs variance_probe_every == 0 and no host_stream.
    scan_steps: int = 1

    def __post_init__(self) -> None:
        def bad(field: str, why: str) -> None:
            raise ValueError(
                f"TrainConfig.{field}={getattr(self, field)!r}: {why}"
            )

        if self.model not in _MODELS:
            bad("model", f"the port builds {', '.join(_MODELS)}")
        if self.dataset not in _DATASETS:
            bad("dataset", f"the port loads {', '.join(_DATASETS)}")
        if self.world_size < 1:
            bad("world_size", "must be >= 1")
        for field in ("tensor_parallel", "fsdp_parallel"):
            if getattr(self, field) < 1:
                bad(field, "must be >= 1")
        if self.dataset == "imagefolder" and not self.data_dir:
            bad("dataset", "dataset='imagefolder' requires data_dir")
        if self.image_size < 1:
            bad("image_size", "must be >= 1")
        if self.data_placement not in ("replicated", "sharded", "host_stream"):
            bad("data_placement", "use 'replicated', 'sharded' or 'host_stream'")
        if self.data_placement == "host_stream" and self.prefetch_depth < 1:
            bad("prefetch_depth", "host_stream needs prefetch_depth >= 1")
        if self.decode_workers < 0:
            bad("decode_workers", "must be >= 0")
        if self.stream_shard_mode not in ("auto", "local", "replicated"):
            bad("stream_shard_mode", "use 'auto', 'local' or 'replicated'")
        if self.stream_shard_mode == "replicated" and self.world_size > 1:
            bad("stream_shard_mode", "'replicated' is one process only: each "
                "rank is a process, so use 'local' (the W>1 default)")
        if self.sampler not in _SAMPLERS:
            bad("sampler", f"the port samples with {', '.join(_SAMPLERS)}")
        if self.refresh_mode not in ("sync", "async"):
            bad("refresh_mode", "use 'sync' or 'async'")
        if self.refresh_mode == "async" and not self.use_scoretable:
            bad("refresh_mode", "'async' requires sampler='scoretable' with "
                "use_importance_sampling=True (the scorer fleet refreshes the "
                f"persistent score table), got sampler={self.sampler!r}, "
                f"use_importance_sampling={self.use_importance_sampling}")
        # The JAX step's refusals: the backend and the tenants are the async
        # scorer's (validate_scorer_composition checks the backend's name).
        if self.scorer_backend != "host" and not self.use_async:
            bad("scorer_backend", "any backend but 'host' requires refresh_mode='async' "
                "with sampler='scoretable'")
        if self.scorer_tenants != 1 and not self.use_async:
            bad("scorer_tenants", "requires refresh_mode='async' with "
                "sampler='scoretable' (tenancy is a property of the scorer service)")
        if self.use_async:
            if self.scorer_workers < 1:
                bad("scorer_workers", "must be >= 1")
            if self.snapshot_every < 1:
                bad("snapshot_every", "must be >= 1")
            if self.scorer_throttle_s < 0:
                bad("scorer_throttle_s", "must be >= 0")
            validate_scorer_composition(self, self.world_size)
        if self.use_scoretable:
            if self.refresh_size < 1:
                bad("refresh_size", "must be >= 1")
            if not 0.0 <= self.table_decay <= 1.0:
                bad("table_decay", "must be in [0, 1]")
        if self.scoring_dtype not in (None, "bfloat16", "float32"):
            bad("scoring_dtype", "use None, 'bfloat16' or 'float32'")
        if self.scoring_dtype is not None and not self.use_importance_sampling:
            bad("scoring_dtype", "scoring_dtype only affects the candidate-scoring "
                "forward; set use_importance_sampling=True (or drop scoring_dtype)")
        if self.augmentation not in ("noniid", "iid", "none"):
            bad("augmentation", "use 'noniid', 'iid' or 'none'")
        if self.fused_input and self.augmentation != "noniid":
            bad("fused_input", "the fused ingest kernel fuses the noniid "
                "crop and flip; set augmentation='noniid'")
        if self.fused_input and self.cutout:
            bad("fused_input", "the fused ingest kernel does not fuse "
                "cutout; set cutout=False")
        if self.importance_score not in ("loss", "grad_norm"):
            bad("importance_score", "use 'loss' or 'grad_norm'")
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
        if self.grad_accum_steps < 1:
            bad("grad_accum_steps", "must be >= 1")
        if self.grad_compression not in ("none", "stochastic", "int8"):
            bad("grad_compression", "use 'none', 'stochastic' or 'int8'")
        if self.variance_probe_every < 0:
            bad("variance_probe_every", "must be >= 0")
        # The pool sampler's step modes, refused where the JAX step
        # refuses them; without importance sampling both flags are ignored.
        if self.score_refresh_every < 1:
            bad("score_refresh_every", "must be >= 1")
        if self.use_pipelined and self.sampler != "pool":
            bad("pipelined_scoring", f"requires sampler='pool', got {self.sampler!r}")
        if self.use_cadence and self.sampler != "pool":
            bad("score_refresh_every", f"> 1 requires sampler='pool' (the {self.sampler!r} "
                "sampler already keeps scores across steps)")
        if self.use_cadence and self.use_pipelined:
            bad("score_refresh_every", "> 1 does not compose with pipelined_scoring: the "
                "cadence already removes the scoring forward the pipeline moves")
        if self.host_stream and self.use_pipelined:
            bad("pipelined_scoring", "data_placement='host_stream' already draws ahead "
                "(its lookahead); the two do not compose")
        if self.host_stream and self.use_cadence:
            bad("score_refresh_every", "data_placement='host_stream' requires 1: the "
                "cached pool redraws slots whose rows were never streamed")
        if self.host_stream and self.use_groupwise:
            bad("sampler", "data_placement='host_stream' takes 'pool' or 'scoretable': the "
                "groupwise draw reads scores of this step and cannot be drawn ahead")

    @property
    def lr(self) -> float:
        """Linear-scaling rule: base_lr × world_size."""
        return self.base_lr * self.world_size

    @property
    def second_axis(self) -> Optional[Tuple[str, int]]:
        """The mesh's second axis, ``(name, size)``, when tensor_parallel or
        fsdp_parallel is above 1 (tensor_parallel's when both are); None
        for a data-only mesh."""
        if self.tensor_parallel > 1:
            return self.model_axis, self.tensor_parallel
        if self.fsdp_parallel > 1:
            return self.fsdp_axis, self.fsdp_parallel
        return None

    @property
    def use_scoretable(self) -> bool:
        """The scoretable step runs only with importance sampling on; with
        it off the step is the uniform arm whatever the sampler."""
        return self.use_importance_sampling and self.sampler == "scoretable"

    @property
    def use_async(self) -> bool:
        """The scoretable refreshed by the scorer fleet, off the step."""
        return self.use_scoretable and self.refresh_mode == "async"

    @property
    def use_groupwise(self) -> bool:
        return self.use_importance_sampling and self.sampler == "groupwise"

    @property
    def use_pipelined(self) -> bool:
        return self.use_importance_sampling and self.pipelined_scoring

    @property
    def use_cadence(self) -> bool:
        """The cached-pool cadence: importance sampling with
        ``score_refresh_every > 1``."""
        return self.use_importance_sampling and self.score_refresh_every > 1

    @property
    def use_ledger(self) -> bool:
        """The selection-count ledger rides with the score table, under
        telemetry."""
        return self.use_scoretable and self.telemetry

    @property
    def use_probe(self) -> bool:
        """The grad-variance probe needs telemetry and importance
        weights."""
        return (self.telemetry and self.variance_probe_every > 0
                and self.use_importance_sampling)

    @property
    def host_stream(self) -> bool:
        return self.data_placement == "host_stream"

    @property
    def resolved_stream_shard_mode(self) -> str:
        """``"auto"`` resolved by process count, as the JAX package
        resolves it: a rank a process, so ``"local"`` at W>1."""
        if self.stream_shard_mode != "auto":
            return self.stream_shard_mode
        return "local" if self.world_size > 1 else "replicated"

    @property
    def stream_rows(self) -> int:
        """Rows a host-stream step receives: the pool, or the refresh
        window and the drawn batch, or the batch (uniform, and the async
        scoretable, whose fleet scores its windows itself)."""
        if self.use_async:
            return self.batch_size
        if self.use_scoretable:
            return self.refresh_size + self.batch_size
        return self.candidate_pool_size if self.use_importance_sampling else self.batch_size

    @property
    def candidate_pool_size(self) -> int:
        """Per-step importance candidate count (10×32 = 320 by default)."""
        return self.presample_batches * self.batch_size

    def run_name(self) -> str:
        """The run's name, encoding the config as the JAX package's does."""
        iid = "noniid" if self.noniid else "iid"
        isp = "is" if self.use_importance_sampling else "uniform"
        return (f"{self.model}_{self.dataset}_{isp}_{iid}_w{self.world_size}"
                f"_b{self.batch_size}_lr{self.lr:g}_seed{self.seed}")

    def replace(self, **kw) -> "TrainConfig":
        return dataclasses.replace(self, **kw)


def parse_tenant_weights(config: TrainConfig) -> List[float]:
    """``scorer_tenant_weights`` as floats ("" = equal weights); raises
    ``ValueError`` naming the field on a bad entry, length or sign."""
    n = int(config.scorer_tenants)
    raw = (config.scorer_tenant_weights or "").strip()
    if not raw:
        return [1.0] * n
    prefix = f"TrainConfig.scorer_tenant_weights={config.scorer_tenant_weights!r}: "
    try:
        weights = [float(w) for w in raw.split(",")]
    except ValueError:
        raise ValueError(prefix + "must be comma-separated numbers") from None
    if len(weights) != n:
        raise ValueError(prefix + f"has {len(weights)} entries for scorer_tenants={n}")
    if any(w <= 0 for w in weights):
        raise ValueError(prefix + "entries must be > 0")
    return weights


def validate_scorer_composition(config: TrainConfig, world_size: int) -> None:
    """Refuse what JAX's ``validate_scorer_composition`` refuses, with
    ``world_size`` (a process a rank) in place of the process count; each
    ``ValueError`` names its field."""

    def bad(field: str, why: str) -> None:
        raise ValueError(f"TrainConfig.{field}={getattr(config, field)!r}: {why}")

    backend = config.scorer_backend
    if backend not in ("host", "device"):
        bad("scorer_backend", "use 'host' or 'device'")
    tenants = int(config.scorer_tenants)
    if not 1 <= tenants <= MAX_TENANTS:
        bad("scorer_tenants", f"must be in 1..{MAX_TENANTS} (the metric keys are "
            f"t0..t{MAX_TENANTS - 1})")
    parse_tenant_weights(config)
    if backend == "device" and float(config.scorer_throttle_s) != 0.0:
        bad("scorer_throttle_s", "is the host backend's duty-cycle knob; the device "
            "backend is paced by snapshots (each opens one bounded scoring epoch, so "
            "snapshot_every bounds the duty cycle): set scorer_throttle_s=0")
    if world_size > 1:
        if backend == "host":
            bad("refresh_mode", "'async' with scorer_backend='host' is "
                "single-controller only: the scorer fleet's params snapshot and its "
                "(slots, scores) chunk stream are per-process, with no protocol across "
                "processes to keep every rank's score table consistent; "
                "scorer_backend='device' scores in deterministic lockstep and runs at "
                "world_size > 1")
        for field in ("scorer_tenants", "scorer_workers"):
            if int(getattr(config, field)) > 1:
                bad(field, "world_size > 1 runs scorer_backend='device' in deterministic "
                    "lockstep (chunk q scored from snapshot q, delivered at snapshot q+1, "
                    "on every rank), with exactly one tenant and one worker")
