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

With ``tensor_parallel=T`` or ``fsdp_parallel=F`` the process group has
``world_size × T`` (or ``× F``) ranks, one process each, and the Trainer
builds the mesh (``parallel/mesh.py``, :func:`build_mesh`) with the JAX
Trainer's refusals and messages: global rank ``r`` is data worker
``r // T`` (``self.rank``: its dataset shard row, sampler row and draws)
and shard ``r % T`` of the model, which it cuts to its Megatron shards
(``parallel/tensor.py``, the transformer family) or FSDP shards
(``parallel/fsdp.py``, any model) before the optimizer is built. The
step's collectives run over the data group. Every rank calls ``fit``,
``train_step``, ``evaluate``, ``predict``, ``save`` and ``restore``
(the forwards gather or all-reduce over the model group); the first rank
of each model group writes its worker's log shards, and global rank 0
the run's manifest, records and journal. A checkpoint holds the whole
model and moments, so it restores into another layout at the same
``world_size``, and ``restore_elastic`` into any. Under async refresh one
scorer serves a model group, on its first rank, which broadcasts the
chunks it applies to the group (:meth:`Trainer._shared_chunks`); the
supervisor's ladder is agreed over every rank.

Beyond training: ``save``/``restore`` (``train/checkpoint.py``; ``fit``
saves every ``checkpoint_every`` steps and at its end when
``checkpoint_dir`` is set, the cadence saves on a writer thread under
``async_checkpoint``, and ``auto_resume`` restores the newest checkpoint
there at construction, falling back to an older one that fails to load or
to verify), ``restore_elastic`` (``train/elastic.py``: a checkpoint of
another world size, which ``auto_resume`` takes by itself), ``predict``
(logits of raw images) and ``per_class_accuracy``.

With a ``fault_spec`` the Trainer arms a
:class:`~mercury_tpu_torch.faults.FaultPlane` and hands it to the hook
sites: ``fit`` (``host_slow``, and the clock), the checkpoint writes
(``ckpt_io_error``), the prefetch worker, the scorer and the metric
writer. ``fit``'s log records then carry ``fault/injected`` and
``fault/armed``, and with a ``checkpoint_dir`` always
``checkpoint/write_failures``. Without ``supervise`` a worker an injected
fault killed raises at the next step, as in the JAX package.

The supervised host runtime, as the JAX Trainer builds it: with
``log_dir`` and ``event_journal`` an
:class:`~mercury_tpu_torch.obs.events.EventJournal` (``events.h{r}.jsonl``)
is built first, and the fault plane, the scorer service, the checkpoint
writes and restores, the supervisor and the anomaly engine journal their
decisions to it; the metric writer's drain thread writes it. Rank 0 keeps
an :class:`~mercury_tpu_torch.obs.anomaly.AnomalyEngine` (``anomaly_*`` and
``slo_*``), a writer observer over every logged record, fed each step's
time by ``fit``; its dumps (``flight_record_*.json``) go to
``anomaly_dir`` or ``log_dir``, and a trigger may open a
:class:`~mercury_tpu_torch.train.profile.ProfilerWindow`. With
``supervise`` a :class:`~mercury_tpu_torch.runtime.supervisor.
HostSupervisor` supervises the prefetch worker (``escalates=False``: a
dead one is rebuilt from the state's ring, bit-equal to an uninterrupted
run, within the budget; past it ``fit`` raises) and the async scorer
(``escalates=True``: restarted within the budget, and past it the ladder
async → sync → frozen → uniform, :meth:`Trainer._refresh_tick`); the
scorer service's SLOs walk the same ladder. ``fit`` ticks it each step and
logs its ``supervisor/*`` keys and ``sampler/is_active``; :meth:`close`
writes ``supervisor_summary.json`` to ``log_dir`` on rank 0.

The rest of the host runtime's observability, as the JAX Trainer builds
it. ``trace=True`` records host spans (``obs/trace.py``: ``trainer/*`` on
the ``train`` thread, ``stream/*`` on the prefetch worker, ``fleet/chunk``
on the scorer's workers, ``anomaly/<kind>`` and ``profiler/*`` instants)
into a ring of ``trace_capacity``; a span times the host's work, a step's
launches and not its kernels, and never synchronizes the card. At
:meth:`close` rank 0 writes ``log_dir/trace.json`` with its event journal
merged in. ``crosshost_telemetry`` (``obs/aggregate.py``) adds
``host/{min,max,spread}/*`` and ``host/straggler_ratio`` to rank 0's
records, from the ranks' shards (``"files"``, on the drain thread) or by
an all-gather at the log tick (``"allgather"``); each record carries
``time/host_s``, the training thread's seconds a step outside the step's
dispatch, which the straggler window reads. ``serve_port`` starts a
:class:`~mercury_tpu_torch.obs.serve.StatusServer` on rank 0 (``/healthz``,
``/statusz``, ``/metricsz`` from the writer's latest record), last in the
constructor and first in :meth:`close`. When an anomaly-armed profiler
window closes, rank 0 attributes its trace (``obs/profile_parse.py``),
writes ``device_time_breakdown.json`` and logs the ``prof/*`` keys. At
``world_size > 1`` the supervisor agrees the ladder's level with the other
ranks every tick (``runtime/supervisor.py``), and a descent out of async
releases the scorer service's lockstep.

Under ``data_placement="host_stream"`` the train pixels stay a host array
(``dataset``, when passed, may hold an ``np.memmap``): the Trainer primes
the state's ring of selections in flight, keeps a
:class:`~mercury_tpu_torch.data.stream.PrefetchPipeline` ``prefetch_depth``
batches ahead, and each step is pop → step → push (:meth:`train_step`).
``fit`` adds the pipeline's ``data/*`` counters to its log records, a
restore refills the pipeline from the restored ring (or primes it anew
from a checkpoint without one), and :meth:`close` stops the worker.

Under ``refresh_mode="async"`` the Trainer keeps a scorer, built after
the state and before ``auto_resume``, with a first snapshot: a
:class:`~mercury_tpu_torch.sampling.scorer_fleet.ScorerFleet`, or, as the
JAX Trainer chooses, a
:class:`~mercury_tpu_torch.sampling.scorer_service.ScorerService` when
``scorer_backend="device"``, ``scorer_tenants > 1`` or a scoring SLO is
armed (at ``world_size > 1`` the device backend's lockstep). After every
step (:meth:`train_step`) it scatters the chunks ready for this trainer
into the table, each weighted by ``table_decay**age`` (a chunk with a
non-finite score is rejected and counted), and snapshots the parameters
every ``snapshot_every`` steps; nothing of it waits for the device, but a
lockstep snapshot waits for this rank's scorer. ``fit``'s log records add
the scorer's ``stats()`` keys and ``sampler/chunks_rejected``; a restore
drops the queued chunks and snapshots the restored parameters;
:meth:`close` stops the scorer.

With the scoretable sampler and ``telemetry`` the Trainer keeps a
``SamplerHealthMonitor`` (``obs/sampler_health.py``): at every
``log_every`` tick ``fit`` merges its seven ledger-derived keys into the
logged record (:meth:`Trainer.sampler_health`), and into its returned
dict when its last step is a tick. At W>1 rank 0 gathers every rank's
ledger, table and EMA for them at the tick; the other ranks log without.

Every Trainer streams its log ticks through an
:class:`~mercury_tpu_torch.obs.writer.AsyncMetricWriter` (``self.logger``):
``fit`` enqueues each tick's record (the step's scalar metrics, still on
the device, with the live ``perf/*`` rates of
:class:`~mercury_tpu_torch.obs.accounting.ThroughputMeter` and the host
counters) and a drain thread copies it to the host and writes it. With
``log_dir`` rank 0 writes ``run_manifest.json``, ``metrics.jsonl`` and
TensorBoard (when it imports), and every rank its metric and heartbeat
shards; ``heartbeat_every`` prints a line on rank 0. :meth:`close` (or
``with Trainer(config) as t:``) stops the supervisor, the scorer and the
prefetch worker, then drains and closes the writer and the journal.
"""

from __future__ import annotations

import copy
import dataclasses
import functools
import inspect
import json
import math
import os
import time
from typing import Any, Dict, List, Optional, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist

from mercury_tpu_torch.config import TrainConfig
from mercury_tpu_torch.data import cifar
from mercury_tpu_torch.data.partition import partition_data
from mercury_tpu_torch.data.pipeline import (
    ShardedDataset,
    eval_batches,
    make_sharded_dataset,
    normalize_images,
)
from mercury_tpu_torch.data.stream import HostStreamSource, PrefetchPipeline
from mercury_tpu_torch.data.transforms import EVAL_RESIZE, IID_CROP, eval_transform_iid
from mercury_tpu_torch.faults import FaultPlane
from mercury_tpu_torch.models import (
    TRANSFORMERS,
    TransformerClassifier,
    create_model,
    require_transformer_for,
)
from mercury_tpu_torch.models.resnet import set_sync_batch_norm
from mercury_tpu_torch.obs.accounting import ThroughputMeter, flops_per_step
from mercury_tpu_torch.obs.aggregate import (
    CrossHostGatherAggregator,
    HostShardAggregator,
    resolve_mode,
)
from mercury_tpu_torch.obs.anomaly import AnomalyEngine
from mercury_tpu_torch.obs.events import EventJournal, journal_filename, read_journal
from mercury_tpu_torch.obs.manifest import build_run_manifest, write_run_manifest
from mercury_tpu_torch.obs.profile_parse import parse_profile, scope_frac_metrics, write_breakdown
from mercury_tpu_torch.obs.sampler_health import SamplerHealthMonitor
from mercury_tpu_torch.obs.serve import StatusServer
from mercury_tpu_torch.obs.trace import NULL_TRACER, SpanTracer
from mercury_tpu_torch.obs.writer import (
    AsyncMetricWriter,
    HeartbeatShardSink,
    HeartbeatSink,
    JsonlSink,
    host_thread_stats,
    shard_filename,
    try_tensorboard_sink,
)
from mercury_tpu_torch.ops.mercury_kernels import per_sample_nll
from mercury_tpu_torch.parallel import distributed
from mercury_tpu_torch.parallel.fsdp import shard_model_fsdp
from mercury_tpu_torch.parallel.mesh import Mesh, full_state_dict, make_mesh, make_tp_mesh
from mercury_tpu_torch.parallel.tensor import shard_model_tp
from mercury_tpu_torch.parallel.collectives import (
    allgather_floats,
    allreduce_max_ints,
    broadcast_from_first,
    gather_to_rank0,
    host_flag_device,
)
from mercury_tpu_torch.parallel.distributed import cards_in_use
from mercury_tpu_torch.runtime.supervisor import HostSupervisor
from mercury_tpu_torch.sampling.scoretable import apply_async_chunk
from mercury_tpu_torch.sampling.scorer_fleet import ScoreChunk, ScorerFleet
from mercury_tpu_torch.sampling.scorer_service import ScorerService
from mercury_tpu_torch.train import checkpoint, elastic
from mercury_tpu_torch.train.profile import ProfilerWindow
from mercury_tpu_torch.train.state import MercuryState, create_state
from mercury_tpu_torch.train.step import (
    Draws,
    make_train_step,
    prime_host_stream,
    refuse_on_second_axis,
    second_ranks,
    to_nchw,
)
from mercury_tpu_torch.utils.logging import get_logger

_log = get_logger(__name__)
EVAL_BATCH = 256
# The status of a model group's chunk broadcast (Trainer._shared_chunks).
_CHUNKS_TAKEN, _CHUNKS_NONE, _CHUNKS_FAILED = 0, 1, 2


def resolve_device(device=None) -> torch.device:
    """``None`` → this rank's card; no card and no explicit device
    raises."""
    return distributed.device() if device is None else torch.device(device)


def build_dataset(config: TrainConfig, device, rank: int = 0) -> ShardedDataset:
    """Load, partition and place the dataset for worker ``rank``, as the JAX
    package's ``build_dataset`` does from the same config: every rank
    partitions the same way from the seed. ``dataset="imagefolder"``
    decodes ``data_dir`` once, resized to ``image_size``."""
    if config.dataset == "imagefolder":
        from mercury_tpu_torch.data.imagefolder import load_imagefolder_dataset

        train, test, info = load_imagefolder_dataset(
            config.data_dir, image_size=config.image_size, seed=config.seed)
    else:
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


def build_mesh(config: TrainConfig, model: Optional[torch.nn.Module] = None) -> Mesh:
    """The run's mesh, after the JAX Trainer's refusals of a second axis
    (its messages): tensor_parallel and fsdp_parallel together, tensor
    parallelism outside the transformer family or with ``num_heads`` (the
    passed model's, else the family's default) not divisible by it; then
    the step's (``train/step.refuse_on_second_axis``). A second axis needs
    a process group of ``world_size × n`` ranks. This is the one place of
    those checks: ``make_train_step`` under a second axis takes this
    mesh."""
    tp, fs = config.tensor_parallel, config.fsdp_parallel
    if tp > 1 and fs > 1:
        raise ValueError(
            "tensor_parallel and fsdp_parallel are mutually exclusive "
            "(both claim the second mesh axis); pick one")
    if tp > 1:
        if config.model not in TRANSFORMERS:
            raise ValueError(
                "tensor_parallel requires the transformer family "
                f"(model='transformer'|'vit'), got {config.model!r}")
        heads = (model.blocks[0].num_heads if model is not None else
                 inspect.signature(TransformerClassifier).parameters["num_heads"].default)
        if heads % tp != 0:
            raise ValueError(f"num_heads={heads} must be divisible by tensor_parallel={tp}")
    second = config.second_axis
    if second is None:
        # The step checks the process group (make_train_step).
        return make_mesh(config.world_size, config.mesh_axis)
    refuse_on_second_axis(config)
    distributed.require_world(config.world_size, second_ranks(config))
    return make_tp_mesh(config.world_size, second[1], config.mesh_axis, second[0])


class Trainer:
    """``Trainer(config)`` builds everything on the card; ``dataset`` (a
    :class:`ShardedDataset` of this rank, placed as ``config.data_placement``
    says) and ``model`` may be passed in (the tests pass a small model),
    with the same weights on every rank."""

    def __init__(self, config: TrainConfig, dataset: Optional[ShardedDataset] = None,
                 device=None, model: Optional[torch.nn.Module] = None) -> None:
        self.config = config
        if config.serve_port < 0 or config.serve_port > 65535:
            raise ValueError(
                f"serve_port must be 0 (off) or a valid TCP port, "
                f"got {config.serve_port}"
            )
        # The JAX Trainer's refusals of crosshost_telemetry, crosshost_window
        # and trace_capacity, before anything is built.
        self._crosshost_mode = resolve_mode(config.crosshost_telemetry, config.world_size,
                                            config.log_dir)
        if self._crosshost_mode != "off" and config.crosshost_window < 1:
            raise ValueError(f"window must be >= 1, got {config.crosshost_window}")
        # Host spans (obs/trace.py); the disabled tracer is one shared no-op.
        self.tracer = SpanTracer(config.trace_capacity) if config.trace else NULL_TRACER
        # The mesh (parallel/mesh.py): the data worker this rank is, and
        # under tensor_parallel or fsdp_parallel its shard of the model. A
        # model group's ranks are one worker: the same shard row, sampler
        # row and draws. Its first rank writes the worker's logs; global
        # rank 0 the run's.
        self.mesh = build_mesh(config, model)
        self.rank = self.mesh.data_rank
        self._leads = self.mesh.leads
        self._is_rank0 = self.rank == 0 and self._leads
        dgroup = self.mesh.data_group
        self.device = resolve_device(device)
        if dataset is None:
            dataset = build_dataset(config, self.device, self.rank)
        elif dataset.host_pixels != config.host_stream:
            raise ValueError(
                f"data_placement={config.data_placement!r} but the dataset's train "
                f"pixels are {'a host array' if dataset.host_pixels else 'a tensor'}: "
                "build it with make_sharded_dataset(..., placement=data_placement)")
        self.dataset = dataset
        # fit's async cadence write in flight, at most one.
        self._ckpt_thread: Optional[checkpoint.AsyncSave] = None
        if config.num_classes is not None and config.num_classes != self.dataset.num_classes:
            raise ValueError(
                f"config.num_classes={config.num_classes} but dataset "
                f"{config.dataset!r} has {self.dataset.num_classes} classes")
        # The JAX Trainer's refusals of remat, of experts outside the
        # transformer family and of augmenting sequences.
        # [H, W, C] for images, [T, F] for sequences.
        sample_shape = tuple(int(s) for s in self.dataset.x_train.shape[1:])
        if len(sample_shape) != 3 and config.augmentation != "none":
            raise ValueError(
                f"augmentation={config.augmentation!r} needs image data; "
                f"dataset {config.dataset!r} has sample shape {sample_shape} — "
                "set augmentation='none'")
        if config.moe_experts is not None:
            require_transformer_for("moe_experts", config.model)
        if config.remat:
            require_transformer_for("remat", config.model)
        # Refuses a world_size that the process group does not have, and
        # label smoothing where the kernels would run.
        self._step_fn = make_train_step(config, self.dataset, mesh=self.mesh)
        # K steps a call for fit (train_chunk), refused with the probe or
        # host_stream; the JAX Trainer's warning for a cadence a chunk can
        # step over.
        self.scan_steps = max(int(config.scan_steps), 1)
        self._chunk_fn = None
        if self.scan_steps > 1:
            for name in ("log_every", "eval_every", "checkpoint_every"):
                every = getattr(config, name)
                if every and every % self.scan_steps != 0:
                    print(f"warning: {name}={every} is not a multiple of "
                          f"scan_steps={self.scan_steps}; cadence actions fire "
                          "at most once per chunk (at chunk boundaries)")
            self._chunk_fn = make_train_step(config, self.dataset, scan_steps=self.scan_steps,
                                             mesh=self.mesh)
        # The event journal, before every producer that takes it.
        self._journal: Optional[EventJournal] = (
            EventJournal(config.log_dir, self.rank)
            if config.log_dir and config.event_journal and self._leads else None)
        # The fault plane, before every hook site it is handed to (a
        # malformed spec raises here).
        try:
            self._faults: Optional[FaultPlane] = (
                FaultPlane(config.fault_spec, journal=self._journal)
                if config.fault_spec else None)
        except BaseException:
            self.close()
            raise
        # The IID evaluation's crop offsets, the same for every batch, as
        # the JAX package crops every batch with one fixed key (its offsets
        # differ from these: threefry is not Philox).
        self.eval_crop = torch.randint(
            0, EVAL_RESIZE - IID_CROP + 1, (EVAL_BATCH, 2),
            generator=torch.Generator().manual_seed(0), dtype=torch.int32).to(self.device)
        if model is None:
            gen = torch.Generator().manual_seed(config.seed)
            # The sample shape sizes the input (and VGG's head) as the JAX
            # init's sample does: the dataset's, before any augmentation.
            model = create_model(config.model, self.dataset.num_classes, gen, sample_shape,
                                 remat=config.remat, moe_experts=config.moe_experts)
        # Under async refresh with a second axis, the model group's scorer
        # (on its first rank) scores with an unsharded copy: a shard's
        # forward would call the group's collectives from the scorer's
        # threads.
        scorer_model = None
        if config.use_async and self.mesh.model is not None and self._leads:
            scorer_model = copy.deepcopy(model).to(self.device)
            if self.device.type == "cuda":
                scorer_model = scorer_model.to(memory_format=torch.channels_last)
        # Under a second axis: this rank's shards (the whole model arrives,
        # the same on every rank, and each keeps its slices).
        if config.tensor_parallel > 1:
            shard_model_tp(model, self.mesh.model)
        elif config.fsdp_parallel > 1:
            shard_model_fsdp(model, self.mesh.model)
        set_sync_batch_norm(model, config.batch_norm == "sync" and config.world_size > 1,
                            dgroup)
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
            with_groupwise=config.use_groupwise,
            pending_batch_size=config.batch_size if config.use_pipelined else 0,
            # The IID augmentation crops to 32 whatever the image size.
            pending_sample_shape=((32, 32, sample_shape[-1])
                                  if config.augmentation == "iid" else sample_shape),
            cached_pool_size=config.candidate_pool_size if config.use_cadence else 0,
            world_size=config.world_size, zero_sharding=config.zero_sharding,
        )
        self.state.mesh = self.mesh
        self.sampler_monitor: Optional[SamplerHealthMonitor] = None
        if config.use_ledger:
            self.sampler_monitor = SamplerHealthMonitor(
                self.dataset.shard_indices.cpu().numpy(),
                self.dataset.y_train.cpu().numpy(), self.dataset.num_classes,
                config.is_alpha, starvation_share=config.slo_class_starvation_share or 0.2)
        # The anomaly engine, rank 0's: its value checks run on the writer's
        # drain thread; only the step-time check runs here.
        self.anomaly: Optional[AnomalyEngine] = None
        if config.anomaly_detection and self._is_rank0:
            self.anomaly = AnomalyEngine(
                ring_steps=config.anomaly_window,
                slow_step_factor=config.anomaly_slow_step_factor,
                ess_floor=config.slo_ess_floor,
                stall_frac_max=config.slo_stall_frac_max if config.host_stream else 0.0,
                mfu_floor=config.slo_mfu_floor,
                straggler_factor=config.anomaly_straggler_factor,
                gini_max=config.slo_selection_gini_max,
                # Any starved class breaches; the share is the monitor's.
                starved_classes=1.0 if config.slo_class_starvation_share > 0 else 0.0,
                var_ratio_patience=config.slo_var_ratio_patience,
                cooldown_steps=config.anomaly_cooldown_steps,
                dump_dir=config.anomaly_dir or config.log_dir,
                context_fn=self._flight_context,
                profile_steps=config.anomaly_profile_steps,
                journal=self._journal, tracer=self.tracer)
        self._profiler = ProfilerWindow(config.anomaly_dir or config.log_dir)
        self._nan_injected = False
        # The supervisor; the units register as their fleets are built.
        self.supervisor: Optional[HostSupervisor] = None
        if config.supervise:
            self.supervisor = HostSupervisor(
                restart_budget=config.supervisor_restart_budget,
                backoff_s=config.supervisor_backoff_s,
                probe_every=config.supervisor_probe_every,
                poll_s=config.supervisor_poll_s,
                anomaly=self.anomaly, journal=self._journal,
                # At W>1 the ranks agree the ladder's level every tick; under
                # a second axis every rank does, at W=1 too, since a model
                # group's ranks share one scorer.
                agree=(allreduce_max_ints if self.mesh.world_size * self.mesh.second > 1
                       else None))
        # The ladder level the refresh path last acted on (3: flattened).
        self._actuated_level = 0
        # host_stream: prime the ring with steps 0 … depth−1 and put their
        # gathers in flight. Built before auto_resume: a restore refills it.
        self._stream_pipe: Optional[PrefetchPipeline] = None
        self._stream_gen = 0   # supervisor restarts of the pipeline
        if config.host_stream:
            # One pipeline a rank, over this rank's own rows: every rank is
            # a process, so stream_shard_mode "local" and "replicated" (W=1)
            # gather the same rows.
            self._stream_pipe = self._new_stream_pipe()
            self._seed_stream_pipe(
                prime_host_stream(self.state, config, self.dataset))
            if self.supervisor is not None:
                # No degraded mode makes pixels: past its budget a dead
                # worker raises. ``alive`` reads the current pipeline.
                self.supervisor.register_unit(
                    "prefetch", alive=lambda: self._stream_pipe.alive(),
                    restart=self._restart_stream_pipe, escalates=False)
        # The metric stream: the manifest and the sinks, then the writer,
        # whose drain thread starts at the first record.
        sinks = []
        if config.log_dir and self._is_rank0:
            write_run_manifest(config.log_dir, config, self.device)
            sinks.append(JsonlSink(config.log_dir))
            sinks.append(try_tensorboard_sink(config.log_dir))
        if config.log_dir and self._leads:
            # Every worker (rank 0 included) writes its own metric and
            # heartbeat shards, from the first rank of its model group.
            sinks.append(JsonlSink(config.log_dir, filename=shard_filename(self.rank)))
            sinks.append(HeartbeatShardSink(config.log_dir, self.rank))
        if config.heartbeat_every and self._is_rank0:
            sinks.append(HeartbeatSink(every_steps=config.heartbeat_every))
        # Cross-rank telemetry: rank 0's shard tailer rides the drain thread
        # ahead of the anomaly engine (which reads its host/* keys); the
        # all-gather runs at the log tick on every rank.
        self._host_agg: Optional[HostShardAggregator] = None
        self._crosshost_gather: Optional[CrossHostGatherAggregator] = None
        if self._crosshost_mode == "files" and self._is_rank0:
            self._host_agg = HostShardAggregator(
                config.log_dir, processes=config.world_size, window=config.crosshost_window)
        elif self._crosshost_mode == "allgather":
            self._crosshost_gather = CrossHostGatherAggregator(
                window=config.crosshost_window,
                gather=_on_group(allgather_floats, dgroup), rank=self.rank)
        observers = [] if self._host_agg is None else [self._host_agg.observe_record]
        if self.anomaly is not None:
            observers.append(self.anomaly.observe_record)
        if self.supervisor is not None:
            observers.append(self.supervisor.observe_record)
        self.logger = AsyncMetricWriter(sinks, observers=observers, faults=self._faults,
                                        journal=self._journal)
        # steps/s, examples/s and MFU between log ticks; the FLOP count is
        # taken at the first log tick.
        self._throughput = ThroughputMeter(
            examples_per_step=config.batch_size * config.world_size,
            device_kind=(torch.cuda.get_device_name(self.device)
                         if self.device.type == "cuda" else None))
        self._flops_known = False
        # The step's dispatch seconds so far, and fit's host seconds outside
        # it since the last log tick (time/host_s: the straggler's signal).
        self._dispatch_s = 0.0
        self._host_s = 0.0
        self._host_steps = 0
        # refresh_mode="async": the scorer and its first snapshot. Built
        # before auto_resume: a restore resets it.
        self._async = config.use_async
        self._scorer_fleet: Optional[Union[ScorerFleet, ScorerService]] = None
        # The ladder's revival, which the probe after it runs (_revive_scorer).
        self._revive_due = False
        self._chunks_rejected = 0
        # Chunks whose copy to the device may still read their pinned
        # buffers, each with the event after its copy.
        self._chunks_in_copy: List[Tuple[torch.cuda.Event, ScoreChunk]] = []
        try:
            if config.use_async:
                # The JAX Trainer's choice: the service for the device
                # backend, tenants or an armed SLO; else the fleet.
                use_service = (config.scorer_backend == "device"
                               or config.scorer_tenants > 1
                               or config.slo_score_staleness_max > 0
                               or config.scorer_queue_highwater > 0)
                in_use = None
                if use_service and config.scorer_backend == "device" and \
                        self.device.type == "cuda":
                    # A collective of every rank, before the scorers are built.
                    in_use = cards_in_use(self.device)
                # One scorer a model group, on its first rank (every rank
                # without a second axis).
                scored = self.state.model if scorer_model is None else scorer_model
                if use_service and self._leads:
                    self._scorer_fleet = ScorerService(
                        self.dataset, scored, config, self.device, faults=self._faults,
                        journal=self._journal, tracer=self.tracer, in_use=in_use)
                elif self._leads:
                    self._scorer_fleet = ScorerFleet(self.dataset, scored, config,
                                                     self.device, faults=self._faults,
                                                     tracer=self.tracer)
                self._snapshot(self.state.step)
                if self.supervisor is not None:
                    # Past its budget the ladder takes over: the table can be
                    # refreshed on this thread, frozen or flattened, and
                    # training goes on either way.
                    if self._scorer_fleet is not None:
                        self.supervisor.register_unit(
                            "scorer_service" if use_service else "scorer",
                            alive=lambda: self._scorer_fleet.alive(),
                            restart=lambda: self._scorer_fleet.restart_workers(),
                            escalates=True, cause=lambda: self._scorer_fleet.death_event())
                    self.supervisor.set_ladder(probe=self._probe_scoring,
                                               revive=self._revive_scorer)
                    if use_service and self._scorer_fleet is not None:
                        # A wedged tenant or an undrained queue walks the
                        # ladder as a death does.
                        self.supervisor.register_slo(
                            "scorer_service",
                            lambda: self._scorer_fleet.slo_status(self.state.step))
            # Crash or preemption recovery: the newest checkpoint, sampler
            # state included; the first fit() then runs on to the original
            # total_steps.
            self._auto_resumed = False
            if (config.auto_resume and config.checkpoint_dir
                    and checkpoint.latest_step(config.checkpoint_dir) is not None):
                self._auto_resume()
                self._auto_resumed = True
            # The status server (obs/serve.py) on rank 0, started last, when
            # every callback's target exists.
            self._status_server: Optional[StatusServer] = None
            if config.serve_port > 0 and self._is_rank0:
                self._status_server = StatusServer(
                    config.serve_port, health_fn=self._serve_health,
                    status_fn=self._serve_status, metrics_fn=self.logger.latest_record)
        except BaseException:
            self.close()
            raise

    def _serve_health(self) -> Dict[str, Any]:
        """``/healthz``'s body: the step and the ladder's level, from host
        numbers (the serving thread never reads the card)."""
        body: Dict[str, Any] = {"step": self.state.step}
        if self.supervisor is not None:
            s = self.supervisor.summary()
            body["level"] = s["level"]
            body["level_name"] = s["level_name"]
            body["units_down"] = sum(1 for u in s["units"] if u["down"])
        return body

    def _serve_status(self) -> Dict[str, Any]:
        """``/statusz``'s body: the manifest, the supervisor's summary, the
        scorer's and the journal's tail and counts. ``state_schema_sha`` is
        None: the port has no state-schema file, as the JAX Trainer reports
        when its file is absent."""
        doc: Dict[str, Any] = {"step": self.state.step}
        if self.config.log_dir:
            try:
                with open(os.path.join(self.config.log_dir, "run_manifest.json")) as f:
                    doc["manifest"] = json.load(f)
            except Exception:
                pass
        if self.supervisor is not None:
            doc["supervisor"] = self.supervisor.summary()
        fleet = getattr(self, "_scorer_fleet", None)
        if fleet is not None:
            try:
                doc["scorer"] = fleet.summary()
            except Exception:
                pass
        if self._journal is not None:
            doc["events"] = self._journal.tail()
            doc["event_counts"] = self._journal.counts()
        doc["state_schema_sha"] = None
        return doc

    def train_step(self, draws: Optional[Draws] = None,
                   use_kernels: bool = True) -> Dict[str, torch.Tensor]:
        """One step; metrics stay on the device. Under host_stream ``draws``
        are those of step t+depth, whose selection the step draws. Under
        async refresh the fleet's ready chunks are applied after it."""
        if self._stream_pipe is not None:
            metrics = self._host_stream_step(draws, use_kernels)
        else:
            t0 = time.perf_counter()
            with self.tracer.span("trainer/dispatch", cat="trainer"):
                metrics = self._step_fn(self.state, draws, use_kernels)
            self._dispatch_s += time.perf_counter() - t0
        if self._async:
            self._refresh_tick(self.state.step)
        return metrics

    def train_chunk(self, draws: Optional[List[Draws]] = None,
                    use_kernels: bool = True) -> Dict[str, torch.Tensor]:
        """``scan_steps`` steps in one call (``draws``, when given, one a
        step); every metric ``[scan_steps, ...]``, on the device. Under
        async refresh the fleet's ready chunks are applied once, after the
        last step."""
        if self._chunk_fn is None:
            raise ValueError("train_chunk needs TrainConfig.scan_steps > 1")
        t0 = time.perf_counter()
        with self.tracer.span("trainer/dispatch", cat="trainer", steps=self.scan_steps):
            metrics = self._chunk_fn(self.state, draws, use_kernels)
        self._dispatch_s += time.perf_counter() - t0
        if self._async:
            self._refresh_tick(self.state.step, advanced=self.scan_steps)
        return metrics

    def _apply_chunks(self, chunks: List[ScoreChunk], step: int) -> None:
        """Scatter the fleet's chunks into the table, each at its age's
        weight ``float32(table_decay**age)``. A chunk with a non-finite
        score is rejected, counted and leaves the table as it was. The
        chunks are pinned host tensors: their copies to the device do not
        wait for the step in flight, and each stays referenced until the
        event after its copy has passed."""
        cuda = self.device.type == "cuda"
        self._chunks_in_copy = [(e, c) for e, c in self._chunks_in_copy if not e.query()]
        for chunk in chunks:
            if not bool(torch.isfinite(chunk.scores).all()):
                self._chunks_rejected += 1
                _log.warning("rejected a non-finite score chunk (snapshot step %d) at "
                             "step %d: table untouched", chunk.step, step)
                continue
            age = max(step - chunk.step, 0)
            table = self.state.scoretable
            self.state.scoretable = table._replace(scores=apply_async_chunk(
                table.scores, chunk.slots.to(self.device, non_blocking=True),
                chunk.scores.to(self.device, non_blocking=True), self.state.ema.value,
                self.config.table_decay ** age))
            if cuda:
                copied = torch.cuda.Event()
                copied.record()
                self._chunks_in_copy.append((copied, chunk))
            if self._scorer_fleet is not None:
                self._scorer_fleet.note_applied(age)

    def _snapshot(self, step: int) -> None:
        """The scorer's snapshot of the parameters at ``step``. Under a
        second mesh axis it is of the whole model, gathered over the model
        group (every rank of the group calls this), for the scorer on the
        group's first rank."""
        model = self.state.model
        source = model if self.mesh.model is None else full_state_dict(model)
        if self._scorer_fleet is not None:
            self._scorer_fleet.snapshot(source, step)

    def _shared_chunks(self, take) -> Optional[List[ScoreChunk]]:
        """The chunks ``take()`` returns on the rank that holds the scorer
        (None: none this tick, and no snapshot). Under a second mesh axis
        the model group's first rank runs ``take`` and broadcasts what it
        got to the group — a status and a count, then each chunk's slots,
        scores and snapshot step — so every rank of the group applies the
        same chunks at the same step; an exception of ``take`` raises on
        every rank of the group."""
        model = self.mesh.model
        if model is None:
            return take()
        group = model.group
        if self._scorer_fleet is not None:
            try:
                chunks = take()
            except BaseException:
                broadcast_from_first([_CHUNKS_FAILED, 0], torch.int64, group)
                raise
            broadcast_from_first([_CHUNKS_NONE if chunks is None else _CHUNKS_TAKEN,
                                  len(chunks or ())], torch.int64, group)
            if chunks:
                broadcast_from_first([v for c in chunks for v in (
                    *c.slots.tolist(), *c.scores.tolist(), c.step)], torch.float64, group)
            return chunks
        status, n = broadcast_from_first([0, 0], torch.int64, group)
        if status == _CHUNKS_FAILED:
            raise RuntimeError("the scorer of this rank's model group failed on the "
                               "group's first rank")
        if status == _CHUNKS_NONE:
            return None
        if n == 0:
            return []
        r = int(self.config.refresh_size)
        rows = torch.tensor(broadcast_from_first([0.0] * (n * (2 * r + 1)), torch.float64,
                                                 group), dtype=torch.float64).view(n, 2 * r + 1)
        return [ScoreChunk(slots=row[:r].to(torch.int64), scores=row[r:2 * r].to(torch.float32),
                           step=int(row[2 * r])) for row in rows]

    def _async_refresh_tick(self, step: int, advanced: int = 1) -> None:
        """After a step under async refresh: apply the ready chunks, and
        snapshot the parameters when the step crossed a multiple of
        ``snapshot_every``. Host numbers only: no device sync (under a
        second axis, one small broadcast over the model group, and the
        snapshot's gather)."""
        fleet = self._scorer_fleet

        def take() -> Optional[List[ScoreChunk]]:
            if self.supervisor is not None and not fleet.alive():
                # A worker died: the supervisor's tick restarts it or walks
                # the ladder (drain would raise); the queued chunks wait.
                return None
            # The service's drain also advances every tenant's staleness and
            # empties the other tenants' queues into their accounting.
            return (fleet.drain_for_step(step) if isinstance(fleet, ScorerService)
                    else fleet.drain())

        chunks = self._shared_chunks(take)
        if chunks is None:
            return
        if chunks:
            with self.tracer.span("trainer/apply_refresh", cat="trainer", chunks=len(chunks)):
                self._apply_chunks(chunks, step)
        every = self.config.snapshot_every
        if step // every > (step - advanced) // every:
            self._snapshot(step)

    def _sync_refresh_tick(self, step: int, advanced: int = 1) -> None:
        """Ladder level 1: the training thread scores one window every
        ``supervisor_sync_every`` steps against a snapshot taken now (no
        worker thread); a failure descends one level, with the fault that
        caused it as the parent."""
        fleet = self._scorer_fleet
        every = max(int(self.config.supervisor_sync_every), 1)
        if step // every <= (step - advanced) // every:
            return
        try:
            with self.tracer.span("trainer/sync_refresh", cat="trainer"):
                self._snapshot(step)
                chunks = self._shared_chunks(lambda: [fleet.score_once()])
        except Exception as exc:
            self.supervisor.report_failure("sync refresh", step, exc,
                                           parent=getattr(exc, "event_id", None))
            return
        self._apply_chunks(chunks, step)

    def _refresh_tick(self, step: int, advanced: int = 1) -> None:
        """After each step under async refresh, by the ladder's level: 0
        drains the scorer, 1 scores on this thread, 2 does nothing (the
        step's decay flattens the table toward the EMA mean), 3 zeroes the
        table in place on the step's stream after every step (no sync, no
        copy), so the next draw is uniform: the step's write-back rescores
        the slots it trained, and a one-time flatten would let them tilt
        the draws again."""
        sup = self.supervisor
        level = 0 if sup is None else sup.level()
        if level > 0 and self._actuated_level == 0:
            # Out of async: the trainer drains no lockstep chunk from here,
            # so no snapshot may wait at its barrier (every rank leaves at
            # this step: the level is agreed).
            release = getattr(self._scorer_fleet, "release_lockstep", None)
            if release is not None:
                release()
        if level == 0:
            self._async_refresh_tick(step, advanced)
        elif level == 1:
            self._sync_refresh_tick(step, advanced)
        if sup is None:
            return
        if level >= 3:
            self.state.scoretable.scores.zero_()
            if self._actuated_level < 3:
                _log.warning("sampler degraded to UNIFORM at step %d: score table "
                             "flattened (sampler/is_active=0)", step)
        # A climb below uniform needs no undoing: the resumed refresh and
        # the step's write-backs repaint the flattened table.
        self._actuated_level = level

    def _probe_scoring(self) -> None:
        """The supervisor's probe: one round scored on this thread against
        the parameters now and applied; raises on a failure or a
        non-finite score (the chunk's pinned host scores: no device
        sync)."""
        fleet = self._scorer_fleet
        if not self._async:
            raise RuntimeError("no scorer fleet to probe")
        step = self.state.step
        self._snapshot(step)

        def take() -> List[ScoreChunk]:
            if self._revive_due:
                fleet.restart_workers()
            chunk = fleet.score_once()
            if not bool(torch.isfinite(chunk.scores).all()):
                raise RuntimeError("probe chunk contains non-finite scores")
            return [chunk]

        try:
            chunks = self._shared_chunks(take)
        finally:
            self._revive_due = False
        self._apply_chunks(chunks, step)

    def _revive_scorer(self) -> None:
        """The ladder's revival before the climb to async: the probe that
        follows restarts the scorer's workers, after its snapshot (so they
        start from it) and, under a second mesh axis, on the group's first
        rank, where a failure reaches every rank of the group (through
        :meth:`_shared_chunks`)."""
        self._revive_due = True

    def scorer_stats(self) -> Dict[str, float]:
        """The scorer's ``stats()`` since the previous call and the count
        of rejected chunks (none without async refresh)."""
        if self._scorer_fleet is None:
            return {}
        return {**self._scorer_fleet.stats(),
                "sampler/chunks_rejected": float(self._chunks_rejected)}

    def _host_stream_step(self, draws: Optional[Draws] = None,
                          use_kernels: bool = True) -> Dict[str, torch.Tensor]:
        """Pop → step → push: train on the oldest prefetched rows and hand
        the selection of step t+depth, a device tensor still being
        computed, to the pipeline. A dead worker raises here, unless the
        supervisor restarts it within its budget: the new pipeline is
        refilled from the ring, so the batch popped is the one the dead
        worker owed."""
        # The pop span is the input stall: the time the trainer waited for
        # the prefetch worker.
        with self.tracer.span("trainer/pop", cat="trainer"):
            try:
                batch = self._stream_pipe.pop()
            except RuntimeError:
                if (self.supervisor is None
                        or not self.supervisor.request_restart("prefetch", self.state.step)):
                    raise
                batch = self._stream_pipe.pop()
        t0 = time.perf_counter()
        with self.tracer.span("trainer/dispatch", cat="trainer"):
            metrics, next_gidx = self._step_fn(self.state, batch, draws, use_kernels)
        self._dispatch_s += time.perf_counter() - t0
        with self.tracer.span("trainer/push", cat="trainer"):
            self._stream_pipe.push(next_gidx)
        return metrics

    def _new_stream_pipe(self) -> PrefetchPipeline:
        cfg = self.config
        return PrefetchPipeline(
            HostStreamSource(self.dataset.x_train, cfg.decode_workers), cfg.stream_rows,
            self.device, depth=cfg.prefetch_depth, faults=self._faults,
            generation=self._stream_gen, tracer=self.tracer)

    def _restart_stream_pipe(self) -> None:
        """The supervisor's restart of the prefetch worker: close the dead
        pipeline, build a new one (``mercury-prefetch-r<N>``) and refill it
        from the state's ring, which holds the selections of steps t …
        t+depth−1 wherever the worker died: the run goes on bit-equal to an
        uninterrupted one."""
        old = self._stream_pipe
        self._stream_gen += 1
        try:
            old.close(timeout=5.0)
        except Exception as exc:
            _log.warning("dead prefetch pipeline close() raised: %s", exc)
        self._stream_pipe = self._new_stream_pipe()
        self._refill_stream_pipe()

    def _seed_stream_pipe(self, gidx: torch.Tensor) -> None:
        """Drop what the pipeline holds and push the ``[depth, S]``
        selections ``gidx`` (the ring's, in step order)."""
        self._stream_pipe.reset()
        for row in gidx:
            self._stream_pipe.push(row)

    def _refill_stream_pipe(self) -> None:
        """After a restore: the restored ring's selections are those of
        steps t … t+depth−1, so push their rows; a checkpoint without a
        ring (a replicated run's) primes the ring anew from the restored
        generator and stream, as the replicated run would draw on."""
        if self._stream_pipe is None:
            return
        with self.tracer.span("trainer/refill_stream_pipe", cat="trainer"):
            if self.state.pending is None:
                gidx = prime_host_stream(self.state, self.config, self.dataset)
            else:
                gidx = self.dataset.shard_indices[self.dataset.rank][self.state.pending.slots]
            self._seed_stream_pipe(gidx)

    def stream_stats(self) -> Dict[str, float]:
        """The prefetch pipeline's ``data/*`` counters since the previous
        call (none without host_stream)."""
        return {} if self._stream_pipe is None else self._stream_pipe.stats()

    def close(self) -> None:
        """Stop the supervisor (its poll must not read the teardown as
        deaths), the scorer fleet, the prefetch worker and a profiler
        window, then drain and close the metric writer (the others feed
        its records); last, even when a step of this raised, write
        ``supervisor_summary.json`` and close the journal. A second call
        does nothing, and a Trainer whose construction stopped partway
        closes what it built."""
        try:
            server = getattr(self, "_status_server", None)
            if server is not None:
                # Scrapers first: a request mid-teardown would read half-
                # closed parts.
                server.close()
            supervisor = getattr(self, "supervisor", None)
            if supervisor is not None:
                supervisor.close()
            fleet = getattr(self, "_scorer_fleet", None)
            if fleet is not None:
                fleet.close()
            pipe = getattr(self, "_stream_pipe", None)
            if pipe is not None:
                pipe.close()
            profiler = getattr(self, "_profiler", None)
            if profiler is not None:
                self._profile_closed(profiler.stop())
            self._export_trace()
            writer = getattr(self, "logger", None)
            if writer is not None:
                writer.close()
        finally:
            self._write_supervisor_summary()
            journal = getattr(self, "_journal", None)
            if journal is not None:
                journal.close()

    def _export_trace(self) -> None:
        """Rank 0 writes ``log_dir/trace.json``: the tracer's spans with this
        rank's event journal merged in as lanes of instants and causal
        arrows. A second call writes nothing more; never raises."""
        tracer = getattr(self, "tracer", None)
        config = getattr(self, "config", None)
        if (tracer is None or not tracer.enabled or config is None or not config.log_dir
                or not getattr(self, "_is_rank0", True)
                or getattr(self, "_trace_exported", False)):
            return
        self._trace_exported = True
        try:
            events = []
            journal = getattr(self, "_journal", None)
            if journal is not None:
                journal.flush()
                events = read_journal(os.path.join(config.log_dir,
                                                   journal_filename(self.rank)))
            tracer.export_chrome_trace(os.path.join(config.log_dir, "trace.json"),
                                       events=events or None)
        except Exception as exc:
            _log.warning("trace export failed: %s", exc)

    def _profile_closed(self, path: Optional[str]) -> None:
        """After a profiler window closed with ``path`` (None: none was
        open, or it failed): a ``profiler/stop`` instant and, on rank 0,
        its device-time attribution (``obs/profile_parse.py``) written to
        ``log_dir/device_time_breakdown.json`` and logged as ``prof/*``.
        Never raises."""
        if path is None:
            return
        self.tracer.instant("profiler/stop", cat="trainer")
        if not self._is_rank0:
            return
        try:
            breakdown = parse_profile(path)
            out_dir = self.config.log_dir or self.config.anomaly_dir
            write_breakdown(breakdown, os.path.join(out_dir, "device_time_breakdown.json"))
            if breakdown["total_device_time_us"] > 0:
                self.logger.write(self.state.step, scope_frac_metrics(breakdown))
            _log.warning("device-time breakdown written: %.1f%% attributed to named scopes",
                         100.0 * (1.0 - breakdown["scopes"].get("unattributed", {})
                                  .get("frac", 0.0)))
        except Exception as exc:
            _log.warning("profile fold-back failed: %s: %s", type(exc).__name__, exc)

    def _write_supervisor_summary(self) -> None:
        """``supervisor_summary.json`` in ``log_dir`` on rank 0: the
        ladder's transitions, the budgets and the SLO latches. Never
        raises."""
        supervisor = getattr(self, "supervisor", None)
        config = getattr(self, "config", None)
        if (supervisor is None or config is None or not config.log_dir
                or not getattr(self, "_is_rank0", True)):
            return
        try:
            path = os.path.join(config.log_dir, "supervisor_summary.json")
            tmp = path + ".tmp"
            with open(tmp, "w") as f:
                json.dump(supervisor.summary(), f, indent=2, default=str)
                f.write("\n")
            os.replace(tmp, path)
        except Exception as exc:
            _log.warning("supervisor summary write failed: %s", exc)

    def _flight_context(self) -> Dict[str, Any]:
        """A flight record's run context (called only when one is
        written): the config, the manifest and the summaries of the
        pipeline, the scorer, the supervisor and the fault plane."""
        ctx: Dict[str, Any] = {"config": dataclasses.asdict(self.config),
                               "manifest": build_run_manifest(self.config, self.device)}
        for key, attr in (("pipeline", "_stream_pipe"), ("scorer_fleet", "_scorer_fleet"),
                          ("supervisor", "supervisor"), ("faults", "_faults")):
            part = getattr(self, attr, None)
            if part is not None:
                ctx[key] = part.summary()
        return ctx

    def __enter__(self) -> "Trainer":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def fit(self, num_epochs: Optional[int] = None, *,
            steps: Optional[int] = None) -> Dict[str, float]:
        """Train ``num_epochs`` (default ``config.num_epochs``) epochs of
        ``steps_per_epoch`` steps from the current step, as the JAX
        package's ``fit`` does: the first call after an actual
        ``auto_resume`` runs to the absolute end of the schedule instead,
        and every call stops after the first step at which
        ``step × world_size`` exceeds ``step_budget``. ``steps=k`` runs
        ``k`` steps from here (under the same budget).

        Writes a record to ``self.logger`` every ``log_every`` steps,
        evaluates every ``eval_every`` (also logged, and printed) and, with
        a ``checkpoint_dir``, saves every ``checkpoint_every`` steps and at
        the end (under ``async_checkpoint`` the cadence saves on a writer
        thread, one at a time; every write is joined before ``fit``
        returns or raises, and a failed one raises here). With
        ``scan_steps=K`` it runs a chunk of K steps while one fits before
        the end and single steps for the tail; a tick fires when a call
        crossed a multiple of its cadence, and a chunk's record holds the
        chunk's means. Returns the
        final evaluation (the last eval tick's, else a fresh
        :meth:`evaluate`), the last step's scalar metrics and, when
        the last step is a log tick, the sampler-health keys and (under
        host_stream) the pipeline's ``data/*`` counters and (under async
        refresh) the fleet's."""
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
        k = 1  # the steps of the last call
        self._throughput.reset(start)
        self.tracer.register_thread("train")

        def crossed(every: int, at: int, advanced: int) -> bool:
            """Did ``[at - advanced, at]`` cross a multiple of ``every``?"""
            return bool(every) and (at // every) > ((at - advanced) // every)

        try:
            while self.state.step < end:
                # The iteration's wall time: under asynchronous launches it
                # settles to the device's pace once the queue is full.
                t_iter = time.perf_counter()
                dispatch_before = self._dispatch_s
                if self._faults is not None:
                    # The clock the hook sites fire against, and the
                    # training thread's own hook.
                    self._faults.note_step(self.state.step)
                    slow = self._faults.fire("host_slow")
                    if slow is not None:
                        time.sleep(float(slow.get("secs", 1.0)))
                if self._chunk_fn is not None and self.state.step + self.scan_steps <= end:
                    k = self.scan_steps
                    metrics = self.train_chunk()
                else:
                    k = 1
                    metrics = self.train_step()
                step = self.state.step
                if self.supervisor is not None:
                    # Liveness, restarts, SLOs and probes: host work only,
                    # once a call.
                    self.supervisor.tick(step)
                dt_iter = time.perf_counter() - t_iter
                self._host_s += dt_iter - (self._dispatch_s - dispatch_before)
                self._host_steps += k
                if self.anomaly is not None:
                    self.anomaly.observe_step_time(step, dt_iter, steps=k)
                # A trigger's profiler window opens here, so the next
                # occurrence of a sporadic anomaly lands inside it.
                if self._profiler.active:
                    self._profile_closed(self._profiler.advance(k))
                elif self.anomaly is not None:
                    want = self.anomaly.take_profile_request()
                    if want > 0 and self._profiler.start(want, step):
                        self.tracer.instant("profiler/start", cat="trainer", steps=want)
                health = {}
                if crossed(cfg.log_every, step, k):
                    with self.tracer.span("trainer/log_gate", cat="trainer", step=step):
                        health = self._log_tick(step, metrics, k)
                if crossed(cfg.eval_every, step, k):
                    with self.tracer.span("trainer/eval", cat="trainer", step=step):
                        evaluation = self.evaluate()
                    self.logger.log_scalars(step, evaluation)
                    print(f"  eval @ {step}: "
                          + " ".join(f"{k}={v:.4f}" for k, v in evaluation.items()))
                if cfg.checkpoint_dir and crossed(cfg.checkpoint_every, step, k):
                    with self.tracer.span("trainer/checkpoint", cat="trainer", step=step):
                        if cfg.async_checkpoint:
                            self._join_checkpoint()
                            self._ckpt_thread = checkpoint.save_checkpoint_async(
                                cfg.checkpoint_dir, self.state, cfg,
                                failure_cb=self._ckpt_failure_cb, **self._ckpt_kwargs())
                        else:
                            self.save()
                    saved = step
            self._join_checkpoint()
            if cfg.checkpoint_dir and saved != self.state.step:
                self.save()
            if not evaluation:
                evaluation = self.evaluate()
            return {**evaluation, **_scalars(metrics, k), **health}
        finally:
            # No write stays in flight past fit: a relaunch must not find
            # a file half written.
            self._join_checkpoint()
            self.logger.flush()

    def _join_checkpoint(self) -> None:
        """Wait for the async write in flight, if any; raise its error."""
        thread, self._ckpt_thread = self._ckpt_thread, None
        if thread is not None:
            thread.join()

    def _ckpt_failure_cb(self, exc: BaseException) -> None:
        """On the writer thread, when an async write has failed: a warning
        and a flight record now (``fit`` raises the error at the next
        join). Never raises."""
        _log.warning("async checkpoint write failed (%s: %s); %d failed attempts so far",
                     type(exc).__name__, exc, checkpoint.write_failures())
        if self.anomaly is not None:
            self.anomaly.dump_flight_record(
                "checkpoint_write_failed", self.state.step,
                {"error": f"{type(exc).__name__}: {exc}",
                 "write_failures": checkpoint.write_failures()})

    def _ckpt_kwargs(self) -> Dict[str, Any]:
        """The durability settings of every save."""
        cfg = self.config
        return dict(keep=cfg.checkpoint_keep, retries=cfg.checkpoint_write_retries,
                    retry_backoff_s=cfg.checkpoint_retry_backoff_s,
                    manifest=cfg.checkpoint_manifest, faults=self._faults,
                    journal=self._journal)

    def _log_tick(self, step: int, metrics: Dict[str, torch.Tensor],
                  steps: int = 1) -> Dict[str, float]:
        """Enqueue the record of a log tick, as the JAX ``fit`` assembles
        it: the step's scalar metrics (device tensors, copied by the drain
        thread; after a chunk of ``steps`` the ``[steps]`` series, which
        the drain thread reduces to their means), the throughput since the
        previous tick, the pipeline's,
        the scorer's and the sampler monitor's keys, the thread census and
        the epoch. The monitor's gather (a collective at W>1) runs here, on
        the training thread; nothing else reads the card. Returns the
        sampler-health, stream and scorer keys for ``fit``'s result."""
        if not self._flops_known:
            self._throughput.flops_per_step = flops_per_step(self)
            self._flops_known = True
        record: Dict = {k: v for k, v in metrics.items() if _is_scalar(v, steps)}
        record.update(self._throughput.tick(step))
        stream, scorer = self.stream_stats(), self.scorer_stats()
        health = self.sampler_health()
        record.update(stream)
        record.update(scorer)
        record.update(health)
        record.update(host_thread_stats())
        if self._faults is not None:
            record.update(self._faults.stats())
        if self.supervisor is not None:
            # The ladder's level, restarts and descents, sampler/is_active.
            record.update(self.supervisor.stats())
        if self.config.checkpoint_dir:
            record["checkpoint/write_failures"] = float(checkpoint.write_failures())
        record["threads/queue_depth/metrics"] = float(self.logger.queue_depth())
        record["epoch"] = (step - 1) // self.steps_per_epoch
        if self._host_steps:
            # The training thread's seconds a step outside the dispatch since
            # the last tick: fault sleeps, the refresh, the supervisor, the
            # previous tick. A rank's peers wait for it inside their steps.
            record["time/host_s"] = self._host_s / self._host_steps
            self._host_s, self._host_steps = 0.0, 0
        if self._crosshost_gather is not None:
            # Every rank gathers (the tick is the same step on each); rank 0
            # gets the merge back.
            record.update(self._crosshost_gather.update(record))
        inject = self.config.anomaly_inject_nan_step
        if inject and not self._nan_injected and step >= inject:
            # For tests: the host record's loss, never the step, turns NaN,
            # so the non_finite trigger runs end to end.
            record["train/loss"] = float("nan")
            self._nan_injected = True
        self.logger.write(step, record)
        return {**health, **stream, **scorer}

    def sampler_health(self) -> Dict[str, float]:
        """The sampler-health monitor's keys of the ledger so far (none
        without a ledger). At W>1 every rank must call it at the same step:
        rank 0 gathers the rows and returns the keys of the ``[W, L]``
        ledger, the other ranks return none."""
        if self.sampler_monitor is None:
            return {}
        st = self.state
        rows = gather_to_rank0(tuple(t.cpu().numpy() for t in (
            st.sel_counts, st.scoretable.scores, st.ema.value)), self.mesh.data_group)
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
        ``checkpoint_dir``) as ``ckpt_<step>.pt`` with the config's
        durability settings (manifest, retries, the fault plane), keeping
        the newest ``checkpoint_keep``; return its path. At W>1 every rank
        calls it."""
        return checkpoint.save_checkpoint(self._directory(directory), self.state,
                                          self.config, **self._ckpt_kwargs())

    def restore(self, directory: Optional[str] = None, step: Optional[int] = None) -> int:
        """Restore the checkpoint at ``step`` (default: the newest that
        loads and, under ``checkpoint_verify``, verifies; at W>1 agreed
        across the ranks) from ``directory`` (default ``checkpoint_dir``);
        return its step. Under host_stream the prefetch pipeline is
        refilled from the restored ring; under async refresh the fleet's
        queued chunks are dropped and the restored parameters
        snapshotted."""
        step = checkpoint.restore_checkpoint(self._directory(directory), self.state,
                                             self.config, step,
                                             verify=self.config.checkpoint_verify,
                                             journal=self._journal)
        self._after_restore()
        return step

    def restore_elastic(self, directory: Optional[str] = None, step: Optional[int] = None,
                        raw: Optional[Dict[str, Any]] = None) -> int:
        """Restore a checkpoint saved at another world size (or the same):
        the model, the optimizer (ZeRO's chunks resharded) and the counters
        exactly, the EMA from the old ranks', the score table, ledger and
        cursors carried under ``stream_checkpoint_cursor``, the generator
        re-seeded from the restored step (``train/elastic.py``); ``raw`` is
        a payload already read at ``step``. Every rank calls it. Under
        host_stream the ring is primed anew for the new shards. Under
        tensor_parallel or fsdp_parallel each rank loads its slices of the
        whole model and moments, and the file's rows are data workers."""
        step = elastic.elastic_restore(self._directory(directory), self, step, raw=raw)
        self._after_restore()
        return step

    def _after_restore(self) -> None:
        self._refill_stream_pipe()
        if self._async:
            if self._scorer_fleet is not None:
                self._scorer_fleet.reset()
            self._snapshot(self.state.step)

    def _auto_resume(self) -> None:
        """The newest checkpoint's world size decides between
        :meth:`restore` and :meth:`restore_elastic`; at W>1 rank 0's
        reading decides for every rank."""
        cfg = self.config
        raw, raw_step = elastic.probe_checkpoint(cfg.checkpoint_dir)
        w_ckpt = elastic.world_size_of_raw(raw)
        if self.mesh.world_size * self.mesh.second > 1:
            agreed = torch.tensor([-1 if w_ckpt is None else w_ckpt,
                                   -1 if raw_step is None else raw_step],
                                  dtype=torch.int64, device=host_flag_device())
            dist.broadcast(agreed, src=0)
            w0, s0 = (int(v) for v in agreed.tolist())
            if s0 != raw_step:
                raw = None  # this rank read another file: it reads rank 0's
            w_ckpt, raw_step = (None if w0 < 0 else w0), (None if s0 < 0 else s0)
        if w_ckpt is not None and w_ckpt != cfg.world_size:
            step = self.restore_elastic(step=raw_step, raw=raw)
            _log.info("auto-resumed elastically from a %d-rank checkpoint at step %d "
                      "(now %d ranks)", w_ckpt, step, cfg.world_size)
        else:
            # The fall-back walk reads (and verifies) the files itself.
            del raw
            step = self.restore()
            _log.info("auto-resumed from the checkpoint at step %d", step)

    def _logits(self, raw: torch.Tensor) -> torch.Tensor:
        """Inference-mode logits of ``EVAL_BATCH`` raw NHWC images (or
        ``[B, T, F]`` sequences) on this device, normalized with the
        dataset's statistics (``/255`` for uint8 only) and, under
        ``augmentation="iid"``, resized to 33 and cropped at ``eval_crop``;
        under the step's autocast."""
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
        images (uint8 or float) or ``[N, T, F]`` sequences (a numpy array or
        a tensor; a single ``[H, W, C]`` image or ``[T, F]`` sequence is one
        of one), normalized as ``evaluate`` does, in its batches of
        ``EVAL_BATCH`` (the last padded by wrapping, as there)."""
        x = inputs if isinstance(inputs, np.ndarray) else torch.as_tensor(inputs)
        if x.ndim == self.dataset.x_test.dim() - 1:
            x = x[None]
        n = int(x.shape[0])
        out = torch.empty((n, self.dataset.num_classes), dtype=torch.float32)
        for idx_np, valid in eval_batches(n, EVAL_BATCH):
            logits = self._logits(_rows(x, idx_np))
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
            mask = torch.as_tensor(np.arange(EVAL_BATCH) < valid,
                                   device=self.device)
            labels = _rows(y, idx_np).to(self.device)
            logits = self._logits(_rows(x, idx_np))
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


def _on_group(collective, group):
    """``collective`` over ``group``: itself on the default group (None)."""
    return collective if group is None else functools.partial(collective, group=group)


def _rows(x, idx_np: np.ndarray) -> torch.Tensor:
    """Rows ``idx_np`` of a tensor (on its device) or of a host array (the
    host_stream train pixels, read on the host)."""
    if isinstance(x, np.ndarray):
        return torch.from_numpy(np.ascontiguousarray(x[idx_np]))
    return x[torch.as_tensor(idx_np, device=x.device)]


def _is_scalar(value: torch.Tensor, steps: int) -> bool:
    """A scalar metric of one step, or its ``[steps]`` series of a chunk."""
    return value.numel() == 1 if steps == 1 else tuple(value.shape) == (steps,)


def _scalars(metrics: Dict[str, torch.Tensor], steps: int = 1) -> Dict[str, float]:
    """The last step's scalar metrics as floats."""
    return {k: float(v.reshape(-1)[-1]) for k, v in metrics.items() if _is_scalar(v, steps)}
