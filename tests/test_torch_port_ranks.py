"""Rank bodies of the port's two-rank CPU tests (``test_torch_port_parallel``,
``test_torch_port_dist_step``, ``test_torch_port_checkpoint``,
``test_torch_port_telemetry_step``, ``test_torch_port_sampler_modes``,
``test_torch_port_grad_path``, ``test_torch_port_scorer_service_dist``,
``test_torch_port_elastic``, ``test_torch_port_durable_checkpoint``,
``test_torch_port_aggregate``, ``test_torch_port_supervisor``,
``test_torch_port_sequence_step``, ``test_torch_port_mesh``,
``test_torch_port_fsdp``, ``test_torch_port_int8_flat``,
``test_torch_port_sp_attention``, ``test_torch_port_sp_step``,
``test_torch_port_sp_train_step``, ``test_torch_port_pipeline``,
``test_torch_port_pp_step``, ``test_torch_port_pp_moe``,
``test_torch_port_ep``, ``test_torch_port_pp_2d`` and
``test_torch_port_pp_2d_step``); this file holds no tests.

``mercury_tpu_torch.parallel.distributed.spawn`` runs each body in a
process of its own, one a rank, in a gloo process group, and pickles the
body by its import path. So the bodies live at module level in a module
that imports torch and the port only, not JAX: a rank then starts in a
couple of seconds. Every input arrives as an argument, made with numpy
(and the JAX package) by the test process; every result goes back as CPU
tensors and numbers.
"""

from __future__ import annotations

import contextlib
import threading

import torch
import torch.distributed as dist

from mercury_tpu_torch import TrainConfig, Trainer
from mercury_tpu_torch.data.pipeline import ShardStream, make_sharded_dataset
from mercury_tpu_torch.models import create_model
from mercury_tpu_torch.models.convert import scoretable_from_jax
from mercury_tpu_torch.models.resnet import (
    BasicBlock,
    BatchNorm,
    ResNet,
    init_weights,
    set_sync_batch_norm,
)
from mercury_tpu_torch.obs.aggregate import CrossHostGatherAggregator
from mercury_tpu_torch.parallel import collectives
from mercury_tpu_torch.parallel.distributed import cards_in_use
from mercury_tpu_torch.sampling import scorer_fleet
from mercury_tpu_torch.sampling.scorer_service import ScorerService
from mercury_tpu_torch.sampling.importance import EMAState
from mercury_tpu_torch.train.state import create_state
from mercury_tpu_torch.train.step import make_train_step


def group_ranks(group) -> tuple:
    """The global ranks of ``group`` (None: the default group's; ``(0,)``
    without a process group)."""
    if group is None:
        return tuple(range(collectives.world()))
    return tuple(dist.get_process_group_ranks(group))


@contextlib.contextmanager
def counting_all_reduces(groups: bool = False):
    """Count the ``torch.distributed.all_reduce`` calls made inside: each
    call's shape, or with ``groups`` its ``(shape, ranks of its group)``."""
    with counting_collectives(("all_reduce",), groups) as calls:
        yield calls


@contextlib.contextmanager
def counting_collectives(kinds=("all_reduce", "all_gather_into_tensor",
                                "reduce_scatter_tensor", "all_to_all_single"),
                         groups: bool = True):
    """Record the ``torch.distributed`` collectives of ``kinds`` made
    inside: with ``groups`` each as ``(kind, shape, ranks of its group,
    dtype)`` (``all_reduce`` alone as ``(shape, ranks)``), else its input's
    shape."""
    calls = []
    originals = {kind: getattr(dist, kind) for kind in kinds}

    def counter(kind):
        def counted(*args, **kwargs):
            # all_reduce(tensor, ...) and the gathers' (output, input, ...):
            # record the tensor sent.
            tensor = args[0] if kind == "all_reduce" else args[1]
            shape = tuple(tensor.shape)
            if groups:
                group = kwargs.get("group")
                entry = (shape, group_ranks(group))
                calls.append(entry if kinds == ("all_reduce",)
                             else (kind, *entry, tensor.dtype))
            else:
                calls.append(shape)
            return originals[kind](*args, **kwargs)
        return counted

    for kind in kinds:
        setattr(dist, kind, counter(kind))
    try:
        yield calls
    finally:
        for kind, fn in originals.items():
            setattr(dist, kind, fn)


@contextlib.contextmanager
def one_thread():
    """Torch on one thread inside, as every spawned rank runs: the CPU
    kernels' reductions then take the ranks' order."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


def tiny_resnet(seed=None, width: int = 8) -> ResNet:
    """The tests' [1, 1]-stage ResNet of width 8 (6 BN layers), or of
    ``width``."""
    model = ResNet([1, 1], BasicBlock, num_classes=10, num_filters=width)
    if seed is not None:
        init_weights(model, torch.Generator().manual_seed(seed))
    return model


def collectives_rank(tensors, dtypes, pair, x):
    """``allreduce_mean_`` on this rank's ``tensors[rank]`` (numpy arrays,
    cast to ``dtypes``), ``psum_stats`` on ``pair[rank]``, and
    ``all_reduce_mean`` of ``x[rank]`` with the gradient of ``Σ c·y`` for
    ``c = rank + 1``, with the all-reduces each made."""
    torch.set_num_threads(1)
    r = dist.get_rank()
    ts = [torch.tensor(a).to(getattr(torch, d)) for a, d in zip(tensors[r], dtypes)]
    with counting_all_reduces() as mean_calls:
        collectives.allreduce_mean_(ts)
    with counting_all_reduces() as stat_calls:
        total, count = collectives.psum_stats(torch.tensor(pair[r][0]),
                                              torch.tensor(pair[r][1]))
    xt = torch.tensor(x[r], requires_grad=True)
    with counting_all_reduces() as grad_calls:
        y = collectives.all_reduce_mean(xt)
        (y * (r + 1.0)).sum().backward()
    return dict(means=[t.float() for t in ts], dtypes=[str(t.dtype) for t in ts],
                mean_calls=mean_calls, total=float(total), count=float(count),
                stat_calls=stat_calls, y=y.detach(), x_grad=xt.grad,
                grad_calls=grad_calls)


def batch_norm_rank(x_nchw, cotangent, weight, bias, bf16):
    """A synced ``BatchNorm`` (train mode, running statistics kept) on this
    rank's ``x_nchw[rank]``, and the gradients of ``Σ y·cotangent[rank]``
    for the input, the weight and the bias."""
    torch.set_num_threads(1)
    r = dist.get_rank()
    bn = BatchNorm(x_nchw.shape[2], sync=True)
    with torch.no_grad():
        bn.weight.copy_(torch.tensor(weight))
        bn.bias.copy_(torch.tensor(bias))
    x = torch.tensor(x_nchw[r])
    if bf16:
        x = x.to(torch.bfloat16)
    x.requires_grad_()
    with counting_all_reduces() as calls:
        y = bn(x, train=True, keep_stats=True)
        (y.float() * torch.tensor(cotangent[r])).sum().backward()
    return dict(y=y.detach().float(), y_dtype=str(y.dtype), x_grad=x.grad.float(),
                weight_grad=bn.weight.grad, bias_grad=bn.bias.grad,
                running_mean=bn.running_mean.clone(), running_var=bn.running_var.clone(),
                calls=calls)


def step_rank(jobs):
    """One port step at W ranks for each job, from the JAX worker's state
    and draws: ``job = (config, state_dict, data, ranks, steps)`` with
    ``data = (x, y, xt, yt, shards, mean, std)`` and ``ranks[rank]`` this rank's
    stream permutation, EMA, score table and ``Draws``."""
    torch.set_num_threads(1)
    r = dist.get_rank()
    out = []
    for config, state_dict, data, ranks, steps in jobs:
        x, y, xt, yt, shards, mean, std = data
        mine = ranks[r]
        model = tiny_resnet()
        model.load_state_dict(state_dict)
        set_sync_batch_norm(model, config.batch_norm == "sync")
        dataset = make_sharded_dataset((x, y), (xt, yt), shards, mean, std,
                                       10, device=torch.device("cpu"), rank=r,
                                       placement=config.data_placement)
        state = create_state(model, "cpu", config.seed, dataset.shard_len, "adam",
                             config.lr, steps, with_scoretable=config.use_scoretable,
                             rank=r)
        state.stream = ShardStream(perm=torch.tensor(mine["perm"], dtype=torch.long),
                                   cursor=0)
        state.ema = EMAState(torch.tensor(mine["ema"]), torch.tensor(0, dtype=torch.int32))
        if config.use_scoretable:
            state.scoretable = scoretable_from_jax(mine["scores"], mine["cursor"])
        step_fn = make_train_step(config, dataset)
        with counting_all_reduces() as calls:
            metrics = step_fn(state, mine["draws"])
        out.append(dict(
            metrics={k: v.detach().clone() for k, v in metrics.items()},
            state_dict={k: v.detach().clone() for k, v in state.model.state_dict().items()},
            # After optimizer.step(): the gradient averaged over the ranks.
            grads={k: p.grad.detach().clone() for k, p in state.model.named_parameters()},
            ema=float(state.ema.value), ema_count=int(state.ema.count),
            table=None if state.scoretable is None else state.scoretable.scores.clone(),
            cursor=None if state.scoretable is None else state.scoretable.cursor,
            stream_cursor=state.stream.cursor, calls=calls,
            sel_counts=None if state.sel_counts is None else state.sel_counts.clone(),
            x_shard=None if dataset.x_shard is None else dataset.x_shard.clone()))
    return out


def sequence_step_rank(config, model_kw, state_dict, data, ranks, steps):
    """``steps`` port steps at W ranks of a model without batch norm
    (``create_model(config.model, ..., **model_kw)``) from the JAX
    worker's weights, stream permutation and EMA: ``data = (x, y, xt, yt,
    shards, mean, std)``, ``ranks[rank]["draws"]`` this rank's ``Draws`` of
    each step. Returns each step's metrics and all-reduce shapes, and the
    model's state and gradient after the last."""
    torch.set_num_threads(1)
    r = dist.get_rank()
    x, y, xt, yt, shards, mean, std = data
    mine = ranks[r]
    model = create_model(config.model, 10, None, tuple(x.shape[1:]), **model_kw)
    model.load_state_dict(state_dict)
    dataset = make_sharded_dataset((x, y), (xt, yt), shards, mean, std, 10,
                                   device=torch.device("cpu"), rank=r)
    state = create_state(model, "cpu", config.seed, dataset.shard_len, "adam", config.lr,
                         config.steps_per_epoch, rank=r)
    state.stream = ShardStream(perm=torch.tensor(mine["perm"], dtype=torch.long), cursor=0)
    state.ema = EMAState(torch.tensor(mine["ema"]), torch.tensor(0, dtype=torch.int32))
    step_fn = make_train_step(config, dataset)
    metrics, calls = [], []
    for draws in mine["draws"][:steps]:
        with counting_all_reduces() as step_calls:
            m = step_fn(state, draws)
        metrics.append({k: v.detach().clone() for k, v in m.items()})
        calls.append(step_calls)
    return dict(metrics=metrics, calls=calls,
                state_dict={k: v.detach().clone() for k, v in state.model.state_dict().items()},
                grads={k: p.grad.detach().clone() for k, p in state.model.named_parameters()})


def trainer_rank(config_kw, steps):
    """``Trainer`` at W ranks on the CPU with the tiny model, the same
    weights on every rank: ``steps`` steps of ``fit``, then the
    parameters, buffers, Adam state, an evaluation and the rank's first
    draws."""
    torch.set_num_threads(1)
    trainer = Trainer(TrainConfig(**config_kw), device="cpu", model=tiny_resnet(seed=0))
    first = torch.rand(4, generator=_copy_generator(trainer.state.generator))
    losses = [float(trainer.train_step()["train/loss"]) for _ in range(steps)]
    opt = trainer.state.optimizer.state_dict()["state"]
    return dict(
        rank=trainer.rank, losses=losses, first_draws=first, ema=float(trainer.state.ema.value),
        state_dict={k: v.clone() for k, v in trainer.state.model.state_dict().items()},
        adam={i: {k: v.clone() for k, v in s.items() if torch.is_tensor(v)}
              for i, s in opt.items()},
        evaluate=trainer.evaluate(),
        shard_row=trainer.dataset.shard_indices[trainer.rank].clone(),
        sync=[m.sync for m in trainer.state.model.modules() if isinstance(m, BatchNorm)])


def monitor_rank(config_kw, steps):
    """``Trainer.fit(steps=steps)`` at W ranks ending on a log tick: what it
    returned, and this rank's ledger, score table and EMA."""
    torch.set_num_threads(1)
    trainer = Trainer(TrainConfig(**config_kw), device="cpu", model=tiny_resnet(seed=0))
    out = trainer.fit(steps=steps)
    st = trainer.state
    return dict(rank=trainer.rank, out=out, sel_counts=st.sel_counts.clone(),
                scores=st.scoretable.scores.clone(), ema=st.ema.value.clone(),
                shard_indices=trainer.dataset.shard_indices.clone(),
                labels=trainer.dataset.y_train.clone())


def state_tensors(state) -> dict:
    """Everything a resumed run must carry over, as named CPU tensors: the
    model's parameters and BN buffers, the optimizer's state, the
    accumulator, the counters, the EMA, the stream, the generator's state,
    the score table and the selection-count ledger."""
    out = {f"model.{k}": v for k, v in state.model.state_dict().items()}
    for i, st in state.optimizer.state_dict()["state"].items():
        out.update({f"optimizer.{i}.{k}": v for k, v in st.items()})
    for i, acc in enumerate(state.accum or []):
        out[f"accum.{i}"] = acc
    counters = dict(step=state.step, updates=state.updates, mini_step=state.mini_step,
                    cursor=state.stream.cursor)
    out.update({k: torch.tensor(v) for k, v in counters.items()})
    out.update({"ema.value": state.ema.value, "ema.count": state.ema.count,
                "stream.perm": state.stream.perm, "generator": state.generator.get_state()})
    if state.scoretable is not None:
        out["table.scores"] = state.scoretable.scores
        out["table.cursor"] = torch.tensor(state.scoretable.cursor)
    if state.sel_counts is not None:
        out["sel_counts"] = state.sel_counts
    return {k: v.detach().cpu().clone() for k, v in out.items()}


def checkpoint_rank(config_kw, directory, before, after):
    """A ``Trainer`` at W ranks: ``before`` steps, a save into
    ``directory``, ``after`` more steps; then a fresh ``Trainer`` (other
    weights) restored from the file and the same ``after`` steps. Returns
    the states saved, restored and reached by both runs, and the files this
    rank wrote."""
    torch.set_num_threads(1)
    config = TrainConfig(**config_kw)
    live = Trainer(config, device="cpu", model=tiny_resnet(seed=0))
    for _ in range(before):
        live.train_step()
    writes = []
    save = torch.save

    def counted(obj, f, *args, **kwargs):
        if hasattr(f, "name"):  # a file; gather_object pickles to buffers
            writes.append(f.name)
        return save(obj, f, *args, **kwargs)

    torch.save = counted
    try:
        path = live.save(directory)
    finally:
        torch.save = save
    saved = state_tensors(live.state)
    for _ in range(after):
        live.train_step()
    fresh = Trainer(config, device="cpu", model=tiny_resnet(seed=1))
    step = fresh.restore(directory)
    restored = state_tensors(fresh.state)
    for _ in range(after):
        fresh.train_step()
    return dict(rank=live.rank, path=path, step=step, writes=writes, saved=saved,
                restored=restored, live=state_tensors(live.state),
                resumed=state_tensors(fresh.state))


def _copy_generator(gen: torch.Generator) -> torch.Generator:
    copy = torch.Generator(device=gen.device)
    copy.set_state(gen.get_state())
    return copy


def failing_rank():
    """Rank 1 raises before the all-reduce that rank 0 then waits in."""
    if dist.get_rank() == 1:
        raise RuntimeError("rank 1 fails on purpose")
    dist.all_reduce(torch.ones(1))
    return "unreachable"


def carried_numpy(state) -> dict:
    """What the pool sampler's step modes carry, as host numpy values: the
    EMA, the stream and the pending batch, cached pool or groupwise
    state."""
    out = {"ema": float(state.ema.value), "ema_count": int(state.ema.count),
           "cursor": state.stream.cursor, "perm": state.stream.perm.numpy().copy()}
    for prefix, value in (("pending", state.pending_batch), ("cached", state.cached_pool),
                          ("gw", state.groupwise)):
        if value is not None:
            out.update({f"{prefix}.{k}": v.numpy().copy() if torch.is_tensor(v) else v
                        for k, v in value._asdict().items()})
    return out


def modes_rank(jobs, data):
    """The pool sampler's step modes at W ranks: for each job ``(config,
    state_dict, perms, draws, synced)`` the model from ``state_dict``, this
    rank's stream permutation ``perms[rank]``, then a step a row of
    ``draws[t][rank]``, each followed by loading ``synced[t]`` (the JAX
    step's parameters). Returns each step's metrics, carried state and
    parameters before the load."""
    torch.set_num_threads(1)
    r = dist.get_rank()
    x, y, xt, yt, shards, mean, std = data
    out = []
    for config, state_dict, perms, draws, synced in jobs:
        model = tiny_resnet()
        model.load_state_dict(state_dict)
        set_sync_batch_norm(model, config.batch_norm == "sync")
        dataset = make_sharded_dataset((x, y), (xt, yt), shards, mean, std, 10,
                                       device=torch.device("cpu"), rank=r)
        state = create_state(
            model, "cpu", config.seed, dataset.shard_len, "adam", config.lr,
            config.steps_per_epoch * config.num_epochs, rank=r,
            with_groupwise=config.use_groupwise,
            pending_batch_size=config.batch_size if config.use_pipelined else 0,
            cached_pool_size=config.candidate_pool_size if config.use_cadence else 0)
        state.stream = ShardStream(perm=torch.tensor(perms[r], dtype=torch.long), cursor=0)
        step_fn = make_train_step(config, dataset)
        steps = []
        for row, params in zip(draws, synced):
            metrics = step_fn(state, row[r])
            steps.append(dict(
                metrics={k: v.detach().clone() for k, v in metrics.items()},
                carried=carried_numpy(state),
                state_dict={k: v.detach().clone() for k, v in state.model.state_dict().items()}))
            state.model.load_state_dict(params)
        out.append(steps)
    return out


def grad_path_rank(jobs, data, checkpoint_kw, directory):
    """The gradient path's options at W ranks: for each job ``(config,
    state_dict, perms, draws, synced)`` the model from ``state_dict``, this
    rank's stream permutation ``perms[rank]``, then a step a row of
    ``draws[t][rank]``, each followed by loading ``synced[t]`` (the JAX
    step's parameters); then :func:`checkpoint_rank` of ``checkpoint_kw``
    into ``directory``, three steps before the save and three after. Returns
    each step's metrics, parameters before the load and, under ZeRO, this
    rank's chunk moments; and the checkpoint run's states."""
    torch.set_num_threads(1)
    r = dist.get_rank()
    x, y, xt, yt, shards, mean, std = data
    out = []
    for config, state_dict, perms, draws, synced in jobs:
        model = tiny_resnet()
        model.load_state_dict(state_dict)
        set_sync_batch_norm(model, config.batch_norm == "sync")
        dataset = make_sharded_dataset((x, y), (xt, yt), shards, mean, std, 10,
                                       device=torch.device("cpu"), rank=r,
                                       placement=config.data_placement)
        state = create_state(
            model, "cpu", config.seed, dataset.shard_len, "adam", config.lr,
            config.steps_per_epoch * config.num_epochs, rank=r,
            grad_accum_steps=config.grad_accum_steps,
            with_scoretable=config.use_scoretable, world_size=config.world_size,
            zero_sharding=config.zero_sharding)
        state.stream = ShardStream(perm=torch.tensor(perms[r], dtype=torch.long), cursor=0)
        step_fn = make_train_step(config, dataset)
        steps = []
        for row, params in zip(draws, synced):
            metrics = step_fn(state, row[r])
            moments = {k: v.clone() for st in state.optimizer.state.values()
                       for k, v in st.items() if k.startswith("exp_avg")}
            steps.append(dict(
                metrics={k: v.detach().clone() for k, v in metrics.items()},
                moments=moments if config.zero_sharding else None,
                state_dict={k: v.detach().clone() for k, v in state.model.state_dict().items()}))
            state.model.load_state_dict(params)
        out.append(steps)
    return dict(jobs=out, checkpoint=checkpoint_rank(checkpoint_kw, directory, 3, 3))


def _recorded(trainer):
    """Wrap ``trainer``'s apply and its scorer's snapshot to record every
    applied chunk as ``(tick step, chunk step)`` and every snapshot's step
    into the two lists returned (cleared by the caller as it likes)."""
    applied, snapshots = [], []
    apply, snapshot = trainer._apply_chunks, trainer._scorer_fleet.snapshot

    def recorded(chunks, step):
        applied.extend((step, c.step) for c in chunks)
        apply(chunks, step)

    def snapped(model, step):
        snapshots.append(step)
        snapshot(model, step)

    trainer._apply_chunks, trainer._scorer_fleet.snapshot = recorded, snapped
    return applied, snapshots


def lockstep_rank(config_kw, data, state_dict, augs, runs, steps, directory, restore_at):
    """The device backend's lockstep at W ranks, on the CPU. First this
    rank's two ``score_once`` chunks of a :class:`ScorerService` (workers
    stopped) from a snapshot at step 5 of the model ``state_dict``, the
    crops and flips of chunk ``seq`` being ``augs[seq][rank]``, and the
    card indices ``cards_in_use`` gathers when rank r says it trains on
    card ``2 + r``. Then ``runs`` Trainers, each ``fit(steps=steps)`` from
    the tiny model of seed 0, recording every applied chunk as ``(tick
    step, chunk step)``, every snapshot's step, and the final table. Last,
    a restore in a live run: ``restore_at`` steps, a save into
    ``directory``, two more steps, a restore of the save and ``steps -
    restore_at`` steps; and a fresh Trainer (other weights) restored from
    the same save and run as far. Both record what they apply and snapshot
    from the restore on."""
    torch.set_num_threads(1)
    r = dist.get_rank()
    x, y, xt, yt, shards, mean, std = data
    config = TrainConfig(**config_kw)

    def dataset():
        return make_sharded_dataset((x, y), (xt, yt), shards, mean, std, 10,
                                    device=torch.device("cpu"), rank=r)

    model = tiny_resnet()
    model.load_state_dict(state_dict)
    svc = ScorerService(dataset(), model, config, "cpu")
    svc.close()
    fed = iter(row[r] for row in augs)
    draw = scorer_fleet.draw_augment
    scorer_fleet.draw_augment = lambda gen, n, cfg: next(fed)
    try:
        svc.snapshot(model, 5)
        chunks = [svc.score_once() for _ in augs]
    finally:
        scorer_fleet.draw_augment = draw
    out = dict(chunks=chunks, summary=svc.summary(), runs=[],
               cards=cards_in_use(torch.device("cuda", 2 + r)))
    for _ in range(runs):
        trainer = Trainer(config, dataset=dataset(), device="cpu", model=tiny_resnet(seed=0))
        snapshots0 = [trainer._scorer_fleet.summary()["snapshot_step"]]
        applied, snapshots = _recorded(trainer)
        try:
            result = trainer.fit(steps=steps)
            out["runs"].append(dict(
                applied=applied, snapshots=snapshots0 + snapshots,
                loss=result["train/loss"], table=trainer.state.scoretable.scores.clone(),
                summary=trainer._scorer_fleet.summary(),
                waits=list(trainer._scorer_fleet.barrier_waits_ms)))
        finally:
            trainer.close()
    restored = {}
    live = Trainer(config, dataset=dataset(), device="cpu", model=tiny_resnet(seed=0))
    fresh = Trainer(config, dataset=dataset(), device="cpu", model=tiny_resnet(seed=1))
    try:
        live.fit(steps=restore_at)
        live.save(directory)
        live.fit(steps=2)   # snapshot restore_at + 2 arms a chunk of this trajectory
        for name, trainer in (("live", live), ("fresh", fresh)):
            applied, snapshots = _recorded(trainer)
            step = trainer.restore(directory)
            result = trainer.fit(steps=steps - restore_at)
            restored[name] = dict(step=step, applied=applied, snapshots=snapshots,
                                  loss=result["train/loss"],
                                  table=trainer.state.scoretable.scores.clone(),
                                  summary=trainer._scorer_fleet.summary())
    finally:
        live.close()
        fresh.close()
    out["restored"] = restored
    return out


def elastic_save_rank(jobs):
    """For each ``(config_kw, directory, steps)``: a ``Trainer`` of the tiny
    model at W ranks, ``steps`` steps, a save into ``directory``. Returns
    each job's losses."""
    torch.set_num_threads(1)
    out = []
    for config_kw, directory, steps in jobs:
        trainer = Trainer(TrainConfig(**config_kw), device="cpu", model=tiny_resnet(seed=0))
        out.append([float(trainer.train_step()["train/loss"]) for _ in range(steps)])
        trainer.save(directory)
        trainer.close()
    return out


def elastic_restore_rank(jobs):
    """For each ``(config_kw, directory, auto)``: a ``Trainer`` of the tiny
    model with other weights at W ranks that restores ``directory``
    elastically (``auto``: by ``auto_resume`` at construction); the state
    it restored, the step, and two more steps' losses."""
    torch.set_num_threads(1)
    out = []
    for config_kw, directory, auto in jobs:
        config = TrainConfig(**config_kw)
        if auto:
            trainer = Trainer(config.replace(checkpoint_dir=directory, auto_resume=True),
                              device="cpu", model=tiny_resnet(seed=1))
            step = trainer.state.step
        else:
            trainer = Trainer(config, device="cpu", model=tiny_resnet(seed=1))
            step = trainer.restore_elastic(directory)
        restored = state_tensors(trainer.state)
        losses = [float(trainer.train_step()["train/loss"]) for _ in range(2)]
        trainer.close()
        out.append(dict(rank=dist.get_rank(), step=step, restored=restored, losses=losses,
                        shard_row=trainer.dataset.shard_indices[trainer.rank].clone()))
    return out


def fallback_rank(config_kw, directory):
    """Two saves at W ranks (after steps 1 and 2); then a fresh ``Trainer``
    whose newest file fails to read on rank 1 alone restores, and another
    restores step 1 explicitly. Returns both restored steps and states."""
    from mercury_tpu_torch.train import checkpoint

    torch.set_num_threads(1)
    config = TrainConfig(**config_kw)
    live = Trainer(config, device="cpu", model=tiny_resnet(seed=0))
    for _ in range(2):
        live.train_step()
        live.save(directory)
    load = checkpoint.load_checkpoint

    def failing(directory_, step, verify=True):
        if step == 2 and dist.get_rank() == 1:
            raise OSError("rank 1 cannot read ckpt_2.pt")
        return load(directory_, step, verify)

    checkpoint.load_checkpoint = failing
    try:
        walked = Trainer(config, device="cpu", model=tiny_resnet(seed=1))
        step = walked.restore(directory)
    finally:
        checkpoint.load_checkpoint = load
    explicit = Trainer(config, device="cpu", model=tiny_resnet(seed=1))
    explicit.restore(directory, step=1)
    return dict(rank=dist.get_rank(), step=step, walked=state_tensors(walked.state),
                explicit=state_tensors(explicit.state))


def gather_rank(rounds):
    """``CrossHostGatherAggregator`` (``"allgather"``) at W ranks: each
    round's ``rounds[i][rank]`` record, through the gather; every
    round's merge on this rank (empty on the ranks but 0)."""
    r = dist.get_rank()
    agg = CrossHostGatherAggregator(window=4, gather=collectives.allgather_floats, rank=r)
    return [agg.update(records[r]) for records in rounds]


def _rank_dataset(data):
    x, y, xt, yt, shards, mean, std = data
    return make_sharded_dataset((x, y), (xt, yt), shards, mean, std, 10,
                                device=torch.device("cpu"), rank=dist.get_rank())


def straggler_rank(config_kw, data, slow_rank, slow_spec, steps, log_dirs):
    """A W-rank ``fit`` of ``steps`` steps for each ``crosshost_telemetry``
    mode of ``log_dirs`` (mode → this run's log_dir), ``slow_spec`` (a
    ``host_slow`` fault) on rank ``slow_rank`` alone: rank 0's anomaly
    trigger counts a mode (None elsewhere)."""
    torch.set_num_threads(1)
    out = {}
    for mode, log_dir in log_dirs.items():
        kw = dict(config_kw, crosshost_telemetry=mode, log_dir=log_dir)
        if dist.get_rank() == slow_rank:
            kw["fault_spec"] = slow_spec
        trainer = Trainer(TrainConfig(**kw), dataset=_rank_dataset(data), device="cpu",
                          model=tiny_resnet(seed=0))
        try:
            trainer.fit(steps=steps)
            trainer.logger.flush()
            out[mode] = (None if trainer.anomaly is None
                         else dict(trainer.anomaly.trigger_counts))
        finally:
            trainer.close()
    return out


def ladder_rank(config_kw, data, steps, die_rank, die_step):
    """The supervised async ladder at W ranks: ``scorer_die`` at
    ``die_step`` on rank ``die_rank`` alone, a ``fit`` of ``steps`` steps.
    Returns each tick's level after the tick, the level each refresh tick
    acted on, the supervisor's transitions, the service's summary, the
    seconds ``fit`` took and this rank's journal kinds."""
    import time

    torch.set_num_threads(1)
    kw = dict(config_kw)
    if dist.get_rank() == die_rank:
        kw["fault_spec"] = f"scorer_die@step={die_step}"
    trainer = Trainer(TrainConfig(**kw), dataset=_rank_dataset(data), device="cpu",
                      model=tiny_resnet(seed=0))
    sup = trainer.supervisor
    levels, acted = [], []
    tick, refresh = sup.tick, trainer._refresh_tick

    def ticked(step):
        tick(step)
        levels.append((step, sup.level()))

    def refreshed(step, advanced=1):
        acted.append((step, sup.level()))
        refresh(step, advanced)

    sup.tick, trainer._refresh_tick = ticked, refreshed
    try:
        t0 = time.perf_counter()
        trainer.fit(steps=steps)
        elapsed = time.perf_counter() - t0
        return dict(levels=levels, acted=acted, transitions=sup.summary()["transitions"],
                    service=trainer._scorer_fleet.summary(), elapsed=elapsed,
                    released=trainer._scorer_fleet._ls_released)
    finally:
        trainer.close()


def restored_state(state) -> dict:
    """Copies of the gathered whole model and Adam state, and the EMA."""
    from mercury_tpu_torch.parallel.mesh import full_optimizer_state, full_state_dict

    adam = full_optimizer_state(state.model, state.optimizer.state_dict())["state"]
    return dict(full={k: v.clone() for k, v in full_state_dict(state.model).items()},
                adam={i: {k: v.clone() if torch.is_tensor(v) else v for k, v in st.items()}
                      for i, st in adam.items()},
                ema=(float(state.ema.value), int(state.ema.count)))


def mesh_rank(jobs):
    """Each job one ``Trainer`` of a ``world_size × N`` mesh on the CPU
    (``job``: ``config`` keywords; ``model``, None for the Trainer's own, a
    ``create_model`` keyword dict with its ``name``, or ``{"tiny_resnet":
    width}``; ``steps``; optionally ``params`` an unsharded state dict to
    load, ``workers`` each worker's JAX stream permutation and EMA,
    ``draws`` each worker's ``Draws`` a step, ``synced`` an unsharded
    state dict a step loaded after it (the JAX step's parameters; the
    gathered state before the load is kept a step), ``save`` a directory
    saved into after ``save_at`` steps, ``restore`` a directory restored
    from first, ``restore_elastic`` one restored elastically, ``evaluate``
    to evaluate and predict at the end). Under ``scan_steps=K`` a step is a
    chunk of K. Returns, a job each: the rank's place in the mesh and its
    groups, its shards before and after the steps, Adam's local moments,
    each step's loss, sparse rate, selection, gradient norm and
    collectives, the EMA's count and the gathered unsharded state at the
    end (and after each step under ``synced``), the gathered Adam state,
    and the score table."""
    from mercury_tpu_torch.parallel.mesh import full_state_dict, load_full_state_dict
    from mercury_tpu_torch.parallel.mesh import full_optimizer_state

    if dist.is_initialized():
        torch.set_num_threads(1)
    out = []
    for job in jobs:
        trainer = _mesh_trainer(job)
        config, mesh, state = trainer.config, trainer.mesh, trainer.state
        if job.get("restore"):
            trainer.restore(job["restore"])
        if job.get("restore_elastic"):
            trainer.restore_elastic(job["restore_elastic"])
        if job.get("params") is not None:
            load_full_state_dict(state.model, job["params"])
        if job.get("workers") is not None:
            mine = job["workers"][trainer.rank]
            state.stream = ShardStream(perm=torch.tensor(mine["perm"], dtype=torch.long),
                                       cursor=0)
            state.ema = EMAState(torch.tensor(mine["ema"]), torch.tensor(0, dtype=torch.int32))
        result = dict(rank=collectives.rank(), data_rank=trainer.rank, model_rank=mesh.model_rank,
                      data_ranks=group_ranks(mesh.data_group),
                      model_ranks=None if mesh.model is None else group_ranks(mesh.model.group),
                      step0=state.step,
                      local0={k: v.detach().clone() for k, v in state.model.state_dict().items()},
                      restored=restored_state(state) if job.get("restore_elastic") else None,
                      losses=[], sparse_rates=[], selected=[], grad_norms=[], calls=[],
                      full_steps=[])
        for i in range(job["steps"]):
            draws = None if job.get("draws") is None else job["draws"][trainer.rank][i]
            with counting_collectives() as calls:
                # A chunk of scan_steps steps a call, each metric [K].
                m = (trainer.train_chunk() if config.scan_steps > 1
                     else trainer.train_step(draws))
            result["losses"].extend(m["train/loss"].reshape(-1).tolist())
            result["sparse_rates"].extend(m["train/sparse_rate"].reshape(-1).tolist())
            result["selected"].append(m["sampler/selected"].clone())
            if "train/grad_norm" in m:
                result["grad_norms"].extend(m["train/grad_norm"].reshape(-1).tolist())
            result["calls"].append(calls)
            if job.get("synced") is not None:
                result["full_steps"].append({k: v.clone() for k, v in
                                             full_state_dict(state.model).items()})
                load_full_state_dict(state.model, job["synced"][i])
            if job.get("save") and job.get("save_at") == i + 1:
                trainer.save(job["save"])
        adam = state.optimizer.state_dict()["state"]
        result.update(
            local={k: v.detach().clone() for k, v in state.model.state_dict().items()},
            shapes={k: tuple(p.shape) for k, p in state.model.named_parameters()},
            adam={i: {k: v.clone() for k, v in st.items() if torch.is_tensor(v)}
                  for i, st in adam.items()},
            full=full_state_dict(state.model),
            full_adam=full_optimizer_state(state.model, state.optimizer.state_dict())["state"],
            ema_count=int(state.ema.count),
            evaluate=trainer.evaluate(include_train=False) if job.get("evaluate") else None,
            predict=(trainer.predict(trainer.dataset.x_test[:8]) if job.get("evaluate")
                     else None))
        trainer.close()
        out.append(result)
    return out


def wire_rank(leaves, specs, uniforms, n):
    """The per-leaf int8 wire on a ``W × n`` mesh (``world_size`` ranks
    /n workers): each leaf ``leaves[w][i]`` is worker w's whole leaf,
    which this rank cuts to its shard along the dim ``specs[i]`` claims;
    ``uniforms[w][i]`` its whole ``(u1, u2)`` (None where the leaf takes
    the plain mean). Returns the tree's results and ``compressed_pmean_nd``
    of leaf 0 alone (with its split, dim 0), gathered back to the whole
    leaves over the model group."""
    from mercury_tpu_torch.parallel.collectives import (
        compressed_pmean_nd,
        compressed_pmean_tree_sharded,
        wire_chunk_dim,
    )
    from mercury_tpu_torch.parallel.mesh import gather_dim, make_tp_mesh

    torch.set_num_threads(1)
    w_size = collectives.world() // n
    mesh = make_tp_mesh(w_size, n)
    w, m = mesh.data_rank, mesh.model_rank
    xs, u1s, u2s, splits = [], [], [], []
    for x, spec, pair in zip(leaves[w], specs, uniforms[w]):
        x = torch.as_tensor(x)
        split = next((d for d, e in enumerate(spec or ()) if e is not None), None)
        dim = wire_chunk_dim(tuple(x.shape), spec)
        splits.append(split)
        xs.append(x if split is None else x.chunk(n, split)[m].clone())
        if pair is None:
            u1s.append(None)
            u2s.append(None)
            continue
        at = None if split is None else 2 + (split if split < dim else split - 1)
        u1s.append(torch.as_tensor(pair[0]) if at is None else
                   torch.as_tensor(pair[0]).chunk(n, at)[m])
        u2s.append(torch.as_tensor(pair[1]) if at is None else
                   torch.as_tensor(pair[1]).chunk(n, at)[m])
    out = compressed_pmean_tree_sharded(xs, u1s, u2s, specs, mesh.data_group, mesh.model)
    nd = compressed_pmean_nd(xs[0], u1s[0], u2s[0], wire_chunk_dim(tuple(xs[0].shape),
                                                                   specs[0]),
                             mesh.data_group, None if splits[0] is None else mesh.model)
    whole = [o if s is None else gather_dim(o, s, mesh.model) for o, s in zip(out, splits)]
    nd = nd if splits[0] is None else gather_dim(nd, splits[0], mesh.model)
    return dict(rank=collectives.rank(), worker=w, tree=whole, nd=nd)


@contextlib.contextmanager
def no_fleet_workers():
    """Scorer fleets built inside start no worker thread: their chunks
    come only from ``score_once``, so a run is deterministic."""
    spawn_workers = scorer_fleet.ScorerFleet._spawn_workers

    def idle(self):
        self._stop, self._threads = threading.Event(), []

    scorer_fleet.ScorerFleet._spawn_workers = idle
    try:
        yield
    finally:
        scorer_fleet.ScorerFleet._spawn_workers = spawn_workers


def _mesh_trainer(job):
    spec, model = job.get("model"), None
    if spec is not None and "tiny_resnet" in spec:
        model = tiny_resnet(seed=0, width=spec["tiny_resnet"])
    elif spec is not None:
        kw = dict(spec)
        model = create_model(kw.pop("name"), 10, torch.Generator().manual_seed(0),
                             tuple(kw.pop("sample_shape")), **kw)
    return Trainer(TrainConfig(**job["config"]), device="cpu", model=model)


def async_steps(job):
    """Async refresh with the chunks given: before step t the scorer's
    rank queues one ``score_once`` chunk made to be ``ages[t]`` steps old
    at the step's tick (None: none), then every rank steps. Returns each
    step's table, loss and selection, the chunks applied ``(tick step,
    chunk step)``, whether this rank holds a scorer and the scorer threads
    alive."""
    with no_fleet_workers():
        trainer = _mesh_trainer(job)
    fleet = trainer._scorer_fleet
    applied = []
    apply = trainer._apply_chunks

    def recorded(chunks, step):
        applied.extend((step, c.step) for c in chunks)
        apply(chunks, step)

    trainer._apply_chunks = recorded
    out = dict(rank=collectives.rank(), model_rank=trainer.mesh.model_rank,
               has_scorer=fleet is not None, tables=[], losses=[], selected=[])
    try:
        for age in job["ages"]:
            if fleet is not None and age is not None:
                chunk = fleet.score_once()
                fleet._ready.put(chunk._replace(step=trainer.state.step + 1 - age))
            m = trainer.train_step()
            out["tables"].append(trainer.state.scoretable.scores.clone())
            out["losses"].append(float(m["train/loss"]))
            out["selected"].append(m["sampler/selected"].clone())
        out.update(applied=applied, threads=sorted(
            t.name for t in threading.enumerate() if t.name.startswith("mercury-scorer")))
    finally:
        trainer.close()
    return out


def ladder_steps(job):
    """The supervised async ladder under a second axis with live workers:
    ``fit`` of ``job["steps"]`` steps, the scorer's fault in the config.
    Returns each tick's level, the table after every refresh tick, the
    chunks applied and the supervisor's transitions."""
    trainer = _mesh_trainer(job)
    sup = trainer.supervisor
    levels, tables, applied = [], [], []
    tick, refresh, apply = sup.tick, trainer._refresh_tick, trainer._apply_chunks

    def ticked(step):
        tick(step)
        levels.append((step, sup.level()))

    def refreshed(step, advanced=1):
        refresh(step, advanced)
        tables.append(trainer.state.scoretable.scores.clone())

    def recorded(chunks, step):
        applied.extend((step, c.step) for c in chunks)
        apply(chunks, step)

    sup.tick, trainer._refresh_tick, trainer._apply_chunks = ticked, refreshed, recorded
    try:
        trainer.fit(steps=job["steps"])
        return dict(rank=collectives.rank(), levels=levels, tables=tables, applied=applied,
                    has_scorer=trainer._scorer_fleet is not None,
                    transitions=sup.summary()["transitions"])
    finally:
        trainer.close()


def mesh_async_rank(jobs):
    """Each job ``(kind, job)``: ``"async"`` :func:`async_steps`,
    ``"ladder"`` :func:`ladder_steps`, ``"mesh"`` :func:`mesh_rank` of the
    one job."""
    if dist.is_initialized():
        torch.set_num_threads(1)
    bodies = {"async": async_steps, "ladder": ladder_steps,
              "mesh": lambda job: mesh_rank([job])[0]}
    return [bodies[kind](job) for kind, job in jobs]


def flat_wire_rank(steps):
    """The flat int8 wire at W ranks: ``steps[t][w]`` is worker w's
    ``(vec, u1, u2)`` of step t; returns this rank's
    ``compressed_allreduce_mean`` of each step."""
    torch.set_num_threads(1)
    w = collectives.rank()
    return [collectives.compressed_allreduce_mean(*(torch.as_tensor(a) for a in step[w]))
            for step in steps]


def sp_attention_rank(cases, long_len):
    """The sequence-parallel attentions on this rank's block of each case
    ``(impl, causal, q, k, v, cotangent)`` (global ``[B, L, H, D]`` numpy
    arrays, in the layout the impl reads): the output block and the
    gradients of ``sum(out · cotangent)`` with respect to this rank's q, k
    and v blocks. Then a ring forward at ``long_len`` (``[1, L, 1, 8]``)
    with every tensor autograd saves recorded: their shapes."""
    from mercury_tpu_torch.parallel.mesh import GroupRef
    from mercury_tpu_torch.parallel.sequence import attention

    torch.set_num_threads(1)
    w, r = collectives.world(), collectives.rank()
    group = GroupRef(dist.group.WORLD, w, r)

    def block(a):
        return torch.as_tensor(a).chunk(w, dim=1)[r].clone()

    out = []
    for impl, causal, *arrays in cases:
        q, k, v, ct = (block(a) for a in arrays)
        q, k, v = (t.requires_grad_() for t in (q, k, v))
        o = attention(q, k, v, causal=causal, sp_axis="seq", sp_impl=impl, group=group)
        (o.float() * ct.float()).sum().backward()
        out.append(dict(out=o.detach(), grads=[t.grad for t in (q, k, v)]))
    saved = []
    x = torch.zeros((1, long_len // w, 1, 8), requires_grad=True)

    def pack(t):
        saved.append(tuple(t.shape))
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        attention(x, x, x, sp_axis="seq", sp_impl="ring", group=group).sum()
    return dict(cases=out, saved=saved)


def sp_step_rank(jobs, x, y):
    """Each job on this rank of a ``2 × 2`` data × seq mesh: the
    Transformer ``TransformerClassifier(**job["model"])`` from the JAX
    weights ``job["state_dict"]`` under SGD at ``job["lr"]``; a
    ``"mercury"`` job runs ``make_dp_sp_mercury_step`` (telemetry on)
    for ``len(job["uniforms"])`` steps from each worker's JAX stream
    ``job["perms"][w]`` with the draws ``job["uniforms"][t][w]``, a
    ``"train"`` job one ``make_dp_sp_train_step`` on ``job["batch"]``.
    Returns each step's metrics and the parameters after the first."""
    from mercury_tpu_torch.models.transformer import TransformerClassifier
    from mercury_tpu_torch.parallel.mesh import make_tp_mesh
    from mercury_tpu_torch.train.sp_step import (
        init_sp_mercury_state,
        make_dp_sp_mercury_step,
        make_dp_sp_train_step,
    )
    from mercury_tpu_torch.train.state import Draws

    torch.set_num_threads(1)
    mesh = make_tp_mesh(2, 2, "data", "seq")
    x, y = torch.as_tensor(x), torch.as_tensor(y)
    out = []
    for job in jobs:
        model = TransformerClassifier(**job["model"])
        model.load_state_dict(job["state_dict"])
        opt = torch.optim.SGD(model.parameters(), lr=job["lr"])
        if job["kind"] == "train":
            step = make_dp_sp_train_step(model, opt, mesh, device="cpu")
            loss = step(*(torch.as_tensor(a) for a in job["batch"]))
            out.append(dict(metrics=[{"train/loss": loss}], params=model.state_dict()))
            continue
        state = init_sp_mercury_state(model, opt, mesh, x.shape[0], device="cpu")
        state.stream = ShardStream(perm=torch.as_tensor(job["perms"][mesh.data_rank]).long(),
                                   cursor=0)
        step = make_dp_sp_mercury_step(model, mesh, 4, 2, moe_aux_weight=job["aux_weight"],
                                       telemetry=True)
        metrics, params = [], None
        for row in job["uniforms"]:
            _, m = step(state, x, y, Draws(perm=None, aug=None,
                                           uniforms=torch.as_tensor(row[mesh.data_rank])))
            metrics.append({k: v.detach().clone() for k, v in m.items()})
            if params is None:
                params = {k: v.detach().clone() for k, v in model.state_dict().items()}
        out.append(dict(metrics=metrics, params=params, ema=state.ema.value.item()))
    return dict(rank=collectives.rank(), data_rank=mesh.data_rank, seq_rank=mesh.model_rank,
                jobs=out)


def pipeline_rank(jobs, sizes):
    """Each job on this rank of a pipe mesh of ``job["stages"]`` ranks (one
    of ``sizes``; a pipe of fewer ranks than the process group is
    ``make_tp_mesh(world // S, S, "data", "pipe")``, a pipeline a pair of
    data ranks): the Transformer ``TransformerClassifier(**job["model"])``
    with this stage's weights ``job["staged"][stage]`` (SGD at
    ``job["lr"]``). An ``"apply"`` job runs ``make_pp_apply`` at
    ``job["microbatches"]`` (``remat``, ``with_aux``) on ``job["x"]`` and
    the backward of the mean NLL of ``job["y"]`` plus
    ``job["aux_weight"]`` times the router loss, then
    ``reduce_replicated_grads``: the logits, the loss, the router loss and
    the gradients. A ``"step"`` job runs ``make_pp_mercury_step`` (batch
    ``job["batch"]``, presample ``job["presample"]``, telemetry on) from the
    JAX stream ``job["perm"]`` with the draws ``job["uniforms"][t]``: each
    step's metrics and the stage's parameters after the first."""
    from mercury_tpu_torch.models.transformer import TransformerClassifier
    from mercury_tpu_torch.ops.mercury_kernels import per_sample_nll
    from mercury_tpu_torch.parallel.mesh import make_tp_mesh
    from mercury_tpu_torch.parallel.pipeline import (
        make_pp_apply,
        reduce_replicated_grads,
        shard_stacked_blocks,
    )
    from mercury_tpu_torch.train.pp_step import create_pp_state, make_pp_mercury_step
    from mercury_tpu_torch.train.state import Draws

    torch.set_num_threads(1)
    w = collectives.world()
    meshes = {s: make_tp_mesh(w // s, s, "data", "pipe") for s in sorted(sizes)}
    out = []
    for job in jobs:
        mesh = meshes[job["stages"]]
        stage = mesh.model_rank
        model = shard_stacked_blocks(TransformerClassifier(**job["model"]), mesh)
        model.load_state_dict(job["staged"][stage])
        opt = torch.optim.SGD(model.parameters(), lr=job.get("lr", 0.0))
        if job["kind"] == "apply":
            apply = make_pp_apply(model, mesh, job["microbatches"], remat=job.get("remat", False),
                                  with_aux=job.get("with_aux", False))
            res = apply(torch.as_tensor(job["x"]))
            logits, aux = res if job.get("with_aux") else (res, torch.zeros(()))
            loss = per_sample_nll(logits, torch.as_tensor(job["y"])).mean()
            total = loss + job.get("aux_weight", 0.0) * aux
            total.backward()
            reduce_replicated_grads(model, mesh)
            out.append(dict(stage=stage, blocks=len(model.blocks), logits=logits.detach(),
                            loss=total.item(), aux=aux.item(),
                            grads={k: p.grad.clone() for k, p in model.named_parameters()}))
            continue
        state = create_pp_state(model, opt, mesh, job["n"], device="cpu")
        state.stream = ShardStream(perm=torch.as_tensor(job["perm"]).long(), cursor=0)
        step = make_pp_mercury_step(model, mesh, job["batch"], job["presample"],
                                    job["microbatches"], moe_aux_weight=job["aux_weight"],
                                    telemetry=True)
        x, y = torch.as_tensor(job["x"]), torch.as_tensor(job["y"])
        metrics, params = [], None
        for row in job["uniforms"]:
            _, m = step(state, x, y, Draws(perm=None, aug=None, uniforms=torch.as_tensor(row)))
            metrics.append({k: v.detach().clone() for k, v in m.items()})
            if params is None:
                params = {k: v.detach().clone() for k, v in model.state_dict().items()}
        out.append(dict(stage=stage, metrics=metrics, params=params, ema=state.ema.value.item()))
    return dict(rank=collectives.rank(), jobs=out)


def moe_from_flax(params) -> dict:
    """The state dict of a lone ``MoEMLP`` from its Flax ``params`` (numpy):
    the gate's Dense transposed, the stacked arrays as they are."""
    return {"gate.weight": torch.as_tensor(params["gate"]["kernel"]).T.contiguous(),
            "gate.bias": torch.as_tensor(params["gate"]["bias"]),
            **{k: torch.as_tensor(params[k]) for k in ("w_up", "b_up", "w_down", "b_down")}}


def ep_rank(jobs):
    """Each job on this rank of an expert group of ``job["w"]`` ranks (4:
    the whole group; 2: the model groups of ``make_tp_mesh(2, 2, "data",
    "expert")``, two pairs fed alike), on its slice ``e`` of the batch
    ``job["x"]``. A ``"moe"`` job: the layer ``MoEMLP`` built whole from
    the Flax ``job["params"]`` with ``ep_axis``, its experts cut by
    ``bind``; the loss ``Σ y²`` over the group (``shard_sum``) plus
    ``job["aux_weight"]`` × the router loss. A ``"classifier"`` job: the
    Transformer ``TransformerClassifier(**job["model"])`` from the Flax
    ``job["params"]``, ``bind_expert_group``; the loss the batch's mean NLL
    of ``job["y"]`` plus ``job["aux_weight"]`` × the router loss. Both:
    the backward, every gradient but the experts' (``expert_leaf_names``)
    summed over the group (``sum_grads_``); the rank's output rows, the
    router loss, the loss and the gradients (the experts the rank's)."""
    from mercury_tpu_torch.models.convert import params_from_flax
    from mercury_tpu_torch.models.moe import MoEMLP, bind_expert_group, expert_leaf_names
    from mercury_tpu_torch.models.transformer import TransformerClassifier
    from mercury_tpu_torch.ops.mercury_kernels import per_sample_nll
    from mercury_tpu_torch.parallel.mesh import GroupRef, make_tp_mesh

    torch.set_num_threads(1)
    w, r = collectives.world(), collectives.rank()
    groups = {w: GroupRef(dist.group.WORLD, w, r), 2: make_tp_mesh(w // 2, 2, "data",
                                                                   "expert").model}
    out = []
    for job in jobs:
        group = groups[job["w"]]
        x = torch.as_tensor(job["x"]).chunk(group.size)[group.rank]
        if job["kind"] == "moe":
            e, d = job["params"]["w_up"].shape[:2]
            model = MoEMLP(e, d, capacity_factor=job["cf"], ep_axis="expert")
            model.load_state_dict(moe_from_flax(job["params"]))
            model.bind(group)
            y, aux = model(x)
            total = collectives.shard_sum((y * y).sum(), group)
        else:
            model = TransformerClassifier(**job["model"])
            model.load_state_dict(params_from_flax(job["params"], {}))
            bind_expert_group(model, group)
            y, aux = model(x, return_aux=True)
            labels = torch.as_tensor(job["y"]).chunk(group.size)[group.rank]
            nll = per_sample_nll(y, labels).sum() / job["x"].shape[0]
            total = collectives.shard_sum(nll, group)
        total = total + job["aux_weight"] * aux
        total.backward()
        experts = expert_leaf_names(model)
        collectives.sum_grads_([p for k, p in model.named_parameters() if k not in experts],
                               group)
        out.append(dict(e=group.rank, out=y.detach(), aux=aux.item(), loss=total.item(),
                        grads={k: p.grad.clone() for k, p in model.named_parameters()}))
    return dict(rank=r, jobs=out)


def pp_2d_rank(jobs):
    """Each job on this rank of a 2 × 2 pipe × ``job["inner"]`` mesh
    (``make_pp_mesh``; ``"seq"`` or ``"expert"``): the Transformer
    ``TransformerClassifier(**job["model"])`` staged by
    ``shard_stacked_blocks``, with its stage's (and expert rank's) weights
    from the JAX trees ``job["stacked"]``, ``job["rest"]``. An ``"apply"``
    job runs ``make_pp_apply`` at ``job["microbatches"]`` on this rank's
    part of ``job["x"]`` (its token window, or its batch rows) and the
    backward of the batch's mean NLL of ``job["y"]`` plus
    ``job["aux_weight"]`` × the router loss, then
    ``reduce_replicated_grads``: the logits, the loss, the router loss and
    the gradients. A ``"step"`` job runs ``make_pp_mercury_step`` (SGD at
    ``job["lr"]``, batch ``job["batch"]``, presample ``job["presample"]``,
    telemetry on) from the JAX stream ``job["perm"]`` with the draws
    ``job["uniforms"][t]``: each step's metrics and the rank's parameters
    after the first."""
    from mercury_tpu_torch.models.transformer import TransformerClassifier
    from mercury_tpu_torch.ops.mercury_kernels import per_sample_nll
    from mercury_tpu_torch.parallel.mesh import make_pp_mesh
    from mercury_tpu_torch.parallel.pipeline import (
        make_pp_apply,
        reduce_replicated_grads,
        shard_stacked_blocks,
        staged_from_flax,
    )
    from mercury_tpu_torch.train.pp_step import create_pp_state, make_pp_mercury_step
    from mercury_tpu_torch.train.state import Draws

    torch.set_num_threads(1)
    meshes = {inner: make_pp_mesh(2, 2, inner) for inner in ("seq", "expert")}
    out = []
    for job in jobs:
        mesh = meshes[job["inner"]]
        stage, i = mesh.model_rank, mesh.inner.rank
        ep = job["inner"] == "expert"
        model = shard_stacked_blocks(TransformerClassifier(**job["model"]), mesh)
        model.load_state_dict(staged_from_flax(job["stacked"], job["rest"], stage, 2,
                                               i if ep else 0, 2 if ep else 1))
        opt = torch.optim.SGD(model.parameters(), lr=job.get("lr", 0.0))
        x, y = torch.as_tensor(job["x"]), torch.as_tensor(job["y"])
        if job["kind"] == "apply":
            apply = make_pp_apply(model, mesh, job["microbatches"],
                                  with_aux=job.get("with_aux", False))
            if ep:
                x, y = x.chunk(2)[i], y.chunk(2)[i]
            else:
                x = x.chunk(2, dim=1)[i]
            res = apply(x)
            logits, aux = res if job.get("with_aux") else (res, torch.zeros(()))
            nll = per_sample_nll(logits, y).sum() / job["x"].shape[0]
            total = (collectives.shard_sum(nll, mesh.inner) if ep else nll)
            total = total + job.get("aux_weight", 0.0) * aux
            total.backward()
            reduce_replicated_grads(model, mesh)
            out.append(dict(stage=stage, inner=i, logits=logits.detach(), loss=total.item(),
                            aux=aux.item(),
                            grads={k: p.grad.clone() for k, p in model.named_parameters()}))
            continue
        state = create_pp_state(model, opt, mesh, job["n"], device="cpu")
        state.stream = ShardStream(perm=torch.as_tensor(job["perm"]).long(), cursor=0)
        step = make_pp_mercury_step(model, mesh, job["batch"], job["presample"],
                                    job["microbatches"], moe_aux_weight=job["aux_weight"],
                                    telemetry=True)
        metrics, params = [], None
        for row in job["uniforms"]:
            _, m = step(state, x, y, Draws(perm=None, aug=None, uniforms=torch.as_tensor(row)))
            metrics.append({k: v.detach().clone() for k, v in m.items()})
            if params is None:
                params = {k: v.detach().clone() for k, v in model.state_dict().items()}
        out.append(dict(stage=stage, inner=i, metrics=metrics, params=params,
                        ema=state.ema.value.item()))
    return dict(rank=collectives.rank(), jobs=out)
