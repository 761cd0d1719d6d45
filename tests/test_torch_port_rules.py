"""Rules of the port: it imports nothing of JAX or of the JAX package, its
config means what the JAX package's means, it trains on the card unless
told otherwise, and its own fit loop runs on a tiny model."""

import ast
import dataclasses
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from mercury_tpu.config import TrainConfig as JConfig  # noqa: E402
from mercury_tpu_torch import TrainConfig, Trainer  # noqa: E402
from mercury_tpu_torch.models.resnet import BasicBlock, ResNet, init_weights  # noqa: E402
from mercury_tpu_torch.ops import KERNELS, launch_counts, reset_launch_counts  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "mercury_tpu")


def _port_sources():
    return sorted((ROOT / "mercury_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _forbidden_imports(path):
    bad = []
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        for name in names:
            top = name.split(".")[0]
            if top in FORBIDDEN:
                bad.append(f"{path.name}:{node.lineno} imports {name}")
    return bad


def test_port_imports_nothing_of_jax():
    sources = _port_sources()
    assert len(sources) > 10 and all(p.exists() for p in sources)
    bad = [b for p in sources for b in _forbidden_imports(p)]
    assert not bad, bad


def test_ast_walk_catches_a_jax_import(tmp_path):
    p = tmp_path / "m.py"
    p.write_text("import numpy\nfrom mercury_tpu.ops import x\nimport flax.linen as nn\n"
                 "from mercury_tpu_torch import y\n")
    assert [b.split(" imports ")[1] for b in _forbidden_imports(p)] == [
        "mercury_tpu.ops", "flax.linen"]


def test_config_fields_match_the_jax_package():
    jfields = {f.name: f.default for f in dataclasses.fields(JConfig)}
    for f in dataclasses.fields(TrainConfig):
        assert f.name in jfields, f.name
        assert f.default == jfields[f.name], f.name
    cfg = TrainConfig(world_size=1)
    assert cfg.lr == 0.001 and cfg.candidate_pool_size == 320
    for name in ("refresh_size", "table_decay", "refresh_mode", "scoring_dtype",
                 "fused_input", "sampler", "grad_accum_steps", "checkpoint_dir",
                 "checkpoint_every", "checkpoint_keep", "auto_resume", "prefetch_depth",
                 "decode_workers", "stream_shard_mode", "image_size",
                 "pipelined_scoring", "score_refresh_every", "async_checkpoint",
                 "checkpoint_write_retries", "checkpoint_retry_backoff_s",
                 "checkpoint_manifest", "checkpoint_verify", "stream_checkpoint_cursor",
                 "fault_spec"):
        assert name in {f.name for f in dataclasses.fields(TrainConfig)}, name
    assert (cfg.refresh_size, cfg.table_decay, cfg.refresh_mode) == (64, 0.98, "sync")
    assert (cfg.grad_accum_steps, cfg.checkpoint_dir, cfg.checkpoint_every,
            cfg.checkpoint_keep, cfg.auto_resume) == (1, None, 1000, 3, False)
    assert (cfg.prefetch_depth, cfg.decode_workers, cfg.stream_shard_mode,
            cfg.image_size) == (2, 0, "auto", 32)
    assert (cfg.pipelined_scoring, cfg.score_refresh_every) == (False, 1)
    assert (cfg.async_checkpoint, cfg.checkpoint_write_retries, cfg.checkpoint_retry_backoff_s,
            cfg.checkpoint_manifest, cfg.checkpoint_verify, cfg.stream_checkpoint_cursor,
            cfg.fault_spec) == (False, 2, 0.25, True, True, True, "")
    assert len(dataclasses.fields(TrainConfig)) == 106
    assert (cfg.scorer_workers, cfg.snapshot_every, cfg.scorer_throttle_s,
            cfg.scorer_backend) == (1, 16, 0.0, "host")


@pytest.mark.parametrize("field,kw", [
    # The scoretable sampler, its async refresh and the fused ingest are
    # ported: the async refresh is refused where the JAX package refuses it
    # (across processes: every rank of the port is one; without the score
    # table), and a fused ingest without the noniid augmentation is refused.
    pytest.param("refresh_mode", dict(sampler="scoretable", refresh_mode="async",
                                      world_size=2),
                 id="sampler-scoretable"),
    pytest.param("refresh_mode", dict(sampler="pool", refresh_mode="async"),
                 id="refresh_mode-async-pool"),
    pytest.param("fused_input", dict(fused_input=True, augmentation="none"),
                 id="fused_input-True"),
    # host_stream, imagefolder and scoring_dtype are ported: what the JAX
    # package refuses of them is refused.
    pytest.param("prefetch_depth", dict(data_placement="host_stream", prefetch_depth=0),
                 id="data_placement-host_stream"),
    # The image and sequence families are ported (their parity tests are
    # test_torch_port_image_* and test_torch_port_sequence_*).
    pytest.param("data_dir", dict(dataset="imagefolder"), id="dataset-imagefolder"),
    pytest.param("scoring_dtype", dict(scoring_dtype="bfloat16",
                                       use_importance_sampling=False),
                 id="scoring_dtype-bfloat16"),
    pytest.param("grad_accum_steps", dict(grad_accum_steps=0), id="grad_accum_steps-0"),
    pytest.param("stream_shard_mode", dict(data_placement="host_stream",
                                           stream_shard_mode="global"),
                 id="stream_shard_mode-global"),
    pytest.param("stream_shard_mode", dict(world_size=2, stream_shard_mode="replicated"),
                 id="stream_shard_mode-replicated-two-ranks"),
    # The pool sampler's step modes are ported: what the JAX step refuses
    # of them is refused.
    pytest.param("pipelined_scoring", dict(pipelined_scoring=True, sampler="scoretable"),
                 id="pipelined_scoring-scoretable"),
    pytest.param("pipelined_scoring", dict(pipelined_scoring=True, sampler="groupwise"),
                 id="pipelined_scoring-groupwise"),
    pytest.param("score_refresh_every", dict(score_refresh_every=0),
                 id="score_refresh_every-0"),
    pytest.param("score_refresh_every", dict(score_refresh_every=0,
                                             use_importance_sampling=False),
                 id="score_refresh_every-0-uniform"),
    pytest.param("score_refresh_every", dict(score_refresh_every=8, sampler="scoretable"),
                 id="score_refresh_every-scoretable"),
    pytest.param("score_refresh_every", dict(score_refresh_every=8, sampler="groupwise"),
                 id="score_refresh_every-groupwise"),
    pytest.param("score_refresh_every", dict(score_refresh_every=8, pipelined_scoring=True),
                 id="score_refresh_every-pipelined"),
    pytest.param("pipelined_scoring", dict(pipelined_scoring=True,
                                           data_placement="host_stream"),
                 id="pipelined_scoring-host_stream"),
    pytest.param("score_refresh_every", dict(score_refresh_every=8,
                                             data_placement="host_stream"),
                 id="score_refresh_every-host_stream"),
    pytest.param("sampler", dict(sampler="groupwise", data_placement="host_stream"),
                 id="sampler-groupwise-host_stream"),
])
def test_config_rejects_what_is_not_ported(field, kw):
    with pytest.raises(ValueError, match=field):
        TrainConfig(**{"world_size": 1, **kw})


@pytest.mark.parametrize("kw", [
    dict(pipelined_scoring=True, sampler="scoretable"),
    dict(score_refresh_every=8, sampler="groupwise"),
    dict(score_refresh_every=8, pipelined_scoring=True),
    dict(sampler="groupwise", pipelined_scoring=True, data_placement="host_stream"),
], ids=["pipelined-scoretable", "cadence-groupwise", "cadence-pipelined", "host_stream"])
def test_step_modes_are_ignored_without_importance_sampling(kw):
    """As in the JAX step, the uniform arm ignores the step modes."""
    cfg = TrainConfig(world_size=1, use_importance_sampling=False, **kw)
    assert not (cfg.use_pipelined or cfg.use_cadence or cfg.use_groupwise)


#: The observability fields: their defaults, and the ValueError a Trainer
#: raises, as the JAX Trainer does, for a bad value (the JAX package's
#: message: SpanTracer's, StragglerWindow's, or the Trainer's own).
OBS_FIELDS = {"trace": False, "trace_capacity": 4096, "crosshost_telemetry": "auto",
              "crosshost_window": 8, "serve_port": 0}


def test_observability_fields_default_as_jax():
    jfields = {f.name: f.default for f in dataclasses.fields(JConfig)}
    tfields = {f.name: f.default for f in dataclasses.fields(TrainConfig)}
    for name, default in OBS_FIELDS.items():
        assert tfields[name] == jfields[name] == default, name
    missing = sorted(set(jfields) - set(tfields))
    assert missing == ["plan", "plan_memory_budget_bytes"]


def _jax_message(kw):
    """The message of the JAX package's refusal of ``kw``."""
    from mercury_tpu.obs.aggregate import StragglerWindow
    from mercury_tpu.obs.trace import SpanTracer
    from mercury_tpu.train.trainer import Trainer as JTrainer

    if "serve_port" in kw:
        call = lambda: JTrainer(JConfig(serve_port=kw["serve_port"]))  # noqa: E731
    elif "trace_capacity" in kw:
        call = lambda: SpanTracer(kw["trace_capacity"])  # noqa: E731
    elif "crosshost_window" in kw:
        call = lambda: StragglerWindow(kw["crosshost_window"])  # noqa: E731
    else:
        mode = kw["crosshost_telemetry"]
        return (f"crosshost_telemetry={mode!r}: expected one of "
                "'auto', 'off', 'files', 'allgather'")
    with pytest.raises(ValueError) as err:
        call()
    return str(err.value)


@pytest.mark.parametrize("kw", [
    dict(serve_port=-1), dict(serve_port=65536), dict(trace=True, trace_capacity=0),
    dict(crosshost_telemetry="gossip"), dict(crosshost_telemetry="", world_size=2),
    dict(crosshost_telemetry="allgather", crosshost_window=0),
    dict(crosshost_telemetry="files", crosshost_window=0, log_dir="logs"),
], ids=["serve-neg", "serve-big", "capacity-0", "mode-gossip", "mode-empty",
        "window-gather", "window-files"])
def test_observability_fields_validate_as_jax(kw):
    with pytest.raises(ValueError) as err:
        Trainer(TrainConfig(**{"world_size": 1, **kw}), device="cpu")
    assert str(err.value) == _jax_message(kw)


@pytest.mark.parametrize("kw", [
    dict(trace=False, trace_capacity=0), dict(crosshost_window=0),
    dict(crosshost_telemetry="files", crosshost_window=0),
], ids=["capacity-untraced", "window-off", "window-files-without-log-dir"])
def test_observability_fields_ignored_where_jax_ignores_them(kw):
    """A config builds where the JAX Trainer builds it: the capacity of a
    tracer that is off, the window of an aggregation that is off (at one
    rank ``"auto"`` is off, and ``"files"`` without a log_dir)."""
    tr = _tiny(**kw)
    try:
        assert tr._crosshost_mode == "off" and not tr.tracer.enabled
    finally:
        tr.close()


def test_default_config_constructs_at_four_ranks():
    cfg = TrainConfig()
    assert cfg.world_size == 4 and cfg.lr == 0.004
    assert (cfg.data_placement, cfg.sync_importance_stats, cfg.batch_norm) == (
        "replicated", True, "sync")


def test_trainer_at_two_ranks_without_a_process_group_raises():
    """No silent fall back to one rank: the message names the field and
    says how to launch."""
    with pytest.raises(ValueError, match="world_size") as err:
        Trainer(TrainConfig(dataset="synthetic", world_size=2), device="cpu")
    assert "torchrun --nproc_per_node=2" in str(err.value)
    assert "spawn" in str(err.value)


def test_trainer_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Trainer(TrainConfig(dataset="synthetic", world_size=1))


def _tiny(**kw):
    base = dict(dataset="synthetic", world_size=1, batch_size=4, presample_batches=4,
                compute_dtype="float32", num_epochs=1, steps_per_epoch=6,
                eval_every=0, log_every=0, seed=0)
    base.update(kw)
    model = ResNet([1, 1], BasicBlock, num_classes=10, num_filters=8)
    init_weights(model, torch.Generator().manual_seed(0))
    return Trainer(TrainConfig(**base), device="cpu", model=model)


@pytest.mark.parametrize("use_is", [True, False])
def test_cpu_fit_gives_finite_losses(use_is):
    tr = _tiny(use_importance_sampling=use_is)
    reset_launch_counts()
    losses = [float(tr.train_step()["train/loss"]) for _ in range(5)]
    assert all(np.isfinite(losses))
    assert tr.state.step == 5
    assert launch_counts == {k: 0 for k in KERNELS}
    out = tr.fit(steps=1)
    assert np.isfinite(out["train/loss"]) and tr.state.step == 6
    ev = tr.evaluate(include_train=False)
    assert set(ev) == {"test/eval_loss", "test/eval_acc"}
    assert np.isfinite(ev["test/eval_loss"]) and 0.0 <= ev["test/eval_acc"] <= 1.0


def test_stream_wraps_and_reshuffles():
    """5000 images / pool 16: the stream wraps after 312 pools; drive the
    cursor to the end and check the next step reshuffles and restarts."""
    tr = _tiny()
    length = tr.dataset.shard_len
    tr.state.stream = tr.state.stream._replace(cursor=length - 8)
    old = tr.state.stream.perm.clone()
    tr.train_step()
    assert tr.state.stream.cursor == 16
    assert not torch.equal(tr.state.stream.perm, old)


def test_state_clone_is_independent():
    tr = _tiny()
    copy = tr.state.clone()
    tr.train_step()
    assert copy.step == 0 and tr.state.step == 1
    w0 = dict(copy.model.named_parameters())["fc.weight"]
    w1 = dict(tr.state.model.named_parameters())["fc.weight"]
    assert not torch.equal(w0, w1)
    assert copy.optimizer.param_groups[0]["params"][0] is next(copy.model.parameters())
