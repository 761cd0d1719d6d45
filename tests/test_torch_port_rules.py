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
                 "fused_input", "sampler"):
        assert name in {f.name for f in dataclasses.fields(TrainConfig)}, name
    assert (cfg.refresh_size, cfg.table_decay, cfg.refresh_mode) == (64, 0.98, "sync")


@pytest.mark.parametrize("field,kw", [
    # The scoretable sampler and the fused ingest are ported; their async
    # refresh and a fused ingest without the noniid augmentation are not.
    pytest.param("refresh_mode", dict(sampler="scoretable", refresh_mode="async"),
                 id="sampler-scoretable"),
    pytest.param("fused_input", dict(fused_input=True, augmentation="none"),
                 id="fused_input-True"),
    pytest.param("world_size", dict(world_size=2), id="world_size-2"),
    pytest.param("model", dict(model="vgg11"), id="model-vgg11"),
    pytest.param("augmentation", dict(augmentation="iid"), id="augmentation-iid"),
    pytest.param("dataset", dict(dataset="cifar100"), id="dataset-cifar100"),
])
def test_config_rejects_what_is_not_ported(field, kw):
    with pytest.raises(ValueError, match=field):
        TrainConfig(**{"world_size": 1, **kw})


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
    out = tr.fit(1)
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
