"""Whole steps and ``fit`` of the port's config surface against the JAX
package's, on the CPU.

Steps: the JAX package's ``make_train_step`` (telemetry on) and the port's,
from the same weights, stream or table, EMA and random draws, in float32, at
the tiny sizes of ``test_torch_port_step.py``: a [1, 1]-stage ResNet of
width 8, batch 4, a pool of 16 (or a table of 64 slots with a window of 8),
64 images of 10 or 100 synthetic classes. The port's draws are the JAX
step's: its key split 8 ways (``mercury_tpu/train/step.py:855-856``), the
augmentation's offsets, flips, angles, scales and cutout centres from
``k_aug`` (and ``k_aug2``) as the JAX functions draw them, and the draw's
``uniform(k_sel, (1, B))`` where the JAX step runs its kernels (in
interpret mode). With ``use_pallas=False`` the JAX step draws by
``jax.random.categorical(k_sel, log p)``: the port is then fed that draw as
uniforms at the middle of each drawn index's CDF interval. Tolerances are
those files': losses, ESS, clip share and drift rtol 1e-5, the gradient's
norm and ``var_ratio`` rtol 1e-4, the table rtol 1e-5 and atol 1e-6,
parameters after Adam's first update within 2·lr, histograms and the
ledger exactly.

``fit``: the JAX ``Trainer`` (``model="smallcnn"``) and the port's (a tiny
ResNet; the horizon does not depend on the model) take the same number of
steps in every branch of the horizon.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from mercury_tpu.config import TrainConfig as JConfig  # noqa: E402
from mercury_tpu.data import pipeline as jpipe  # noqa: E402
from mercury_tpu.data import transforms as jtr  # noqa: E402
from mercury_tpu.models import resnet as jres  # noqa: E402
from mercury_tpu.obs import sampler_health as jsh  # noqa: E402
from mercury_tpu.ops import score_and_draw_pallas  # noqa: E402
from mercury_tpu.parallel.mesh import host_cpu_mesh  # noqa: E402
from mercury_tpu.sampling import importance as jimp  # noqa: E402
from mercury_tpu.train import state as jstate  # noqa: E402
from mercury_tpu.train.step import make_train_step as jmake_train_step  # noqa: E402
from mercury_tpu_torch import TrainConfig, Trainer  # noqa: E402
from mercury_tpu_torch.data import cifar  # noqa: E402
from mercury_tpu_torch.data.pipeline import ShardStream, make_sharded_dataset  # noqa: E402
from mercury_tpu_torch.data.transforms import eval_transform_iid  # noqa: E402
from mercury_tpu_torch.models import resnet as tres  # noqa: E402
from mercury_tpu_torch.models.convert import params_from_flax, scoretable_from_jax  # noqa: E402
from mercury_tpu_torch.ops import launch_counts, reset_launch_counts  # noqa: E402
from mercury_tpu_torch.sampling.importance import EMAState  # noqa: E402
from mercury_tpu_torch.train.state import create_state  # noqa: E402
from mercury_tpu_torch.train.step import Augment, Draws, make_draws, make_train_step  # noqa: E402

B, PRESAMPLE, R, N_TRAIN, STEPS = 4, 4, 8, 64, 10
POOL = B * PRESAMPLE
MEAN, STD = cifar.CIFAR10_MEAN, cifar.CIFAR10_STD
COMMON = dict(dataset="synthetic", world_size=1, batch_size=B, presample_batches=PRESAMPLE,
              compute_dtype="float32", num_epochs=1, steps_per_epoch=STEPS, seed=0)
TABLE = dict(sampler="scoretable", refresh_size=R, fused_input=True)
GRAD_NORM = dict(importance_score="grad_norm")
SMOOTH = dict(label_smoothing=0.1, use_pallas=False)
# name: (config fields of both packages, classes, scoretable, JAX kernels)
CASES = {
    "grad_norm-pool": (GRAD_NORM, 100, False, True),
    "grad_norm-scoretable": ({**GRAD_NORM, **TABLE}, 100, True, True),
    "smoothing-plain": (SMOOTH, 10, False, False),
    "iid": (dict(augmentation="iid"), 10, False, True),
    "cutout": (dict(cutout=True), 10, False, True),
    "grad_norm-smoothing-probe": ({**GRAD_NORM, **SMOOTH, "variance_probe_every": 1}, 10,
                                  False, False),
}
SCALARS = ("train/loss", "train/pool_loss", "sampler/ess", "sampler/clip_frac",
           "sampler/ema_drift")


def _np_tree(tree):
    return jax.tree_util.tree_map(lambda a: np.array(a), tree)


def _offsets(key, n, hi):
    """``[n, 2]`` int32 offsets as ``random_crop_to_batch`` (or the cutout
    centres) draws them: rows from ``key``, columns from ``fold_in(key, 1)``."""
    oy = jax.random.randint(key, (n,), 0, hi + 1)
    ox = jax.random.randint(jax.random.fold_in(key, 1), (n,), 0, hi + 1)
    return torch.tensor(np.stack([np.asarray(oy), np.asarray(ox)], 1).astype(np.int32))


def _augment_draws(key, n, config):
    """What the JAX step's ``_augment`` (or its fused ingest) draws from
    ``key`` for ``n`` images."""
    k_crop, k_flip, k_third = jax.random.split(key, 3)
    out = {"flip": torch.tensor(np.asarray(jax.random.bernoulli(k_flip, shape=(n,))))}
    if config.augmentation == "iid":
        k1, k2 = jax.random.split(k_third)
        out["crop"] = _offsets(k_crop, n, 3)
        out["theta"] = torch.tensor(np.asarray(jnp.deg2rad(
            jax.random.uniform(k1, (n,), minval=-10.0, maxval=10.0))))
        out["scale"] = torch.tensor(np.asarray(
            jax.random.uniform(k2, (n,), minval=0.9, maxval=1.1)))
        return Augment(**out)
    out["crop"] = torch.tensor(np.asarray(jax.random.randint(k_crop, (n, 2), 0, 9), np.int32))
    if config.cutout:
        out["cut"] = _offsets(k_third, n, 31)
    return Augment(**out)


def _draws(rng, config):
    """The JAX step's draws from its key ``rng``, and its ``k_aug`` and
    ``k_sel``."""
    _, k_aug, k_sel, k_aug2 = jax.random.split(rng, 8)[:4]
    table = config.use_scoretable
    aug = _augment_draws(k_aug, R if table else POOL, config)
    aug2 = _augment_draws(k_aug2, B, config) if table else None
    uniforms = torch.tensor(np.array(jax.random.uniform(k_sel, (1, B), jnp.float32)))
    return Draws(perm=None, aug=aug, uniforms=uniforms, aug2=aug2), k_aug, k_sel


def _uniforms_for(probs, selected):
    """Uniforms that the inverse-CDF draw turns into ``selected``: the
    middle of each index's interval of the float64 CDF of ``probs``."""
    cdf = np.cumsum(probs.astype(np.float64))
    lo = np.concatenate([[0.0], cdf[:-1]])
    return torch.tensor(((lo[selected] + cdf[selected]) / 2).astype(np.float32))[None]


def _host(metrics):
    return {k: np.asarray(v) for k, v in metrics.items()}


def _run(kw, classes, table, jax_kernels):
    """One JAX step and the port's from the same values and draws."""
    (x, y), (xt, yt) = cifar.synthetic_cifar(classes, N_TRAIN, 8, seed=0)
    jm = jres.ResNet(stage_sizes=[1, 1], block_cls=jres.BasicBlock, num_classes=classes,
                     num_filters=8, compute_dtype=jnp.float32)
    jkw = {k: v for k, v in kw.items() if k != "use_pallas"}
    jcfg = JConfig(model="resnet18", use_pallas=jax_kernels, telemetry=True, **COMMON, **jkw)
    tx = jstate.make_optimizer("adam", jcfg.lr, STEPS)
    js = jstate.create_state(jax.random.key(0), jm, tx, jnp.zeros((1, 32, 32, 3), jnp.float32),
                             1, N_TRAIN, with_scoretable=table, with_sel_counts=table)
    snap = dict(params=_np_tree(js.params), stats=_np_tree(js.batch_stats),
                perm=np.array(js.stream.perm[0]), rng=js.rng[0])
    tcfg = TrainConfig(**COMMON, **kw)
    dataset = make_sharded_dataset((x, y), (xt, yt), [np.arange(N_TRAIN)], MEAN, STD, classes,
                                   device=torch.device("cpu"))
    ts = create_state(tres.ResNet([1, 1], tres.BasicBlock, num_classes=classes, num_filters=8),
                      "cpu", 0, N_TRAIN, "adam", tcfg.lr, STEPS, with_scoretable=table,
                      with_sel_counts=tcfg.use_ledger)
    ts.model.load_state_dict(params_from_flax(snap["params"], snap["stats"]))
    ts.ema = EMAState(torch.tensor(np.array(js.ema.value[0])),
                      torch.tensor(np.array(js.ema.count[0])))
    if table:
        ts.scoretable = scoretable_from_jax(np.array(js.scoretable.scores[0]),
                                            np.array(js.scoretable.cursor[0]))
    else:
        ts.stream = ShardStream(torch.tensor(snap["perm"], dtype=torch.long),
                                int(js.stream.cursor[0]))
    draws, k_aug, k_sel = _draws(snap["rng"], tcfg)
    tstep = make_train_step(tcfg, dataset)
    if not jax_kernels:
        # The JAX step's categorical draw over the same distribution.
        probs = tstep(ts.clone(), draws)["sampler/probs"].numpy()
        selected = np.asarray(jax.random.categorical(k_sel, jnp.log(jnp.asarray(probs)),
                                                     shape=(B,)))
        draws = draws._replace(uniforms=_uniforms_for(probs, selected))
    reset_launch_counts()
    tmetrics = _host(tstep(ts, draws))
    counts = dict(launch_counts)
    step_fn = jmake_train_step(jm, tx, jcfg, host_cpu_mesh(1), MEAN, STD)
    shard = jnp.asarray(np.arange(N_TRAIN, dtype=np.int32)[None, :])
    new_js, jmetrics = step_fn(js, jnp.asarray(x), jnp.asarray(y), shard)
    return dict(port=tmetrics, jax=_host(jmetrics), ts=ts, js=new_js, lr=jcfg.lr,
                snap=snap, x=x, y=y, jm=jm, draws=draws, k_aug=k_aug, k_sel=k_sel,
                counts=counts)


_RUNS = {}


@pytest.fixture(params=list(CASES), scope="module")
def run(request):
    if request.param not in _RUNS:
        _RUNS[request.param] = _run(*CASES[request.param])
    return _RUNS[request.param]


def _check_draws(out):
    """Each uniform lies outside the boundary band of the CDF's summation
    order (see test_torch_port_ops), so both sides drew the same batch."""
    probs = out["port"]["sampler/probs"].astype(np.float64)
    u = out["draws"].uniforms.numpy()[0]
    assert np.min(np.abs(np.cumsum(probs)[None, :] - u[:, None])) > 1e-6


def test_step_metrics_match_jax(run):
    _check_draws(run)
    tm, jm = run["port"], run["jax"]
    for key in SCALARS:
        np.testing.assert_allclose(tm[key], jm[key], rtol=1e-5, err_msg=key)
    np.testing.assert_allclose(tm["train/grad_norm"], jm["train/grad_norm"], rtol=1e-4)
    for key in jsh.hist_keys("w_hist"):
        assert tm[key] == jm[key], key
    assert set(run["counts"].values()) == {0}  # the CPU launches no kernel


def test_parameters_match_jax(run):
    """Adam's first update is ≈ lr·sign(g): parameters agree to 2·lr, the
    BN running statistics closely (as in test_torch_port_step)."""
    js = run["js"]
    expect = params_from_flax(_np_tree(js.params), _np_tree(js.batch_stats))
    got = run["ts"].model.state_dict()
    for name, want in expect.items():
        if "running_" in name:
            np.testing.assert_allclose(got[name].numpy(), want.numpy(),
                                       rtol=1e-5, atol=1e-6, err_msg=name)
        else:
            np.testing.assert_allclose(got[name].numpy(), want.numpy(),
                                       atol=2 * run["lr"], err_msg=name)


def _case(name):
    if name not in _RUNS:
        _RUNS[name] = _run(*CASES[name])
    return _RUNS[name]


def test_grad_norm_pool_selection_and_pool_loss():
    """The JAX pool branch composed from the package's functions: the
    scores are gradient norms of the pool's logits, the draw the kernel's
    from those scores, and ``train/pool_loss`` the mean NLL, not the mean
    score."""
    out = _case("grad_norm-pool")
    snap = out["snap"]
    slots = snap["perm"][:POOL]
    raw, labs = jnp.asarray(out["x"][slots]), jnp.asarray(out["y"][slots])
    imgs = jpipe.augment_batch(out["k_aug"], jpipe.normalize_images(raw, MEAN, STD))
    logits, _ = out["jm"].apply({"params": snap["params"], "batch_stats": snap["stats"]},
                                imgs, train=True, mutable=["batch_stats"])
    scores = jimp.per_sample_grad_norm_bound(logits, labs)
    ema = jimp.ema_update(jimp.init_ema(), jimp.pool_mean(scores), 0.9)
    _, selected, _ = score_and_draw_pallas(out["k_sel"], scores, ema.value, B, 0.5)
    np.testing.assert_array_equal(out["port"]["sampler/selected"], np.asarray(selected))
    mean_nll = float(jimp.pool_mean(jimp.per_sample_loss(logits, labs)))
    np.testing.assert_allclose(out["port"]["train/pool_loss"], mean_nll, rtol=1e-5)
    assert abs(mean_nll - float(jimp.pool_mean(scores))) > 1.0  # ln 100 against ≤ √2


def test_grad_norm_table_write_back_and_ledger():
    """The written-back table (gradient norms of the trained slots) and the
    ledger of the drawn slots equal the JAX step's."""
    out = _case("grad_norm-scoretable")
    ts, js = out["ts"], out["js"]
    np.testing.assert_allclose(ts.scoretable.scores.numpy(), np.asarray(js.scoretable.scores[0]),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(ts.sel_counts.numpy(), np.asarray(js.sel_counts[0]))
    selected = out["port"]["sampler/selected"]
    written = ts.scoretable.scores.numpy()[selected]
    assert np.all(written <= np.sqrt(2) + 1e-6)  # norms, not losses (≈ ln 100)
    assert ts.scoretable.cursor == int(js.scoretable.cursor[0]) == R


def test_probe_carries_the_smoothing():
    out = _case("grad_norm-smoothing-probe")
    tm, jm = out["port"], out["jax"]
    assert float(jm["sampler_dist/var_ratio"]) > 0
    np.testing.assert_allclose(tm["sampler_dist/var_ratio"], jm["sampler_dist/var_ratio"],
                               rtol=1e-4)


# ------------------------------------------------------------------ the port alone
def _tiny(classes=10, **kw):
    base = dict(COMMON, eval_every=0, log_every=0, steps_per_epoch=8)
    base.update(kw)
    model = tres.ResNet([1, 1], tres.BasicBlock, num_classes=classes, num_filters=8)
    tres.init_weights(model, torch.Generator().manual_seed(0))
    return Trainer(TrainConfig(**base), device="cpu", model=model)


def test_plain_route_is_todays_plain_step():
    """``use_pallas=False`` with no smoothing is the step's plain route
    (``use_kernels=False``) bit for bit, metrics and parameters; its
    forward numbers are the default step's."""
    trainers = {"plain": _tiny(use_pallas=False), "default": _tiny()}
    draws = make_draws(trainers["default"].state, trainers["default"].config)
    start = trainers["default"].state.clone()
    out = {"plain": trainers["plain"].train_step(draws),
           "unfused": trainers["default"].train_step(draws, use_kernels=False)}
    params = {k: list(t.state.model.parameters()) for k, t in
              (("plain", trainers["plain"]), ("unfused", trainers["default"]))}
    trainers["default"].state = start
    out["default"] = trainers["default"].train_step(draws)
    assert out["plain"].keys() == out["unfused"].keys()
    for key in out["plain"]:
        assert torch.equal(out["plain"][key], out["unfused"][key]), key
    for a, b in zip(params["plain"], params["unfused"]):
        assert torch.equal(a, b)
    for key in ("train/loss", "train/pool_loss", "sampler/selected", "sampler/probs",
                "sampler/ess", "sampler/clip_frac", "sampler/ema_drift"):
        assert torch.equal(out["plain"][key], out["default"][key]), key


def test_smoothing_with_the_kernels_raises():
    with pytest.raises(ValueError, match="use_pallas requires label_smoothing == 0"):
        _tiny(label_smoothing=0.1, use_pallas=True)
    tr = _tiny(label_smoothing=0.1)  # use_pallas=None on the CPU: the plain versions
    reset_launch_counts()
    assert np.isfinite(float(tr.train_step()["train/loss"]))
    assert set(launch_counts.values()) == {0}


@pytest.mark.parametrize("kw,field", [
    (dict(fused_input=True, cutout=True), "fused_input"),
    (dict(fused_input=True, augmentation="iid"), "fused_input"),
    (dict(importance_score="hessian"), "importance_score"),
    (dict(augmentation="autoaugment"), "augmentation"),
    (dict(model="resnet200"), "model"),
])
def test_config_refuses_what_jax_refuses(kw, field):
    with pytest.raises(ValueError, match=field):
        TrainConfig(world_size=1, **kw)


@pytest.mark.parametrize("kw,extra", [
    (dict(augmentation="iid"), {"theta", "scale"}),
    (dict(cutout=True), {"cut"}),
    (dict(augmentation="iid", cutout=True), {"theta", "scale"}),
    (dict(augmentation="none", cutout=True), set()),
    ({**TABLE, "fused_input": False, "augmentation": "iid"}, {"theta", "scale"}),
    ({**TABLE, "fused_input": False, "cutout": True}, {"cut"}),
])
def test_draws_of_each_augmentation(kw, extra):
    """What ``make_draws`` draws for each ingest (the scoretable's two), in
    JAX's ranges; cutout rides on noniid only, as the JAX step's
    ``_augment`` applies it; each step runs, and refuses draws that lack
    what its augmentation needs."""
    tr = _tiny(**kw)
    d = make_draws(tr.state, tr.config)
    augs = {"aug": d.aug, "aug2": d.aug2} if tr.config.use_scoretable else {"aug": d.aug}
    assert d.aug2 is None or tr.config.use_scoretable
    for aug in augs.values():
        assert {k for k, v in aug._asdict().items() if v is not None} == {"crop", "flip"} | extra
        hi = 3 if tr.config.augmentation == "iid" else 8
        assert (int(aug.crop.min()) >= 0 and int(aug.crop.max()) <= hi
                and aug.crop.dtype == torch.int32)
        if aug.theta is not None:
            assert float(aug.theta.abs().max()) <= np.deg2rad(10.0) + 1e-7
            assert 0.9 <= float(aug.scale.min()) and float(aug.scale.max()) <= 1.1
        if aug.cut is not None:
            assert aug.cut.shape == (aug.crop.shape[0], 2) and int(aug.cut.max()) < 32
    assert np.isfinite(float(tr.train_step(d)["train/loss"]))
    for name, aug in augs.items():
        if extra:
            with pytest.raises(ValueError, match="draws"):
                tr.train_step(d._replace(**{name: aug._replace(**{k: None for k in extra})}))


def test_iid_evaluation_crops_as_jax_with_its_offsets():
    """Under ``augmentation="iid"`` ``predict`` (and ``evaluate``) resize
    to 33 and crop at ``eval_crop``, one set of offsets for every batch:
    given the JAX package's offsets (``jax.random.key(0)``), the logits of
    the JAX model on the JAX transform."""
    jm = jres.ResNet(stage_sizes=[1, 1], block_cls=jres.BasicBlock, num_classes=10,
                     num_filters=8, compute_dtype=jnp.float32)
    variables = jm.init(jax.random.key(1), jnp.zeros((1, 32, 32, 3)), train=False)
    model = tres.ResNet([1, 1], tres.BasicBlock, num_classes=10, num_filters=8)
    model.load_state_dict(params_from_flax(variables["params"], variables["batch_stats"]))
    tr = Trainer(TrainConfig(**COMMON, augmentation="iid"), device="cpu", model=model)
    assert tr.eval_crop.shape == (256, 2) and int(tr.eval_crop.max()) <= 1
    tr.eval_crop = _offsets(jax.random.key(0), 256, 1)
    raw = tr.dataset.x_test[:256].numpy()
    want = jm.apply(variables, jtr.eval_transform_iid(
        jax.random.key(0), jpipe.normalize_images(jnp.asarray(raw), MEAN, STD)), train=False)
    np.testing.assert_allclose(tr.predict(raw).numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)
    ev = tr.evaluate(include_train=False)
    acc = float((tr.predict(tr.dataset.x_test).argmax(-1) == tr.dataset.y_test.long()).double()
                .mean())
    assert ev["test/eval_acc"] == acc
    images = eval_transform_iid(torch.zeros(3, 32, 32, 3), tr.eval_crop[:3])
    assert images.shape == (3, 32, 32, 3)


# ------------------------------------------------------------------ fit
FIT = dict(dataset="synthetic", world_size=1, steps_per_epoch=2, num_epochs=1,
           checkpoint_every=0, log_every=0, eval_every=0)


def _fit_sequence(make):
    """The steps after each call of the horizon's branches, for a Trainer
    factory ``make(**config fields)`` of either package."""
    import tempfile

    steps = {}
    with tempfile.TemporaryDirectory() as d:
        t = make(checkpoint_dir=d)
        out = t.fit()
        steps["first"] = int(t.state.step)
        steps["first returns"] = sorted(k for k in out if k.startswith("test/"))
        t.fit()
        steps["second"] = int(t.state.step)
        t.restore(step=2)
        t.fit()
        steps["after restore"] = int(t.state.step)
        resumed = make(checkpoint_dir=d, auto_resume=True, num_epochs=3)
        steps["auto-resumed at"] = int(resumed.state.step)
        resumed.fit()
        steps["first after resume"] = int(resumed.state.step)
        resumed.fit()
        steps["second after resume"] = int(resumed.state.step)
        for trainer in (t, resumed):
            if hasattr(trainer, "close"):
                trainer.close()
    budget = make(steps_per_epoch=4, num_epochs=2, step_budget=3)
    out = budget.fit()
    steps["budget"] = int(budget.state.step)
    steps["budget returns"] = sorted(k for k in out if k.startswith("test/"))
    if hasattr(budget, "close"):
        budget.close()
    return steps


@pytest.fixture(scope="module")
def jax_fit_steps():
    from mercury_tpu.train import Trainer as JTrainer

    return _fit_sequence(lambda **kw: JTrainer(JConfig(model="smallcnn", **{**FIT, **kw})))


def test_fit_horizon_matches_jax(jax_fit_steps):
    def make(**kw):
        model = tres.ResNet([1, 1], tres.BasicBlock, num_classes=10, num_filters=4)
        tres.init_weights(model, torch.Generator().manual_seed(0))
        cfg = TrainConfig(batch_size=4, presample_batches=2, compute_dtype="float32",
                          **{**FIT, **kw})
        return Trainer(cfg, device="cpu", model=model)

    assert _fit_sequence(make) == jax_fit_steps
    assert jax_fit_steps["first"] == 2 and jax_fit_steps["second"] == 4
    assert jax_fit_steps["after restore"] == 4
    assert (jax_fit_steps["first after resume"], jax_fit_steps["second after resume"]) == (6, 12)
    assert jax_fit_steps["budget"] == 4
    assert jax_fit_steps["budget returns"] == ["test/eval_acc", "test/eval_loss"]


def test_fit_steps_runs_k_steps_under_the_budget():
    tr = _tiny(step_budget=5)
    out = tr.fit(steps=3)
    assert tr.state.step == 3 and {"test/eval_acc", "train/loss"} <= set(out)
    tr.fit(steps=10)
    assert tr.state.step == 6  # int(5 // 1) + 1
    tr.fit(num_epochs=1)
    assert tr.state.step == 6
