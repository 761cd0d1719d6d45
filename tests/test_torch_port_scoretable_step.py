"""One scoretable step with the fused uint8 ingest, the port's against the
JAX package's ``make_train_step`` (``sampler="scoretable"``,
``fused_input=True``, ``use_pallas=True``), from the same weights, table,
EMA and random draws, in float32 on the CPU; and a short CPU fit of that
configuration.

The port's draws are the JAX step's: its key ``state.rng[0]`` split 8 ways
(``mercury_tpu/train/step.py:855-856``); the refresh window's crops and
flips from ``k_aug`` and the train batch's from ``k_aug2``, each split 3
ways into ``randint`` offsets and ``bernoulli`` flips as
``augment_normalize_pallas`` draws them; the draw's ``uniform(k_sel, (1,
B))``. On the CPU the JAX fused ingest runs its native op chain (XLA's
arithmetic, last-bit differences from the port's) and the table kernel in
interpret mode. Tiny sizes: a [1, 1]-stage ResNet of width 8, batch 4, a
refresh window of 8, 64 images.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from mercury_tpu.config import TrainConfig as JConfig  # noqa: E402
from mercury_tpu.models import resnet as jres  # noqa: E402
from mercury_tpu.parallel.mesh import host_cpu_mesh  # noqa: E402
from mercury_tpu.train import state as jstate  # noqa: E402
from mercury_tpu.train.step import make_train_step as jmake_train_step  # noqa: E402
from mercury_tpu_torch import TrainConfig, Trainer  # noqa: E402
from mercury_tpu_torch.data import cifar  # noqa: E402
from mercury_tpu_torch.data.pipeline import make_sharded_dataset  # noqa: E402
from mercury_tpu_torch.models import resnet as tres  # noqa: E402
from mercury_tpu_torch.models.convert import params_from_flax, scoretable_from_jax  # noqa: E402
from mercury_tpu_torch.ops import launch_counts, reset_launch_counts  # noqa: E402
from mercury_tpu_torch.sampling.importance import EMAState  # noqa: E402
from mercury_tpu_torch.train.state import create_state  # noqa: E402
from mercury_tpu_torch.train.step import Draws, make_draws, make_train_step  # noqa: E402

B, R, N_TRAIN, STEPS = 4, 8, 64, 10
MEAN, STD = cifar.CIFAR10_MEAN, cifar.CIFAR10_STD
COMMON = dict(dataset="synthetic", world_size=1, batch_size=B, sampler="scoretable",
              refresh_size=R, fused_input=True, compute_dtype="float32",
              num_epochs=1, steps_per_epoch=STEPS, seed=0)


def _np_tree(tree):
    return jax.tree_util.tree_map(lambda a: np.array(a), tree)


def _augment_draws(key, n):
    k_crop, k_flip, _ = jax.random.split(key, 3)
    return (torch.tensor(np.array(jax.random.randint(k_crop, (n, 2), 0, 9), np.int32)),
            torch.tensor(np.array(jax.random.bernoulli(k_flip, shape=(n,)))))


@pytest.fixture(scope="module")
def steps():
    """The JAX step and the port's, each from the same starting values."""
    (x, y), (xt, yt) = cifar.synthetic_cifar(10, N_TRAIN, 8, seed=0)
    jm = jres.ResNet(stage_sizes=[1, 1], block_cls=jres.BasicBlock,
                     num_classes=10, num_filters=8, compute_dtype=jnp.float32)
    jcfg = JConfig(model="resnet18", use_pallas=True, telemetry=False, **COMMON)
    tx = jstate.make_optimizer("adam", jcfg.lr, STEPS)
    js = jstate.create_state(jax.random.key(0), jm, tx,
                             jnp.zeros((1, 32, 32, 3), jnp.float32), 1, N_TRAIN,
                             with_scoretable=True)
    snap = dict(params=_np_tree(js.params), stats=_np_tree(js.batch_stats),
                ema=float(js.ema.value[0]), scores=np.array(js.scoretable.scores[0]),
                cursor=np.array(js.scoretable.cursor[0]), rng=js.rng[0])
    _, k_aug, k_sel, k_aug2 = jax.random.split(snap["rng"], 8)[:4]
    crop, flip = _augment_draws(k_aug, R)
    crop2, flip2 = _augment_draws(k_aug2, B)
    draws = Draws(perm=None, crop=crop, flip=flip, crop2=crop2, flip2=flip2,
                  uniforms=torch.tensor(np.array(jax.random.uniform(k_sel, (1, B),
                                                                    jnp.float32))))

    tm = tres.ResNet([1, 1], tres.BasicBlock, num_classes=10, num_filters=8)
    tm.load_state_dict(params_from_flax(snap["params"], snap["stats"]))
    dataset = make_sharded_dataset((x, y), (xt, yt), [np.arange(N_TRAIN)], MEAN,
                                   STD, 10, device=torch.device("cpu"))
    tcfg = TrainConfig(**COMMON)
    ts = create_state(tm, "cpu", 0, N_TRAIN, "adam", tcfg.lr, STEPS,
                      with_scoretable=True)
    ts.scoretable = scoretable_from_jax(snap["scores"], snap["cursor"])
    ts.ema = EMAState(torch.tensor(snap["ema"]), torch.tensor(0, dtype=torch.int32))
    stream_before = ts.stream
    reset_launch_counts()
    tmetrics = make_train_step(tcfg, dataset)(ts, draws)
    counts = dict(launch_counts)

    step_fn = jmake_train_step(jm, tx, jcfg, host_cpu_mesh(1), MEAN, STD)
    shard = jnp.asarray(np.arange(N_TRAIN, dtype=np.int32)[None, :])
    new_js, jmetrics = step_fn(js, jnp.asarray(x), jnp.asarray(y), shard)
    return dict(ts=ts, tmetrics=tmetrics, counts=counts, js=new_js,
                jmetrics=jmetrics, lr=jcfg.lr, stream_before=stream_before)


def test_loss_and_window_loss_match(steps):
    tm, jm = steps["tmetrics"], steps["jmetrics"]
    np.testing.assert_allclose(float(tm["train/loss"]), float(jm["train/loss"]), rtol=1e-5)
    np.testing.assert_allclose(float(tm["train/pool_loss"]),
                               float(jm["train/pool_loss"]), rtol=1e-5)


def test_table_and_cursor_match(steps):
    """Decayed slots, the refresh window's scores and the trained slots'
    write-back: float32 values from two frameworks' forwards and NLLs."""
    ts, js = steps["ts"], steps["js"]
    want = np.asarray(js.scoretable.scores[0])
    got = ts.scoretable.scores.numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    assert ts.scoretable.cursor == int(js.scoretable.cursor[0]) == R
    selected = steps["tmetrics"]["sampler/selected"]
    assert selected.shape == (B,) and int(selected.max()) < N_TRAIN
    decayed_only = np.setdiff1d(np.arange(N_TRAIN),
                                np.concatenate([np.arange(R), selected.numpy()]))
    assert len(decayed_only) > 0 and np.all(got[decayed_only] == got[decayed_only[0]])


def test_parameters_match(steps):
    """As in test_torch_port_step: Adam's first update is ≈ lr·sign(g), so
    parameters agree to 2·lr; the BN running statistics closely."""
    js = steps["js"]
    expect = params_from_flax(_np_tree(js.params), _np_tree(js.batch_stats))
    got = steps["ts"].model.state_dict()
    lr = steps["lr"]
    for name, want in expect.items():
        if "running_" in name:
            np.testing.assert_allclose(got[name].numpy(), want.numpy(),
                                       rtol=1e-5, atol=1e-6, err_msg=name)
        else:
            np.testing.assert_allclose(got[name].numpy(), want.numpy(),
                                       atol=2 * lr, err_msg=name)


def test_step_leaves_the_stream_and_launches_nothing_on_cpu(steps):
    ts = steps["ts"]
    assert ts.step == 1 and int(ts.ema.count) == 1
    assert ts.stream is steps["stream_before"]
    assert set(steps["counts"].values()) == {0}


def _tiny(**kw):
    base = dict(COMMON, eval_every=0, log_every=0, steps_per_epoch=6)
    base.update(kw)
    model = tres.ResNet([1, 1], tres.BasicBlock, num_classes=10, num_filters=8)
    tres.init_weights(model, torch.Generator().manual_seed(0))
    return Trainer(TrainConfig(**base), device="cpu", model=model)


@pytest.mark.parametrize("sampler", ["scoretable", "pool"])
def test_cpu_fit_with_fused_ingest(sampler):
    tr = _tiny(sampler=sampler, presample_batches=4)
    assert (tr.state.scoretable is not None) == (sampler == "scoretable")
    losses = [float(tr.train_step()["train/loss"]) for _ in range(4)]
    assert all(np.isfinite(losses))
    out = tr.fit(1)
    assert np.isfinite(out["train/loss"]) and tr.state.step == 5
    if sampler == "scoretable":
        assert tr.state.scoretable.cursor == 5 * R
        assert torch.isfinite(tr.state.scoretable.scores).all()


def test_draws_and_clone_carry_the_table():
    tr = _tiny()
    d = make_draws(tr.state, tr.config)
    assert d.perm is None and d.crop.shape == (R, 2) and d.flip.shape == (R,)
    assert d.crop2.shape == (B, 2) and d.flip2.shape == (B,) and d.uniforms.shape == (1, B)
    assert d.crop.dtype == torch.int32 and d.flip.dtype == torch.bool
    copy = tr.state.clone()
    tr.train_step()
    assert copy.scoretable.cursor == 0 and tr.state.scoretable.cursor == R
    assert torch.equal(copy.scoretable.scores, torch.ones_like(copy.scoretable.scores))


def test_kernel_and_plain_steps_agree_on_cpu():
    """use_kernels=False swaps every wrapper for its plain version; on the
    CPU both are the plain versions, so the two steps are identical."""
    tr = _tiny()
    draws = make_draws(tr.state, tr.config)
    state = tr.state
    out = {}
    for use_kernels in (True, False):
        tr.state = state.clone()
        out[use_kernels] = (tr.train_step(draws, use_kernels=use_kernels),
                            tr.state.scoretable.scores)
    assert torch.equal(out[True][0]["sampler/selected"], out[False][0]["sampler/selected"])
    assert float(out[True][0]["train/loss"]) == float(out[False][0]["train/loss"])
    assert torch.equal(out[True][1], out[False][1])


@pytest.mark.parametrize("kw,field", [
    (dict(refresh_mode="async"), "refresh_mode"),
    (dict(refresh_mode="weird"), "refresh_mode"),
    (dict(fused_input=True, augmentation="none"), "fused_input"),
    (dict(refresh_size=0), "refresh_size"),
    (dict(table_decay=1.5), "table_decay"),
    (dict(scoring_dtype="bfloat16"), "scoring_dtype"),
    (dict(sampler="groupwise"), "sampler"),
])
def test_config_rejections(kw, field):
    base = dict(world_size=1, sampler="scoretable")
    base.update(kw)
    with pytest.raises(ValueError, match=field):
        TrainConfig(**base)
