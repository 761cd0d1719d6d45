"""One importance-sampled step of the port against the JAX package's, from
the same weights, stream, EMA and random draws, in float32 on the CPU.

The port's draws are the JAX step's: its key ``state.rng[0]`` split 8 ways
(``mercury_tpu/train/step.py:855-856``), the crop offsets and flips that
``augment_batch`` draws from ``k_aug``, and the draw's
``uniform(k_sel, (1, B))``. The JAX side runs with ``use_pallas=True``, its
kernels in interpret mode. Tiny sizes: a [1, 1]-stage ResNet of width 8,
batch 4, a pool of 16, 64 images.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from mercury_tpu.config import TrainConfig as JConfig  # noqa: E402
from mercury_tpu.data import pipeline as jpipe  # noqa: E402
from mercury_tpu.models import resnet as jres  # noqa: E402
from mercury_tpu.ops import per_sample_nll_pallas, score_and_draw_pallas  # noqa: E402
from mercury_tpu.parallel.mesh import host_cpu_mesh  # noqa: E402
from mercury_tpu.sampling import importance as jimp  # noqa: E402
from mercury_tpu.train import state as jstate  # noqa: E402
from mercury_tpu.train.step import make_train_step as jmake_train_step  # noqa: E402
from mercury_tpu_torch.config import TrainConfig  # noqa: E402
from mercury_tpu_torch.data import cifar  # noqa: E402
from mercury_tpu_torch.data.pipeline import ShardStream, make_sharded_dataset  # noqa: E402
from mercury_tpu_torch.models import resnet as tres  # noqa: E402
from mercury_tpu_torch.models.convert import params_from_flax  # noqa: E402
from mercury_tpu_torch.sampling.importance import EMAState  # noqa: E402
from mercury_tpu_torch.train.state import create_state  # noqa: E402
from mercury_tpu_torch.train.step import Augment, Draws, make_train_step  # noqa: E402

B, PRESAMPLE, N_TRAIN, STEPS = 4, 4, 64, 10
POOL = B * PRESAMPLE
MEAN, STD = cifar.CIFAR10_MEAN, cifar.CIFAR10_STD


def _jax_config():
    return JConfig(model="resnet18", dataset="synthetic", world_size=1,
                   batch_size=B, presample_batches=PRESAMPLE, use_pallas=True,
                   telemetry=False, compute_dtype="float32", num_epochs=1,
                   steps_per_epoch=STEPS, seed=0)


def _torch_config():
    return TrainConfig(dataset="synthetic", world_size=1, batch_size=B,
                       presample_batches=PRESAMPLE, compute_dtype="float32",
                       num_epochs=1, steps_per_epoch=STEPS, seed=0)


def _np_tree(tree):
    return jax.tree_util.tree_map(lambda a: np.array(a), tree)


@pytest.fixture(scope="module")
def setup():
    """The JAX model, state and data, copied to numpy before any step can
    donate them, and the port's state built from the same values."""
    (x, y), (xt, yt) = cifar.synthetic_cifar(10, N_TRAIN, 8, seed=0)
    jm = jres.ResNet(stage_sizes=[1, 1], block_cls=jres.BasicBlock,
                     num_classes=10, num_filters=8, compute_dtype=jnp.float32)
    jcfg = _jax_config()
    tx = jstate.make_optimizer("adam", jcfg.lr, STEPS)
    jst = jstate.create_state(jax.random.key(0), jm, tx,
                              jnp.zeros((1, 32, 32, 3), jnp.float32), 1, N_TRAIN)
    snap = dict(params=_np_tree(jst.params), stats=_np_tree(jst.batch_stats),
                perm=np.array(jst.stream.perm[0]), ema=float(jst.ema.value[0]),
                rng=jst.rng[0])
    keys = jax.random.split(snap["rng"], 8)
    k_aug, k_sel = keys[1], keys[2]
    k_crop, k_flip, _ = jax.random.split(k_aug, 3)
    draws = Draws(
        perm=None,  # cursor 0 + pool 16 <= 64: no reshuffle this step
        aug=Augment(crop=torch.tensor(np.array(jax.random.randint(k_crop, (POOL, 2), 0, 9))),
                    flip=torch.tensor(np.array(jax.random.bernoulli(k_flip, shape=(POOL,))))),
        uniforms=torch.tensor(np.array(jax.random.uniform(k_sel, (1, B), jnp.float32))),
    )

    tm = tres.ResNet([1, 1], tres.BasicBlock, num_classes=10, num_filters=8)
    tm.load_state_dict(params_from_flax(snap["params"], snap["stats"]))
    dataset = make_sharded_dataset((x, y), (xt, yt), [np.arange(N_TRAIN)], MEAN,
                                   STD, 10, device=torch.device("cpu"))
    tcfg = _torch_config()
    tst = create_state(tm, "cpu", 0, N_TRAIN, "adam", tcfg.lr, STEPS)
    tst.stream = ShardStream(perm=torch.tensor(snap["perm"], dtype=torch.long), cursor=0)
    tst.ema = EMAState(torch.tensor(snap["ema"]), torch.tensor(0, dtype=torch.int32))
    metrics = make_train_step(tcfg, dataset)(tst, draws)
    return dict(x=x, y=y, jm=jm, jst=jst, jcfg=jcfg, tx=tx, snap=snap,
                k_aug=k_aug, k_sel=k_sel, tst=tst, metrics=metrics)


@pytest.fixture(scope="module")
def composed(setup):
    """The JAX step's pool branch composed by hand from the package's own
    functions (``next_pool``, ``augment_batch``, the interpret-mode Pallas
    kernels), with its loss and gradient."""
    s = setup
    jm, snap = s["jm"], s["snap"]
    slots = snap["perm"][:POOL]
    raw, labs = jnp.asarray(s["x"][slots]), jnp.asarray(s["y"][slots])
    imgs = jpipe.augment_batch(s["k_aug"], jpipe.normalize_images(raw, MEAN, STD))
    variables = {"params": snap["params"], "batch_stats": snap["stats"]}
    pool_logits, _ = jm.apply(variables, imgs, train=True, mutable=["batch_stats"])
    pool_losses = per_sample_nll_pallas(pool_logits, labs)
    avg = jimp.pool_mean(pool_losses)
    ema = jimp.ema_update(jimp.init_ema(), avg, 0.9)
    probs, selected, scaled = score_and_draw_pallas(
        s["k_sel"], pool_losses, ema.value, B, 0.5)
    sel_images, sel_labels = imgs[selected], labs[selected]

    def loss_fn(params):
        logits, _ = jm.apply({"params": params, "batch_stats": snap["stats"]},
                             sel_images, train=True, mutable=["batch_stats"])
        return jimp.reweighted_loss(per_sample_nll_pallas(logits, sel_labels), scaled)

    loss, grads = jax.value_and_grad(loss_fn)(snap["params"])
    return dict(probs=np.asarray(probs), selected=np.asarray(selected),
                avg=float(avg), loss=float(loss), grads=_np_tree(grads))


def test_selection_matches(setup, composed):
    m = setup["metrics"]
    cdf = np.cumsum(composed["probs"].astype(np.float64))
    uniforms = np.asarray(
        jax.random.uniform(setup["k_sel"], (1, B), jnp.float32))[0]
    # Boundary band of the CDF summation order (see test_torch_port_ops).
    assert np.min(np.abs(cdf[None, :] - uniforms[:, None])) > 1e-6
    np.testing.assert_array_equal(m["sampler/selected"].numpy(), composed["selected"])
    # The same mean of float32 losses from two frameworks' forwards.
    np.testing.assert_allclose(float(m["train/pool_loss"]), composed["avg"], rtol=1e-5)


def test_loss_and_gradients_match(setup, composed):
    np.testing.assert_allclose(float(setup["metrics"]["train/loss"]),
                               composed["loss"], rtol=1e-5)
    expect = params_from_flax(composed["grads"], setup["snap"]["stats"])
    got = dict(setup["tst"].model.named_parameters())
    for name, param in got.items():
        # Float32 gradients through convolutions and batch statistics,
        # summed in another order by XLA and ATen.
        np.testing.assert_allclose(param.grad.numpy(), expect[name].numpy(),
                                   rtol=1e-3, atol=1e-5, err_msg=name)


def test_state_advances(setup):
    tst = setup["tst"]
    assert tst.step == 1 and tst.stream.cursor == POOL
    assert int(tst.ema.count) == 1


def test_full_step_matches_make_train_step(setup):
    """The whole JAX step (``make_train_step`` on a world-1 CPU mesh)
    against the port's: loss, pool loss, parameters after Adam and the BN
    running statistics. Adam's first update is ≈ lr·sign(g), so where g is
    near 0 a last-bit difference in g flips the update's sign: parameters
    agree to 2·lr, not better."""
    s = setup
    mesh = host_cpu_mesh(1)
    step_fn = jmake_train_step(s["jm"], s["tx"], s["jcfg"], mesh, MEAN, STD)
    shard = jnp.asarray(np.arange(N_TRAIN, dtype=np.int32)[None, :])
    new_state, jm = step_fn(s["jst"], jnp.asarray(s["x"]),
                            jnp.asarray(s["y"]), shard)
    tm = s["metrics"]
    np.testing.assert_allclose(float(tm["train/loss"]), float(jm["train/loss"]), rtol=1e-5)
    np.testing.assert_allclose(float(tm["train/pool_loss"]),
                               float(jm["train/pool_loss"]), rtol=1e-5)
    expect = params_from_flax(_np_tree(new_state.params), _np_tree(new_state.batch_stats))
    got = s["tst"].model.state_dict()
    lr = s["jcfg"].lr
    for name, want in expect.items():
        if "running_" in name:
            np.testing.assert_allclose(got[name].numpy(), want.numpy(),
                                       rtol=1e-5, atol=1e-6, err_msg=name)
        else:
            np.testing.assert_allclose(got[name].numpy(), want.numpy(),
                                       atol=2 * lr, err_msg=name)
