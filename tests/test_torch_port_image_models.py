"""The port's SmallCNN, VGGs and MobileNetV2 against the Flax models of the
JAX package, from the same weights (``params_from_flax``), in float32 on
the CPU: forwards, running statistics, parameter counts, the flat order of
the ZeRO and int8 wires, and one importance-sampled step."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import flax.linen as fnn  # noqa: E402
from jax.flatten_util import ravel_pytree  # noqa: E402

import chip_smoke  # noqa: E402
from mercury_tpu.config import TrainConfig as JConfig  # noqa: E402
from mercury_tpu.models import create_model as jcreate_model  # noqa: E402
from mercury_tpu.models import resnet as jres  # noqa: E402
from mercury_tpu.parallel.mesh import host_cpu_mesh  # noqa: E402
from mercury_tpu.train import state as jstate  # noqa: E402
from mercury_tpu.train.step import make_train_step as jmake_train_step  # noqa: E402
from mercury_tpu_torch import Trainer  # noqa: E402
from mercury_tpu_torch.config import _MODELS, TrainConfig  # noqa: E402
from mercury_tpu_torch.data import cifar  # noqa: E402
from mercury_tpu_torch.data.pipeline import ShardStream, make_sharded_dataset  # noqa: E402
from mercury_tpu_torch.models import MODELS, create_model  # noqa: E402
from mercury_tpu_torch.models import resnet as tres  # noqa: E402
from mercury_tpu_torch.models.convert import jax_flat_order, params_from_flax  # noqa: E402
from mercury_tpu_torch.sampling.importance import EMAState  # noqa: E402
from mercury_tpu_torch.train.state import create_state  # noqa: E402
from mercury_tpu_torch.train.step import Augment, Draws, make_train_step  # noqa: E402

# Forward tolerance, as for the ResNet: the same float32 math in another
# order (XLA vs ATen convolutions and reductions).
LOGITS_ATOL = 1e-4

# name → (model, keyword arguments of both packages' models, image side).
CASES = {
    "smallcnn": ("smallcnn", {}, 32),
    "vgg11": ("vgg11", {}, 32),
    # At 64×64 the last map is 2×2: a channels-first flatten would scramble
    # the first Dense layer's rows.
    "vgg11-64px": ("vgg11", {}, 64),
    "mobilenetv2": ("mobilenetv2", dict(width_mult=0.1), 32),
    # The ImageNet stem: stride 2 in the stem and every down-stage.
    "mobilenetv2-strided-stem": ("mobilenet_v2", dict(width_mult=0.1, cifar_stem=False), 32),
}

# Parameters at full width and 10 classes, as the Flax models count them.
PARAMETERS = {"smallcnn": 5_466, "vgg11": 9_290_186, "vgg13": 9_474_890,
              "vgg16": 14_785_866, "vgg19": 20_096_842, "mobilenetv2": 2_236_682}


def _images(n, side, seed):
    return np.random.default_rng(seed).normal(0, 1, (n, side, side, 3)).astype(np.float32)


def _nchw(x):
    return torch.from_numpy(x).permute(0, 3, 1, 2).contiguous()


def _pair(case, seed=0):
    """The Flax model with non-trivial running statistics, and the port's
    model loaded with its variables."""
    name, kw, side = CASES[case]
    jm = jcreate_model(name, 10, compute_dtype="float32", **kw)
    x = _images(6, side, seed)
    variables = jm.init(jax.random.key(seed), jnp.asarray(x), train=False)
    stats = jax.tree_util.tree_map(
        lambda a: a + 0.1 * np.random.default_rng(seed + 1).uniform(0.5, 1.5, a.shape),
        variables["batch_stats"])
    variables = {"params": variables["params"], "batch_stats": stats}
    tm = create_model(name, 10, torch.Generator().manual_seed(seed), (side, side, 3), **kw)
    tm.load_state_dict(params_from_flax(variables["params"], variables["batch_stats"]))
    return jm, variables, tm, x


@pytest.mark.parametrize("case", sorted(CASES))
def test_eval_forward_matches_flax(case):
    jm, variables, tm, x = _pair(case)
    ref = np.asarray(jm.apply(variables, jnp.asarray(x), train=False))
    with torch.no_grad():
        ours = tm(_nchw(x), train=False)
    assert ours.dtype == torch.float32
    np.testing.assert_allclose(ours.numpy(), ref, atol=LOGITS_ATOL)


# The strided stem ends on a 1×1 map at 32×32, where train-mode batch
# statistics over 6 values amplify float32 rounding (Flax's one-pass
# variance put its logits 1.1e-4 off a float64 forward of the port, the
# port's own two-pass one 2.2e-5): its train forward is not compared.
@pytest.mark.parametrize("case", sorted(set(CASES) - {"mobilenetv2-strided-stem"}))
def test_train_forward_and_running_stats_match_flax(case):
    jm, variables, tm, x = _pair(case)
    ref, new_state = jm.apply(variables, jnp.asarray(x), train=True,
                              mutable=["batch_stats"])
    ours = tm(_nchw(x), train=True, keep_stats=True)
    assert ours.dtype == torch.float32
    np.testing.assert_allclose(ours.detach().numpy(), np.asarray(ref), atol=LOGITS_ATOL)
    expect = params_from_flax(variables["params"], new_state["batch_stats"])
    got = tm.state_dict()
    assert set(got) == set(expect)
    for k in expect:
        if "running_" in k:
            np.testing.assert_allclose(got[k].numpy(), expect[k].numpy(),
                                       rtol=1e-5, atol=1e-6, err_msg=k)


@pytest.mark.parametrize("case", ["smallcnn", "vgg11", "mobilenetv2"])
def test_scoring_forward_keeps_running_stats(case):
    _, _, tm, x = _pair(case)
    before = {k: v.clone() for k, v in tm.state_dict().items()}
    with torch.no_grad():
        tm(_nchw(x), train=True, keep_stats=False)
    for k, v in tm.state_dict().items():
        assert torch.equal(v, before[k]), k
    tm(_nchw(x), train=True, keep_stats=True)
    moved = [k for k, v in tm.state_dict().items()
             if k.endswith("running_mean") and not torch.equal(v, before[k])]
    assert len(moved) == sum(k.endswith("running_mean") for k in before)


def test_stride2_depthwise_needs_same_padding():
    """A stride-2 depthwise 3×3 conv pads (0, 1) under XLA's SAME, as a
    dense one does; padding=1 shifts the output by a pixel."""
    rng = np.random.default_rng(5)
    x = rng.normal(0, 1, (2, 32, 32, 6)).astype(np.float32)
    conv = fnn.Conv(6, (3, 3), strides=(2, 2), feature_group_count=6, use_bias=False)
    variables = conv.init(jax.random.key(0), jnp.asarray(x))
    kernel = np.asarray(variables["params"]["kernel"])
    assert kernel.shape == (3, 3, 1, 6)
    ref = np.asarray(conv.apply(variables, jnp.asarray(x))).transpose(0, 3, 1, 2)
    w = torch.tensor(kernel).permute(3, 2, 0, 1)
    same = tres.SameConv2d(6, 6, 3, stride=2, groups=6)
    assert same.weight.shape == w.shape == (6, 1, 3, 3)
    same.weight.data.copy_(w)
    with torch.no_grad():
        ours = same(_nchw(x)).numpy()
        symmetric = torch.nn.functional.conv2d(_nchw(x), w, stride=2, padding=1,
                                               groups=6).numpy()
    np.testing.assert_allclose(ours, ref, atol=1e-5)
    assert symmetric.shape == ref.shape
    assert np.abs(symmetric - ref).max() > 0.1


def _flax_count(name, classes):
    jm = jcreate_model(name, classes)
    shapes = jax.eval_shape(lambda: jm.init(jax.random.key(0), jnp.zeros((1, 32, 32, 3)),
                                            train=False))
    return sum(int(np.prod(a.shape)) for a in jax.tree_util.tree_leaves(shapes["params"]))


def _port_count(name, classes):
    with torch.device("meta"):
        model = create_model(name, classes)
    return sum(p.numel() for p in model.parameters())


@pytest.mark.parametrize("name", sorted(PARAMETERS))
def test_full_width_parameter_count_equals_flax(name):
    """Counted from the Flax init's shapes (``jax.eval_shape``: no forward
    runs) and from the port's model on the meta device."""
    assert _port_count(name, 10) == _flax_count(name, 10) == PARAMETERS[name]


@pytest.mark.parametrize("name,classes", sorted(k for k in chip_smoke.PARAMETERS
                                                 if k[0] in PARAMETERS))
def test_smoke_parameter_counts_equal_flax(name, classes):
    """The counts the card's smoke holds its phase-19 models to."""
    assert _port_count(name, classes) == _flax_count(name, classes)
    assert chip_smoke.PARAMETERS[name, classes] == _flax_count(name, classes)


def test_model_names_are_the_configs():
    assert set(MODELS) == set(_MODELS)
    assert create_model("mobilenet_v2", 10).__class__ is create_model("mobilenetv2", 10).__class__
    with pytest.raises(ValueError, match="vgg12"):
        create_model("vgg12", 10)


@pytest.mark.parametrize("case", ["smallcnn", "vgg16", "mobilenetv2"])
def test_flat_order_is_ravel_pytree(case):
    """``port_vec[order]`` is ``ravel_pytree`` of the Flax ``params`` (the
    order of the ZeRO chunks and int8 rows) exactly, every value distinct;
    ``inverse`` takes it back. VGG-16 has 13 convs and MobileNetV2 17
    blocks: ``_10`` sorts before ``_2``. (The ResNets are held so in
    ``test_torch_port_grad_path.py``.)"""
    name, kw, side = CASES.get(case, (case, dict(hidden_dim=16), 32))
    jm = jcreate_model(name, 10, compute_dtype="float32", **kw)
    shapes = jax.eval_shape(lambda: jm.init(jax.random.key(0),
                                            jnp.zeros((1, side, side, 3)), train=False))
    at = [0]

    def distinct(a):
        n = int(np.prod(a.shape))
        at[0] += n
        return np.arange(at[0] - n, at[0], dtype=np.float32).reshape(a.shape)

    variables = jax.tree_util.tree_map(distinct, shapes)
    tm = create_model(name, 10, None, (side, side, 3), **kw)
    tm.load_state_dict(params_from_flax(variables["params"], variables["batch_stats"]))
    flat, _ = ravel_pytree(variables["params"])
    port_vec = torch.cat([p.detach().reshape(-1) for p in tm.parameters()])
    order, inverse = jax_flat_order(tm)
    np.testing.assert_array_equal(port_vec[order].numpy(), np.asarray(flat))
    assert torch.equal(torch.tensor(np.asarray(flat))[inverse], port_vec)
    if case != "smallcnn":
        names = sorted(variables["params"])
        block = "InvertedResidual" if case == "mobilenetv2" else "Conv"
        assert names.index(f"{block}_10") < names.index(f"{block}_2")


@pytest.mark.parametrize("case", ["smallcnn", "vgg11", "mobilenetv2"])
def test_zero_sharding_step_equals_the_plain_step(case):
    """ZeRO's step runs Adam over the flat parameters in ``jax_flat_order``
    and copies them back: at W=1 two of its steps leave the same model as
    two plain steps, bit for bit."""
    name, kw, _ = CASES[case]
    states = []
    for zero in (False, True):
        cfg = TrainConfig(model=name, dataset="synthetic_hard", world_size=1, batch_size=4,
                          presample_batches=2, compute_dtype="float32", num_epochs=1,
                          steps_per_epoch=2, seed=0, zero_sharding=zero)
        model = create_model(name, 20, torch.Generator().manual_seed(0), **kw)
        trainer = Trainer(cfg, device="cpu", model=model)
        for _ in range(2):
            trainer.train_step()
        assert (trainer.state.flat is not None) == zero
        states.append(trainer.state.model.state_dict())
        trainer.close()
    for k, v in states[0].items():
        assert torch.equal(v, states[1][k]), k


# ------------------------------------------------------------ one step
B, PRESAMPLE, N_TRAIN, STEPS = 4, 4, 64, 10
POOL = B * PRESAMPLE
MEAN, STD = cifar.CIFAR10_MEAN, cifar.CIFAR10_STD


def _np_tree(tree):
    return jax.tree_util.tree_map(lambda a: np.array(a), tree)


@pytest.mark.parametrize("case", ["smallcnn", "mobilenetv2"])
def test_pool_step_matches_make_train_step(case):
    """One importance-sampled pool step of each package from the same Flax
    weights, stream, EMA and draws (the JAX step's keys, as in
    ``test_torch_port_step.py``): loss, pool loss, parameters after Adam's
    first update within 2·lr (≈ lr·sign(g): where g is near 0 a last-bit
    difference flips the sign) and the running statistics."""
    name, kw, _ = CASES[case]
    (x, y), (xt, yt) = cifar.synthetic_cifar(10, N_TRAIN, 8, seed=0)
    jm = jcreate_model(name, 10, compute_dtype="float32", **kw)
    jcfg = JConfig(model=name, dataset="synthetic", world_size=1, batch_size=B,
                   presample_batches=PRESAMPLE, use_pallas=True, telemetry=False,
                   compute_dtype="float32", num_epochs=1, steps_per_epoch=STEPS, seed=0)
    tx = jstate.make_optimizer("adam", jcfg.lr, STEPS)
    jst = jstate.create_state(jax.random.key(0), jm, tx,
                              jnp.zeros((1, 32, 32, 3), jnp.float32), 1, N_TRAIN)
    params, stats = _np_tree(jst.params), _np_tree(jst.batch_stats)
    perm, ema = np.array(jst.stream.perm[0]), float(jst.ema.value[0])
    keys = jax.random.split(jst.rng[0], 8)
    k_crop, k_flip, _ = jax.random.split(keys[1], 3)
    draws = Draws(
        perm=None,  # cursor 0 + pool 16 <= 64: no reshuffle this step
        aug=Augment(crop=torch.tensor(np.array(jax.random.randint(k_crop, (POOL, 2), 0, 9))),
                    flip=torch.tensor(np.array(jax.random.bernoulli(k_flip, shape=(POOL,))))),
        uniforms=torch.tensor(np.array(jax.random.uniform(keys[2], (1, B), jnp.float32))))

    tm = create_model(name, 10, None, **kw)
    tm.load_state_dict(params_from_flax(params, stats))
    dataset = make_sharded_dataset((x, y), (xt, yt), [np.arange(N_TRAIN)], MEAN, STD, 10,
                                   device=torch.device("cpu"))
    tcfg = TrainConfig(model=name, dataset="synthetic", world_size=1, batch_size=B,
                       presample_batches=PRESAMPLE, compute_dtype="float32", num_epochs=1,
                       steps_per_epoch=STEPS, seed=0)
    tst = create_state(tm, "cpu", 0, N_TRAIN, "adam", tcfg.lr, STEPS)
    tst.stream = ShardStream(perm=torch.tensor(perm, dtype=torch.long), cursor=0)
    tst.ema = EMAState(torch.tensor(ema), torch.tensor(0, dtype=torch.int32))
    tmet = make_train_step(tcfg, dataset)(tst, draws)

    step_fn = jmake_train_step(jm, tx, jcfg, host_cpu_mesh(1), MEAN, STD)
    new_state, jmet = step_fn(jst, jnp.asarray(x), jnp.asarray(y),
                              jnp.asarray(np.arange(N_TRAIN, dtype=np.int32)[None, :]))
    np.testing.assert_allclose(float(tmet["train/loss"]), float(jmet["train/loss"]), rtol=1e-5)
    np.testing.assert_allclose(float(tmet["train/pool_loss"]),
                               float(jmet["train/pool_loss"]), rtol=1e-5)
    expect = params_from_flax(_np_tree(new_state.params), _np_tree(new_state.batch_stats))
    got = tst.model.state_dict()
    for k, want in expect.items():
        if "running_" in k:
            np.testing.assert_allclose(got[k].numpy(), want.numpy(), rtol=1e-5, atol=1e-6,
                                       err_msg=k)
        else:
            np.testing.assert_allclose(got[k].numpy(), want.numpy(), atol=2 * jcfg.lr,
                                       err_msg=k)
