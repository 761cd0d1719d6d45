"""Gradient accumulation of the port (``grad_accum_steps=2``) against the
JAX package's ``optax.MultiSteps`` step, in float32 on the CPU.

The JAX side is ``make_train_step`` on a world-1 CPU mesh with
``make_optimizer(..., grad_accum_steps=2)`` and ``use_pallas=True`` (its
kernels in interpret mode). The port starts from the same weights
(``params_from_flax``), stream and EMA, and each of its microsteps takes the
draws that the JAX step makes from its ``state.rng`` (as
``test_torch_port_dist_step``'s ``_worker_draws``). Four microsteps are two
updates. Tiny sizes: a [1, 1]-stage ResNet of width 8, batch 4, a pool of
16, 64 images.

Tolerances, the single-step tests' own: the accumulator, a mean of
gradients, to rtol 1e-3, atol 1e-5; parameters after an update to 2·lr
(Adam's update is ≈ lr·sign(g), flipped by a last-bit difference in a g
near 0); the Adam moments to rtol 1e-3, atol 1e-5; the BN running
statistics to rtol 1e-5, atol 1e-6. Between updates the parameters are
bit-unchanged on both sides.
"""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

from mercury_tpu.config import TrainConfig as JConfig  # noqa: E402
from mercury_tpu.models import resnet as jres  # noqa: E402
from mercury_tpu.parallel.mesh import host_cpu_mesh  # noqa: E402
from mercury_tpu.train import state as jstate  # noqa: E402
from mercury_tpu.train.step import make_train_step as jmake_train_step  # noqa: E402
from mercury_tpu_torch.config import TrainConfig  # noqa: E402
from mercury_tpu_torch.data import cifar  # noqa: E402
from mercury_tpu_torch.data.pipeline import ShardStream, make_sharded_dataset  # noqa: E402
from mercury_tpu_torch.models import resnet as tres  # noqa: E402
from mercury_tpu_torch.models.convert import params_from_flax  # noqa: E402
from mercury_tpu_torch.sampling.importance import EMAState  # noqa: E402
from mercury_tpu_torch.train.state import create_state, make_optimizer  # noqa: E402
from mercury_tpu_torch.train.step import Augment, Draws, accumulate, make_train_step  # noqa: E402

B, PRESAMPLE, N_TRAIN, STEPS, A, MICROSTEPS = 4, 4, 64, 10, 2, 4
POOL = B * PRESAMPLE
MEAN, STD = cifar.CIFAR10_MEAN, cifar.CIFAR10_STD
COMMON = dict(dataset="synthetic", world_size=1, batch_size=B,
              presample_batches=PRESAMPLE, compute_dtype="float32", num_epochs=1,
              steps_per_epoch=STEPS, seed=0, grad_accum_steps=A)


def _np_tree(tree):
    return jax.tree_util.tree_map(lambda a: np.array(a), tree)


def _draws(rng) -> Draws:
    """The draws the JAX step makes from its key ``rng``."""
    _, k_aug, k_sel = jax.random.split(rng, 8)[:3]
    k_crop, k_flip, _ = jax.random.split(k_aug, 3)
    return Draws(
        perm=None,  # 4 pools of 16 read the 64-slot stream once: no reshuffle
        aug=Augment(
            crop=torch.tensor(np.array(jax.random.randint(k_crop, (POOL, 2), 0, 9), np.int32)),
            flip=torch.tensor(np.array(jax.random.bernoulli(k_flip, shape=(POOL,))))),
        uniforms=torch.tensor(np.array(jax.random.uniform(k_sel, (1, B), jnp.float32))))


def _snapshot_port(state):
    opt = state.optimizer.state_dict()["state"]
    names = [n for n, _ in state.model.named_parameters()]
    return dict(
        state_dict={k: v.clone() for k, v in state.model.state_dict().items()},
        accum={n: a.clone() for n, a in zip(names, state.accum)},
        mu={n: opt[i]["exp_avg"].clone() for i, n in enumerate(names) if i in opt},
        nu={n: opt[i]["exp_avg_sq"].clone() for i, n in enumerate(names) if i in opt},
        mini_step=state.mini_step, updates=state.updates, step=state.step)


def _snapshot_jax(js):
    stats = _np_tree(js.batch_stats)
    ms = js.opt_state
    adam = ms.inner_opt_state[0]

    def per_param(tree):
        return {k: v for k, v in params_from_flax(_np_tree(tree), stats).items()
                if "running_" not in k}

    return dict(
        state_dict=params_from_flax(_np_tree(js.params), stats),
        accum=per_param(ms.acc_grads), mu=per_param(adam.mu), nu=per_param(adam.nu),
        mini_step=int(ms.mini_step), updates=int(ms.gradient_step))


@pytest.fixture(scope="module")
def runs():
    """Both sides' state after each of the four microsteps, and before the
    first."""
    (x, y), (xt, yt) = cifar.synthetic_cifar(10, N_TRAIN, 8, seed=0)
    jm = jres.ResNet(stage_sizes=[1, 1], block_cls=jres.BasicBlock,
                     num_classes=10, num_filters=8, compute_dtype=jnp.float32)
    jcfg = JConfig(model="resnet18", use_pallas=True, telemetry=False, **COMMON)
    tx = jstate.make_optimizer("adam", jcfg.lr, STEPS, grad_accum_steps=A)
    js = jstate.create_state(jax.random.key(0), jm, tx,
                             jnp.zeros((1, 32, 32, 3), jnp.float32), 1, N_TRAIN)

    tm = tres.ResNet([1, 1], tres.BasicBlock, num_classes=10, num_filters=8)
    tm.load_state_dict(params_from_flax(_np_tree(js.params), _np_tree(js.batch_stats)))
    dataset = make_sharded_dataset((x, y), (xt, yt), [np.arange(N_TRAIN)], MEAN,
                                   STD, 10, device=torch.device("cpu"))
    tcfg = TrainConfig(**COMMON)
    ts = create_state(tm, "cpu", 0, N_TRAIN, "adam", tcfg.lr, STEPS,
                      grad_accum_steps=A)
    ts.stream = ShardStream(perm=torch.tensor(np.array(js.stream.perm[0]), dtype=torch.long),
                            cursor=0)
    ts.ema = EMAState(torch.tensor(float(js.ema.value[0])), torch.tensor(0, dtype=torch.int32))
    port_step = make_train_step(tcfg, dataset)
    jax_step = jmake_train_step(jm, tx, jcfg, host_cpu_mesh(1), MEAN, STD)
    shard = jnp.asarray(np.arange(N_TRAIN, dtype=np.int32)[None, :])

    port, ref, selected = [_snapshot_port(ts)], [_snapshot_jax(js)], []
    for _ in range(MICROSTEPS):
        draws = _draws(js.rng[0])
        metrics = port_step(ts, draws)
        js, _ = jax_step(js, jnp.asarray(x), jnp.asarray(y), shard)
        port.append(_snapshot_port(ts))
        ref.append(_snapshot_jax(js))
        selected.append((metrics["sampler/probs"].numpy(), draws.uniforms.numpy()[0]))
    return dict(port=port, ref=ref, selected=selected, lr=tcfg.lr)


def test_counters_match_multisteps(runs):
    for i, (p, r) in enumerate(zip(runs["port"], runs["ref"])):
        assert (p["mini_step"], p["updates"]) == (r["mini_step"], r["updates"]) == (
            i % A, i // A), i
        assert p["step"] == i


def test_draws_stay_clear_of_cdf_boundaries(runs):
    """The selections the comparison rests on: no uniform within the
    boundary band of the CDF summation order (see test_torch_port_ops)."""
    for probs, u in runs["selected"]:
        cdf = np.cumsum(probs.astype(np.float64))
        assert np.min(np.abs(cdf[None, :] - u[:, None])) > 1e-6


@pytest.mark.parametrize("microstep", [1, 3])
def test_parameters_unchanged_between_updates(runs, microstep):
    """The first microstep of a window changes neither side's parameters
    or Adam state, to the bit."""
    for side in ("port", "ref"):
        before, after = runs[side][microstep - 1], runs[side][microstep]
        for key in ("mu", "nu"):
            for name, v in before[key].items():
                assert torch.equal(torch.as_tensor(after[key][name]), torch.as_tensor(v)), name
        for name, v in before["state_dict"].items():
            if "running_" not in name:
                assert torch.equal(after["state_dict"][name], v), (side, name)


@pytest.mark.parametrize("microstep", [1, 2, 3, 4])
def test_accumulator_matches_acc_grads(runs, microstep):
    p, r = runs["port"][microstep], runs["ref"][microstep]
    assert p["accum"].keys() == r["accum"].keys()
    for name, got in p["accum"].items():
        want = r["accum"][name].numpy()
        if microstep % A == 0:
            assert not got.any() and not want.any(), name  # zeroed by the update
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-3, atol=1e-5, err_msg=name)


@pytest.mark.parametrize("microstep", [2, 4])
def test_update_matches(runs, microstep):
    p, r, lr = runs["port"][microstep], runs["ref"][microstep], runs["lr"]
    for name, want in r["state_dict"].items():
        got = p["state_dict"][name].numpy()
        if "running_" in name:
            np.testing.assert_allclose(got, want.numpy(), rtol=1e-5, atol=1e-6, err_msg=name)
        else:
            np.testing.assert_allclose(got, want.numpy(), atol=2 * lr, err_msg=name)
    for key in ("mu", "nu"):
        assert p[key].keys() == r[key].keys()
        for name, got in p[key].items():
            np.testing.assert_allclose(got.numpy(), r[key][name].numpy(),
                                       rtol=1e-3, atol=1e-5, err_msg=f"{key} {name}")


@pytest.mark.parametrize("microstep", [1, 3])
def test_running_statistics_move_every_microstep(runs, microstep):
    p, r = runs["port"][microstep], runs["ref"][microstep]
    before = runs["port"][microstep - 1]["state_dict"]
    for name, want in r["state_dict"].items():
        if "running_" in name:
            assert not torch.equal(p["state_dict"][name], before[name]), name
            np.testing.assert_allclose(p["state_dict"][name].numpy(), want.numpy(),
                                       rtol=1e-5, atol=1e-6, err_msg=name)


@pytest.mark.parametrize("accum", [2, 3])
def test_accumulate_rounds_as_multisteps(accum):
    """``accumulate`` on given gradients against ``optax.MultiSteps`` over
    ``optax.identity()``, to the bit: the running mean after each microstep
    (a sum divided at the end differs from the second microstep at A=3),
    and on the A-th the mean handed to the optimizer, then a zero
    accumulator."""
    rng = np.random.default_rng(accum)
    model = torch.nn.Linear(3, 2)
    state = create_state(model, "cpu", 0, 8, "sgd", 0.1, 30, grad_accum_steps=accum)
    handed = []
    step = state.optimizer.step
    state.optimizer.step = lambda: (handed.append([p.grad.clone() for p in model.parameters()]),
                                    step())
    tx = optax.MultiSteps(optax.identity(), every_k_schedule=accum)
    params = {"w": jnp.zeros((2, 3)), "b": jnp.zeros(2)}
    opt_state = tx.init(params)
    for micro in range(1, 2 * accum + 1):
        grads = {"w": rng.standard_normal((2, 3)).astype(np.float32),
                 "b": rng.standard_normal(2).astype(np.float32)}
        model.weight.grad = torch.tensor(grads["w"])
        model.bias.grad = torch.tensor(grads["b"])
        accumulate(state, accum)
        updates, opt_state = tx.update(jax.tree_util.tree_map(jnp.asarray, grads), opt_state)
        for got, key in zip(state.accum, ("w", "b")):
            assert np.array_equal(got.numpy(), np.asarray(opt_state.acc_grads[key])), micro
        if micro % accum == 0:
            for got, key in zip(handed[-1], ("w", "b")):
                assert np.array_equal(got.numpy(), np.asarray(updates[key])), micro
            assert all(p.grad is None for p in model.parameters())
        assert (state.mini_step, state.updates) == (micro % accum, micro // accum)
    assert len(handed) == 2


@pytest.mark.parametrize("accum", [1, 2, 3])
@pytest.mark.parametrize("total,warmup", [(10, 0), (10, 3), (7, 2), (1000, 100)])
def test_schedule_runs_over_updates(accum, total, warmup):
    """The port's lr_schedule(k) is optax's schedule over ceil(T/A) updates
    with a warmup of ceil(warmup/A), at every update and past the end, to
    rtol 1e-6. optax computes in float32, and its warmup ``lr − lr·(1 −
    k/w)`` cancels: at small k it is off by up to an ulp of lr, which the
    port's float64 is not, hence atol lr·2⁻²³."""
    lr = 0.002
    updates = math.ceil(total / accum)
    _, schedule = make_optimizer("adam", [torch.nn.Parameter(torch.zeros(1))], lr,
                                 total, warmup_steps=warmup, grad_accum_steps=accum)
    if warmup:
        want = optax.warmup_cosine_decay_schedule(0.0, lr, math.ceil(warmup / accum), updates)
    else:
        want = optax.cosine_decay_schedule(lr, updates)
    for k in range(updates + 2):
        np.testing.assert_allclose(schedule(k), float(want(k)), rtol=1e-6, atol=lr * 2**-23,
                                   err_msg=f"update {k}")


def test_colliding_warmup_raises():
    """warmup_steps < total_steps, yet ceil(9/2) = ceil(10/2) = 5 updates:
    both packages refuse."""
    with pytest.raises(ValueError, match="warmup"):
        jstate.make_optimizer("adam", 0.001, 10, grad_accum_steps=2, warmup_steps=9)
    with pytest.raises(ValueError, match="warmup"):
        make_optimizer("adam", [torch.nn.Parameter(torch.zeros(1))], 0.001, 10,
                       warmup_steps=9, grad_accum_steps=2)
    make_optimizer("adam", [torch.nn.Parameter(torch.zeros(1))], 0.001, 10,
                   warmup_steps=9, grad_accum_steps=1)
