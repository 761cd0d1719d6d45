"""The port's sampling core and optimizers against the JAX package's, on
the same numpy inputs, in float32 on the CPU."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from mercury_tpu.sampling import importance as jimp  # noqa: E402
from mercury_tpu.train import state as jstate  # noqa: E402
from mercury_tpu_torch.ops import score_and_draw  # noqa: E402
from mercury_tpu_torch.sampling import importance as timp  # noqa: E402
from mercury_tpu_torch.train.state import make_optimizer  # noqa: E402


def _losses(n, seed):
    return np.random.default_rng(seed).exponential(1.0, n).astype(np.float32)


@pytest.mark.parametrize("label_smoothing", [0.0, 0.1])
def test_per_sample_loss_matches(label_smoothing):
    rng = np.random.default_rng(0)
    z = rng.normal(0, 3, (64, 10)).astype(np.float32)
    y = rng.integers(0, 10, 64).astype(np.int32)
    ref = np.asarray(jimp.per_sample_loss(jnp.asarray(z), jnp.asarray(y), label_smoothing))
    ours = timp.per_sample_loss(torch.from_numpy(z), torch.from_numpy(y), label_smoothing)
    np.testing.assert_allclose(ours.numpy(), ref, rtol=1e-5, atol=1e-6)


def test_ema_bootstraps_then_decays():
    je, te = jimp.init_ema(), timp.init_ema()
    for v in (2.0, 1.0, 0.5):
        je = jimp.ema_update(je, jnp.float32(v), 0.9)
        te = timp.ema_update(te, torch.tensor(v), 0.9)
        np.testing.assert_allclose(float(te.value), float(je.value), rtol=1e-6)
    assert int(te.count) == 3
    assert float(timp.ema_update(timp.init_ema(), torch.tensor(2.0)).value) == 2.0


@pytest.mark.parametrize("zero_pool", [False, True])
def test_importance_probs_and_reweighting_match(zero_pool):
    """Includes the all-zero pool, where the score floor makes p uniform."""
    losses = np.zeros(32, np.float32) if zero_pool else _losses(32, 1)
    ema = 0.0 if zero_pool else 0.7
    ref = np.asarray(jimp.importance_probs(jnp.asarray(losses), jnp.float32(ema), 0.5))
    ours = timp.importance_probs(torch.from_numpy(losses), torch.tensor(ema), 0.5).numpy()
    np.testing.assert_allclose(ours, ref, rtol=1e-6)
    scaled = (ours * 32)[:8]
    np.testing.assert_allclose(
        float(timp.reweighted_loss(torch.from_numpy(losses[:8]), torch.from_numpy(scaled))),
        float(jimp.reweighted_loss(jnp.asarray(losses[:8]), jnp.asarray(scaled))),
        rtol=1e-6)


def test_select_from_pool_matches_all_but_the_draw():
    """JAX draws with ``jax.random.categorical`` (Gumbel), the port by
    inverse CDF from given uniforms, so the draws themselves cannot agree;
    the EMA, the mean pool loss and each drawn candidate's ``p·N`` do, and
    the port's draw is the fused kernel's for the same uniforms."""
    losses = _losses(320, 2)
    ema0 = jimp.ema_update(jimp.init_ema(), jnp.float32(1.3))
    ref = jimp.select_from_pool(jax.random.key(0), jnp.asarray(losses), ema0, 32)
    u = torch.from_numpy(np.random.default_rng(3).uniform(size=(1, 32)).astype(np.float32))
    tema0 = timp.EMAState(torch.tensor(1.3), torch.tensor(1, dtype=torch.int32))
    ours = timp.select_from_pool(torch.from_numpy(losses), tema0, u)
    np.testing.assert_allclose(float(ours.ema.value), float(ref.ema.value), rtol=1e-6)
    np.testing.assert_allclose(float(ours.avg_pool_loss), float(ref.avg_pool_loss), rtol=1e-6)
    probs = np.asarray(jimp.importance_probs(jnp.asarray(losses), ref.ema.value, 0.5))
    np.testing.assert_allclose(ours.scaled_probs.numpy(),
                               probs[ours.selected.numpy()] * 320, rtol=1e-5)
    _, kernel_sel, _ = score_and_draw(torch.from_numpy(losses), ours.ema.value, u, 0.5)
    np.testing.assert_array_equal(ours.selected.numpy(), kernel_sel.numpy())


def test_uniform_selection_is_uniform_with_unit_weights():
    sel, w = timp.uniform_selection(320, 32, torch.Generator().manual_seed(0))
    assert sel.shape == (32,) and int(sel.min()) >= 0 and int(sel.max()) < 320
    assert torch.equal(w, torch.ones(32))


@pytest.mark.parametrize("name,weight_decay,warmup", [
    ("adam", 0.0, 0), ("adam", 0.01, 0), ("adamw", 0.01, 0), ("sgd", 0.0, 0),
    ("adam", 0.0, 2),
])
def test_optimizer_updates_match_optax(name, weight_decay, warmup):
    """Six updates under the schedule, from the same parameters and
    gradients, against ``mercury_tpu.train.state.make_optimizer``."""
    rng = np.random.default_rng(4)
    w0 = rng.normal(0, 1, (5, 3)).astype(np.float32)
    grads = rng.normal(0, 1, (6, 5, 3)).astype(np.float32)
    lr, total = 0.01, 8

    tx = jstate.make_optimizer(name, lr, total, weight_decay=weight_decay,
                               warmup_steps=warmup)
    w = jnp.asarray(w0)
    opt_state = tx.init(w)
    for g in grads:
        upd, opt_state = tx.update(jnp.asarray(g), opt_state, w)
        w = w + upd

    p = torch.nn.Parameter(torch.from_numpy(w0.copy()))
    opt, schedule = make_optimizer(name, [p], lr, total, weight_decay, warmup)
    for k, g in enumerate(grads):
        for group in opt.param_groups:
            group["lr"] = schedule(k)
        p.grad = torch.from_numpy(g)
        opt.step()
    np.testing.assert_allclose(p.detach().numpy(), np.asarray(w), rtol=1e-5, atol=1e-6)
