"""The pool sampler's step modes in the port — ``pipelined_scoring``,
``score_refresh_every`` and ``sampler="groupwise"`` — against the JAX
package's ``make_train_step``, on the CPU.

Sizes are ``test_torch_port_config_step``'s: a [1, 1]-stage ResNet of width
8, batch 4, a pool of 16, 64 synthetic images, float32. Each case runs ten
steps of both packages. The JAX step runs first; the port's draws of step
t are the JAX key of step t split 8 ways (``mercury_tpu/train/step.py:855``):
the pool's augmentation from ``k_aug``, the re-ingested batch's from
``k_aug2``, the reshuffle from ``k_stream`` where the stream wraps, the
pipelined boot pool's from ``k_boot_stream``, ``k_boot_aug`` and
``k_boot_sel``. Where the JAX step draws with its kernel (pipelined,
``use_pallas=True``) the port takes its ``uniform(k_sel, (1, B))``; where it
draws by ``jax.random.categorical`` (the cadence's and the groupwise draws
always, the pipelined draw with ``use_pallas=False``) the port is fed that
draw as uniforms at the middle of each drawn index's CDF interval.

Each step starts both packages from the same weights: after comparing a
step, the port's model takes the JAX step's parameters and BN statistics.
What a mode carries — the stream, the EMA, the pending batch, the cached
pool, the groupwise importance, the optimizer's moments and the
accumulator — each package carries on its own through all ten steps.

Tolerances, ``test_torch_port_config_step``'s: losses, ESS, clip share,
EMA and the carried scores and probabilities rtol 1e-5 (atol 1e-7 for
values that are 0 on a step that scores nothing); the drift, the difference
of the pool mean and the EMA carried apart for steps, to 1e-5 of the pool
loss (``chip_smoke.telemetry_agree``'s limit); the gradient's norm
rtol 1e-4; slots, labels, cursors and histograms exactly; parameters after
the step within 2·lr of JAX's (Adam's update is ≈ lr·sign(g)), the BN
running statistics rtol 1e-5, atol 1e-6; the pipelined batch's images
rtol and atol 1e-5 (the IID transform resamples bilinearly in each
framework's float32 arithmetic). Under ``scoring_dtype="bfloat16"``
what comes from the bf16 scorer is held to rtol 1e-2, the tolerance of
``test_torch_port_scoring_dtype`` (torch's autocast and Flax round to bf16
at different places), and the weights' histogram to its count.
"""

import tempfile

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from mercury_tpu.config import TrainConfig as JConfig  # noqa: E402
from mercury_tpu.models import resnet as jres  # noqa: E402
from mercury_tpu.obs import sampler_health as jsh  # noqa: E402
from mercury_tpu.parallel.mesh import host_cpu_mesh  # noqa: E402
from mercury_tpu.sampling import groupwise as jgw  # noqa: E402
from mercury_tpu.train import state as jstate  # noqa: E402
from mercury_tpu.train.step import make_train_step as jmake_train_step  # noqa: E402
from mercury_tpu_torch import TrainConfig, Trainer  # noqa: E402
from mercury_tpu_torch.data import cifar  # noqa: E402
from mercury_tpu_torch.data.pipeline import ShardStream, make_sharded_dataset  # noqa: E402
from mercury_tpu_torch.models import resnet as tres  # noqa: E402
from mercury_tpu_torch.models.convert import groupwise_from_jax, params_from_flax  # noqa: E402
from mercury_tpu_torch.ops import launch_counts, reset_launch_counts  # noqa: E402
from mercury_tpu_torch.sampling import groupwise as tgw  # noqa: E402
from mercury_tpu_torch.sampling.importance import EMAState, draw_with_replacement  # noqa: E402
from mercury_tpu_torch.train.state import Draws, create_state  # noqa: E402
from mercury_tpu_torch.train.step import make_draws, make_train_step  # noqa: E402

from test_torch_port_config_step import _augment_draws, _uniforms_for  # noqa: E402
from test_torch_port_ranks import carried_numpy, state_tensors, tiny_resnet  # noqa: E402

B, PRESAMPLE, N_TRAIN, STEPS, K = 4, 4, 64, 10, 3
POOL = B * PRESAMPLE
MEAN, STD = cifar.CIFAR10_MEAN, cifar.CIFAR10_STD
COMMON = dict(dataset="synthetic", world_size=1, batch_size=B, presample_batches=PRESAMPLE,
              compute_dtype="float32", num_epochs=1, steps_per_epoch=STEPS, seed=0)
PIPELINED = dict(pipelined_scoring=True)
CADENCE = dict(score_refresh_every=K)
GROUPWISE = dict(sampler="groupwise")
# name: (config fields of both packages, JAX kernels). Each mode runs with
# the JAX kernels (interpret mode) and with its plain route; the plain
# cases carry the compositions.
CASES = {
    "pipelined-kernels": (PIPELINED, True),
    "pipelined-plain-iid": ({**PIPELINED, "augmentation": "iid"}, False),
    "cadence-kernels": (CADENCE, True),
    "cadence-plain-bf16-scorer": ({**CADENCE, "scoring_dtype": "bfloat16"}, False),
    "groupwise-kernels": (GROUPWISE, True),
    "groupwise-plain-accum": ({**GROUPWISE, "grad_accum_steps": 2}, False),
}
SCALARS = ("train/loss", "train/pool_loss", "sampler/ess", "sampler/clip_frac",
           "sampler/ema_drift")


@pytest.fixture(autouse=True, scope="module")
def one_intra_op_thread():
    """One intra-op thread for the tiny steps, as in
    ``test_torch_port_host_stream``: torch's pool made them many times
    slower with the test workers sharing the host's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _np_tree(tree):
    return jax.tree_util.tree_map(lambda a: np.array(a), tree)


def _t(a, dtype=None):
    return torch.tensor(np.array(a), dtype=dtype)


def _jax_mode_state(jm, tx, cfg, workers, shard_len):
    return jstate.create_state(
        jax.random.key(0), jm, tx, jnp.zeros((1, 32, 32, 3), jnp.float32), workers, shard_len,
        with_groupwise=cfg.use_groupwise, pending_batch_size=B if cfg.use_pipelined else 0,
        pending_sample_shape=(32, 32, 3), cached_pool_size=POOL if cfg.use_cadence else 0)


def _categorical_uniforms(key, probs, logits_floor=False):
    """The JAX ``categorical`` draw of B over ``probs`` (``log p``, or
    ``log max(p, 1e-30)`` as the groupwise draw takes it) as CDF-midpoint
    uniforms, and the indices."""
    probs = np.asarray(probs, np.float32)
    logits = jnp.log(jnp.maximum(probs, 1e-30)) if logits_floor else jnp.log(probs)
    drawn = np.asarray(jax.random.categorical(key, logits, shape=(B,)))
    return _uniforms_for(probs, drawn), drawn


def worker_draws(cfg, jax_kernels, rng, step, cursor, length, new_js, worker=0,
                 pool_probs=None):
    """Worker ``worker``'s draws of ``step`` as the JAX step makes them from
    its key ``rng``, with the stream at ``cursor`` of ``length``. The
    categorical draws are read from the JAX state after the step
    (``new_js``: the cached pool's probabilities, or the groupwise draw
    over the updated importance); the pipelined draw without the JAX
    kernels over ``pool_probs(draws, boot)``, the port's distribution of
    that pool."""
    k_stream, k_aug, k_sel, k_aug2, kb_stream, kb_aug, kb_sel, _ = jax.random.split(rng, 8)

    def perm(key, at):
        if at + POOL <= length:
            return None, at + POOL
        return _t(jax.random.permutation(key, length), torch.long), POOL

    def uniform(key):
        return _t(jax.random.uniform(key, (1, B), jnp.float32))

    if cfg.use_cadence:
        refresh = step % cfg.score_refresh_every == 0
        probs = np.asarray(new_js.cached_pool.probs[worker])
        return Draws(perm=perm(k_stream, cursor)[0] if refresh else None,
                     aug=_augment_draws(k_aug, POOL, cfg) if refresh else None,
                     uniforms=_categorical_uniforms(k_sel, probs)[0],
                     aug2=_augment_draws(k_aug2, B, cfg))
    if cfg.use_groupwise:
        gw = jax.tree_util.tree_map(lambda a: a[worker], new_js.groupwise)
        drawn = np.asarray(jax.jit(jgw.draw, static_argnums=2)(gw, k_sel, B)[0])
        probs = tgw.group_probs(groupwise_from_jax(*gw))[0].numpy()
        return Draws(perm=None, aug=_augment_draws(k_aug, POOL, cfg),
                     uniforms=_uniforms_for(probs, drawn), aug2=_augment_draws(k_aug2, B, cfg))
    boot = None
    if step == 0:
        boot_perm, cursor = perm(kb_stream, cursor)
        boot = Draws(perm=boot_perm, aug=_augment_draws(kb_aug, POOL, cfg),
                     uniforms=uniform(kb_sel))
    draws = Draws(perm=perm(k_stream, cursor)[0], aug=_augment_draws(k_aug, POOL, cfg),
                  uniforms=uniform(k_sel), boot=boot)
    if jax_kernels:
        return draws
    # The plain JAX route draws by categorical over the pools' probabilities.
    if boot is not None:
        boot = boot._replace(uniforms=_categorical_uniforms(kb_sel, pool_probs(boot, True))[0])
        draws = draws._replace(boot=boot)
    return draws._replace(uniforms=_categorical_uniforms(k_sel, pool_probs(draws, False))[0])


def _carried_jax(js, w=0):
    out = {"ema": float(js.ema.value[w]), "ema_count": int(js.ema.count[w]),
           "cursor": int(js.stream.cursor[w]), "perm": np.asarray(js.stream.perm[w])}
    if js.pending is not None:
        out.update({f"pending.{k}": np.asarray(v[w]) for k, v in js.pending._asdict().items()})
    if js.cached_pool is not None:
        out.update({f"cached.{k}": np.asarray(v[w]) for k, v in js.cached_pool._asdict().items()})
    if js.groupwise is not None:
        gw = js.groupwise
        out.update({"gw.importance": np.asarray(gw.importance[w]),
                    "gw.group": np.asarray(gw.group[w]), "gw.cursor": int(gw.cursor[w]),
                    "gw.generation": int(gw.generation[w])})
    return out


def check_carried(port, ref, rtol, where):
    assert port.keys() == ref.keys(), where
    for key, want in ref.items():
        msg = f"{where}: {key}"
        if key in ("ema", "cached.probs", "cached.pool_loss", "pending.scaled_probs",
                   "gw.importance"):
            np.testing.assert_allclose(port[key], want, rtol=rtol, atol=1e-7, err_msg=msg)
        elif key == "pending.images":
            np.testing.assert_allclose(port[key], want, rtol=1e-5, atol=1e-5, err_msg=msg)
        else:
            np.testing.assert_array_equal(np.asarray(port[key]), np.asarray(want), err_msg=msg)


def check_metrics(tm, jm, rtol, where):
    for key in SCALARS:
        # The drift is the difference of two numbers near the pool loss
        # (the pool mean and the EMA before it): it is held to rtol of the
        # pool loss, as chip_smoke.telemetry_agree holds it.
        atol = rtol * abs(float(jm["train/pool_loss"])) if key == "sampler/ema_drift" else 1e-7
        np.testing.assert_allclose(float(tm[key]), float(jm[key]), rtol=rtol, atol=atol,
                                   err_msg=f"{where}: {key}")
    np.testing.assert_allclose(float(tm["train/grad_norm"]), float(jm["train/grad_norm"]),
                               rtol=max(rtol, 1e-4), err_msg=f"{where}: grad_norm")
    hist = [int(tm[k]) for k in jsh.hist_keys("w_hist")]
    if rtol > 1e-5:
        assert sum(hist) == sum(int(jm[k]) for k in jsh.hist_keys("w_hist")), where
    else:
        assert hist == [int(jm[k]) for k in jsh.hist_keys("w_hist")], where


def check_params(state_dict, js, lr, where):
    expect = params_from_flax(_np_tree(js.params), _np_tree(js.batch_stats))
    for name, want in expect.items():
        if "running_" in name:
            np.testing.assert_allclose(state_dict[name].numpy(), want.numpy(), rtol=1e-5,
                                       atol=1e-6, err_msg=f"{where}: {name}")
        else:
            np.testing.assert_allclose(state_dict[name].numpy(), want.numpy(), atol=2 * lr,
                                       err_msg=f"{where}: {name}")
    return expect


def _run(kw, jax_kernels):
    """Ten steps of each package from the same values; per step the
    port's and JAX's metrics and carried state, and the parameters' check."""
    (x, y), (xt, yt) = cifar.synthetic_cifar(10, N_TRAIN, 8, seed=0)
    jm = jres.ResNet(stage_sizes=[1, 1], block_cls=jres.BasicBlock, num_classes=10,
                     num_filters=8, compute_dtype=jnp.float32)
    jcfg = JConfig(model="resnet18", use_pallas=jax_kernels, telemetry=True, **COMMON, **kw)
    tcfg = TrainConfig(**COMMON, **kw, use_pallas=jax_kernels)
    accum = tcfg.grad_accum_steps
    tx = jstate.make_optimizer("adam", jcfg.lr, STEPS, grad_accum_steps=accum)
    js = _jax_mode_state(jm, tx, tcfg, 1, N_TRAIN)
    dataset = make_sharded_dataset((x, y), (xt, yt), [np.arange(N_TRAIN)], MEAN, STD, 10,
                                   device=torch.device("cpu"))
    model = tres.ResNet([1, 1], tres.BasicBlock, num_classes=10, num_filters=8)
    model.load_state_dict(params_from_flax(_np_tree(js.params), _np_tree(js.batch_stats)))
    ts = create_state(model, "cpu", 0, N_TRAIN, "adam", tcfg.lr, STEPS, grad_accum_steps=accum,
                      with_groupwise=tcfg.use_groupwise,
                      pending_batch_size=B if tcfg.use_pipelined else 0,
                      cached_pool_size=POOL if tcfg.use_cadence else 0)
    ts.stream = ShardStream(_t(js.stream.perm[0], torch.long), 0)
    ts.ema = EMAState(_t(js.ema.value[0]), _t(js.ema.count[0]))
    assert carried_numpy(ts).keys() == _carried_jax(js).keys()
    tstep = make_train_step(tcfg, dataset)
    jstep = jmake_train_step(jm, tx, jcfg, host_cpu_mesh(1), MEAN, STD)
    shard = jnp.asarray(np.arange(N_TRAIN, dtype=np.int32)[None, :])

    def pool_probs(draws, boot):
        """The port's distribution of a pipelined pool: a clone steps with
        it (a boot pool as a later step's pool, before the EMA's boot
        update moves on)."""
        probe = ts.clone()
        if boot:
            probe.step = 1
            draws = draws._replace(boot=None)
        return tstep(probe, draws._replace(uniforms=torch.full((1, B), 0.5)))[
            "sampler/probs"].numpy()

    steps, launches = [], 0
    for t in range(STEPS):
        rng = js.rng[0]
        new_js, jmetrics = jstep(js, jnp.asarray(x), jnp.asarray(y), shard)
        draws = worker_draws(tcfg, jax_kernels, rng, t, ts.stream.cursor, N_TRAIN, new_js,
                             pool_probs=pool_probs)
        reset_launch_counts()
        tmetrics = tstep(ts, draws)
        launches += sum(launch_counts.values())
        steps.append(dict(port={k: v.numpy().copy() for k, v in tmetrics.items()},
                          jax={k: np.asarray(v) for k, v in jmetrics.items()},
                          tcarried=carried_numpy(ts), jcarried=_carried_jax(new_js),
                          draws=draws, counters=(ts.step, ts.updates, ts.mini_step)))
        expect = check_params(ts.model.state_dict(), new_js, tcfg.lr, f"step {t}")
        ts.model.load_state_dict(expect)
        js = new_js
    return dict(steps=steps, cfg=tcfg, launches=launches, js=js)


_RUNS = {}


@pytest.fixture(params=list(CASES), scope="module")
def run(request):
    if request.param not in _RUNS:
        _RUNS[request.param] = _run(*CASES[request.param])
    return _RUNS[request.param]


def _rtol(cfg):
    return 1e-2 if cfg.scoring_dtype == "bfloat16" else 1e-5


def test_steps_match_jax(run):
    """Ten steps: every step's losses, telemetry and weights' histogram."""
    for t, s in enumerate(run["steps"]):
        check_metrics(s["port"], s["jax"], _rtol(run["cfg"]), f"step {t}")
    assert run["launches"] == 0  # the CPU launches no kernel


def test_carried_state_matches_jax(run):
    """The stream, the EMA and the mode's carried state after each step."""
    for t, s in enumerate(run["steps"]):
        check_carried(s["tcarried"], s["jcarried"], _rtol(run["cfg"]), f"step {t}")


def test_draws_and_counters(run):
    """Each uniform lies clear of the boundary band of its distribution's
    CDF (so both packages drew the same batch), the selections are those
    drawn, and the counters advance as JAX's (microsteps, updates)."""
    cfg = run["cfg"]
    for t, s in enumerate(run["steps"]):
        probs = s["port"]["sampler/probs"].astype(np.float64)
        u = s["draws"].uniforms.numpy()[0]
        assert np.min(np.abs(np.cumsum(probs)[None, :] - u[:, None])) > 1e-6, t
        sel = s["port"]["sampler/selected"]
        assert np.all(probs[sel] > 0)
        if cfg.use_groupwise:
            # Slots of the newest window: the generation's tag.
            assert np.all(s["tcarried"]["gw.group"][sel] == t + 1)
        assert s["counters"] == (t + 1, (t + 1) // cfg.grad_accum_steps,
                                 (t + 1) % cfg.grad_accum_steps)


def test_each_mode_reads_what_it_should(run):
    """Pipelined: the stream advances two pools at step 0 (the boot) and
    one after. Cadence: the pool loss is the cached one between refreshes,
    where clip and drift are 0. Groupwise: the stream is never read and the
    window wraps the 64-slot shard after four steps."""
    cfg, steps = run["cfg"], run["steps"]
    cursors = [s["tcarried"]["cursor"] for s in steps]
    if cfg.use_pipelined:
        assert cursors[:3] == [2 * POOL, 3 * POOL, 4 * POOL]
        assert steps[0]["tcarried"]["ema_count"] == 2
    elif cfg.use_cadence:
        for t, s in enumerate(steps):
            if t % K:
                assert float(s["port"]["sampler/clip_frac"]) == 0.0
                assert float(s["port"]["sampler/ema_drift"]) == 0.0
                assert s["port"]["train/pool_loss"] == steps[t - 1]["port"]["train/pool_loss"]
        assert steps[-1]["tcarried"]["ema_count"] == len(range(0, STEPS, K))
    else:
        assert cursors == [0] * STEPS
        assert [s["tcarried"]["gw.cursor"] for s in steps[:5]] == [16, 32, 48, 0, 16]


# ------------------------------------------------------------------ the group draw
# Its newest group's probabilities sum, in float32, to 1 − 2⁻²⁴ (checked
# in the test; most seeds sum to 1.0).
GROUP_SEED = 6


def _random_groupwise(seed, n=64, window=16, cursor=56, generations=3):
    """A JAX groupwise state after ``generations`` windows of random scores
    from ``cursor``, the newest one wrapping the shard's end."""
    rng = np.random.default_rng(seed)
    st = jgw.init_groupwise(n)._replace(cursor=jnp.asarray(cursor, jnp.int32))
    for _ in range(generations):
        idx = jgw.window_indices(st, window)
        st = jgw.update_importance(st, idx, jnp.asarray(rng.gamma(2.0, 1.0, window),
                                                        jnp.float32))
    return st


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_groupwise_functions_match_jax(seed):
    """``window_indices``, ``update_importance`` and ``draw`` on random
    states against the JAX package's: the window, the importance, tags,
    cursor and generation exactly; the draw (JAX's categorical fed as
    CDF-midpoint uniforms) its slots exactly and ``p·M`` to rtol 1e-6."""
    jst = _random_groupwise(seed, cursor=8 * seed)
    tst = groupwise_from_jax(*jst)
    idx = np.asarray(jgw.window_indices(jst, 16))
    np.testing.assert_array_equal(tgw.window_indices(tst, 16).numpy(), idx)
    scores = np.random.default_rng(seed + 10).gamma(2.0, 1.0, 16).astype(np.float32)
    jst = jgw.update_importance(jst, jnp.asarray(idx), jnp.asarray(scores))
    tst = tgw.update_importance(tst, torch.tensor(idx), torch.tensor(scores))
    np.testing.assert_array_equal(tst.importance.numpy(), np.asarray(jst.importance))
    np.testing.assert_array_equal(tst.group.numpy(), np.asarray(jst.group))
    assert (tst.cursor, tst.generation) == (int(jst.cursor), int(jst.generation))
    key = jax.random.key(seed)
    jsel, jscaled = jgw.draw(jst, key, 8)
    probs = tgw.group_probs(tst)[0].numpy()
    u = _uniforms_for(probs, np.asarray(jsel))
    sel, scaled, _ = tgw.draw(tst, u)
    np.testing.assert_array_equal(sel.numpy(), np.asarray(jsel))
    np.testing.assert_allclose(scaled.numpy(), np.asarray(jscaled), rtol=1e-6)


def test_group_draw_clamps_to_the_group():
    """A group that ends before L − 1 (the newest window is slots 40 … 55
    of 64): a uniform at 1 − 2⁻²⁴, at this group's float32 ``cdf[−1]``,
    draws the group's last slot, 55, with a finite weight > 0. The pool
    draw's clamp to L − 1 would give slot 63, outside the group, whose p
    is 0: an infinite reweighted loss."""
    st = groupwise_from_jax(*_random_groupwise(GROUP_SEED, cursor=8, generations=3))
    assert (st.cursor, st.generation) == (56, 3)
    in_group = (st.group == st.generation).numpy()
    assert in_group[40:56].all() and in_group.sum() == 16
    probs = tgw.group_probs(st)[0]
    u = torch.tensor([[1.0 - 2.0 ** -24, 0.0, 0.5]], dtype=torch.float32)
    assert float(u[0, 0]) >= float(torch.cumsum(probs, 0)[-1])
    assert int(draw_with_replacement(probs, u)[0]) == 63 and float(probs[63]) == 0.0
    sel, scaled, _ = tgw.draw(st, u)
    assert int(sel[0]) == 55 and in_group[sel.numpy()].all()
    assert bool(torch.isfinite(scaled).all()) and bool((scaled > 0).all())
    # The degenerate group (scores summing to 0): uniform over the group.
    flat = st._replace(importance=torch.zeros_like(st.importance))
    probs, size = tgw.group_probs(flat)
    assert float(size) == 16 and torch.equal(probs, torch.where(
        torch.tensor(in_group), 1.0 / 16, 0.0).float())


def test_a_window_longer_than_the_shard_keeps_the_last_score():
    st = tgw.init_groupwise(5)
    idx = tgw.window_indices(st, 8)  # 0 1 2 3 4 0 1 2
    st = tgw.update_importance(st, idx, torch.arange(8, dtype=torch.float32))
    assert st.importance.tolist() == [5.0, 6.0, 7.0, 3.0, 4.0]
    assert st.group.tolist() == [1] * 5 and (st.cursor, st.generation) == (3, 1)


# ------------------------------------------------------------------ save and restore
def _tiny(seed=0, **kw):
    """A Trainer on the CPU over the 64 images of the parity tests."""
    base = dict(COMMON, eval_every=0, log_every=0, steps_per_epoch=12)
    base.update(kw)
    (x, y), (xt, yt) = cifar.synthetic_cifar(10, N_TRAIN, 8, seed=0)
    dataset = make_sharded_dataset((x, y), (xt, yt), [np.arange(N_TRAIN)], MEAN, STD, 10,
                                   device=torch.device("cpu"))
    return Trainer(TrainConfig(**base), dataset=dataset, device="cpu",
                   model=tiny_resnet(seed=seed))


def _carried_tensors(state):
    out = state_tensors(state)
    for name in ("pending_batch", "cached_pool", "groupwise"):
        value = getattr(state, name)
        if value is not None:
            for k, v in value._asdict().items():
                out[f"{name}.{k}"] = torch.as_tensor(v).clone()
    return out


@pytest.mark.parametrize("kw,before", [
    (PIPELINED, 2),               # a batch in flight
    (CADENCE, 4),                 # between the refreshes at steps 3 and 6
    (GROUPWISE, 5),               # the 64-slot shard's window wrapped at step 4
], ids=["pipelined", "cadence", "groupwise"])
def test_resume_mid_mode_is_bit_exact(kw, before):
    """A save in the middle of each mode, then four steps live and four
    restored into a fresh Trainer (other weights): every tensor of the
    state bit-equal, the carried state included. A file restores only into
    a run of its mode."""
    live = _tiny(**kw)
    for _ in range(before):
        live.train_step()
    with tempfile.TemporaryDirectory() as d:
        live.save(d)
        saved = _carried_tensors(live.state)
        losses = [live.train_step()["train/loss"] for _ in range(4)]
        fresh = _tiny(seed=1, **kw)
        assert fresh.restore(d) == before
        restored = _carried_tensors(fresh.state)
        assert restored.keys() == saved.keys()
        assert any(k.startswith(("pending_batch", "cached_pool", "groupwise")) for k in saved)
        for k, v in saved.items():
            assert torch.equal(v, restored[k]), k
        again = [fresh.train_step()["train/loss"] for _ in range(4)]
        assert [float(a) for a in again] == [float(a) for a in losses]
        for k, v in _carried_tensors(live.state).items():
            assert torch.equal(v, _carried_tensors(fresh.state)[k]), k
        other = _tiny(**({"sampler": "pool"} if kw is GROUPWISE else {}))
        with pytest.raises(ValueError, match="pipelined_scoring|score_refresh_every|sampler"):
            other.restore(d)
        assert _tiny(**kw).restore(d) == before


@pytest.mark.parametrize("kw", [
    {**PIPELINED, "importance_score": "grad_norm", "fused_input": True},
    {**CADENCE, "importance_score": "grad_norm", "augmentation": "iid"},
    {**GROUPWISE, "scoring_dtype": "bfloat16", "cutout": True},
], ids=["pipelined-grad_norm-fused", "cadence-grad_norm-iid", "groupwise-bf16-cutout"])
def test_each_mode_composes_with_the_probe(kw):
    """Each mode with the grad-variance probe and other options of the
    pool step: finite losses, a positive ``var_ratio`` on the probe's
    steps and −1.0 on the others, and the weights' histogram summing to
    the batch."""
    tr = _tiny(variance_probe_every=2, **kw)
    for t in range(4):
        m = tr.train_step()
        assert np.isfinite(float(m["train/loss"])) and np.isfinite(float(m["train/pool_loss"]))
        ratio = float(m["sampler_dist/var_ratio"])
        assert ratio > 0 if (t + 1) % 2 == 0 else ratio == -1.0
        assert sum(int(m[k]) for k in jsh.hist_keys("w_hist")) == B


@pytest.mark.parametrize("kw", [PIPELINED, CADENCE, GROUPWISE],
                         ids=["pipelined", "cadence", "groupwise"])
def test_trainer_fits_each_mode(kw):
    """``fit`` runs each mode on the CPU when the CPU is asked for; the
    step's draws carry only what the mode reads."""
    tr = _tiny(**kw)
    draws = make_draws(tr.state, tr.config)
    assert (draws.boot is not None) == tr.config.use_pipelined
    assert (draws.aug2 is not None) == (not tr.config.use_pipelined)
    out = tr.fit(steps=4)
    assert tr.state.step == 4 and np.isfinite(out["train/loss"])
    reuse = make_draws(tr.state, tr.config)  # step 4: a cadence reuse step
    if tr.config.use_cadence:
        assert reuse.aug is None and reuse.perm is None
    assert reuse.boot is None
