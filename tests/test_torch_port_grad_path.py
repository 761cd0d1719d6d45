"""The gradient path's options in the port — ``zero_sharding`` and
``grad_compression`` ("stochastic", "int8") — against the JAX package on the
CPU, at one rank.

Sizes are ``test_torch_port_sampler_modes``'s: a [1, 1]-stage ResNet of
width 8, batch 4, a pool of 16, 64 synthetic images, float32. The JAX step
(``make_train_step`` on a one-device mesh, its kernels in interpret mode)
runs first; the port's draws are the JAX key of step t split 8 ways
(``worker_draws``) and the quantizers' uniforms that key gives
(:func:`grad_draws`): ``split(fold_in(rng, 0x71), n_leaves)`` one
``uniform`` a gradient leaf in the Flax layout (carried into the port's by
``params_from_flax``) under "stochastic", and ``split(fold_in(rng, 0x72))``
``uniform(k1, (W, chunk))`` and ``uniform(k2, (1, chunk))`` for the int8
wire (``jax.random.bernoulli(k, p)`` is ``uniform(k, p.shape) < p``).
After comparing a step the port's model takes the JAX step's parameters;
each package carries its optimizer's moments on its own.

Tolerances: the quantizers bit-exact given the same uniforms (int8 values,
scales and float32 outputs); the flat order exact; losses,
``train/sparse_rate`` and ``train/grad_norm`` rtol 1e-5 (read: at most
4.3e-7). Each step starts from JAX's parameters, so the parameters after it
are held to JAX's per leaf (:func:`check_update`): within 1e-3·lr (read:
8.3e-4·lr under ZeRO, 1.2e-4·lr under "stochastic"), and under the int8
wire within lr/100, one step of the update's int8 grid (max|u|/127 ≤
lr/127): the port's update is the chunk's change fl(p + u) − p, which
differs from optax's u in p's last bit, so some stochastic roundings of the
update take the other branch (33 of 5,266 elements at the first ZeRO+int8
step, each off by lr/127). At most :data:`FLIPS` elements of a step may
miss that bound (a gradient at rounding level whose Adam direction or int8
rounding differs), and every element stays within 2·lr, the bound of the
earlier parity tests of the step. ZeRO's chunk moments against the JAX
``opt_state`` rows: ``exp_avg`` and √``exp_avg_sq`` (both on the
gradient's scale) rtol 1e-5 and atol 1e-5 of the row's largest value. rtol
alone does not hold even without int8: the two frameworks' gradients differ
by float32 rounding of their largest terms (read: 5.6e-6 of the row's
largest value), which is up to 5% of an element whose terms cancel.
"""

import contextlib
import tempfile

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.flatten_util import ravel_pytree  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from mercury_tpu.compat import shard_map  # noqa: E402
from mercury_tpu.config import TrainConfig as JConfig  # noqa: E402
from mercury_tpu.models import resnet as jres  # noqa: E402
from mercury_tpu.parallel import collectives as jcoll  # noqa: E402
from mercury_tpu.parallel.mesh import host_cpu_mesh  # noqa: E402
from mercury_tpu.train import state as jstate  # noqa: E402
from mercury_tpu.train.step import make_train_step as jmake_train_step  # noqa: E402
from mercury_tpu.utils import quantize as jquant  # noqa: E402
from mercury_tpu_torch import TrainConfig, Trainer  # noqa: E402
from mercury_tpu_torch.data import cifar  # noqa: E402
from mercury_tpu_torch.data.pipeline import ShardStream, make_sharded_dataset  # noqa: E402
from mercury_tpu_torch.models import resnet as tres  # noqa: E402
from mercury_tpu_torch.models.convert import jax_flat_order, params_from_flax  # noqa: E402
from mercury_tpu_torch.parallel import collectives as tcoll  # noqa: E402
from mercury_tpu_torch.sampling.importance import EMAState  # noqa: E402
from mercury_tpu_torch.train import step as tstep_mod  # noqa: E402
from mercury_tpu_torch.train.state import create_state  # noqa: E402
from mercury_tpu_torch.train.step import make_draws, make_train_step  # noqa: E402
from mercury_tpu_torch.utils import quantize as tquant  # noqa: E402
from mercury_tpu_torch.utils.tree import zero_chunk_size  # noqa: E402

from test_torch_port_ranks import state_tensors, tiny_resnet  # noqa: E402
from test_torch_port_sampler_modes import (  # noqa: E402
    COMMON,
    MEAN,
    N_TRAIN,
    STD,
    _np_tree,
    _t,
    check_params,
    worker_draws,
)

STEPS = 3
CASES = {
    "zero": dict(zero_sharding=True),
    "stochastic": dict(grad_compression="stochastic"),
    "zero-int8": dict(zero_sharding=True, grad_compression="int8"),
    "zero-accum": dict(zero_sharding=True, grad_accum_steps=2),
}


@pytest.fixture(autouse=True, scope="module")
def one_intra_op_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# ------------------------------------------------------------------ helpers
def grad_draws(cfg, rng, params, batch_stats, world):
    """The quantizers' fields of the port's ``Draws`` from the JAX worker's
    key ``rng`` before the step: the uniforms its ``train_update`` draws."""
    if cfg.grad_compression == "stochastic":
        leaves, treedef = jax.tree_util.tree_flatten(params)
        keys = jax.random.split(jax.random.fold_in(rng, 0x71), len(leaves))
        u = jax.tree_util.tree_unflatten(treedef, [
            np.asarray(jax.random.uniform(k, leaf.shape, jnp.float32))
            for k, leaf in zip(keys, leaves)])
        port = params_from_flax(u, batch_stats)
        names = [name for name, _ in tiny_resnet().named_parameters()]
        return dict(grad_uniforms=tuple(port[name] for name in names))
    if cfg.grad_compression == "int8" and (cfg.zero_sharding or world > 1):
        chunk = zero_chunk_size(ravel_pytree(params)[0].size, world)
        k1, k2 = jax.random.split(jax.random.fold_in(rng, 0x72))
        return dict(wire_u1=_t(jax.random.uniform(k1, (world, chunk), jnp.float32)),
                    wire_u2=_t(jax.random.uniform(k2, (1, chunk), jnp.float32))[0])
    return {}


def adam_rows(opt_state):
    """``(mu, nu)`` of the JAX optimizer state, ``[W, chunk]`` under ZeRO
    (inside ``optax.MultiSteps`` too)."""
    found = [s for s in jax.tree_util.tree_leaves(
        opt_state, is_leaf=lambda s: hasattr(s, "mu") and hasattr(s, "nu"))
        if hasattr(s, "mu")]
    assert len(found) == 1
    return np.asarray(found[0].mu), np.asarray(found[0].nu)


def check_moments(optimizer, opt_state, rank, where):
    """The port's chunk moments against row ``rank`` of JAX's."""
    mu, nu = adam_rows(opt_state)
    if not optimizer.state:  # before the first update of an accumulation window
        assert not mu.any() and not nu.any(), where
        return
    (st,) = optimizer.state.values()
    check_moment_rows(st, mu[rank], nu[rank], where)


def check_moment_rows(st, mu, nu, where):
    """``exp_avg`` and √``exp_avg_sq`` of ``st`` against JAX's rows ``mu``
    and √``nu``: rtol 1e-5, atol 1e-5 of the row's largest value."""
    for name, got, want in (("exp_avg", st["exp_avg"], mu),
                            ("sqrt exp_avg_sq", st["exp_avg_sq"].sqrt(), np.sqrt(nu))):
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                                   atol=1e-5 * np.abs(want).max(), err_msg=f"{where}: {name}")


FLIPS = 3  # elements of a step that may miss check_update's bound


def check_update(got, want, cfg, where):
    """The port's parameters after a step that started from JAX's, against
    JAX's after that step, per leaf: within 1e-3·lr (lr/100 under the int8
    wire) but for at most :data:`FLIPS` elements of the model."""
    tol = cfg.lr / 100 if cfg.grad_compression == "int8" else 1e-3 * cfg.lr
    off = {}
    for name, w in want.items():
        if "running_" not in name:
            n = int((np.abs(got[name].numpy() - w.numpy()) > tol).sum())
            if n:
                off[name] = n
    assert sum(off.values()) <= FLIPS, f"{where}: elements more than {tol:g} from JAX's: {off}"


@contextlib.contextmanager
def quantizations():
    """Record the quantizers the port's step calls: ``"stochastic"`` for
    each gradient leaf, ``"int8"`` for each row set of the int8 wire."""
    calls = []
    quantize, rows = tstep_mod.stochastic_quantize, tcoll.quantize_rows

    def stochastic(u, a):
        calls.append("stochastic")
        return quantize(u, a)

    def int8(u, x):
        calls.append("int8")
        return rows(u, x)

    tstep_mod.stochastic_quantize, tcoll.quantize_rows = stochastic, int8
    try:
        yield calls
    finally:
        tstep_mod.stochastic_quantize, tcoll.quantize_rows = quantize, rows


def _jax_model():
    return jres.ResNet(stage_sizes=[1, 1], block_cls=jres.BasicBlock, num_classes=10,
                       num_filters=8, compute_dtype=jnp.float32)


def _run(kw):
    """``STEPS`` steps of each package from the same values at one rank;
    per step both packages' metrics, the port's moments and the JAX state."""
    (x, y), (xt, yt) = cifar.synthetic_cifar(10, N_TRAIN, 8, seed=0)
    jm = _jax_model()
    tcfg = TrainConfig(**COMMON, **kw)
    jcfg = JConfig(model="resnet18", use_pallas=True, telemetry=True, **COMMON, **kw)
    accum = tcfg.grad_accum_steps
    tx = jstate.make_optimizer("adam", jcfg.lr, COMMON["steps_per_epoch"],
                               grad_accum_steps=accum)
    js = jstate.create_state(jax.random.key(0), jm, tx, jnp.zeros((1, 32, 32, 3), jnp.float32),
                             1, N_TRAIN, zero_sharding=tcfg.zero_sharding)
    dataset = make_sharded_dataset((x, y), (xt, yt), [np.arange(N_TRAIN)], MEAN, STD, 10,
                                   device=torch.device("cpu"))
    model = tiny_resnet()
    model.load_state_dict(params_from_flax(_np_tree(js.params), _np_tree(js.batch_stats)))
    ts = create_state(model, "cpu", 0, N_TRAIN, "adam", tcfg.lr, COMMON["steps_per_epoch"],
                      grad_accum_steps=accum, zero_sharding=tcfg.zero_sharding)
    ts.stream = ShardStream(_t(js.stream.perm[0], torch.long), 0)
    ts.ema = EMAState(_t(js.ema.value[0]), _t(js.ema.count[0]))
    tstep = make_train_step(tcfg, dataset)
    jstep = jmake_train_step(jm, tx, jcfg, host_cpu_mesh(1), MEAN, STD)
    shard = jnp.asarray(np.arange(N_TRAIN, dtype=np.int32)[None, :])
    steps = []
    for t in range(STEPS):
        rng = js.rng[0]
        params, stats = _np_tree(js.params), _np_tree(js.batch_stats)
        new_js, jmetrics = jstep(js, jnp.asarray(x), jnp.asarray(y), shard)
        draws = worker_draws(tcfg, True, rng, t, ts.stream.cursor, N_TRAIN, new_js)
        draws = draws._replace(**grad_draws(tcfg, rng, params, stats, 1))
        with quantizations() as calls:
            tmetrics = tstep(ts, draws)
        got = {k: v.clone() for k, v in ts.model.state_dict().items()}
        if tcfg.zero_sharding:
            check_moments(ts.optimizer, new_js.opt_state, 0, f"step {t}")
        expect = check_params(got, new_js, tcfg.lr, f"step {t}")
        steps.append(dict(port={k: v.numpy().copy() for k, v in tmetrics.items()},
                          jax={k: np.asarray(v) for k, v in jmetrics.items()},
                          counters=(ts.step, ts.updates, ts.mini_step), calls=calls,
                          params=(got, expect)))
        ts.model.load_state_dict(expect)
        js = new_js
    return dict(cfg=tcfg, steps=steps, ts=ts, js=js)


_RUNS = {}


@pytest.fixture(params=list(CASES), scope="module")
def run(request):
    if request.param not in _RUNS:
        _RUNS[request.param] = _run(CASES[request.param])
    return _RUNS[request.param]


# ------------------------------------------------------------------ the flat order
@pytest.mark.parametrize("stages,jblock,tblock", [
    ([2, 2, 2, 2], jres.BasicBlock, tres.BasicBlock),
    ([3, 4, 23, 3], jres.Bottleneck, tres.Bottleneck),
], ids=["resnet18", "resnet101"])
def test_jax_flat_order_is_ravel_pytree(stages, jblock, tblock):
    """ResNet-18's and ResNet-101's layers (width 4): the port's
    parameters gathered by ``order`` are ``ravel_pytree`` of the Flax
    ``params`` exactly (every value distinct), and ``inverse`` takes them
    back. ResNet-101's 33 blocks sort ``Bottleneck_10`` before
    ``Bottleneck_2``."""
    jm = jres.ResNet(stage_sizes=stages, block_cls=jblock, num_classes=10, num_filters=4,
                     compute_dtype=jnp.float32)
    shapes = jax.eval_shape(lambda: jm.init(jax.random.key(0), jnp.zeros((1, 32, 32, 3)),
                                            train=False))
    at = [0]

    def distinct(s):
        n = int(np.prod(s.shape))
        at[0] += n
        return np.arange(at[0] - n, at[0], dtype=np.float32).reshape(s.shape)

    variables = jax.tree_util.tree_map(distinct, shapes)
    jvec = np.asarray(ravel_pytree(variables["params"])[0])
    model = tres.ResNet(stages, tblock, num_classes=10, num_filters=4)
    model.load_state_dict(params_from_flax(variables["params"], variables["batch_stats"]))
    pvec = torch.cat([p.detach().reshape(-1) for p in model.parameters()])
    order, inverse = jax_flat_order(model)
    assert order.dtype == inverse.dtype == torch.int64
    np.testing.assert_array_equal(pvec[order].numpy(), jvec)
    assert torch.equal(torch.tensor(jvec)[inverse], pvec)
    names = list(variables["params"])
    if len(stages) == 4 and stages[2] == 23:
        assert names.index("Bottleneck_10") < names.index("Bottleneck_2")


# ------------------------------------------------------------------ the quantizers
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_int8_quantizer_is_jax_bit_for_bit(seed):
    """``quantize_rows`` and ``stochastic_round`` given JAX's uniforms:
    the int8 values and the scales equal the compiled ``_quantize_rows``'
    (as the jitted step runs it) and ``_stochastic_round``'s, across rows
    of very different ranges, an all-zero row (scale 1e-30/127) and values
    past the clip."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((4, 777)).astype(np.float32)
    x *= np.array([[1.0], [3e-4], [0.0], [250.0]], np.float32)
    key = jax.random.key(seed)
    q, scale = jax.jit(jcoll._quantize_rows)(key, jnp.asarray(x))
    u = torch.tensor(np.asarray(jax.random.uniform(key, x.shape, jnp.float32)))
    tq, tscale = tcoll.quantize_rows(u, torch.tensor(x))
    assert tq.dtype == torch.int8 and tuple(tscale.shape) == (4, 1)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(q))
    np.testing.assert_array_equal(tscale.numpy(), np.asarray(scale))
    assert int(np.abs(np.asarray(q)).max()) <= 127
    y = rng.uniform(-140.0, 140.0, 3000).astype(np.float32)
    y[:40] = np.round(y[:40])  # integers: frac 0 never rounds up
    k2 = jax.random.fold_in(key, 1)
    want = np.asarray(jcoll._stochastic_round(k2, jnp.asarray(y)))
    u2 = torch.tensor(np.asarray(jax.random.uniform(k2, y.shape, jnp.float32)))
    np.testing.assert_array_equal(tcoll.stochastic_round(u2, torch.tensor(y)).numpy(), want)


def test_stochastic_round_is_strict():
    """``u < frac`` rounds up, ``u == frac`` down, and the clip is ±127."""
    y = torch.tensor([2.5, 2.5, -2.5, 200.0, -200.0])
    u = torch.tensor([0.5, 0.4999, 0.0, 0.0, 0.99])
    assert tcoll.stochastic_round(u, y).tolist() == [2, 3, -2, 127, -127]


@pytest.mark.parametrize("zeros", [0.0, 0.3, 1.0], ids=["dense", "sparse", "all-zero"])
def test_stochastic_quantize_is_jax(zeros):
    """``stochastic_quantize`` given JAX's uniforms equals
    ``mercury_tpu.utils.quantize``'s exactly (an all-zero tensor stays
    zero); ``sparsity`` to rtol 1e-6."""
    rng = np.random.default_rng(7)
    a = rng.standard_normal((6, 5, 3, 3)).astype(np.float32)
    a[rng.random(a.shape) < zeros] = 0.0
    key = jax.random.key(3)
    want = np.asarray(jquant.stochastic_quantize(key, jnp.asarray(a)))
    u = torch.tensor(np.asarray(jax.random.uniform(key, a.shape, jnp.float32)))
    got = tquant.stochastic_quantize(u, torch.tensor(a))
    np.testing.assert_array_equal(got.numpy(), want)
    # XLA's mean multiplies by the reciprocal of the count: one ulp apart.
    np.testing.assert_allclose(float(tquant.sparsity(got)),
                               float(jquant.sparsity(jnp.asarray(want))), rtol=1e-6)


def test_one_rank_rules():
    """At one rank the int8 all-reduce is the identity in both packages,
    while ZeRO's two int8 halves quantize in both, bit for bit given the
    same uniforms; the plain ZeRO pair is the identity."""
    rng = np.random.default_rng(0)
    vec = rng.standard_normal(1001).astype(np.float32)
    key = jax.random.key(5)
    k1, k2 = jax.random.split(key)
    np.testing.assert_array_equal(
        np.asarray(jcoll.compressed_allreduce_mean(jnp.asarray(vec), "data", 1, key)), vec)
    tvec = torch.tensor(vec)
    assert tcoll.compressed_allreduce_mean(tvec, None, None) is tvec
    mesh = host_cpu_mesh(1)

    def on_mesh(fn):
        return shard_map(fn, mesh=mesh, in_specs=P(), out_specs=P(), check_vma=False)

    rows = jnp.asarray(vec)[None]
    want_rs = np.asarray(on_mesh(
        lambda r: jcoll.compressed_psum_scatter_mean(r, "data", k1))(rows))
    want_ag = np.asarray(on_mesh(
        lambda c: jcoll.compressed_all_gather(c, "data", k2))(jnp.asarray(vec)))
    u1 = torch.tensor(np.asarray(jax.random.uniform(k1, (1, 1001), jnp.float32)))
    u2 = torch.tensor(np.asarray(jax.random.uniform(k2, (1, 1001), jnp.float32)))[0]
    got_rs = tcoll.compressed_psum_scatter_mean(tvec[None], u1)
    got_ag = tcoll.compressed_all_gather(tvec, u2)
    np.testing.assert_array_equal(got_rs.numpy(), want_rs)
    np.testing.assert_array_equal(got_ag.numpy(), want_ag)
    assert not np.array_equal(want_rs, vec) and not np.array_equal(want_ag, vec)
    assert torch.equal(tcoll.psum_scatter_mean(tvec[None]), tvec)
    assert tcoll.all_gather_flat(tvec) is tvec


# ------------------------------------------------------------------ steps against JAX
def test_steps_match_jax(run):
    """Each step's losses, ``train/sparse_rate`` and ``train/grad_norm``
    against the JAX step's (the parameters within 2·lr and, under ZeRO, the
    chunk's moments are held inside the run, every step); the counters
    advance as JAX's."""
    cfg = run["cfg"]
    for t, s in enumerate(run["steps"]):
        tm, jm = s["port"], s["jax"]
        where = f"step {t}"
        for key in ("train/loss", "train/pool_loss", "train/sparse_rate", "sampler/ess",
                    "train/grad_norm"):
            np.testing.assert_allclose(tm[key], jm[key], rtol=1e-5, err_msg=f"{where}: {key}")
        if cfg.grad_compression == "stochastic":
            assert 0.0 < float(tm["train/sparse_rate"]) < 1.0
        else:
            assert float(tm["train/sparse_rate"]) == 1.0
        a = cfg.grad_accum_steps
        assert s["counters"] == (t + 1, (t + 1) // a, (t + 1) % a)


def test_updates_match_jax(run):
    """Each step, from JAX's parameters: the port's parameters after it
    against JAX's, per leaf (:func:`check_update`). This holds the
    write-back of ZeRO's gathered update and of the int8 wire's mean."""
    for t, s in enumerate(run["steps"]):
        got, want = s["params"]
        check_update(got, want, run["cfg"], f"step {t}")


def test_quantizes_where_jax_does(run):
    """The port's step quantizes what the JAX step quantizes at one rank:
    each gradient leaf under "stochastic"; under ZeRO with "int8" the
    gradient rows and the update (both halves quantize at one rank);
    nothing otherwise."""
    cfg = run["cfg"]
    n_params = len(list(run["ts"].model.parameters()))
    want = {"stochastic": ["stochastic"] * n_params, "int8": ["int8", "int8"], "none": []}
    for t, s in enumerate(run["steps"]):
        assert s["calls"] == want[cfg.grad_compression], t


def test_zero_state_is_one_chunk(run):
    """Under ZeRO the optimizer holds one float32 tensor of the chunk's
    length (at W=1 the padded flat vector), the accumulator is one such
    tensor, and the JAX state's chunk rows have the same length."""
    cfg, ts = run["cfg"], run["ts"]
    if not cfg.zero_sharding:
        params = ts.optimizer.param_groups[0]["params"]
        assert ts.flat is None and len(params) == len(list(ts.model.parameters()))
        return
    (chunk,) = ts.optimizer.param_groups[0]["params"]
    n = sum(p.numel() for p in ts.model.parameters())
    assert chunk.shape == (zero_chunk_size(n, 1),) and ts.flat.n == n
    mu, _ = adam_rows(run["js"].opt_state)
    assert mu.shape == (1, chunk.numel())
    if cfg.grad_accum_steps > 1:
        assert [tuple(a.shape) for a in ts.accum] == [(n,)]


# ------------------------------------------------------------------ defaults, refusals
def _dataset(placement="replicated"):
    (x, y), (xt, yt) = cifar.synthetic_cifar(10, N_TRAIN, 8, seed=0)
    return make_sharded_dataset((x, y), (xt, yt), [np.arange(N_TRAIN)], MEAN, STD, 10,
                                device=torch.device("cpu"), placement=placement)


def _tiny(seed=0, **kw):
    base = dict(COMMON, eval_every=0, log_every=0, steps_per_epoch=12)
    base.update(kw)
    config = TrainConfig(**base)
    return Trainer(config, dataset=_dataset(config.data_placement), device="cpu",
                   model=tiny_resnet(seed=seed))


def test_options_off_keep_the_step():
    """With both options off the step draws what it drew before (the
    sampler's draws only, the same generator sequence) and returns
    ``train/sparse_rate`` 1.0; ``"int8"`` at one rank without ZeRO (the
    identity wire) draws nothing more and steps bit for bit as the default;
    ``"stochastic"`` draws the sampler's numbers first, then one uniform a
    gradient element."""
    plain, int8, stoch = _tiny(), _tiny(grad_compression="int8"), _tiny(
        grad_compression="stochastic")
    st, cfg = plain.state, plain.config
    before = st.generator.get_state()
    draws = make_draws(st, cfg)
    after = st.generator.get_state()
    st.generator.set_state(before)
    sampler = tstep_mod._sampler_draws(st, cfg)
    assert torch.equal(st.generator.get_state(), after)
    assert draws.grad_uniforms is draws.wire_u1 is draws.wire_u2 is None
    assert torch.equal(draws.uniforms, sampler.uniforms)
    st.generator.set_state(before)
    sd = make_draws(stoch.state, stoch.config)
    assert torch.equal(sd.uniforms, draws.uniforms) and torch.equal(sd.aug.crop, draws.aug.crop)
    assert [u.shape for u in sd.grad_uniforms] == [p.shape for p in stoch.state.model.parameters()]
    int8_gen = int8.state.generator.get_state()
    assert int8.state.flat is None and make_draws(int8.state, int8.config).wire_u1 is None
    assert torch.equal(int8.state.generator.get_state(), after)
    int8.state.generator.set_state(int8_gen)
    for _ in range(3):
        a, b = plain.train_step(), int8.train_step()
        assert float(a["train/sparse_rate"]) == float(b["train/sparse_rate"]) == 1.0
        for k in a:
            assert torch.equal(a[k], b[k]), k
    for k, v in state_tensors(plain.state).items():
        assert torch.equal(v, state_tensors(int8.state)[k]), k


def test_unknown_compression_is_refused():
    with pytest.raises(ValueError, match="grad_compression"):
        TrainConfig(grad_compression="fp8")
    for value in ("none", "stochastic", "int8"):
        for zero in (False, True):
            assert TrainConfig(grad_compression=value, zero_sharding=zero).grad_compression == value


@pytest.mark.parametrize("kw", [
    dict(zero_sharding=True, grad_accum_steps=2),
    dict(zero_sharding=True, grad_compression="int8"),
    dict(grad_compression="stochastic", sampler="scoretable", refresh_size=8),
    dict(zero_sharding=True, grad_compression="int8", data_placement="host_stream"),
    dict(grad_compression="stochastic", pipelined_scoring=True),
], ids=["zero-accum", "zero-int8", "stochastic-scoretable", "zero-int8-host_stream",
        "stochastic-pipelined"])
def test_resume_is_bit_exact(kw):
    """A save in the middle of an accumulation window (or after three
    steps), then four steps live and four on a fresh Trainer restored from
    the file: every tensor of the state bit-equal, ZeRO's chunk moments and
    accumulator included; under host_stream the ring's draws carry the
    quantizers' uniforms of the steps in flight."""
    live = _tiny(**kw)
    fresh = None
    try:
        for _ in range(3):
            live.train_step()
        if live.config.host_stream:
            assert all(d.wire_u1 is not None for d in live.state.pending.draws)
        with tempfile.TemporaryDirectory() as d:
            live.save(d)
            saved = state_tensors(live.state)
            losses = [float(live.train_step()["train/loss"]) for _ in range(4)]
            fresh = _tiny(seed=1, **kw)
            assert fresh.restore(d) == 3
            restored = state_tensors(fresh.state)
            assert restored.keys() == saved.keys()
            for k, v in saved.items():
                assert torch.equal(v, restored[k]), k
            assert [float(fresh.train_step()["train/loss"]) for _ in range(4)] == losses
            for k, v in state_tensors(live.state).items():
                assert torch.equal(v, state_tensors(fresh.state)[k]), k
    finally:
        live.close()
        if fresh is not None:
            fresh.close()


def test_a_zero_file_restores_only_into_zero():
    """A ZeRO checkpoint into a run without ZeRO, and the other way, raise
    ``ValueError`` naming ``zero_sharding``."""
    zero = _tiny(zero_sharding=True)
    zero.train_step()
    with tempfile.TemporaryDirectory() as d:
        zero.save(d)
        with pytest.raises(ValueError, match="zero_sharding"):
            _tiny().restore(d)
    plain = _tiny()
    plain.train_step()
    with tempfile.TemporaryDirectory() as d:
        plain.save(d)
        with pytest.raises(ValueError, match="zero_sharding"):
            _tiny(zero_sharding=True).restore(d)


OPTIONS = (dict(zero_sharding=True), dict(grad_compression="int8"),
           dict(grad_compression="stochastic"),
           dict(zero_sharding=True, grad_compression="int8", grad_accum_steps=2))


@pytest.mark.parametrize("kw", [
    {}, dict(use_importance_sampling=False), dict(sampler="scoretable", refresh_size=8),
    dict(sampler="groupwise", fused_input=True), dict(pipelined_scoring=True),
    dict(score_refresh_every=3), dict(data_placement="sharded"),
    dict(data_placement="host_stream", sampler="scoretable", refresh_size=8),
], ids=["pool", "uniform", "scoretable", "groupwise-fused", "pipelined", "cadence",
        "sharded", "host_stream-scoretable"])
def test_every_option_trains_with(kw):
    """Each option, and ZeRO with int8 and accumulation, with each sampler,
    mode and placement the port runs: a Trainer builds and takes three
    finite steps, with ``train/sparse_rate`` in (0, 1] (1.0 unless
    "stochastic")."""
    for option in OPTIONS:
        tr = _tiny(**kw, **option)
        try:
            for _ in range(3):
                m = tr.train_step()
                assert np.isfinite(float(m["train/loss"])), (kw, option)
                rate = float(m["train/sparse_rate"])
                if option.get("grad_compression") == "stochastic":
                    assert 0.0 < rate <= 1.0
                else:
                    assert rate == 1.0
            assert (tr.state.flat is not None) == option.get("zero_sharding", False)
        finally:
            tr.close()
