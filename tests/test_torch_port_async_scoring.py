"""``refresh_mode="async"`` in the port: the scorer fleet, the staleness-
weighted apply, the async step (the kernel route's one-slot sentinel
refresh and the plain decay → probs → inverse-CDF draw), the async host
stream, and the Trainer's fleet bookkeeping.

Port against the JAX package (``refresh_mode="async"``, a Flax ResNet of
width 8 on a one-device CPU mesh, the Pallas kernels in interpret mode),
fed the same weights, rows and draws:

- ``apply_async_chunk`` bit-equal to JAX's at ``w = 1`` and ``w = γ³``,
  and bit-equal to the port's sync refresh at age 0;
- ``score_once`` against JAX's ``ScorerFleet.score_once()`` at W=1, with
  JAX's crops and flips of each chunk's key fed in (loss and grad_norm
  scores, rtol 1e-5);
- three async steps with a chunk applied before each, against JAX's async
  step with ``use_pallas=False`` and ``True``, on JAX's uniforms; the
  port's model takes JAX's parameters after each step, the table and EMA
  evolve in each package (slots drawn exact; table, EMA, weights and
  scalars to rtol 1e-5);
- two async host-stream steps against JAX's ``hs_body`` under async.

Async runs are nondeterministic by design (a chunk's age follows thread
timing), so parity is held through ``score_once`` and chunks applied at
given ages; the live fleet is checked for what it must do whatever the
timing. Tiny sizes: a [1, 1]-stage ResNet of width 8, batch 4, windows of
8, 64 images (24 under the host stream).
"""

import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import chip_smoke  # noqa: E402
from mercury_tpu.config import TrainConfig as JConfig  # noqa: E402
from mercury_tpu.models import resnet as jres  # noqa: E402
from mercury_tpu.parallel.mesh import host_cpu_mesh  # noqa: E402
from mercury_tpu.sampling import scoretable as jtable  # noqa: E402
from mercury_tpu.sampling.scorer_fleet import ScorerFleet as JFleet  # noqa: E402
from mercury_tpu.train import state as jstate  # noqa: E402
from mercury_tpu.train.step import make_host_stream_prime  # noqa: E402
from mercury_tpu.train.step import make_train_step as jmake_train_step  # noqa: E402
from mercury_tpu_torch import TrainConfig, Trainer  # noqa: E402
from mercury_tpu_torch.data import cifar  # noqa: E402
from mercury_tpu_torch.data.pipeline import ShardStream, make_sharded_dataset  # noqa: E402
from mercury_tpu_torch.models import resnet as tres  # noqa: E402
from mercury_tpu_torch.models.convert import params_from_flax  # noqa: E402
from mercury_tpu_torch.ops import mercury_kernels as mk  # noqa: E402
from mercury_tpu_torch.sampling import scorer_fleet  # noqa: E402
from mercury_tpu_torch.sampling.importance import EMAState  # noqa: E402
from mercury_tpu_torch.sampling.scoretable import (  # noqa: E402
    apply_async_chunk,
    decay_scores,
    scatter_mean,
)
from mercury_tpu_torch.sampling.scorer_fleet import ScoreChunk, ScorerFleet  # noqa: E402
from mercury_tpu_torch.train.state import Augment, Draws, create_state  # noqa: E402
from mercury_tpu_torch.train.step import make_draws, make_train_step, prime_host_stream  # noqa: E402

from test_torch_port_ranks import tiny_resnet  # noqa: E402

B, R, N_TRAIN, STEPS, DECAY = 4, 8, 64, 3, 0.98
MEAN, STD = cifar.CIFAR10_MEAN, cifar.CIFAR10_STD
COMMON = dict(dataset="synthetic", world_size=1, batch_size=B, sampler="scoretable",
              refresh_size=R, refresh_mode="async", compute_dtype="float32",
              num_epochs=1, steps_per_epoch=10, seed=0)


@pytest.fixture(autouse=True, scope="module")
def one_intra_op_thread():
    """One intra-op thread: the tiny steps here run 30-50× slower with
    torch's thread pool on cores the test workers share."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _np_tree(tree):
    return jax.tree_util.tree_map(lambda a: np.array(a), tree)


def _augment(key, n):
    """JAX's crops and flips of ``augment_batch(key, ...)``."""
    k_crop, k_flip, _ = jax.random.split(key, 3)
    return Augment(torch.tensor(np.array(jax.random.randint(k_crop, (n, 2), 0, 9), np.int32)),
                   torch.tensor(np.array(jax.random.bernoulli(k_flip, shape=(n,)))))


def _jax_model():
    return jres.ResNet(stage_sizes=[1, 1], block_cls=jres.BasicBlock, num_classes=10,
                       num_filters=8, compute_dtype=jnp.float32)


def _port_model(params, stats):
    tm = tres.ResNet([1, 1], tres.BasicBlock, num_classes=10, num_filters=8)
    tm.load_state_dict(params_from_flax(params, stats))
    return tm


def _data(n=N_TRAIN):
    return cifar.synthetic_cifar(10, n, 8, seed=0)


def _dataset(placement="replicated", n=N_TRAIN):
    (x, y), (xt, yt) = _data(n)
    return make_sharded_dataset((x, y), (xt, yt), [np.arange(n)], MEAN, STD, 10,
                                device=torch.device("cpu"), placement=placement)


# ------------------------------------------------------------------ the apply
@pytest.mark.parametrize("case", ["w1", "gamma3", "sync_age0"])
def test_apply_async_chunk_is_bit_exact(case):
    rng = np.random.default_rng(5)
    scores = (rng.random(N_TRAIN) * 3 + 0.1).astype(np.float32)
    slots = np.array([3, 4, 4, 60, 61, 62, 63, 0], np.int64)   # a duplicate, a wrap
    values = (rng.random(R) * 5).astype(np.float32)
    ema = np.float32(1.37)
    weight = 1.0 if case != "gamma3" else DECAY ** 3
    got = apply_async_chunk(torch.tensor(scores), torch.tensor(slots), torch.tensor(values),
                            torch.tensor(ema), weight).numpy()
    if case == "sync_age0":
        # The step's own refresh of the decayed table: scatter_mean alone.
        decayed = decay_scores(torch.tensor(scores), torch.tensor(ema), DECAY)
        sync = scatter_mean(decayed, torch.tensor(slots), torch.tensor(values)).numpy()
        at0 = apply_async_chunk(decayed, torch.tensor(slots), torch.tensor(values),
                                torch.tensor(ema), DECAY ** 0).numpy()
        np.testing.assert_array_equal(at0, sync)
        return
    # JAX's function op by op: two float32 products and a sum. (Under jit
    # XLA:CPU contracts the product and the sum into an fma, which can move
    # an element by one ulp at w < 1; at w = 1 both are exact.)
    args = (jnp.asarray(scores), jnp.asarray(slots.astype(np.int32)), jnp.asarray(values),
            jnp.asarray(ema), jnp.float32(weight))
    np.testing.assert_array_equal(got, np.asarray(jtable.apply_async_chunk(*args)))
    if case == "w1":
        np.testing.assert_array_equal(got, np.asarray(jax.jit(jtable.apply_async_chunk)(*args)))
    untouched = np.setdiff1d(np.arange(N_TRAIN), slots)
    np.testing.assert_array_equal(got[untouched], scores[untouched])


# ------------------------------------------------------------------ the fleet
@pytest.fixture(scope="module")
def jax_weights():
    js = jstate.create_state(jax.random.key(0), _jax_model(),
                             jstate.make_optimizer("adam", 0.001, 10),
                             jnp.zeros((1, 32, 32, 3), jnp.float32), 1, N_TRAIN,
                             with_scoretable=True)
    return js, _np_tree(js.params), _np_tree(js.batch_stats)


@pytest.mark.parametrize("score", ["loss", "grad_norm"])
def test_score_once_matches_jax_fleet(score, jax_weights, monkeypatch):
    """Two chunks (windows 0:R and R:2R, chunk ids 0 and 1) of each fleet,
    from one snapshot at step 5, the port fed JAX's crops and flips of
    ``fold_in(fold_in(key(seed), 0x5C0), chunk_id)``."""
    js, params, stats = jax_weights
    (x, y), _ = _data()
    jcfg = JConfig(model="resnet18", telemetry=False, importance_score=score,
                   **{k: v for k, v in COMMON.items()})
    jfleet = JFleet(x, y, np.arange(N_TRAIN)[None], _jax_model(), MEAN, STD, jcfg)
    jfleet.close()  # no worker moves the cursor: score on this thread
    jfleet.snapshot(js.params, js.batch_stats, step=5)
    jchunks = [jfleet.score_once() for _ in range(2)]

    base = jax.random.fold_in(jax.random.key(jcfg.seed), 0x5C0)
    augs = iter([_augment(jax.random.split(jax.random.fold_in(base, k), 1)[0], R)
                 for k in range(2)])
    monkeypatch.setattr(scorer_fleet, "draw_augment", lambda gen, n, config: next(augs))
    tcfg = TrainConfig(importance_score=score, **COMMON)
    fleet = ScorerFleet(_dataset(), _port_model(params, stats), tcfg, "cpu")
    fleet.close()
    fleet.snapshot(_port_model(params, stats), 5)
    chunks = [fleet.score_once() for _ in range(2)]
    for k, (c, jc) in enumerate(zip(chunks, jchunks)):
        assert c.step == jc.step == 5
        np.testing.assert_array_equal(c.slots.numpy(), jc.slots[0])
        np.testing.assert_array_equal(c.slots.numpy(), np.arange(k * R, (k + 1) * R))
        assert c.scores.dtype == torch.float32
        np.testing.assert_allclose(c.scores.numpy(), jc.scores[0], rtol=1e-5, err_msg=str(k))
    summary = fleet.summary()
    assert summary["chunks_scored"] == 2 and summary["rows_scored"] == 2 * R
    assert summary["snapshot_step"] == 5 and summary["closed"]


def test_fleet_draws_from_its_own_generator():
    """A chunk's crops and flips depend on (seed, 0x5C0, chunk id) only:
    two fleets give the same scores, and the rank's generator is not
    read."""
    tcfg = TrainConfig(**COMMON)
    out = []
    for _ in range(2):
        model = tiny_resnet(seed=0)
        fleet = ScorerFleet(_dataset(), model, tcfg, "cpu")
        fleet.close()
        fleet.snapshot(model, 0)
        out.append([fleet.score_once().scores for _ in range(2)])
    assert torch.equal(out[0][0], out[1][0]) and torch.equal(out[0][1], out[1][1])
    assert not torch.equal(out[0][0], out[0][1])
    assert scorer_fleet.chunk_seed(0, 0) != scorer_fleet.chunk_seed(0, 1)
    assert scorer_fleet.chunk_seed(0, 0) != scorer_fleet.chunk_seed(1, 0)


# The draws of three steps from create_state's generator (seed 0), hashed:
# the default pool step's and the sync scoretable step's (and its iid and
# cutout variants') sequences as they were before the async step existed.
DRAW_DIGESTS = {(): "47e5a750de870e0a", (("sampler", "scoretable"),): "0a42e0c4d4afa0f1",
                (("sampler", "scoretable"), ("augmentation", "iid")): "a9699c8aa9263358",
                (("sampler", "scoretable"), ("cutout", True)): "be7cdcb04780c35c"}


@pytest.mark.parametrize("kw", sorted(DRAW_DIGESTS), ids=lambda kw: str(dict(kw)) or "pool")
def test_generator_sequence_is_unchanged(kw):
    import hashlib

    cfg = TrainConfig(dataset="synthetic", world_size=1, batch_size=4, refresh_size=8,
                      presample_batches=2, seed=0, **dict(kw))
    st = create_state(tres.ResNet([1, 1], tres.BasicBlock, num_classes=10, num_filters=8),
                      "cpu", 0, 24, "adam", cfg.lr, 10, with_scoretable=cfg.use_scoretable)
    h = hashlib.sha256()

    def add(x):
        if isinstance(x, torch.Tensor):
            h.update(x.numpy().tobytes())
        elif isinstance(x, tuple):
            for v in x:
                add(v)

    for _ in range(3):
        add(tuple(make_draws(st, cfg)))
    assert h.hexdigest()[:16] == DRAW_DIGESTS[kw]


def test_async_draws_are_uniforms_then_the_batch():
    cfg = TrainConfig(**COMMON)
    st = create_state(tiny_resnet(0), "cpu", 0, N_TRAIN, "adam", cfg.lr, 10,
                      with_scoretable=True)
    gen = torch.Generator()
    gen.set_state(st.generator.get_state())
    d = make_draws(st, cfg)
    assert d.aug is None and d.perm is None
    assert d.uniforms.shape == (1, B) and d.aug2.crop.shape == (B, 2)
    assert torch.equal(d.uniforms, torch.rand((1, B), generator=gen))
    assert torch.equal(d.aug2.crop, torch.randint(0, 9, (B, 2), generator=gen,
                                                  dtype=torch.int32))


# ------------------------------------------------------------------ the step
def _keys(rng, steps):
    out = [rng]
    for _ in range(steps - 1):
        out.append(jax.random.split(out[-1], 8)[7])
    return out


def _chunk(step_t, age, cursor, rng):
    """A chunk of the window at ``cursor``, scored ``age`` steps before
    ``step_t``: random scores from numpy."""
    slots = (cursor + np.arange(R)) % N_TRAIN
    return slots, (rng.random(R) * 3).astype(np.float32), step_t - age


@pytest.fixture(scope="module", params=[False, True], ids=["plain", "kernels"])
def async_steps(request):
    """Three async steps of each package from the same values, a chunk of
    age 0, 3 and 1 applied before each."""
    kernels = request.param
    (x, y), _ = _data()
    jm = _jax_model()
    jcfg = JConfig(model="resnet18", use_pallas=kernels, telemetry=True, **COMMON)
    tx = jstate.make_optimizer("adam", jcfg.lr, 10)
    js = jstate.create_state(jax.random.key(0), jm, tx, jnp.zeros((1, 32, 32, 3), jnp.float32),
                             1, N_TRAIN, with_scoretable=True, with_sel_counts=True)
    step = jmake_train_step(jm, tx, jcfg, host_cpu_mesh(1), MEAN, STD)
    shard = jnp.asarray(np.arange(N_TRAIN, dtype=np.int32)[None, :])
    keys = _keys(js.rng[0], STEPS)

    tcfg = TrainConfig(use_pallas=kernels, **COMMON)
    tm = _port_model(_np_tree(js.params), _np_tree(js.batch_stats))
    ts = create_state(tm, "cpu", 0, N_TRAIN, "adam", tcfg.lr, 10, with_scoretable=True,
                      with_sel_counts=True)
    ts.ema = EMAState(torch.tensor(float(js.ema.value[0])), torch.tensor(0, dtype=torch.int32))
    tstep = make_train_step(tcfg, _dataset())
    rng = np.random.default_rng(1)
    out = []
    for t, age in enumerate((0, 3, 1)):
        slots, values, scored_at = _chunk(t, age, t * R, rng)
        weight = DECAY ** (t - scored_at)
        jt = jtable.apply_async_chunk(js.scoretable.scores[0], jnp.asarray(slots, jnp.int32),
                                      jnp.asarray(values), js.ema.value[0],
                                      jnp.float32(weight))
        js = js.replace(scoretable=js.scoretable._replace(scores=jt[None]))
        ts.scoretable = ts.scoretable._replace(scores=apply_async_chunk(
            ts.scoretable.scores, torch.tensor(slots), torch.tensor(values), ts.ema.value,
            weight))
        applied = dict(t=ts.scoretable.scores.numpy().copy(), j=np.asarray(jt))
        ks = jax.random.split(keys[t], 8)
        shape = (1, B) if kernels else (B,)
        draws = Draws(perm=None, aug=None, aug2=_augment(ks[3], B),
                      uniforms=torch.tensor(np.array(jax.random.uniform(ks[2], shape)))[None]
                      .reshape(1, B))
        table_before = ts.scoretable.scores.clone()
        ema_before = ts.ema.value.clone()
        tmetrics = tstep(ts, draws, use_kernels=kernels)
        js, jmetrics = step(js, jnp.asarray(x), jnp.asarray(y), shard)
        out.append(dict(port={k: np.asarray(v) for k, v in tmetrics.items()},
                        jax={k: np.asarray(v) for k, v in jmetrics.items()},
                        applied=applied, table_before=table_before, ema_before=ema_before,
                        ttable=ts.scoretable.scores.numpy().copy(),
                        jtable=np.asarray(js.scoretable.scores[0]),
                        tcursor=ts.scoretable.cursor, jcursor=int(js.scoretable.cursor[0]),
                        tema=float(ts.ema.value), jema=float(js.ema.value[0]),
                        tcounts=ts.sel_counts.numpy().copy(),
                        jcounts=np.asarray(js.sel_counts[0])))
        # The port trains on from JAX's weights; table and EMA stay each
        # package's own.
        tm.load_state_dict(params_from_flax(_np_tree(js.params), _np_tree(js.batch_stats)))
    return dict(out=out, kernels=kernels)


def test_async_step_keys_match_jax(async_steps):
    for o in async_steps["out"]:
        tkeys, jkeys = set(o["port"]), set(o["jax"])
        assert jkeys == chip_smoke.JAX_STEP_KEYS["async"]
        assert tkeys - chip_smoke.PORT_ONLY_KEYS == jkeys - chip_smoke.JAX_ONLY_KEYS
        assert not any("table_age" in k for k in tkeys)


def test_async_steps_match_jax(async_steps):
    """The draws slot for slot, their weights p·L, the table after each
    apply (bit-equal at the first step) and after each step, the EMA from
    the trained batch, the ledger, the cursor kept, and every metric."""
    for t, o in enumerate(async_steps["out"]):
        msg = f"step {t}"
        tm, jm = o["port"], o["jax"]
        if t == 0:
            np.testing.assert_array_equal(o["applied"]["t"], o["applied"]["j"])
        else:
            np.testing.assert_allclose(o["applied"]["t"], o["applied"]["j"], rtol=1e-5,
                                       err_msg=msg)
        np.testing.assert_array_equal(o["tcounts"], o["jcounts"], err_msg=msg)
        np.testing.assert_allclose(o["ttable"], o["jtable"], rtol=1e-5, atol=1e-6,
                                   err_msg=msg)
        np.testing.assert_allclose(o["tema"], o["jema"], rtol=1e-5, err_msg=msg)
        assert o["tcursor"] == o["jcursor"] == 0
        for key, jv in jm.items():
            if key in chip_smoke.JAX_ONLY_KEYS:
                continue
            if "hist" in key:
                assert int(tm[key]) == int(jv), (msg, key)
            else:
                rtol = 1e-4 if key == "train/grad_norm" else 1e-5
                np.testing.assert_allclose(tm[key], jv, rtol=rtol, atol=1e-6,
                                           err_msg=f"{msg} {key}")
        assert float(tm["train/pool_loss"]) == 0.0


def test_async_step_trains_on_the_drawn_slots(async_steps):
    """The port's draw is the inverse CDF of its own probs on the given
    uniforms; the weights are p·L of the drawn slots; the trained slots
    were written back (and only they, beyond the decay)."""
    for o in async_steps["out"]:
        tm = o["port"]
        probs, sel = tm["sampler/probs"].astype(np.float64), tm["sampler/selected"]
        assert sel.shape == (B,) and probs.shape == (N_TRAIN,)
        np.testing.assert_allclose(probs.sum(), 1.0, rtol=1e-5)
        decayed = decay_scores(o["table_before"], o["ema_before"], DECAY).numpy()
        untouched = np.setdiff1d(np.arange(N_TRAIN), sel)
        np.testing.assert_array_equal(o["ttable"][untouched], decayed[untouched])


def test_kernel_route_sentinel_equals_the_plain_route():
    """From one state and draws: the kernel route (a one-slot refresh of
    slot 0 with its own decayed value; the plain versions on the CPU) and
    the plain route give the same table, slots, weights and probs; slot 0
    is the decay alone, bit for bit."""
    cfg = TrainConfig(**COMMON)
    st = create_state(tiny_resnet(0), "cpu", 0, N_TRAIN, "adam", cfg.lr, 10,
                      with_scoretable=True)
    rng = np.random.default_rng(3)
    st.scoretable = st.scoretable._replace(
        scores=torch.tensor((rng.random(N_TRAIN) * 3).astype(np.float32)))
    st.ema = EMAState(torch.tensor(1.25), torch.tensor(1, dtype=torch.int32))
    step = make_train_step(cfg, _dataset())
    draws = make_draws(st, cfg)
    decayed = decay_scores(st.scoretable.scores, st.ema.value, DECAY)
    out = {}
    for use_kernels in (True, False):
        s = st.clone()
        m = step(s, draws, use_kernels=use_kernels)
        out[use_kernels] = (m, s.scoretable.scores)
    (km, kt), (pm, pt) = out[True], out[False]
    assert torch.equal(km["sampler/selected"], pm["sampler/selected"])
    assert torch.equal(kt, pt)
    np.testing.assert_allclose(km["sampler/probs"], pm["sampler/probs"], rtol=1e-6)
    np.testing.assert_allclose(km["sampler/ess"], pm["sampler/ess"], rtol=1e-6)
    if 0 not in km["sampler/selected"].tolist():
        assert kt[0].item() == decayed[0].item()


# ------------------------------------------------------------ the host stream
HS_N = 24


@pytest.fixture(scope="module")
def hs_pair():
    """Two async host-stream steps of each package: the ring front's batch
    trained (B rows streamed), the table decayed and written back, the EMA
    from the trained batch, and the lookahead's inverse-CDF draw."""
    (x, y), _ = _data(HS_N)
    jm = _jax_model()
    kw = dict(COMMON, steps_per_epoch=10)
    jcfg = JConfig(model="resnet18", use_pallas=True, telemetry=True, prefetch_depth=2,
                   data_placement="host_stream", **kw)
    tx = jstate.make_optimizer("adam", jcfg.lr, 10)
    js = jstate.create_state(jax.random.key(0), jm, tx, jnp.zeros((1, 32, 32, 3), jnp.float32),
                             1, HS_N, with_scoretable=True, with_sel_counts=True,
                             stream_depth=2, stream_emit_size=B, stream_batch_size=B)
    params, stats = _np_tree(js.params), _np_tree(js.batch_stats)
    perm, rng0 = np.array(js.stream.perm[0]), js.rng[0]
    mesh = host_cpu_mesh(1)
    shard = jnp.asarray(np.arange(HS_N, dtype=np.int32)[None, :])
    js, jgidx = make_host_stream_prime(jcfg, mesh)(js, shard)
    jstep = jmake_train_step(jm, tx, jcfg, mesh, MEAN, STD)

    tcfg = TrainConfig(data_placement="host_stream", **kw)
    dataset = _dataset("host_stream", HS_N)
    tm = _port_model(params, stats)
    ts = create_state(tm, "cpu", 0, HS_N, "adam", tcfg.lr, 10, with_scoretable=True,
                      with_sel_counts=True)
    ts.stream = ShardStream(torch.tensor(perm, dtype=torch.long), 0)
    keys = _keys(rng0, 5)

    def draws(u):
        ks = jax.random.split(keys[u], 8)
        return Draws(perm=None, aug=None, aug2=_augment(ks[3], B),
                     uniforms=torch.tensor(np.array(jax.random.uniform(ks[2], (B,))))[None])

    tgidx = prime_host_stream(ts, tcfg, dataset, [draws(0), draws(1)]).numpy()
    step = make_train_step(tcfg, dataset)
    out = []
    for t in range(2):
        rows = ts.pending.slots[0].numpy()
        table_before, ema_before = ts.scoretable.scores.clone(), ts.ema.value.clone()
        tmetrics, tnext = step(ts, torch.from_numpy(x[rows]), draws(t + 2))
        js, jmetrics, jnext = jstep(js, jnp.asarray(x[rows][None]), jnp.asarray(y), shard)
        out.append(dict(port={k: np.asarray(v) for k, v in tmetrics.items()},
                        jax={k: np.asarray(v) for k, v in jmetrics.items()},
                        rows=rows, tnext=tnext.numpy(), jnext=np.asarray(jnext)[0],
                        tring=ts.pending.slots.numpy().copy(),
                        jring=np.asarray(js.pending_sel.slots[0]),
                        tscaled=ts.pending.scaled_probs.numpy().copy(),
                        jscaled=np.asarray(js.pending_sel.scaled_probs[0]),
                        ttable=ts.scoretable.scores.numpy().copy(),
                        jtable=np.asarray(js.scoretable.scores[0]),
                        tcursor=ts.scoretable.cursor, jcursor=int(js.scoretable.cursor[0]),
                        tema=float(ts.ema.value), jema=float(js.ema.value[0]),
                        table_before=table_before, ema_before=ema_before,
                        tcounts=ts.sel_counts.numpy().copy(),
                        jcounts=np.asarray(js.sel_counts[0])))
        tm.load_state_dict(params_from_flax(_np_tree(js.params), _np_tree(js.batch_stats)))
    return dict(tgidx=tgidx, jgidx=np.asarray(jgidx)[:, 0], out=out, cfg=tcfg)


def test_async_host_stream_prime_matches_jax(hs_pair):
    """The ring carries the flat draws alone: B slots a step."""
    assert hs_pair["cfg"].stream_rows == B
    assert hs_pair["tgidx"].shape == (2, B)
    np.testing.assert_array_equal(hs_pair["tgidx"], hs_pair["jgidx"])


def test_async_host_stream_steps_match_jax(hs_pair):
    for t, o in enumerate(hs_pair["out"]):
        msg = f"step {t}"
        assert o["rows"].shape == (B,)
        np.testing.assert_array_equal(o["tring"], o["jring"], err_msg=msg)
        np.testing.assert_array_equal(o["tnext"], o["jnext"], err_msg=msg)
        np.testing.assert_allclose(o["tscaled"], o["jscaled"], rtol=1e-5, err_msg=msg)
        np.testing.assert_allclose(o["ttable"], o["jtable"], rtol=1e-5, atol=1e-6,
                                   err_msg=msg)
        np.testing.assert_allclose(o["tema"], o["jema"], rtol=1e-5, err_msg=msg)
        np.testing.assert_array_equal(o["tcounts"], o["jcounts"], err_msg=msg)
        assert o["tcursor"] == o["jcursor"] == 0
        tm, jm = o["port"], o["jax"]
        assert set(tm) - chip_smoke.PORT_ONLY_KEYS == set(jm) - chip_smoke.JAX_ONLY_KEYS
        for key in ("train/loss", "sampler/ess", "sampler/clip_frac", "sampler/ema_drift",
                    "train/grad_norm", "train/pool_loss"):
            rtol = 1e-4 if key == "train/grad_norm" else 1e-5
            np.testing.assert_allclose(tm[key], jm[key], rtol=rtol, atol=1e-6,
                                       err_msg=f"{msg} {key}")
        # Nothing scored: the table before the write-back is the decay alone.
        decayed = decay_scores(o["table_before"], o["ema_before"], DECAY).numpy()
        untouched = np.setdiff1d(np.arange(HS_N), hs_pair["out"][t]["rows"])
        np.testing.assert_array_equal(o["ttable"][untouched], decayed[untouched])


# ------------------------------------------------------------------ refusals
@pytest.mark.parametrize("kw,field", [
    (dict(sampler="pool"), "refresh_mode"),
    (dict(use_importance_sampling=False), "refresh_mode"),
    (dict(world_size=2), "refresh_mode"),
    (dict(scorer_workers=0), "scorer_workers"),
    (dict(snapshot_every=0), "snapshot_every"),
    (dict(scorer_throttle_s=-0.1), "scorer_throttle_s"),
    (dict(scorer_backend="device", scorer_throttle_s=0.1), "scorer_throttle_s"),
    (dict(scorer_backend="device", refresh_mode="sync"), "scorer_backend"),
    (dict(scorer_backend="tpu"), "scorer_backend"),
])
def test_refusals(kw, field):
    with pytest.raises(ValueError, match=field):
        TrainConfig(**{**COMMON, **kw})


def test_jax_refuses_what_the_port_refuses():
    """The JAX step refuses async without the scoretable, and the JAX
    Trainer's composition check refuses the host fleet across processes and
    accepts the device backend's lockstep there, as the port does."""
    from mercury_tpu.sampling.scorer_service import validate_scorer_composition

    jm, tx = _jax_model(), jstate.make_optimizer("adam", 0.001, 10)
    with pytest.raises(ValueError, match="refresh_mode"):
        jmake_train_step(jm, tx, JConfig(**{**COMMON, "sampler": "pool"}), host_cpu_mesh(1),
                         MEAN, STD)
    with pytest.raises(ValueError, match="single-controller"):
        validate_scorer_composition(JConfig(**COMMON), 2)
    with pytest.raises(ValueError, match="single-controller"):
        TrainConfig(**{**COMMON, "world_size": 2})
    validate_scorer_composition(JConfig(**COMMON, scorer_backend="device"), 2)
    assert TrainConfig(**{**COMMON, "world_size": 2, "scorer_backend": "device"}).world_size == 2


# ------------------------------------------------------------------ the Trainer
def _trainer(**kw):
    cfg = TrainConfig(**{**COMMON, "eval_every": 0, "log_every": 0, **kw})
    return Trainer(cfg, dataset=_dataset(cfg.data_placement), device="cpu",
                   model=tiny_resnet(seed=0))


def _scorer_threads():
    return [t for t in threading.enumerate() if t.name.startswith("mercury-scorer-")]


def _wait_scored(fleet, n, timeout=60.0):
    deadline = time.monotonic() + timeout
    while fleet.summary()["chunks_scored"] < n:
        assert time.monotonic() < deadline, "the fleet scored nothing"
        time.sleep(0.01)


@pytest.mark.parametrize("placement", ["replicated", "host_stream"])
def test_fit_with_a_live_fleet(placement):
    tr = _trainer(log_every=8, snapshot_every=4, scorer_workers=2, data_placement=placement)
    try:
        assert len(_scorer_threads()) == 2
        _wait_scored(tr._scorer_fleet, 1)
        out = tr.fit(steps=8)
        assert np.isfinite(out["train/loss"])
        for key in ("scorer/throughput", "sampler/refresh_lag_chunks",
                    "threads/queue_depth/scorer", "sampler/score_staleness_mean",
                    "sampler/score_staleness_max", "sampler/chunks_rejected"):
            assert key in out and np.isfinite(out[key]), key
        assert out["sampler/chunks_rejected"] == 0.0
        assert out["sampler/score_staleness_max"] >= out["sampler/score_staleness_mean"] >= 0
        summary = tr._scorer_fleet.summary()
        assert summary["chunks_applied"] >= 1 and summary["snapshots"] == 3
        assert summary["snapshot_step"] == 8 and tr.state.scoretable.cursor == 0
        assert torch.isfinite(tr.state.scoretable.scores).all()
        assert set(tr.scorer_stats()) == set(out) & set(tr.scorer_stats())
    finally:
        tr.close()
    assert not _scorer_threads()


def test_nan_chunk_is_rejected_and_counted():
    tr = _trainer(scorer_throttle_s=30.0)
    try:
        _wait_scored(tr._scorer_fleet, 1)
        tr.train_step()
        table = tr.state.scoretable.scores.clone()
        bad = ScoreChunk(torch.arange(R), torch.full((R,), float("nan")), tr.state.step)
        tr._apply_chunks([bad], tr.state.step)
        assert torch.equal(tr.state.scoretable.scores, table)
        assert tr.scorer_stats()["sampler/chunks_rejected"] == 1.0
        good = ScoreChunk(torch.arange(R), torch.full((R,), 2.0), tr.state.step - 2)
        tr._apply_chunks([good], tr.state.step)
        w = np.float32(DECAY ** 2)
        want = np.float32(2.0) * w + np.float32(tr.state.ema.value) * (np.float32(1) - w)
        np.testing.assert_array_equal(tr.state.scoretable.scores[:R].numpy(),
                                      np.full(R, want, np.float32))
    finally:
        tr.close()


def test_restore_resets_the_fleet(tmp_path):
    """Nothing of the fleet is saved: the checkpoint restores into an
    async run, the queue is then empty and the snapshot is the restored
    step's."""
    tr = _trainer(checkpoint_dir=str(tmp_path), scorer_throttle_s=30.0)
    try:
        tr.fit(steps=3)   # saves at its end
        tr.train_step()
        _wait_scored(tr._scorer_fleet, 1)
        tr._scorer_fleet._ready.put(tr._scorer_fleet.score_once())
        assert tr._scorer_fleet.summary()["queue_depth"] >= 1
        saved = torch.load(tmp_path / "ckpt_3.pt", weights_only=False)
        assert not any("scorer" in str(k) or "fleet" in str(k) for k in saved)
        assert tr.restore() == 3
        summary = tr._scorer_fleet.summary()
        assert summary["queue_depth"] == 0 and summary["snapshot_step"] == 3
        assert tr.state.step == 3
        assert np.isfinite(float(tr.train_step()["train/loss"]))
    finally:
        tr.close()


def test_dead_worker_raises_at_the_next_drain(monkeypatch):
    def boom(*args):
        raise RuntimeError("scoring failed")

    monkeypatch.setattr(scorer_fleet.ScoringProgram, "__call__", boom)
    tr = _trainer()
    try:
        deadline = time.monotonic() + 30
        while tr._scorer_fleet.alive():
            assert time.monotonic() < deadline
            time.sleep(0.01)
        with pytest.raises(RuntimeError, match="scorer fleet worker died"):
            tr.train_step()
    finally:
        tr.close()


def test_close_twice_and_on_a_partly_built_trainer(tmp_path):
    tr = _trainer()
    assert _scorer_threads()
    tr.close()
    tr.close()
    assert not _scorer_threads()
    Trainer.__new__(Trainer).close()
    # A constructor that raises after the fleet started closes it.
    (tmp_path / "ckpt_5.pt").write_bytes(b"not a checkpoint")
    with pytest.raises(Exception):
        _trainer(checkpoint_dir=str(tmp_path), auto_resume=True)
    assert not _scorer_threads()


def test_fleet_launches_count_apart_from_the_step():
    """A launch inside ``counting_into`` (the fleet's scoring) counts into
    the fleet's dict, on that thread only; the step's stay in
    launch_counts."""
    mk.reset_launch_counts()
    fleet_counts = {k: 0 for k in mk.KERNELS}
    other = []
    with mk.counting_into(fleet_counts):
        mk._launched("nll_fwd", 0)
        thread = threading.Thread(target=lambda: other.append(mk._launched("nll_bwd", 0)))
        thread.start()
        thread.join()
    mk._launched("nll_bwd", 0)
    assert fleet_counts["nll_fwd"] == 1 and mk.launch_counts["nll_fwd"] == 0
    assert mk.launch_counts["nll_bwd"] == 2 and fleet_counts["nll_bwd"] == 0
    with pytest.raises(RuntimeError, match="failed to launch"):
        mk._launched("nll_fwd", 2)
    mk.reset_launch_counts()
    assert not any(mk.launch_counts.values())
