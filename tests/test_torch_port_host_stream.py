"""``data_placement="host_stream"`` in the port: the step that trains on
rows a prefetch pipeline sent and draws the selection of step t+depth, its
prime, its ring through a checkpoint, two ranks, and the pipeline itself.

- Port against port: the host-stream pool, fused pool and uniform steps
  are bit-equal to the replicated ones, at depth 2 and 3 (the draws of
  step t+depth are drawn at step t, in step order, from the one
  generator).
- Port against the JAX package: its host-stream ``make_train_step`` and
  ``make_host_stream_prime`` (``data_placement="host_stream"``, a Flax
  ResNet of width 8, kernels in interpret mode) on a one-device CPU mesh,
  fed the same weights, rows and draws. The draws of step u are the JAX
  key of step u split 8 ways: ``k_aug`` (and ``k_aug2``) split 3 ways into
  crops and flips, the pool draw's ``uniform(k_sel, (1, B))``, and the
  stream's ``permutation(k_stream, L)`` where it wraps. The JAX scoretable
  lookahead draws by ``categorical``: the port is fed that draw as
  uniforms at the middle of each drawn index's CDF interval (the prime's
  flat draw at ``(i + ½)/L``). Tolerances: slots and row ids exact; float32
  losses, EMA and table from two frameworks' forwards to rtol 1e-5.

Tiny sizes: a [1, 1]-stage ResNet of width 8, batch 4, a pool of 2×4, 24
images (the stream wraps every 3 pools).
"""

import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from mercury_tpu.config import TrainConfig as JConfig  # noqa: E402
from mercury_tpu.models import resnet as jres  # noqa: E402
from mercury_tpu.parallel.mesh import host_cpu_mesh  # noqa: E402
from mercury_tpu.train import state as jstate  # noqa: E402
from mercury_tpu.train.step import make_host_stream_prime  # noqa: E402
from mercury_tpu.train.step import make_train_step as jmake_train_step  # noqa: E402
from mercury_tpu_torch import TrainConfig, Trainer  # noqa: E402
from mercury_tpu_torch.data import cifar  # noqa: E402
from mercury_tpu_torch.data.pipeline import ShardStream, make_sharded_dataset  # noqa: E402
from mercury_tpu_torch.data.stream import HostStreamSource, PrefetchPipeline  # noqa: E402
from mercury_tpu_torch.models import resnet as tres  # noqa: E402
from mercury_tpu_torch.models.convert import params_from_flax  # noqa: E402
from mercury_tpu_torch.obs.sampler_health import (  # noqa: E402
    SCORE_HIST_HI,
    SCORE_HIST_LO,
    WEIGHT_HIST_HI,
    WEIGHT_HIST_LO,
    log_bin_histogram_np,
)
from mercury_tpu_torch.ops import launch_counts, reset_launch_counts  # noqa: E402
from mercury_tpu_torch.parallel.distributed import spawn  # noqa: E402
from mercury_tpu_torch.sampling.importance import EMAState  # noqa: E402
from mercury_tpu_torch.train.state import Augment, Draws, create_state  # noqa: E402
from mercury_tpu_torch.train.step import make_train_step, prime_host_stream  # noqa: E402

from test_torch_port_ranks import state_tensors, tiny_resnet, trainer_rank  # noqa: E402

B, PRESAMPLE, N_TRAIN, R = 4, 2, 24, 8
POOL = B * PRESAMPLE
MEAN, STD = cifar.CIFAR10_MEAN, cifar.CIFAR10_STD
COMMON = dict(dataset="synthetic", world_size=1, batch_size=B, presample_batches=PRESAMPLE,
              compute_dtype="float32", num_epochs=1, steps_per_epoch=10, eval_every=0,
              log_every=0, seed=0)


@pytest.fixture(autouse=True, scope="module")
def one_intra_op_thread():
    """The tiny steps here run one intra-op thread: with the test workers
    sharing the host's cores, torch's thread pool made each step of this
    size 30-50× slower (its barriers wait on descheduled threads)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _data():
    return cifar.synthetic_cifar(10, N_TRAIN, 8, seed=0)


def _dataset(placement):
    (x, y), (xt, yt) = _data()
    return make_sharded_dataset((x, y), (xt, yt), [np.arange(N_TRAIN)], MEAN, STD, 10,
                                device=torch.device("cpu"), placement=placement)


def _trainer(placement="host_stream", seed=0, **kw):
    config = TrainConfig(**{**COMMON, "data_placement": placement, **kw})
    return Trainer(config, dataset=_dataset(placement), device="cpu",
                   model=tiny_resnet(seed=seed))


def _run(trainer, steps):
    return [trainer.train_step() for _ in range(steps)]


# ---------------------------------------------------------------- port vs port
@pytest.mark.parametrize("depth", [2, 3])
@pytest.mark.parametrize("kw", [dict(use_importance_sampling=False), dict(),
                                dict(fused_input=True)],
                         ids=["uniform", "pool", "fused-pool"])
def test_host_stream_is_bit_equal_to_replicated(kw, depth):
    """Nine steps (three wraps of the stream): every loss, selection and
    parameter bit-equal; the stream ahead by depth pools."""
    rep, hs = _trainer("replicated", **kw), _trainer(prefetch_depth=depth, **kw)
    try:
        for a, b in zip(_run(rep, 9), _run(hs, 9)):
            assert torch.equal(a["train/loss"], b["train/loss"])
            assert torch.equal(a["sampler/selected"], b["sampler/selected"])
        for k, v in rep.state.model.state_dict().items():
            assert torch.equal(v, hs.state.model.state_dict()[k]), k
        assert torch.equal(rep.state.ema.value, hs.state.ema.value)
        assert hs.state.pending.slots.shape == (depth, hs.config.stream_rows)
        # 9 slabs popped; up to depth more sent ahead.
        slab = hs.config.stream_rows * 32 * 32 * 3
        stats = hs.stream_stats()
        assert stats["data/h2d_bytes"] in [k * slab for k in range(9, 10 + depth)]
        assert stats["data/stall_s"] >= 0.0 and 0 <= stats["data/queue_depth"] <= depth
    finally:
        hs.close()


def test_host_stream_trainer_basics():
    """The train pixels stay a host array, predict and evaluate read it,
    fit adds the data counters, close twice, and the step takes only
    what it was given."""
    tr = _trainer(sampler="scoretable", refresh_size=R, fused_input=True, log_every=2)
    try:
        assert isinstance(tr.dataset.x_train, np.ndarray)
        assert tr.dataset.y_train.device.type == "cpu"
        reset_launch_counts()
        out = tr.fit(steps=2)
        assert set(launch_counts.values()) == {0}
        assert {"data/stall_s", "data/queue_depth", "data/h2d_bytes"} <= set(out)
        slab = (R + B) * 3072  # the window and the batch, a step
        assert out["data/h2d_bytes"] in (2 * slab, 3 * slab, 4 * slab)
        assert tr.state.scoretable.cursor == 2 * R and int(tr.state.sel_counts.sum()) == 2 * B
        ev = tr.evaluate()
        assert np.isfinite(ev["train/eval_loss"]) and len(ev) == 4
        assert tr.predict(tr.dataset.x_train[:3]).shape == (3, 10)
        with pytest.raises(ValueError, match="x_stream"):
            tr._step_fn(tr.state, None)
    finally:
        tr.close()
        tr.close()
    with pytest.raises(ValueError, match="data_placement"):
        Trainer(TrainConfig(**{**COMMON, "data_placement": "host_stream"}),
                dataset=_dataset("replicated"), device="cpu", model=tiny_resnet(0))


# ------------------------------------------------------------- port vs JAX
def _augment(key, n):
    k_crop, k_flip, _ = jax.random.split(key, 3)
    return Augment(torch.tensor(np.array(jax.random.randint(k_crop, (n, 2), 0, 9), np.int32)),
                   torch.tensor(np.array(jax.random.bernoulli(k_flip, shape=(n,)))))


def _keys(rng, steps):
    """Step u's JAX key for u = 0 … steps−1: ``rng_{u+1} = split(rng_u, 8)[7]``."""
    out = [rng]
    for _ in range(steps - 1):
        out.append(jax.random.split(out[-1], 8)[7])
    return out


def _midpoints(probs, selected):
    """Uniforms the inverse-CDF draw turns into ``selected``."""
    cdf = np.cumsum(probs.astype(np.float64))
    lo = np.concatenate([[0.0], cdf[:-1]])
    return torch.tensor(((lo[selected] + cdf[selected]) / 2).astype(np.float32))[None]


def _jax_side(kw, table):
    (x, y), _ = _data()
    jm = jres.ResNet(stage_sizes=[1, 1], block_cls=jres.BasicBlock, num_classes=10,
                     num_filters=8, compute_dtype=jnp.float32)
    jcfg = JConfig(model="resnet18", use_pallas=True, telemetry=True, prefetch_depth=2,
                   data_placement="host_stream",
                   **{k: v for k, v in {**COMMON, **kw}.items()
                      if k not in ("eval_every", "log_every")})
    emit = R + B if table else POOL
    tx = jstate.make_optimizer("adam", jcfg.lr, 10)
    js = jstate.create_state(jax.random.key(0), jm, tx, jnp.zeros((1, 32, 32, 3), jnp.float32),
                             1, N_TRAIN, with_scoretable=table, with_sel_counts=table,
                             stream_depth=2, stream_emit_size=emit, stream_batch_size=B)
    snap = dict(params=jax.tree_util.tree_map(np.array, js.params),
                stats=jax.tree_util.tree_map(np.array, js.batch_stats),
                perm=np.array(js.stream.perm[0]), rng=js.rng[0])
    mesh = host_cpu_mesh(1)
    shard = jnp.asarray(np.arange(N_TRAIN, dtype=np.int32)[None, :])
    js, gidx = make_host_stream_prime(jcfg, mesh)(js, shard)
    step = jmake_train_step(jm, tx, jcfg, mesh, MEAN, STD)
    return dict(x=x, y=y, js=js, gidx=np.asarray(gidx)[:, 0], snap=snap, step=step,
                shard=shard, jcfg=jcfg)


def _port_state(snap, tcfg, table):
    tm = tres.ResNet([1, 1], tres.BasicBlock, num_classes=10, num_filters=8)
    tm.load_state_dict(params_from_flax(snap["params"], snap["stats"]))
    ts = create_state(tm, "cpu", 0, N_TRAIN, "adam", tcfg.lr, 10, with_scoretable=table,
                      with_sel_counts=tcfg.use_ledger)
    ts.stream = ShardStream(torch.tensor(snap["perm"], dtype=torch.long), 0)
    ts.ema = EMAState(torch.tensor(0.0), torch.tensor(0, dtype=torch.int32))
    return ts


POOL_STEPS = 4


@pytest.fixture(scope="module")
def pool_pair():
    """Four host-stream pool steps of each package from the same values
    (the stream wraps on the second step's lookahead)."""
    j = _jax_side({}, table=False)
    tcfg = TrainConfig(**COMMON, data_placement="host_stream")
    dataset = _dataset("host_stream")
    ts = _port_state(j["snap"], tcfg, table=False)
    keys = _keys(j["snap"]["rng"], POOL_STEPS + 2)

    def draws(u, cursor):
        ks = jax.random.split(keys[u], 8)
        perm = None
        if cursor + POOL > N_TRAIN:
            perm = torch.tensor(np.array(jax.random.permutation(ks[0], N_TRAIN)),
                                dtype=torch.long)
        return Draws(perm=perm, aug=_augment(ks[1], POOL),
                     uniforms=torch.tensor(np.array(jax.random.uniform(ks[2], (1, B)))))

    primed = [draws(0, 0), draws(1, POOL)]
    tgidx = prime_host_stream(ts, tcfg, dataset, primed).numpy()
    step = make_train_step(tcfg, dataset)
    js, out = j["js"], []
    for t in range(POOL_STEPS):
        rows = ts.pending.slots[0].numpy()
        tm, tnext = step(ts, torch.from_numpy(j["x"][rows]), draws(t + 2, ts.stream.cursor))
        js, jm, jnext = j["step"](js, jnp.asarray(j["x"][rows][None]), jnp.asarray(j["y"]),
                                  j["shard"])
        out.append(dict(port=tm, jax=jm, tnext=tnext.numpy(), jnext=np.asarray(jnext)[0],
                        tring=ts.pending.slots.numpy().copy(),
                        jring=np.asarray(js.pending_sel.slots[0]),
                        tema=float(ts.ema.value), jema=float(js.ema.value[0])))
    return dict(j=j, tgidx=tgidx, out=out)


def test_pool_prime_matches_jax(pool_pair):
    np.testing.assert_array_equal(pool_pair["tgidx"], pool_pair["j"]["gidx"])


def test_pool_steps_match_jax(pool_pair):
    """The streamed pool's slots are param-independent: the ring and the
    emitted row ids equal JAX's at every step; the losses and the EMA to
    rtol 1e-5 (the first step from equal weights; later ones after
    Adam updates of two frameworks' gradients, which agree to ~lr)."""
    for t, o in enumerate(pool_pair["out"]):
        np.testing.assert_array_equal(o["tnext"], o["jnext"], err_msg=str(t))
        np.testing.assert_array_equal(o["tring"], o["jring"], err_msg=str(t))
    first = pool_pair["out"][0]
    np.testing.assert_allclose(float(first["port"]["train/loss"]),
                               float(first["jax"]["train/loss"]), rtol=1e-5)
    np.testing.assert_allclose(first["tema"], first["jema"], rtol=1e-5)
    for key in ("sampler/ess", "sampler/clip_frac", "sampler/ema_drift"):
        np.testing.assert_allclose(float(first["port"][key]), float(first["jax"][key]),
                                   rtol=1e-5, atol=1e-6, err_msg=key)
    for o in pool_pair["out"][1:]:
        np.testing.assert_allclose(float(o["port"]["train/loss"]),
                                   float(o["jax"]["train/loss"]), rtol=1e-2)


TABLE_KW = dict(sampler="scoretable", refresh_size=R, fused_input=True)


@pytest.fixture(scope="module")
def table_pair():
    """Two host-stream scoretable steps of each package from the same
    values: the window scored, the EMA, decay and scatter, the ring
    front's batch trained, the write-back and the lookahead draw."""
    j = _jax_side(TABLE_KW, table=True)
    tcfg = TrainConfig(**COMMON, data_placement="host_stream", **TABLE_KW)
    dataset = _dataset("host_stream")
    ts = _port_state(j["snap"], tcfg, table=True)
    keys = _keys(j["snap"]["rng"], 5)

    def draws(u, uniforms=None):
        ks = jax.random.split(keys[u], 8)
        return Draws(perm=None, aug=_augment(ks[1], R), aug2=_augment(ks[3], B),
                     uniforms=uniforms)

    flat = np.full(N_TRAIN, 1.0 / N_TRAIN, np.float32)
    primed = []
    for u in range(2):
        drawn = np.asarray(jax.random.categorical(jax.random.split(keys[u], 8)[2],
                                                  jnp.log(jnp.asarray(flat)), shape=(B,)))
        primed.append(draws(u, _midpoints(flat, drawn)))
    tgidx = prime_host_stream(ts, tcfg, dataset, primed).numpy()
    step = make_train_step(tcfg, dataset)
    js, out = j["js"], []
    for t in range(2):
        rows = ts.pending.slots[0].numpy()
        x_stream = torch.from_numpy(j["x"][rows])
        # The JAX lookahead's categorical draw over the port's distribution.
        probe = ts.clone()
        probs = step(probe, x_stream, draws(t + 2, torch.full((1, B), 0.5)))[0]
        probs = probs["sampler/probs"].numpy()
        drawn = np.asarray(jax.random.categorical(jax.random.split(keys[t + 2], 8)[2],
                                                  jnp.log(jnp.asarray(probs)), shape=(B,)))
        nd = draws(t + 2, _midpoints(probs, drawn))
        tm, tnext = step(ts, x_stream, nd)
        js, jm, jnext = j["step"](js, jnp.asarray(j["x"][rows][None]), jnp.asarray(j["y"]),
                                  j["shard"])
        out.append(dict(port={k: np.asarray(v) for k, v in tm.items()},
                        jax={k: np.asarray(v) for k, v in jm.items()},
                        tnext=tnext.numpy(), jnext=np.asarray(jnext)[0],
                        tring=ts.pending.slots.numpy().copy(),
                        jring=np.asarray(js.pending_sel.slots[0]),
                        tscaled=ts.pending.scaled_probs.numpy().copy(),
                        jscaled=np.asarray(js.pending_sel.scaled_probs[0]),
                        ttable=ts.scoretable.scores.numpy().copy(),
                        jtable=np.asarray(js.scoretable.scores[0]),
                        tcursor=ts.scoretable.cursor, jcursor=int(js.scoretable.cursor[0]),
                        tema=float(ts.ema.value), jema=float(js.ema.value[0]),
                        tcounts=ts.sel_counts.numpy().copy(),
                        jcounts=np.asarray(js.sel_counts[0]), probs=probs, drawn=drawn))
    return dict(j=j, tgidx=tgidx, out=out)


def test_scoretable_prime_matches_jax(table_pair):
    """The round-robin windows and the flat draws, slot for slot."""
    np.testing.assert_array_equal(table_pair["tgidx"], table_pair["j"]["gidx"])


def test_scoretable_first_step_matches_jax(table_pair):
    o = table_pair["out"][0]
    for key in ("train/loss", "train/pool_loss", "sampler/ess", "sampler/clip_frac",
                "sampler/ema_drift", "train/grad_norm"):
        np.testing.assert_allclose(o["port"][key], o["jax"][key], rtol=1e-5, atol=1e-6,
                                   err_msg=key)
    np.testing.assert_allclose(o["tema"], o["jema"], rtol=1e-5)
    np.testing.assert_allclose(o["ttable"], o["jtable"], rtol=1e-5, atol=1e-6)
    assert o["tcursor"] == o["jcursor"] == R
    np.testing.assert_array_equal(o["tcounts"], o["jcounts"])
    # The histograms: the port's equal its numpy reference's bins of the
    # unit weights and of its table; JAX's hold the same counts, though
    # XLA's fused arithmetic may bin a value on an edge (a weight of
    # exactly 1.0 is one) into the bin below.
    for fam, values, lo, hi in (("w_hist", np.ones(B), WEIGHT_HIST_LO, WEIGHT_HIST_HI),
                                ("score_hist", o["ttable"], SCORE_HIST_LO, SCORE_HIST_HI)):
        keys = [f"sampler_dist/{fam}/b{i:02d}" for i in range(16)]
        port = [int(o["port"][k]) for k in keys]
        assert port == log_bin_histogram_np(values, lo, hi).tolist(), fam
        assert sum(int(o["jax"][k]) for k in keys) == sum(port) == len(values), fam


def test_scoretable_ring_and_rows_match_jax(table_pair):
    """The ring's slots (windows exact, the lookahead's draws through the
    CDF midpoints) and its weights p·L; the emitted row ids; both steps."""
    for t, o in enumerate(table_pair["out"]):
        np.testing.assert_array_equal(o["tring"], o["jring"], err_msg=str(t))
        np.testing.assert_array_equal(o["tnext"], o["jnext"], err_msg=str(t))
        np.testing.assert_array_equal(o["tnext"][R:], o["drawn"])
        np.testing.assert_allclose(o["tscaled"], o["jscaled"], rtol=1e-5, err_msg=str(t))
    second = table_pair["out"][1]
    np.testing.assert_allclose(second["port"]["train/loss"], second["jax"]["train/loss"],
                               rtol=1e-2)


# ------------------------------------------------------------- the pipeline
class _Source:
    """Row i holds the value i; an optional delay a gather, or a failure."""

    def __init__(self, n=32, delay=0.0, fail_at=None):
        self.x = np.repeat(np.arange(n, dtype=np.uint8)[:, None], 5, axis=1)
        self.row_shape, self.dtype = (5,), np.dtype(np.uint8)
        self.delay, self.fail_at, self.calls, self.closed = delay, fail_at, 0, 0

    def gather(self, gidx, out):
        self.calls += 1
        if self.fail_at == self.calls:
            raise OSError("disk went away")
        time.sleep(self.delay)
        out[:] = self.x[gidx]

    def close(self):
        self.closed += 1


def test_pipeline_pops_in_push_order_and_counts_bytes():
    src = _Source()
    pipe = PrefetchPipeline(src, rows=3, device="cpu", depth=2)
    try:
        sels = [np.array([i, i + 1, i + 2]) for i in range(0, 18, 3)]
        pipe.push(sels[0])
        pipe.push(torch.tensor(sels[1]))
        for i, sel in enumerate(sels):
            if i + 2 < len(sels):
                pipe.push(sels[i + 2])
            batch = pipe.pop()
            assert batch.dtype == torch.uint8 and batch.shape == (3, 5)
            assert torch.equal(batch[:, 0], torch.from_numpy(sel).to(torch.uint8))
        s = pipe.summary()
        assert s["pops"] == 6 and s["total_h2d_bytes"] == 6 * 15
        stats = pipe.stats()
        assert stats["data/h2d_bytes"] == 90 and stats["data/queue_depth"] == 0
        assert pipe.stats()["data/h2d_bytes"] == 0  # a delta since the last call
    finally:
        pipe.close()
    pipe.close()
    assert src.closed == 1 and not pipe.alive()
    with pytest.raises(RuntimeError, match="closed"):
        pipe.push(np.arange(3))


def test_pipeline_accounts_stall_and_wait_apart():
    """A slow gather is input stall; a pop that waits for a push that has
    not come is a wait, not a stall."""
    pipe = PrefetchPipeline(_Source(delay=0.2), rows=2, device="cpu", depth=1)
    try:
        pipe.push(np.array([0, 1]))
        pipe.pop()
        assert 0.15 < pipe.total_stall_s <= pipe.total_wait_s
        stall = pipe.total_stall_s
        pipe.source.delay = 0.0

        def late_push():
            time.sleep(0.3)
            pipe.push(np.array([2, 3]))

        threading.Thread(target=late_push).start()
        pipe.pop()
        assert pipe.total_wait_s - stall > 0.25
        assert pipe.total_stall_s - stall < 0.1
    finally:
        pipe.close()


def test_dead_worker_raises_at_next_pop_with_its_traceback():
    pipe = PrefetchPipeline(_Source(fail_at=2), rows=2, device="cpu", depth=2)
    try:
        pipe.push(np.array([0, 1]))
        pipe.push(np.array([2, 3]))
        deadline = time.monotonic() + 10
        while pipe.alive() and time.monotonic() < deadline:
            time.sleep(0.01)
        assert not pipe.alive()
        with pytest.raises(RuntimeError, match="prefetch worker died") as err:
            pipe.pop()
        assert "disk went away" in str(err.value) and "gather" in str(err.value)
        assert isinstance(err.value.__cause__, OSError)
    finally:
        pipe.close()


def test_reset_drops_the_old_trajectory():
    pipe = PrefetchPipeline(_Source(), rows=2, device="cpu", depth=2)
    try:
        pipe.push(np.array([0, 1]))
        pipe.push(np.array([2, 3]))
        pipe.reset()
        pipe.push(np.array([9, 9]))
        assert torch.equal(pipe.pop()[:, 0], torch.tensor([9, 9], dtype=torch.uint8))
    finally:
        pipe.close()


def test_memmap_source_and_decode_workers(tmp_path):
    """A memmap file gathers as its array does, and two gather threads give
    what one does."""
    rng = np.random.default_rng(0)
    x = rng.integers(0, 256, (40, 4, 4, 3), dtype=np.uint8)
    path = tmp_path / "rows.u8"
    x.tofile(path)
    mm = np.memmap(path, dtype=np.uint8, mode="r", shape=x.shape)
    gidx = rng.integers(0, 40, 13)
    outs = []
    for workers in (0, 2):
        src = HostStreamSource(mm, decode_workers=workers)
        out = np.empty((13, 4, 4, 3), np.uint8)
        src.gather(gidx, out)
        src.close()
        outs.append(out)
    np.testing.assert_array_equal(outs[0], x[gidx])
    np.testing.assert_array_equal(outs[1], outs[0])
    pipe = PrefetchPipeline(HostStreamSource(mm, decode_workers=2), rows=13, device="cpu")
    try:
        pipe.push(torch.from_numpy(gidx))
        np.testing.assert_array_equal(pipe.pop().numpy(), x[gidx])
    finally:
        pipe.close()


def test_memmap_dataset_trains_like_the_array(tmp_path):
    """A Trainer over an np.memmap of the train split gives the array's
    steps, and decode_workers=2 the same."""
    (x, y), (xt, yt) = _data()
    path = tmp_path / "train.u8"
    x.tofile(path)
    mm = np.memmap(path, dtype=np.uint8, mode="r", shape=x.shape)
    ds = make_sharded_dataset((mm, y), (xt, yt), [np.arange(N_TRAIN)], MEAN, STD, 10,
                              device=torch.device("cpu"), placement="host_stream")
    assert isinstance(ds.x_train, np.memmap)
    config = TrainConfig(**COMMON, data_placement="host_stream", decode_workers=2)
    a = Trainer(config, dataset=ds, device="cpu", model=tiny_resnet(0))
    b = _trainer()
    try:
        for m, n in zip(_run(a, 4), _run(b, 4)):
            assert torch.equal(m["train/loss"], n["train/loss"])
    finally:
        a.close()
        b.close()


# -------------------------------------------------------------- checkpoints
def test_resume_with_the_ring_in_flight_is_bit_exact(tmp_path):
    """Save after 3 steps with depth 2 selections in flight, 4 more live;
    a fresh Trainer (other weights) restores and runs the same 4."""
    kw = dict(sampler="scoretable", refresh_size=R, fused_input=True)
    live = _trainer(**kw)
    fresh = _trainer(seed=1, **kw)
    try:
        _run(live, 3)
        live.save(str(tmp_path))
        saved = state_tensors(live.state)
        ring = live.state.pending
        a = [m["train/loss"] for m in _run(live, 4)]
        assert fresh.restore(str(tmp_path)) == 3
        assert torch.equal(fresh.state.pending.slots, ring.slots)
        assert torch.equal(fresh.state.pending.scaled_probs, ring.scaled_probs)
        restored = state_tensors(fresh.state)
        assert restored.keys() == saved.keys()
        for k, v in saved.items():
            assert torch.equal(torch.as_tensor(v), torch.as_tensor(restored[k])), k
        b = [m["train/loss"] for m in _run(fresh, 4)]
        assert a == b
        for k, v in state_tensors(live.state).items():
            assert torch.equal(torch.as_tensor(v), torch.as_tensor(state_tensors(fresh.state)[k])), k
    finally:
        live.close()
        fresh.close()


def test_replicated_checkpoint_reprimes_into_host_stream(tmp_path):
    """A replicated run's file has no ring: restored into a host_stream
    run, the ring is primed anew from the restored generator and stream,
    and the pool steps go on exactly as the replicated run's. A ring does
    not restore into a replicated run, nor into another depth."""
    rep = _trainer("replicated")
    _run(rep, 4)
    rep.save(str(tmp_path / "rep"))
    hs = _trainer()
    try:
        assert hs.restore(str(tmp_path / "rep")) == 4
        assert hs.state.pending is not None and hs.state.step == 4
        for a, b in zip(_run(rep, 5), _run(hs, 5)):
            assert torch.equal(a["train/loss"], b["train/loss"])
        hs.save(str(tmp_path / "hs"))
        with pytest.raises(ValueError, match="host_stream"):
            _trainer("replicated").restore(str(tmp_path / "hs"))
        deeper = _trainer(prefetch_depth=3)
        try:
            with pytest.raises(ValueError, match="prefetch_depth"):
                deeper.restore(str(tmp_path / "hs"))
        finally:
            deeper.close()
    finally:
        hs.close()


# ---------------------------------------------------------------- two ranks
W2_KW = dict(dataset="synthetic", world_size=2, batch_size=4, presample_batches=4,
             compute_dtype="float32", num_epochs=1, steps_per_epoch=6, eval_every=0,
             log_every=0, seed=0)


def test_two_ranks_host_stream_equal_replicated():
    """W=2 over gloo: each rank streams its own shard's rows ("auto" is
    "local" at W>1); losses, parameters, Adam state and evaluation
    bit-equal to the W=2 replicated run, rank by rank."""
    rep = spawn(trainer_rank, 2, "gloo", W2_KW, 4)
    hs = spawn(trainer_rank, 2, "gloo", {**W2_KW, "data_placement": "host_stream"}, 4)
    for a, b in zip(rep, hs):
        assert a["rank"] == b["rank"] and a["losses"] == b["losses"]
        for k, v in a["state_dict"].items():
            assert torch.equal(v, b["state_dict"][k]), k
        for i, moments in a["adam"].items():
            for k, v in moments.items():
                assert torch.equal(v, b["adam"][i][k]), (i, k)
        assert a["evaluate"] == b["evaluate"]
    assert hs[0]["losses"] == hs[1]["losses"]  # the ranks' mean
    assert not torch.equal(hs[0]["shard_row"], hs[1]["shard_row"])
    assert TrainConfig(**{**W2_KW, "data_placement": "host_stream"}
                       ).resolved_stream_shard_mode == "local"


def test_host_stream_needs_the_card_or_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Trainer(TrainConfig(**{**COMMON, "data_placement": "host_stream"}),
                dataset=_dataset("host_stream"))


def test_ring_survives_its_plain_form():
    """The ring's draws survive the checkpoint's plain form."""
    from mercury_tpu_torch.train.state import pending_from_host, pending_to_host

    tr = _trainer(**TABLE_KW)
    try:
        ring = tr.state.pending
        back = pending_from_host(pending_to_host(ring), "cpu")
        assert torch.equal(back.slots, ring.slots)
        for a, b in zip(ring.draws, back.draws):
            assert torch.equal(a.aug.crop, b.aug.crop) and torch.equal(a.aug2.flip, b.aug2.flip)
            assert torch.equal(a.uniforms, b.uniforms) and a.perm is b.perm is None
    finally:
        tr.close()
