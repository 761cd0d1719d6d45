"""The port's step at two ranks against the JAX package's step at two
workers, per rank, in float32 on the CPU.

The JAX side is ``make_train_step`` on a 2-device virtual CPU mesh
(``host_cpu_mesh(2)``, ``use_pallas=True``, its kernels in interpret
mode). The port's side is two gloo ranks (``parallel.distributed.spawn``;
the rank body is ``test_torch_port_ranks.step_rank``), each given the same
weights (``params_from_flax``), its worker's stream permutation, EMA and
score table, and its worker's draws: the key ``state.rng[w]`` split 8
ways (``mercury_tpu/train/step.py:855-856``), the crops and flips of
``k_aug`` (and ``k_aug2``) split 3 ways, and ``uniform(k_sel, (1, B))``.
The JAX step returns neither its draws nor its gradient, so each worker's
selection and the gradient averaged over the workers (``jax.grad``, then
``lax.pmean``, as the step's ``allreduce_mean_tree``) are composed from the
package's own functions under ``shard_map``.

Three configurations: the pool step with synced BN and replicated data;
the pool step with local BN and sharded data; the scoretable step with the
fused ingest and synced BN. The port runs each with its telemetry on (the
default); the JAX step of the scoretable configuration too, so its
telemetry is held to the JAX workers' (ESS, clip share and drift means over
the workers, the histograms sums, the gradient's norm equal on both). Tiny sizes: a [1, 1]-stage ResNet of width 8,
batch 4, a pool of 16 (or a window of 8) a worker, 64 images split into
two Dirichlet shards.

Tolerances, the single-rank step tests' own: rtol 1e-5 on the losses and
the EMA; the averaged gradient to rtol 1e-3, atol 1e-5 (float32 through
convolutions and batch statistics, summed in another order by XLA and
ATen); parameters after Adam to 2·lr (its first update is ≈ lr·sign(g),
so a last-bit difference in a g near 0 flips it: this one holds the
optimizer, the gradient test the gradient), the BN running statistics and
the score table to rtol 1e-5, atol 1e-6; the selections and the accuracy
equal; the two ranks' replicas bit-equal; the telemetry as in
``test_torch_port_telemetry_step`` (ESS, clip and drift rtol 1e-5, the
gradient's norm rtol 1e-4, histograms and ages exactly).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from mercury_tpu.compat import shard_map  # noqa: E402
from mercury_tpu.config import TrainConfig as JConfig  # noqa: E402
from mercury_tpu.data import pipeline as jpipe  # noqa: E402
from mercury_tpu.models import resnet as jres  # noqa: E402
from mercury_tpu.obs import sampler_health as jsh  # noqa: E402
from mercury_tpu.ops import (  # noqa: E402
    augment_normalize_pallas,
    per_sample_nll_pallas,
    score_and_draw_pallas,
    table_refresh_draw_pallas,
)
from mercury_tpu.parallel.mesh import host_cpu_mesh  # noqa: E402
from mercury_tpu.sampling import importance as jimp  # noqa: E402
from mercury_tpu.train import state as jstate  # noqa: E402
from mercury_tpu.train.step import make_train_step as jmake_train_step  # noqa: E402
from mercury_tpu_torch import TrainConfig  # noqa: E402
from mercury_tpu_torch.data import cifar  # noqa: E402
from mercury_tpu_torch.data.partition import partition_data  # noqa: E402
from mercury_tpu_torch.data.pipeline import make_sharded_dataset  # noqa: E402
from mercury_tpu_torch.models.convert import params_from_flax  # noqa: E402
from mercury_tpu_torch.parallel.distributed import spawn  # noqa: E402
from mercury_tpu_torch.train.step import Augment, Draws  # noqa: E402
from test_torch_port_ranks import step_rank  # noqa: E402

W, B, PRESAMPLE, R, N_TRAIN, STEPS = 2, 4, 4, 8, 64, 10
POOL = B * PRESAMPLE
# The head's bias favours this class, so every image is predicted as it and
# a rank's accuracy is its share of the class: 6 of shard 0's 30 images, 1 of
# shard 1's 34. The two ranks' accuracies then differ, and train/acc shows
# whether it is the global count over the global count.
HIT_CLASS, HIT_BIAS = 7, 3.0
BN_LAYERS = 6  # the [1, 1]-stage ResNet
# The configuration whose JAX step runs with telemetry=True.
TELEMETRY_CONFIG = "scoretable-fused-sync"
MEANS = ("sampler/ess", "sampler/clip_frac", "sampler/ema_drift")
MEAN, STD = cifar.CIFAR10_MEAN, cifar.CIFAR10_STD
CONFIGS = {
    "pool-sync-replicated": dict(batch_norm="sync", data_placement="replicated"),
    "pool-local-sharded": dict(batch_norm="local", data_placement="sharded"),
    "scoretable-fused-sync": dict(batch_norm="sync", sampler="scoretable",
                                  refresh_size=R, fused_input=True),
}
COMMON = dict(dataset="synthetic", world_size=W, batch_size=B,
              presample_batches=PRESAMPLE, compute_dtype="float32", num_epochs=1,
              steps_per_epoch=STEPS, seed=0)


def _np_tree(tree):
    return jax.tree_util.tree_map(lambda a: np.array(a), tree)


def _augment_draws(key, n):
    k_crop, k_flip, _ = jax.random.split(key, 3)
    return (torch.tensor(np.array(jax.random.randint(k_crop, (n, 2), 0, 9), np.int32)),
            torch.tensor(np.array(jax.random.bernoulli(k_flip, shape=(n,)))))


def _worker_draws(rng, table: bool) -> Draws:
    """Worker ``rng``'s draws as the JAX step makes them."""
    _, k_aug, k_sel, k_aug2 = jax.random.split(rng, 8)[:4]
    aug = Augment(*_augment_draws(k_aug, R if table else POOL))
    aug2 = Augment(*_augment_draws(k_aug2, B)) if table else None
    uniforms = torch.tensor(np.array(jax.random.uniform(k_sel, (1, B), jnp.float32)))
    # cursor 0 + a pool of 16 <= L: the stream does not wrap this step.
    return Draws(perm=None, aug=aug, uniforms=uniforms, aug2=aug2)


def _jax_worker_step(jm, jcfg, snap, x, y, sidx, mesh):
    """Each worker's drawn batch and the gradient averaged over the
    workers, composed from the JAX package's functions as its step runs
    them: the pool (or the refresh window) gathered and ingested, the
    scoring forward (synced BN where the model has its axis), the
    per-sample NLL, the global pool mean, the EMA update and the Pallas
    draw; then the drawn batch (the scoretable's ingested anew from
    ``k_aug2``), the reweighted loss's gradient through the train forward
    and its ``pmean`` over the workers."""
    table = jcfg.sampler == "scoretable"
    sharded = jcfg.data_placement == "sharded"
    length = sidx.shape[1]

    def body(params, stats, perm, rng, ema_v, ema_c, rows, xs, ys, scores):
        _, k_aug, k_sel, k_aug2 = jax.random.split(rng[0], 8)[:4]

        def gather(slots):
            if sharded:
                return xs[0][slots], ys[0][slots]
            return xs[rows[0][slots]], ys[rows[0][slots]]

        def ingest(key, raw):
            if jcfg.fused_input:
                return augment_normalize_pallas(key, raw, MEAN, STD)
            return jpipe.augment_batch(key, jpipe.normalize_images(raw, MEAN, STD))

        def forward(params, imgs):
            logits, _ = jm.apply({"params": params, "batch_stats": stats}, imgs,
                                 train=True, mutable=["batch_stats"])
            return logits

        slots = jnp.arange(R) % length if table else perm[0][:POOL]
        raw, labs = gather(slots)
        imgs = ingest(k_aug, raw)
        losses = per_sample_nll_pallas(forward(params, imgs), labs)
        ema = jimp.ema_update(jimp.EMAState(ema_v[0], ema_c[0]),
                              jimp.pool_mean(losses, "data"), jcfg.ema_alpha)
        if table:
            _, probs, selected, scaled = table_refresh_draw_pallas(
                k_sel, scores[0], slots, losses, ema.value, B,
                alpha=jcfg.is_alpha, decay=jcfg.table_decay)
            sel_raw, sel_labels = gather(selected)
            sel_images = ingest(k_aug2, sel_raw)
        else:
            probs, selected, scaled = score_and_draw_pallas(k_sel, losses, ema.value, B,
                                                            jcfg.is_alpha)
            sel_images, sel_labels = imgs[selected], labs[selected]

        def loss_fn(params):
            return jimp.reweighted_loss(
                per_sample_nll_pallas(forward(params, sel_images), sel_labels), scaled)

        grads = jax.lax.pmean(jax.grad(loss_fn)(params), "data")
        return selected[None], probs[None], jax.tree_util.tree_map(lambda g: g[None], grads)

    xs, ys = (x[sidx], y[sidx]) if sharded else (x, y)
    data_spec = P("data") if sharded else P()
    fn = shard_map(body, mesh=mesh,
                   in_specs=(P(), P(), P("data"), P("data"), P("data"), P("data"),
                             P("data"), data_spec, data_spec, P("data")),
                   out_specs=(P("data"), P("data"), P("data")), check_vma=False)
    sel, probs, grads = jax.jit(fn)(snap["params"], snap["stats"], snap["perm"], snap["rng"],
                             snap["ema"], snap["ema_count"], jnp.asarray(sidx),
                             jnp.asarray(xs), jnp.asarray(ys), snap["scores"])
    return np.asarray(sel), np.asarray(probs), _np_tree(grads)


@pytest.fixture(scope="module", params=list(CONFIGS))
def run(request):
    """The JAX W=2 step, its per-worker selections and averaged gradient,
    and the port's two ranks, from the same starting values."""
    name = request.param
    (x, y), (xt, yt) = cifar.synthetic_cifar(10, N_TRAIN, 8, seed=0)
    shards = partition_data(y, W, "hetero", alpha=0.5, seed=0, min_size=10)
    sidx = make_sharded_dataset((x, y), (xt, yt), shards, MEAN, STD, 10,
                                device=torch.device("cpu")).shard_indices.numpy()
    length = sidx.shape[1]
    tcfg = TrainConfig(**COMMON, **CONFIGS[name])
    jcfg = JConfig(model="resnet18", use_pallas=True, telemetry=name == TELEMETRY_CONFIG,
                   **COMMON, **CONFIGS[name])
    table = tcfg.use_scoretable
    jm = jres.ResNet(stage_sizes=[1, 1], block_cls=jres.BasicBlock, num_classes=10,
                     num_filters=8, compute_dtype=jnp.float32,
                     bn_axis_name="data" if tcfg.batch_norm == "sync" else None)
    tx = jstate.make_optimizer("adam", jcfg.lr, STEPS)
    js = jstate.create_state(jax.random.key(0), jm, tx,
                             jnp.zeros((1, 32, 32, 3), jnp.float32), W, length,
                             with_scoretable=table,
                             with_sel_counts=table and jcfg.telemetry)
    params = _np_tree(js.params)
    params["Dense_0"]["bias"][HIT_CLASS] = HIT_BIAS
    js = js.replace(params=jax.tree_util.tree_map(jnp.asarray, params))
    snap = dict(params=_np_tree(js.params), stats=_np_tree(js.batch_stats),
                perm=np.array(js.stream.perm), rng=js.rng,
                ema=np.array(js.ema.value), ema_count=np.array(js.ema.count),
                scores=(np.array(js.scoretable.scores) if table
                        else np.ones((W, length), np.float32)),
                cursor=np.array(js.scoretable.cursor) if table else np.zeros(W))
    assert POOL <= length and not np.array_equal(snap["perm"][0], snap["perm"][1])
    mesh = host_cpu_mesh(W)
    jsel, jprobs, jgrads = _jax_worker_step(jm, jcfg, snap, x, y, sidx, mesh)

    ranks = [dict(perm=snap["perm"][w], ema=float(snap["ema"][w]),
                  scores=snap["scores"][w], cursor=snap["cursor"][w],
                  draws=_worker_draws(snap["rng"][w], table)) for w in range(W)]
    job = (tcfg, params_from_flax(snap["params"], snap["stats"]),
           (x, y, xt, yt, shards, MEAN, STD), ranks, STEPS)
    ports = [out[0] for out in spawn(step_rank, W, "gloo", [job])]

    step_fn = jmake_train_step(jm, tx, jcfg, mesh, MEAN, STD)
    sharded = tcfg.data_placement == "sharded"
    xs, ys = (x[sidx], y[sidx]) if sharded else (x, y)
    new_js, jmetrics = step_fn(js, jnp.asarray(xs), jnp.asarray(ys),
                               jnp.asarray(sidx.astype(np.int32)))
    return dict(name=name, tcfg=tcfg, ports=ports, jsel=jsel, jprobs=jprobs,
                jgrads=jgrads, stats=snap["stats"], js=new_js, jmetrics={k: float(v) for k, v in jmetrics.items()},
                ranks=ranks, x=x, y=y, sidx=sidx)


def test_losses_and_accuracy_match_per_rank(run):
    """train/loss and train/pool_loss: means over the ranks; train/acc: the
    global correct count over the global count, k/8 here, where each rank's
    own share of HIT_CLASS differs."""
    jm = run["jmetrics"]
    hits = []
    for w, port in enumerate(run["ports"]):
        m = port["metrics"]
        np.testing.assert_allclose(float(m["train/loss"]), jm["train/loss"], rtol=1e-5)
        np.testing.assert_allclose(float(m["train/pool_loss"]), jm["train/pool_loss"],
                                   rtol=1e-5)
        slots = m["sampler/selected"].numpy()
        if not run["tcfg"].use_scoretable:
            slots = run["ranks"][w]["perm"][:POOL][slots]
        hits.append(int(np.sum(run["y"][run["sidx"][w][slots]] == HIT_CLASS)))
    assert hits[0] != hits[1]
    for port in run["ports"]:
        assert float(port["metrics"]["train/acc"]) == jm["train/acc"] == sum(hits) / (W * B)


def test_selections_match_per_rank(run):
    for w, port in enumerate(run["ports"]):
        probs = port["metrics"]["sampler/probs"].numpy()
        np.testing.assert_allclose(probs, run["jprobs"][w], rtol=1e-5, atol=1e-7)
        # Boundary band of the CDF summation order (see test_torch_port_ops).
        cdf = np.cumsum(probs.astype(np.float64))
        u = run["ranks"][w]["draws"].uniforms.numpy()[0]
        assert np.min(np.abs(cdf[None, :] - u[:, None])) > 1e-6
        np.testing.assert_array_equal(port["metrics"]["sampler/selected"].numpy(),
                                      run["jsel"][w])
    assert not np.array_equal(run["jsel"][0], run["jsel"][1])


def test_ema_is_global_and_matches(run):
    """sync_importance_stats: the pool mean is global, so both ranks' EMA are
    one value, the JAX workers' one."""
    js = run["js"]
    emas = [p["ema"] for p in run["ports"]]
    assert emas[0] == emas[1]
    for w, port in enumerate(run["ports"]):
        assert port["ema_count"] == 1
        np.testing.assert_allclose(port["ema"], float(js.ema.value[w]), rtol=1e-5)


def test_gradients_match_per_rank(run):
    """Each rank's gradient after its all-reduce, the mean over the ranks
    of gradients that flow back through the synced BN where there is one,
    against each JAX worker's ``pmean``'d gradient: a sum in place of the
    mean, a missing ÷W or a local gradient fails it."""
    names = [k for k in run["ports"][0]["grads"]]
    for w, port in enumerate(run["ports"]):
        worker = jax.tree_util.tree_map(lambda g: g[w], run["jgrads"])
        expect = params_from_flax(worker, run["stats"])
        assert sorted(port["grads"]) == sorted(
            k for k in expect if "running_" not in k) == sorted(names)
        for name, got in port["grads"].items():
            np.testing.assert_allclose(got.numpy(), expect[name].numpy(),
                                       rtol=1e-3, atol=1e-5, err_msg=name)


def test_parameters_and_running_stats_match(run):
    js, lr = run["js"], run["tcfg"].lr
    expect = params_from_flax(_np_tree(js.params), _np_tree(js.batch_stats))
    for port in run["ports"]:
        got = port["state_dict"]
        assert got.keys() == expect.keys()
        for name, want in expect.items():
            if "running_" in name:
                np.testing.assert_allclose(got[name].numpy(), want.numpy(),
                                           rtol=1e-5, atol=1e-6, err_msg=name)
            else:
                np.testing.assert_allclose(got[name].numpy(), want.numpy(),
                                           atol=2 * lr, err_msg=name)


def test_replicas_are_bit_equal(run):
    p0, p1 = run["ports"]
    for name, v in p0["state_dict"].items():
        assert torch.equal(v, p1["state_dict"][name]), name


def test_sampler_state_advances_per_rank(run):
    """The stream, or the score table and its cursor, of each rank against
    its JAX worker's; under sharded placement each rank holds only its own
    shard's rows."""
    js = run["js"]
    for w, port in enumerate(run["ports"]):
        if run["tcfg"].use_scoretable:
            np.testing.assert_allclose(port["table"].numpy(),
                                       np.asarray(js.scoretable.scores[w]),
                                       rtol=1e-5, atol=1e-6)
            assert port["cursor"] == int(js.scoretable.cursor[w]) == R
        else:
            assert port["stream_cursor"] == int(js.stream.cursor[w]) == POOL
        if run["tcfg"].data_placement == "sharded":
            np.testing.assert_array_equal(port["x_shard"].numpy(),
                                          run["x"][run["sidx"][w]])
        else:
            assert port["x_shard"] is None


def test_collectives_a_step(run):
    """Synced BN: one all-reduce a BN layer in the scoring forward, the
    train forward and the backward; then the pool mean, the gradient
    bucket, the running-statistics bucket and the metrics. Local BN: the
    last four only."""
    sync = run["tcfg"].batch_norm == "sync"
    for port in run["ports"]:
        calls = port["calls"]
        assert len(calls) == (3 * BN_LAYERS if sync else 0) + 4
        # The pool mean, and the metrics: four, then the telemetry's three
        # means and its histograms' counts (telemetry is on by default).
        hists = 2 if run["tcfg"].use_scoretable else 1
        assert calls.count((2,)) == 1 and calls.count((4 + 3 + 16 * hists,)) == 1
        if sync:
            assert sum(shape[0] == 2 and len(shape) == 2 for shape in calls) == 3 * BN_LAYERS


def test_telemetry_per_rank(run):
    """ESS, clip share and drift are means over the ranks, the histograms
    sums, the gradient's norm the all-reduced gradient's: equal on both
    ranks; against the JAX workers' where its step has telemetry."""
    ports = [p["metrics"] for p in run["ports"]]
    table = run["tcfg"].use_scoretable
    families = ("w_hist", "score_hist") if table else ("w_hist",)
    for key in (*MEANS, "train/grad_norm"):
        assert float(ports[0][key]) == float(ports[1][key]), key
    assert float(ports[0]["train/grad_norm"]) > 0
    for family in families:
        keys = jsh.hist_keys(family)
        for m in ports:
            assert [int(m[k]) for k in keys] == [int(ports[0][k]) for k in keys]
        assert sum(int(ports[0][k]) for k in keys) == W * (run["sidx"].shape[1] if
                                                            family == "score_hist" else B)
    if run["name"] != TELEMETRY_CONFIG:
        return
    jm = run["jmetrics"]
    for m in ports:
        for key in MEANS:
            np.testing.assert_allclose(float(m[key]), jm[key], rtol=1e-5, err_msg=key)
        np.testing.assert_allclose(float(m["train/grad_norm"]), jm["train/grad_norm"],
                                   rtol=1e-4)
        for family in families:
            for key in jsh.hist_keys(family):
                assert int(m[key]) == jm[key], key
        for key in ("sampler/table_age_min", "sampler/table_age_mean", "sampler/table_age_max"):
            assert float(m[key]) == jm[key], key
    for w, port in enumerate(run["ports"]):
        np.testing.assert_array_equal(port["sel_counts"].numpy(),
                                      np.asarray(run["js"].sel_counts[w]))
        assert int(port["sel_counts"].sum()) == B
