"""The sequence family through the port's step and Trainer against the JAX
package, in float32 on the CPU.

Pool steps: three importance-sampled steps of each package from the same
Flax weights, stream, EMA and draws (each step's from the JAX state's key,
split 8 ways as ``mercury_tpu/train/step.py:855-856`` splits it), the JAX
side ``make_train_step`` on a world-1 CPU mesh with its Pallas kernels in
interpret mode: ``bilstm_attention`` and ``transformer`` on
``synthetic_seq``-shaped sequences (``augmentation="none"``), ``vit`` on
``synthetic`` images (the noniid crop and flip). Two gloo ranks of the
Transformer against the JAX step at two workers: a step without batch
norm at W>1. Then the Trainer: fit, evaluate and predict on sequences,
the refusals, and the FLOPs a step against the layers' closed form.

Tolerances: the losses of the first step to rtol 1e-5 (the single-rank
step tests' own), of later steps to rtol 1e-4 (the weights by then differ
by Adam's updates of gradients that differ in their last bits);
parameters after the steps to 2·lr a step (Adam's first update is ≈
lr·sign(g), so a g near 0 can flip it); the selections equal.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from mercury_tpu.config import TrainConfig as JConfig  # noqa: E402
from mercury_tpu.data.pipeline import normalize_images as jnormalize  # noqa: E402
from mercury_tpu.models import create_model as jcreate_model  # noqa: E402
from mercury_tpu.parallel.mesh import host_cpu_mesh  # noqa: E402
from mercury_tpu.train import state as jstate  # noqa: E402
from mercury_tpu.train.step import make_train_step as jmake_train_step  # noqa: E402
from mercury_tpu_torch import TrainConfig, Trainer  # noqa: E402
from mercury_tpu_torch.data import cifar  # noqa: E402
from mercury_tpu_torch.data.partition import partition_data  # noqa: E402
from mercury_tpu_torch.data.pipeline import ShardStream, make_sharded_dataset  # noqa: E402
from mercury_tpu_torch.models import create_model  # noqa: E402
from mercury_tpu_torch.models.convert import params_from_flax  # noqa: E402
from mercury_tpu_torch.obs.accounting import flops_per_step  # noqa: E402
from mercury_tpu_torch.parallel.distributed import spawn  # noqa: E402
from mercury_tpu_torch.sampling.importance import EMAState  # noqa: E402
from mercury_tpu_torch.train.profile import timing_breakdown  # noqa: E402
from mercury_tpu_torch.train.state import create_state  # noqa: E402
from mercury_tpu_torch.train.step import Augment, Draws, make_train_step  # noqa: E402
from test_torch_port_ranks import sequence_step_rank  # noqa: E402

B, PRESAMPLE, N_TRAIN, STEPS = 4, 4, 64, 3
POOL = B * PRESAMPLE
T, F = 8, 4
# name → (model, dataset, keyword arguments of both packages' models).
CASES = {
    "bilstm": ("bilstm_attention", "synthetic_seq", dict(hidden_dim=8, attention_dim=8,
                                                          mlp_dim=16)),
    "transformer": ("transformer", "synthetic_seq", dict(d_model=16, num_heads=2,
                                                         num_layers=2, max_len=16)),
    "vit": ("vit", "synthetic", dict(d_model=16, num_heads=2, num_layers=2)),
}


def _np_tree(tree):
    return jax.tree_util.tree_map(lambda a: np.array(a), tree)


def _data(dataset, n_train=N_TRAIN, n_test=8):
    if dataset == "synthetic_seq":
        train, test = cifar.synthetic_sequences(10, n_train, n_test, T, F, seed=0)
        mean, std = np.zeros((1,), np.float32), np.ones((1,), np.float32)
    else:
        train, test = cifar.synthetic_cifar(10, n_train, n_test, seed=0)
        mean, std = cifar.CIFAR10_MEAN, cifar.CIFAR10_STD
    return train, test, mean, std


def _draws(rng, n, image):
    """One worker's draws of a pool step from its key, as the JAX step
    makes them (``k_aug`` split 3 ways for the crop and flip)."""
    _, k_aug, k_sel = jax.random.split(rng, 8)[:3]
    if image:
        k_crop, k_flip, _ = jax.random.split(k_aug, 3)
        aug = Augment(crop=torch.tensor(np.array(jax.random.randint(k_crop, (n, 2), 0, 9))),
                      flip=torch.tensor(np.array(jax.random.bernoulli(k_flip, shape=(n,)))))
    else:
        # augmentation="none": the draws are not read.
        aug = Augment(crop=torch.zeros((n, 2), dtype=torch.int32),
                      flip=torch.zeros(n, dtype=torch.bool))
    # cursor + a pool of 16 <= 64 for three steps: the stream does not wrap.
    return Draws(perm=None, aug=aug,
                 uniforms=torch.tensor(np.array(jax.random.uniform(k_sel, (1, B),
                                                                   jnp.float32))))


def _configs(name, world=1):
    model, dataset, _ = CASES[name]
    aug = "noniid" if dataset == "synthetic" else "none"
    common = dict(model=model, dataset=dataset, world_size=world, batch_size=B,
                  presample_batches=PRESAMPLE, compute_dtype="float32", num_epochs=1,
                  steps_per_epoch=10, seed=0, augmentation=aug)
    return (TrainConfig(**common),
            JConfig(use_pallas=True, telemetry=False, **common))


@pytest.fixture(scope="module", params=list(CASES))
def pool_run(request):
    name = request.param
    model, dataset, kw = CASES[name]
    (x, y), (xt, yt), mean, std = _data(dataset)
    tcfg, jcfg = _configs(name)
    jm = jcreate_model(model, 10, compute_dtype="float32", **kw)
    tx = jstate.make_optimizer("adam", jcfg.lr, jcfg.steps_per_epoch)
    jst = jstate.create_state(jax.random.key(0), jm, tx,
                              jnp.zeros((1, *x.shape[1:]), jnp.float32), 1, N_TRAIN)
    params = _np_tree(jst.params)
    tm = create_model(model, 10, None, x.shape[1:], **kw)
    tm.load_state_dict(params_from_flax(params, {}))
    dataset_t = make_sharded_dataset((x, y), (xt, yt), [np.arange(N_TRAIN)], mean, std, 10,
                                     device=torch.device("cpu"))
    tst = create_state(tm, "cpu", 0, N_TRAIN, "adam", tcfg.lr, tcfg.steps_per_epoch)
    tst.stream = ShardStream(perm=torch.tensor(np.array(jst.stream.perm[0]),
                                               dtype=torch.long), cursor=0)
    tst.ema = EMAState(torch.tensor(float(jst.ema.value[0])),
                       torch.tensor(0, dtype=torch.int32))
    t_step = make_train_step(tcfg, dataset_t)
    j_step = jmake_train_step(jm, tx, jcfg, host_cpu_mesh(1), mean, std)
    shard = jnp.asarray(np.arange(N_TRAIN, dtype=np.int32)[None, :])
    t_metrics, j_metrics = [], []
    for _ in range(STEPS):
        draws = _draws(jst.rng[0], POOL, dataset == "synthetic")
        t_metrics.append({k: v.detach().clone() for k, v in t_step(tst, draws).items()})
        jst, jm_ = j_step(jst, jnp.asarray(x), jnp.asarray(y), shard)
        j_metrics.append({k: float(v) for k, v in jm_.items()})
    return dict(name=name, tst=tst, jst=jst, t=t_metrics, j=j_metrics, lr=jcfg.lr)


def test_pool_steps_losses_match(pool_run):
    for step, (t, j) in enumerate(zip(pool_run["t"], pool_run["j"])):
        rtol = 1e-5 if step == 0 else 1e-4
        for key in ("train/loss", "train/pool_loss"):
            np.testing.assert_allclose(float(t[key]), j[key], rtol=rtol,
                                       err_msg=f"step {step} {key}")
        assert float(t["train/acc"]) == j["train/acc"]


def test_pool_steps_parameters_match(pool_run):
    expect = params_from_flax(_np_tree(pool_run["jst"].params), {})
    got = pool_run["tst"].model.state_dict()
    assert got.keys() == expect.keys()
    for k, want in expect.items():
        np.testing.assert_allclose(got[k].numpy(), want.numpy(),
                                   atol=2 * pool_run["lr"] * STEPS, err_msg=k)
    assert pool_run["tst"].step == STEPS and pool_run["tst"].stream.cursor == STEPS * POOL


# ------------------------------------------------------------ two ranks
W = 2


@pytest.fixture(scope="module")
def two_ranks():
    """The Transformer at W=2 (replicated data, Dirichlet shards): the JAX
    step at two workers and two gloo ranks of the port, two steps."""
    model, dataset, kw = CASES["transformer"]
    (x, y), (xt, yt), mean, std = _data(dataset)
    shards = partition_data(y, W, "hetero", alpha=0.5, seed=0, min_size=10)
    sidx = make_sharded_dataset((x, y), (xt, yt), shards, mean, std, 10,
                                device=torch.device("cpu")).shard_indices.numpy()
    tcfg, jcfg = _configs("transformer", world=W)
    jm = jcreate_model(model, 10, compute_dtype="float32", **kw)
    tx = jstate.make_optimizer("adam", jcfg.lr, jcfg.steps_per_epoch)
    js = jstate.create_state(jax.random.key(0), jm, tx, jnp.zeros((1, T, F), jnp.float32),
                             W, sidx.shape[1])
    params = _np_tree(js.params)
    ranks = [dict(perm=np.array(js.stream.perm[w]), ema=float(js.ema.value[w]), draws=[])
             for w in range(W)]
    step_fn = jmake_train_step(jm, tx, jcfg, host_cpu_mesh(W), mean, std)
    jmetrics = []
    for _ in range(2):
        for w in range(W):
            ranks[w]["draws"].append(_draws(js.rng[w], POOL, False))
        js, m = step_fn(js, jnp.asarray(x), jnp.asarray(y), jnp.asarray(sidx.astype(np.int32)))
        jmetrics.append({k: float(v) for k, v in m.items()})
    ports = spawn(sequence_step_rank, W, "gloo", tcfg, kw, params_from_flax(params, {}),
                  (x, y, xt, yt, shards, mean, std), ranks, 2)
    return dict(ports=ports, js=js, jmetrics=jmetrics, lr=jcfg.lr)


def test_two_ranks_without_batch_norm_match_jax(two_ranks):
    """Each rank's losses, and its parameters after two steps, are the JAX
    workers'; the ranks' replicas are bit-equal. A step all-reduces the
    pool mean, the gradient bucket and the metrics: 3, where a ResNet adds
    its BN layers' statistics and the running statistics' bucket; the
    empty running-statistics set issues no all-reduce."""
    js, lr = two_ranks["js"], two_ranks["lr"]
    expect = params_from_flax(_np_tree(js.params), {})
    ports = two_ranks["ports"]
    for port in ports:
        for step, (t, j) in enumerate(zip(port["metrics"], two_ranks["jmetrics"])):
            rtol = 1e-5 if step == 0 else 1e-4
            np.testing.assert_allclose(float(t["train/loss"]), j["train/loss"], rtol=rtol)
            np.testing.assert_allclose(float(t["train/pool_loss"]), j["train/pool_loss"],
                                       rtol=rtol)
        assert [len(c) for c in port["calls"]] == [3, 3]
        for k, want in expect.items():
            np.testing.assert_allclose(port["state_dict"][k].numpy(), want.numpy(),
                                       atol=2 * lr * 2, err_msg=k)
    for k, v in ports[0]["state_dict"].items():
        assert torch.equal(v, ports[1]["state_dict"][k]), k


# ------------------------------------------------------------ the Trainer
SMALL_KW = dict(hidden_dim=8, attention_dim=8, mlp_dim=8)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Small models: one intra-op thread is the fastest and keeps the
    workers of a parallel run off each other's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _trainer(model="bilstm_attention", **over):
    """A CPU Trainer of a small model on 64 [8, 4] sequences (40 to test)."""
    cfg = TrainConfig(model=model, dataset="synthetic_seq", world_size=1, batch_size=8,
                      presample_batches=4, compute_dtype="float32", num_epochs=1,
                      steps_per_epoch=4, eval_every=0, log_every=2, seed=0,
                      augmentation="none", **over)
    (x, y), (xt, yt), mean, std = _data("synthetic_seq", n_test=40)
    dataset = make_sharded_dataset((x, y), (xt, yt), [np.arange(N_TRAIN)], mean, std, 10,
                                   device=torch.device("cpu"))
    kw = SMALL_KW if model != "transformer" else dict(d_model=16, num_heads=2, max_len=16,
                                                      remat=cfg.remat)
    return Trainer(cfg, dataset=dataset, device="cpu",
                   model=create_model(model, 10, None, (T, F), **kw))


@pytest.fixture(scope="module")
def trained():
    trainer = _trainer()
    result = trainer.fit()
    yield trainer, result
    trainer.close()


def test_trainer_fits_and_evaluates_sequences(trained):
    trainer, result = trained
    ds = trainer.dataset
    assert ds.x_train.dtype == ds.x_test.dtype == torch.float32
    assert tuple(ds.x_train.shape[1:]) == (T, F) and trainer.state.step == 4
    assert np.isfinite(result["train/loss"]) and 0.0 <= result["test/eval_acc"] <= 1.0


@pytest.mark.parametrize("form", ["batch", "single", "tensor"])
def test_predict_on_sequences_equals_jax(trained, form):
    """``predict`` against the JAX package's inference path composed as
    its ``Trainer.predict`` composes it (``normalize_images``, a no-op for
    these statistics, then ``apply``), on the same weights; a single
    ``[T, F]`` sequence is one of one. Logits to atol 1e-5."""
    trainer, _ = trained
    ds = trainer.dataset
    jm = jcreate_model("bilstm_attention", 10, compute_dtype="float32", **SMALL_KW)
    variables = jm.init(jax.random.key(0), jnp.zeros((1, T, F)))
    trainer.state.model.load_state_dict(params_from_flax(variables["params"], {}))
    x = ds.x_test[:40].numpy()
    if form == "single":
        x = x[3]
    got = trainer.predict(torch.as_tensor(x) if form == "tensor" else x)
    want = np.asarray(jm.apply(variables, jnormalize(jnp.asarray(x if x.ndim == 3
                                                               else x[None]),
                                                     ds.mean, ds.std)))
    assert tuple(got.shape) == want.shape == ((1, 10) if form == "single" else (40, 10))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


def test_predict_argmax_is_evaluate(trained):
    trainer, _ = trained
    ds = trainer.dataset
    pred = trainer.predict(ds.x_test).argmax(-1)
    acc = int((pred == ds.y_test.long()).sum()) / ds.x_test.shape[0]
    assert acc == trainer.evaluate(include_train=False)["test/eval_acc"]


def test_transformer_trainer_with_remat_fits():
    trainer = _trainer("transformer", remat=True)
    assert trainer.state.model.remat
    result = trainer.fit()
    assert np.isfinite(result["train/loss"])
    trainer.close()


def test_augmentation_on_sequences_refused_with_jax_message():
    with pytest.raises(ValueError) as info:
        Trainer(TrainConfig(model="bilstm_attention", dataset="synthetic_seq",
                            world_size=1), device="cpu")
    assert str(info.value) == (
        "augmentation='noniid' needs image data; dataset 'synthetic_seq' has sample "
        "shape (32, 16) — set augmentation='none'")


def test_remat_refused_outside_the_transformer_family():
    with pytest.raises(ValueError, match=r"^remat requires the transformer family "
                       r"\(model='transformer'\|'vit'\), got 'smallcnn'$"):
        Trainer(TrainConfig(model="smallcnn", dataset="synthetic", world_size=1,
                            remat=True), device="cpu")


def test_fused_input_on_sequences_refused():
    """Sequences train with augmentation="none", and the fused ingest
    needs "noniid" (JAX ``train/step.py:426-431``)."""
    with pytest.raises(ValueError, match="set augmentation='noniid'"):
        TrainConfig(model="transformer", dataset="synthetic_seq", world_size=1,
                    augmentation="none", fused_input=True)


def test_host_stream_refuses_float_rows():
    (x, y), (xt, yt), mean, std = _data("synthetic_seq")
    with pytest.raises(ValueError, match="host_stream streams uint8 rows, got float32"):
        make_sharded_dataset((x, y), (xt, yt), [np.arange(N_TRAIN)], mean, std, 10,
                             device=torch.device("cpu"), placement="host_stream")


@pytest.mark.parametrize("placement", ["replicated", "sharded"])
def test_float_rows_stay_float32(placement):
    """The float32 sequences stay float32 on both splits (and the sharded
    rows), bit for bit; uint8 images stay uint8."""
    for dataset in ("synthetic_seq", "synthetic"):
        (x, y), (xt, yt), mean, std = _data(dataset)
        ds = make_sharded_dataset((x, y), (xt, yt), [np.arange(N_TRAIN)], mean, std, 10,
                                  device=torch.device("cpu"), placement=placement)
        want = torch.float32 if dataset == "synthetic_seq" else torch.uint8
        assert ds.x_train.dtype == ds.x_test.dtype == want
        np.testing.assert_array_equal(ds.x_train.numpy(), x)
        np.testing.assert_array_equal(ds.x_test.numpy(), xt)
        if placement == "sharded":
            assert ds.x_shard.dtype == want


# ------------------------------------------------------------ FLOPs
def _bilstm_forward(b, t, f, h, a, m, c):
    """The BiLSTM's matrix products at 2 FLOPs a multiply-add: per layer
    and direction the input projection and T − 1 recurrent products (h is
    zero at the first step), then both attentions, their pooling and the
    head."""
    layer = lambda fin: 2 * (2 * b * t * fin * 4 * h + 2 * b * (t - 1) * h * 4 * h)  # noqa: E731
    attn = 2 * b * t * 2 * h * a + 2 * b * t * a + 2 * b * t * 2 * h
    return layer(f) + layer(2 * h) + 2 * attn + 2 * b * 4 * h * m + 2 * b * m * c


def _transformer_forward(b, t, f, d, layers, c, heads):
    """Embed, per block the four projections, QKᵀ and PV, the MLP; the
    head."""
    block = 4 * 2 * b * t * d * d + 2 * 2 * b * t * t * d + 2 * 2 * b * t * d * 4 * d
    assert d % heads == 0
    return 2 * b * t * f * d + layers * block + 2 * b * d * c


@pytest.mark.parametrize("model", ["bilstm_attention", "transformer"])
def test_flops_per_step_is_the_closed_form(model):
    """The scoring forward at the pool P plus the train forward and
    backward at the batch B: the backward is twice the forward but for the
    input's gradient of the first layer's projections (the batch needs
    none)."""
    trainer = _trainer(model)
    p, b = 8 * 4, 8
    if model == "bilstm_attention":
        h = a = m = 8

        def fwd(n):
            return _bilstm_forward(n, T, F, h, a, m, 10)

        first = 2 * 2 * b * T * F * 4 * h  # both directions' input projections
    else:
        def fwd(n):
            return _transformer_forward(n, T, F, 16, 2, 10, 2)

        first = 2 * b * T * F * 16
    assert flops_per_step(trainer) == fwd(p) + 3 * fwd(b) - first
    trainer.close()


def test_timing_breakdown_takes_sequences():
    """``timing_breakdown``'s forwards take the ``[B, T, F]`` batch as it
    is; each segment is a non-negative time and the step advances (the
    warm call and two timed steps)."""
    trainer = _trainer("transformer")
    out = timing_breakdown(trainer, iters=2)
    assert set(out) >= {"is_time", "ff_time", "fb_time", "bp_time", "sync_time", "step_time"}
    assert all(v >= 0.0 for v in out.values())
    assert trainer.state.step == 3
    trainer.close()


def test_jax_and_port_sequence_configs_agree():
    """Every TrainConfig field the port has defaults as in JAX, remat too."""
    jfields = {f.name: f.default for f in dataclasses.fields(JConfig)}
    tfields = {f.name: f.default for f in dataclasses.fields(TrainConfig)}
    assert tfields["remat"] is jfields["remat"] is False
    assert len(tfields) == 106 and len(jfields) == 108
    assert set(tfields) <= set(jfields)
