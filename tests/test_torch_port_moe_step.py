"""The mixture-of-experts Transformer and ViT through the port's step
against the JAX package's ``make_train_step``, in float32 on the CPU, from
the same Flax weights, state and draws (each step's from the JAX state's
key, split 8 ways as ``mercury_tpu/train/step.py:855-856`` splits it; the
JAX Pallas kernels in interpret mode):

- three importance-sampled pool steps of the Transformer with
  ``moe_experts=4`` on ``synthetic_seq``-shaped sequences: the objective
  is the reweighted loss plus ``moe_aux_weight · aux``;
- one fused-ingest scoretable step of ViT with ``moe_experts=4``;
- two gloo ranks of the Transformer with experts against the JAX step at
  two workers: ``train/moe_aux`` rides the metrics' one all-reduce.

Tolerances, those of ``test_torch_port_sequence_step.py``: the losses and
``train/moe_aux`` of the first step to rtol 1e-5, of later steps to rtol
1e-4; parameters after the steps to 2·lr a step (Adam's first update is ≈
lr·sign(g), so a g near 0 can flip it); the selections equal.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from mercury_tpu.config import TrainConfig as JConfig  # noqa: E402
from mercury_tpu.models import create_model as jcreate_model  # noqa: E402
from mercury_tpu.parallel.mesh import host_cpu_mesh  # noqa: E402
from mercury_tpu.train import state as jstate  # noqa: E402
from mercury_tpu.train.step import make_train_step as jmake_train_step  # noqa: E402
from mercury_tpu_torch import TrainConfig  # noqa: E402
from mercury_tpu_torch.data import cifar  # noqa: E402
from mercury_tpu_torch.data.partition import partition_data  # noqa: E402
from mercury_tpu_torch.data.pipeline import ShardStream, make_sharded_dataset  # noqa: E402
from mercury_tpu_torch.models import create_model  # noqa: E402
from mercury_tpu_torch.models.convert import params_from_flax, scoretable_from_jax  # noqa: E402
from mercury_tpu_torch.parallel.distributed import spawn  # noqa: E402
from mercury_tpu_torch.sampling.importance import EMAState  # noqa: E402
from mercury_tpu_torch.train.state import create_state  # noqa: E402
from mercury_tpu_torch.train.step import Augment, Draws, make_train_step  # noqa: E402
from test_torch_port_ranks import sequence_step_rank  # noqa: E402

B, PRESAMPLE, N_TRAIN = 4, 4, 64
POOL = B * PRESAMPLE
T, F = 8, 4
SEQ_KW = dict(d_model=16, num_heads=2, num_layers=2, max_len=16, moe_experts=4)
VIT_KW = dict(d_model=16, num_heads=2, num_layers=2, moe_experts=4)
MEAN, STD = cifar.CIFAR10_MEAN, cifar.CIFAR10_STD


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _np_tree(tree):
    return jax.tree_util.tree_map(lambda a: np.array(a), tree)


def _sequences():
    (x, y), (xt, yt) = cifar.synthetic_sequences(10, N_TRAIN, 8, T, F, seed=0)
    return x, y, xt, yt, np.zeros((1,), np.float32), np.ones((1,), np.float32)


def _pool_draws(rng):
    """A pool step's draws from the JAX worker's key (augmentation "none":
    the crops and flips are not read)."""
    _, _, k_sel = jax.random.split(rng, 8)[:3]
    return Draws(perm=None, aug=Augment(crop=torch.zeros((POOL, 2), dtype=torch.int32),
                                        flip=torch.zeros(POOL, dtype=torch.bool)),
                 uniforms=torch.tensor(np.array(jax.random.uniform(k_sel, (1, B),
                                                                   jnp.float32))))


def _seq_configs(world=1):
    common = dict(model="transformer", dataset="synthetic_seq", world_size=world,
                  batch_size=B, presample_batches=PRESAMPLE, compute_dtype="float32",
                  num_epochs=1, steps_per_epoch=10, seed=0, augmentation="none",
                  moe_experts=4, moe_aux_weight=0.05)
    return TrainConfig(**common), JConfig(use_pallas=True, telemetry=False, **common)


def _assert_params(state_dict, jparams, atol):
    expect = params_from_flax(_np_tree(jparams), {})
    assert state_dict.keys() == expect.keys()
    assert "blocks.1.moe.w_up" in expect
    for k, want in expect.items():
        np.testing.assert_allclose(state_dict[k].numpy(), want.numpy(), atol=atol, err_msg=k)


@pytest.fixture(scope="module")
def pool_run():
    x, y, xt, yt, mean, std = _sequences()
    tcfg, jcfg = _seq_configs()
    jm = jcreate_model("transformer", 10, compute_dtype="float32", **SEQ_KW)
    tx = jstate.make_optimizer("adam", jcfg.lr, jcfg.steps_per_epoch)
    jst = jstate.create_state(jax.random.key(0), jm, tx, jnp.zeros((1, T, F), jnp.float32),
                              1, N_TRAIN)
    tm = create_model("transformer", 10, None, (T, F), **SEQ_KW)
    tm.load_state_dict(params_from_flax(_np_tree(jst.params), {}))
    dataset = make_sharded_dataset((x, y), (xt, yt), [np.arange(N_TRAIN)], mean, std, 10,
                                   device=torch.device("cpu"))
    tst = create_state(tm, "cpu", 0, N_TRAIN, "adam", tcfg.lr, tcfg.steps_per_epoch)
    tst.stream = ShardStream(perm=torch.tensor(np.array(jst.stream.perm[0]),
                                               dtype=torch.long), cursor=0)
    tst.ema = EMAState(torch.tensor(float(jst.ema.value[0])),
                       torch.tensor(0, dtype=torch.int32))
    t_step = make_train_step(tcfg, dataset)
    j_step = jmake_train_step(jm, tx, jcfg, host_cpu_mesh(1), mean, std)
    shard = jnp.asarray(np.arange(N_TRAIN, dtype=np.int32)[None, :])
    t_metrics, j_metrics = [], []
    for _ in range(3):
        draws = _pool_draws(jst.rng[0])
        t_metrics.append({k: v.detach().clone() for k, v in t_step(tst, draws).items()})
        jst, jm_ = j_step(jst, jnp.asarray(x), jnp.asarray(y), shard)
        j_metrics.append({k: np.array(v) for k, v in jm_.items()})
    return dict(tst=tst, jst=jst, t=t_metrics, j=j_metrics, lr=jcfg.lr)


def test_pool_steps_match_jax_with_the_aux_term(pool_run):
    """``train/loss`` is the objective with ``0.05 · aux``; ``train/moe_aux``
    the train forward's summed aux, in (0, 2·E] for two blocks."""
    for step, (t, j) in enumerate(zip(pool_run["t"], pool_run["j"])):
        rtol = 1e-5 if step == 0 else 1e-4
        for key in ("train/loss", "train/pool_loss", "train/moe_aux"):
            np.testing.assert_allclose(float(t[key]), float(j[key]), rtol=rtol,
                                       err_msg=f"step {step} {key}")
        assert 0.0 < float(t["train/moe_aux"]) <= 8.0
        assert float(t["train/acc"]) == float(j["train/acc"])
        assert t["train/moe_aux"].dtype == torch.float32


def test_pool_steps_parameters_match(pool_run):
    _assert_params(pool_run["tst"].model.state_dict(), pool_run["jst"].params,
                   2 * pool_run["lr"] * 3)


def test_moe_aux_is_zero_without_experts():
    """Every step reports ``train/moe_aux``: 0.0 for a model without
    experts, as the JAX step's sum of an empty ``"losses"``."""
    x, y, xt, yt, mean, std = _sequences()
    tcfg = TrainConfig(model="transformer", dataset="synthetic_seq", world_size=1,
                       batch_size=B, presample_batches=PRESAMPLE, compute_dtype="float32",
                       seed=0, augmentation="none")
    dataset = make_sharded_dataset((x, y), (xt, yt), [np.arange(N_TRAIN)], mean, std, 10,
                                   device=torch.device("cpu"))
    tm = create_model("transformer", 10, torch.Generator().manual_seed(0), (T, F),
                      d_model=16, num_heads=2, num_layers=1, max_len=16)
    tst = create_state(tm, "cpu", 0, N_TRAIN, "adam", tcfg.lr, 10)
    metrics = make_train_step(tcfg, dataset)(tst)
    assert float(metrics["train/moe_aux"]) == 0.0
    assert metrics["train/moe_aux"].dtype == torch.float32


# ---------------------------------------------------- ViT, fused scoretable
R = 8


def _augment_draws(key, n):
    k_crop, k_flip, _ = jax.random.split(key, 3)
    return Augment(torch.tensor(np.array(jax.random.randint(k_crop, (n, 2), 0, 9), np.int32)),
                   torch.tensor(np.array(jax.random.bernoulli(k_flip, shape=(n,)))))


@pytest.fixture(scope="module")
def table_run():
    (x, y), (xt, yt) = cifar.synthetic_cifar(10, N_TRAIN, 8, seed=0)
    common = dict(model="vit", dataset="synthetic", world_size=1, batch_size=B,
                  sampler="scoretable", refresh_size=R, fused_input=True,
                  compute_dtype="float32", num_epochs=1, steps_per_epoch=10, seed=0,
                  moe_experts=4)
    jcfg = JConfig(use_pallas=True, telemetry=False, **common)
    tcfg = TrainConfig(**common)
    jm = jcreate_model("vit", 10, compute_dtype="float32", **VIT_KW)
    tx = jstate.make_optimizer("adam", jcfg.lr, 10)
    js = jstate.create_state(jax.random.key(0), jm, tx, jnp.zeros((1, 32, 32, 3), jnp.float32),
                             1, N_TRAIN, with_scoretable=True)
    _, k_aug, k_sel, k_aug2 = jax.random.split(js.rng[0], 8)[:4]
    draws = Draws(perm=None, aug=_augment_draws(k_aug, R), aug2=_augment_draws(k_aug2, B),
                  uniforms=torch.tensor(np.array(jax.random.uniform(k_sel, (1, B),
                                                                    jnp.float32))))
    tm = create_model("vit", 10, None, (32, 32, 3), **VIT_KW)
    tm.load_state_dict(params_from_flax(_np_tree(js.params), {}))
    dataset = make_sharded_dataset((x, y), (xt, yt), [np.arange(N_TRAIN)], MEAN, STD, 10,
                                   device=torch.device("cpu"))
    ts = create_state(tm, "cpu", 0, N_TRAIN, "adam", tcfg.lr, 10, with_scoretable=True)
    ts.scoretable = scoretable_from_jax(np.array(js.scoretable.scores[0]),
                                        np.array(js.scoretable.cursor[0]))
    ts.ema = EMAState(torch.tensor(float(js.ema.value[0])), torch.tensor(0, dtype=torch.int32))
    tmetrics = make_train_step(tcfg, dataset)(ts, draws)
    step_fn = jmake_train_step(jm, tx, jcfg, host_cpu_mesh(1), MEAN, STD)
    shard = jnp.asarray(np.arange(N_TRAIN, dtype=np.int32)[None, :])
    new_js, jmetrics = step_fn(js, jnp.asarray(x), jnp.asarray(y), shard)
    return dict(ts=ts, t=tmetrics, js=new_js, j=jmetrics, lr=jcfg.lr)


def test_vit_scoretable_step_matches_jax(table_run):
    t, j = table_run["t"], table_run["j"]
    for key in ("train/loss", "train/pool_loss", "train/moe_aux"):
        np.testing.assert_allclose(float(t[key]), float(np.asarray(j[key])), rtol=1e-5,
                                   err_msg=key)
    np.testing.assert_allclose(table_run["ts"].scoretable.scores.numpy(),
                               np.asarray(table_run["js"].scoretable.scores[0]),
                               rtol=1e-5, atol=1e-6)
    _assert_params(table_run["ts"].model.state_dict(), table_run["js"].params,
                   2 * table_run["lr"])


# ------------------------------------------------------------ two ranks
W = 2


@pytest.fixture(scope="module")
def two_ranks():
    x, y, xt, yt, mean, std = _sequences()
    shards = partition_data(y, W, "hetero", alpha=0.5, seed=0, min_size=10)
    sidx = make_sharded_dataset((x, y), (xt, yt), shards, mean, std, 10,
                                device=torch.device("cpu")).shard_indices.numpy()
    tcfg, jcfg = _seq_configs(world=W)
    jm = jcreate_model("transformer", 10, compute_dtype="float32", **SEQ_KW)
    tx = jstate.make_optimizer("adam", jcfg.lr, jcfg.steps_per_epoch)
    js = jstate.create_state(jax.random.key(0), jm, tx, jnp.zeros((1, T, F), jnp.float32),
                             W, sidx.shape[1])
    ranks = [dict(perm=np.array(js.stream.perm[w]), ema=float(js.ema.value[w]), draws=[])
             for w in range(W)]
    params = params_from_flax(_np_tree(js.params), {})
    step_fn = jmake_train_step(jm, tx, jcfg, host_cpu_mesh(W), mean, std)
    jmetrics = []
    for _ in range(2):
        for w in range(W):
            ranks[w]["draws"].append(_pool_draws(js.rng[w]))
        js, m = step_fn(js, jnp.asarray(x), jnp.asarray(y), jnp.asarray(sidx.astype(np.int32)))
        jmetrics.append({k: float(v) for k, v in m.items()})
    ports = spawn(sequence_step_rank, W, "gloo", tcfg, SEQ_KW, params,
                  (x, y, xt, yt, shards, mean, std), ranks, 2)
    return dict(ports=ports, js=js, jmetrics=jmetrics, lr=jcfg.lr)


def test_two_ranks_match_jax_with_the_mean_aux(two_ranks):
    """Each rank's loss and ``train/moe_aux`` (the mean over the ranks) are
    the JAX workers'; a step still issues 3 all-reduces (the aux rides the
    metrics'), and the replicas are bit-equal."""
    ports = two_ranks["ports"]
    for port in ports:
        for step, (t, j) in enumerate(zip(port["metrics"], two_ranks["jmetrics"])):
            rtol = 1e-5 if step == 0 else 1e-4
            for key in ("train/loss", "train/pool_loss", "train/moe_aux"):
                np.testing.assert_allclose(float(t[key]), j[key], rtol=rtol,
                                           err_msg=f"step {step} {key}")
        assert [len(c) for c in port["calls"]] == [3, 3]
        _assert_params(port["state_dict"], two_ranks["js"].params, 2 * two_ranks["lr"] * 2)
    for k, v in ports[0]["state_dict"].items():
        assert torch.equal(v, ports[1]["state_dict"][k]), k
    assert float(ports[0]["metrics"][1]["train/moe_aux"]) == float(
        ports[1]["metrics"][1]["train/moe_aux"])
