"""The pool sampler's step modes at two ranks — ``pipelined_scoring``,
``score_refresh_every=2`` and ``sampler="groupwise"``, three steps each —
against the JAX package's step at two workers, per rank, on the CPU.

The JAX side is ``make_train_step`` on a 2-device CPU mesh (synced BN, its
kernels in interpret mode). The port's side is one spawn of two gloo ranks
(the rank body is ``test_torch_port_ranks.modes_rank``) that runs the three
modes from the same weights, each rank with its worker's stream and draws
(``test_torch_port_sampler_modes.worker_draws``), and takes the JAX step's
parameters after each step, as the one-rank tests do. Sizes: the tiny
ResNet, batch 4, a pool of 16 a worker, 64 images in two Dirichlet shards
(L = 34, so the groupwise window wraps on the third step). Tolerances are
``test_torch_port_sampler_modes``'s.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from mercury_tpu.config import TrainConfig as JConfig  # noqa: E402
from mercury_tpu.models import resnet as jres  # noqa: E402
from mercury_tpu.parallel.mesh import host_cpu_mesh  # noqa: E402
from mercury_tpu.train import state as jstate  # noqa: E402
from mercury_tpu.train.step import make_train_step as jmake_train_step  # noqa: E402
from mercury_tpu_torch import TrainConfig  # noqa: E402
from mercury_tpu_torch.data import cifar  # noqa: E402
from mercury_tpu_torch.data.partition import partition_data  # noqa: E402
from mercury_tpu_torch.data.pipeline import make_sharded_dataset  # noqa: E402
from mercury_tpu_torch.models.convert import params_from_flax  # noqa: E402
from mercury_tpu_torch.parallel.distributed import spawn  # noqa: E402

from test_torch_port_ranks import modes_rank  # noqa: E402
from test_torch_port_sampler_modes import (  # noqa: E402
    COMMON,
    GROUPWISE,
    MEAN,
    N_TRAIN,
    PIPELINED,
    POOL,
    STD,
    STEPS,
    _carried_jax,
    _jax_mode_state,
    _np_tree,
    check_carried,
    check_metrics,
    worker_draws,
)

W, W_STEPS = 2, 3
W_CASES = {"pipelined": PIPELINED, "cadence": dict(score_refresh_every=2),
           "groupwise": GROUPWISE}


@pytest.fixture(scope="module")
def two_ranks():
    """Each mode 3 steps at W=2: the JAX step on a 2-device CPU mesh (synced
    BN, kernels in interpret mode), and one spawn of two gloo ranks that
    runs the three modes from the same weights and each worker's draws,
    taking JAX's parameters after each step."""
    (x, y), (xt, yt) = cifar.synthetic_cifar(10, N_TRAIN, 8, seed=0)
    shards = partition_data(y, W, "hetero", alpha=0.5, seed=0, min_size=10)
    sidx = make_sharded_dataset((x, y), (xt, yt), shards, MEAN, STD, 10,
                                device=torch.device("cpu")).shard_indices.numpy()
    length = sidx.shape[1]
    assert POOL <= length < W_STEPS * POOL  # the groupwise window wraps
    mesh = host_cpu_mesh(W)
    jobs, ref = [], {}
    for name, kw in W_CASES.items():
        common = {**COMMON, "world_size": W}
        jcfg = JConfig(model="resnet18", use_pallas=True, telemetry=True, **common, **kw)
        tcfg = TrainConfig(**common, **kw)
        jm = jres.ResNet(stage_sizes=[1, 1], block_cls=jres.BasicBlock, num_classes=10,
                         num_filters=8, compute_dtype=jnp.float32, bn_axis_name="data")
        tx = jstate.make_optimizer("adam", jcfg.lr, STEPS)
        js = _jax_mode_state(jm, tx, tcfg, W, length)
        start = params_from_flax(_np_tree(js.params), _np_tree(js.batch_stats))
        perms = [np.array(js.stream.perm[w]) for w in range(W)]
        jstep = jmake_train_step(jm, tx, jcfg, mesh, MEAN, STD)
        cursors = [0] * W
        draws, synced, out = [], [], []
        for t in range(W_STEPS):
            rng = [js.rng[w] for w in range(W)]
            new_js, jmetrics = jstep(js, jnp.asarray(x), jnp.asarray(y),
                                     jnp.asarray(sidx.astype(np.int32)))
            draws.append([worker_draws(tcfg, True, rng[w], t, cursors[w], length, new_js, w)
                          for w in range(W)])
            cursors = [int(new_js.stream.cursor[w]) for w in range(W)]
            synced.append(params_from_flax(_np_tree(new_js.params),
                                           _np_tree(new_js.batch_stats)))
            out.append(dict(metrics={k: float(v) for k, v in jmetrics.items()},
                            carried=[_carried_jax(new_js, w) for w in range(W)]))
            js = new_js
        jobs.append((tcfg, start, perms, draws, synced))
        ref[name] = dict(cfg=tcfg, steps=out, synced=synced)
    data = (x, y, xt, yt, shards, MEAN, STD)
    ports = spawn(modes_rank, W, "gloo", jobs, data)
    return dict(ref=ref, ports=ports)


@pytest.mark.parametrize("name", list(W_CASES))
def test_two_ranks_match_jax_per_rank(two_ranks, name):
    """Per rank and step: the losses and telemetry (means over the ranks,
    so equal on both) against the JAX step's; each rank's stream, EMA (the
    global pool mean: one value on both) and carried state against its JAX
    worker's; the parameters within 2·lr of JAX's and the replicas
    bit-equal."""
    ref = two_ranks["ref"][name]
    at = list(W_CASES).index(name)
    for w, port in enumerate(two_ranks["ports"]):
        steps = port[at]
        for t, (s, r) in enumerate(zip(steps, ref["steps"])):
            where = f"{name} rank {w} step {t}"
            check_metrics(s["metrics"], r["metrics"], 1e-5, where)
            check_carried(s["carried"], r["carried"][w], 1e-5, where)
            for key, want in ref["synced"][t].items():
                tol = dict(rtol=1e-5, atol=1e-6) if "running_" in key else dict(
                    atol=2 * ref["cfg"].lr)
                np.testing.assert_allclose(s["state_dict"][key].numpy(), want.numpy(),
                                           err_msg=f"{where}: {key}", **tol)
    p0, p1 = (port[at] for port in two_ranks["ports"])
    for s0, s1 in zip(p0, p1):
        assert s0["carried"]["ema"] == s1["carried"]["ema"]
        for key in ("train/loss", "train/pool_loss", "sampler/ess"):
            assert float(s0["metrics"][key]) == float(s1["metrics"][key]), key
        for key, v in s0["state_dict"].items():
            assert torch.equal(v, s1["state_dict"][key]), key
