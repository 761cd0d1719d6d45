"""The gradient path's options at two ranks — ``zero_sharding``,
``grad_compression="int8"``, both, ``"stochastic"`` and ``zero_sharding``
with ``grad_accum_steps=2``, two steps each, and one int8 step of the
scoretable sampler — against the JAX package's step at two
workers, per rank, on the CPU; and a ZeRO resume at two ranks.

The JAX side is ``make_train_step`` on a 2-device CPU mesh (synced BN, its
kernels in interpret mode). The port's side is one spawn of two gloo ranks
(the rank body is ``test_torch_port_ranks.grad_path_rank``) that runs every
case from the same weights, each rank with its worker's stream and draws
(``test_torch_port_sampler_modes.worker_draws``, the scoretable's from
``test_torch_port_config_step._draws``) and the quantizers' uniforms of its
worker's key (``test_torch_port_grad_path.grad_draws``), and takes the JAX
step's parameters after each step. The same spawn then saves a run of
``zero_sharding=True, grad_compression="int8", grad_accum_steps=2`` in the
middle of an accumulation window and resumes it on a fresh Trainer. Sizes:
the tiny ResNet, batch 4, a pool of 16 (or a window of 8) a worker, 64
images in two Dirichlet shards.

Tolerances are ``test_torch_port_grad_path``'s: losses, telemetry,
``train/sparse_rate`` (the mean over the ranks, as the JAX step's
``pmean``) and the gradient's norm rtol 1e-5; the parameters after each
step, which starts from JAX's, against JAX's per leaf (``check_update``:
1e-3·lr, lr/100 under the int8 wire, but for at most ``FLIPS`` elements,
and all within 2·lr); the BN running statistics rtol 1e-5, atol 1e-6; each
rank's ZeRO moments against its row of the JAX ``opt_state``
(``check_moment_rows``: ``exp_avg`` and √``exp_avg_sq`` rtol 1e-5, atol
1e-5 of the row's largest value); the two replicas and the resumed run
bit-equal.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
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

from test_torch_port_config_step import _draws as table_draws  # noqa: E402
from test_torch_port_grad_path import (  # noqa: E402
    adam_rows,
    check_moment_rows,
    check_update,
    grad_draws,
)
from test_torch_port_ranks import grad_path_rank  # noqa: E402
from test_torch_port_sampler_modes import (  # noqa: E402
    COMMON,
    MEAN,
    N_TRAIN,
    STD,
    STEPS,
    _np_tree,
    check_metrics,
    worker_draws,
)

W, W_STEPS = 2, 2
TABLE = dict(sampler="scoretable", refresh_size=8, fused_input=True)
W_CASES = {"zero": (dict(zero_sharding=True), W_STEPS),
           "int8": (dict(grad_compression="int8"), W_STEPS),
           "zero-int8": (dict(zero_sharding=True, grad_compression="int8"), W_STEPS),
           "stochastic": (dict(grad_compression="stochastic"), W_STEPS),
           "zero-accum": (dict(zero_sharding=True, grad_accum_steps=2), W_STEPS),
           "int8-scoretable": (dict(grad_compression="int8", **TABLE), 1)}
RESUME = dict(COMMON, world_size=W, zero_sharding=True, grad_compression="int8",
              grad_accum_steps=2, steps_per_epoch=12, eval_every=0, log_every=0)


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """Each case at W=2: the JAX step on a 2-device CPU mesh, and one spawn
    of two gloo ranks that runs every case from the same weights and each
    worker's draws, taking JAX's parameters after each step, then the
    ZeRO resume."""
    (x, y), (xt, yt) = cifar.synthetic_cifar(10, N_TRAIN, 8, seed=0)
    shards = partition_data(y, W, "hetero", alpha=0.5, seed=0, min_size=10)
    sidx = make_sharded_dataset((x, y), (xt, yt), shards, MEAN, STD, 10,
                                device=torch.device("cpu")).shard_indices.numpy()
    length = sidx.shape[1]
    mesh = host_cpu_mesh(W)
    jobs, ref = [], {}
    for name, (kw, n_steps) in W_CASES.items():
        common = {**COMMON, "world_size": W}
        jcfg = JConfig(model="resnet18", use_pallas=True, telemetry=True, **common, **kw)
        tcfg = TrainConfig(**common, **kw)
        jm = jres.ResNet(stage_sizes=[1, 1], block_cls=jres.BasicBlock, num_classes=10,
                         num_filters=8, compute_dtype=jnp.float32, bn_axis_name="data")
        tx = jstate.make_optimizer("adam", jcfg.lr, STEPS,
                                   grad_accum_steps=tcfg.grad_accum_steps)
        js = jstate.create_state(jax.random.key(0), jm, tx,
                                 jnp.zeros((1, 32, 32, 3), jnp.float32), W, length,
                                 zero_sharding=tcfg.zero_sharding,
                                 with_scoretable=tcfg.use_scoretable,
                                 with_sel_counts=tcfg.use_ledger)
        start = params_from_flax(_np_tree(js.params), _np_tree(js.batch_stats))
        perms = [np.array(js.stream.perm[w]) for w in range(W)]
        jstep = jmake_train_step(jm, tx, jcfg, mesh, MEAN, STD)
        cursors = [0] * W
        draws, synced, out = [], [], []
        for t in range(n_steps):
            rng = [js.rng[w] for w in range(W)]
            params, stats = _np_tree(js.params), _np_tree(js.batch_stats)
            new_js, jmetrics = jstep(js, jnp.asarray(x), jnp.asarray(y),
                                     jnp.asarray(sidx.astype(np.int32)))
            row = []
            for w in range(W):
                d = (table_draws(rng[w], tcfg)[0] if tcfg.use_scoretable else
                     worker_draws(tcfg, True, rng[w], t, cursors[w], length, new_js, w))
                row.append(d._replace(**grad_draws(tcfg, rng[w], params, stats, W)))
            draws.append(row)
            cursors = [int(new_js.stream.cursor[w]) for w in range(W)]
            synced.append(params_from_flax(_np_tree(new_js.params),
                                           _np_tree(new_js.batch_stats)))
            out.append(dict(metrics={k: float(v) for k, v in jmetrics.items()},
                            moments=adam_rows(new_js.opt_state) if tcfg.zero_sharding
                            else None))
            js = new_js
        jobs.append((tcfg, start, perms, draws, synced))
        ref[name] = dict(cfg=tcfg, steps=out, synced=synced)
    data = (x, y, xt, yt, shards, MEAN, STD)
    directory = str(tmp_path_factory.mktemp("zero_ckpt"))
    ports = spawn(grad_path_rank, W, "gloo", jobs, data, RESUME, directory)
    return dict(ref=ref, ports=ports)


@pytest.mark.parametrize("name", list(W_CASES))
def test_two_ranks_match_jax_per_rank(two_ranks, name):
    """Per rank and step: the losses, telemetry and sparse rate (means over
    the ranks, so equal on both) against the JAX step's; the parameters
    against JAX's, within 2·lr and per leaf by ``check_update``; under ZeRO each rank's chunk moments against its
    JAX worker's row; the replicas bit-equal."""
    ref = two_ranks["ref"][name]
    cfg = ref["cfg"]
    at = list(W_CASES).index(name)
    for w, port in enumerate(two_ranks["ports"]):
        for t, (s, r) in enumerate(zip(port["jobs"][at], ref["steps"])):
            where = f"{name} rank {w} step {t}"
            check_metrics(s["metrics"], r["metrics"], 1e-5, where)
            for key in ("train/sparse_rate", "train/grad_norm"):
                np.testing.assert_allclose(float(s["metrics"][key]), r["metrics"][key],
                                           rtol=1e-5, err_msg=f"{where}: {key}")
            if cfg.grad_compression != "stochastic":
                assert float(s["metrics"]["train/sparse_rate"]) == 1.0
            for key, want in ref["synced"][t].items():
                tol = dict(rtol=1e-5, atol=1e-6) if "running_" in key else dict(atol=2 * cfg.lr)
                np.testing.assert_allclose(s["state_dict"][key].numpy(), want.numpy(),
                                           err_msg=f"{where}: {key}", **tol)
            check_update(s["state_dict"], ref["synced"][t], cfg, where)
            if cfg.zero_sharding:
                mu, nu = r["moments"]
                if s["moments"]:
                    check_moment_rows(s["moments"], mu[w], nu[w], where)
                else:  # before the first update of an accumulation window
                    assert not mu.any() and not nu.any(), where
    p0, p1 = (port["jobs"][at] for port in two_ranks["ports"])
    for s0, s1 in zip(p0, p1):
        for key in ("train/loss", "train/pool_loss", "train/sparse_rate", "train/grad_norm"):
            assert float(s0["metrics"][key]) == float(s1["metrics"][key]), key
        for key, v in s0["state_dict"].items():
            assert torch.equal(v, s1["state_dict"][key]), key
        if s0["moments"]:
            # Each rank keeps its own half of the moments.
            assert not torch.equal(s0["moments"]["exp_avg"], s1["moments"]["exp_avg"])


def test_zero_resume_at_two_ranks_is_bit_exact(two_ranks):
    """``zero_sharding`` with the int8 wire and ``grad_accum_steps=2`` at
    two ranks, saved in the middle of an accumulation window: rank 0 writes
    the one file holding each rank's chunk moments and accumulator in its
    row, each rank restores its own, and three more steps are bit-equal to
    the live run's on both ranks. The ranks' chunk states differ; the
    replicas are equal."""
    r0, r1 = (port["checkpoint"] for port in two_ranks["ports"])
    assert [len(r0["writes"]), len(r1["writes"])] == [1, 0]
    for out in (r0, r1):
        assert out["step"] == 3
        for which in ("restored", "resumed"):
            want = out["saved" if which == "restored" else "live"]
            assert out[which].keys() == want.keys()
            for k, v in want.items():
                assert torch.equal(v, out[which][k]), (which, k)
        assert any(k.startswith("optimizer.0.exp_avg") for k in out["saved"])
        assert [k for k in out["saved"] if k.startswith("accum.")] == ["accum.0"]
    assert not torch.equal(r0["saved"]["accum.0"], r1["saved"]["accum.0"])
    assert not torch.equal(r0["live"]["optimizer.0.exp_avg"], r1["live"]["optimizer.0.exp_avg"])
    for k, v in r0["live"].items():
        if k.startswith("model."):
            assert torch.equal(v, r1["live"][k]), k
