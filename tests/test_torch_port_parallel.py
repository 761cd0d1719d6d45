"""The port's data parallelism on the CPU: its collectives against numpy,
its synced BatchNorm against Flax's ``BatchNorm(axis_name=...)`` under
``shard_map`` on a 2-device virtual CPU mesh, the trainer at two ranks, and
the one-rank step, which issues no collective.

Two ranks run as two processes in a gloo process group
(``parallel.distributed.spawn``); their bodies are in
``test_torch_port_ranks.py``. Inputs are made with numpy from a seed and
go through both packages.

Tolerances: the collectives exact (a sum of two float32 values, then a
division by 2, is what ``lax.pmean`` computes too); BatchNorm in float32
rtol 1e-5 on the output and the running statistics and rtol 1e-4 on the
gradients (float32 sums of 200 terms in another order); in bfloat16 one
bf16 ulp (rtol 2⁻⁷) on the output, and one bf16 ulp of the largest
element on the input's gradient (see the test).
"""

import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import flax.linen as fnn  # noqa: E402
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from mercury_tpu.compat import shard_map  # noqa: E402
from mercury_tpu.parallel.mesh import host_cpu_mesh  # noqa: E402
from mercury_tpu_torch import TrainConfig, Trainer  # noqa: E402
from mercury_tpu_torch.models.resnet import BatchNorm, ResNet, init_weights  # noqa: E402
from mercury_tpu_torch.models.resnet import BasicBlock  # noqa: E402
from mercury_tpu_torch.parallel import collectives  # noqa: E402
from mercury_tpu_torch.parallel.distributed import (  # noqa: E402
    init_distributed,
    require_world,
    spawn,
)
from test_torch_port_ranks import (  # noqa: E402
    batch_norm_rank,
    collectives_rank,
    failing_rank,
    trainer_rank,
)

W = 2


# ------------------------------------------------------------ collectives
@pytest.fixture(scope="module")
def reduced():
    rng = np.random.default_rng(0)
    shapes, dtypes = [(3, 4), (5,), (2,), (7,)], ["float32", "bfloat16", "float32", "bfloat16"]
    tensors = [[rng.normal(size=s).astype(np.float32) for s in shapes] for _ in range(W)]
    # bf16 inputs: values a bf16 holds exactly, so the expected mean is exact.
    for per_rank in tensors:
        for i, d in enumerate(dtypes):
            if d == "bfloat16":
                per_rank[i] = torch.tensor(per_rank[i]).to(torch.bfloat16).float().numpy()
    pair = [(float(rng.normal()), float(rng.integers(1, 9))) for _ in range(W)]
    x = [rng.normal(size=(6,)).astype(np.float32) for _ in range(W)]
    out = spawn(collectives_rank, W, "gloo", tensors, dtypes, pair, x)
    return dict(tensors=tensors, dtypes=dtypes, pair=pair, x=x, out=out)


def test_allreduce_mean_is_one_bucket_per_dtype(reduced):
    """Each rank ends with (a + b) / 2 of every tensor, in its own dtype, from
    one all-reduce per dtype over a float32 bucket of that dtype's sizes."""
    t, dtypes = reduced["tensors"], reduced["dtypes"]
    for out in reduced["out"]:
        assert out["dtypes"] == [f"torch.{d}" for d in dtypes]
        for i, d in enumerate(dtypes):
            want = (t[0][i] + t[1][i]) / np.float32(2)
            if d == "bfloat16":
                want = torch.tensor(want).to(torch.bfloat16).float().numpy()
            np.testing.assert_array_equal(out["means"][i].numpy(), want)
        assert sorted(out["mean_calls"]) == [(7 + 5,), (12 + 2,)]


def test_psum_stats_sums_the_pair_in_one_all_reduce(reduced):
    (s0, c0), (s1, c1) = reduced["pair"]
    for out in reduced["out"]:
        assert out["total"] == float(np.float32(s0) + np.float32(s1))
        assert out["count"] == c0 + c1
        assert out["stat_calls"] == [(2,)]


def test_all_reduce_mean_forward_and_gradient(reduced):
    """Forward SUM/W; backward SUM/W of the incoming gradients (c = 1 on rank
    0, 2 on rank 1): 1.5 everywhere, as the transpose of lax.pmean."""
    x0, x1 = reduced["x"]
    for out in reduced["out"]:
        np.testing.assert_array_equal(out["y"].numpy(), (x0 + x1) / np.float32(2))
        np.testing.assert_array_equal(out["x_grad"].numpy(), np.full(6, 1.5, np.float32))
        assert out["grad_calls"] == [(6,), (6,)]


def test_one_rank_collectives_return_their_input():
    """No process group here: every collective is the identity."""
    a, b = torch.ones(3), torch.zeros(2, dtype=torch.bfloat16)
    assert collectives.world() == 1 and collectives.rank() == 0
    assert collectives.allreduce_mean_([a, b])[0] is a
    s, c = torch.tensor(3.0), torch.tensor(4.0)
    assert collectives.psum_stats(s, c) == (s, c)
    assert collectives.all_reduce_mean(a) is a and collectives.allreduce_sum(b) is b


# -------------------------------------------------------------- batch norm
N, C, H = 4, 6, 5


def _flax_synced_bn(x_nhwc, cot_nhwc, weight, bias, dtype):
    """Flax's BatchNorm(axis_name="data") in train mode under shard_map on a
    2-device CPU mesh: each worker's output, input gradient, scale and bias
    gradients and updated running statistics."""
    bn = fnn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5,
                       axis_name="data", dtype=dtype)
    params = {"scale": jnp.asarray(weight), "bias": jnp.asarray(bias)}
    stats = {"mean": jnp.zeros(C, jnp.float32), "var": jnp.ones(C, jnp.float32)}

    def body(params, x, cot):
        def loss(params, x):
            y, upd = bn.apply({"params": params, "batch_stats": stats}, x[0],
                              mutable=["batch_stats"])
            return jnp.sum(y.astype(jnp.float32) * cot[0]), (y, upd["batch_stats"])

        (_, (y, st)), (gp, gx) = jax.value_and_grad(
            loss, argnums=(0, 1), has_aux=True)(params, x)
        return (y[None].astype(jnp.float32), gx.astype(jnp.float32), gp["scale"][None],
                gp["bias"][None], st["mean"][None], st["var"][None])

    fn = shard_map(body, mesh=host_cpu_mesh(W), in_specs=(P(), P("data"), P("data")),
                   out_specs=(P("data"),) * 6, check_vma=False)
    out = jax.jit(fn)(params, jnp.asarray(x_nhwc).astype(dtype), jnp.asarray(cot_nhwc))
    return [np.asarray(o) for o in out]


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def batch_norms(request):
    bf16 = request.param == "bfloat16"
    rng = np.random.default_rng(1)
    # Each rank's batch has its own mean and scale, so the synced statistics
    # differ from either rank's own.
    x = np.stack([rng.normal(loc=r - 0.5, scale=1 + r, size=(N, C, H, H))
                  for r in range(W)]).astype(np.float32)
    if bf16:
        x = torch.tensor(x).to(torch.bfloat16).float().numpy()
    cot = rng.normal(size=x.shape).astype(np.float32)
    weight = rng.uniform(0.5, 1.5, C).astype(np.float32)
    bias = rng.normal(size=C).astype(np.float32)
    nhwc = (0, 1, 3, 4, 2)
    flax_out = _flax_synced_bn(x.transpose(nhwc), cot.transpose(nhwc), weight, bias,
                               jnp.bfloat16 if bf16 else jnp.float32)
    want = dict(zip(["y", "x_grad", "weight_grad", "bias_grad", "running_mean",
                     "running_var"], flax_out))
    for k in ("y", "x_grad"):
        want[k] = want[k].transpose(0, 1, 4, 2, 3)  # back to NCHW
    got = spawn(batch_norm_rank, W, "gloo", x, cot, weight, bias, bf16)
    return dict(bf16=bf16, want=want, got=got)


def test_synced_batch_norm_matches_flax(batch_norms):
    want, bf16 = batch_norms["want"], batch_norms["bf16"]
    one_ulp = dict(rtol=2 ** -7, atol=1e-6)
    for r, got in enumerate(batch_norms["got"]):
        assert got["y_dtype"] == ("torch.bfloat16" if bf16 else "torch.float32")
        np.testing.assert_allclose(got["y"].numpy(), want["y"][r],
                                   **(one_ulp if bf16 else dict(rtol=1e-5, atol=1e-5)))
        # In bf16 JAX rounds the input's two cotangents (through the
        # statistics and through x − mean) to bf16 before it adds them; the
        # port adds them in float32 and rounds once. So the two differ by up
        # to one bf16 ulp of the largest gradient, not of each element.
        gx = want["x_grad"][r]
        np.testing.assert_allclose(
            got["x_grad"].numpy(), gx,
            **(dict(rtol=0, atol=2 ** -7 * np.abs(gx).max()) if bf16
               else dict(rtol=1e-4, atol=1e-6)))
        for k in ("weight_grad", "bias_grad"):
            np.testing.assert_allclose(got[k].numpy(), want[k][r], rtol=1e-4, atol=1e-5,
                                       err_msg=k)
        for k in ("running_mean", "running_var"):
            np.testing.assert_allclose(got[k].numpy(), want[k][r], rtol=1e-5, atol=1e-6,
                                       err_msg=k)


def test_synced_batch_norm_issues_one_all_reduce_each_way(batch_norms):
    """One [2, C] all-reduce in the forward, one in the backward; the
    running statistics equal on both ranks."""
    g0, g1 = batch_norms["got"]
    for got in (g0, g1):
        assert got["calls"] == [(2, C), (2, C)]
    assert torch.equal(g0["running_mean"], g1["running_mean"])
    assert torch.equal(g0["running_var"], g1["running_var"])


def test_one_rank_batch_norm_keeps_the_local_path():
    """batch_norm="sync" at one rank: the trainer leaves every layer's
    ``sync`` off, so a layer is F.batch_norm, as before, bit for bit."""
    torch.manual_seed(0)
    x = torch.randn(N, 8, H, H)
    bn = next(m for m in _tiny_trainer(batch_norm="sync").state.model.modules()
              if isinstance(m, BatchNorm))
    assert not bn.sync
    with torch.no_grad():
        want = torch.nn.functional.batch_norm(x, None, None, bn.weight, bn.bias,
                                              True, 0.0, bn.eps)
        assert torch.equal(bn(x, True, False), want)


# ----------------------------------------------------------------- trainer
def _tiny_trainer(**kw):
    base = dict(dataset="synthetic", world_size=1, batch_size=4, presample_batches=4,
                compute_dtype="float32", num_epochs=1, steps_per_epoch=6,
                eval_every=0, log_every=0, seed=0)
    base.update(kw)
    model = ResNet([1, 1], BasicBlock, num_classes=10, num_filters=8)
    init_weights(model, torch.Generator().manual_seed(0))
    return Trainer(TrainConfig(**base), device="cpu", model=model)


@pytest.mark.parametrize("kw", [
    dict(),
    dict(sampler="scoretable", refresh_size=8, fused_input=True),
], ids=["pool", "scoretable-fused"])
def test_one_rank_step_issues_no_collective(monkeypatch, kw):
    def refuse(*args, **kwargs):
        raise AssertionError("a collective at world_size=1")

    monkeypatch.setattr(torch.distributed, "all_reduce", refuse)
    tr = _tiny_trainer(**kw)
    for _ in range(2):
        assert np.isfinite(float(tr.train_step()["train/loss"]))
    assert not any(m.sync for m in tr.state.model.modules() if isinstance(m, BatchNorm))


def test_init_distributed_reads_the_launcher_environment(monkeypatch):
    """Under torchrun a world_size that disagrees with WORLD_SIZE raises
    before any process group is formed; without either, so does a call
    that names no rank."""
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("RANK", "0")
    with pytest.raises(ValueError, match="WORLD_SIZE=2"):
        init_distributed(4, "gloo")
    monkeypatch.delenv("WORLD_SIZE")
    with pytest.raises(ValueError, match="world_size and rank"):
        init_distributed(2, "gloo")
    assert not torch.distributed.is_initialized()


def test_require_world():
    assert require_world(1) == 0
    with pytest.raises(ValueError, match="world_size=4"):
        require_world(4)


TRAINER_KW = dict(dataset="synthetic", world_size=W, batch_size=4, presample_batches=4,
                  compute_dtype="float32", num_epochs=1, steps_per_epoch=6,
                  eval_every=0, log_every=0, seed=0)


@pytest.fixture(scope="module", params=[
    dict(data_placement="sharded"),
    dict(batch_norm="local", sampler="scoretable", refresh_size=8, fused_input=True,
         sync_importance_stats=False),
], ids=["pool-sync-sharded", "scoretable-fused-local"])
def trainers(request):
    kw = dict(TRAINER_KW, **request.param)
    return kw, spawn(trainer_rank, W, "gloo", kw, 3)


def test_trainer_replicas_stay_bit_equal(trainers):
    """Two ranks, each its own shard and draws: after three steps the
    parameters, BN running statistics and Adam moments are bit-equal, and
    both ranks evaluate to the same numbers."""
    _, (r0, r1) = trainers
    assert (r0["rank"], r1["rank"]) == (0, 1)
    assert all(np.isfinite(r0["losses"])) and r0["losses"] == r1["losses"]
    assert r0["state_dict"].keys() == r1["state_dict"].keys()
    for k, v in r0["state_dict"].items():
        assert torch.equal(v, r1["state_dict"][k]), k
    assert r0["adam"].keys() == r1["adam"].keys()
    for i, moments in r0["adam"].items():
        for k, v in moments.items():
            assert torch.equal(v, r1["adam"][i][k]), (i, k)
    assert r0["evaluate"] == r1["evaluate"] and len(r0["evaluate"]) == 4


def test_trainer_ranks_take_their_own_shards_and_draws(trainers):
    """Different shard rows and generators; BN synced under "sync" only;
    one EMA under sync_importance_stats, each rank's own without it."""
    kw, (r0, r1) = trainers
    assert not torch.equal(r0["shard_row"], r1["shard_row"])
    assert not torch.equal(r0["first_draws"], r1["first_draws"])
    sync = kw.get("batch_norm", "sync") == "sync"
    assert r0["sync"] == r1["sync"] == [sync] * 6
    assert (r0["ema"] == r1["ema"]) == kw.get("sync_importance_stats", True)


def test_spawn_checks_the_devices_it_is_given():
    with pytest.raises(ValueError, match="for 2 ranks"):
        spawn(failing_rank, W, "gloo", devices=[0])


def test_a_failing_rank_fails_the_launch():
    """Rank 1 raises while rank 0 waits in an all-reduce: spawn raises
    promptly instead of hanging (with whichever rank's error it saw first:
    rank 0's all-reduce fails too once rank 1 is gone)."""
    t0 = time.perf_counter()
    with pytest.raises(torch.multiprocessing.ProcessRaisedException):
        spawn(failing_rank, W, "gloo", timeout_s=60)
    assert time.perf_counter() - t0 < 60
