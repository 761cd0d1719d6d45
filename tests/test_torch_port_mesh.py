"""The device mesh and tensor parallelism of the port against the JAX
package, on the CPU.

Against JAX: ``Trainer(tensor_parallel=2, world_size=2)`` on four virtual
CPU devices and four gloo ranks of the port, from the JAX Trainer's
weights, streams and EMAs and with its draws (each worker's key split as
the step splits it; the Pallas kernels in interpret mode, so the draw is
the inverse CDF of the same uniforms). The port against itself: the
Transformer at d_model 32, 2 heads and 2 blocks, T=2 against T=1 at one
worker; the collectives a step, by group; a checkpoint carried T=2 → T=1 →
T=2. Then the refusals, with the JAX Trainer's messages (the gradient wires,
async refresh and ``restore_elastic`` under a second axis are held in
``test_torch_port_mesh_wires*.py``, ``test_torch_port_mesh_stochastic.py``
and ``test_torch_port_mesh_async.py``).

Tolerances. Against JAX, as the JAX package's own test holds its sharded
step to its unsharded one (``tests/test_tensor_parallel.py:168-176``):
each step's loss to rtol 1e-4, the parameters after three steps to atol
2e-3 (Adam's first updates are ≈ lr·sign(g), so a gradient near 0 that
rounds the other way moves a weight by up to 2·lr), Adam's moments to
rtol 1e-3 with atol 1e-5 (``mu``) and 1e-8 (``nu``, of squared
gradients), each rank's shards before the steps exactly. The port against
itself: the losses to rtol 1e-6 and the gradient's norm to rtol 1e-5 (the
row-parallel sums reassociate float32), the selections bit-equal, the
parameters to atol 1e-3 (half of JAX's).
"""

import json
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from mercury_tpu.config import TrainConfig as JConfig  # noqa: E402
from mercury_tpu_torch import TrainConfig, Trainer  # noqa: E402
from mercury_tpu_torch.models import create_model  # noqa: E402
from mercury_tpu_torch.models.convert import flax_leaves, params_from_flax  # noqa: E402
from mercury_tpu_torch.obs.manifest import build_run_manifest  # noqa: E402
from mercury_tpu_torch.parallel.distributed import spawn  # noqa: E402
from mercury_tpu_torch.parallel.tensor import tp_dims  # noqa: E402
from mercury_tpu_torch.train.step import Augment, Draws  # noqa: E402
from test_torch_port_ranks import mesh_rank, one_thread  # noqa: E402

W, T, STEPS = 2, 2, 3
B, PRESAMPLE = 4, 2
POOL = B * PRESAMPLE
COMMON = dict(model="transformer", dataset="synthetic_seq", augmentation="none",
              world_size=W, batch_size=B, presample_batches=PRESAMPLE, steps_per_epoch=STEPS,
              num_epochs=1, eval_every=0, log_every=0, compute_dtype="float32", seed=0,
              sync_importance_stats=True, telemetry=False)
SMALL = dict(name="transformer", sample_shape=(32, 16), d_model=32, num_heads=2,
             num_layers=2, max_len=32)


def _np_tree(tree):
    return jax.tree_util.tree_map(lambda a: np.array(a), tree)


def _draws(rng):
    """One worker's draws of a pool step from its key, as the JAX step
    makes them (``augmentation="none"``: the augmentation draws are not
    read)."""
    k_sel = jax.random.split(rng, 8)[2]
    return Draws(perm=None,
                 aug=Augment(crop=torch.zeros((POOL, 2), dtype=torch.int32),
                             flip=torch.zeros(POOL, dtype=torch.bool)),
                 uniforms=torch.tensor(np.array(jax.random.uniform(k_sel, (1, B), jnp.float32))))


def jax_run(**second):
    """The JAX Trainer at ``W × second`` on virtual CPU devices: its
    initial state and draws, its losses and its state after the steps."""
    from mercury_tpu.train.trainer import Trainer as JTrainer

    jt = JTrainer(JConfig(use_pallas=True, **COMMON, **second))
    js = jt.state
    init = params_from_flax(_np_tree(js.params), {})
    workers = [dict(perm=np.array(js.stream.perm[w]), ema=float(js.ema.value[w]))
               for w in range(W)]
    draws, losses, shards0 = [[] for _ in range(W)], [], _device_shards(jt, js.params)
    for _ in range(STEPS):
        for w in range(W):
            draws[w].append(_draws(js.rng[w]))
        js, m = jt.train_step(js, jt.dataset.x_train, jt.dataset.y_train,
                              jt.dataset.shard_indices)
        losses.append(float(m["train/loss"]))
    adam = [s for s in jax.tree_util.tree_leaves(
        js.opt_state, is_leaf=lambda x: hasattr(x, "mu") and hasattr(x, "nu"))
        if hasattr(s, "mu")][0]
    return dict(init=init, workers=workers, draws=draws, losses=losses,
                params=params_from_flax(_np_tree(js.params), {}), shards0=shards0,
                shards=_device_shards(jt, js.params),
                moments={k: params_from_flax(_np_tree(getattr(adam, k)), {})
                         for k in ("mu", "nu")})


def check_moments(ref, port):
    """The gathered Adam moments, by parameter name, against optax's
    ``mu`` and ``nu`` after the same steps."""
    model = create_model("transformer", 10, None, (32, 16))
    names = [n for n, _ in model.named_parameters()]
    for i, st in port["full_adam"].items():
        for key, jkey, atol in (("exp_avg", "mu", 1e-5), ("exp_avg_sq", "nu", 1e-8)):
            want = ref["moments"][jkey][names[i]]
            np.testing.assert_allclose(st[key].numpy(), want.numpy(), rtol=1e-3, atol=atol,
                                       err_msg=f"{names[i]} {key}")


def _device_shards(jt, params):
    """Each mesh device's shard of every Flax leaf, in the mesh's order
    (global rank r is device ``mesh.devices.flat[r]``): ``{path: array}``
    a device."""
    leaves = jax.tree_util.tree_flatten_with_path(params)[0]
    out = []
    for device in jt.mesh.devices.flat:
        shards = {}
        for path, leaf in leaves:
            key = tuple(str(getattr(p, "key", p)) for p in path)
            data = [s.data for s in leaf.addressable_shards if s.device == device][0]
            shards[key] = np.array(data)
        out.append(shards)
    return out


def torch_layout(model, shards):
    """A device's Flax shards in the port's names and layout."""
    return {name: torch.from_numpy(np.ascontiguousarray(
        np.transpose(shards[path], np.argsort(axes))))
        for name, path, axes in flax_leaves(model)}


@pytest.fixture(scope="module")
def tp_vs_jax():
    ref = jax_run(tensor_parallel=T)
    job = dict(config=dict(COMMON, tensor_parallel=T), steps=STEPS, params=ref["init"],
               workers=ref["workers"], draws=ref["draws"])
    ports = [r[0] for r in spawn(mesh_rank, W * T, "gloo", [job])]
    return ref, ports


def test_mesh_places_the_model_axis_innermost(tp_vs_jax):
    """Global rank r is worker r // T and shard r % T; the data group
    holds the ranks of one shard, the model group a worker's."""
    _, ports = tp_vs_jax
    for r, port in enumerate(ports):
        assert (port["rank"], port["data_rank"], port["model_rank"]) == (r, r // T, r % T)
        assert port["data_ranks"] == tuple(w * T + r % T for w in range(W))
        assert port["model_ranks"] == tuple((r // T) * T + m for m in range(T))


def test_tensor_parallel_losses_and_parameters_match_jax(tp_vs_jax):
    ref, ports = tp_vs_jax
    for port in ports:
        np.testing.assert_allclose(port["losses"], ref["losses"], rtol=1e-4)
        assert port["full"].keys() == ref["params"].keys()
        for k, want in ref["params"].items():
            np.testing.assert_allclose(port["full"][k].numpy(), want.numpy(), rtol=0,
                                       atol=2e-3, err_msg=k)


def test_adam_moments_match_jax(tp_vs_jax):
    ref, ports = tp_vs_jax
    for port in ports:
        check_moments(ref, port)


def test_each_rank_holds_jax_device_shard(tp_vs_jax):
    """Rank r's parameters are the JAX mesh's device r shards: equal
    before the steps, and within the parameters' tolerance after."""
    ref, ports = tp_vs_jax
    model = create_model("transformer", 10, None, (32, 16))
    for r, port in enumerate(ports):
        before = torch_layout(model, ref["shards0"][r])
        after = torch_layout(model, ref["shards"][r])
        for name, want in before.items():
            assert torch.equal(port["local0"][name], want), name
            np.testing.assert_allclose(port["local"][name].numpy(), after[name].numpy(),
                                       rtol=0, atol=2e-3, err_msg=name)


def test_model_group_selects_and_keeps_the_same(tp_vs_jax):
    """A worker's ranks draw the same indices bit for bit, end with the
    same replicated leaves and gather the same unsharded model."""
    _, ports = tp_vs_jax
    for w in range(W):
        first, *rest = ports[w * T:(w + 1) * T]
        for port in rest:
            for a, b in zip(first["selected"], port["selected"]):
                assert torch.equal(a, b)
            for k, v in first["full"].items():
                assert torch.equal(v, port["full"][k]), k


# ------------------------------------------------------------ T=2 against T=1
@pytest.fixture(scope="module")
def tp_vs_one(tmp_path_factory):
    """The small Transformer at one worker: T=2 (two gloo ranks) for four
    steps, and a second T=2 run saved after one step; the same four steps
    at T=1 in this process; a T=1 run restored from the T=2 file for two
    steps and saved; T=2 restored from that file for one more."""
    root = tmp_path_factory.mktemp("tp")
    cfg = dict(COMMON, world_size=1, telemetry=True, steps_per_epoch=4)
    sharded = dict(config=dict(cfg, tensor_parallel=T), model=SMALL)
    modes = [dict(config=dict(cfg, **kw), model=SMALL, steps=steps) for kw, steps in MODES]
    a, b, *tp_modes = zip(*spawn(mesh_rank, T, "gloo", [
        dict(sharded, steps=4, evaluate=True),
        dict(sharded, steps=1, save=str(root / "t2"), save_at=1),
        *[dict(m, config=dict(m["config"], tensor_parallel=T)) for m in modes]]))
    with one_thread():
        one, *one_modes = mesh_rank([dict(config=cfg, model=SMALL, steps=4, evaluate=True),
                                     *modes])
        c = mesh_rank([dict(config=cfg, model=SMALL, steps=2, restore=str(root / "t2"),
                            save=str(root / "t1"), save_at=2)])[0]
    d = spawn(mesh_rank, T, "gloo", [dict(sharded, steps=1, restore=str(root / "t1"))])
    return dict(a=a, b=b, one=one, c=c, d=[r[0] for r in d], tp_modes=tp_modes,
                one_modes=one_modes)


# JAX's test_tp_scan_and_pipelined and test_tp_composes_with_score_cadence:
# a chunk of 3 steps, pipelined scoring, and a score cadence of 2 (a refresh
# at steps 0 and 2 of 4).
MODES = [(dict(scan_steps=3), 1), (dict(pipelined_scoring=True), 2),
         (dict(score_refresh_every=2), 4)]


@pytest.mark.parametrize("mode", range(len(MODES)), ids=["scan", "pipelined", "cadence"])
def test_step_modes_compose_with_tensor_parallel(tp_vs_one, mode):
    one = tp_vs_one["one_modes"][mode]
    for port in tp_vs_one["tp_modes"][mode]:
        assert len(port["losses"]) == (3 if mode == 0 else MODES[mode][1])
        np.testing.assert_allclose(port["losses"], one["losses"], rtol=1e-6)
        for a, b in zip(port["selected"], one["selected"]):
            assert torch.equal(a, b)
        assert port["ema_count"] == one["ema_count"]
    if mode == 2:
        assert one["ema_count"] == 2


def test_evaluate_and_predict_under_tensor_parallel(tp_vs_one):
    one = tp_vs_one["one"]
    for port in tp_vs_one["a"]:
        assert port["evaluate"].keys() == one["evaluate"].keys() == {
            "test/eval_loss", "test/eval_acc"}
        for k, v in one["evaluate"].items():
            np.testing.assert_allclose(port["evaluate"][k], v, rtol=1e-5, err_msg=k)
        np.testing.assert_allclose(port["predict"].numpy(), one["predict"].numpy(),
                                   rtol=0, atol=1e-5)


def test_tensor_parallel_matches_one_rank(tp_vs_one):
    one = tp_vs_one["one"]
    for port in tp_vs_one["a"]:
        np.testing.assert_allclose(port["losses"], one["losses"], rtol=1e-6)
        np.testing.assert_allclose(port["grad_norms"], one["grad_norms"], rtol=1e-5)
        for a, b in zip(port["selected"], one["selected"]):
            assert torch.equal(a, b)
        for k, want in one["full"].items():
            np.testing.assert_allclose(port["full"][k].numpy(), want.numpy(), rtol=0,
                                       atol=1e-3, err_msg=k)


def test_shards_and_moments_have_the_megatron_layout(tp_vs_one):
    """Each rank holds its chunk of every split leaf and Adam's moments of
    the same shape; bytes a rank are what the layout predicts."""
    model = create_model("transformer", 10, None, (32, 16), d_model=32, num_heads=2,
                         num_layers=2, max_len=32)
    dims = tp_dims(model)
    assert sorted(dims) == sorted(
        f"blocks.{i}.{m}.{leaf}" for i in range(2)
        for m, leaf in [("query", "weight"), ("query", "bias"), ("key", "weight"),
                        ("key", "bias"), ("value", "weight"), ("value", "bias"),
                        ("fc1", "weight"), ("fc1", "bias"), ("proj", "weight"),
                        ("fc2", "weight")])
    assert dims["blocks.0.query.weight"] == 0 and dims["blocks.0.proj.weight"] == 1
    full = dict(model.named_parameters())
    want_numel = sum(p.numel() // (T if n in dims else 1) for n, p in full.items())
    for port in tp_vs_one["a"]:
        for name, p in full.items():
            shape = list(p.shape)
            if name in dims:
                shape[dims[name]] //= T
            assert port["shapes"][name] == tuple(shape), name
        names = list(full)
        moments = 0
        for i, st in port["adam"].items():
            assert st["exp_avg"].shape == port["shapes"][names[i]]
            moments += st["exp_avg"].numel() + st["exp_avg_sq"].numel()
        assert sum(np.prod(s) for s in port["shapes"].values()) == want_numel
        assert moments == 2 * want_numel


def test_model_group_collectives_a_step(tp_vs_one):
    """At one worker a step's collectives are the model group's alone: 2
    all-reduces a block in each forward (scoring and training) and 2 in
    the backward, and the gradient's norm (telemetry): 6·2 + 1."""
    for port in tp_vs_one["a"]:
        for calls in port["calls"]:
            assert [c[0] for c in calls] == ["all_reduce"] * (6 * 2 + 1)
            assert {c[2] for c in calls} == {(0, 1)}
            # The block outputs [B, T, d] and [P, T, d], and the norm's scalar.
            assert sorted({c[1] for c in calls}) == [(), (B, 32, 32), (POOL, 32, 32)]


def test_checkpoint_moves_between_layouts(tp_vs_one):
    """JAX's ``test_tp_checkpoint_resume_keeps_layout``, across layouts: a
    T=2 file restores into T=1 and the losses continue as the unbroken T=2
    run's; that run's file restores into T=2, each rank its slices."""
    a, c, d = tp_vs_one["a"][0], tp_vs_one["c"], tp_vs_one["d"]
    assert c["step0"] == 1
    np.testing.assert_allclose(c["losses"], a["losses"][1:3], rtol=1e-5)
    for port in d:
        assert port["step0"] == 3
        np.testing.assert_allclose(port["losses"], a["losses"][3:], rtol=1e-5)
        sharded = dict(tp_vs_one["a"][port["model_rank"]]["shapes"])
        for k, v in c["full"].items():
            if k in sharded and tuple(v.shape) != sharded[k]:
                dim = [i for i, (x, y) in enumerate(zip(v.shape, sharded[k])) if x != y][0]
                v = v.chunk(T, dim)[port["model_rank"]]
            assert torch.equal(port["local0"][k], v), k


# ------------------------------------------------------------ refusals
def _refused(exc, message, **kw):
    cfg = TrainConfig(**dict(COMMON, **kw))
    with pytest.raises(exc, match=re.escape(message)):
        Trainer(cfg, device="cpu")


def test_refusals_carry_jax_messages():
    _refused(ValueError, "tensor_parallel and fsdp_parallel are mutually exclusive (both "
             "claim the second mesh axis); pick one", tensor_parallel=2, fsdp_parallel=2)
    _refused(ValueError, "tensor_parallel requires the transformer family "
             "(model='transformer'|'vit'), got 'smallcnn'", tensor_parallel=2,
             model="smallcnn", dataset="synthetic", augmentation="noniid")
    _refused(ValueError, "num_heads=4 must be divisible by tensor_parallel=3",
             tensor_parallel=3, world_size=1)
    _refused(ValueError, "zero_sharding flattens params to a vector, which would force an "
             "all-gather of the sharded params; use fsdp_parallel or plain allreduce when "
             "a second mesh axis shards the params", tensor_parallel=2, zero_sharding=True)
    _refused(ValueError, "host_stream requires a data-only mesh (no tensor/fsdp axis); "
             "drop tensor_parallel/fsdp_parallel", tensor_parallel=2,
             data_placement="host_stream")


def test_second_axis_needs_world_times_n_ranks():
    with pytest.raises(ValueError, match=re.escape(
            "TrainConfig.world_size=2 × tensor_parallel=2 needs a process group of 4 ranks")):
        Trainer(TrainConfig(**dict(COMMON, tensor_parallel=2)), device="cpu")


def test_mesh_fields_default_as_jax():
    jfields = {f: getattr(JConfig(), f) for f in ("mesh_axis", "model_axis",
                                                  "tensor_parallel", "fsdp_parallel",
                                                  "fsdp_axis")}
    assert {f: getattr(TrainConfig(), f) for f in jfields} == jfields
    assert TrainConfig().second_axis is None
    assert TrainConfig(tensor_parallel=2).second_axis == ("model", 2)
    assert TrainConfig(fsdp_parallel=4).second_axis == ("fsdp", 4)


def test_command_line_takes_the_mesh_flags(capsys):
    from mercury_tpu_torch import cli

    assert cli.main(["--tensor-parallel", "2", "--model-axis", "m", "--print-config"]) == 0
    got = json.loads(capsys.readouterr().out)
    assert (got["tensor_parallel"], got["model_axis"], got["fsdp_parallel"]) == (2, "m", 1)


def test_manifest_reports_the_mesh_axes():
    for kw, shape in [(dict(), {"data": 2}), (dict(tensor_parallel=2), {"data": 2, "model": 2}),
                      (dict(fsdp_parallel=2, fsdp_axis="f"), {"data": 2, "f": 2})]:
        man = build_run_manifest(TrainConfig(world_size=2, **kw), "cpu")
        assert man["mesh_shape"] == shape and man["mesh_axis_names"] == list(shape)


def test_flop_count_is_a_rank_share():
    """``perf/flops_per_step`` counts a rank's own work on a meta copy,
    with no collective: a tensor-parallel rank computes its heads' and MLP
    columns' share of the blocks (here 5.50e9 of 1.096e10 FLOPs), an FSDP
    rank its worker's whole step."""
    import types

    from mercury_tpu_torch.obs.accounting import flops_per_step
    from mercury_tpu_torch.parallel.fsdp import shard_model_fsdp
    from mercury_tpu_torch.parallel.mesh import GroupRef
    from mercury_tpu_torch.parallel.tensor import shard_model_tp

    cfg = TrainConfig(model="transformer", dataset="synthetic_seq", augmentation="none",
                      world_size=1)
    data = types.SimpleNamespace(x_test=torch.zeros(4, 32, 16))
    counts = {}
    for name, shard in (("one", None), ("tp", shard_model_tp), ("fsdp", shard_model_fsdp)):
        model = create_model("transformer", 10, torch.Generator().manual_seed(0), (32, 16))
        if shard is not None:
            shard(model, GroupRef(None, 2, 0))
        counts[name] = flops_per_step(types.SimpleNamespace(
            config=cfg, dataset=data, state=types.SimpleNamespace(model=model)))
    assert counts["fsdp"] == counts["one"] == 10_956_587_008
    assert counts["tp"] == 5_503_991_808
