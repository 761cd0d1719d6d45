"""FSDP in the port (``fsdp_parallel``) against the JAX package, on the CPU.

The split rule against ``fsdp_shardings`` on the Flax parameters of
ResNet-18, SmallCNN, VGG-11 and the Transformer. ``Trainer(fsdp_parallel=2,
world_size=2)`` of the JAX package on four virtual CPU devices against
four gloo ranks of the port, from the JAX Trainer's weights, streams, EMAs
and draws (the Pallas kernels in interpret mode). The port against itself
at one worker, F=2 against F=1: a tiny ResNet of width 16 (its 16→16 conv
kernels split on Cin, as JAX's rule picks the first of equal dimensions),
the BiLSTM (whose cells the model gathers) and the Transformer under
``remat`` (whose blocks gather again in the backward); the collectives a
step; the bytes a rank keeps; a checkpoint of an F=2 run restored at F=1.

Tolerances. Against JAX as in ``test_torch_port_mesh``: losses to rtol
1e-4, parameters to atol 2e-3, Adam's moments to rtol 1e-3 (atol 1e-5 and
1e-8). The port against itself: bit-equal (the
single rank on one thread, as the ranks run). Every rank of a group
computes its worker's whole batch with the same whole weights, and the
gradient's reduce-scatter takes the mean of F equal copies, which at F=2
is exact. Only the gradient's norm differs, to rtol 1e-6: the sharded
leaves' squares are summed apart from the others.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import Mesh  # noqa: E402

from mercury_tpu.models import create_model as jcreate_model  # noqa: E402
from mercury_tpu.parallel.fsdp import fsdp_shardings  # noqa: E402
from mercury_tpu_torch import TrainConfig, Trainer  # noqa: E402
from mercury_tpu_torch.models import create_model  # noqa: E402
from mercury_tpu_torch.models.convert import flax_leaves  # noqa: E402
from mercury_tpu_torch.parallel.distributed import spawn  # noqa: E402
from mercury_tpu_torch.models.lstm import BiLSTMAttention  # noqa: E402
from mercury_tpu_torch.parallel.fsdp import fsdp_dims, shard_model_fsdp, split_axis  # noqa: E402
from mercury_tpu_torch.parallel.mesh import GroupRef  # noqa: E402
from test_torch_port_mesh import COMMON, W, check_moments, jax_run, torch_layout  # noqa: E402
from test_torch_port_ranks import mesh_rank, one_thread, tiny_resnet  # noqa: E402

F = 2


@pytest.mark.parametrize("name,shape,n", [("resnet18", (32, 32, 3), 2),
                                          ("resnet18", (32, 32, 3), 4),
                                          ("smallcnn", (32, 32, 3), 2),
                                          ("vgg11", (32, 32, 3), 4),
                                          ("transformer", (32, 16), 2)])
def test_split_rule_is_jax(name, shape, n):
    """Every leaf splits along the Flax dimension ``fsdp_shardings``
    picks, or stays replicated where it does."""
    jm = jcreate_model(name, num_classes=10, compute_dtype="float32")
    shapes = jax.eval_shape(lambda: jm.init(jax.random.key(0), jnp.zeros((1, *shape)),
                                            train=False))["params"]
    params = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32), shapes)
    mesh = Mesh(np.array(jax.devices()[:n]), ("fsdp",))
    specs = {tuple(str(getattr(p, "key", p)) for p in path): s.spec
             for path, s in jax.tree_util.tree_flatten_with_path(
                 fsdp_shardings(params, mesh, "fsdp"))[0]}
    model = create_model(name, 10, None, shape)
    dims = fsdp_dims(model, n)
    split = 0
    for pname, path, axes in flax_leaves(model):
        spec = tuple(specs[path]) + (None,) * (len(axes) - len(specs[path]))
        want = spec.index("fsdp") if "fsdp" in spec else None
        got = axes.index(dims[pname]) if pname in dims else None
        assert got == want, (pname, spec)
        split += want is not None
    assert split > 0


def test_split_rule_takes_the_first_of_equal_dimensions():
    assert split_axis((3, 3, 64, 64), 2) == 2
    assert split_axis((3, 3, 16, 32), 2) == 3
    assert split_axis((31, 33), 2) is None and split_axis((4, 8), 2) is None
    model = tiny_resnet(width=16)
    dims = fsdp_dims(model, 2)
    # [Cout, Cin, 3, 3] in torch: the 16→16 convs split on Cin (dim 1).
    assert dims["blocks.0.conv1.weight"] == 1 and "conv.weight" not in dims


class RenamedBiLSTM(BiLSTMAttention):
    pass


@pytest.mark.parametrize("model", [BiLSTMAttention(hidden_dim=64), RenamedBiLSTM(hidden_dim=64),
                                   tiny_resnet(width=16)], ids=["bilstm", "subclass", "resnet"])
def test_model_names_where_its_weights_gather(model):
    """A model's ``fsdp_gather_at`` moves the gathers of the modules it
    names to the module that reads their weights (the BiLSTM's cells to
    the model, a subclass too); every other sharded parameter gathers in
    its own module."""
    at = getattr(model, "fsdp_gather_at", {})
    shard_model_fsdp(model, GroupRef(None, 2, 0))
    roots = {name: [f"{name}.{leaf}".lstrip(".") for m, leaf, _ in module._fsdp_params
                    for name in [next(n for n, x in model.named_modules() if x is m)]]
             for name, module in model.named_modules() if hasattr(module, "_fsdp_params")}
    gathered = sorted(p for names in roots.values() for p in names)
    assert gathered == sorted(model.param_sharding.dims)
    for root, names in roots.items():
        for name in names:
            owner = name.rpartition(".")[0]
            want = next((r for prefix, r in at.items() if owner.startswith(prefix)), owner)
            assert root == want, (name, root)
    assert ("" in roots) == bool(at)


@pytest.fixture(scope="module")
def fsdp_vs_jax():
    ref = jax_run(fsdp_parallel=F)
    job = dict(config=dict(COMMON, fsdp_parallel=F), steps=3, params=ref["init"],
               workers=ref["workers"], draws=ref["draws"])
    return ref, [r[0] for r in spawn(mesh_rank, W * F, "gloo", [job])]


def test_fsdp_losses_and_parameters_match_jax(fsdp_vs_jax):
    ref, ports = fsdp_vs_jax
    for port in ports:
        np.testing.assert_allclose(port["losses"], ref["losses"], rtol=1e-4)
        for k, want in ref["params"].items():
            np.testing.assert_allclose(port["full"][k].numpy(), want.numpy(), rtol=0,
                                       atol=2e-3, err_msg=k)


def test_fsdp_adam_moments_match_jax(fsdp_vs_jax):
    ref, ports = fsdp_vs_jax
    for port in ports:
        check_moments(ref, port)


def test_fsdp_rank_holds_jax_device_shard(fsdp_vs_jax):
    ref, ports = fsdp_vs_jax
    model = create_model("transformer", 10, None, (32, 16))
    for r, port in enumerate(ports):
        before = torch_layout(model, ref["shards0"][r])
        after = torch_layout(model, ref["shards"][r])
        for name, want in before.items():
            assert torch.equal(port["local0"][name], want), name
            np.testing.assert_allclose(port["local"][name].numpy(), after[name].numpy(),
                                       rtol=0, atol=2e-3, err_msg=name)
        for w in range(W):
            first, second = ports[w * F:(w + 1) * F]
            for a, b in zip(first["selected"], second["selected"]):
                assert torch.equal(a, b)


# ------------------------------------------------------------ F=2 against F=1
IMAGE = dict(model="resnet18", dataset="synthetic", world_size=1, batch_size=4,
             presample_batches=2, steps_per_epoch=3, num_epochs=1, eval_every=0, log_every=0,
             compute_dtype="float32", seed=0)
ARMS = {
    "resnet": (IMAGE, {"tiny_resnet": 16}),
    "bilstm": (dict(IMAGE, model="bilstm_attention", dataset="synthetic_seq",
                    augmentation="none"),
               dict(name="bilstm_attention", sample_shape=(32, 16), hidden_dim=64,
                    attention_dim=32, mlp_dim=64)),
    "transformer_remat": (dict(IMAGE, model="transformer", dataset="synthetic_seq",
                               augmentation="none", remat=True),
                          dict(name="transformer", sample_shape=(32, 16), d_model=32,
                               num_heads=2, num_layers=2, max_len=32, remat=True)),
}


@pytest.fixture(scope="module")
def fsdp_vs_one(tmp_path_factory):
    root = tmp_path_factory.mktemp("fsdp")
    jobs = [dict(config=dict(cfg, fsdp_parallel=F), model=spec, steps=3)
            for cfg, spec in ARMS.values()]
    jobs[0].update(save=str(root), save_at=3)
    ranks = spawn(mesh_rank, F, "gloo", jobs)
    with one_thread():
        one = mesh_rank([dict(config=cfg, model=spec, steps=3)
                         for cfg, spec in ARMS.values()])
    restored = Trainer(TrainConfig(**IMAGE), device="cpu", model=tiny_resnet(seed=1, width=16))
    restored.restore(str(root))
    return dict(ranks=ranks, one=dict(zip(ARMS, one)), restored=restored)


@pytest.mark.parametrize("arm", list(ARMS))
def test_fsdp_is_bit_equal_to_one_rank(fsdp_vs_one, arm):
    i = list(ARMS).index(arm)
    one = fsdp_vs_one["one"][arm]
    for rank in fsdp_vs_one["ranks"]:
        port = rank[i]
        assert port["losses"] == one["losses"]
        np.testing.assert_allclose(port["grad_norms"], one["grad_norms"], rtol=1e-6)
        for a, b in zip(port["selected"], one["selected"]):
            assert torch.equal(a, b)
        for k, v in one["full"].items():
            assert torch.equal(port["full"][k], v), k
        for j, st in one["full_adam"].items():
            for key in ("exp_avg", "exp_avg_sq"):
                assert torch.equal(port["full_adam"][j][key], st[key]), (j, key)


@pytest.mark.parametrize("arm", list(ARMS))
def test_fsdp_bytes_and_collectives_a_step(fsdp_vs_one, arm):
    """A rank keeps its shards and their moments: the layout's count. A
    step gathers every sharded leaf for the scoring and the training
    forwards (a remat block's once more in the backward), reduce-scatters
    each gradient once, and all-reduces the norm's squares, all over the
    fsdp group."""
    i = list(ARMS).index(arm)
    cfg, spec = ARMS[arm]
    one = fsdp_vs_one["one"][arm]
    for port in (r[i] for r in fsdp_vs_one["ranks"]):
        full = {k: v for k, v in one["full"].items() if k in port["shapes"]}
        split = {k for k, v in full.items() if tuple(v.shape) != port["shapes"][k]}
        want = sum(v.numel() // (F if k in split else 1) for k, v in full.items())
        assert sum(int(np.prod(s)) for s in port["shapes"].values()) == want
        moments = sum(st["exp_avg"].numel() + st["exp_avg_sq"].numel()
                      for st in port["adam"].values())
        assert moments == 2 * want and split
        gathers = 2 + (1 if cfg.get("remat") else 0)
        for calls in port["calls"]:
            kinds = [c[0] for c in calls]
            assert {c[2] for c in calls} == {(0, 1)}
            assert kinds.count("reduce_scatter_tensor") == len(split)
            assert kinds.count("all_reduce") == 1
            if not cfg.get("remat"):
                assert kinds.count("all_gather_into_tensor") == gathers * len(split)
            else:
                blocks = {k for k in split if k.startswith("blocks.")}
                assert kinds.count("all_gather_into_tensor") == (
                    2 * len(split) + len(blocks))


def test_fsdp_checkpoint_restores_unsharded(fsdp_vs_one):
    """The F=2 run's file holds the whole model and moments: an F=1 run
    restores them exactly."""
    port = fsdp_vs_one["ranks"][0][0]
    state = fsdp_vs_one["restored"].state
    assert state.step == 3
    for k, v in state.model.state_dict().items():
        assert torch.equal(v, port["full"][k]), k
    for j, st in state.optimizer.state_dict()["state"].items():
        for key in ("exp_avg", "exp_avg_sq"):
            assert torch.equal(st[key], port["full_adam"][j][key]), (j, key)


def test_fsdp_refuses_zero_with_jax_message():
    with pytest.raises(ValueError, match="zero_sharding"):
        Trainer(TrainConfig(**dict(COMMON, fsdp_parallel=F, zero_sharding=True)),
                device="cpu")
