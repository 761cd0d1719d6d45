"""The port's expert parallelism (``models/moe.py`` with ``ep_axis``) against
the JAX package's (``mercury_tpu/models/moe.py``), on the CPU.

JAX runs its all-to-all Switch dispatch under ``shard_map`` on virtual CPU
devices, the port on four gloo ranks (one spawn; the rank body is
``test_torch_port_ranks.ep_rank``), each rank its slice of the batch:

- the layer alone at JAX's test sizes (``tests/test_expert_parallel.py``:
  B=16, T=8, D=16, 8 experts over 4 ranks), at a capacity that admits
  every token (factor 8) and at one that drops them (JAX's minimal
  ``1e-6``: one slot an expert a rank); the output, the router loss, and
  every gradient of ``Σ y² + 0.01·aux`` against JAX's ``jax.grad``
  through its ``shard_map`` (the experts each rank's, the gate summed over
  the group by ``sum_grads_``);
- the EP classifier (``test_ep_classifier_matches_dense``'s, at the sizes
  of ``tests/test_pipeline_parallel.py``: T=16, F=8, C=5, d_model 32, 2
  heads, 4 blocks, 4 experts at capacity 8 over 2 ranks, a batch of 8):
  the logits, the blocks' summed router loss and every gradient of the
  mean NLL plus 0.01 × the router loss, against JAX's; its logits against
  the dense model's too.

Tolerances, the JAX package's own: outputs rtol 2e-5 and atol 2e-5, the
router loss rtol 1e-5, gradients rtol 5e-4 and atol 5e-5. The refusals:
``num_experts % W`` with JAX's message, and a layer whose group was never
bound.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import Mesh, PartitionSpec as P  # noqa: E402

from mercury_tpu.compat import shard_map  # noqa: E402
from mercury_tpu.models import TransformerClassifier as JTransformer  # noqa: E402
from mercury_tpu.models.moe import MoEMLP as JMoE  # noqa: E402
from mercury_tpu.sampling.importance import per_sample_loss  # noqa: E402
from mercury_tpu_torch.models.convert import expert_shard, params_from_flax  # noqa: E402
from mercury_tpu_torch.models.moe import MoEMLP, bind_expert_group  # noqa: E402
from mercury_tpu_torch.models.transformer import TransformerClassifier  # noqa: E402
from mercury_tpu_torch.parallel.distributed import spawn  # noqa: E402
from mercury_tpu_torch.parallel.mesh import GroupRef  # noqa: E402
from test_torch_port_ranks import ep_rank, moe_from_flax  # noqa: E402

B, T, D, E, W = 16, 8, 16, 8, 4           # the layer: JAX's test sizes
CAPACITIES = {"ample": 8.0, "drops": 1e-6}
AUX = 0.01
CLS = dict(num_classes=5, d_model=32, num_heads=2, num_layers=4, max_len=16,
           moe_experts=4, moe_capacity_factor=8.0)
CLS_W, CLS_B, CLS_T, CLS_F = 2, 8, 16, 8


def np_tree(tree):
    return jax.tree_util.tree_map(lambda a: np.array(a), tree)


def jax_layer(params, x, cf):
    """JAX's EP layer on 4 devices: the output, the router loss and the
    gradients of ``Σ y² + 0.01·aux``, as ``tests/test_expert_parallel.py``'s
    ``ep_apply`` runs it."""
    model = JMoE(num_experts=E, d_model=D, ep_axis="expert", capacity_factor=cf)
    mesh = Mesh(np.array(jax.devices()[:W]), ("expert",))
    specs = {k: (P() if k == "gate" else P("expert")) for k in params}
    fn = shard_map(lambda p, x: model.apply({"params": p}, x), mesh=mesh,
                   in_specs=(specs, P("expert")), out_specs=(P("expert"), P()))

    def loss(p):
        y, aux = fn(p, x)
        return jnp.sum(y * y) + AUX * aux, (y, aux)

    (total, (y, aux)), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(params)
    return dict(out=np.asarray(y), aux=float(aux), loss=float(total),
                grads=moe_from_flax(np_tree(grads)))


def jax_classifier(params, x, y):
    """JAX's EP classifier on 2 devices (``test_ep_classifier_matches_dense``'s
    ``shard_map``): the logits, the blocks' router losses summed, the
    gradients of the mean NLL plus 0.01 × that sum; and the dense model's
    logits."""
    model = JTransformer(moe_ep_axis="expert", **CLS)
    mesh = Mesh(np.array(jax.devices()[:CLS_W]), ("expert",))

    def spec_for(path, _):
        name = "/".join(str(getattr(k, "key", k)) for k in path)
        return P("expert") if "/moe/" in name and "gate" not in name else P()

    specs = jax.tree_util.tree_map_with_path(spec_for, params)

    def body(p, x):
        logits, state = model.apply({"params": p}, x, train=False, mutable=["losses"])
        return logits, sum(jax.tree_util.tree_leaves(state["losses"]))

    fn = shard_map(body, mesh=mesh, in_specs=(specs, P("expert")),
                   out_specs=(P("expert"), P()))

    def loss(p):
        logits, aux = fn(p, x)
        return jnp.mean(per_sample_loss(logits, y)) + AUX * aux, (logits, aux)

    (total, (logits, aux)), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(params)
    dense = JTransformer(**CLS).apply({"params": params}, x, train=False,
                                      mutable=["losses"])[0]
    return dict(out=np.asarray(logits), aux=float(aux), loss=float(total),
                dense=np.asarray(dense), grads=params_from_flax(np_tree(grads), {}))


@pytest.fixture(scope="module")
def both():
    x = np.asarray(jax.random.normal(jax.random.key(0), (B, T, D), jnp.float32))
    layer = np_tree(JMoE(num_experts=E, d_model=D).init(jax.random.key(1), x)["params"])
    ref, jobs = {}, []
    for name, cf in CAPACITIES.items():
        ref[name] = jax_layer(layer, x, cf)
        jobs.append(dict(kind="moe", w=W, params=layer, x=x, cf=cf, aux_weight=AUX))
    cx = jax.random.normal(jax.random.key(3), (CLS_B, CLS_T, CLS_F), jnp.float32)
    cy = jnp.arange(CLS_B) % CLS["num_classes"]
    cls_params = np_tree(JTransformer(**CLS).init(jax.random.key(4), cx, train=False)["params"])
    ref["classifier"] = jax_classifier(cls_params, cx, cy)
    jobs.append(dict(kind="classifier", w=CLS_W, params=cls_params, x=np.asarray(cx),
                     y=np.asarray(cy), aux_weight=AUX,
                     model=dict(in_features=CLS_F, moe_ep_axis="expert", **CLS)))
    ranks = spawn(ep_rank, 4, "gloo", jobs)
    ports = [[r["jobs"][i] for r in ranks] for i in range(len(jobs))]
    return ref, dict(zip([*CAPACITIES, "classifier"], ports))


def check_grads(port, want, w):
    """A rank's gradients against JAX's whole ones: its experts' slice of
    the stacked leaves, every other leaf whole."""
    sliced = expert_shard(want, port["e"], w)
    for k, g in port["grads"].items():
        np.testing.assert_allclose(g.numpy(), sliced[k].numpy(), rtol=5e-4, atol=5e-5,
                                   err_msg=k)


@pytest.mark.parametrize("capacity", list(CAPACITIES))
def test_layer_matches_jax(both, capacity):
    """The rank's rows of the output, the router loss (the same on every
    rank) and the loss."""
    ref, ports = both
    want = ref[capacity]
    rows = np.split(want["out"], W)
    for port in ports[capacity]:
        np.testing.assert_allclose(port["out"].numpy(), rows[port["e"]], rtol=2e-5, atol=2e-5)
        np.testing.assert_allclose(port["aux"], want["aux"], rtol=1e-5)
        np.testing.assert_allclose(port["loss"], want["loss"], rtol=1e-5)


@pytest.mark.parametrize("capacity", list(CAPACITIES))
def test_layer_gradients_match_jax(both, capacity):
    """The gate's gradient summed over the group, each expert's whole on
    the rank that holds it."""
    ref, ports = both
    for port in ports[capacity]:
        for k, g in port["grads"].items():
            want = ref[capacity]["grads"][k]
            if not k.startswith("gate."):
                want = want.chunk(W)[port["e"]]
            np.testing.assert_allclose(g.numpy(), want.numpy(), rtol=5e-4, atol=5e-5,
                                       err_msg=k)


def test_minimal_capacity_drops_tokens(both):
    """One slot an expert a rank: at most E tokens a rank survive, every
    other token's output is exactly zero (JAX's
    ``test_overflow_tokens_drop_to_zero``), and the kept ones computed."""
    _, ports = both
    for port in ports["drops"]:
        rows = port["out"].reshape(-1, D)
        zero = int((rows == 0).all(dim=-1).sum())
        assert rows.shape[0] - E <= zero < rows.shape[0]


def test_classifier_matches_jax(both):
    """The EP classifier's logits on the rank's rows, against JAX's EP and
    dense classifiers; the router loss; every gradient."""
    ref, ports = both
    want = ref["classifier"]
    rows, dense = np.split(want["out"], CLS_W), np.split(want["dense"], CLS_W)
    for port in ports["classifier"]:
        np.testing.assert_allclose(port["out"].numpy(), rows[port["e"]], rtol=2e-5, atol=2e-5)
        np.testing.assert_allclose(port["out"].numpy(), dense[port["e"]], rtol=2e-5, atol=2e-5)
        np.testing.assert_allclose(port["aux"], want["aux"], rtol=1e-5)
        np.testing.assert_allclose(port["loss"], want["loss"], rtol=1e-5)
        check_grads(port, want["grads"], CLS_W)


def test_a_rank_holds_its_experts(both):
    """After ``bind`` a rank holds E/W experts of each stacked leaf, and
    the gate whole."""
    _, ports = both
    for port in ports["ample"]:
        assert port["grads"]["w_up"].shape == (E // W, D, 4 * D)
        assert port["grads"]["gate.weight"].shape == (E, D)
    for port in ports["classifier"]:
        assert port["grads"]["blocks.3.moe.b_down"].shape == (CLS["moe_experts"] // CLS_W,
                                                              CLS["d_model"])
    layer = MoEMLP(E, D, ep_axis="expert")
    full = layer.w_down.detach().clone()
    layer.bind(GroupRef(None, W, 2))
    assert torch.equal(layer.w_down.detach(), full[4:6])


def _unbound():
    return MoEMLP(4, 8, ep_axis="expert")(torch.zeros((2, 8)))


def _indivisible():
    return MoEMLP(4, 8, ep_axis="expert").bind(GroupRef(None, 3, 0))


def _indivisible_model():
    model = TransformerClassifier(5, 8, d_model=8, num_heads=2, num_layers=1,
                                  moe_experts=4, moe_ep_axis="expert")
    return bind_expert_group(model, GroupRef(None, 3, 0))


def _unbound_model():
    model = TransformerClassifier(5, 8, d_model=8, num_heads=2, num_layers=1,
                                  moe_experts=4, moe_ep_axis="expert")
    return model(torch.zeros((2, 4, 8)))


def _no_expert_axis():
    return bind_expert_group(TransformerClassifier(5, 8, d_model=8, num_heads=2, num_layers=1,
                                                   moe_experts=4), GroupRef(None, 2, 0))


# The JAX package's message for W not dividing E (models/moe.py), and the
# port's own for a layer or model whose group was never bound.
EP_REFUSALS = {"indivisible": (_indivisible, "num_experts 4 not divisible by axis size 3"),
               "indivisible_model": (_indivisible_model,
                                     "num_experts 4 not divisible by axis size 3"),
               "unbound": (_unbound, "ep_axis='expert' needs its expert group bound "
                           "(models.moe.bind_expert_group)"),
               "unbound_model": (_unbound_model, "ep_axis='expert' needs its expert group "
                                 "bound (models.moe.bind_expert_group)"),
               "no_expert_axis": (_no_expert_axis,
                                  "bind_expert_group needs a model built with moe_ep_axis")}


@pytest.mark.parametrize("case", list(EP_REFUSALS))
def test_refusals(case):
    fn, text = EP_REFUSALS[case]
    with pytest.raises(ValueError) as err:
        fn()
    assert str(err.value) == text
