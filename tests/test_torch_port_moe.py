"""The port's Switch mixture-of-experts MLP against the Flax module of the
JAX package (``mercury_tpu/models/moe.py``), from the same weights, on the
CPU: the layer alone (forward, aux and gradients, with and without
dropped tokens), against its own one-hot oracle, the Transformer and ViT
with ``moe_experts`` (the summed sowed aux, ``remat`` on and off, bf16
autocast), the weights' names and flat order, Flax's 3-D initializer, the
FLOPs that ``FlopCounterMode`` sees, a checkpoint round trip and the
refusals. Small widths (8-16), a few layers.

Tolerances, those of ``test_torch_port_sequence_models.py``: float32
forwards and the aux to atol 1e-5, gradients to rtol 1e-4 / atol 1e-6,
bf16 logits to two bf16 ulps of the largest (atol ``2**-6 · max|logit|``).
A dropped token's output row is exactly zero on both sides, and the
layer's bucketed path equals its oracle to atol 1e-6 where nothing drops.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402
from jax.flatten_util import ravel_pytree  # noqa: E402

from mercury_tpu.models import create_model as jcreate_model  # noqa: E402
from mercury_tpu.models.moe import MoEMLP as JMoEMLP  # noqa: E402
from mercury_tpu.utils.tree import sum_sowed_losses  # noqa: E402
from mercury_tpu_torch import TrainConfig, Trainer  # noqa: E402
from mercury_tpu_torch.data import cifar  # noqa: E402
from mercury_tpu_torch.data.pipeline import make_sharded_dataset  # noqa: E402
from mercury_tpu_torch.models import MoEMLP, create_model  # noqa: E402
from mercury_tpu_torch.models.convert import jax_flat_order, params_from_flax  # noqa: E402
from mercury_tpu_torch.models.layers import init_weights  # noqa: E402
from mercury_tpu_torch.parallel.mesh import GroupRef  # noqa: E402

LOGITS_ATOL = 1e-5
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-6
E, D, RATIO = 4, 8, 2
# name → (model, keyword arguments of both packages' models, sample shape).
CASES = {
    "transformer": ("transformer", dict(d_model=16, num_heads=2, num_layers=2, max_len=16,
                                        moe_experts=4), (9, 5)),
    "vit": ("vit", dict(d_model=16, num_heads=4, num_layers=2, moe_experts=4), (32, 32, 3)),
}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _np_tree(tree):
    return jax.tree_util.tree_map(lambda a: np.array(a), tree)


def _tokens(shape=(3, 8, D), seed=0, skew=0.0):
    """Seeded tokens; ``skew`` adds a shared offset, which tilts the
    router toward a few experts (and so drops tokens at capacity 1)."""
    rng = np.random.default_rng(seed)
    return (rng.normal(0, 1, shape) + skew * rng.normal(0, 1, shape[-1])).astype(np.float32)


def _layer_pair(capacity_factor, seed=0):
    """Flax's MoEMLP and its variables, and the port's loaded with them."""
    jm = JMoEMLP(num_experts=E, d_model=D, mlp_ratio=RATIO, capacity_factor=capacity_factor)
    variables = jm.init(jax.random.key(seed), jnp.zeros((4, D)))
    p = _np_tree(variables["params"])
    tm = MoEMLP(E, D, RATIO, capacity_factor)
    state = {"gate.weight": torch.tensor(p["gate"]["kernel"].T),
             "gate.bias": torch.tensor(p["gate"]["bias"])}
    state.update({k: torch.tensor(p[k]) for k in ("w_up", "b_up", "w_down", "b_down")})
    tm.load_state_dict(state)
    return jm, variables, tm


@pytest.mark.parametrize("capacity_factor,skew", [(8.0, 0.0), (1.0, 3.0)],
                         ids=["no-drops", "drops"])
def test_layer_matches_flax(capacity_factor, skew):
    """Forward, aux and the gradients of ``Σ y·r + 0.3·aux`` with respect
    to every parameter and the tokens."""
    jm, variables, tm = _layer_pair(capacity_factor)
    x = _tokens(skew=skew)
    r = _tokens(seed=1)
    jy, jaux = jm.apply(variables, jnp.asarray(x))
    xt = torch.tensor(x, requires_grad=True)
    ty, taux = tm(xt)
    np.testing.assert_allclose(ty.detach().numpy(), np.asarray(jy), atol=LOGITS_ATOL)
    np.testing.assert_allclose(float(taux.detach()), float(jaux), atol=LOGITS_ATOL)
    zero_rows = np.abs(np.asarray(jy)).reshape(-1, D).sum(-1) == 0
    assert np.array_equal(ty.detach().reshape(-1, D).abs().sum(-1).numpy() == 0, zero_rows)
    assert zero_rows.any() == (capacity_factor == 1.0)

    def objective(params, tokens):
        y, aux = jm.apply({"params": params}, tokens)
        return jnp.sum(y * r) + 0.3 * aux

    jgp, jgx = jax.grad(objective, argnums=(0, 1))(variables["params"], jnp.asarray(x))
    ((ty * torch.tensor(r)).sum() + 0.3 * taux).backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jgx), rtol=GRAD_RTOL,
                               atol=GRAD_ATOL)
    want = {"gate.weight": np.asarray(jgp["gate"]["kernel"]).T,
            "gate.bias": np.asarray(jgp["gate"]["bias"])}
    want.update({k: np.asarray(jgp[k]) for k in ("w_up", "b_up", "w_down", "b_down")})
    for name, p in tm.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[name], rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL, err_msg=name)


@pytest.mark.parametrize("capacity_factor,skew", [(8.0, 0.0), (1.0, 3.0)],
                         ids=["no-drops", "drops"])
def test_layer_against_its_oracle(capacity_factor, skew):
    """With room for every token the buckets give the oracle's output; at
    capacity 1 on a skewed router the overflow rows are exactly zero and
    every other row is the oracle's. The aux is the same number."""
    _, _, tm = _layer_pair(capacity_factor)
    x = torch.tensor(_tokens(skew=skew))
    with torch.no_grad():
        y, aux = tm(x)
        ry, raux = tm.reference(x)
    y, ry = y.reshape(-1, D), ry.reshape(-1, D)
    dropped = (y == 0).all(dim=-1)
    assert bool(dropped.any()) == (capacity_factor == 1.0)
    assert tm.capacity(24) == (6 if capacity_factor == 1.0 else 48)
    np.testing.assert_allclose(y[~dropped].numpy(), ry[~dropped].numpy(), atol=1e-6)
    assert torch.equal(aux, raux)


def test_capacity_counts_this_call_and_ties_take_the_first():
    """``ceil(capacity_factor · n / e)`` from this call's token count, in
    float64; a router that ties every expert sends every token to expert
    0 (argmax's first maximum), which keeps the first C tokens."""
    tm = MoEMLP(8, D, capacity_factor=1.25)
    assert [tm.capacity(n) for n in (320 * 32, 32 * 32, 1, 7)] == [1600, 160, 1, 2]
    init_weights(tm, torch.Generator().manual_seed(0))
    with torch.no_grad():
        tm.gate.weight.zero_()
        y, aux = tm(torch.tensor(_tokens((16, D))))
    kept = (y != 0).any(dim=-1)
    assert kept.tolist() == [True] * 3 + [False] * 13
    assert float(aux) == pytest.approx(8 * 1.0 * (1 / 8))


def test_flax_initializer_counts_the_expert_axis():
    """Flax's ``lecun_normal`` on ``[E, D, H]`` takes ``fan_in = E·D``:
    the std of a ``(8, 128, 512)`` draw is (1/1024)^½, not (1/128)^½; the
    draw is truncated at 2σ of the untruncated normal; biases are zero."""
    tm = MoEMLP(8, 128)
    init_weights(tm, torch.Generator().manual_seed(0))
    for w, fan_in in ((tm.w_up, 8 * 128), (tm.w_down, 8 * 512)):
        std = float(w.detach().std())
        assert std == pytest.approx(fan_in ** -0.5, rel=0.01)
        assert float(w.detach().abs().max()) <= 2 * fan_in ** -0.5 / 0.87962566103423978 + 1e-6
    assert not tm.b_up.any() and not tm.b_down.any() and not tm.gate.bias.any()
    jm = JMoEMLP(num_experts=8, d_model=128)
    flax_std = float(np.asarray(jm.init(jax.random.key(0), jnp.zeros((4, 128)))
                                ["params"]["w_up"]).std())
    assert flax_std == pytest.approx(float(tm.w_up.detach().std()), rel=0.01)


def _pair(case, seed=0, **over):
    name, kw, shape = CASES[case]
    kw = {**kw, **over}
    jm = jcreate_model(name, 10, compute_dtype="float32", **kw)
    variables = jm.init(jax.random.key(seed), jnp.zeros((1, *shape)))
    tm = create_model(name, 10, torch.Generator().manual_seed(seed), shape, **kw)
    tm.load_state_dict(params_from_flax(variables["params"], {}))
    return jm, variables, tm


def _x(case, n=4, seed=0):
    shape = CASES[case][2]
    return np.random.default_rng(seed).normal(0, 1, (n, *shape)).astype(np.float32)


def _port_input(x):
    t = torch.from_numpy(x)
    return t.permute(0, 3, 1, 2).contiguous() if t.dim() == 4 else t


def _objective_flax(jm, variables, x, y, weight=0.01):
    def loss_fn(params):
        logits, state = jm.apply({"params": params}, jnp.asarray(x), mutable=["losses"])
        aux = sum_sowed_losses(state)
        ce = optax.softmax_cross_entropy_with_integer_labels(logits, jnp.asarray(y)).mean()
        return ce + weight * aux, (logits, aux)

    (loss, (logits, aux)), grads = jax.value_and_grad(loss_fn, has_aux=True)(
        variables["params"])
    return float(loss), np.asarray(logits), float(aux), params_from_flax(_np_tree(grads), {})


def _objective_port(tm, x, y, weight=0.01):
    tm.zero_grad(set_to_none=True)
    logits, aux = tm(_port_input(x), return_aux=True)
    loss = torch.nn.functional.cross_entropy(logits, torch.tensor(y, dtype=torch.long))
    loss = loss + weight * aux
    loss.backward()
    return (loss.item(), logits.detach().numpy(), aux.item(),
            {k: p.grad.detach().clone() for k, p in tm.named_parameters()})


@pytest.mark.parametrize("remat", [False, True], ids=["remat-off", "remat-on"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_classifier_matches_flax_with_summed_aux(case, remat):
    """Logits, the blocks' summed aux (Flax's sowed ``"losses"``) and the
    gradients of ``CE + 0.01·aux``; with ``remat`` the port's gradients
    and aux equal its own without remat exactly (a recomputed block adds
    nothing twice)."""
    jm, variables, tm = _pair(case, remat=remat)
    x, y = _x(case), np.array([1, 7, 3, 0], np.int32)
    want_loss, want_logits, want_aux, want = _objective_flax(jm, variables, x, y)
    got_loss, got_logits, got_aux, got = _objective_port(tm, x, y)
    np.testing.assert_allclose(got_logits, want_logits, atol=LOGITS_ATOL)
    np.testing.assert_allclose(got_aux, want_aux, atol=LOGITS_ATOL)
    np.testing.assert_allclose(got_loss, want_loss, rtol=1e-6)
    assert 0.0 < got_aux <= 2 * 4  # two blocks, each in (0, E]
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL, err_msg=k)
    if remat:
        _, _, plain = _pair(case)
        _, _, plain_aux, plain_grads = _objective_port(plain, x, y)
        assert plain_aux == got_aux
        for k in plain_grads:
            assert torch.equal(plain_grads[k], got[k]), k


@pytest.mark.parametrize("case", sorted(CASES))
def test_classifier_bf16_autocast_matches_jax_bf16(case):
    """bf16 autocast against Flax's ``compute_dtype="bfloat16"`` on the same
    weights: the tokens cast to bf16 before the dispatch, the router's
    softmax in float32, the experts and their biases in bf16."""
    name, kw, shape = CASES[case]
    _, variables, tm = _pair(case)
    jm = jcreate_model(name, 10, compute_dtype="bfloat16", **kw)
    x = _x(case, n=8, seed=1)
    ref = np.asarray(jm.apply(variables, jnp.asarray(x)))
    with torch.no_grad(), torch.autocast("cpu", torch.bfloat16):
        ours, aux = tm(_port_input(x), return_aux=True)
    assert ours.dtype == aux.dtype == torch.float32
    np.testing.assert_allclose(ours.numpy(), ref, atol=2.0 ** -6 * np.abs(ref).max())


def test_classifier_without_experts_returns_a_zero_aux():
    tm = create_model("transformer", 10, None, (9, 5), d_model=16, num_heads=2, num_layers=1,
                      max_len=16)
    logits, aux = tm(torch.zeros(2, 9, 5), return_aux=True)
    assert tuple(logits.shape) == (2, 10) and aux.dtype == torch.float32 and float(aux) == 0.0
    assert not hasattr(tm.blocks[0], "moe") and hasattr(tm.blocks[0], "fc1")


@pytest.mark.parametrize("case", sorted(CASES))
def test_flat_order_and_names_are_flax(case):
    """``params_from_flax`` carries ``block{i}/moe/gate`` and the four bare
    arrays exactly, and ``port_vec[order]`` is ``ravel_pytree`` of the
    Flax ``params`` (``moe`` between ``key`` and ``proj``; ``b_down,
    b_up, gate, w_down, w_up`` inside it)."""
    name, kw, shape = CASES[case]
    jm = jcreate_model(name, 10, compute_dtype="float32", **kw)
    shapes = jax.eval_shape(lambda: jm.init(jax.random.key(0), jnp.zeros((1, *shape))))
    at = [0]

    def distinct(a):
        n = int(np.prod(a.shape))
        at[0] += n
        return np.arange(at[0] - n, at[0], dtype=np.float32).reshape(a.shape)

    params = jax.tree_util.tree_map(distinct, shapes["params"])
    assert list(params["block0"]["moe"]) == ["b_down", "b_up", "gate", "w_down", "w_up"]
    state = params_from_flax(params, {})
    assert torch.equal(state["blocks.1.moe.w_up"], torch.tensor(params["block1"]["moe"]["w_up"]))
    assert torch.equal(state["blocks.0.moe.gate.weight"],
                       torch.tensor(params["block0"]["moe"]["gate"]["kernel"]).T)
    tm = create_model(name, 10, None, shape, **kw)
    tm.load_state_dict(state)
    flat, _ = ravel_pytree(params)
    port_vec = torch.cat([p.detach().reshape(-1) for p in tm.parameters()])
    order, inverse = jax_flat_order(tm)
    np.testing.assert_array_equal(port_vec[order].numpy(), np.asarray(flat))
    assert torch.equal(torch.tensor(np.asarray(flat))[inverse], port_vec)


@pytest.mark.parametrize("name,shape", [("transformer", (32, 16)), ("vit", (32, 32, 3))])
def test_full_width_parameter_count_equals_flax(name, shape):
    jm = jcreate_model(name, 10, moe_experts=8)
    shapes = jax.eval_shape(lambda: jm.init(jax.random.key(0), jnp.zeros((1, *shape))))
    want = sum(int(np.prod(a.shape)) for a in jax.tree_util.tree_leaves(shapes["params"]))
    model = create_model(name, 10, None, shape, moe_experts=8)
    assert sum(p.numel() for p in model.parameters()) == want


def test_flop_counter_sees_the_bucketed_products():
    """``FlopCounterMode`` counts the gate and the two batched expert
    products at the bucket's capacity (not the oracle's ``E × N``):
    ``2·N·D·E + 2 · 2·E·C·D·H``."""
    from torch.utils.flop_counter import FlopCounterMode

    tm = MoEMLP(8, 16, 4, 1.25).to("meta")
    n = 5 * 7
    cap = tm.capacity(n)
    with FlopCounterMode(display=False) as counter, torch.no_grad():
        tm(torch.zeros(5, 7, 16, device="meta"))
    assert counter.get_total_flops() == 2 * n * 16 * 8 + 2 * 2 * 8 * cap * 16 * 64


def _trainer(tmp_path, **over):
    (x, y), (xt, yt) = cifar.synthetic_sequences(10, 64, 16, 8, 4, seed=0)
    dataset = make_sharded_dataset((x, y), (xt, yt), [np.arange(64)], np.zeros(1, np.float32),
                                   np.ones(1, np.float32), 10, device=torch.device("cpu"))
    cfg = TrainConfig(model="transformer", dataset="synthetic_seq", world_size=1, batch_size=4,
                      presample_batches=4, compute_dtype="float32", num_epochs=1,
                      steps_per_epoch=6, eval_every=0, log_every=0, seed=0,
                      augmentation="none", moe_experts=4, checkpoint_dir=str(tmp_path), **over)
    model = create_model("transformer", 10, torch.Generator().manual_seed(0), (8, 4),
                         d_model=16, num_heads=2, max_len=16, moe_experts=4)
    return Trainer(cfg, dataset=dataset, device="cpu", model=model)


def test_checkpoint_round_trip_of_an_moe_model(tmp_path):
    """Save after two steps, step on, restore: every parameter (the
    experts' stacked arrays too), Adam's state and the step come back
    bit-equal, and the next step's loss and aux repeat."""
    tr = _trainer(tmp_path)
    for _ in range(2):
        tr.train_step()
    tr.save()
    saved = {k: v.clone() for k, v in tr.state.model.state_dict().items()}
    adam = {i: {k: v.clone() for k, v in s.items() if torch.is_tensor(v)}
            for i, s in tr.state.optimizer.state_dict()["state"].items()}
    first = tr.train_step()
    first = {k: float(first[k]) for k in ("train/loss", "train/moe_aux")}
    assert tr.restore() == 2 and tr.state.step == 2
    for k, v in tr.state.model.state_dict().items():
        assert torch.equal(v, saved[k]), k
    assert "blocks.0.moe.w_down" in saved
    for i, s in tr.state.optimizer.state_dict()["state"].items():
        for k, v in adam[i].items():
            assert torch.equal(s[k], v), (i, k)
    again = tr.train_step()
    assert {k: float(again[k]) for k in first} == first
    tr.close()


def test_refusals_are_jax_s():
    with pytest.raises(ValueError, match=r"moe_experts requires the transformer family "
                       r"\(model='transformer'\|'vit'\), got 'resnet18'"):
        create_model("resnet18", 10, None, moe_experts=4)
    with pytest.raises(ValueError, match=r"moe_experts requires the transformer family "
                       r"\(model='transformer'\|'vit'\), got 'bilstm_attention'"):
        Trainer(TrainConfig(model="bilstm_attention", dataset="synthetic_seq", world_size=1,
                            augmentation="none", moe_experts=4), device="cpu")
    with pytest.raises(ValueError, match="^num_experts 4 not divisible by axis size 3$"):
        MoEMLP(4, 8, ep_axis="expert").bind(GroupRef(None, 3, 0))
    cfg = TrainConfig()
    assert (cfg.moe_experts, cfg.moe_aux_weight) == (None, 0.01)
