"""The port's BiLSTM-attention, Transformer and ViT against the Flax models
of the JAX package, from the same weights (``params_from_flax``), on the
CPU: forwards in float32 (eval and train mode, with and without
``lengths``), the loss's gradients, bf16 autocast against the JAX
package's ``compute_dtype="bfloat16"``, ``remat``, the parameter counts at
full width, the flat order of the ZeRO and int8 wires, Flax's initial
distributions, the refusals of what is not ported and the sequence-
parallel refusals, with the JAX package's messages. Small widths (8-32)
and a few layers."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402
from flax.linen import recurrent as flax_recurrent  # noqa: E402
from jax.flatten_util import ravel_pytree  # noqa: E402

import chip_smoke  # noqa: E402
from mercury_tpu.models import create_model as jcreate_model  # noqa: E402
from mercury_tpu_torch.models import create_model  # noqa: E402
from mercury_tpu_torch.models import lstm  # noqa: E402
from mercury_tpu_torch.models.convert import jax_flat_order, params_from_flax  # noqa: E402
from mercury_tpu_torch.models.lstm import flip_sequences  # noqa: E402
from mercury_tpu_torch.models.transformer import TransformerClassifier  # noqa: E402

# Float32 forwards: the same math in another order (XLA vs ATen products
# and reductions); the gradients after the backward through T steps or
# the attention.
LOGITS_ATOL = 1e-5
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-6

# name → (model, keyword arguments of both packages' models, sample shape).
CASES = {
    "bilstm": ("bilstm_attention", dict(hidden_dim=8, attention_dim=12, mlp_dim=16), (9, 5)),
    "transformer": ("transformer", dict(d_model=16, num_heads=2, num_layers=2, max_len=16),
                    (9, 5)),
    "transformer-causal": ("transformer", dict(d_model=16, num_heads=2, num_layers=2,
                                               max_len=16, causal=True), (9, 5)),
    "vit": ("vit", dict(d_model=16, num_heads=4, num_layers=2), (32, 32, 3)),
}
# Parameters at full width (the JAX package's defaults), 10 classes, on a
# [32, 16] sequence (the synthetic_seq sample) or a 32×32×3 image.
PARAMETERS = {"bilstm_attention": 675_722, "transformer": 662_410, "vit": 809_098}
LENGTHS = np.array([9, 4, 1, 6], np.int32)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Small models: one intra-op thread is the fastest and keeps the
    workers of a parallel run off each other's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _x(case, n=4, seed=0):
    shape = CASES[case][2]
    return np.random.default_rng(seed).normal(0, 1, (n, *shape)).astype(np.float32)


def _port_input(x):
    """The batch as the port's step hands it to a model: NCHW images."""
    t = torch.from_numpy(x)
    return t.permute(0, 3, 1, 2).contiguous() if t.dim() == 4 else t


def _pair(case, seed=0):
    """The Flax model (float32) with its variables, and the port's model
    loaded with them."""
    name, kw, shape = CASES[case]
    jm = jcreate_model(name, 10, compute_dtype="float32", **kw)
    variables = jm.init(jax.random.key(seed), jnp.zeros((1, *shape)))
    tm = create_model(name, 10, torch.Generator().manual_seed(seed), shape, **kw)
    tm.load_state_dict(params_from_flax(variables["params"], {}))
    return jm, variables, tm


def _lengths(case):
    return LENGTHS if case == "bilstm" else None


@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("case", sorted(CASES))
def test_forward_matches_flax(case, train):
    """Neither family has batch norm or dropout: train mode is eval mode."""
    jm, variables, tm = _pair(case)
    x = _x(case)
    ref = np.asarray(jm.apply(variables, jnp.asarray(x), train=train))
    with torch.no_grad():
        ours = tm(_port_input(x), train=train, keep_stats=True)
    assert ours.dtype == torch.float32 and tuple(ours.shape) == (4, 10)
    np.testing.assert_allclose(ours.numpy(), ref, atol=LOGITS_ATOL)


def test_bilstm_lengths_match_flax():
    """Positions at or past a sequence's length are masked out of both
    attentions, and the backward direction reads each sequence reversed
    within its length: changing the padding changes no logit."""
    jm, variables, tm = _pair("bilstm")
    x = _x("bilstm")
    ref = np.asarray(jm.apply(variables, jnp.asarray(x), jnp.asarray(LENGTHS)))
    with torch.no_grad():
        ours = tm(_port_input(x), torch.tensor(LENGTHS))
        padded = x.copy()
        for b, n in enumerate(LENGTHS):
            padded[b, n:] = 7.0
        again = tm(_port_input(padded), torch.tensor(LENGTHS))
    np.testing.assert_allclose(ours.numpy(), ref, atol=LOGITS_ATOL)
    np.testing.assert_allclose(again.numpy(), ours.numpy(), atol=LOGITS_ATOL)
    assert np.abs(ours.numpy() - np.asarray(jm.apply(variables, jnp.asarray(x)))).max() > 1e-3


@pytest.mark.parametrize("with_lengths", [False, True])
def test_flip_sequences_is_flax(with_lengths):
    x = _x("bilstm", seed=3)
    lengths = LENGTHS if with_lengths else None
    ref = flax_recurrent.flip_sequences(jnp.asarray(x), None if lengths is None
                                        else jnp.asarray(lengths), 1, False)
    ours = flip_sequences(torch.from_numpy(x), None if lengths is None
                          else torch.tensor(lengths))
    np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))
    np.testing.assert_array_equal(flip_sequences(ours, None if lengths is None else
                                                 torch.tensor(lengths)).numpy(), x)


@pytest.mark.parametrize("cell,direction", [(0, "forward"), (1, "backward"),
                                            (2, "forward"), (3, "backward")])
def test_which_cell_is_which_direction(cell, direction):
    """Flax's ``OptimizedLSTMCell_{cell}``: perturbing it moves only its
    layer's half of that layer's output (the first H features forward, the
    last H backward), in the Flax model, and the port's ``cells[cell]``
    moves the same half."""
    jm, variables, tm = _pair("bilstm")
    x = jnp.asarray(_x("bilstm"))
    layer = "bilstm1" if cell < 2 else "bilstm2"
    hidden = CASES["bilstm"][1]["hidden_dim"]

    def flax_h(params):
        _, inter = jm.apply({"params": params}, x, capture_intermediates=True,
                            mutable=["intermediates"])
        return np.asarray(inter["intermediates"][layer]["__call__"][0])

    name = f"OptimizedLSTMCell_{cell}"
    bumped = dict(variables["params"])
    bumped[name] = jax.tree_util.tree_map(lambda a: a + 0.5, bumped[name])
    before, after = flax_h(variables["params"]), flax_h(bumped)
    moved = np.abs(after - before).max(axis=(0, 1))
    half = slice(0, hidden) if direction == "forward" else slice(hidden, 2 * hidden)
    other = slice(hidden, 2 * hidden) if direction == "forward" else slice(0, hidden)
    assert moved[half].min() > 1e-4 and moved[other].max() == 0.0

    def port_h(model):
        with torch.no_grad():
            h = lstm.bilstm(torch.from_numpy(np.array(x)), model.cells[0], model.cells[1],
                            None)
            return (h if cell < 2 else lstm.bilstm(h, model.cells[2], model.cells[3], None)
                    ).numpy()

    np.testing.assert_allclose(port_h(tm), before, atol=LOGITS_ATOL)
    tm.load_state_dict(params_from_flax(bumped, {}))
    np.testing.assert_allclose(port_h(tm), after, atol=LOGITS_ATOL)


def _loss_grads_flax(jm, variables, x, y, lengths=None):
    def loss(params):
        args = (jnp.asarray(x),) if lengths is None else (jnp.asarray(x), jnp.asarray(lengths))
        logits = jm.apply({"params": params}, *args)
        return optax.softmax_cross_entropy_with_integer_labels(logits, jnp.asarray(y)).mean()

    value, grads = jax.value_and_grad(loss)(variables["params"])
    return float(value), params_from_flax(jax.tree_util.tree_map(np.asarray, grads), {})


def _loss_grads_port(tm, x, y, lengths=None):
    tm.zero_grad(set_to_none=True)
    args = (_port_input(x),) if lengths is None else (_port_input(x), torch.tensor(lengths))
    loss = torch.nn.functional.cross_entropy(tm(*args), torch.tensor(y).long())
    loss.backward()
    return float(loss.detach()), {k: p.grad.clone() for k, p in tm.named_parameters()}


@pytest.mark.parametrize("case", sorted(CASES))
def test_gradients_match_flax(case):
    jm, variables, tm = _pair(case)
    x, y = _x(case), np.array([1, 7, 3, 0], np.int32)
    want_loss, want = _loss_grads_flax(jm, variables, x, y, _lengths(case))
    got_loss, got = _loss_grads_port(tm, x, y, _lengths(case))
    np.testing.assert_allclose(got_loss, want_loss, rtol=1e-6)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL, err_msg=k)


@pytest.mark.parametrize("case", sorted(CASES))
def test_bf16_autocast_matches_jax_bf16(case):
    """``torch.autocast("cpu", torch.bfloat16)`` against the Flax model
    with ``compute_dtype="bfloat16"`` on the same weights: the logits are
    bf16 values cast to float32 on both sides, so they agree to two bf16
    ulps at the largest logit (atol ``2**-6 · max|logit|``). The BiLSTM's
    cells run in float32 on both sides (its input rounded to bf16 first)."""
    name, kw, shape = CASES[case]
    _, variables, tm = _pair(case)
    jm = jcreate_model(name, 10, compute_dtype="bfloat16", **kw)
    x = _x(case, n=8, seed=1)
    ref = np.asarray(jm.apply(variables, jnp.asarray(x)))
    with torch.no_grad(), torch.autocast("cpu", torch.bfloat16):
        ours = tm(_port_input(x))
    assert ours.dtype == torch.float32
    np.testing.assert_allclose(ours.numpy(), ref, atol=2.0 ** -6 * np.abs(ref).max())


@pytest.mark.parametrize("case", ["transformer", "vit"])
def test_remat_gradients_equal_off_and_jax(case):
    """``remat=True`` recomputes each block in the backward: the port's
    gradients equal its own without remat exactly, and JAX's
    ``remat=True`` gradients to the tolerance above."""
    name, kw, shape = CASES[case]
    jm, variables, tm = _pair(case)
    tm_remat = create_model(name, 10, None, shape, remat=True, **kw)
    tm_remat.load_state_dict(tm.state_dict())
    assert tm_remat.remat and not tm.remat
    x, y = _x(case), np.array([2, 2, 9, 4], np.int32)
    _, off = _loss_grads_port(tm, x, y)
    _, on = _loss_grads_port(tm_remat, x, y)
    jm_remat = jcreate_model(name, 10, compute_dtype="float32", remat=True, **kw)
    _, want = _loss_grads_flax(jm_remat, variables, x, y)
    for k in off:
        assert torch.equal(on[k], off[k]), k
        np.testing.assert_allclose(on[k].numpy(), want[k].numpy(), rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL, err_msg=k)


def _flax_count(name, shape):
    jm = jcreate_model(name, 10)
    shapes = jax.eval_shape(lambda: jm.init(jax.random.key(0), jnp.zeros((1, *shape))))
    return sum(int(np.prod(a.shape)) for a in jax.tree_util.tree_leaves(shapes["params"]))


@pytest.mark.parametrize("name", sorted(PARAMETERS))
def test_full_width_parameter_count_equals_flax(name):
    shape = (32, 32, 3) if name == "vit" else (32, 16)
    model = create_model(name, 10, None, shape)
    assert sum(p.numel() for p in model.parameters()) == _flax_count(name, shape) \
        == PARAMETERS[name]
    smoke = {k[0]: v for k, v in chip_smoke.PARAMETERS.items()
             if k[0] in PARAMETERS and k[1] == 10}
    assert smoke[name] == PARAMETERS[name]


@pytest.mark.parametrize("case", ["bilstm", "transformer", "vit"])
def test_flat_order_is_ravel_pytree(case):
    """``port_vec[order]`` is ``ravel_pytree`` of the Flax ``params``
    exactly, every value distinct: the LSTM gates in the order ``hf, hg,
    hi, ho, if, ig, ii, io``, ``LayerNorm_0`` before ``block0``, the bare
    ``pos_embed`` among the top-level names."""
    name, kw, shape = CASES[case]
    jm = jcreate_model(name, 10, compute_dtype="float32", **kw)
    shapes = jax.eval_shape(lambda: jm.init(jax.random.key(0), jnp.zeros((1, *shape))))
    at = [0]

    def distinct(a):
        n = int(np.prod(a.shape))
        at[0] += n
        return np.arange(at[0] - n, at[0], dtype=np.float32).reshape(a.shape)

    params = jax.tree_util.tree_map(distinct, shapes["params"])
    tm = create_model(name, 10, None, shape, **kw)
    tm.load_state_dict(params_from_flax(params, {}))
    flat, _ = ravel_pytree(params)
    port_vec = torch.cat([p.detach().reshape(-1) for p in tm.parameters()])
    order, inverse = jax_flat_order(tm)
    np.testing.assert_array_equal(port_vec[order].numpy(), np.asarray(flat))
    assert torch.equal(torch.tensor(np.asarray(flat))[inverse], port_vec)
    if case == "bilstm":
        assert list(params["OptimizedLSTMCell_0"]) == ["hf", "hg", "hi", "ho", "if", "ig",
                                                       "ii", "io"]


def test_initial_distributions_are_flax():
    """Orthogonal hidden kernels (each gate's), ``normal(0.02)`` positional
    embedding, LayerNorm 1 and 0, zero biases, truncated LeCun-normal
    kernels (none past 2σ)."""
    lstm = create_model("bilstm_attention", 10, torch.Generator().manual_seed(3), (32, 16))
    for cell in lstm.cells:
        for g in "ifgo":
            w = getattr(cell, f"h{g}").weight.detach()
            np.testing.assert_allclose((w @ w.T).numpy(), np.eye(128), atol=1e-5)
            assert not getattr(cell, f"h{g}").bias.any()
            wi = getattr(cell, f"i{g}").weight.detach()
            std = (1.0 / wi.shape[1]) ** 0.5 / 0.87962566103423978
            assert wi.abs().max() <= 2 * std + 1e-6
    vit = create_model("vit", 10, torch.Generator().manual_seed(3))
    assert abs(float(vit.pos_embed.detach().std()) - 0.02) < 0.002
    assert tuple(vit.pos_embed.shape) == (64, 128)
    for mod in vit.modules():
        if isinstance(mod, torch.nn.LayerNorm):
            assert mod.eps == 1e-6
            assert bool((mod.weight == 1).all()) and not mod.bias.any()


@pytest.mark.parametrize("kw,item", [(dict(moe_experts=4, moe_ep_axis="expert", sp_axis="seq"),
                                      "item 8")])
def test_unported_transformer_options_raise(kw, item):
    """Experts and sequences split together (a pipe × expert × seq mesh)
    are not ported: ``make_pp_apply`` names ROADMAP's item 8d."""
    from mercury_tpu_torch.parallel.mesh import GroupRef, Mesh
    from mercury_tpu_torch.parallel.pipeline import make_pp_apply

    mesh = Mesh(("data", "pipe", "expert"), {"data": 1, "pipe": 1, "expert": 2}, data_rank=0,
                model_rank=0, model=GroupRef(None, 1, 0), inner=GroupRef(None, 2, 0))
    model = create_model("transformer", 10, None, (8, 4), **kw)
    with pytest.raises(ValueError, match=item):
        make_pp_apply(model, mesh, 2, with_aux=True)


def _sp_refusal(case):
    """The call that must refuse in each sequence-parallel refusal case,
    on a sequence group of two that is never reached (each raises before
    any collective)."""
    from mercury_tpu_torch.parallel import sequence as tseq
    from mercury_tpu_torch.parallel.mesh import GroupRef, Mesh
    from mercury_tpu_torch.train.sp_step import init_sp_mercury_state, make_dp_sp_mercury_step

    pair = GroupRef(None, 2, 0)
    q = torch.zeros((1, 4, 2, 4))

    def model(**kw):
        m = TransformerClassifier(10, 4, d_model=8, num_heads=2, num_layers=1,
                                  **{"max_len": 16, "sp_axis": "seq", **kw})
        return m if kw.get("patch_size") else tseq.bind_sequence_group(m, pair)

    if case == "raw_images":
        return lambda: model(patch_size=4)(torch.zeros((1, 4, 8, 8)))
    if case == "odd_zigzag_length":
        return lambda: model(sp_impl="zigzag")(torch.zeros((1, 3, 4)))
    if case == "ulysses_heads":
        return lambda: tseq.ulysses_attention(q, q, q, GroupRef(None, 4, 0))
    if case == "global_length":
        return lambda: model(max_len=8)(torch.zeros((1, 5, 4)))
    if case == "zigzag_order":
        return lambda: tseq.zigzag_order(10, 2)
    if case == "unknown_sp_impl":
        return lambda: tseq.attention(q, q, q, sp_axis="seq", sp_impl="flash", group=pair)
    if case == "unbound_group":
        return lambda: TransformerClassifier(10, 4, d_model=8, num_heads=2, num_layers=1,
                                             sp_axis="seq")(torch.zeros((1, 4, 4)))
    # The step: 65 tokens on a sequence axis of 2.
    mesh = Mesh(("data", "seq"), {"data": 1, "seq": 2}, data_rank=0, model_rank=0,
                model=pair)
    m = model()
    state = init_sp_mercury_state(m, torch.optim.SGD(m.parameters(), lr=0.1), mesh, 16,
                                  device="cpu")
    step = make_dp_sp_mercury_step(m, mesh, 2, 2)
    return lambda: step(state, torch.zeros((16, 65, 4)), torch.zeros(16, dtype=torch.int32))


# The JAX package's messages (mercury_tpu/models/transformer.py,
# parallel/sequence.py, train/sp_step.py), and the port's own for a model
# whose sequence group was never bound.
SP_REFUSALS = {
    "raw_images": "sequence parallelism over raw images is unsupported: patchify first, "
                  "then shard the token sequence",
    "odd_zigzag_length": "zigzag layout needs an even local length, got 3",
    "ulysses_heads": "ulysses attention needs num_heads (2) divisible by the 'seq' axis size "
                     "(4); use ring attention otherwise",
    "global_length": "sequence length 10 exceeds max_len=8",
    "zigzag_order": "zigzag layout needs sequence length (10) divisible by 2 x axis size (4)",
    "unknown_sp_impl": "unknown sp_impl 'flash' (expected 'ring', 'zigzag', or 'ulysses')",
    "step_length": "sequence length 65 must divide by the 'seq' axis size 2",
    "unbound_group": "sp_axis='seq' needs its sequence group bound "
                     "(parallel.sequence.bind_sequence_group)",
}


@pytest.mark.parametrize("case", list(SP_REFUSALS))
def test_sequence_parallel_refusals_are_jax_s(case):
    with pytest.raises(ValueError) as err:
        _sp_refusal(case)()
    assert str(err.value) == SP_REFUSALS[case]
    if case == "zigzag_order":
        from mercury_tpu.parallel.sequence import zigzag_order

        with pytest.raises(ValueError) as jerr:
            zigzag_order(10, 2)
        assert str(jerr.value) == str(err.value)


def test_remat_refused_outside_the_transformer_family():
    with pytest.raises(ValueError, match=r"remat requires the transformer family "
                       r"\(model='transformer'\|'vit'\), got 'resnet18'"):
        create_model("resnet18", 10, None, remat=True)


def test_shape_refusals_are_jax_s():
    model = TransformerClassifier(10, 5, d_model=8, num_heads=2, num_layers=1, max_len=4)
    with pytest.raises(ValueError, match="sequence length 9 exceeds max_len=4"):
        model(torch.zeros(2, 9, 5))
    with pytest.raises(ValueError, match="needs patch_size set"):
        model(torch.zeros(2, 5, 8, 8))
    vit = create_model("vit", 10, None, patch_size=3, max_len=121)
    with pytest.raises(ValueError, match="not divisible by patch_size 3"):
        vit(torch.zeros(1, 3, 32, 32))
