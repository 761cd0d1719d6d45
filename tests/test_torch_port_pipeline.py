"""The port's pipeline parallelism (``parallel/pipeline.py``) against the
JAX package's (``mercury_tpu/parallel/pipeline.py``), on the CPU.

JAX's ``make_pp_apply`` runs on pipe meshes of 2 and 4 virtual CPU
devices, the port's on four gloo ranks (one spawn a file; the rank body is
``test_torch_port_ranks.pipeline_rank``): a pipe of 4 is the whole process
group, a pipe of 2 is ``make_tp_mesh(2, 2, "data", "pipe")``, two
pipelines fed alike. The model is JAX's test model
(``tests/test_pipeline_parallel.py``: T=16, F=8, C=5, d_model 32, 2 heads,
4 blocks, a batch of 8), the port's stages from the JAX weights through
``staged_from_flax``.

Cases: the stacking against JAX's on one tree; a rank holding L/S blocks;
the forward at S=2 and S=4 and M ∈ {1, 2, 4} against JAX's at the same S
and M, and every gradient of the mean NLL against JAX's ``value_and_grad``
through its schedule; ``remat`` against no remat; ViT mode; the refusals.
Tolerances, the JAX package's own (``tests/test_pipeline_parallel.py``):
logits rtol 2e-5 and atol 2e-5, the loss rtol 1e-5, gradients rtol 1e-3
and atol 1e-5; remat against no remat, the loss rtol 1e-6, gradients rtol
1e-5 and atol 1e-6.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import Mesh  # noqa: E402

from mercury_tpu.models import TransformerClassifier as JTransformer  # noqa: E402
from mercury_tpu.parallel import pipeline as jpp  # noqa: E402
from mercury_tpu.sampling.importance import per_sample_loss  # noqa: E402
from mercury_tpu_torch.models.convert import params_from_flax  # noqa: E402
from mercury_tpu_torch.models.transformer import TransformerClassifier  # noqa: E402
from mercury_tpu_torch.parallel import pipeline as tpp  # noqa: E402
from mercury_tpu_torch.parallel.distributed import spawn  # noqa: E402
from mercury_tpu_torch.parallel.mesh import GroupRef  # noqa: E402
from mercury_tpu_torch.parallel.mesh import Mesh as TMesh  # noqa: E402
from test_torch_port_ranks import pipeline_rank  # noqa: E402

T, F, C, D, L, BATCH = 16, 8, 5, 32, 4, 8
CASES = [(s, m) for s in (2, 4) for m in (1, 2, 4)]
VIT = dict(patch_size=4, max_len=4)   # 8×8 RGB images, 2×2 patches of 4


def np_tree(tree):
    return jax.tree_util.tree_map(lambda a: np.array(a), tree)


def jax_model(**kw):
    return JTransformer(**{**dict(num_classes=C, d_model=D, num_heads=2, num_layers=L,
                                  max_len=T), **kw})


def port_kw(in_features=F, **kw):
    """The port's constructor arguments of ``jax_model(**kw)``."""
    return {**dict(num_classes=C, in_features=in_features, d_model=D, num_heads=2,
                   num_layers=L, max_len=T), **kw}


def jax_mesh(stages):
    return Mesh(np.array(jax.devices()[:stages]), ("pipe",))


def staged(params, stages):
    """Each stage's state dict of the Flax ``params`` (numpy)."""
    stacked, rest = jpp.stack_block_params(params, L)
    stacked, rest = np_tree(stacked), np_tree(rest)
    return [tpp.staged_from_flax(stacked, rest, i, stages) for i in range(stages)]


def jax_apply(model, params, x, y, stages, m, aux_weight=None):
    """JAX's pipelined forward and gradient of the mean NLL (plus
    ``aux_weight`` × the router loss where given): the logits, the loss,
    the router loss and the gradients as a port state dict."""
    mesh = jax_mesh(stages)
    stacked, rest = jpp.stack_block_params(params, L)
    stacked = jpp.shard_stacked_blocks(stacked, mesh)
    apply = jpp.make_pp_apply(model, mesh, m, with_aux=aux_weight is not None)

    def f(st, rs):
        out = apply(st, rs, x)
        logits, aux = out if aux_weight is not None else (out, jnp.zeros(()))
        total = jnp.mean(per_sample_loss(logits, y)) + (aux_weight or 0.0) * aux
        return total, (logits, aux)

    (loss, (logits, aux)), (g_st, g_rest) = jax.jit(
        jax.value_and_grad(f, argnums=(0, 1), has_aux=True))(stacked, rest)
    grads = params_from_flax(tpp.unstack_block_params(np_tree(g_st), np_tree(g_rest)), {})
    return dict(logits=np.asarray(logits), loss=float(loss), aux=float(aux), grads=grads)


def whole(name, stage, stages):
    """The unstaged model's name of a stage's entry ``name``."""
    if not name.startswith("blocks."):
        return name
    _, i, leaf = name.split(".", 2)
    return f"blocks.{int(i) + stage * (L // stages)}.{leaf}"


def check_grads(got, stage, stages, want, rtol, atol):
    for k, g in got.items():
        np.testing.assert_allclose(g.numpy(), want[whole(k, stage, stages)].numpy(),
                                   rtol=rtol, atol=atol, err_msg=k)


def _data():
    x = jax.random.normal(jax.random.key(0), (BATCH, T, F), jnp.float32)
    return x, jnp.arange(BATCH) % C


@pytest.fixture(scope="module")
def both():
    """JAX's forward and gradients of each case (and ViT's at S=2, M=2),
    then the port's on four gloo ranks, with a remat run of S=4, M=2."""
    x, y = _data()
    model = jax_model()
    params = np_tree(model.init(jax.random.key(1), x, train=False)["params"])
    ref, jobs = {}, []
    for s, m in CASES:
        ref[s, m] = jax_apply(model, params, x, y, s, m)
        jobs.append(dict(kind="apply", stages=s, microbatches=m, model=port_kw(),
                         staged=staged(params, s), x=np.asarray(x), y=np.asarray(y)))
    jobs.append(dict(jobs[CASES.index((4, 2))], remat=True))
    images = jax.random.normal(jax.random.key(2), (BATCH, 8, 8, 3), jnp.float32)
    vit = jax_model(**VIT)
    vit_params = np_tree(vit.init(jax.random.key(3), images, train=False)["params"])
    ref["vit"] = jax_apply(vit, vit_params, images, y, 2, 2)
    jobs.append(dict(kind="apply", stages=2, microbatches=2, model=port_kw(3, **VIT),
                     staged=staged(vit_params, 2), x=np.asarray(images).transpose(0, 3, 1, 2),
                     y=np.asarray(y)))
    ranks = spawn(pipeline_rank, 4, "gloo", jobs, (2, 4))
    ports = [[r["jobs"][i] for r in ranks] for i in range(len(jobs))]
    return ref, dict(zip(CASES + ["remat", "vit"], ports)), params


@pytest.mark.parametrize("case", CASES, ids=[f"S{s}-M{m}" for s, m in CASES])
def test_forward_matches_jax(both, case):
    ref, ports, _ = both
    for port in ports[case]:
        np.testing.assert_allclose(port["logits"].numpy(), ref[case]["logits"], rtol=2e-5,
                                   atol=2e-5)
        np.testing.assert_allclose(port["loss"], ref[case]["loss"], rtol=1e-5)


@pytest.mark.parametrize("case", CASES, ids=[f"S{s}-M{m}" for s, m in CASES])
def test_gradients_match_jax(both, case):
    """Every parameter's gradient after the schedule's backward and the
    replicated parameters' sum over the pipe group: a block's on the rank
    that holds it, the others on every rank."""
    ref, ports, _ = both
    for port in ports[case]:
        check_grads(port["grads"], port["stage"], case[0], ref[case]["grads"], 1e-3, 1e-5)


def test_a_rank_holds_its_stage(both):
    """Each rank of a pipe of S holds L/S blocks, stage i of the pipe
    blocks [i·L/S, (i+1)·L/S) (its gradients carry the whole model's)."""
    _, ports, _ = both
    for (s, _), port in ((c, ports[c]) for c in CASES):
        assert [p["blocks"] for p in port] == [L // s] * 4
        assert [p["stage"] for p in port] == [r % s for r in range(4)]
    model = TransformerClassifier(**port_kw())
    block = sum(p.numel() for p in model.blocks[0].parameters())
    total = sum(p.numel() for p in model.parameters())
    mesh = _fake_mesh(2, rank=1)
    first = model.blocks[2]
    tpp.shard_stacked_blocks(model, mesh)
    assert len(model.blocks) == 2 and model.blocks[0] is first
    assert sum(p.numel() for p in model.parameters()) == total - 2 * block


def test_remat_matches_no_remat(both):
    _, ports, _ = both
    for plain, remat in zip(ports[4, 2], ports["remat"]):
        np.testing.assert_allclose(remat["loss"], plain["loss"], rtol=1e-6)
        for k, g in remat["grads"].items():
            np.testing.assert_allclose(g.numpy(), plain["grads"][k].numpy(), rtol=1e-5,
                                       atol=1e-6, err_msg=k)


def test_vit_mode_matches_jax(both):
    """ViT: NCHW images (JAX's NHWC transposed) patchified by the
    embedding on every rank, at S=2, M=2."""
    ref, ports, _ = both
    for port in ports["vit"]:
        np.testing.assert_allclose(port["logits"].numpy(), ref["vit"]["logits"], rtol=2e-5,
                                   atol=2e-5)
        check_grads(port["grads"], port["stage"], 2, ref["vit"]["grads"], 1e-3, 1e-5)


def test_stacking_round_trips_as_jax_s(both):
    """On the Flax tree the port's stacking is JAX's, leaf for leaf, and so
    is its unstacking; on a state dict the round trip is the identity and
    a stacked leaf's row i is block i's."""
    _, _, params = both
    want_st, want_rest = jpp.stack_block_params(params, L)
    got_st, got_rest = tpp.stack_block_params(params, L)
    for a, b in zip(jax.tree_util.tree_leaves((got_st, got_rest)),
                    jax.tree_util.tree_leaves((want_st, want_rest))):
        np.testing.assert_array_equal(a, np.asarray(b))
    again = tpp.unstack_block_params(np_tree(want_st), np_tree(want_rest))
    want = jpp.unstack_block_params(want_st, want_rest)
    assert jax.tree_util.tree_structure(again) == jax.tree_util.tree_structure(want)
    for a, b in zip(jax.tree_util.tree_leaves(again), jax.tree_util.tree_leaves(want)):
        np.testing.assert_array_equal(a, np.asarray(b))
    sd = params_from_flax(params, {})
    stacked, rest = tpp.stack_block_params(sd, L)
    assert stacked["query.weight"].shape == (L, D, D)
    torch.testing.assert_close(stacked["fc1.bias"][3], sd["blocks.3.fc1.bias"], rtol=0, atol=0)
    back = tpp.unstack_block_params(stacked, rest)
    assert back.keys() == sd.keys()
    for k, v in sd.items():
        assert torch.equal(back[k], v), k


def _fake_mesh(stages, rank=0):
    """A pipe mesh of ``stages`` ranks whose group is never reached: each
    refusal raises before any collective."""
    return TMesh(("data", "pipe"), {"data": 1, "pipe": stages}, data_rank=0, model_rank=rank,
                 model=GroupRef(None, stages, rank))


def _fake_mesh_2d(inner, n, rank=0):
    """A pipe of 2 × ``inner`` of ``n`` mesh whose groups are never
    reached."""
    return TMesh(("data", "pipe", inner), {"data": 1, "pipe": 2, inner: n}, data_rank=0,
                 model_rank=rank, model=GroupRef(None, 2, rank), inner=GroupRef(None, n, 0))


def _refusal(case):
    from mercury_tpu_torch.train.pp_step import create_pp_state, make_pp_mercury_step

    mesh = _fake_mesh(2)

    def staged_model(on=mesh, **kw):
        return tpp.shard_stacked_blocks(TransformerClassifier(**port_kw(**kw)), on)

    experts = dict(moe_experts=2, moe_ep_axis="expert")
    if case == "sp_axis":
        return lambda: tpp.make_pp_apply(staged_model(sp_axis="seq"), mesh, 2)
    if case == "moe_ep_axis":
        return lambda: tpp.make_pp_apply(staged_model(**experts), mesh, 2, with_aux=True)
    if case == "experts_ep_axis":
        return lambda: staged_model(_fake_mesh_2d("expert", 3), **experts)
    if case == "three_axes":
        return lambda: staged_model(_fake_mesh_2d("expert", 2), sp_axis="seq", **experts)
    if case == "unused_inner_axis":
        return lambda: staged_model(_fake_mesh_2d("seq", 2))
    if case == "step_expert_batch":
        on = _fake_mesh_2d("expert", 2)
        return lambda: make_pp_mercury_step(staged_model(on, **experts), on, batch_size=6)
    if case == "layers":
        return lambda: tpp.shard_stacked_blocks(TransformerClassifier(**port_kw()),
                                                _fake_mesh(3))
    if case == "batch":
        return lambda: tpp.make_pp_apply(staged_model(), mesh, 3)(torch.zeros((BATCH, T, F)))
    if case == "with_aux":
        return lambda: tpp.make_pp_apply(staged_model(moe_experts=2), mesh, 2)
    if case == "step_microbatches":
        return lambda: make_pp_mercury_step(staged_model(), mesh, batch_size=9)
    if case == "unstaged":
        return lambda: tpp.make_pp_apply(TransformerClassifier(**port_kw()), mesh, 2)
    if case == "staged_twice":
        return lambda: tpp.shard_stacked_blocks(staged_model(), mesh)
    if case == "staged_forward":
        return lambda: staged_model()(torch.zeros((BATCH, T, F)))
    if case == "optimizer_first":
        model = TransformerClassifier(**port_kw())
        opt = torch.optim.SGD(model.parameters(), lr=0.1)
        return lambda: create_pp_state(model, opt, mesh, 64, device="cpu")
    raise AssertionError(case)


REFUSALS = {"sp_axis": r"^model.sp_axis='seq' needs that axis in the mesh; mesh axes: "
                       r"\('data', 'pipe'\)$",
            "moe_ep_axis": r"^model.moe_ep_axis='expert' needs that axis in the mesh; mesh "
                           r"axes: \('data', 'pipe'\)$",
            "experts_ep_axis": "^num_experts 2 not divisible by axis size 3$",
            "three_axes": "Queue 1 item 8d",
            "unused_inner_axis": "needs a model built with sp_axis or moe_ep_axis 'seq'",
            "step_expert_batch": r"^pool \(60\) and batch \(6\) must divide by the "
                                 r"'expert' axis size × num_microbatches \(2×2\)$",
            "layers": "^num_layers 4 not divisible by pipe axis size 3$",
            "batch": "batch must divide into microbatches",
            "with_aux": "with_aux=True",
            "step_microbatches": r"must divide by num_microbatches \(2\)",
            "unstaged": "shard_stacked_blocks", "staged_twice": "staged already",
            "staged_forward": "make_pp_apply", "optimizer_first": "shard_stacked_blocks"}


@pytest.mark.parametrize("case", list(REFUSALS))
def test_refusals(case):
    """What JAX refuses (``L % S`` with its message, a batch ``M`` does not
    divide, experts without ``with_aux``, the step's microbatches, a model
    axis the mesh lacks with its message, ``num_experts % W`` with its
    message), the three-axis mesh of item 8d, a 2-D mesh whose inner axis
    the model does not use, a pipe × expert batch ``W·M`` does not divide,
    and a model used unstaged, staged twice, run whole when staged, or
    staged after its optimizer was built."""
    with pytest.raises(ValueError, match=REFUSALS[case]):
        _refusal(case)()


def test_refusal_texts_are_jax_s():
    """The layer count's and the step's messages are JAX's own."""
    from mercury_tpu.train.pp_step import make_pp_mercury_step as jax_step
    from mercury_tpu_torch.train.pp_step import make_pp_mercury_step

    import optax

    with pytest.raises(ValueError) as want:
        jpp.make_pp_apply(jax_model(), jax_mesh(3), 2)
    with pytest.raises(ValueError) as got:
        _refusal("layers")()
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError) as want:
        jax_step(jax_model(), optax.sgd(0.1), jax_mesh(2), batch_size=9)
    mesh = _fake_mesh(2)
    model = tpp.shard_stacked_blocks(TransformerClassifier(**port_kw()), mesh)
    with pytest.raises(ValueError) as got:
        make_pp_mercury_step(model, mesh, batch_size=9)
    assert str(got.value) == str(want.value)
