"""The port's pipeline on a mesh with two model axes (``parallel/pipeline.py``
on ``make_pp_mesh``) against the JAX package's ``make_pp_apply`` on its
``("pipe", "seq")`` and ``("pipe", "expert")`` meshes, on the CPU.

JAX runs on 2 × 2 virtual CPU devices, the port on four gloo ranks (one
spawn; the rank body is ``test_torch_port_ranks.pp_2d_rank``), with JAX's
test model (``tests/test_pipeline_parallel.py``: T=16, F=8, C=5, d_model
32, 2 heads, 4 blocks, a batch of 8, M=2), initialized as JAX's twin without
the second axis and carried across by ``staged_from_flax``:

- **pipe × seq**, ring attention: each rank takes its window of the tokens;
  the logits, the mean NLL and every gradient against JAX's
  ``value_and_grad`` through its schedule (``test_pp_sp_2d_mesh_matches_dense``);
  and with 4 experts a block on the dense path (capacity 8), whose router
  loss each seq rank takes on its own tokens and the schedule averages
  over the seq group, with 10 × it in the loss;
- **pipe × expert**, 4 experts a block over 2 expert ranks, at capacity 8
  (every token admitted) and at 1.25 (the default: tokens drop): each rank
  takes its half of the batch; its logits, the router loss and every
  gradient of the mean NLL plus 10 × the router loss against JAX's
  (``test_pipeline_composes_with_ep_moe``); at capacity 8 its logits
  against the dense pipeline's too.

Tolerances, the JAX package's own: logits rtol 2e-5 and atol 2e-5, the loss
and the router loss rtol 1e-5, gradients rtol 1e-3 and atol 1e-5 (pipe ×
seq), rtol 5e-4 and atol 5e-5 (pipe × expert). The refusals of the 2-D
meshes are cases of ``tests/test_torch_port_pipeline.py``'s.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import Mesh  # noqa: E402

from mercury_tpu.parallel import pipeline as jpp  # noqa: E402
from mercury_tpu.sampling.importance import per_sample_loss  # noqa: E402
from mercury_tpu_torch.models.convert import expert_shard, params_from_flax  # noqa: E402
from mercury_tpu_torch.parallel.distributed import spawn  # noqa: E402
from test_torch_port_pipeline import BATCH, F, L, T, jax_model, np_tree, port_kw  # noqa: E402
from test_torch_port_ranks import pp_2d_rank  # noqa: E402

M, AUX = 2, 10.0
EXPERTS = dict(moe_experts=4)
CASES = {"seq": dict(sp_axis="seq"),
         "seq_experts": dict(sp_axis="seq", moe_capacity_factor=8.0, **EXPERTS),
         "expert": dict(moe_ep_axis="expert", moe_capacity_factor=8.0, **EXPERTS),
         "expert_drops": dict(moe_ep_axis="expert", moe_capacity_factor=1.25, **EXPERTS)}
TOLS = {"seq": (1e-3, 1e-5), "seq_experts": (1e-3, 1e-5), "expert": (5e-4, 5e-5),
        "expert_drops": (5e-4, 5e-5)}


def inner_of(case):
    return "seq" if case.startswith("seq") else "expert"


def twin(kw):
    """The model's keywords without its second axis: JAX's init runs
    outside ``shard_map``, where an axis name is unbound."""
    return {k: v for k, v in kw.items() if k not in ("sp_axis", "moe_ep_axis")}


def jax_mesh_2d(inner):
    return Mesh(np.array(jax.devices()[:4]).reshape(2, 2), ("pipe", inner))


def jax_apply_2d(case, params, x, y):
    """JAX's pipelined forward on its 2 × 2 mesh and the gradient of the
    mean NLL (plus 10 × the router loss with experts): the logits, the
    loss, the router loss and the gradients as a port state dict."""
    kw = CASES[case]
    model = jax_model(**kw)
    inner, aux = inner_of(case), "moe_experts" in kw
    mesh = jax_mesh_2d(inner)
    stacked, rest = jpp.stack_block_params(params, L)
    if inner == "expert":
        stacked = jpp.shard_stacked_blocks(stacked, mesh, "pipe", model=model, ep="expert")
    else:
        stacked = jpp.shard_stacked_blocks(stacked, mesh, "pipe")
    apply = jpp.make_pp_apply(model, mesh, M, with_aux=aux)

    def f(st, rs):
        out = apply(st, rs, x)
        logits, a = out if aux else (out, jnp.zeros(()))
        return jnp.mean(per_sample_loss(logits, y)) + (AUX if aux else 0.0) * a, (logits, a)

    (loss, (logits, a)), (g_st, g_rest) = jax.jit(
        jax.value_and_grad(f, argnums=(0, 1), has_aux=True))(stacked, rest)
    grads = params_from_flax(jpp.unstack_block_params(np_tree(g_st), np_tree(g_rest)), {})
    out = dict(logits=np.asarray(logits), loss=float(loss), aux=float(a), grads=grads)
    if case == "expert":
        dense = jax_model(**twin(kw))
        pipe = Mesh(np.array(jax.devices()[:2]), ("pipe",))
        st = jpp.shard_stacked_blocks(jpp.stack_block_params(params, L)[0], pipe)
        out["dense"] = np.asarray(jpp.make_pp_apply(dense, pipe, M, with_aux=True)(
            st, jpp.stack_block_params(params, L)[1], x)[0])
    return out


@pytest.fixture(scope="module")
def both():
    x = jax.random.normal(jax.random.key(7), (BATCH, T, F), jnp.float32)
    y = jnp.arange(BATCH) % 5
    ref, jobs = {}, []
    for i, (case, kw) in enumerate(CASES.items()):
        params = np_tree(jax_model(**twin(kw)).init(jax.random.key(8 + i), x,
                                                     train=False)["params"])
        ref[case] = jax_apply_2d(case, params, x, y)
        stacked, rest = jpp.stack_block_params(params, L)
        jobs.append(dict(kind="apply", inner=inner_of(case), microbatches=M,
                         model=port_kw(**kw), stacked=np_tree(stacked), rest=np_tree(rest),
                         x=np.asarray(x), y=np.asarray(y), with_aux="moe_experts" in kw,
                         aux_weight=AUX if "moe_experts" in kw else 0.0))
    ranks = spawn(pp_2d_rank, 4, "gloo", jobs)
    return ref, {case: [r["jobs"][i] for r in ranks] for i, case in enumerate(CASES)}


def whole(name, stage):
    """The unstaged model's name of a stage's entry ``name``."""
    if not name.startswith("blocks."):
        return name
    _, i, leaf = name.split(".", 2)
    return f"blocks.{int(i) + stage * (L // 2)}.{leaf}"


def check_grads(port, want, ep, rtol, atol):
    """A rank's gradients against JAX's whole ones: a block's under the
    unstaged model's name, an expert leaf's the rank's slice of it."""
    got = {whole(k, port["stage"]): g for k, g in port["grads"].items()}
    if ep:
        want = expert_shard(want, port["inner"], 2)
    for k, g in got.items():
        np.testing.assert_allclose(g.numpy(), want[k].numpy(), rtol=rtol, atol=atol,
                                   err_msg=k)


@pytest.mark.parametrize("case", list(CASES))
def test_forward_matches_jax(both, case):
    """The logits (whole under seq, the rank's half of the batch under
    expert), the loss and the router loss."""
    ref, ports = both
    want = ref[case]
    for port in ports[case]:
        rows = want["logits"]
        if inner_of(case) == "expert":
            rows = np.split(rows, 2)[port["inner"]]
        np.testing.assert_allclose(port["logits"].numpy(), rows, rtol=2e-5, atol=2e-5)
        np.testing.assert_allclose(port["loss"], want["loss"], rtol=1e-5)
        if case != "seq":
            assert port["aux"] > 0.0
            np.testing.assert_allclose(port["aux"], want["aux"], rtol=1e-5)


@pytest.mark.parametrize("case", list(CASES))
def test_gradients_match_jax(both, case):
    """Every parameter's gradient after ``reduce_replicated_grads``: a
    block's summed over the inner group (but an expert's, whole through
    the all-to-all), the replicated parameters' over both groups."""
    ref, ports = both
    for port in ports[case]:
        check_grads(port, ref[case]["grads"], inner_of(case) == "expert", *TOLS[case])


def test_ample_capacity_is_the_dense_pipeline(both):
    """At capacity 8 no token drops, so pipe × expert's logits are the dense
    pipeline's on the same rows."""
    ref, ports = both
    for port in ports["expert"]:
        np.testing.assert_allclose(port["logits"].numpy(),
                                   np.split(ref["expert"]["dense"], 2)[port["inner"]],
                                   rtol=2e-5, atol=2e-5)


def test_a_rank_holds_its_stage_and_experts(both):
    """Stage ``r // 2`` and inner rank ``r % 2`` on rank r; under expert a
    rank holds 2 blocks of 2 experts each, under seq 2 whole blocks (4
    experts each where they have experts)."""
    _, ports = both
    for case, port in ports.items():
        assert [(p["stage"], p["inner"]) for p in port] == [(0, 0), (0, 1), (1, 0), (1, 1)]
        w_up = port[0]["grads"].get("blocks.1.moe.w_up")
        assert (w_up is None) == (case == "seq")
        if w_up is not None:
            assert tuple(w_up.shape) == ((4 if case == "seq_experts" else 2), 32, 128)
        assert "blocks.2.ln1.weight" not in port[0]["grads"]
