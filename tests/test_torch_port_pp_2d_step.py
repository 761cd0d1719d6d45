"""The port's pipelined Mercury step (``train/pp_step.py``) on meshes with two
model axes against the JAX package's ``make_pp_mercury_step`` on its
``("pipe", "seq")`` and ``("pipe", "expert")`` meshes, on the CPU.

JAX's step runs on 2 × 2 virtual CPU devices, its state made by
``create_pp_state`` from the model's twin without the second axis (its
init runs outside ``shard_map``); the port's on four gloo ranks of
``make_pp_mesh(2, 2, inner)`` (one spawn; the rank body is
``test_torch_port_ranks.pp_2d_rank``), from JAX's weights, stream
permutation and draws, read off its step as ``test_torch_port_pp_step.py``
reads them. The model and sizes are that file's (T=16, F=8, C=5, d_model
32, 2 heads, 4 blocks, M=2, 64 rows, batch 8, presample 2, SGD, telemetry
on, three steps): under seq with ring attention, under expert with 4
experts a block over 2 expert ranks at capacity 8 and ``moe_aux_weight``
10, where each rank scores half the pool and trains half the batch.

Tolerances, ``test_torch_port_pp_step.py``'s: step 1's loss rtol 1e-5,
three steps' losses rtol 5e-3, the parameters after step 1 rtol 1e-4 and
atol 1e-5; the pool loss, ESS, clip share and drift rtol 1e-5 (atol 1e-7),
the gradient's norm and the router loss rtol 1e-4. The selections are JAX's
draws exactly and equal on all four ranks; the accuracy JAX's exactly.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from mercury_tpu_torch.models.convert import expert_shard  # noqa: E402
from mercury_tpu_torch.parallel.distributed import spawn  # noqa: E402
from test_torch_port_pipeline import jax_model, port_kw  # noqa: E402
from test_torch_port_pp_2d import CASES, inner_of, jax_mesh_2d, twin, whole  # noqa: E402
from test_torch_port_pp_step import (  # noqa: E402
    B,
    LR,
    M,
    N,
    PRESAMPLE,
    STEPS,
    TELEMETRY,
    data,
    jax_steps,
)
from test_torch_port_ranks import pp_2d_rank  # noqa: E402

STEP_CASES = {"seq": (CASES["seq"], 0.01), "expert": (CASES["expert"], 10.0)}


@pytest.fixture(scope="module")
def both():
    x, y = data()
    ref, jobs = {}, []
    for case, (kw, weight) in STEP_CASES.items():
        ref[case] = jax_steps(jax_model(**kw), x, y, STEPS, aux_weight=weight,
                              mesh=jax_mesh_2d(inner_of(case)), init=jax_model(**twin(kw)))
        jobs.append(dict(kind="step", inner=inner_of(case), microbatches=M,
                         model=port_kw(**kw), stacked=ref[case]["stacked"],
                         rest=ref[case]["rest"], lr=LR, n=N, batch=B, presample=PRESAMPLE,
                         perm=ref[case]["perm"], uniforms=ref[case]["uniforms"],
                         aux_weight=weight, x=np.asarray(x), y=np.asarray(y)))
    ranks = spawn(pp_2d_rank, 4, "gloo", jobs)
    return ref, {case: [r["jobs"][i] for r in ranks] for i, case in enumerate(STEP_CASES)}


@pytest.mark.parametrize("case", list(STEP_CASES))
def test_step_matches_jax(both, case):
    """Each rank's losses, selections and accuracy at every step, and its
    parameters after step 1 (an expert leaf the rank's slice)."""
    ref, ports = both
    want = ref[case]
    jlosses = [m["train/loss"] for m in want["metrics"]]
    for port in ports[case]:
        losses = [float(m["train/loss"]) for m in port["metrics"]]
        np.testing.assert_allclose(losses[0], jlosses[0], rtol=1e-5)
        np.testing.assert_allclose(losses, jlosses, rtol=5e-3)
        for t, m in enumerate(port["metrics"]):
            np.testing.assert_array_equal(m["sampler/selected"].numpy(), want["selected"][t],
                                          err_msg=f"step {t}")
            assert float(m["train/acc"]) == want["metrics"][t]["train/acc"], t
        params = want["params"]
        if case == "expert":
            params = expert_shard(params, port["inner"], 2)
        got = {whole(k, port["stage"]): v for k, v in port["params"].items()}
        assert got.keys() <= params.keys()
        for k, v in got.items():
            np.testing.assert_allclose(v.numpy(), params[k].numpy(), rtol=1e-4, atol=1e-5,
                                       err_msg=k)


@pytest.mark.parametrize("case", list(STEP_CASES))
def test_telemetry_matches_jax(both, case):
    """JAX's metric keys, the sampler's health, the gradient's norm (each
    block and each expert once) and the router loss at every step."""
    ref, ports = both
    for port in ports[case]:
        for t, m in enumerate(port["metrics"]):
            want = ref[case]["metrics"][t]
            assert set(m) == set(want) | {"sampler/selected"}
            for key in TELEMETRY:
                np.testing.assert_allclose(float(m[key]), want[key], rtol=1e-5, atol=1e-7,
                                           err_msg=f"step {t} {key}")
            np.testing.assert_allclose(float(m["train/grad_norm"]), want["train/grad_norm"],
                                       rtol=1e-4)
            np.testing.assert_allclose(float(m["train/moe_aux"]), want["train/moe_aux"],
                                       rtol=1e-4)
            assert (case == "seq") == (float(m["train/moe_aux"]) == 0.0)
        np.testing.assert_allclose(port["ema"], ref[case]["ema"], rtol=1e-5)


@pytest.mark.parametrize("case", list(STEP_CASES))
def test_ranks_draw_alike(both, case):
    """All four ranks draw the same indices and report the same loss at
    every step, computed apart."""
    _, ports = both
    first = ports[case][0]
    for port in ports[case][1:]:
        for a, b in zip(first["metrics"], port["metrics"]):
            assert torch.equal(a["sampler/selected"], b["sampler/selected"])
            assert float(a["train/loss"]) == float(b["train/loss"])
