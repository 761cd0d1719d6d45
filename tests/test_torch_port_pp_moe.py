"""The port's pipeline with the Switch experts on the dense path against
the JAX package's, on the CPU, as ``test_torch_port_pipeline.py`` and
``test_torch_port_pp_step.py`` hold the dense model (their helpers, model,
meshes, draws and tolerances), with two experts a block at capacity factor
8 (JAX's ``tests/test_pp_mercury.py``); one spawn of two gloo ranks.

A block's capacity is set by the tokens of its call, here a microbatch, so
the pipelined forward is not the unstaged one: the port is held to JAX's
``make_pp_apply(with_aux=True)`` at the same S and M, never to
``forward``. Cases: at S=2, M=2 the logits, the router loss (rtol 1e-5)
and every gradient of the mean NLL plus 10 × the router loss against JAX's
``value_and_grad``; one Mercury step at ``moe_aux_weight`` 0 and at 10
against JAX's (the loss and ``train/moe_aux`` rtol 1e-4, as
``tests/test_pp_mercury.py``; the parameters after it rtol 1e-4 and atol
1e-5; the selections JAX's), the weight changing the update.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from mercury_tpu_torch.parallel.distributed import spawn  # noqa: E402
from test_torch_port_pipeline import (  # noqa: E402
    _data,
    check_grads,
    jax_apply,
    jax_model,
    np_tree,
    port_kw,
    staged,
)
from test_torch_port_pp_step import check_step, data, jax_steps, step_job  # noqa: E402
from test_torch_port_ranks import pipeline_rank  # noqa: E402

MOE = dict(moe_experts=2, moe_capacity_factor=8.0)
AUX_WEIGHTS = (0.0, 10.0)
STEPS = 1


@pytest.fixture(scope="module")
def both():
    x, y = _data()
    model = jax_model(**MOE)
    params = np_tree(model.init(jax.random.key(6), x, train=False)["params"])
    ref = {"apply": jax_apply(model, params, x, y, 2, 2, aux_weight=10.0)}
    jobs = [dict(kind="apply", stages=2, microbatches=2, model=port_kw(**MOE),
                 staged=staged(params, 2), x=np.asarray(x), y=np.asarray(y), with_aux=True,
                 aux_weight=10.0)]
    xs, ys = data()
    for w in AUX_WEIGHTS:
        ref[w] = jax_steps(model, xs, ys, STEPS, aux_weight=w)
        jobs.append(step_job(ref[w], xs, ys, aux_weight=w, **MOE))
    ranks = spawn(pipeline_rank, 2, "gloo", jobs, (2,))
    ports = [[r["jobs"][i] for r in ranks] for i in range(len(jobs))]
    return ref, dict(zip(["apply", *AUX_WEIGHTS], ports))


def test_router_loss_through_the_schedule_matches_jax(both):
    """The router loss summed over the valid ticks of each stage, summed
    over the stages and divided by M, and the gradients it sends back."""
    ref, ports = both
    want = ref["apply"]
    for port in ports["apply"]:
        assert port["aux"] > 0.0
        np.testing.assert_allclose(port["aux"], want["aux"], rtol=1e-5)
        np.testing.assert_allclose(port["logits"].numpy(), want["logits"], rtol=2e-5,
                                   atol=2e-5)
        np.testing.assert_allclose(port["loss"], want["loss"], rtol=1e-5)
        check_grads(port["grads"], port["stage"], 2, want["grads"], 1e-3, 1e-5)


@pytest.mark.parametrize("weight", AUX_WEIGHTS)
def test_step_with_experts_matches_jax(both, weight):
    ref, ports = both
    check_step(ports[weight], ref[weight], steps_rtol=1e-4)
    for port in ports[weight]:
        np.testing.assert_allclose([float(m["train/moe_aux"]) for m in port["metrics"]],
                                   [m["train/moe_aux"] for m in ref[weight]["metrics"]],
                                   rtol=1e-4)


def test_aux_weight_changes_the_update(both):
    """``moe_aux_weight`` enters the objective: the parameters after step
    1 at 0 and 10 differ (JAX's ``test_moe_aux_live_in_objective``)."""
    _, ports = both
    off, on = (torch.cat([v.reshape(-1) for v in ports[w][0]["params"].values()])
               for w in AUX_WEIGHTS)
    assert not torch.allclose(off, on)
