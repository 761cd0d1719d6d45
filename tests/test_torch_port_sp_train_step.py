"""The port's data × seq steps (``train/sp_step.py``) against the JAX
package's, on the CPU, as ``test_torch_port_sp_step.py`` holds them (its
helpers, mesh, model, draws and tolerances): one Mercury step of an MoE
model (one block, two experts) at ``moe_aux_weight`` 0 and 10, and one
``make_dp_sp_train_step`` step of each ``sp_impl`` (zigzag causal) on the
first four rows.
"""

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from test_torch_port_sp_step import TRAIN, _check_params, run_both  # noqa: E402


@pytest.fixture(scope="module")
def both():
    return run_both(("moe0", "moe10"), tuple(TRAIN))


def test_moe_aux_joins_the_objective(both):
    """One step of the MoE model at aux weight 0 and 10, each held to
    JAX's; the weight changes the update (JAX's
    ``test_moe_aux_joins_objective``)."""
    ref, ports, _ = both
    for name in ("moe0", "moe10"):
        want = ref[f"mercury/{name}"]
        for port in ports[f"mercury/{name}"]:
            np.testing.assert_allclose(float(port["metrics"][0]["train/loss"]),
                                       want["metrics"][0]["train/loss"], rtol=1e-5)
            _check_params(port["params"], want["params"])
    off, on = (torch.cat([v.reshape(-1) for v in ports[f"mercury/{n}"][0]["params"].values()])
               for n in ("moe0", "moe10"))
    assert not torch.allclose(off, on)


@pytest.mark.parametrize("name", list(TRAIN))
def test_train_step_matches_jax(both, name):
    ref, ports, _ = both
    want = ref[f"train/{name}"]
    for port in ports[f"train/{name}"]:
        np.testing.assert_allclose(float(port["metrics"][0]["train/loss"]), want["loss"],
                                   rtol=1e-5)
        _check_params(port["params"], want["params"])
