"""The port's pipelined Mercury step (``train/pp_step.py``) against the JAX
package's (``mercury_tpu/train/pp_step.py``), on the CPU.

JAX's ``make_pp_mercury_step`` runs on a pipe mesh of two virtual CPU
devices, the port's on two gloo ranks of ``make_tp_mesh(1, 2, "data",
"pipe")`` (one spawn a file; the rank body is
``test_torch_port_ranks.pipeline_rank``), with JAX's test model
(``tests/test_pp_mercury.py``: T=16, F=8, C=5, d_model 32, 2 heads, 4
blocks, two microbatches) on 64 rows, batch 8 and presample 2, under SGD,
telemetry on, for three steps. The port starts from JAX's weights
(``staged_from_flax``) and stream permutation, and is fed JAX's draws: the
JAX step draws by ``jax.random.categorical`` over its pool's ``p``, read off
the step through a wrapped ``draw_with_replacement``
(``jax.debug.callback``), given to the port as uniforms at the middle of
each drawn index's CDF interval.

Tolerances, the JAX package's for its staged steps
(``tests/test_pp_mercury.py``, ``tests/test_sequence_parallel.py``): step
1's loss rtol 1e-5, three steps' losses rtol 5e-3, the parameters after
step 1 rtol 1e-4 and atol 1e-5; the pool loss, ESS, clip share and drift
rtol 1e-5 (atol 1e-7), the gradient's norm rtol 1e-4. The selections are
the JAX draws exactly, and equal on the two stages; the accuracy is
JAX's exactly.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from mercury_tpu.sampling import importance as jimp  # noqa: E402
from mercury_tpu_torch.models.convert import params_from_flax  # noqa: E402
from mercury_tpu_torch.parallel import pipeline as tpp  # noqa: E402
from mercury_tpu_torch.parallel.distributed import spawn  # noqa: E402
from test_torch_port_config_step import _uniforms_for  # noqa: E402
from test_torch_port_pipeline import (  # noqa: E402
    F,
    T,
    C,
    jax_mesh,
    jax_model,
    np_tree,
    port_kw,
    whole,
)
from test_torch_port_ranks import pipeline_rank  # noqa: E402

N, B, PRESAMPLE, M, STEPS, LR, STAGES = 64, 8, 2, 2, 3, 0.05, 2
TELEMETRY = ("train/pool_loss", "sampler/ess", "sampler/clip_frac", "sampler/ema_drift")


def data():
    k1, k2 = jax.random.split(jax.random.key(40))
    return (jax.random.normal(k1, (N, T, F), jnp.float32),
            jax.random.randint(k2, (N,), 0, C))


def jax_steps(model, x, y, steps, aux_weight=0.01, mesh=None, init=None):
    """JAX's pipelined Mercury step (on ``mesh``, by default a pipe of
    STAGES, its state made by ``init``, by default ``model``): its initial
    stages and their numpy trees, stream and each step's draws as
    uniforms, its metrics and selections, the whole parameters after the
    first step (a port state dict) and the EMA."""
    import optax

    from mercury_tpu.train.pp_step import create_pp_state, make_pp_mercury_step

    tx = optax.sgd(LR)
    mesh = jax_mesh(STAGES) if mesh is None else mesh
    state = create_pp_state(jax.random.key(7), model if init is None else init, tx, x[:1],
                            shard_len=N, mesh=mesh)
    stacked, rest = np_tree(state.stacked), np_tree(state.rest)
    staged = [tpp.staged_from_flax(stacked, rest, i, STAGES) for i in range(STAGES)]
    step = make_pp_mercury_step(model, tx, mesh, batch_size=B, presample_batches=PRESAMPLE,
                                num_microbatches=M, moe_aux_weight=aux_weight,
                                telemetry=True)
    seen, original = [], jimp.draw_with_replacement

    def record(probs, drawn):
        seen.append((np.array(probs), np.array(drawn)))

    def spy(key, probs, n):
        drawn = original(key, probs, n)
        jax.debug.callback(record, probs, drawn)
        return drawn

    metrics, uniforms, selected, params = [], [], [], None
    perm = np.array(state.stream.perm)
    jimp.draw_with_replacement = spy
    try:
        for _ in range(steps):
            seen.clear()
            state, m = step(state, x, y)
            metrics.append({k: float(v) for k, v in m.items()})
            jax.effects_barrier()
            assert len(seen) == 1
            uniforms.append(_uniforms_for(*seen[0]))
            selected.append(seen[0][1])
            if params is None:
                params = params_from_flax(tpp.unstack_block_params(
                    np_tree(state.stacked), np_tree(state.rest)), {})
    finally:
        jimp.draw_with_replacement = original
    return dict(staged=staged, stacked=stacked, rest=rest, perm=perm, uniforms=uniforms,
                metrics=metrics, selected=selected, params=params, ema=float(state.ema.value))


def step_job(ref, x, y, aux_weight=0.01, **model):
    return dict(kind="step", stages=STAGES, microbatches=M, model=port_kw(**model),
                staged=ref["staged"], lr=LR, n=N, batch=B, presample=PRESAMPLE,
                perm=ref["perm"], uniforms=ref["uniforms"], aux_weight=aux_weight,
                x=np.asarray(x), y=np.asarray(y))


def check_step(ports, want, steps_rtol=5e-3):
    """Each rank's metrics, selections and (both stages together) the
    parameters after step 1 against JAX's step."""
    for port in ports:
        losses = [float(m["train/loss"]) for m in port["metrics"]]
        jlosses = [m["train/loss"] for m in want["metrics"]]
        np.testing.assert_allclose(losses[0], jlosses[0], rtol=1e-5)
        np.testing.assert_allclose(losses, jlosses, rtol=steps_rtol)
        for t, m in enumerate(port["metrics"]):
            np.testing.assert_array_equal(m["sampler/selected"].numpy(), want["selected"][t],
                                          err_msg=f"step {t}")
            assert float(m["train/acc"]) == want["metrics"][t]["train/acc"], t
    got = {whole(k, p["stage"], STAGES): v for p in ports for k, v in p["params"].items()}
    assert got.keys() == want["params"].keys()
    for k, w in want["params"].items():
        np.testing.assert_allclose(got[k].numpy(), w.numpy(), rtol=1e-4, atol=1e-5, err_msg=k)


@pytest.fixture(scope="module")
def both():
    x, y = data()
    ref = jax_steps(jax_model(), x, y, STEPS)
    ranks = spawn(pipeline_rank, STAGES, "gloo", [step_job(ref, x, y)], (STAGES,))
    return ref, [r["jobs"][0] for r in ranks]


def test_step_matches_jax(both):
    ref, ports = both
    check_step(ports, ref)
    assert [p["stage"] for p in ports] == [0, 1]


def test_telemetry_matches_jax(both):
    """JAX's metric keys, and the sampler's health and the gradient's norm
    (each block once, the replicated leaves once) at every step."""
    ref, ports = both
    for port in ports:
        for t, m in enumerate(port["metrics"]):
            assert set(m) == set(ref["metrics"][t]) | {"sampler/selected"}
            for key in TELEMETRY:
                np.testing.assert_allclose(float(m[key]), ref["metrics"][t][key], rtol=1e-5,
                                           atol=1e-7, err_msg=f"step {t} {key}")
            np.testing.assert_allclose(float(m["train/grad_norm"]),
                                       ref["metrics"][t]["train/grad_norm"], rtol=1e-4)
            assert float(m["train/moe_aux"]) == 0.0
        np.testing.assert_allclose(port["ema"], ref["ema"], rtol=1e-5)


def test_stages_draw_alike(both):
    """Both stages draw the same indices and train on the same loss at
    every step, computed apart."""
    _, (a, b) = both
    for ma, mb in zip(a["metrics"], b["metrics"]):
        assert torch.equal(ma["sampler/selected"], mb["sampler/selected"])
        assert float(ma["train/loss"]) == float(mb["train/loss"])
