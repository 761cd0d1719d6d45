"""The port's sequence-parallel attentions (``parallel/sequence.py``)
against the JAX package's, on the CPU: the JAX functions under
``shard_map`` on four virtual CPU devices, the port's on four gloo ranks
(one spawn; the rank body is ``test_torch_port_ranks.sp_attention_rank``),
from the same numpy inputs.

Cases: ring, zigzag (on the ``zigzag_order`` layout) and Ulysses, causal
and not, each the output and the gradients of ``sum(out · cotangent)``
with respect to q, k and v; the ring in bfloat16. Tolerances are the JAX
package's own for its attentions against dense attention
(``tests/test_sequence_parallel.py``): rtol and atol 2e-5 for the output,
5e-5 for the gradients, 0.1 in bfloat16. Then the layout's round trip and
the port's form of ``test_never_materializes_full_score_matrix``: no
tensor autograd saves in a ring forward at L=1024 over four ranks has an
axis of the global length.
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import Mesh, PartitionSpec as P  # noqa: E402

from mercury_tpu.compat import shard_map  # noqa: E402
from mercury_tpu.parallel import sequence as jseq  # noqa: E402
from mercury_tpu_torch.parallel import sequence as tseq  # noqa: E402
from mercury_tpu_torch.parallel.distributed import spawn  # noqa: E402
from test_torch_port_ranks import sp_attention_rank  # noqa: E402

W = 4
B, L, H, D = 2, 64, 4, 8
LONG = 1024
CASES = [(impl, causal) for impl in ("ring", "zigzag", "ulysses") for causal in (False, True)]
BF16 = ("ring", False, "bfloat16")


def _inputs(seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((B, L, H, D)).astype(np.float32) for _ in range(4)]


def _jax_case(impl, causal, q, k, v, ct, dtype=jnp.float32):
    """The JAX attention ``impl`` under shard_map on W devices: the output
    and the gradients of ``sum(out · ct)``."""
    mesh = Mesh(np.array(jax.devices()[:W]), ("seq",))
    fn = jax.jit(shard_map(
        functools.partial(jseq.attention, causal=causal, sp_axis="seq", sp_impl=impl),
        mesh=mesh, in_specs=(P(None, "seq"),) * 3, out_specs=P(None, "seq")))
    args = [jnp.asarray(a, dtype) for a in (q, k, v)]

    def loss(q, k, v):
        return jnp.sum(fn(q, k, v).astype(jnp.float32) * jnp.asarray(ct))

    out = np.asarray(fn(*args).astype(jnp.float32))
    grads = [np.asarray(g.astype(jnp.float32))
             for g in jax.grad(loss, argnums=(0, 1, 2))(*args)]
    return out, grads


@pytest.fixture(scope="module")
def both():
    perm = jseq.zigzag_order(L, W)
    cases, ref, port_cases = [], [], []
    for i, (impl, causal, *dtype) in enumerate(CASES + [BF16]):
        q, k, v, ct = _inputs(i)
        if impl == "zigzag":
            q, k, v, ct = (a[:, perm] for a in (q, k, v, ct))
        bf16 = bool(dtype)
        ref.append(_jax_case(impl, causal, q, k, v, ct, jnp.bfloat16 if bf16 else jnp.float32))
        cases.append((impl, causal, bf16))
        arrays = [torch.tensor(a) for a in (q, k, v)]
        if bf16:
            arrays = [a.to(torch.bfloat16) for a in arrays]
        port_cases.append((impl, causal, *arrays, torch.tensor(ct)))
    ranks = spawn(sp_attention_rank, W, "gloo", port_cases, LONG)
    return cases, ref, ranks


def _gathered(ranks, i, what):
    if what == "out":
        parts = [r["cases"][i]["out"] for r in ranks]
    else:
        parts = [r["cases"][i]["grads"][what] for r in ranks]
    return torch.cat(parts, dim=1).float().numpy()


@pytest.mark.parametrize("i", range(len(CASES)),
                         ids=[f"{impl}-{'causal' if c else 'full'}" for impl, c in CASES])
def test_attention_and_gradients_match_jax(both, i):
    cases, ref, ranks = both
    out, grads = ref[i]
    np.testing.assert_allclose(_gathered(ranks, i, "out"), out, rtol=2e-5, atol=2e-5)
    for j, name in enumerate("qkv"):
        np.testing.assert_allclose(_gathered(ranks, i, j), grads[j], rtol=5e-5, atol=5e-5,
                                   err_msg=f"d{name}")


def test_bfloat16_ring_within_jax_bound(both):
    """bf16 q/k/v: the output in bf16, within JAX's bf16 bound (0.1) of
    JAX's bf16 ring, and its gradients too."""
    cases, ref, ranks = both
    i = len(CASES)
    assert all(r["cases"][i]["out"].dtype == torch.bfloat16 for r in ranks)
    out, grads = ref[i]
    np.testing.assert_allclose(_gathered(ranks, i, "out"), out, rtol=0.1, atol=0.1)
    for j in range(3):
        np.testing.assert_allclose(_gathered(ranks, i, j), grads[j], rtol=0.1, atol=0.1)


def test_no_saved_tensor_has_the_global_length(both):
    """The ring at L=1024 over four ranks saves blocks of L/4 = 256 along
    the sequence (scores ``[1, 1, 256, 256]``), never a tensor with an
    axis of 1024: no global ``[L, L]`` scores, no gathered K/V."""
    _, _, ranks = both
    for r in ranks:
        assert r["saved"], "the ring saved nothing for its backward"
        assert any(s[-2:] == (LONG // W, LONG // W) for s in r["saved"]), r["saved"]
        assert all(LONG not in s for s in r["saved"]), r["saved"]


def test_zigzag_order_round_trip_is_jax_s():
    for length, w in ((32, 4), (64, 2), (12, 3)):
        perm = tseq.zigzag_order(length, w)
        np.testing.assert_array_equal(perm, jseq.zigzag_order(length, w))
        inv = tseq.zigzag_inverse(length, w)
        np.testing.assert_array_equal(inv, jseq.zigzag_inverse(length, w))
        x = np.arange(length)
        np.testing.assert_array_equal(x[perm][inv], x)
    # Shard 0 of the permuted array: chunks 0 and 7.
    np.testing.assert_array_equal(tseq.zigzag_order(32, 4)[:8],
                                  np.concatenate([np.arange(0, 4), np.arange(28, 32)]))
