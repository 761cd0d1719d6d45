"""The port's kernel functions against the JAX package's Pallas kernels.

On the CPU the port's wrappers run their plain versions
(``mercury_tpu_torch/ops/reference.py``) and the Pallas kernels run in
interpret mode, as ``tests/test_ops.py`` runs them. Inputs come from numpy
and go through both packages; the uniforms of the draw come from
``jax.random.uniform(key, (1, B))``, as the TPU kernel's wrapper draws them.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from mercury_tpu.ops import per_sample_nll_pallas, score_and_draw_pallas  # noqa: E402
from mercury_tpu_torch.ops import mercury_kernels as mk  # noqa: E402
from mercury_tpu_torch.ops import per_sample_nll, score_and_draw  # noqa: E402

# A uniform within this distance of a CDF value may be drawn one index over:
# the port sums the CDF in another order than the TPU kernel's chunked
# matmul prefix (float32 rounding, ~1e-7 relative at these pool sizes).
BOUNDARY_BAND = 1e-6


def _logits(shape, seed, scale=3.0):
    rng = np.random.default_rng(seed)
    z = rng.normal(0, scale, shape).astype(np.float32)
    y = rng.integers(0, shape[1], shape[0]).astype(np.int32)
    return z, y


def _jax_logits(z, dtype):
    return jnp.asarray(z).astype(dtype)


class TestNLLForward:
    @pytest.mark.parametrize("shape", [(320, 10), (32, 100)])
    def test_matches_pallas_f32(self, shape):
        z, y = _logits(shape, 0)
        ref = np.asarray(per_sample_nll_pallas(jnp.asarray(z), jnp.asarray(y)))
        ours = per_sample_nll(torch.from_numpy(z), torch.from_numpy(y)).numpy()
        np.testing.assert_allclose(ours, ref, rtol=1e-5, atol=1e-6)

    def test_matches_pallas_bf16_input(self):
        # The same bf16 values on both sides; both kernels compute in f32.
        z, y = _logits((320, 10), 1)
        zb = _jax_logits(z, jnp.bfloat16)
        ref = np.asarray(per_sample_nll_pallas(zb, jnp.asarray(y)))
        zt = torch.tensor(np.asarray(zb.astype(jnp.float32))).to(torch.bfloat16)
        ours = per_sample_nll(zt, torch.from_numpy(y)).numpy()
        np.testing.assert_allclose(ours, ref, rtol=1e-5, atol=1e-6)

    def test_out_of_range_label_picks_nothing(self):
        """A bad label selects no column (the loss is the logsumexp), as
        the TPU kernel's one-hot compare does; it is never an address."""
        z, y = _logits((8, 10), 2)
        y[3] = 10
        y[5] = -1
        ref = np.asarray(per_sample_nll_pallas(jnp.asarray(z), jnp.asarray(y)))
        ours = per_sample_nll(torch.from_numpy(z), torch.from_numpy(y)).numpy()
        np.testing.assert_allclose(ours, ref, rtol=1e-5, atol=1e-6)


class TestNLLBackward:
    @pytest.mark.parametrize("shape", [(32, 10), (64, 100)])
    def test_matches_pallas_vjp(self, shape):
        z, y = _logits(shape, 3)
        g = np.random.default_rng(4).uniform(0.1, 2.0, shape[0]).astype(np.float32)
        _, vjp = jax.vjp(lambda lg: per_sample_nll_pallas(lg, jnp.asarray(y)),
                         jnp.asarray(z))
        ref = np.asarray(vjp(jnp.asarray(g))[0])
        zt = torch.from_numpy(z).requires_grad_()
        per_sample_nll(zt, torch.from_numpy(y)).backward(torch.from_numpy(g))
        np.testing.assert_allclose(zt.grad.numpy(), ref, atol=1e-6)

    def test_bf16_grad_in_logits_dtype(self):
        """The gradient comes back in the logits' dtype (``_vjp_bwd``'s
        final cast); one bf16 rounding of values that agree in f32 to ~1e-7
        can differ by one bf16 ulp (2^-8 relative)."""
        z, y = _logits((32, 10), 5)
        g = np.full(32, 1.0 / 32, np.float32)
        zb = _jax_logits(z, jnp.bfloat16)
        _, vjp = jax.vjp(lambda lg: per_sample_nll_pallas(lg, jnp.asarray(y)), zb)
        ref = np.asarray(vjp(jnp.asarray(g))[0].astype(jnp.float32))
        zt = torch.tensor(np.asarray(zb.astype(jnp.float32))).to(torch.bfloat16)
        zt.requires_grad_()
        per_sample_nll(zt, torch.from_numpy(y)).backward(torch.from_numpy(g))
        assert zt.grad.dtype == torch.bfloat16
        np.testing.assert_allclose(zt.grad.float().numpy(), ref,
                                   rtol=2 ** -8, atol=1e-6)

    def test_mean_gradient_view_is_accepted(self):
        """The gradient of a mean arrives as a broadcast view; the backward
        makes it contiguous before it reaches the kernel."""
        z, y = _logits((16, 10), 6)
        zt = torch.from_numpy(z).requires_grad_()
        per_sample_nll(zt, torch.from_numpy(y)).mean().backward()
        expect = torch.softmax(torch.from_numpy(z), 1)
        expect[torch.arange(16), torch.from_numpy(y).long()] -= 1.0
        np.testing.assert_allclose(zt.grad.numpy(), expect.numpy() / 16, atol=1e-7)


def _draw_both(n, b, seed, ema=0.8, alpha=0.5, losses=None):
    if losses is None:
        losses = np.random.default_rng(seed).exponential(1.0, n).astype(np.float32)
    key = jax.random.key(seed)
    probs_j, sel_j, scaled_j = score_and_draw_pallas(
        key, jnp.asarray(losses), jnp.asarray(ema, jnp.float32), b, alpha=alpha)
    u = np.asarray(jax.random.uniform(key, (1, b), jnp.float32))
    probs_t, sel_t, scaled_t = score_and_draw(
        torch.from_numpy(losses), torch.tensor(ema), torch.from_numpy(u), alpha)
    return (np.asarray(probs_j), np.asarray(sel_j), np.asarray(scaled_j),
            probs_t.numpy(), sel_t.numpy(), scaled_t.numpy(), u[0])


def _in_band(probs, u):
    cdf = np.cumsum(probs.astype(np.float64))
    return np.min(np.abs(cdf[None, :] - u[:, None].astype(np.float64)), axis=1) < BOUNDARY_BAND


class TestScoreAndDraw:
    @pytest.mark.parametrize("n", [320, 1000, 4096])
    def test_matches_pallas(self, n):
        pj, sj, cj, pt, st, ct, u = _draw_both(n, 32, seed=n)
        np.testing.assert_allclose(pt, pj, rtol=1e-6)
        band = _in_band(pt, u)
        assert band.sum() <= 1, f"{band.sum()} uniforms in the boundary band"
        np.testing.assert_array_equal(st[~band], sj[~band])
        same = st == sj
        np.testing.assert_allclose(ct[same], cj[same], rtol=1e-6)
        assert st.dtype == np.int32 and ((st >= 0) & (st < n)).all()

    def test_extreme_skew_clamps_index(self):
        """All mass on the first candidate, u close to 1: the count of cdf
        values ≤ u can reach N, and the clamp keeps it at N−1
        (``tests/test_ops.py:107``)."""
        losses = np.asarray([100.0] + [0.0] * 15, np.float32)
        for s in range(20):
            pj, sj, cj, pt, st, ct, u = _draw_both(16, 8, s, ema=0.0, alpha=0.0,
                                                   losses=losses)
            assert st.min() >= 0 and st.max() < 16
            band = _in_band(pt, u)
            np.testing.assert_array_equal(st[~band], sj[~band])
        _, sel, _ = score_and_draw(torch.from_numpy(losses), torch.tensor(0.0),
                                   torch.tensor([0.0, 0.5, 1.0 - 2 ** -24, 1.0]), 0.0)
        assert sel.tolist() == [0, 0, 0, 15]

    def test_padded_pool_semantics(self):
        """The TPU wrapper pads an awkward large pool (N=2500 → 2560) with
        rows that can never be drawn; the port uses the true N and must give
        the same probabilities and draws, none past N."""
        pj, sj, cj, pt, st, ct, u = _draw_both(2500, 64, seed=11)
        assert pj.shape == pt.shape == (2500,)
        np.testing.assert_allclose(pt, pj, rtol=1e-6)
        band = _in_band(pt, u)
        np.testing.assert_array_equal(st[~band], sj[~band])
        assert st.max() < 2500 and sj.max() < 2500
        np.testing.assert_allclose(ct, pt[st] * 2500, rtol=1e-6)


class TestDispatch:
    def test_cpu_path_counts_no_launch(self):
        mk.reset_launch_counts()
        z, y = _logits((8, 10), 7)
        per_sample_nll(torch.from_numpy(z), torch.from_numpy(y))
        score_and_draw(torch.rand(8), torch.tensor(0.5), torch.rand(1, 4))
        assert mk.launch_counts == {k: 0 for k in mk.KERNELS}
        assert mk.KERNELS == ("nll_fwd", "nll_bwd", "score_and_draw",
                              "table_refresh_draw", "augment_normalize")

    def test_ctypes_signatures_match_the_c_entry_points(self):
        """Each ``extern "C"`` entry point of the CUDA source takes the
        arguments ``_build.SIGNATURES`` declares for ctypes: a pointer where
        ctypes passes c_void_p, an int where c_int, a float where c_float.
        (nvcc runs only on the card; a mismatch here would pass garbage.)"""
        import ctypes
        import re

        from mercury_tpu_torch.ops import _build

        text = "".join(p.read_text() for p in _build.sources())
        decls = dict(re.findall(r"^int (mercury_\w+)\(([^)]*)\)", text, re.M))
        assert set(decls) == set(_build.SIGNATURES)
        kind = {ctypes.c_void_p: "*", ctypes.c_int: "int", ctypes.c_float: "float"}
        for name, argtypes in _build.SIGNATURES.items():
            params = [" ".join(a.split()) for a in decls[name].split(",")]
            assert len(params) == len(argtypes), name
            for param, t in zip(params, argtypes):
                want = kind[t]
                assert (want in param) if want == "*" else param.startswith(want + " "), \
                    f"{name}: {param!r} is not passed as {t.__name__}"

    def test_kernel_entry_points_refuse_cpu_tensors(self):
        z, y = _logits((8, 10), 8)
        with pytest.raises(ValueError, match="CUDA"):
            mk.nll_fwd_kernel(torch.from_numpy(z), torch.from_numpy(y))
        with pytest.raises(ValueError, match="CUDA"):
            mk.score_and_draw_kernel(torch.rand(8), torch.tensor([0.5]),
                                     torch.rand(4), 0.5)
