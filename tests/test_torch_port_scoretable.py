"""The port's score-table sampler against the JAX package's.

(a) ``mercury_tpu_torch.sampling.scoretable`` against
``mercury_tpu.sampling.scoretable`` on numpy inputs from a seed; (b) the
port's ``table_refresh_draw`` (its plain version, on the CPU) against
``table_refresh_draw_pallas`` in interpret mode, whose draw uses
``jax.random.uniform(key, (1, B))`` — the uniforms handed to the port.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from mercury_tpu.ops import table_refresh_draw_pallas  # noqa: E402
from mercury_tpu.sampling import scoretable as jst  # noqa: E402
from mercury_tpu_torch.models.convert import scoretable_from_jax  # noqa: E402
from mercury_tpu_torch.ops import launch_counts, table_refresh_draw  # noqa: E402
from mercury_tpu_torch.ops import mercury_kernels as mk  # noqa: E402
from mercury_tpu_torch.sampling import scoretable as tst  # noqa: E402

# A uniform within this distance of a CDF value may be drawn one index over:
# the port sums the CDF in another order than the TPU kernel's chunked
# matmul prefix (as for score_and_draw, see test_torch_port_ops).
BOUNDARY_BAND = 1e-6


def _table(n, seed):
    return np.random.default_rng(seed).uniform(0.1, 4.0, n).astype(np.float32)


class TestUnits:
    def test_init_and_period(self):
        j = jst.init_score_table(37)
        t = tst.init_score_table(37)
        np.testing.assert_array_equal(t.scores.numpy(), np.asarray(j.scores))
        assert t.cursor == int(j.cursor) == 0 and t.scores.dtype == torch.float32
        for n, r in [(10, 3), (5000, 64), (50000, 64), (7, 7)]:
            assert tst.refresh_period(n, r) == jst.refresh_period(n, r)

    @pytest.mark.parametrize("n,r", [(10, 3), (12, 4), (9, 2), (5000, 64)])
    def test_windows_and_cursor_follow_the_jax_sweep(self, n, r):
        j = jst.init_score_table(n)
        t = tst.init_score_table(n)
        for _ in range(jst.refresh_period(n, r) + 2):
            np.testing.assert_array_equal(tst.refresh_window(t, r).numpy(),
                                          np.asarray(jst.refresh_window(j, r)))
            j = jst.ScoreTableState(scores=j.scores, cursor=jst.advance_cursor(j, r))
            t = tst.ScoreTableState(t.scores, tst.advance_cursor(t, r))
            assert t.cursor == int(j.cursor)

    def test_decay_and_probs(self):
        scores = _table(333, 1)
        mu = np.float32(1.7)
        j = jst.decay_scores(jnp.asarray(scores), jnp.asarray(mu), 0.98)
        t = tst.decay_scores(torch.from_numpy(scores), torch.tensor(mu), 0.98)
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-7, atol=1e-7)
        np.testing.assert_allclose(
            tst.table_probs(t, torch.tensor(mu), 0.5).numpy(),
            np.asarray(jst.table_probs(j, jnp.asarray(mu), 0.5)), rtol=1e-6)

    def test_scatter_mean_averages_duplicates(self):
        scores = _table(50, 2)
        slots = np.array([3, 7, 3, 3, 49, 0, 7], np.int32)
        values = np.random.default_rng(3).uniform(0, 5, 7).astype(np.float32)
        j = np.asarray(jst.scatter_mean(jnp.asarray(scores), jnp.asarray(slots),
                                        jnp.asarray(values)))
        t = tst.scatter_mean(torch.from_numpy(scores), torch.from_numpy(slots),
                             torch.from_numpy(values)).numpy()
        np.testing.assert_allclose(t, j, rtol=1e-6)
        untouched = np.setdiff1d(np.arange(50), slots)
        np.testing.assert_array_equal(t[untouched], scores[untouched])
        np.testing.assert_allclose(t[3], values[[0, 2, 3]].mean(), rtol=1e-6)

    def test_inverse_cdf_draw_on_the_same_uniforms(self):
        probs = _table(200, 4)
        probs /= probs.sum()
        key = jax.random.key(5)
        j = np.asarray(jst.table_draw_inverse_cdf(key, jnp.asarray(probs), 64))
        u = np.array(jax.random.uniform(key, (64,)))
        t = tst.table_draw_inverse_cdf(torch.from_numpy(probs), torch.from_numpy(u))
        assert t.dtype == torch.int32
        np.testing.assert_array_equal(t.numpy(), j)

    def test_state_carries_across(self):
        j = jst.ScoreTableState(scores=jnp.asarray(_table(20, 6)),
                                cursor=jnp.asarray(12, jnp.int32))
        t = scoretable_from_jax(np.asarray(j.scores), np.asarray(j.cursor))
        np.testing.assert_array_equal(t.scores.numpy(), np.asarray(j.scores))
        assert t.cursor == 12 and isinstance(t.cursor, int)


def _refresh_draw_both(n, r, b, seed, dup=True, ema=1.3):
    rng = np.random.default_rng(seed)
    scores = _table(n, seed)
    slots = ((np.arange(r) * 3) % n).astype(np.int64)
    if dup:
        slots[1] = slots[0]
        slots[5] = slots[4] = slots[2]  # three hits on one slot
    rscores = rng.uniform(0.1, 4.0, r).astype(np.float32)
    key = jax.random.key(seed)
    pj = table_refresh_draw_pallas(key, jnp.asarray(scores), jnp.asarray(slots, jnp.int32),
                                   jnp.asarray(rscores), jnp.asarray(ema, jnp.float32), b,
                                   alpha=0.5, decay=0.98)
    u = np.array(jax.random.uniform(key, (1, b), jnp.float32))
    pt = table_refresh_draw(torch.from_numpy(scores), torch.from_numpy(slots),
                            torch.from_numpy(rscores), torch.tensor(ema),
                            torch.from_numpy(u), 0.5, 0.98)
    return [np.asarray(a) for a in pj], [a.numpy() for a in pt], u[0], slots, rscores


def _in_band(probs, u):
    cdf = np.cumsum(probs.astype(np.float64))
    return np.min(np.abs(cdf[None, :] - u[:, None].astype(np.float64)), axis=1) < BOUNDARY_BAND


class TestTableRefreshDraw:
    @pytest.mark.parametrize("n", [64, 320, 1250])
    def test_matches_pallas(self, n):
        """L = 1250 takes the TPU wrapper's pad path (to 1536 rows that
        are never drawn); the port uses the true L."""
        (tj, pj, sj, cj), (tt, pt, st, ct), u, slots, rscores = _refresh_draw_both(
            n, 16, 32, seed=n)
        assert tt.shape == pt.shape == tj.shape == (n,)
        np.testing.assert_allclose(tt, tj, atol=1e-6)
        np.testing.assert_allclose(pt, pj, atol=1e-6)
        np.testing.assert_allclose(tt[slots[2]], rscores[[2, 4, 5]].mean(), rtol=1e-6)
        band = _in_band(pt, u)
        assert band.sum() <= 1, f"{band.sum()} uniforms in the boundary band"
        np.testing.assert_array_equal(st[~band], sj[~band])
        assert st.dtype == np.int32 and ((st >= 0) & (st < n)).all()
        np.testing.assert_allclose(ct, pt[st] * n, rtol=1e-6)
        same = st == sj
        np.testing.assert_allclose(ct[same], cj[same], rtol=1e-5)

    def test_zero_decay_and_no_duplicates(self):
        """decay 0 puts every untouched slot at the EMA exactly."""
        scores = _table(64, 9)
        slots = torch.arange(8) * 5
        out, _, _, _ = table_refresh_draw(torch.from_numpy(scores), slots,
                                          torch.ones(8), torch.tensor(0.75),
                                          torch.rand(4), 0.5, 0.0)
        rest = np.setdiff1d(np.arange(64), slots.numpy())
        np.testing.assert_array_equal(out.numpy()[rest], np.float32(0.75))
        np.testing.assert_array_equal(out.numpy()[slots.numpy()], 1.0)

    def test_cpu_path_counts_no_launch_and_kernel_refuses_cpu(self):
        mk.reset_launch_counts()
        table_refresh_draw(torch.ones(16), torch.arange(4), torch.ones(4),
                           torch.tensor(1.0), torch.rand(1, 4))
        assert launch_counts["table_refresh_draw"] == 0
        with pytest.raises(ValueError, match="CUDA"):
            mk.table_refresh_draw_kernel(torch.ones(16), torch.arange(4), torch.ones(4),
                                         torch.tensor([1.0]), torch.rand(4), 0.5, 0.98)
