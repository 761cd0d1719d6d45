"""The launch geometry and the two-level draw of the port's selection kernels.

``score_and_draw`` and ``table_refresh_draw`` run on the card as one
thread-block cluster (``select_kernel`` in
``mercury_tpu_torch/ops/csrc/mercury_kernels.cu``), with the geometry of
``draw_geometry``. The kernel cannot run here, so these tests check what
surrounds it: the split of ``[0, n)`` into block ranges and thread runs, a
numpy model of its draw over that split (block starts from the rank-ordered
block sums, owner block, owner thread, the walk over the thread's run, the
clamp) against
``score_and_draw_pallas`` in interpret mode and the port's plain version,
and the division step the kernel uses for ``p = s / Σs``.
"""

from fractions import Fraction

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from mercury_tpu.ops import score_and_draw_pallas  # noqa: E402
from mercury_tpu_torch.ops import mercury_kernels as mk  # noqa: E402
from mercury_tpu_torch.ops import reference  # noqa: E402

# A uniform within this distance of a CDF value may be drawn one index over:
# the kernel, the TPU kernel and the plain version sum in different orders.
BOUNDARY_BAND = 1e-6
SIZES = [1, 31, 320, 1024, 4097, 5000, 50_000, 50_001, 262_145, 1_000_000]


def _owners(n, geo):
    """How many (block, run) pairs own each index of [0, n). Thread t takes
    runs t, t + threads, ..., so a block has tiles·threads runs."""
    k, t = np.meshgrid(np.arange(geo.clusters), np.arange(geo.tiles * geo.threads),
                       indexing="ij")
    blo = k * geo.per_block
    bhi = np.minimum(blo + geo.per_block, n)
    lo = blo + t * geo.run
    hi = np.minimum(lo + geo.run, bhi)
    lo, hi = lo[hi > lo], hi[hi > lo]
    diff = np.zeros(n + 1, np.int64)
    np.add.at(diff, lo, 1)
    np.add.at(diff, hi, -1)
    return np.cumsum(diff)[:n]


class TestGeometry:
    @pytest.mark.parametrize("max_cluster", [16, 8, 1])
    @pytest.mark.parametrize("n", SIZES)
    def test_every_index_has_one_owner(self, n, max_cluster):
        geo = mk.draw_geometry(n, max_cluster=max_cluster)
        np.testing.assert_array_equal(_owners(n, geo), np.ones(n, np.int64))
        # No block is empty: the last one owns n - 1 and draws the clamp.
        assert (geo.clusters - 1) * geo.per_block < n <= geo.clusters * geo.per_block

    @pytest.mark.parametrize("n", SIZES)
    def test_limits_of_the_card(self, n):
        for refresh in (None, 64):
            geo = mk.draw_geometry(n, refresh)
            assert geo.clusters in (1, 2, 4, 8, 16)
            # 16 is the non-portable size; a card that schedules at most 8
            # (mercury_cluster_limit) gets at most 8.
            assert geo.clusters <= mk.MAX_CLUSTER == 16
            assert mk.draw_geometry(n, refresh, max_cluster=8).clusters <= 8
            assert geo.smem <= 232_448
            assert geo.threads % 32 == 0 and 32 <= geo.threads <= 1024
            assert geo.per_block % 4 == 0
            assert geo.tiles * geo.threads * geo.run >= geo.per_block
            assert geo.tiles * geo.threads <= mk.MAX_RUNS + 1024
            assert geo.run == 8 or geo.run % 4 == 0

    @pytest.mark.parametrize("n", SIZES)
    def test_small_arrays_take_one_block_large_ones_a_cluster(self, n):
        geo = mk.draw_geometry(n)
        if n <= 4096:
            assert geo.clusters == 1
        if n >= 50_000:
            assert geo.clusters > 1
        assert geo.in_registers == (n <= 262_144)
        # Past registers: runs of 8 in tiles, so a warp's loads stay dense.
        assert geo.in_registers or geo.run == 8

    @pytest.mark.parametrize("n", [2 ** 24, 2 ** 31 - 1])
    def test_any_n_fits(self, n):
        """Beyond 32,768 runs of 8 a block, runs grow instead, so the
        prefixes still fit in shared memory."""
        for refresh in (None, 64):
            geo = mk.draw_geometry(n, refresh)
            assert geo.smem <= 232_448 and geo.clusters == 16
            assert geo.tiles * geo.threads * geo.run >= geo.per_block
            assert (geo.clusters - 1) * geo.per_block < n <= geo.clusters * geo.per_block

    def test_shared_memory_grows_with_the_refresh_window(self):
        assert mk.draw_geometry(5000, 64).smem - mk.draw_geometry(5000).smem == 8 * 64
        with pytest.raises(ValueError, match="shared memory"):
            mk.draw_geometry(5000, refresh=30_000)
        with pytest.raises(ValueError, match="n >= 1"):
            mk.draw_geometry(0)


def scores_of(losses, ema, alpha):
    """``max(loss + RN(α·ema), 1e-12)`` in float32, as the kernel smooths."""
    a = np.float32(np.float32(alpha) * np.float32(ema))
    return np.maximum(losses.astype(np.float32) + a, np.float32(1e-12))


def two_level_draw(scores, u, geo):
    """numpy model of the kernel's draw, in float32. Block sums S_k of the
    scores, Σs their sum in rank order, p = s/Σs; block k's cdf starts at
    off_k = RN(P_{k−1}/Σs), P the rank-ordered prefix of the S_k, and goes
    on by the block's inclusive prefix of its threads' masses. The owner
    block is the number of block starts off_1..off_{K−1} ≤ u; in the last
    block a u at or past its end clamps to n − 1. The owner thread is the
    first with off + prefix > u (at most the last), and the index in its
    run the number of its running sums ≤ u, at most the run's last."""
    n = scores.shape[0]
    f32 = np.float32
    k, t, r = geo.clusters, geo.tiles * geo.threads, geo.run
    runs = np.zeros((k, t * r), f32)
    for b in range(k):
        seg = scores[b * geo.per_block:min((b + 1) * geo.per_block, n)]
        runs[b, :seg.size] = seg
    runs = runs.reshape(k, t, r)
    sums = runs.sum(axis=(1, 2), dtype=f32)
    prefix = np.cumsum(sums, dtype=f32)
    total = prefix[-1]
    starts = np.concatenate([[f32(0)], prefix[:-1] / total]).astype(f32)
    runs = runs / total  # p, and 0 past n
    incl = np.cumsum(runs.sum(axis=2, dtype=f32), axis=1, dtype=f32)
    out = np.empty(u.shape[0], np.int64)
    for i, ui in enumerate(u.astype(f32)):
        b = int((starts[1:] <= ui).sum())
        off = starts[b]
        blo, bhi = b * geo.per_block, min((b + 1) * geo.per_block, n)
        if b == k - 1 and ui >= f32(off + incl[b, -1]):
            out[i] = n - 1
            continue
        th = min(int(((off + incl[b]).astype(f32) <= ui).sum()), t - 1)
        c = f32(off + incl[b, th - 1]) if th > 0 else off
        lo = blo + th * r
        cnt = max(0, min(r, bhi - lo))
        below = 0
        for p in runs[b, th, :cnt]:
            c = f32(c + p)
            below += int(c <= ui)
        out[i] = max(min(lo + min(below, cnt - 1), bhi - 1), blo)
    return out


def _in_band(probs, u):
    """Which u lie within the band of a CDF value (the nearest is found by
    search, so a million-long CDF needs no [B, n] matrix)."""
    cdf = np.cumsum(probs.astype(np.float64))
    u = u.astype(np.float64)
    pos = np.clip(np.searchsorted(cdf, u), 1, cdf.size - 1) if cdf.size > 1 else np.zeros(u.size, int)
    near = np.minimum(np.abs(cdf[pos] - u), np.abs(cdf[np.maximum(pos - 1, 0)] - u))
    return near < BOUNDARY_BAND


def _pallas_draws(losses, ema, b, seed, alpha=0.5):
    key = jax.random.key(seed)
    probs, sel, _ = score_and_draw_pallas(key, jnp.asarray(losses),
                                          jnp.asarray(ema, jnp.float32), b, alpha=alpha)
    u = np.asarray(jax.random.uniform(key, (1, b), jnp.float32))[0]
    return np.asarray(probs), np.asarray(sel), u


class TestTwoLevelDraw:
    @pytest.mark.parametrize("n", [320, 2500, 5000])
    def test_matches_pallas_outside_the_band(self, n):
        losses = np.random.default_rng(n).exponential(1.0, n).astype(np.float32)
        probs, sel, u = _pallas_draws(losses, 0.8, 64, seed=n)
        ours = two_level_draw(scores_of(losses, 0.8, 0.5), u, mk.draw_geometry(n))
        band = _in_band(probs, u)
        assert band.sum() <= 1
        np.testing.assert_array_equal(ours[~band], sel[~band])

    def test_extreme_skew_clamps_index(self):
        """All mass on the first element; u up to 1.0 (as
        ``test_torch_port_ops.py``'s skew case): 0s, and the clamp to n − 1
        where the count of cdf values ≤ u reaches n."""
        losses = np.asarray([100.0] + [0.0] * 15, np.float32)
        geo = mk.draw_geometry(16)
        for s in range(20):
            probs, sel, u = _pallas_draws(losses, 0.0, 8, seed=s, alpha=0.0)
            ours = two_level_draw(scores_of(losses, 0.0, 0.0), u, geo)
            band = _in_band(probs, u)
            np.testing.assert_array_equal(ours[~band], sel[~band])
        u = np.asarray([0.0, 0.5, 1.0 - 2 ** -24, 1.0], np.float32)
        assert two_level_draw(scores_of(losses, 0.0, 0.0), u, geo).tolist() == [0, 0, 0, 15]

    @pytest.mark.parametrize("n", [50_000, 1_000_000])
    def test_cluster_split_matches_the_plain_version(self, n):
        """With K = 8 and 16 blocks the model draws what the port's plain
        version (cumsum, searchsorted, clamp) draws outside the band."""
        rng = np.random.default_rng(n)
        losses = torch.from_numpy(rng.exponential(1.0, n).astype(np.float32))
        u = torch.from_numpy(rng.uniform(0, 1, 256).astype(np.float32))
        probs, sel, _ = reference.score_and_draw(losses, torch.tensor(0.8), u, 0.5)
        geo = mk.draw_geometry(n)
        assert geo.clusters > 1
        ours = two_level_draw(scores_of(losses.numpy(), 0.8, 0.5), u.numpy(), geo)
        band = _in_band(probs.numpy(), u.numpy())
        np.testing.assert_array_equal(ours[~band], sel.numpy()[~band])

    @pytest.mark.parametrize("where", ["first", "last"])
    def test_mass_in_one_block_of_a_cluster(self, where):
        """All mass on element 0 (block 0) or n − 1 (the last block) of a
        K = 8 split, u up to 1.0: the draws are 0 then the clamp, or all
        n − 1."""
        n = 50_000
        losses = torch.zeros(n)
        losses[0 if where == "first" else n - 1] = 100.0
        u = torch.tensor([0.3, 0.9, 1.0 - 2 ** -24, 1.0])
        probs, sel, _ = reference.score_and_draw(losses, torch.tensor(0.0), u, 0.0)
        ours = two_level_draw(scores_of(losses.numpy(), 0.0, 0.0), u.numpy(),
                              mk.draw_geometry(n))
        want = [0, 0, 0, n - 1] if where == "first" else [n - 1] * 4
        assert ours.tolist() == want == sel.tolist()


def _rn32(x: Fraction) -> np.float32:
    """The float32 nearest to the exact rational x, ties to even."""
    f = np.float32(float(x))
    best = None
    for c in (np.nextafter(f, np.float32(-np.inf)), f, np.nextafter(f, np.float32(np.inf))):
        d = abs(Fraction(float(c)) - x)
        even = (int(np.asarray(c).view(np.int32)) & 1) == 0
        if best is None or d < best[0] or (d == best[0] and even):
            best = (d, c)
    return best[1]


def test_quotient_is_correctly_rounded():
    """The kernel's p = s/Σs: q = RN(s·RN(1/Σs)), then RN(q + RN(s − q·Σs)·
    RN(1/Σs)) with both steps in an fma, equals the correctly rounded s/Σs
    (Markstein) for scores in [1e-12, Σs], Σs up to 1e7."""
    rng = np.random.default_rng(0)
    b = (10.0 ** rng.uniform(-3, 7, 3000)).astype(np.float32)
    a = (b * 10.0 ** rng.uniform(-12, 0, 3000)).astype(np.float32)
    a = np.maximum(a, np.float32(1e-12))
    # Awkward divisors: powers of two and all-ones mantissas; a = b.
    b[:20] = np.float32(2.0) ** np.arange(20)
    b[20:40] = np.nextafter(np.float32(2.0) ** np.arange(1, 21), np.float32(0))
    a[40:60] = b[40:60]
    for ai, bi in zip(a, b):
        inv = np.float32(1.0) / bi
        q = _rn32(Fraction(float(ai)) * Fraction(float(inv)))
        e = _rn32(Fraction(float(ai)) - Fraction(float(q)) * Fraction(float(bi)))
        got = _rn32(Fraction(float(e)) * Fraction(float(inv)) + Fraction(float(q)))
        assert got == ai / bi, (ai, bi, got, ai / bi)
