"""The launch geometry and the lane split of the port's forward NLL kernel.

``nll_fwd`` runs on the card as ``nll_fwd_kernel`` in
``mercury_tpu_torch/ops/csrc/mercury_kernels.cu``, with the geometry of
``nll_geometry``: ``G`` lanes a row, lane ``g`` holding the row's vectors
``g, g + G, ...`` of ``vec`` values. The kernel cannot run here, so these
tests check what surrounds it: that the geometry gives every (row, column)
to exactly one lane, and that a torch model of the kernel's order of
operations (each lane's max over its values, the butterfly max across the
``G`` lanes, each lane's sum of exp in its register order, the butterfly
sum with the picked logit riding along) agrees with the plain version and
with ``per_sample_nll_pallas`` in interpret mode.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from mercury_tpu.ops import per_sample_nll_pallas  # noqa: E402
from mercury_tpu_torch.ops import mercury_kernels as mk  # noqa: E402
from mercury_tpu_torch.ops import reference  # noqa: E402

CLASSES = [1, 2, 3, 10, 31, 32, 33, 100, 1000]
ROWS = [1, 31, 32, 33, 320, 4096]
ITEMSIZES = [4, 2]  # float32, bfloat16


def _lane_columns(c, geo):
    """Columns [G, per·vec] lane g of a row holds, in its register order,
    and which of them lie in the row."""
    nvec = c // geo.vec
    per = -(-nvec // geo.lanes)
    g = np.arange(geo.lanes)[:, None, None]
    k = np.arange(per)[None, :, None]
    e = np.arange(geo.vec)[None, None, :]
    j = g + geo.lanes * k
    cols = (j * geo.vec + e).reshape(geo.lanes, per * geo.vec)
    valid = np.broadcast_to(j < nvec, (geo.lanes, per, geo.vec)).reshape(cols.shape)
    return cols, valid


def _owners(n, c, geo):
    """How many threads of the grid hold each (row, column)."""
    blocks = -(-n // geo.rows)
    tid = np.arange(blocks * geo.threads)
    row = (tid // geo.threads) * geo.rows + (tid % geo.threads) // geo.lanes
    lane = tid % geo.lanes
    cols, valid = _lane_columns(c, geo)
    count = np.zeros((n, c), np.int64)
    live = row < n
    col, ok = cols[lane[live]], valid[lane[live]]
    r = np.broadcast_to(row[live][:, None], col.shape)
    np.add.at(count, (r[ok], col[ok]), 1)
    return count


def lane_model(z, y, geo):
    """The kernel's arithmetic order in float32 torch: fmaxf (a NaN is no
    maximum) over each lane's values, then the xor butterfly over the G
    lanes; each lane's Σ exp(z − m) in register order, the logit of the
    label's column (compared, never indexed), then the butterfly sum of
    both; ``(log s + m) − picked``."""
    z = z.to(torch.float32)
    n, c = z.shape
    cols, valid = _lane_columns(c, geo)
    cols_t = torch.from_numpy(np.where(valid, cols, 0))
    valid_t = torch.from_numpy(valid.copy())
    vals = torch.where(valid_t, z[:, cols_t], torch.tensor(-torch.inf))  # [N, G, per·vec]
    y = y.long()
    y = torch.where((y >= 0) & (y < c), y, -1)
    lane = torch.arange(geo.lanes)
    m = torch.full((n, geo.lanes), -torch.inf)
    for i in range(vals.shape[2]):
        m = torch.fmax(m, vals[:, :, i])
    o = geo.lanes // 2
    while o:
        m = torch.fmax(m, m[:, lane ^ o])
        o //= 2
    s = torch.zeros(n, geo.lanes)
    picked = torch.zeros(n, geo.lanes)
    for i in range(vals.shape[2]):
        ok = valid_t[:, i]
        s = torch.where(ok, s + torch.exp(vals[:, :, i] - m), s)
        hit = ok & (torch.from_numpy(cols[:, i])[None, :] == y[:, None])
        picked = torch.where(hit, vals[:, :, i], picked)
    o = geo.lanes // 2
    while o:
        s = s + s[:, lane ^ o]
        picked = picked + picked[:, lane ^ o]
        o //= 2
    return (torch.log(s[:, 0]) + m[:, 0]) - picked[:, 0]


def _logits(n, c, seed, dtype=torch.float32):
    rng = np.random.default_rng(seed)
    z = torch.from_numpy(rng.normal(0, 3, (n, c)).astype(np.float32)).to(dtype)
    y = torch.from_numpy(rng.integers(0, c, n).astype(np.int32))
    return z, y


class TestGeometry:
    @pytest.mark.parametrize("itemsize", ITEMSIZES)
    @pytest.mark.parametrize("c", CLASSES)
    def test_every_logit_has_one_lane(self, c, itemsize):
        for n in ROWS:
            geo = mk.nll_geometry(n, c, itemsize)
            np.testing.assert_array_equal(_owners(n, c, geo), np.ones((n, c), np.int64))

    @pytest.mark.parametrize("itemsize", ITEMSIZES)
    @pytest.mark.parametrize("c", CLASSES)
    def test_limits_of_the_kernel(self, c, itemsize):
        for n in ROWS:
            for align in (2, 4, 8, 16, 64):
                if align < itemsize:
                    continue
                geo = mk.nll_geometry(n, c, itemsize, align)
                assert geo.lanes in (1, 2, 4, 8, 16, 32)
                assert geo.threads % 32 == 0 and 32 <= geo.threads <= mk.NLL_THREADS <= 256
                assert geo.threads % geo.lanes == 0
                assert c % geo.vec == 0 and geo.vec * itemsize <= min(16, align)
                loads = -(-(c // geo.vec) // geo.lanes)
                assert loads <= mk.NLL_LANE_VECTORS or geo.lanes == mk.NLL_MAX_LANES
                # The fewest lanes that keep a lane's loads within bounds.
                if geo.lanes > 1:
                    assert -(-(c // geo.vec) // (geo.lanes // 2)) > mk.NLL_LANE_VECTORS
                # No block is idle.
                assert (-(-n // geo.rows) - 1) * geo.rows < n

    def test_the_step_shapes(self):
        """The sweep's choice: 4 lanes a row at 10 classes, 16 at 100, 128
        threads a block; [32, 10] is one block, [320, 10] ten."""
        assert mk.nll_geometry(320, 10, 4) == (4, 128, 2)
        assert mk.nll_geometry(32, 10, 4) == (4, 128, 2)
        assert mk.nll_geometry(64, 10, 2) == (4, 128, 2)
        assert mk.nll_geometry(4096, 100, 4) == (16, 128, 4)
        assert mk.nll_geometry(1, 10, 4) == (4, 32, 2)

    def test_widest_load(self):
        # 40-byte float32 rows take float2, 20-byte bf16 rows bf16 pairs,
        # 400-byte rows float4; a pointer off 16 bytes narrows the load.
        assert mk.nll_vec(10, 4) == 2 and mk.nll_vec(10, 2) == 2
        assert mk.nll_vec(100, 4) == 4 and mk.nll_vec(100, 2) == 4
        assert mk.nll_vec(1000, 2) == 8 and mk.nll_vec(33, 4) == 1
        assert mk.nll_vec(100, 4, align=8) == 2 and mk.nll_vec(100, 4, align=4) == 1
        t = torch.zeros(64, dtype=torch.float32)  # the CPU allocator aligns to 64 bytes
        assert [mk._alignment(t[i:]) for i in range(5)] == [16, 4, 8, 4, 16]

    def test_refuses_empty_shapes(self):
        for args in ((0, 10, 4), (8, 0, 4), (8, 10, 8)):
            with pytest.raises(ValueError):
                mk.nll_geometry(*args)


class TestLaneModel:
    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    @pytest.mark.parametrize("n,c", [(32, 10), (64, 10), (320, 10), (33, 1), (31, 3),
                                     (64, 33), (256, 100), (16, 1000), (8, 2053)])
    def test_matches_plain_version(self, n, c, dtype):
        z, y = _logits(n, c, n + c, dtype)
        geo = mk.nll_geometry(n, c, z.element_size())
        np.testing.assert_allclose(lane_model(z, y, geo).numpy(),
                                   reference.nll_forward(z, y).numpy(), rtol=1e-5, atol=1e-5)

    @pytest.mark.parametrize("lanes", [1, 2, 4, 8, 16, 32])
    def test_every_lane_count_at_the_pool_shape(self, lanes):
        """The sweep's splits: any G gives the same losses to rounding."""
        z, y = _logits(320, 10, 3)
        geo = mk.NllGeometry(lanes, 64, 2)
        np.testing.assert_allclose(lane_model(z, y, geo).numpy(),
                                   reference.nll_forward(z, y).numpy(), rtol=1e-5, atol=1e-5)

    def test_matches_pallas_at_the_pool_shape(self):
        z, y = _logits(320, 10, 4)
        ref = np.asarray(per_sample_nll_pallas(jnp.asarray(z.numpy()), jnp.asarray(y.numpy())))
        geo = mk.nll_geometry(320, 10, 4)
        np.testing.assert_allclose(lane_model(z, y, geo).numpy(), ref, rtol=1e-5, atol=1e-6)

    @pytest.mark.parametrize("lanes", [1, 2, 8])
    def test_non_finite_rows(self, lanes):
        """fmaxf skips a NaN where torch's max keeps it, yet the NaN still
        reaches the loss through Σexp: NaN and ±inf fall where the plain
        version puts them."""
        z, y = _logits(6, 10, 5)
        y[:6] = torch.tensor([1, 2, 0, 3, 1, 10], dtype=torch.int32)
        z[0, 9] = -torch.inf
        z[1, 2] = -torch.inf
        z[2, 1] = torch.inf
        z[3, 0] = torch.nan
        z[4] = -torch.inf
        geo = mk.NllGeometry(lanes, 32, 2)
        got, want = lane_model(z, y, geo).numpy(), reference.nll_forward(z, y).numpy()
        np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
        assert np.isnan(want).tolist() == [False, False, True, True, True, False]
        assert got[1] == want[1] == np.inf
        fin = np.isfinite(want)
        np.testing.assert_allclose(got[fin], want[fin], rtol=1e-5, atol=1e-6)
