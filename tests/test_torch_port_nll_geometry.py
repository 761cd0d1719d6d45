"""The launch geometry and the lane split of the port's NLL kernels.

``nll_fwd`` and ``nll_bwd`` run on the card as ``nll_fwd_kernel`` and
``nll_bwd_kernel`` in ``mercury_tpu_torch/ops/csrc/mercury_kernels.cu``,
both with the geometry of ``nll_geometry``: ``G`` lanes a row, lane ``g``
holding the row's vectors ``g, g + G, ...`` of ``vec`` values (for the
backward, the widest that both the logits' and the gradient's pointers
allow, since its stores are as wide as its loads). The kernels cannot run
here, so these tests check what surrounds them: that the geometry gives
every (row, column) to exactly one lane, with every vector aligned to its
width, and that torch models of the kernels' order of operations agree
with the plain versions and with ``per_sample_nll_pallas`` (and its VJP)
in interpret mode. The forward's model: each lane's max over its values,
the butterfly max across the ``G`` lanes, each lane's sum of exp in its
register order, the butterfly sum with the picked logit riding along. The
backward's: the same max, ``exp`` once an element, each lane's float64 sum
of the exponentials in register order, the butterfly sum rounded once to
float32, ``(e / s − onehot)·g`` rounded once. Last, every ablation cut of ``ops/select_sweep.py`` still
finds its text in the source (a stale cut fails there only on the card).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import jax  # noqa: E402

from mercury_tpu.ops import per_sample_nll_pallas  # noqa: E402
from mercury_tpu_torch.ops import _build, select_sweep  # noqa: E402
from mercury_tpu_torch.ops import mercury_kernels as mk  # noqa: E402
from mercury_tpu_torch.ops import reference  # noqa: E402

CLASSES = [1, 2, 3, 10, 31, 32, 33, 100, 1000]
ROWS = [1, 31, 32, 33, 320, 4096]
ITEMSIZES = [4, 2]  # float32, bfloat16
ALIGNS = [2, 4, 8, 16]  # byte alignments of the logits' and the gradient's pointers


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
    live = row < n
    col, ok = cols[lane[live]], valid[lane[live]]
    r = np.broadcast_to(row[live][:, None], col.shape)
    return np.bincount(r[ok] * c + col[ok], minlength=n * c).reshape(n, c)


def _lane_values(z, geo):
    """The values [N, G, per·vec] each lane of each row holds, in register
    order, −inf past the row's end; which lie in the row; their columns."""
    n, c = z.shape
    cols, valid = _lane_columns(c, geo)
    cols_t = torch.from_numpy(np.where(valid, cols, 0))
    valid_t = torch.from_numpy(valid.copy())
    vals = torch.where(valid_t, z[:, cols_t], torch.tensor(-torch.inf))
    return vals, valid_t, cols


def _row_max(vals, geo):
    """fmaxf (a NaN is no maximum) over each lane's values, then the xor
    butterfly over the G lanes: [N, G], every lane's copy of the row max."""
    lane = torch.arange(geo.lanes)
    m = torch.full(vals.shape[:2], -torch.inf)
    for i in range(vals.shape[2]):
        m = torch.fmax(m, vals[:, :, i])
    o = geo.lanes // 2
    while o:
        m = torch.fmax(m, m[:, lane ^ o])
        o //= 2
    return m


def _butterfly_sum(s, geo):
    lane = torch.arange(geo.lanes)
    o = geo.lanes // 2
    while o:
        s = s + s[:, lane ^ o]
        o //= 2
    return s


def _label_or_none(y, c):
    """A label outside [0, C) becomes −1: it matches no column."""
    y = y.long()
    return torch.where((y >= 0) & (y < c), y, -1)


def lane_model(z, y, geo):
    """The kernel's arithmetic order in float32 torch: fmaxf (a NaN is no
    maximum) over each lane's values, then the xor butterfly over the G
    lanes; each lane's Σ exp(z − m) in register order, the logit of the
    label's column (compared, never indexed), then the butterfly sum of
    both; ``(log s + m) − picked``."""
    z = z.to(torch.float32)
    n, c = z.shape
    vals, valid_t, cols = _lane_values(z, geo)
    y = _label_or_none(y, c)
    m = _row_max(vals, geo)
    s = torch.zeros(n, geo.lanes)
    picked = torch.zeros(n, geo.lanes)
    for i in range(vals.shape[2]):
        ok = valid_t[:, i]
        s = torch.where(ok, s + torch.exp(vals[:, :, i] - m), s)
        hit = ok & (torch.from_numpy(cols[:, i])[None, :] == y[:, None])
        picked = torch.where(hit, vals[:, :, i], picked)
    s, picked = _butterfly_sum(s, geo), _butterfly_sum(picked, geo)
    return (torch.log(s[:, 0]) + m[:, 0]) - picked[:, 0]


def bwd_lane_model(z, y, g, geo):
    """``nll_bwd_kernel``'s arithmetic order in torch: the forward's row max;
    ``e = exp(z − m)`` once an element in float32; each lane's Σe in
    float64 in register order over the values in the row, then the
    butterfly sum, rounded once to float32; ``(e / s − [col == y])·g`` with
    a true division, rounded once into z's dtype, each value written to its
    column by the lane that holds it."""
    n, c = z.shape
    vals, valid_t, cols = _lane_values(z.to(torch.float32), geo)
    m = _row_max(vals, geo)
    e = torch.exp(vals - m[:, :, None])
    s = torch.zeros(n, geo.lanes, dtype=torch.float64)
    for i in range(vals.shape[2]):
        s = torch.where(valid_t[:, i], s + e[:, :, i].to(torch.float64), s)
    s = _butterfly_sum(s, geo).to(torch.float32)
    cols_t = torch.from_numpy(cols)
    onehot = (cols_t[None] == _label_or_none(y, c)[:, None, None]).to(torch.float32)
    r = (e / s[:, :, None] - onehot) * g.to(torch.float32)[:, None, None]
    out = torch.full((n, c), torch.nan)
    out[:, cols_t[valid_t]] = r[:, valid_t]
    return out.to(z.dtype)


def _assert_bf16_ulp(got, want):
    """Within one bf16 ulp of the larger magnitude (1e-6 near zero)."""
    a, b = got.float().numpy(), want.float().numpy()
    _, e = np.frexp(np.maximum(np.abs(a), np.abs(b)))
    ulp = np.ldexp(1.0, e - 8)  # 8 significant bits
    assert np.all(np.abs(a - b) <= np.maximum(ulp, 1e-6)), float(np.abs(a - b).max())


def _assert_same_gradient(got, want):
    if got.dtype == torch.bfloat16:
        _assert_bf16_ulp(got, want)
    else:
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5, atol=1e-6)


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


def _bwd_inputs(n, c, seed, dtype=torch.float32):
    z, y = _logits(n, c, seed, dtype)
    g = torch.from_numpy(np.random.default_rng(seed + 1).uniform(0.1, 2.0, n).astype(np.float32))
    return z, y, g


def _non_finite_rows():
    """The rows of ``test_non_finite_rows_vjp_match_pallas``
    (``tests/test_torch_port_ops.py``): −inf off the label, −inf on the
    label, +inf, NaN, then finite rows."""
    z, y = _logits(8, 10, 9)
    y[:4] = torch.tensor([1, 2, 0, 3], dtype=torch.int32)
    z[0, 9] = -torch.inf
    z[1, 2] = -torch.inf
    z[2, 1] = torch.inf
    z[3, 0] = torch.nan
    return z, y, torch.linspace(0.5, 1.5, 8)


def _pallas_vjp(z, y, g):
    _, vjp = jax.vjp(lambda lg: per_sample_nll_pallas(lg, jnp.asarray(y.numpy())),
                     jnp.asarray(z.numpy()))
    return np.asarray(vjp(jnp.asarray(g.numpy()))[0])


class TestBackwardGeometry:
    @pytest.mark.parametrize("itemsize", ITEMSIZES)
    @pytest.mark.parametrize("c", CLASSES)
    def test_every_gradient_element_written_once(self, c, itemsize):
        """With the backward's geometry (the alignment both pointers share),
        each (row, column) of the gradient is written by exactly one lane,
        and every vector of the logits and of the gradient is aligned to its
        width, for pointers 2, 4, 8 and 16 bytes aligned."""
        checked = set()
        for n in ROWS:
            for a_z in ALIGNS:
                for a_g in ALIGNS:
                    if min(a_z, a_g) < itemsize:
                        continue  # no tensor of this dtype starts there
                    geo = mk.nll_geometry(n, c, itemsize, min(a_z, a_g))
                    width = geo.vec * itemsize
                    assert c % geo.vec == 0 and width <= min(16, a_z, a_g)
                    if (n, geo) not in checked:
                        np.testing.assert_array_equal(_owners(n, c, geo), 1)
                        checked.add((n, geo))
                    # The byte address of each vector a lane loads and stores.
                    cols, valid = _lane_columns(c, geo)
                    starts = np.unique(cols[valid][::geo.vec])
                    offsets = (np.arange(n)[:, None] * c + starts[None, :]) * itemsize
                    for base in (4096 + a_z, 4096 + a_g):  # exactly a_z, a_g aligned
                        assert np.all((base + offsets) % width == 0)

    def test_the_step_shapes(self):
        """The wrapper's fresh gradient is aligned, so the step's [32, 10]
        call takes the forward's geometry: 4 lanes, float2 loads and
        stores; a logits pointer 4 bytes off narrows both to one value."""
        assert mk.nll_geometry(32, 10, 4, min(16, 16)) == (4, 128, 2)
        assert mk.nll_geometry(4096, 100, 2, min(16, 16)) == (16, 128, 4)
        assert mk.nll_geometry(64, 10, 4, min(4, 16)) == (8, 128, 1)

    def test_wrapper_refuses_cpu_tensors(self):
        z, y, g = _bwd_inputs(8, 10, 1)
        with pytest.raises(ValueError, match="CUDA"):
            mk.nll_bwd_kernel(z, y, g)


class TestBackwardLaneModel:
    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    @pytest.mark.parametrize("n,c", [(32, 10), (64, 10), (320, 10), (33, 1), (31, 3),
                                     (64, 33), (256, 100), (16, 1000), (8, 2053)])
    def test_matches_plain_version(self, n, c, dtype):
        z, y, g = _bwd_inputs(n, c, n + c, dtype)
        y[::7] = torch.tensor([-1, c], dtype=torch.int32).repeat(n)[: len(y[::7])]
        geo = mk.nll_geometry(n, c, z.element_size())
        _assert_same_gradient(bwd_lane_model(z, y, g, geo), reference.nll_backward(z, y, g))

    @pytest.mark.parametrize("lanes", [4, 16, 32])
    def test_bf16_the_same_for_every_lane_count(self, lanes):
        """Σe in float64, rounded once, is the correctly rounded sum in any
        order of adds, so every lane count gives the same bf16 gradient to
        the bit (that of the row summed in column order), within one bf16
        ulp of the plain version's float32 sum."""
        z, y, g = _bwd_inputs(4096, 100, lanes, torch.bfloat16)
        got = bwd_lane_model(z, y, g, mk.NllGeometry(lanes, 128, 4))
        assert torch.equal(got, bwd_lane_model(z, y, g, mk.NllGeometry(1, 128, 1)))
        _assert_bf16_ulp(got, reference.nll_backward(z, y, g))

    @pytest.mark.parametrize("lanes", [1, 2, 4, 8, 16, 32])
    def test_every_lane_count_at_the_batch_shape(self, lanes):
        """The sweep's splits: any G gives the same gradient to rounding."""
        z, y, g = _bwd_inputs(32, 10, 3)
        geo = mk.NllGeometry(lanes, 64, 2)
        _assert_same_gradient(bwd_lane_model(z, y, g, geo), reference.nll_backward(z, y, g))

    @pytest.mark.parametrize("n,c", [(32, 10), (64, 100)])
    def test_matches_pallas_vjp(self, n, c):
        z, y, g = _bwd_inputs(n, c, 6)
        geo = mk.nll_geometry(n, c, 4)
        np.testing.assert_allclose(bwd_lane_model(z, y, g, geo).numpy(), _pallas_vjp(z, y, g),
                                   rtol=1e-5, atol=1e-6)

    @pytest.mark.parametrize("lanes", [1, 2, 8])
    def test_non_finite_rows(self, lanes):
        """NaN and ±inf fall where the plain version and the Pallas VJP put
        them: the +inf and the NaN rows are NaN; −inf off the label is
        finite, and on the label gives −g_i there."""
        z, y, g = _non_finite_rows()
        got = bwd_lane_model(z, y, g, mk.NllGeometry(lanes, 32, 2)).numpy()
        for want in (reference.nll_backward(z, y, g).numpy(), _pallas_vjp(z, y, g)):
            np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
            np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
            fin = np.isfinite(want)
            np.testing.assert_allclose(got[fin], want[fin], rtol=1e-5, atol=1e-6)
        assert np.isnan(got).all(1).tolist() == [False, False, True, True] + [False] * 4
        assert got[1, 2] == -g[1].item()


class TestLibraryYardstick:
    @pytest.mark.parametrize("n,c", [(32, 10), (320, 10), (4096, 100)])
    def test_aten_pair_is_the_plain_gradient(self, n, c):
        """The 2 ATen calls timed beside nll_bwd compute its function."""
        z, y, g = _bwd_inputs(n, c, 7)
        got = select_sweep.aten_nll_backward(torch, z, y.long(), g)()
        np.testing.assert_allclose(got.numpy(), reference.nll_backward(z, y, g).numpy(),
                                   rtol=0, atol=1e-6)


# Occurrences in csrc/mercury_kernels.cu of each cut's text, by table, by
# ablation, in cut order. build_variants() replaces every occurrence, so a
# count above 1 would cut more than one kernel.
CUT_COUNTS = {
    "ABLATIONS": {"no_draws": [1], "no_exchange": [1, 1, 1, 1]},
    "INGEST_ABLATIONS": {"empty": [1], "no_table": [1], "no_copy": [1, 1], "no_lookup": [1],
                         "no_stores": [1], "no_sync": [1], "stop_after_sync": [1],
                         "stop_after_wait": [1]},
    "NLL_ABLATIONS": {"empty": [1], "stop_after_loads": [1], "no_exp": [1]},
    "NLL_BWD_ABLATIONS": {"empty": [1], "stop_after_loads": [1], "no_division": [1],
                          "float32_sum": [1, 1]},
}


@pytest.mark.parametrize("table", sorted(CUT_COUNTS))
def test_ablation_cuts_hit_the_source(table):
    assert sorted(n for n in dir(select_sweep) if n.endswith("ABLATIONS")) == sorted(CUT_COUNTS)
    text = (_build.CSRC / "mercury_kernels.cu").read_text()
    found = {name: [text.count(old) for old, _ in cuts]
             for name, cuts in getattr(select_sweep, table).items()}
    assert found == CUT_COUNTS[table]
