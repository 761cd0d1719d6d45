"""The port's fused uint8 ingest (``augment_normalize``) against the JAX
package's ``augment_normalize_pallas``.

On the CPU the port's wrapper runs its plain version
(``mercury_tpu_torch/ops/reference.py``) and the Pallas kernel runs in
interpret mode (``use_kernel=True``), as ``tests/test_ops.py`` runs it. The
crop offsets and flips are the ones the JAX wrapper draws from its key:
``split(key, 3)``, then ``randint`` and ``bernoulli``
(``mercury_tpu/ops/mercury_kernels.py:510-512``).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from mercury_tpu.ops import augment_normalize_pallas  # noqa: E402
from mercury_tpu_torch.data import cifar  # noqa: E402
from mercury_tpu_torch.data.pipeline import augment_batch, normalize_images  # noqa: E402
from mercury_tpu_torch.ops import augment_normalize, launch_counts  # noqa: E402
from mercury_tpu_torch.ops import mercury_kernels as mk  # noqa: E402
from mercury_tpu_torch.ops import reference  # noqa: E402

MEAN, STD = cifar.CIFAR10_MEAN, cifar.CIFAR10_STD
PAD = 4


def _raw(n, seed):
    raw = np.random.default_rng(seed).integers(0, 256, (n, 32, 32, 3)).astype(np.uint8)
    raw[0] = np.tile(np.arange(256, dtype=np.uint8), 12).reshape(32, 32, 3)  # every value
    return raw


def _draws(key, n):
    k_crop, k_flip, _ = jax.random.split(key, 3)
    off = np.array(jax.random.randint(k_crop, (n, 2), 0, 2 * PAD + 1), np.int32)
    flip = np.array(jax.random.bernoulli(k_flip, shape=(n,)))
    return off, flip


def _ours(raw, off, flip, out_dtype=torch.float32):
    return augment_normalize(torch.from_numpy(raw), torch.from_numpy(MEAN),
                             torch.from_numpy(STD), torch.from_numpy(off),
                             torch.from_numpy(flip), PAD, out_dtype)


@pytest.mark.parametrize("seed", [0, 5])
def test_matches_interpret_kernel_bit_identical_f32(seed):
    """The interpret-mode TPU kernel and the plain version agree bit for
    bit at float32, the out-of-bounds +0.0 border included."""
    raw = _raw(8, seed)
    key = jax.random.key(seed)
    ref = np.asarray(augment_normalize_pallas(key, jnp.asarray(raw), MEAN, STD,
                                              use_kernel=True))
    off, flip = _draws(key, 8)
    ours = _ours(raw, off, flip).numpy()
    assert ours.dtype == np.float32 and ours.shape == raw.shape
    np.testing.assert_array_equal(ours.view(np.int32), ref.view(np.int32))


def test_bf16_is_the_last_op_cast():
    """At bf16 both round the same float32 value once, so they agree to
    within one bf16 ulp (here: exactly)."""
    raw = _raw(6, 2)
    key = jax.random.key(2)
    ref = np.asarray(augment_normalize_pallas(key, jnp.asarray(raw), MEAN, STD,
                                              out_dtype=jnp.bfloat16, use_kernel=True)
                     .astype(jnp.float32))
    off, flip = _draws(key, 6)
    ours = _ours(raw, off, flip, torch.bfloat16)
    assert ours.dtype == torch.bfloat16
    ours32 = ours.float().numpy()
    np.testing.assert_allclose(ours32, ref, rtol=2 ** -8, atol=0)
    np.testing.assert_array_equal(ours32, _ours(raw, off, flip).to(torch.bfloat16)
                                  .float().numpy())


def test_every_offset_and_flip_against_a_pixel_loop():
    """All 81 crop offsets, each with and without the flip, against a
    pixel-by-pixel loop over the padded, normalized image."""
    offs = np.array([(oy, ox) for oy in range(2 * PAD + 1) for ox in range(2 * PAD + 1)],
                    np.int32)
    off = np.concatenate([offs, offs])
    flip = np.repeat([False, True], len(offs))
    raw = np.random.default_rng(3).integers(0, 256, (len(off), 8, 8, 3)).astype(np.uint8)
    ours = _ours(raw, off, flip).numpy()
    norm = reference.dequant_normalize(torch.from_numpy(raw), torch.from_numpy(MEAN),
                                       torch.from_numpy(STD)).numpy()
    padded = np.pad(norm, ((0, 0), (PAD, PAD), (PAD, PAD), (0, 0)))
    want = np.empty_like(norm)
    for i, ((oy, ox), f) in enumerate(zip(off, flip)):
        for y in range(8):
            for x in range(8):
                xe = 7 - x if f else x
                want[i, y, x] = padded[i, y + oy, xe + ox]
    np.testing.assert_array_equal(ours, want)
    assert not np.signbit(ours[ours == 0]).any()  # the padding is +0.0


def test_dequant_is_one_fma_rounding():
    """``x·RN(1/255) − mean`` rounded once, then ``/ std``: what the
    interpret-mode kernel computes. The op-by-op ``normalize_images``
    (``x/255``, ``− mean``, ``/ std``) rounds ``x/255`` on its own, so some
    values differ by about one float32 ulp of ``x/255`` over ``std``."""
    raw = np.arange(256, dtype=np.uint8).reshape(1, 1, 256, 1).repeat(3, axis=3)
    fused = reference.dequant_normalize(torch.from_numpy(raw), torch.from_numpy(MEAN),
                                        torch.from_numpy(STD)).numpy()
    x = raw.astype(np.float64)
    exact = (x * np.float64(np.float32(1) / np.float32(255)) - MEAN.astype(np.float64)
             ).astype(np.float32)
    np.testing.assert_array_equal(fused, exact / STD)
    chain = normalize_images(torch.from_numpy(raw), MEAN, STD).numpy()
    diff = np.abs(fused - chain)
    assert diff.max() <= 2 ** -23 / STD.min()
    assert 0 < (diff > 0).sum() < diff.size


def test_cpu_wrapper_launches_nothing_and_matches_the_chain_gathers():
    """The wrapper's CPU path is the plain version (no launch), and its
    crop/flip are ``augment_batch``'s."""
    raw = _raw(4, 9)
    off, flip = _draws(jax.random.key(9), 4)
    mk.reset_launch_counts()
    ours = _ours(raw, off, flip)
    assert launch_counts["augment_normalize"] == 0
    norm = reference.dequant_normalize(torch.from_numpy(raw), torch.from_numpy(MEAN),
                                       torch.from_numpy(STD))
    want = augment_batch(norm, torch.from_numpy(off), torch.from_numpy(flip), PAD)
    assert torch.equal(ours, want)


def test_kernel_entry_point_refuses_what_it_does_not_take():
    raw = torch.from_numpy(_raw(2, 1))
    mean, std = torch.from_numpy(MEAN), torch.from_numpy(STD)
    off, flip = torch.zeros(2, 2, dtype=torch.int32), torch.zeros(2, dtype=torch.bool)
    with pytest.raises(ValueError, match="CUDA"):
        mk.augment_normalize_kernel(raw, mean, std, off, flip, PAD, torch.float32)
    with pytest.raises(ValueError, match="all CPU or all CUDA"):
        augment_normalize(raw, mean.to("meta"), std, off, flip)


# --- The redesigned kernel: its table, its rows, its geometry -------------

def _table_model(mean, std):
    """The kernel's per-block table ``T[c][v]`` (``C × 256``), each entry
    built as the kernel builds it: the fma ``v·RN(1/255) − mean_c`` rounded
    once to float32 (from its exact rational value, which float64 holds
    without rounding), then an IEEE float32 division by ``std_c``."""
    from fractions import Fraction

    inv = Fraction(float(np.float32(reference.INV_255)))
    table = np.empty((len(mean), 256), np.float32)
    for ch, (m, s) in enumerate(zip(mean.astype(np.float32), std.astype(np.float32))):
        for v in range(256):
            exact = v * inv - Fraction(float(m))
            assert Fraction(float(exact)) == exact  # float64 holds it: one rounding below
            table[ch, v] = np.float32(float(exact)) / s
    return table


@pytest.mark.parametrize("which", ["cifar", "random"])
def test_table_model_is_bit_equal_to_dequant_normalize(which):
    """Every output element of the kernel is a lookup ``T[c][u8]``; the
    table holds exactly what the plain version computes for all 256 values
    of every channel."""
    if which == "cifar":
        mean, std = MEAN, STD
    else:
        rng = np.random.default_rng(17)
        mean = rng.uniform(0.2, 0.8, 3).astype(np.float32)
        std = rng.uniform(0.1, 0.5, 3).astype(np.float32)
    table = _table_model(mean, std)
    raw = np.arange(256, dtype=np.uint8).reshape(1, 16, 16, 1).repeat(3, axis=3)
    want = reference.dequant_normalize(torch.from_numpy(raw), torch.from_numpy(mean),
                                       torch.from_numpy(std)).numpy()
    got = table[np.arange(3)[None, None, None, :], raw]
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


@pytest.mark.parametrize("seed", [4, 8])
def test_rows_form_gathers_on_cpu(seed):
    """``augment_normalize(x, ..., rows=idx)`` is ``augment_normalize(x[idx],
    ...)`` and the interpret-mode TPU kernel on the gathered rows, a
    repeated row included."""
    raw = _raw(12, seed)
    idx = np.array([3, 7, 3, 0, 11, 5], np.int64)
    key = jax.random.key(seed)
    ref = np.asarray(augment_normalize_pallas(key, jnp.asarray(raw[idx]), MEAN, STD,
                                              use_kernel=True))
    off, flip = _draws(key, len(idx))
    mk.reset_launch_counts()
    ours = augment_normalize(torch.from_numpy(raw), torch.from_numpy(MEAN),
                             torch.from_numpy(STD), torch.from_numpy(off),
                             torch.from_numpy(flip), PAD, rows=torch.from_numpy(idx))
    assert launch_counts["augment_normalize"] == 0
    np.testing.assert_array_equal(ours.numpy(), _ours(raw[idx], off, flip).numpy())
    np.testing.assert_array_equal(ours.numpy().view(np.int32), ref.view(np.int32))


def _band_rows(geo, k, h):
    """The output rows ``[y0, y1)`` that block (i, k) of the grid (images,
    ⌈h / band⌉) writes of image i, as the kernel computes them."""
    y0 = k * geo.band
    return y0, min(y0 + geo.band, h)


def _kernel_model(geo, raw, rows, off, flip, mean, std):
    """A numpy model of ``augment_normalize_kernel``'s blocks: block (i, k)
    takes output rows ``_band_rows(k)`` of image i, stages the source rows
    ``band ± pad`` within the image, looks every element up in the table
    and writes it once; ``written`` counts the writes."""
    n = len(rows)
    _, h, w, c = raw.shape
    table = _table_model(mean, std)
    out = np.full((n, h, w, c), np.nan, np.float32)
    written = np.zeros((n, h), np.int64)
    for img, k in np.ndindex(n, -(-h // geo.band)):
        y0, y1 = _band_rows(geo, k, h)
        s0, s1 = max(y0 - PAD, 0), min(y1 + PAD, h)
        stage = raw[rows[img], s0:s1]
        assert ((s1 - s0) * w * c + 4 * 256 * c) <= geo.smem  # the table and the stage
        oy, ox = off[img]
        for y in range(y0, y1):
            written[img, y] += 1
            sy = y + oy - PAD
            if not 0 <= sy < h:
                out[img, y] = 0.0  # a row of the padding: zeros, no lookups
                continue
            for x in range(w):
                sx = (w - 1 - x if flip[img] else x) + ox - PAD
                out[img, y, x] = table[np.arange(c), stage[sy - s0, sx]] if 0 <= sx < w else 0.0
    return out, written


GEOMETRY_SHAPES = [(32, 32, 3), (30, 30, 3), (8, 8, 3), (224, 224, 3), (1000, 4000, 3)]


@pytest.mark.parametrize("n", [1, 32, 64, 320])
@pytest.mark.parametrize("shape", GEOMETRY_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_ingest_geometry_fits_and_covers_every_row_once(n, shape):
    """Shared memory within the card's limit; the bulk staging only for
    rows of a multiple of 16 bytes from an aligned tensor; every output
    row of every image written by exactly one block."""
    h, w, c = shape
    for itemsize in (4, 2):
        for aligned in (True, False):
            geo = mk.ingest_geometry(n, h, w, c, itemsize, PAD, aligned=aligned)
            assert geo.smem <= mk.INGEST_MAX_SMEM
            assert geo.smem >= mk.ingest_smem(h, w, c, geo.band, PAD, itemsize)
            assert geo.threads % 32 == 0 and 32 <= geo.threads <= 1024
            bulk = (w * c) % 16 == 0 and aligned
            assert geo.copy == (mk.COPY_BULK if bulk else mk.COPY_BYTES)
            seen = np.zeros((n, h), np.int64)
            for img, k in np.ndindex(n, -(-h // geo.band)):
                y0, y1 = _band_rows(geo, k, h)
                assert 0 <= y0 < y1 <= h
                seen[img, y0:y1] += 1
            assert (seen == 1).all()


@pytest.mark.parametrize("band", [32, 16, 8, 5, 1])
def test_kernel_model_matches_the_plain_version(band):
    """The block model at several bands (a band of 5 leaves a short last
    one), rows with a repeat, all offsets at the corners of [0, 2·pad]:
    bit-equal to the plain version on the gathered rows, every output row
    written once."""
    raw = _raw(6, 21)
    rows = np.array([5, 0, 5, 2], np.int64)
    off = np.array([[0, 0], [8, 8], [0, 8], [4, 3]], np.int32)
    flip = np.array([False, True, True, False])
    geo = mk.IngestGeometry(256, band, mk.COPY_BULK, mk.ingest_smem(32, 32, 3, band, PAD, 4))
    got, written = _kernel_model(geo, raw, rows, off, flip, MEAN, STD)
    assert (written == 1).all()
    want = _ours(raw[rows], off, flip).numpy()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


def test_kernel_model_on_an_odd_shape():
    """30×30×3 (rows of 90 bytes: byte staging, per-pixel stores)."""
    raw = np.random.default_rng(2).integers(0, 256, (3, 30, 30, 3)).astype(np.uint8)
    rows = np.array([2, 2, 1], np.int64)
    off = np.array([[1, 7], [8, 0], [3, 3]], np.int32)
    flip = np.array([True, False, True])
    geo = mk.ingest_geometry(3, 30, 30, 3, 4, PAD)
    assert geo.copy == mk.COPY_BYTES and geo.band == 30
    got, written = _kernel_model(geo, raw, rows, off, flip, MEAN, STD)
    assert (written == 1).all()
    np.testing.assert_array_equal(got, _ours(raw[rows], off, flip).numpy())


def test_ingest_geometry_refuses_what_does_not_fit():
    with pytest.raises(ValueError, match="shared"):
        mk.ingest_geometry(1, 4, 100_000, 3, 4, PAD)  # one row of 300 KB
    with pytest.raises(ValueError, match="n, h, w, c >= 1"):
        mk.ingest_geometry(0, 32, 32, 3, 4, PAD)


def test_wrapper_refuses_bad_rows():
    """``rows`` must be 1-d int64 on the images' device; the kernel entry
    point refuses CPU rows like every CPU tensor."""
    raw = torch.from_numpy(_raw(4, 3))
    mean, std = torch.from_numpy(MEAN), torch.from_numpy(STD)
    off, flip = torch.zeros(2, 2, dtype=torch.int32), torch.zeros(2, dtype=torch.bool)
    with pytest.raises(TypeError, match="int64"):
        augment_normalize(raw, mean, std, off, flip, rows=torch.tensor([0, 1], dtype=torch.int32))
    with pytest.raises(TypeError, match="int64"):
        augment_normalize(raw, mean, std, off, flip, rows=torch.tensor([[0, 1]]))
    with pytest.raises(ValueError, match="all CPU or all CUDA"):
        augment_normalize(raw, mean, std, off, flip, rows=torch.tensor([0, 1], device="meta"))
    with pytest.raises(ValueError, match="CUDA"):
        mk.augment_normalize_kernel(raw, mean, std, off, flip, PAD, torch.float32,
                                    rows=torch.tensor([0, 1]))
