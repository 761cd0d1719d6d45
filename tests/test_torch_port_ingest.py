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
