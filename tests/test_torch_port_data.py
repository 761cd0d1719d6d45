"""The port's data layer against the JAX package's: the synthetic data and
the partition from the same seed, and normalize + crop + flip bit-identical
at float32 for the offsets and flips ``augment_batch`` draws."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from mercury_tpu.data import cifar as jcifar  # noqa: E402
from mercury_tpu.data import partition as jpart  # noqa: E402
from mercury_tpu.data import pipeline as jpipe  # noqa: E402
from mercury_tpu_torch.data import cifar as tcifar  # noqa: E402
from mercury_tpu_torch.data import partition as tpart  # noqa: E402
from mercury_tpu_torch.data import pipeline as tpipe  # noqa: E402


def _augment_draws(key, n, pad=4):
    """The offsets and flips ``mercury_tpu.data.pipeline.augment_batch``
    draws from ``key``."""
    k_crop, k_flip, _ = jax.random.split(key, 3)
    off = jax.random.randint(k_crop, (n, 2), 0, 2 * pad + 1)
    flip = jax.random.bernoulli(k_flip, shape=(n,))
    return np.asarray(off), np.asarray(flip)


def test_synthetic_data_identical():
    (jx, jy), (jxt, jyt) = jcifar.synthetic_cifar(10, 200, 50, seed=102)
    (tx, ty), (txt, tyt) = tcifar.synthetic_cifar(10, 200, 50, seed=102)
    for a, b in ((jx, tx), (jy, ty), (jxt, txt), (jyt, tyt)):
        np.testing.assert_array_equal(a, b)
    _, _, info = tcifar.load_dataset("synthetic", synthetic_train_size=8,
                                     synthetic_test_size=4)
    assert info["num_classes"] == 10 and info["synthetic"]


@pytest.mark.parametrize("mode,workers", [("hetero", 4), ("hetero", 1), ("homo", 3)])
def test_partition_identical(mode, workers):
    labels = np.random.default_rng(5).integers(0, 10, 2000).astype(np.int32)
    a = jpart.partition_data(labels, workers, mode=mode, alpha=0.5, seed=102)
    b = tpart.partition_data(labels, workers, mode=mode, alpha=0.5, seed=102)
    assert len(a) == len(b) == workers
    for sa, sb in zip(a, b):
        np.testing.assert_array_equal(sa, sb)


def test_normalize_augment_bit_identical():
    """Op by op, as written: ``x/255``, ``− mean``, ``/ std``, then the
    crop and flip gathers. (Under ``jit`` XLA folds the divisions by the
    constant mean/std into reciprocal multiplies, a last-bit difference the
    step test's tolerances cover; the gathers stay exact, see below.)"""
    (x, _), _ = tcifar.synthetic_cifar(10, 64, 1, seed=3)
    mean, std = tcifar.CIFAR10_MEAN, tcifar.CIFAR10_STD
    key = jax.random.key(9)
    ref = np.asarray(jpipe.augment_batch(
        key, jpipe.normalize_images(jnp.asarray(x), mean, std)))
    off, flip = _augment_draws(key, 64)
    assert flip.any() and not flip.all()
    ours = tpipe.augment_batch(
        tpipe.normalize_images(torch.from_numpy(x), mean, std),
        torch.tensor(off), torch.tensor(flip)).numpy()
    assert ours.dtype == np.float32
    np.testing.assert_array_equal(ours, ref)


def test_jitted_crop_flip_bit_identical():
    imgs = np.random.default_rng(4).normal(0, 1, (32, 32, 32, 3)).astype(np.float32)
    key = jax.random.key(2)
    ref = np.asarray(jax.jit(jpipe.augment_batch)(key, jnp.asarray(imgs)))
    off, flip = _augment_draws(key, 32)
    ours = tpipe.augment_batch(torch.from_numpy(imgs), torch.tensor(off),
                               torch.tensor(flip)).numpy()
    np.testing.assert_array_equal(ours, ref)


def test_next_pool_follows_the_stream():
    perm = torch.arange(10)[torch.tensor([3, 1, 4, 0, 5, 9, 2, 6, 8, 7])]
    stream = tpipe.ShardStream(perm=perm, cursor=0)
    calls = []

    def new_perm():
        calls.append(1)
        return torch.arange(9, -1, -1)

    stream, a = tpipe.next_pool(stream, 4, new_perm)
    stream, b = tpipe.next_pool(stream, 4, new_perm)
    assert a.tolist() == [3, 1, 4, 0] and b.tolist() == [5, 9, 2, 6] and not calls
    # Two slots left, four wanted: reshuffle and restart, as the JAX stream does.
    jstream = jpipe.ShardStream(perm=jnp.asarray(perm.numpy(), jnp.int32),
                                cursor=jnp.asarray(8, jnp.int32))
    _, jslots = jpipe.next_pool(jstream, jax.random.key(0), 4)
    stream, c = tpipe.next_pool(stream, 4, new_perm)
    assert calls and c.tolist() == [9, 8, 7, 6] and stream.cursor == 4
    assert len(np.asarray(jslots)) == 4  # the JAX stream also restarted at 0


def test_eval_batches_identical():
    for n, b in ((10, 4), (8, 4), (3, 5)):
        ja = jpipe.eval_batches(n, b)
        ta = tpipe.eval_batches(n, b)
        assert [v for _, v in ja] == [v for _, v in ta]
        for (ji, _), (ti, _) in zip(ja, ta):
            np.testing.assert_array_equal(ji, ti)


def test_sharded_dataset_tiles_short_shards():
    x = np.zeros((6, 4, 4, 3), np.uint8)
    y = np.arange(6, dtype=np.int32)
    shards = [np.array([0, 1, 2, 3]), np.array([4, 5])]
    jds = jpipe.make_sharded_dataset((x, y), (x, y), shards,
                                     tcifar.CIFAR10_MEAN, tcifar.CIFAR10_STD, 10)
    tds = tpipe.make_sharded_dataset((x, y), (x, y), shards,
                                     tcifar.CIFAR10_MEAN, tcifar.CIFAR10_STD, 10,
                                     device=torch.device("cpu"))
    np.testing.assert_array_equal(tds.shard_indices.numpy(),
                                  np.asarray(jds.shard_indices))
    assert tds.y_train.dtype == torch.int32 and tds.x_train.dtype == torch.uint8
