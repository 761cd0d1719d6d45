"""The port's sequence datasets against the JAX package's loader: the same
float32 ``[N, T, F]`` bytes, labels and ``info`` from the same seed, for
``synthetic_seq``, ``synthetic_seq_hard``, ``digits_seq`` and
``digits_seq_imb`` (the digits only where scikit-learn imports, as the
``digits`` tests), and both difficulties of ``synthetic_sequences``."""

import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from mercury_tpu.data import cifar as jcifar  # noqa: E402
from mercury_tpu_torch import TrainConfig  # noqa: E402
from mercury_tpu_torch.config import _DATASETS, _MODELS  # noqa: E402
from mercury_tpu_torch.data import cifar as tcifar  # noqa: E402

SEQUENCE_DATASETS = ("synthetic_seq", "synthetic_seq_hard", "digits_seq", "digits_seq_imb")
SEQUENCE_MODELS = ("bilstm_attention", "mylstm", "lstm", "transformer")
SMALL = dict(synthetic_train_size=300, synthetic_test_size=60)


def _needs_sklearn(name):
    if name.startswith("digits"):
        pytest.importorskip("sklearn.datasets")


@pytest.mark.parametrize("seed", [0, 7])
@pytest.mark.parametrize("name", SEQUENCE_DATASETS)
def test_sequence_dataset_identical(name, seed):
    _needs_sklearn(name)
    want = jcifar.load_dataset(name, seed=seed, **SMALL)
    got = tcifar.load_dataset(name, seed=seed, **SMALL)
    for split_want, split_got in zip(want[:2], got[:2]):
        for a, b in zip(split_want, split_got):
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_array_equal(a, b)
    x = got[0][0]
    assert x.dtype == np.float32 and x.shape[1:] == ((64, 1) if name.startswith("digits")
                                                     else (32, 16))
    assert got[0][1].dtype == np.int32
    assert set(got[2]) == set(want[2]) == {"num_classes", "mean", "std", "synthetic"}
    for k, v in want[2].items():
        if isinstance(v, np.ndarray):
            assert got[2][k].dtype == v.dtype == np.float32 and got[2][k].shape == (1,)
            np.testing.assert_array_equal(got[2][k], v)
        else:
            assert got[2][k] == v, k
    assert got[2]["num_classes"] == 10
    assert got[2]["synthetic"] == name.startswith("synthetic")


@pytest.mark.parametrize("difficulty", ["uniform", "hard_minority"])
@pytest.mark.parametrize("shape", [(32, 16), (10, 3)])
def test_synthetic_sequences_identical(difficulty, shape):
    args = dict(num_classes=5, train_size=120, test_size=40, seq_len=shape[0],
                feature_dim=shape[1], seed=3, difficulty=difficulty)
    want, got = jcifar.synthetic_sequences(**args), tcifar.synthetic_sequences(**args)
    for a, b in zip(want[0] + want[1], got[0] + got[1]):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_hard_minority_is_zero_before_its_window():
    """15% of the samples carry the pattern only in the last T // 5 steps:
    before them they are noise at scale 0.25 alone."""
    (x, _), _ = tcifar.synthetic_sequences(10, 2000, 10, difficulty="hard_minority")
    (u, _), _ = tcifar.synthetic_sequences(10, 2000, 10)
    head = np.abs(x[:, :26]).mean(axis=(1, 2))
    quiet = head < 0.3
    assert 0.1 < quiet.mean() < 0.2
    assert (np.abs(u[:, :26]).mean(axis=(1, 2)) < 0.3).mean() < 0.05


@pytest.mark.parametrize("name", ["digits_seq", "digits_seq_imb"])
def test_digits_seq_without_sklearn_raise_import_error(name, monkeypatch):
    monkeypatch.setitem(sys.modules, "sklearn.datasets", None)
    with pytest.raises(ImportError, match=name):
        tcifar.load_dataset(name)


@pytest.mark.parametrize("seed", [0, 7])
def test_digits_seq_are_the_digits_scans(seed):
    """The same split and labels as ``digits``; each sequence is its scan's
    64 pixels in row order, the uint8 image's first channel at 4×."""
    pytest.importorskip("sklearn.datasets")
    (xs, ys), (xst, yst), info = tcifar.load_dataset("digits_seq_imb", seed=seed)
    (xi, yi), (xit, yit), _ = tcifar.load_dataset("digits_imb", seed=seed)
    np.testing.assert_array_equal(ys, yi)
    np.testing.assert_array_equal(yst, yit)
    scans = xi[:, ::4, ::4, 0].reshape(len(xi), 64)
    np.testing.assert_array_equal((xs[..., 0] * 255.0).astype(np.uint8), scans)
    np.testing.assert_allclose(info["mean"], [xs.mean()], rtol=1e-5)


@pytest.mark.parametrize("dataset", SEQUENCE_DATASETS)
@pytest.mark.parametrize("model", SEQUENCE_MODELS)
def test_config_accepts_the_sequence_family(model, dataset):
    cfg = TrainConfig(model=model, dataset=dataset, world_size=1, augmentation="none")
    assert (cfg.model, cfg.dataset) == (model, dataset)


def test_config_lists_every_jax_name():
    """Every model and dataset name of the JAX package's ``create_model``
    and ``load_dataset`` that the port builds."""
    assert set(SEQUENCE_MODELS) | {"vit"} <= set(_MODELS)
    assert set(SEQUENCE_DATASETS) <= set(_DATASETS)
    assert not hasattr(tcifar, "SEQUENCE_DATASETS")
