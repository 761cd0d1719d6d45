"""CIFAR-10 and CIFAR-100 ingest to host arrays, the deterministic
synthetic stand-ins, scikit-learn's handwritten digits and the sequence
datasets.

A copy of ``mercury_tpu/data/cifar.py`` (``cifar10``, ``cifar100``,
``synthetic``, ``synthetic_tail``, ``synthetic_hard``, ``digits``,
``digits_imb``, ``digits_seq``, ``digits_seq_imb``, ``synthetic_seq``,
``synthetic_seq_hard``): the port imports nothing from the JAX package, and
the two must produce the same bytes from the same seed and search the same
directories (test-enforced). Images are uint8 NHWC, sequences float32
``[N, T, F]``, labels int32.
"""

from __future__ import annotations

import os
import pickle
import tarfile
import warnings
from typing import Optional, Tuple

import numpy as np

CIFAR10_MEAN = np.array([0.49139968, 0.48215827, 0.44653124], np.float32)
CIFAR10_STD = np.array([0.24703233, 0.24348505, 0.26158768], np.float32)
CIFAR100_MEAN = np.array([0.5071, 0.4865, 0.4409], np.float32)
CIFAR100_STD = np.array([0.2673, 0.2564, 0.2762], np.float32)

# Searched after an explicit directory and $MERCURY_TPU_DATA. An archive is
# unpacked only under those two, never under a shared default such as /tmp.
_SEARCH_DIRS = ("data", os.path.expanduser("~/.cache/mercury_tpu"), "/tmp/mercury_tpu_data")

Split = Tuple[np.ndarray, np.ndarray]

# The synthetic variants: (num_classes, difficulty, label_noise).
# synthetic_hard is the sample-efficiency task (a heavy tail of hard
# samples, 5% train-label noise); synthetic_tail the same tail with clean
# labels.
_SYNTH = {
    "synthetic": (10, "uniform", 0.0),
    "synthetic_tail": (20, "heavy_tail", 0.0),
    "synthetic_hard": (20, "heavy_tail", 0.05),
}


def _load_pickle_batches(batch_dir: str, files, label_key: str) -> Split:
    xs, ys = [], []
    for name in files:
        with open(os.path.join(batch_dir, name), "rb") as f:
            d = pickle.load(f, encoding="latin1")
        xs.append(d["data"])
        ys.append(np.asarray(d[label_key], np.int32))
    x = np.concatenate(xs).reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
    return np.ascontiguousarray(x, np.uint8), np.concatenate(ys)


def _try_load(root: str, extract: bool, batch_dir: str, archive: str, train_files,
              test_files, label_key: str, npz_name: str) -> Optional[Tuple[Split, Split]]:
    """The pickled batches under ``root/batch_dir`` (extracted from
    ``archive`` first if only that is there and ``extract``), else
    ``root/npz_name``."""
    bdir = os.path.join(root, batch_dir)
    if extract and not os.path.isdir(bdir):
        tgz = os.path.join(root, archive)
        if os.path.isfile(tgz):
            with tarfile.open(tgz) as tf:
                tf.extractall(root, filter="data")
    if os.path.isdir(bdir):
        return (_load_pickle_batches(bdir, train_files, label_key),
                _load_pickle_batches(bdir, test_files, label_key))
    npz = os.path.join(root, npz_name)
    if os.path.isfile(npz):
        d = np.load(npz)
        return ((d["x_train"], d["y_train"].astype(np.int32)),
                (d["x_test"], d["y_test"].astype(np.int32)))
    return None


def _try_load_cifar10(root: str, extract: bool) -> Optional[Tuple[Split, Split]]:
    return _try_load(root, extract, "cifar-10-batches-py", "cifar-10-python.tar.gz",
                     [f"data_batch_{i}" for i in range(1, 6)], ["test_batch"],
                     "labels", "cifar10.npz")


def _try_load_cifar100(root: str, extract: bool) -> Optional[Tuple[Split, Split]]:
    return _try_load(root, extract, "cifar-100-python", "cifar-100-python.tar.gz",
                     ["train"], ["test"], "fine_labels", "cifar100.npz")


def synthetic_cifar(
    num_classes: int = 10,
    train_size: int = 5000,
    test_size: int = 1000,
    image_size: int = 32,
    seed: int = 0,
    difficulty: str = "uniform",
    label_noise: float = 0.0,
) -> Tuple[Split, Split]:
    """Deterministic learnable stand-in for CIFAR: each class is a fixed
    random low-frequency template, each sample that template plus noise at
    a per-sample scale, so per-sample difficulty varies and importance
    sampling has signal.

    ``difficulty="heavy_tail"`` draws the noise scale from a clipped
    lognormal (most samples easy, a long tail very hard) and normalizes
    each sample by its own min and max, so the tail does not crush every
    sample's contrast. ``label_noise`` flips that share of the train
    labels to another class; the test labels stay clean."""
    rng = np.random.default_rng(seed)
    small = rng.normal(0, 1, (num_classes, 4, 4, 3)).astype(np.float32)
    reps = image_size // 4
    templates = np.repeat(np.repeat(small, reps, axis=1), reps, axis=2)

    def make(n, offset, noisy_labels: bool):
        local = np.random.default_rng(seed + offset)
        y = local.integers(0, num_classes, n).astype(np.int32)
        if difficulty == "heavy_tail":
            noise_scale = np.clip(
                local.lognormal(-0.3, 1.0, (n, 1, 1, 1)), 0.1, 8.0).astype(np.float32)
        elif difficulty == "uniform":
            noise_scale = local.uniform(0.3, 1.5, (n, 1, 1, 1)).astype(np.float32)
        else:
            raise ValueError(f"unknown difficulty {difficulty!r}")
        noise = local.normal(
            0, 1, (n, image_size, image_size, 3)).astype(np.float32)
        x = templates[y] + noise_scale * noise
        if difficulty == "heavy_tail":
            lo = x.min(axis=(1, 2, 3), keepdims=True)
            hi = x.max(axis=(1, 2, 3), keepdims=True)
            x = (x - lo) / (hi - lo + 1e-8)
        else:
            x = (x - x.min()) / (x.max() - x.min() + 1e-8)
        if noisy_labels and label_noise > 0.0:
            flip = local.random(n) < label_noise
            shift = local.integers(1, num_classes, n).astype(np.int32)
            y = np.where(flip, (y + shift) % num_classes, y).astype(np.int32)
        return (x * 255).astype(np.uint8), y

    return make(train_size, 1, True), make(test_size, 2, False)


def synthetic_sequences(
    num_classes: int = 10,
    train_size: int = 5000,
    test_size: int = 1000,
    seq_len: int = 32,
    feature_dim: int = 16,
    seed: int = 0,
    difficulty: str = "uniform",
) -> Tuple[Split, Split]:
    """Deterministic learnable float32 sequences ``[N, T, F]``: each class
    a fixed random frequency and phase per feature channel, each sample
    that pattern plus noise at a per-sample scale.

    ``difficulty="hard_minority"``: 85% of the samples carry the pattern
    over the whole sequence, 15% only in the last ``max(T // 5, 2)`` steps
    (zero elsewhere) at 0.6 of the amplitude, all at noise scale 0.25."""
    rng = np.random.default_rng(seed)
    freqs = rng.uniform(0.5, 4.0, (num_classes, feature_dim)).astype(np.float32)
    phases = rng.uniform(0, 2 * np.pi, (num_classes, feature_dim)).astype(np.float32)
    t = np.arange(seq_len, dtype=np.float32)[None, :, None]  # [1, T, 1]

    def make(n, offset):
        local = np.random.default_rng(seed + offset)
        y = local.integers(0, num_classes, n).astype(np.int32)
        base = np.sin(2 * np.pi * freqs[y][:, None, :] * t / seq_len
                      + phases[y][:, None, :])  # [n, T, F]
        if difficulty == "hard_minority":
            hard = local.random(n) < 0.15
            win = max(seq_len // 5, 2)
            window = (np.arange(seq_len) >= seq_len - win)[None, :, None]
            keep = np.where(hard[:, None, None], window, True)
            base = np.where(keep, base, 0.0)
            base = np.where(hard[:, None, None], 0.6 * base, base)
            noise_scale = np.full((n, 1, 1), 0.25, np.float32)
        else:
            noise_scale = local.uniform(0.2, 1.0, (n, 1, 1)).astype(np.float32)
        noise = local.normal(0, 1, (n, seq_len, feature_dim)).astype(np.float32)
        return (base + noise_scale * noise).astype(np.float32), y

    return make(train_size, 1), make(test_size, 2)


def load_digits(name: str, seed: int = 0) -> Tuple[Split, Split, dict]:
    """scikit-learn's 1,797 real 8×8 handwritten digits, split 80/20 by a
    permutation from ``seed``: ``digits`` upscaled to 32×32×3 uint8,
    ``digits_seq`` each scan as its raw length-64 scanline ``[64, 1]``
    float32 in [0, 1]. ``*_imb`` keeps ``max(round(0.1·n), 8)`` of the
    train samples of each of classes 5-9; the test split stays balanced.
    The normalization ``mean``/``std`` are the train split's (per channel
    for the images, one scalar of shape ``(1,)`` for the sequences)."""
    try:
        from sklearn.datasets import load_digits as _load_digits
    except ImportError as e:
        raise ImportError(f"dataset {name!r} needs scikit-learn, which ships the "
                          "digits; it is not installed") from e

    d = _load_digits()
    labels = d.target.astype(np.int32)
    rng = np.random.default_rng(seed)
    order = rng.permutation(len(labels))
    n_test = len(labels) // 5
    test_idx, train_idx = order[:n_test], order[n_test:]
    if name.endswith("_imb"):
        ytr = labels[train_idx]
        keep = np.ones(len(train_idx), bool)
        for c in range(5, 10):
            idx = np.where(ytr == c)[0]
            n_keep = max(int(round(0.1 * len(idx))), 8)
            keep[rng.permutation(idx)[n_keep:]] = False
        train_idx = train_idx[keep]
    info = {"num_classes": 10, "synthetic": False}
    if name.startswith("digits_seq"):
        x = (d.images / d.images.max()).astype(np.float32).reshape(len(labels), 64, 1)
        mean = x[train_idx].mean(keepdims=False).reshape(1).astype(np.float32)
        std = np.maximum(x[train_idx].std(), 1e-3).reshape(1).astype(np.float32)
        return ((x[train_idx], labels[train_idx]), (x[test_idx], labels[test_idx]),
                {**info, "mean": mean, "std": std})
    imgs = (d.images / d.images.max() * 255.0).astype(np.uint8)
    imgs = np.repeat(np.repeat(imgs, 4, axis=1), 4, axis=2)  # 8→32
    imgs = np.repeat(imgs[..., None], 3, axis=-1)            # gray→RGB
    flat = imgs[train_idx].astype(np.float32) / 255.0
    mean = flat.mean(axis=(0, 1, 2)).astype(np.float32)
    std = np.maximum(flat.std(axis=(0, 1, 2)), 1e-3).astype(np.float32)
    return ((imgs[train_idx], labels[train_idx]), (imgs[test_idx], labels[test_idx]),
            {**info, "mean": mean, "std": std})


def find_data_dir(explicit: Optional[str] = None) -> Optional[str]:
    """Resolve the dataset root: explicit argument, then
    ``$MERCURY_TPU_DATA``, then the first of ``_SEARCH_DIRS`` that
    exists."""
    for c in (explicit, os.environ.get("MERCURY_TPU_DATA"), *_SEARCH_DIRS):
        if c and os.path.isdir(c):
            return c
    return None


def load_dataset(
    name: str = "cifar10",
    data_dir: Optional[str] = None,
    allow_synthetic: bool = True,
    synthetic_train_size: int = 5000,
    synthetic_test_size: int = 1000,
    seed: int = 0,
) -> Tuple[Split, Split, dict]:
    """Load ``(x_train, y_train), (x_test, y_test), info``; ``info`` holds
    ``num_classes``, the normalization ``mean``/``std`` and whether the
    data is synthetic."""
    name = name.lower()
    if name in _SYNTH:
        num_classes, difficulty, label_noise = _SYNTH[name]
        train, test = synthetic_cifar(
            num_classes, synthetic_train_size, synthetic_test_size, seed=seed,
            difficulty=difficulty, label_noise=label_noise)
        return train, test, {"num_classes": num_classes, "mean": CIFAR10_MEAN,
                             "std": CIFAR10_STD, "synthetic": True}
    if name in ("digits", "digits_imb", "digits_seq", "digits_seq_imb"):
        return load_digits(name, seed)
    if name in ("synthetic_seq", "synthetic_seq_hard"):
        train, test = synthetic_sequences(
            10, synthetic_train_size, synthetic_test_size, seed=seed,
            difficulty="hard_minority" if name == "synthetic_seq_hard" else "uniform")
        # Float sequences: the normalization is the identity.
        return train, test, {"num_classes": 10, "mean": np.zeros((1,), np.float32),
                             "std": np.ones((1,), np.float32), "synthetic": True}
    if name not in ("cifar10", "cifar100"):
        raise ValueError(f"unknown dataset {name!r}")
    num_classes, mean, std, loader = (
        (10, CIFAR10_MEAN, CIFAR10_STD, _try_load_cifar10) if name == "cifar10"
        else (100, CIFAR100_MEAN, CIFAR100_STD, _try_load_cifar100))
    info = {"num_classes": num_classes, "mean": mean, "std": std}
    root = find_data_dir(data_dir)
    named = root in (data_dir, os.environ.get("MERCURY_TPU_DATA"))
    loaded = loader(root, named) if root is not None else None
    if loaded is not None:
        train, test = loaded
        return train, test, {**info, "synthetic": False}
    if not allow_synthetic:
        raise FileNotFoundError(
            f"no {name} data found under {root or _SEARCH_DIRS}; "
            "set MERCURY_TPU_DATA")
    warnings.warn(
        f"no {name} data found on disk — substituting the deterministic "
        "synthetic dataset. Set MERCURY_TPU_DATA (or pass data_dir) to "
        "train on real data, or allow_synthetic=False to make this an "
        "error.",
        stacklevel=2,
    )
    train, test = synthetic_cifar(
        num_classes, synthetic_train_size, synthetic_test_size, seed=seed)
    return train, test, {**info, "synthetic": True}
