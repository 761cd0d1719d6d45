"""CIFAR-10 ingest to host arrays, and the deterministic synthetic stand-in.

A copy of the ``synthetic`` and ``cifar10`` branches of
``mercury_tpu/data/cifar.py``: the port imports nothing from the JAX
package, and the two must produce the same bytes from the same seed
(test-enforced). Images are uint8 NHWC, labels int32.
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

Split = Tuple[np.ndarray, np.ndarray]


def _load_pickle_batches(batch_dir: str, files, label_key: str) -> Split:
    xs, ys = [], []
    for name in files:
        with open(os.path.join(batch_dir, name), "rb") as f:
            d = pickle.load(f, encoding="latin1")
        xs.append(d["data"])
        ys.append(np.asarray(d[label_key], np.int32))
    x = np.concatenate(xs).reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
    return np.ascontiguousarray(x, np.uint8), np.concatenate(ys)


def _try_load_cifar10(root: str) -> Optional[Tuple[Split, Split]]:
    bdir = os.path.join(root, "cifar-10-batches-py")
    if not os.path.isdir(bdir):
        tgz = os.path.join(root, "cifar-10-python.tar.gz")
        if os.path.isfile(tgz):
            with tarfile.open(tgz) as tf:
                tf.extractall(root)
    if os.path.isdir(bdir):
        train = _load_pickle_batches(
            bdir, [f"data_batch_{i}" for i in range(1, 6)], "labels")
        test = _load_pickle_batches(bdir, ["test_batch"], "labels")
        return train, test
    npz = os.path.join(root, "cifar10.npz")
    if os.path.isfile(npz):
        d = np.load(npz)
        return ((d["x_train"], d["y_train"].astype(np.int32)),
                (d["x_test"], d["y_test"].astype(np.int32)))
    return None


def synthetic_cifar(
    num_classes: int = 10,
    train_size: int = 5000,
    test_size: int = 1000,
    image_size: int = 32,
    seed: int = 0,
) -> Tuple[Split, Split]:
    """Deterministic learnable stand-in for CIFAR: each class is a fixed
    random low-frequency template, each sample that template plus noise at
    a per-sample scale, so per-sample difficulty varies and importance
    sampling has signal."""
    rng = np.random.default_rng(seed)
    small = rng.normal(0, 1, (num_classes, 4, 4, 3)).astype(np.float32)
    reps = image_size // 4
    templates = np.repeat(np.repeat(small, reps, axis=1), reps, axis=2)

    def make(n, offset):
        local = np.random.default_rng(seed + offset)
        y = local.integers(0, num_classes, n).astype(np.int32)
        noise_scale = local.uniform(0.3, 1.5, (n, 1, 1, 1)).astype(np.float32)
        noise = local.normal(
            0, 1, (n, image_size, image_size, 3)).astype(np.float32)
        x = templates[y] + noise_scale * noise
        x = (x - x.min()) / (x.max() - x.min() + 1e-8)
        return (x * 255).astype(np.uint8), y

    return make(train_size, 1), make(test_size, 2)


def find_data_dir(explicit: Optional[str] = None) -> Optional[str]:
    """Resolve the dataset root: explicit argument, then
    ``$MERCURY_TPU_DATA``, then ``./data``."""
    for c in (explicit, os.environ.get("MERCURY_TPU_DATA"), "data"):
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
    if name == "synthetic":
        train, test = synthetic_cifar(
            10, synthetic_train_size, synthetic_test_size, seed=seed)
        return train, test, {"num_classes": 10, "mean": CIFAR10_MEAN,
                             "std": CIFAR10_STD, "synthetic": True}
    if name != "cifar10":
        raise ValueError(f"unknown dataset {name!r}")
    root = find_data_dir(data_dir)
    loaded = _try_load_cifar10(root) if root is not None else None
    if loaded is not None:
        train, test = loaded
        return train, test, {"num_classes": 10, "mean": CIFAR10_MEAN,
                             "std": CIFAR10_STD, "synthetic": False}
    if not allow_synthetic:
        raise FileNotFoundError(
            f"no cifar10 data found under {root or 'data'}; "
            "set MERCURY_TPU_DATA")
    warnings.warn(
        "no cifar10 data found on disk — substituting the deterministic "
        "synthetic dataset. Set MERCURY_TPU_DATA (or pass data_dir) to "
        "train on real data, or allow_synthetic=False to make this an "
        "error.",
        stacklevel=2,
    )
    train, test = synthetic_cifar(
        10, synthetic_train_size, synthetic_test_size, seed=seed)
    return train, test, {"num_classes": 10, "mean": CIFAR10_MEAN,
                         "std": CIFAR10_STD, "synthetic": True}
