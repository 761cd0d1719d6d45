"""A directory of images as a dataset: ``root/<class>/<image>``.

A copy of ``mercury_tpu/data/imagefolder.py`` (the port imports nothing
from the JAX package; the two give the same arrays from the same folder,
test-enforced). The sample order is the global index the sampler scores:
classes sorted, files sorted within a class. Images are uint8 NHWC,
resized to a square of ``image_size``; labels int32. PIL is needed only
to decode, and is imported there.
"""

from __future__ import annotations

import os
from typing import List, Optional, Tuple

import numpy as np

IMG_EXTENSIONS = (".jpg", ".jpeg", ".png", ".ppm", ".bmp", ".pgm", ".tif",
                  ".tiff", ".webp")


def pil_to_numpy(img) -> np.ndarray:
    """A PIL image → ``[H, W, 3]`` uint8."""
    return np.asarray(img.convert("RGB"), dtype=np.uint8)


def load_image(path: str, size: Optional[int]) -> np.ndarray:
    """Decode one image, resized to ``size × size`` when ``size`` is set
    (PIL's default filter, as the JAX package resizes)."""
    from PIL import Image

    with Image.open(path) as img:
        if size is not None:
            img = img.resize((size, size))
        return pil_to_numpy(img)


def find_classes(root: str) -> List[str]:
    """The sorted names of the class subdirectories."""
    return sorted(d for d in os.listdir(root) if os.path.isdir(os.path.join(root, d)))


def list_image_folder(root: str) -> Tuple[List[str], np.ndarray, List[str]]:
    """``(paths, labels, class_names)`` of ``root/<class>/<image>`` without
    decoding, in the order :func:`load_image_folder` decodes."""
    classes = find_classes(root)
    if not classes:
        raise FileNotFoundError(f"no class subdirectories under {root!r}")
    paths, labels = [], []
    for label, cls in enumerate(classes):
        cdir = os.path.join(root, cls)
        for fname in sorted(os.listdir(cdir)):
            if os.path.splitext(fname)[1].lower() in IMG_EXTENSIONS:
                paths.append(os.path.join(cdir, fname))
                labels.append(label)
    if not paths:
        raise FileNotFoundError(f"no images with {IMG_EXTENSIONS} under {root!r}")
    return paths, np.asarray(labels, np.int32), classes


def load_image_folder(root: str, image_size: Optional[int] = 32
                      ) -> Tuple[np.ndarray, np.ndarray, List[str]]:
    """Decode ``root/<class>/<image>`` into ``(images, labels,
    class_names)``."""
    paths, labels, classes = list_image_folder(root)
    return np.stack([load_image(p, image_size) for p in paths]), labels, classes


def load_imagefolder_dataset(root: str, image_size: Optional[int] = 32,
                             test_fraction: float = 0.1, seed: int = 0):
    """``(train, test, info)`` of a folder: ``root/train/<class>/...`` and
    ``root/test/<class>/...`` when both exist, else ``root/<class>/...``
    split ``1 − test_fraction`` / ``test_fraction`` by a permutation from
    ``seed``. The normalization statistics are the train split's."""
    train_dir, test_dir = os.path.join(root, "train"), os.path.join(root, "test")
    if os.path.isdir(train_dir) and os.path.isdir(test_dir):
        x_tr, y_tr, classes = load_image_folder(train_dir, image_size)
        x_te, y_te, test_classes = load_image_folder(test_dir, image_size)
        if test_classes != classes:
            raise ValueError(f"train/test class mismatch: {classes} vs {test_classes}")
    else:
        x, y, classes = load_image_folder(root, image_size)
        perm = np.random.default_rng(seed).permutation(len(x))
        n_test = max(int(len(x) * test_fraction), 1)
        te, tr = perm[:n_test], perm[n_test:]
        x_tr, y_tr, x_te, y_te = x[tr], y[tr], x[te], y[te]
    scaled = x_tr.astype(np.float32) / 255.0
    mean = scaled.mean(axis=(0, 1, 2))
    std = scaled.std(axis=(0, 1, 2)) + 1e-6
    return (x_tr, y_tr), (x_te, y_te), {
        "num_classes": len(classes), "classes": classes, "mean": mean, "std": std,
        "synthetic": False}
