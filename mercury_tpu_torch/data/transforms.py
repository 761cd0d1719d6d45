"""The IID-path transforms: the PyTorch counterpart of
``mercury_tpu/data/transforms.py``.

Train: resize to 35, random crop to 32, horizontal flip, then a random
rotation and isotropic scale about the centre (``RandomAffine(10,
scale=(0.9, 1.1))``). Evaluation: resize to 33, random crop to 32. Plain
whole-batch tensor functions on NHWC float32 images. As everywhere in the
port, the random numbers are inputs (crop offsets, flips, angles, scales),
so a test can feed in the JAX package's draws; the random crop without
padding and the cutout live beside the other crops in ``data/pipeline.py``,
as in the JAX package, and are re-exported here.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from mercury_tpu_torch.data.pipeline import (
    cutout_batch,
    hflip_batch,
    random_crop_to_batch,
)

IID_RESIZE = 35       # the train transform's resize
EVAL_RESIZE = 33      # the evaluation transform's resize
IID_CROP = 32         # both crop back to the CIFAR size
MAX_ROTATE_DEG = 10.0
SCALE_RANGE = (0.9, 1.1)

__all__ = ["resize_batch", "affine_batch", "augment_batch_iid", "eval_transform_iid",
           "random_crop_to_batch", "cutout_batch"]


def resize_batch(images: torch.Tensor, size: int) -> torch.Tensor:
    """Bilinear resize of ``[N, H, W, C]`` to ``size×size`` with half-pixel
    centres (``transforms.Resize``), as ``jax.image.resize(...,
    "bilinear")`` upsamples: at the edges JAX renormalizes its triangle
    kernel over the taps inside the image and ATen clamps the source
    coordinate, and for upsampling both give the edge pixel."""
    x = images.permute(0, 3, 1, 2)
    out = F.interpolate(x, size=(size, size), mode="bilinear", align_corners=False,
                        antialias=False)
    return out.permute(0, 2, 3, 1)


def affine_batch(images: torch.Tensor, theta: torch.Tensor,
                 scale: torch.Tensor) -> torch.Tensor:
    """Rotate image ``i`` by ``theta[i]`` radians and scale it by
    ``scale[i]`` about its centre: inverse-mapped bilinear resampling, each
    of the four neighbours clamped to the image on its own (edge
    replication), in the JAX function's float32 order of operations."""
    n, h, w, c = images.shape
    dev = images.device
    cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
    ys, xs = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=dev),
                            torch.arange(w, dtype=torch.float32, device=dev),
                            indexing="ij")
    yc, xc = (ys - cy)[None], (xs - cx)[None]                # [1, h, w]
    cos_t = torch.cos(theta)[:, None, None]
    sin_t = torch.sin(theta)[:, None, None]
    inv = (1.0 / scale)[:, None, None]
    src_y = (cos_t * yc + sin_t * xc) * inv + cy             # [n, h, w]
    src_x = (-sin_t * yc + cos_t * xc) * inv + cx
    y0 = torch.floor(src_y)
    x0 = torch.floor(src_x)
    wy = (src_y - y0)[..., None]
    wx = (src_x - x0)[..., None]
    # Each neighbour clamped from the unclamped floor: far outside, both
    # collapse onto the same edge row or column.
    y0l, x0l = y0.to(torch.int32), x0.to(torch.int32)
    y0i, y1i = y0l.clamp(0, h - 1), (y0l + 1).clamp(0, h - 1)
    x0i, x1i = x0l.clamp(0, w - 1), (x0l + 1).clamp(0, w - 1)
    flat = images.reshape(n, h * w, c)

    def sample(yi, xi):
        idx = (yi.long() * w + xi.long()).reshape(n, h * w, 1).expand(n, h * w, c)
        return torch.gather(flat, 1, idx).reshape(n, h, w, c)

    return ((1 - wy) * (1 - wx) * sample(y0i, x0i)
            + (1 - wy) * wx * sample(y0i, x1i)
            + wy * (1 - wx) * sample(y1i, x0i)
            + wy * wx * sample(y1i, x1i))


def augment_batch_iid(images: torch.Tensor, crop: torch.Tensor, flip: torch.Tensor,
                      theta: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """The IID train transform: resize to 35, crop to 32 at ``crop``
    ``[N, 2]`` offsets in ``[0, 3]``, flip where ``flip``, then rotate by
    ``theta`` (radians) and scale by ``scale``."""
    out = resize_batch(images, IID_RESIZE)
    out = random_crop_to_batch(out, crop[:, 0], crop[:, 1], IID_CROP)
    out = hflip_batch(out, flip)
    return affine_batch(out, theta, scale)


def eval_transform_iid(images: torch.Tensor, crop: torch.Tensor) -> torch.Tensor:
    """The IID evaluation transform: resize to 33, crop to 32 at ``crop``
    ``[N, 2]`` offsets in ``[0, 1]``."""
    out = resize_batch(images, EVAL_RESIZE)
    return random_crop_to_batch(out, crop[:, 0], crop[:, 1], IID_CROP)
