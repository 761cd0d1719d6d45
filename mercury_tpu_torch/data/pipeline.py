"""On-device data pipeline: the dataset on the device (uint8 images or
float32 sequences), batches gathered by index inside the step,
augmentation as whole-batch tensor ops, and per-worker presampling
streams.

The PyTorch counterpart of ``mercury_tpu/data/pipeline.py``. Images keep
the JAX package's NHWC layout through this module, so its functions compare
with the JAX ones directly; the model takes the NCHW view
(``images.permute(0, 3, 1, 2)``, which is channels_last in memory).

Random draws are inputs: crop offsets, flip bits and reshuffle
permutations come from the caller (the step's ``torch.Generator``, or a
test replaying the JAX package's draws), because torch's Philox stream and
JAX's threefry never give the same numbers.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, NamedTuple, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

CUTOUT_LENGTH = 16  # the side of the cutout square


def normalize_images(images: torch.Tensor, mean, std) -> torch.Tensor:
    """uint8 NHWC → normalized float32 (``ToTensor`` + ``Normalize``); mean
    and std broadcast over the trailing channel axis."""
    if images.dtype == torch.uint8:
        x = images.to(torch.float32) / 255.0
    else:
        x = images.to(torch.float32)
    mean_t = torch.as_tensor(mean, dtype=torch.float32, device=x.device)
    std_t = torch.as_tensor(std, dtype=torch.float32, device=x.device)
    return (x - mean_t) / std_t


def _take_crops(images: torch.Tensor, oy: torch.Tensor, ox: torch.Tensor,
                out_h: int, out_w: int) -> torch.Tensor:
    """Crop image ``i`` of ``[N, H, W, C]`` at its own offset
    ``(oy[i], ox[i])``, for the whole batch in one gather."""
    dev = images.device
    idx_y = oy[:, None] + torch.arange(out_h, device=dev)[None, :]  # [N, h]
    idx_x = ox[:, None] + torch.arange(out_w, device=dev)[None, :]  # [N, w]
    n_idx = torch.arange(images.shape[0], device=dev)[:, None, None]
    return images[n_idx, idx_y[:, :, None], idx_x[:, None, :]]


def random_crop_batch(images: torch.Tensor, offsets: torch.Tensor,
                      pad: int) -> torch.Tensor:
    """Zero-pad by ``pad``, then crop back to the input size at the given
    per-image offsets ``[N, 2]`` in ``[0, 2·pad]`` (``RandomCrop(32,
    padding=4)``)."""
    _, h, w, _ = images.shape
    padded = F.pad(images, (0, 0, pad, pad, pad, pad))
    offsets = offsets.to(torch.long)
    return _take_crops(padded, offsets[:, 0], offsets[:, 1], h, w)


def random_crop_to_batch(images: torch.Tensor, oy: torch.Tensor, ox: torch.Tensor,
                         out: int) -> torch.Tensor:
    """Crop ``[N, H, W, C]`` down to ``out×out`` at the per-image offsets
    ``oy``, ``ox`` in ``[0, H − out]``, without padding (the IID path crops
    a larger resized image)."""
    return _take_crops(images, oy.to(torch.long), ox.to(torch.long), out, out)


def hflip_batch(images: torch.Tensor, flip: torch.Tensor) -> torch.Tensor:
    """Flip image ``i`` horizontally where ``flip[i]`` is set."""
    flip = flip.to(torch.bool)[:, None, None, None]
    return torch.where(flip, images.flip(2), images)


def cutout_batch(images: torch.Tensor, centres: torch.Tensor,
                 length: int = CUTOUT_LENGTH) -> torch.Tensor:
    """Zero a ``length×length`` square of image ``i`` centred on
    ``centres[i] = (cy, cx)`` (rows ``[cy − length/2, cy + length/2)``),
    clipped at the borders (``Cutout``)."""
    _, h, w, _ = images.shape
    dev = images.device
    half = length // 2
    cy, cx = (centres[:, k].to(torch.long)[:, None, None] for k in (0, 1))
    ys = torch.arange(h, device=dev)[None, :, None]
    xs = torch.arange(w, device=dev)[None, None, :]
    mask = (ys >= cy - half) & (ys < cy + half) & (xs >= cx - half) & (xs < cx + half)
    return torch.where(mask[..., None], 0.0, images)


def augment_batch(images: torch.Tensor, offsets: torch.Tensor,
                  flip: torch.Tensor, pad: int = 4,
                  cut: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Train-time augmentation: random crop (pad 4), then horizontal flip,
    then, given cutout centres ``cut``, cutout — bit-identical at float32 to
    ``mercury_tpu.data.pipeline.augment_batch`` given the offsets, flips and
    centres that function draws."""
    out = hflip_batch(random_crop_batch(images, offsets, pad), flip)
    return out if cut is None else cutout_batch(out, cut)


class ShardStream(NamedTuple):
    """One worker's wrapping, shuffled presampling stream: the epoch's
    permutation of shard slots on the device, and the cursor on the host
    (so deciding on a reshuffle never waits for the device)."""

    perm: torch.Tensor  # [L] int64 — current permutation of shard slots
    cursor: int         # next unread slot


def next_pool(
    stream: ShardStream,
    pool_size: int,
    new_perm: Callable[[], torch.Tensor],
) -> Tuple[ShardStream, torch.Tensor]:
    """The next ``pool_size`` slots of the stream. When fewer than
    ``pool_size`` remain, the stream restarts from a fresh permutation
    ``new_perm()`` (called only then)."""
    length = stream.perm.shape[0]
    perm, cursor = stream.perm, stream.cursor
    if cursor + pool_size > length:
        perm = new_perm().to(device=stream.perm.device, dtype=torch.long)
        if perm.shape != stream.perm.shape:
            raise ValueError(
                f"reshuffle permutation has shape {tuple(perm.shape)}, "
                f"stream needs ({length},)"
            )
        cursor = 0
    slots = perm[cursor:cursor + pool_size]
    return ShardStream(perm=perm, cursor=cursor + pool_size), slots


@dataclasses.dataclass
class ShardedDataset:
    """Device-resident dataset with per-worker shards; shards of unequal
    length are tiled cyclically to the longest, as in the JAX package.

    ``rank`` is the worker whose shard this process trains on. With
    ``data_placement="sharded"`` only that shard's rows are on the device
    (``x_shard``/``y_shard``, indexed by slot), and ``x_train``/``y_train``
    stay on the host for evaluation. With ``"host_stream"`` ``x_train`` is
    the host array itself (numpy or ``np.memmap``, never copied to the
    device), and the labels and shard indices are on the device."""

    x_train: Union[torch.Tensor, np.ndarray]  # [N, H, W, C] uint8 or [N, T, F] float32
    y_train: torch.Tensor        # [N] int32
    x_test: torch.Tensor         # [Nt, ...] as x_train
    y_test: torch.Tensor         # [Nt] int32
    shard_indices: torch.Tensor  # [W, L] int64 — global ids, cyclically padded
    shard_sizes: torch.Tensor    # [W] int64 — true shard lengths
    mean: np.ndarray
    std: np.ndarray
    num_classes: int
    synthetic: bool = True
    rank: int = 0
    x_shard: Optional[torch.Tensor] = None  # [L, ...] as x_train (sharded placement)
    y_shard: Optional[torch.Tensor] = None  # [L] int32 (sharded placement)

    @property
    def host_pixels(self) -> bool:
        """The train pixels are a host numpy array (host_stream)."""
        return isinstance(self.x_train, np.ndarray)

    @property
    def n_train(self) -> int:
        return int(self.x_train.shape[0])

    @property
    def n_workers(self) -> int:
        return int(self.shard_indices.shape[0])

    @property
    def shard_len(self) -> int:
        return int(self.shard_indices.shape[1])


def make_sharded_dataset(
    train: Tuple[np.ndarray, np.ndarray],
    test: Tuple[np.ndarray, np.ndarray],
    shards: List[np.ndarray],
    mean: np.ndarray,
    std: np.ndarray,
    num_classes: int,
    device: torch.device,
    synthetic: bool = True,
    rank: int = 0,
    placement: str = "replicated",
) -> ShardedDataset:
    """Put the host arrays on ``device`` and build the ``[W, L]`` shard
    index matrix, for worker ``rank``. ``placement="sharded"`` puts only
    that worker's ``L`` rows and labels on the device (the JAX package's
    ``worker_shard_global_arrays`` row) and leaves the train split on the
    host; ``"host_stream"`` leaves the train pixels where they are, a host
    array (an ``np.memmap`` stays one), and puts the labels on the
    device."""
    if placement not in ("replicated", "sharded", "host_stream"):
        raise ValueError(f"unknown placement {placement!r}")
    if not 0 <= rank < len(shards):
        raise ValueError(f"rank {rank} of {len(shards)} shards")
    max_len = max(len(s) for s in shards)
    rows = np.stack([np.tile(s, int(np.ceil(max_len / len(s))))[:max_len]
                     for s in shards])

    def put(a, dtype, dev=device):
        return torch.as_tensor(np.asarray(a), dtype=dtype).to(dev)

    def rows_dtype(a) -> torch.dtype:
        return torch.uint8 if np.asarray(a).dtype == np.uint8 else torch.float32

    sharded = placement == "sharded"
    train_dev = torch.device("cpu") if sharded else device
    if placement == "host_stream":
        x_train = train[0] if isinstance(train[0], np.ndarray) else np.asarray(train[0])
        if x_train.dtype != np.uint8:
            raise ValueError(f"host_stream streams uint8 rows, got {x_train.dtype}")
    else:
        x_train = put(train[0], rows_dtype(train[0]), train_dev)
    return ShardedDataset(
        x_train=x_train,
        y_train=put(train[1], torch.int32, train_dev),
        x_test=put(test[0], rows_dtype(test[0])),
        y_test=put(test[1], torch.int32),
        shard_indices=put(rows, torch.long),
        shard_sizes=put([len(s) for s in shards], torch.long),
        mean=mean,
        std=std,
        num_classes=num_classes,
        synthetic=synthetic,
        rank=rank,
        x_shard=(put(np.asarray(train[0])[rows[rank]], rows_dtype(train[0])) if sharded
                 else None),
        y_shard=put(np.asarray(train[1])[rows[rank]], torch.int32) if sharded else None,
    )


def init_shard_streams(generator: torch.Generator, n_workers: int,
                       shard_len: int) -> List[ShardStream]:
    """Initial stream of each worker: a fresh permutation, cursor 0. The
    permutations are drawn on the generator's device."""
    return [
        ShardStream(
            perm=torch.randperm(shard_len, generator=generator,
                                device=generator.device),
            cursor=0,
        )
        for _ in range(n_workers)
    ]


def eval_batches(n: int, batch_size: int) -> List[Tuple[np.ndarray, int]]:
    """Fixed-size eval batching plan: ``(index array, valid count)`` per
    batch; the last batch wraps and its padding is masked by the count."""
    out = []
    for start in range(0, n, batch_size):
        end = min(start + batch_size, n)
        idx = np.arange(start, start + batch_size) % n
        out.append((idx.astype(np.int64), end - start))
    return out
