"""Public wrappers of the port's CUDA kernels.

- :func:`per_sample_nll` — per-sample cross-entropy ``[N]`` of ``[N, C]``
  logits, differentiable: a ``torch.autograd.Function`` whose backward is
  the ``nll_bwd`` kernel (the TPU package's custom VJP).
- :func:`score_and_draw` — smoothing, normalization, inverse-CDF draw and
  ``p·N`` gather of the pool selection, in one kernel.
- :func:`table_refresh_draw` — the scoretable sampler's decay, scatter of
  the refresh window, normalization and draw over the whole table, in one
  kernel.
- :func:`augment_normalize` — the fused uint8 ingest: gather (``rows``),
  dequantize, normalize, crop and flip, in one kernel.

The two selections launch as one thread-block cluster (sm_90a), with the
geometry of :func:`draw_geometry`; they need no scratch tensor. The ingest
launches a block per image, with the geometry of :func:`ingest_geometry`.
Both NLL kernels give a row the lanes :func:`nll_geometry` chooses.

Each wrapper dispatches on the device of its tensors: a CUDA tensor goes to
the kernel (built at first use by ``ops/_build.py``), a CPU tensor to the
plain version in ``ops/reference.py``. There is no fallback: a CUDA tensor
the kernel does not take, a failed build or a refused launch raises.

``launch_counts`` counts kernel launches by name, one per launch and
nowhere else, so a run can show that its main path went through the
kernels; a thread inside :func:`counting_into` counts into another dict
instead (the scorer fleet counts its own, so ``launch_counts`` stays the
step's); :func:`reset_launch_counts` zeroes ``launch_counts``.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Dict, Iterator, NamedTuple, Optional, Tuple

import torch

from mercury_tpu_torch.ops import reference

KERNELS = ("nll_fwd", "nll_bwd", "score_and_draw", "table_refresh_draw",
           "augment_normalize")
launch_counts: Dict[str, int] = {k: 0 for k in KERNELS}
_counting = threading.local()   # .counts: this thread's dict, if not launch_counts
_count_lock = threading.Lock()

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

# The selection kernels' geometry (select_kernel in csrc/mercury_kernels.cu),
# from a sweep on the H100 (PERF.md §6).
RUN = 8                  # elements a thread holds, unless a block would need more threads
MAX_THREADS = 1024
ONE_BLOCK = RUN * MAX_THREADS  # n up to this is one block: no cluster
CLUSTER_SHARE = 4096     # elements a block of a cluster takes before K doubles
MAX_CLUSTER = 16         # the most the kernel takes; 8 is portable, 16 the card may refuse
REG_RUN = 16             # the longest run a thread holds in registers
MAX_RUNS = 32_768        # runs a block keeps prefixes of in shared memory
MAX_SMEM = 232_448       # dynamic shared memory a block can have on Hopper


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def _round_up(a: int, m: int) -> int:
    return _ceil_div(a, m) * m


class DrawGeometry(NamedTuple):
    clusters: int    # K blocks, one cluster
    threads: int     # threads a block
    per_block: int   # elements a block owns, a multiple of 4 (the last block fewer)
    run: int         # contiguous elements a run holds; thread t takes runs t, t + threads, ...
    smem: int        # dynamic shared memory bytes a block

    @property
    def tiles(self) -> int:
        """Runs a thread takes: one while its run is held in registers."""
        return _ceil_div(self.per_block, self.threads * self.run)

    @property
    def in_registers(self) -> bool:
        return self.tiles == 1 and self.run <= REG_RUN


def draw_geometry(n: int, refresh: Optional[int] = None,
                  max_cluster: int = MAX_CLUSTER) -> DrawGeometry:
    """Launch geometry of ``score_and_draw`` (``refresh=None``) or of
    ``table_refresh_draw`` with a window of ``refresh`` slots, over ``n``
    elements, with at most ``max_cluster`` blocks (what the card can
    schedule: :func:`cluster_limit`). Block k owns ``[k·per_block,
    (k+1)·per_block) ∩ [0, n)``, cut into runs of ``run`` elements; thread
    t takes runs t, t + threads, ... (``tiles`` of them).

    Up to 8192 elements (1024 threads of 8) are one block, with no
    cluster. Above, K is the power of two that gives each block at most
    about 4096 elements, up to ``max_cluster``. A run is 8, or up to 16 (a
    multiple of 4) where a block would need more than 1024 threads, held
    in registers. Past that, runs of 8 in several tiles are read from
    device memory, longer only where a block would have more than 32,768
    runs."""
    if n < 1:
        raise ValueError(f"the selection needs n >= 1, got {n}")
    clusters = 1
    if n > ONE_BLOCK:
        while 2 * clusters <= max_cluster and clusters * CLUSTER_SHARE < n:
            clusters *= 2
    per_block = _round_up(_ceil_div(n, clusters), 4)
    run = RUN
    if per_block > MAX_THREADS * RUN:
        run = _round_up(_ceil_div(per_block, MAX_THREADS), 4)
        if run > REG_RUN:
            run = max(RUN, _round_up(_ceil_div(per_block, MAX_RUNS), 4))
    threads = min(MAX_THREADS, _round_up(_ceil_div(per_block, run), 32))
    smem = draw_smem(threads, per_block, run, refresh)
    if smem > MAX_SMEM:
        raise ValueError(f"a refresh window of {refresh} needs {smem} bytes of shared "
                         f"memory, more than {MAX_SMEM}")
    return DrawGeometry(clusters, threads, per_block, run, smem)


def draw_smem(threads: int, per_block: int, run: int, refresh: Optional[int]) -> int:
    """Dynamic shared memory bytes of a selection block: the inclusive
    prefix over its runs and each warp's total in each tile; the block's
    staged probs (and first the refresh means) where runs are held in
    registers; the table's window."""
    tiles = _ceil_div(per_block, threads * run)
    smem = 4 * tiles * threads + 4 * tiles * (threads // 32)
    if tiles == 1 and run <= REG_RUN:
        smem += 4 * per_block
    if refresh is not None:
        smem += 8 * refresh  # the window's slots (as int) and scores
    return smem


# The ingest kernel's geometry (augment_normalize_kernel), from a sweep on
# the H100 (PERF.md §6).
INGEST_THREADS = 256     # threads a block
LEVELS = 256             # table entries a channel: every uint8 value
COPY_BYTES, COPY_BULK = 0, 1  # how a block stages its source rows
INGEST_MAX_SMEM = MAX_SMEM - 8  # less the block's static mbarrier
# Shapes (h, w, c) the kernel is specialized for; it stages their output
# in shared memory (ingest_specialized() in the CUDA source).
INGEST_SPECIALIZED = ((32, 32, 3),)


class IngestGeometry(NamedTuple):
    threads: int  # threads a block
    band: int     # output rows a block, of one image: block (i, k) writes rows k·band, ...
    copy: int     # COPY_BYTES or COPY_BULK
    smem: int     # dynamic shared memory bytes a block


def ingest_smem(h: int, w: int, c: int, band: int, pad: int, out_itemsize: int) -> int:
    """Dynamic shared memory bytes of an ingest block: the table of ``C·256``
    float32 values, the staged source rows ``band ± pad`` (within the
    image) rounded up to 16, and for a specialized shape the band's
    output."""
    smem = 4 * LEVELS * c + _round_up(min(h, band + 2 * pad) * w * c, 16)
    if (h, w, c) in INGEST_SPECIALIZED:
        smem += band * w * c * out_itemsize
    return smem


def ingest_geometry(n: int, h: int, w: int, c: int, out_itemsize: int, pad: int = 4,
                    aligned: bool = True) -> IngestGeometry:
    """Launch geometry of ``augment_normalize`` for ``n`` images of ``[h, w,
    c]`` into a dtype of ``out_itemsize`` bytes: a grid of ``(n, ⌈h /
    band⌉)`` blocks of ``threads``, block (i, k) writing output rows
    ``[k·band, (k+1)·band)`` of image i.

    A block takes a whole image, unless its shared memory would not fit:
    then the band is the most rows that fit. The source rows are staged by
    one bulk async copy where a row is a multiple of 16 bytes and ``raw``
    is 16-byte ``aligned``, by byte loads otherwise. A block has
    ``INGEST_THREADS`` threads, or one a 16-byte piece of its output where
    it has fewer."""
    if min(n, h, w, c) < 1 or pad < 0:
        raise ValueError(f"the ingest needs n, h, w, c >= 1 and pad >= 0, got "
                         f"{(n, h, w, c, pad)}")
    band = h
    while band > 1 and ingest_smem(h, w, c, band, pad, out_itemsize) > INGEST_MAX_SMEM:
        band -= 1
    smem = ingest_smem(h, w, c, band, pad, out_itemsize)
    if smem > INGEST_MAX_SMEM:
        raise ValueError(f"an ingest block of [{w}, {c}] rows needs {smem} bytes of shared "
                         f"memory, more than {INGEST_MAX_SMEM}")
    copy = COPY_BULK if (w * c) % 16 == 0 and aligned else COPY_BYTES
    pieces = _ceil_div(band * w * c * out_itemsize, 16)
    return IngestGeometry(min(INGEST_THREADS, _round_up(pieces, 32)), band, copy, smem)


# The NLL kernels' geometry (nll_fwd_kernel, nll_bwd_kernel), from sweeps
# on the H100 (PERF.md §6).
NLL_LANE_VECTORS = 2     # most loads a lane issues before a row gets twice the lanes
NLL_MAX_LANES = 32       # a warp
NLL_THREADS = 128        # threads a block, unless the rows need fewer (the kernel takes 256)


class NllGeometry(NamedTuple):
    lanes: int    # G lanes a row, a power of two: lane g takes vectors g, g + G, ...
    threads: int  # threads a block: threads // lanes rows
    vec: int      # values a load (a vector of at most 16 bytes)

    @property
    def rows(self) -> int:
        return self.threads // self.lanes


def nll_vec(c: int, itemsize: int, align: int = 16) -> int:
    """The most values one load can take: a power of two dividing ``c``,
    of at most 16 bytes and of no more than ``align``, the byte alignment
    of the logits' pointer."""
    vec = 1
    while c % (2 * vec) == 0 and 2 * vec * itemsize <= min(16, align):
        vec *= 2
    return vec


def nll_geometry(n: int, c: int, itemsize: int, align: int = 16) -> NllGeometry:
    """Launch geometry of ``nll_fwd`` and ``nll_bwd`` over ``[n, c]``
    logits of ``itemsize`` bytes whose pointer (and, for ``nll_bwd``, the
    gradient's) is aligned to ``align`` bytes: a grid of ``⌈n / rows⌉``
    blocks of ``threads``, row ``b·rows + t // lanes`` to the ``lanes``
    threads ``t`` of block ``b`` that share it.

    A load takes :func:`nll_vec` values. A row gets the fewest lanes (a
    power of two, at most a warp) that leave a lane at most
    ``NLL_LANE_VECTORS`` loads: 4 at C = 10, 16 at C = 100. A block has
    ``NLL_THREADS`` threads, or the whole warps that ``n`` rows need where
    that is fewer."""
    if n < 1 or c < 1 or itemsize not in (2, 4):
        raise ValueError(f"the NLL kernels need n, c >= 1 and a 2- or 4-byte dtype, got "
                         f"{(n, c, itemsize)}")
    vec = nll_vec(c, itemsize, align)
    lanes = 1
    while lanes < NLL_MAX_LANES and _ceil_div(c // vec, lanes) > NLL_LANE_VECTORS:
        lanes *= 2
    return NllGeometry(lanes, min(NLL_THREADS, _round_up(n * lanes, 32)), vec)


_cluster_limit: Optional[int] = None


def cluster_limit() -> int:
    """The largest cluster (≤ 16) the card can schedule for the biggest
    selection block draw_geometry makes, asked once of the card."""
    global _cluster_limit
    if _cluster_limit is None:
        from mercury_tpu_torch.ops import _build

        smem = max(draw_smem(MAX_THREADS, MAX_THREADS * REG_RUN, REG_RUN, refresh=64),
                   draw_smem(MAX_THREADS, MAX_RUNS * RUN, RUN, refresh=64))
        _cluster_limit = int(_build.load().mercury_cluster_limit(MAX_THREADS, smem))
    return _cluster_limit


def reset_launch_counts() -> None:
    with _count_lock:
        for k in KERNELS:
            launch_counts[k] = 0


@contextlib.contextmanager
def counting_into(counts: Dict[str, int]) -> Iterator[None]:
    """Count the calling thread's launches into ``counts`` while inside."""
    before = getattr(_counting, "counts", None)
    _counting.counts = counts
    try:
        yield
    finally:
        _counting.counts = before


def _check(name: str, t: torch.Tensor, dtypes, ndim: int) -> None:
    if not t.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype not in dtypes:
        raise TypeError(f"{name}: dtype {t.dtype} not in {dtypes}")
    if t.dim() != ndim:
        raise ValueError(f"{name}: expected {ndim}-d, got shape {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: tensor must be contiguous")


def _launched(name: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: cudaError {err}")
    counts = getattr(_counting, "counts", None)
    with _count_lock:
        (launch_counts if counts is None else counts)[name] += 1


def _check_ema(ema_value: torch.Tensor) -> None:
    if not ema_value.is_cuda or ema_value.dtype != torch.float32 or ema_value.numel() != 1:
        raise ValueError("ema_value must be a one-element float32 CUDA tensor")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _on_cpu(*tensors: torch.Tensor) -> bool:
    devices = {t.device.type for t in tensors}
    if devices == {"cpu"}:
        return True
    if devices == {"cuda"}:
        return False
    raise ValueError(f"tensors on {sorted(devices)}: expected all CPU or all CUDA")


def _alignment(t: torch.Tensor) -> int:
    """The largest power of two, up to 16, that divides ``t``'s address."""
    ptr = t.data_ptr()
    return min(16, ptr & -ptr) if ptr else 16


def nll_fwd_kernel(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Launch ``nll_fwd``: ``[N, C]`` f32/bf16 logits, ``[N]`` int32 labels
    → ``[N]`` float32, with the geometry of :func:`nll_geometry`: ``G``
    lanes a row, each row read once into registers with the widest load
    the row stride and the pointer's alignment allow, one combine across
    the ``G`` lanes. A label outside ``[0, C)`` picks no logit: the loss
    is the logsumexp."""
    from mercury_tpu_torch.ops import _build

    _check("logits", logits, tuple(_DTYPE_CODES), 2)
    _check("labels", labels, (torch.int32,), 1)
    n, c = logits.shape
    if labels.shape[0] != n:
        raise ValueError(f"labels {tuple(labels.shape)} do not match logits {(n, c)}")
    out = torch.empty(n, dtype=torch.float32, device=logits.device)
    if n == 0:
        return out
    geo = nll_geometry(n, c, logits.element_size(), _alignment(logits))
    with torch.cuda.device(logits.device):
        err = _build.load().mercury_nll_fwd(
            logits.data_ptr(), labels.data_ptr(), out.data_ptr(), n, c, *geo,
            _DTYPE_CODES[logits.dtype], _stream(logits))
    _launched("nll_fwd", err)
    return out


def nll_bwd_kernel(logits: torch.Tensor, labels: torch.Tensor,
                   g: torch.Tensor) -> torch.Tensor:
    """Launch ``nll_bwd``: ``(softmax(z_i) − onehot(y_i))·g_i`` of ``[N, C]``
    f32/bf16 logits, ``[N]`` int32 labels and ``[N]`` float32 ``g``,
    computed in float32 (``Σexp`` in float64, rounded once: the same for
    any lane count) and rounded once into the logits' dtype. It has
    ``nll_fwd``'s geometry (:func:`nll_geometry`), with the widest load both
    the logits' and the gradient's pointers allow: each row read once into
    registers, ``exp`` once an element, the gradient written from the
    registers in stores as wide as the loads. A label outside ``[0, C)``
    subtracts nothing."""
    from mercury_tpu_torch.ops import _build

    _check("logits", logits, tuple(_DTYPE_CODES), 2)
    _check("labels", labels, (torch.int32,), 1)
    _check("g", g, (torch.float32,), 1)
    n, c = logits.shape
    if labels.shape[0] != n or g.shape[0] != n:
        raise ValueError("labels and g must have one entry per logits row")
    grad = torch.empty_like(logits)
    if n == 0:
        return grad
    geo = nll_geometry(n, c, logits.element_size(),
                       min(_alignment(logits), _alignment(grad)))
    with torch.cuda.device(logits.device):
        err = _build.load().mercury_nll_bwd(
            logits.data_ptr(), labels.data_ptr(), g.data_ptr(), grad.data_ptr(),
            n, c, *geo, _DTYPE_CODES[logits.dtype], _stream(logits))
    _launched("nll_bwd", err)
    return grad


def score_and_draw_kernel(losses: torch.Tensor, ema_value: torch.Tensor,
                          uniforms: torch.Tensor, alpha: float
                          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch ``score_and_draw`` on ``[N]`` float32 losses, a one-element
    float32 EMA on the device (read there: no host sync) and ``[B]``
    float32 uniforms."""
    from mercury_tpu_torch.ops import _build

    _check("losses", losses, (torch.float32,), 1)
    _check("uniforms", uniforms, (torch.float32,), 1)
    _check_ema(ema_value)
    n, b = losses.shape[0], uniforms.shape[0]
    if n == 0:
        raise ValueError("score_and_draw needs a non-empty pool")
    dev = losses.device
    probs = torch.empty(n, dtype=torch.float32, device=dev)
    selected = torch.empty(b, dtype=torch.int32, device=dev)
    scaled = torch.empty(b, dtype=torch.float32, device=dev)
    if b == 0:
        return probs, selected, scaled
    with torch.cuda.device(dev):
        geo = draw_geometry(n, max_cluster=cluster_limit())
        err = _build.load().mercury_score_and_draw(
            losses.data_ptr(), ema_value.data_ptr(), uniforms.data_ptr(),
            float(alpha), n, b, *geo, probs.data_ptr(),
            selected.data_ptr(), scaled.data_ptr(), _stream(losses))
    _launched("score_and_draw", err)
    return probs, selected, scaled


def table_refresh_draw_kernel(
    scores: torch.Tensor, slots: torch.Tensor, rscores: torch.Tensor,
    ema_value: torch.Tensor, uniforms: torch.Tensor, alpha: float, decay: float,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch ``table_refresh_draw`` on a ``[L]`` float32 table, ``[R]``
    int64 refresh slots and their ``[R]`` float32 scores, a one-element
    float32 EMA on the device and ``[B]`` float32 uniforms."""
    from mercury_tpu_torch.ops import _build

    _check("scores", scores, (torch.float32,), 1)
    _check("slots", slots, (torch.int64,), 1)
    _check("rscores", rscores, (torch.float32,), 1)
    _check("uniforms", uniforms, (torch.float32,), 1)
    _check_ema(ema_value)
    n, r, b = scores.shape[0], slots.shape[0], uniforms.shape[0]
    if rscores.shape[0] != r:
        raise ValueError(f"{r} refresh slots but {rscores.shape[0]} refresh scores")
    if n == 0:
        raise ValueError("table_refresh_draw needs a non-empty table")
    dev = scores.device
    new_table = torch.empty(n, dtype=torch.float32, device=dev)
    probs = torch.empty(n, dtype=torch.float32, device=dev)
    selected = torch.empty(b, dtype=torch.int32, device=dev)
    scaled = torch.empty(b, dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        geo = draw_geometry(n, refresh=r, max_cluster=cluster_limit())
        err = _build.load().mercury_table_refresh_draw(
            scores.data_ptr(), slots.data_ptr(), rscores.data_ptr(),
            ema_value.data_ptr(), uniforms.data_ptr(), float(alpha), float(decay),
            n, r, b, *geo, new_table.data_ptr(), probs.data_ptr(),
            selected.data_ptr(), scaled.data_ptr(), _stream(scores))
    _launched("table_refresh_draw", err)
    return new_table, probs, selected, scaled


def augment_normalize_kernel(raw: torch.Tensor, mean: torch.Tensor, std: torch.Tensor,
                             crop: torch.Tensor, flip: torch.Tensor, pad: int,
                             out_dtype: torch.dtype,
                             rows: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Launch ``augment_normalize`` on ``[M, H, W, C]`` uint8 images, ``[C]``
    float32 mean and std, ``[N, 2]`` int32 crop offsets in ``[0, 2·pad]``
    and ``[N]`` bool flips; returns ``[N, H, W, C]`` in ``out_dtype``
    (float32 or bfloat16) from images ``rows`` (``[N]`` int64), or from
    all ``M = N`` images without ``rows``. A row outside ``[0, M)`` or an
    offset outside ``[0, 2·pad]`` traps on the card."""
    from mercury_tpu_torch.ops import _build

    _check("raw", raw, (torch.uint8,), 4)
    _check("mean", mean, (torch.float32,), 1)
    _check("std", std, (torch.float32,), 1)
    _check("crop", crop, (torch.int32,), 2)
    _check("flip", flip, (torch.bool,), 1)
    if out_dtype not in _DTYPE_CODES:
        raise TypeError(f"out_dtype {out_dtype} not in {tuple(_DTYPE_CODES)}")
    m, h, w, c = raw.shape
    n = m
    if rows is not None:
        _check("rows", rows, (torch.int64,), 1)
        n = rows.shape[0]
    if mean.shape[0] != c or std.shape[0] != c:
        raise ValueError(f"mean/std need {c} channels, got {mean.shape[0]}/{std.shape[0]}")
    if tuple(crop.shape) != (n, 2) or flip.shape[0] != n:
        raise ValueError(f"crop must be ({n}, 2) and flip ({n},), got "
                         f"{tuple(crop.shape)} and {tuple(flip.shape)}")
    out = torch.empty((n, h, w, c), dtype=out_dtype, device=raw.device)
    if out.numel() == 0:
        return out
    if m == 0:
        raise ValueError("rows index an empty raw tensor")
    geo = ingest_geometry(n, h, w, c, out.element_size(), int(pad),
                          aligned=raw.data_ptr() % 16 == 0)
    with torch.cuda.device(raw.device):
        err = _build.load().mercury_augment_normalize(
            raw.data_ptr(), None if rows is None else rows.data_ptr(), mean.data_ptr(),
            std.data_ptr(), crop.data_ptr(), flip.data_ptr(), out.data_ptr(), n, m, h, w,
            c, int(pad), *geo, _DTYPE_CODES[out_dtype], _stream(raw))
    _launched("augment_normalize", err)
    return out


class _PerSampleNLL(torch.autograd.Function):
    @staticmethod
    def forward(ctx, logits, labels):
        ctx.save_for_backward(logits, labels)
        if _on_cpu(logits, labels):
            return reference.nll_forward(logits, labels)
        return nll_fwd_kernel(logits, labels)

    @staticmethod
    def backward(ctx, g):
        logits, labels = ctx.saved_tensors
        # The incoming gradient may be a broadcast view (e.g. of a mean).
        g = g.to(torch.float32).contiguous()
        if _on_cpu(logits, labels):
            return reference.nll_backward(logits, labels, g), None
        return nll_bwd_kernel(logits, labels, g), None


def per_sample_nll(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Per-sample cross-entropy ``[N]`` float32 of ``[N, C]`` logits (f32 or
    bf16) and ``[N]`` int32 labels; differentiable in the logits."""
    return _PerSampleNLL.apply(logits, labels)


def score_and_draw(losses: torch.Tensor, ema_value, uniforms: torch.Tensor,
                   alpha: float = 0.5
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Pool selection from per-candidate losses and the updated EMA: returns
    ``(probs [N], selected [B] int32, scaled_probs [B] = p·N)``. ``uniforms``
    (``[B]`` or ``[1, B]``) are the draw's U(0,1) variates."""
    uniforms = uniforms.reshape(-1)
    ema_value = torch.as_tensor(ema_value, dtype=torch.float32,
                                device=losses.device)
    if _on_cpu(losses, uniforms):
        return reference.score_and_draw(losses, ema_value, uniforms, alpha)
    return score_and_draw_kernel(losses, ema_value.reshape(1), uniforms, alpha)


def table_refresh_draw(scores: torch.Tensor, slots: torch.Tensor,
                       rscores: torch.Tensor, ema_value, uniforms: torch.Tensor,
                       alpha: float = 0.5, decay: float = 0.98
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """One scoretable selection: decay the table toward the EMA, write the
    refresh window's scores in (duplicates averaged), smooth, normalize and
    draw over all ``L`` slots. Returns ``(new_table [L], probs [L],
    selected [B] int32, scaled_probs [B] = p·L)``. ``uniforms`` (``[B]`` or
    ``[1, B]``) are the draw's U(0,1) variates."""
    uniforms = uniforms.reshape(-1)
    ema_value = torch.as_tensor(ema_value, dtype=torch.float32,
                                device=scores.device)
    if _on_cpu(scores, slots, rscores, uniforms):
        return reference.table_refresh_draw(scores, slots, rscores, ema_value,
                                            uniforms, alpha, decay)
    return table_refresh_draw_kernel(scores, slots, rscores, ema_value.reshape(1),
                                     uniforms, alpha, decay)


def augment_normalize(raw: torch.Tensor, mean: torch.Tensor, std: torch.Tensor,
                      crop: torch.Tensor, flip: torch.Tensor, pad: int = 4,
                      out_dtype: torch.dtype = torch.float32,
                      rows: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The fused uint8 ingest: ``[M, H, W, C]`` uint8 images → images
    ``rows`` (``[N]`` int64; all of them without ``rows``), normalized,
    cropped at ``crop [N, 2]`` (zero padding ``pad``) and flipped where
    ``flip [N]``, cast to ``out_dtype`` last; NHWC out. On the card the
    gather of ``rows`` happens inside the one launch."""
    if rows is None:
        tensors = (raw, mean, std, crop, flip)
    else:
        if rows.dtype != torch.int64 or rows.dim() != 1:
            raise TypeError(f"rows must be a 1-d int64 tensor, got {rows.dtype} "
                            f"of shape {tuple(rows.shape)}")
        tensors = (raw, mean, std, crop, flip, rows)
    if _on_cpu(*tensors):
        src = raw if rows is None else raw[rows]
        return reference.augment_normalize(src, mean, std, crop, flip, pad, out_dtype)
    return augment_normalize_kernel(raw, mean, std, crop, flip, pad, out_dtype, rows)
