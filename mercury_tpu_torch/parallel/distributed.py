"""One process a rank: the process group, the rank's card and a launcher —
the PyTorch counterpart of ``mercury_tpu/parallel/distributed.py`` and
``parallel/mesh.py``.

Two ways to run ``world_size=W``:

- ``torchrun --nproc_per_node=W script.py``, where the script calls
  ``init_distributed(W, "nccl")`` (a card a rank) before it builds its
  ``Trainer``; ``init_distributed`` reads
  ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK`` and the rendezvous address from
  the environment torchrun sets.
- :func:`spawn`, which starts W processes on this host, joined through a
  ``FileStore`` in a temporary directory, runs ``fn(*args)`` in each and
  returns each rank's result. The tests run two gloo ranks on the CPU
  with it; ``chip_smoke.py`` two gloo ranks that share one card.

Under ``tensor_parallel=T`` or ``fsdp_parallel=F`` a run takes
``world_size × T`` (or ``× F``) ranks: ``torchrun --nproc_per_node=W·T``
and ``init_distributed(W·T, "nccl")``; ``parallel/mesh.py`` then splits
them into data and model groups.

The backend is always the caller's choice; nothing falls back from one
backend to another. A rank that fails fails the whole launch: every
collective has a timeout, and :func:`spawn` raises when any child exits
non-zero (and stops the others).
"""

from __future__ import annotations

import datetime
import os
import shutil
import socket
import tempfile
from typing import Any, Callable, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from mercury_tpu_torch.parallel.collectives import rank, world

__all__ = ["init_distributed", "rank", "world", "require_world", "device",
           "cards_in_use", "reserve_scorer_device", "spawn"]

DEFAULT_TIMEOUT_S = 300.0


def init_distributed(world_size: Optional[int], backend: str,
                     init_method: Optional[str] = None,
                     rank: Optional[int] = None,
                     device_index: Optional[int] = None,
                     timeout_s: float = DEFAULT_TIMEOUT_S,
                     store: Optional[dist.Store] = None) -> int:
    """Join the process group with ``backend`` (``"nccl"`` or ``"gloo"``,
    always the caller's choice) and return this process's rank.

    Under torchrun, ``RANK``, ``WORLD_SIZE`` and ``LOCAL_RANK`` come from
    the environment and ``init_method`` defaults to ``"env://"``; a
    ``world_size`` that disagrees with ``WORLD_SIZE`` raises. Elsewhere
    pass ``world_size``, ``rank`` and ``init_method`` (or ``store``).
    With CUDA available the rank's card is ``cuda:{device_index}``
    (default ``LOCAL_RANK``), made current with ``torch.cuda.set_device``.
    ``timeout_s`` bounds the rendezvous and every collective."""
    env_world = os.environ.get("WORLD_SIZE")
    if env_world is not None:
        if world_size is not None and world_size != int(env_world):
            raise ValueError(f"world_size={world_size} but the launcher's "
                             f"WORLD_SIZE={env_world}")
        world_size = int(env_world)
        rank = int(os.environ["RANK"]) if rank is None else rank
        if init_method is None and store is None:
            init_method = "env://"
    if world_size is None or rank is None:
        raise ValueError("init_distributed needs world_size and rank, or the "
                         "environment torchrun sets")
    if device_index is None:
        device_index = int(os.environ.get("LOCAL_RANK", rank))
    if torch.cuda.is_available():
        torch.cuda.set_device(device_index)
    dist.init_process_group(backend, init_method=init_method, store=store,
                            world_size=world_size, rank=rank,
                            timeout=datetime.timedelta(seconds=timeout_s))
    return rank


def require_world(world_size: int, second: Optional[Tuple[str, int]] = None) -> int:
    """This process's global rank, once the process group is known to have
    ``world_size`` ranks, or ``world_size × n`` under a second mesh axis
    ``second = (field, n)`` (``("tensor_parallel", T)`` or
    ``("fsdp_parallel", F)``). One rank needs no process group; more need
    one of that many ranks, and its absence raises instead of training at
    one rank."""
    field, n = second if second is not None else (None, 1)
    need = world_size * n
    what = (f"TrainConfig.world_size={world_size}" if field is None else
            f"TrainConfig.world_size={world_size} × {field}={n}")
    initialized = dist.is_available() and dist.is_initialized()
    if not initialized:
        if need == 1:
            return 0
        raise ValueError(
            f"{what} needs a process group of {need} ranks, one process each: "
            f"launch with `torchrun --nproc_per_node={need}` and call "
            "mercury_tpu_torch.parallel.distributed.init_distributed, or run "
            "under mercury_tpu_torch.parallel.distributed.spawn")
    if world() != need:
        raise ValueError(f"{what} but the process group has {world()} ranks")
    return rank()


def device() -> torch.device:
    """This rank's card: the current CUDA device, which
    :func:`init_distributed` set."""
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the port trains on the GPU. Pass "
                           "device='cpu' to run on the CPU deliberately.")
    return torch.device("cuda", torch.cuda.current_device())


def cards_in_use(own: torch.device) -> List[int]:
    """The card indices the ranks of this host train on: ``own``'s alone
    without a process group, else gathered from every rank (a collective:
    every rank calls it)."""
    if not (dist.is_available() and dist.is_initialized()) or world() == 1:
        return [own.index]
    pairs: List[Any] = [None] * world()
    dist.all_gather_object(pairs, (socket.gethostname(), own.index))
    host = socket.gethostname()
    return sorted({index for name, index in pairs if name == host})


def reserve_scorer_device(own: torch.device, in_use: Sequence[int],
                          visible: Optional[int] = None) -> torch.device:
    """The card of ``scorer_backend="device"`` — the counterpart of the JAX
    package's ``reserve_scorer_slice``: the first of the ``visible`` cards
    (default ``torch.cuda.device_count()``) that is not ``in_use`` by a
    rank of this host, else the rank's own card ``own``, where the scorer's
    workers score on streams of their own beside the step."""
    if visible is None:
        visible = torch.cuda.device_count()
    spares = [i for i in range(visible) if i not in set(in_use)]
    return torch.device("cuda", spares[0]) if spares else own


def _rank_main(rank_: int, fn: Callable, world_size: int, backend: str,
               workdir: str, devices: Optional[Sequence[int]],
               timeout_s: float, args: tuple) -> None:
    store = dist.FileStore(os.path.join(workdir, "store"), world_size)
    init_distributed(world_size, backend, rank=rank_, store=store,
                     device_index=rank_ if devices is None else devices[rank_],
                     timeout_s=timeout_s)
    try:
        result = fn(*args)
        torch.save(result, os.path.join(workdir, f"result{rank_}.pt"))
    finally:
        dist.destroy_process_group()


def spawn(fn: Callable, world_size: int, backend: str, *args: Any,
          devices: Optional[Sequence[int]] = None,
          timeout_s: float = DEFAULT_TIMEOUT_S) -> List[Any]:
    """Run ``fn(*args)`` in ``world_size`` new processes, one a rank, in one
    ``backend`` process group; return the ranks' results in rank order.

    ``fn`` and ``args`` are pickled (``fn`` by its import path: a
    module-level function), and so is each result, which comes back through
    a file. ``devices`` gives each rank's card index (default: its rank);
    ``[0] * world_size`` puts every rank on card 0, which only gloo allows.
    Raises if any rank raises or exits non-zero; the others are stopped."""
    if devices is not None and len(devices) != world_size:
        raise ValueError(f"devices {list(devices)} for {world_size} ranks")
    workdir = tempfile.mkdtemp(prefix="mercury_spawn_")
    try:
        torch.multiprocessing.spawn(
            _rank_main, nprocs=world_size, join=True,
            args=(fn, world_size, backend, workdir, devices, timeout_s, args))
        return [torch.load(os.path.join(workdir, f"result{r}.pt"), weights_only=False)
                for r in range(world_size)]
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
