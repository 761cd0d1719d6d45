"""Checkpoints of the port: the whole training state of a run as one file,
``<directory>/ckpt_<step>.pt``, from which the run resumes bit for bit.

The PyTorch counterpart of ``mercury_tpu/train/checkpoint.py`` in a format
of its own (``torch.save`` of a dict of tensors and numbers): the save, its
write retries and ``checkpoint/write_failures`` counter, the sha256
manifest, the async save, pruning, and the restore that falls back to an
older file. A restore at another world size is ``train/elastic.py``'s.

The file holds the replicated state once (the model's parameters and BN
buffers, the optimizer's state, the step counters and the gradient
accumulator) and a row of sampler state for each rank (the EMA, the stream
permutation and cursor, the generator's state and, with
``sampler="scoretable"``, the table and its cursor and, under telemetry, the
selection-count ledger; under ``host_stream``, the ring of selections in
flight with its draws; the pool sampler's step modes' carried state: the
pipelined batch in flight, the cached pool, the groupwise importance). At W>1 every rank sends its row to rank 0, rank 0
alone writes, and a barrier follows, so no rank reads before the file
exists; a restore reads the file on every rank, and each rank takes its own
row. A file without a ledger (saved with ``telemetry=False``) restores into
a zero ledger; a ledger restored into a run without telemetry is dropped.
A file without a ring (saved by a replicated run) restores into a
host_stream run without one, and the Trainer primes the ring anew from the
restored generator and stream, as the JAX package's ``_upgrade_v1_to_v2``
drops the ring; a ring does not restore into a run of another placement.

A file restores only into a run of the same step mode: one with a pending
batch, a cached pool or a groupwise state into a run that keeps the same.

Under ``zero_sharding`` each rank's optimizer state and accumulator are
its own chunk's, so they go into its row and each rank restores its own;
:func:`restore_checkpoint` restores such a file only into a ZeRO run of the
same ``world_size``, and ``elastic.elastic_restore`` reshards the chunks
for another.

Under ``tensor_parallel`` or ``fsdp_parallel`` the file is the same as an
unsharded run's: the model group gathers its shards of the parameters,
Adam's moments and the accumulator (``parallel/mesh.py``), the rows are
gathered over the data group (one a worker), and global rank 0 writes. A
restore reads the whole tensors and each rank keeps its slices, so a file
moves between layouts at the same ``world_size``.

Durability. A file is written to ``ckpt_<step>.pt.tmp``, flushed to disk,
renamed and the directory flushed, so a torn write never carries a
checkpoint's name; a write that raises ``OSError`` is tried again
``retries`` times after an exponential backoff, every failed attempt
counted (:func:`write_failures`), and the older files are pruned only
after a write that landed. With ``manifest`` a sidecar
``ckpt_<step>.pt.manifest.json`` follows the file: the sha256 of its bytes
(hashed as they are written), their count, :data:`FORMAT` and the sha256 of
every tensor keyed by its path in the payload (``model/conv1.weight``,
``ranks/0/ema_value``). A restore of the newest file checks it and, if the
file does not load or fails a digest, warns and takes the next-older one;
at W>1 the ranks walk rank 0's list and agree on each file (a read error on
one rank moves every rank back). :func:`save_checkpoint_async` copies the
state to the host on the caller's thread and writes on a thread of its own.
"""

from __future__ import annotations

import hashlib
import io
import json
import os
import re
import threading
import time
from typing import Any, Callable, Dict, List, Optional

import torch
import torch.distributed as dist

from mercury_tpu_torch.config import TrainConfig
from mercury_tpu_torch.data.pipeline import ShardStream
from mercury_tpu_torch.parallel.collectives import (
    gather_to_rank0,
    host_flag_device,
    rank,
    world,
)
from mercury_tpu_torch.parallel.mesh import (
    full_like_params,
    full_optimizer_state,
    full_state_dict,
    load_full_state_dict,
    local_like_params,
    local_optimizer_state,
    sharding_of,
)
from mercury_tpu_torch.sampling.importance import EMAState
from mercury_tpu_torch.sampling.scoretable import ScoreTableState
from mercury_tpu_torch.sampling.groupwise import GroupwiseState
from mercury_tpu_torch.train.state import (
    CachedPool,
    MercuryState,
    PendingBatch,
    carried_from_host,
    pending_from_host,
    pending_to_host,
)
from mercury_tpu_torch.utils.logging import get_logger

_log = get_logger(__name__)

# The step modes' carried state: the row's key, the state's field, its
# type and the config field that turns it on.
_CARRIED = (("pending_batch", PendingBatch, "pipelined_scoring"),
            ("cached_pool", CachedPool, "score_refresh_every"),
            ("groupwise", GroupwiseState, "sampler"))

FORMAT = 1
MANIFEST_SCHEMA = "mercury-ckpt-manifest-v1"
# The newest files the ranks agree on walking at W>1.
MAX_CANDIDATES = 256
# A .tmp younger than this may be a write in flight; an older one is a
# crash's and is swept.
STALE_TMP_S = 300.0
_NAME = re.compile(r"ckpt_(\d+)\.pt")
_TMP = re.compile(r"ckpt_\d+\.pt(\.manifest\.json)?\.tmp")

# Failed write attempts in this process (a save that lands at its third
# attempt counts 2), from the training thread and the writer threads.
_fail_lock = threading.Lock()
_write_failures = 0
# The newest save's and restore's times, seconds.
_timings: Dict[str, float] = {}


def write_failures() -> int:
    """Failed checkpoint write attempts in this process so far."""
    with _fail_lock:
        return _write_failures


def _count_write_failure() -> None:
    global _write_failures
    with _fail_lock:
        _write_failures += 1


def timings() -> Dict[str, float]:
    """The newest save's ``write_s`` (serialize, flush, rename) and
    ``digest_s`` (the whole-file and per-tensor sha256; 0 without a
    manifest), and the newest restore's ``read_s``, ``verify_s`` and
    ``load_s``."""
    with _fail_lock:
        return dict(_timings)


def _note_times(**kw: float) -> None:
    with _fail_lock:
        _timings.update(kw)


def checkpoint_path(directory: str, step: int) -> str:
    return os.path.join(directory, f"ckpt_{step}.pt")


def manifest_path(path: str) -> str:
    return path + ".manifest.json"


def all_steps(directory: str) -> List[int]:
    """The steps of the checkpoints in ``directory``, ascending (a
    ``.tmp`` file is not a checkpoint)."""
    if not os.path.isdir(directory):
        return []
    return sorted(int(m.group(1)) for m in map(_NAME.fullmatch, os.listdir(directory))
                  if m)


def latest_step(directory: str) -> Optional[int]:
    """The newest checkpoint's step in ``directory``, or None."""
    steps = all_steps(directory)
    return steps[-1] if steps else None


def _cpu(t: torch.Tensor) -> torch.Tensor:
    """A host copy: never the tensor's own storage, which the next step
    may update in place while a writer thread still reads the copy."""
    return t.detach().to("cpu", copy=True)


def _optimizer_on_host(optimizer: torch.optim.Optimizer) -> Dict[str, Any]:
    sd = optimizer.state_dict()
    return {"param_groups": sd["param_groups"],
            "state": {i: {k: _cpu(v) if torch.is_tensor(v) else v for k, v in st.items()}
                      for i, st in sd["state"].items()}}


def _data(state: MercuryState):
    """The state's data group and its rank in it (the default group's on a
    data-only run)."""
    mesh = state.mesh
    if mesh is None or mesh.second == 1:
        return None, rank()
    return mesh.data_group, mesh.data_rank


def _rank_row(state: MercuryState, zero: bool) -> Dict[str, Any]:
    """This rank's sampler state, and under ZeRO its chunk's optimizer
    state and accumulator, on the host."""
    table = state.scoretable
    own = {}
    if zero:
        own = {"optimizer": _optimizer_on_host(state.optimizer),
               "accum": None if state.accum is None else [_cpu(a) for a in state.accum]}
    return {**own,
        "ema_value": _cpu(state.ema.value), "ema_count": _cpu(state.ema.count),
        "perm": _cpu(state.stream.perm), "cursor": state.stream.cursor,
        "generator": state.generator.get_state(),
        "table": None if table is None else _cpu(table.scores),
        "table_cursor": None if table is None else table.cursor,
        "sel_counts": None if state.sel_counts is None else _cpu(state.sel_counts),
        "pending": None if state.pending is None else pending_to_host(state.pending),
        **{key: None if getattr(state, key) is None else pending_to_host(getattr(state, key))
           for key, _, _ in _CARRIED},
    }


def _whole(state: MercuryState, zero: bool) -> Dict[str, Any]:
    """The replicated state as the unsharded run holds it: the model, the
    optimizer and the accumulator (under ZeRO the model alone: the rest is
    in the rank rows), gathered over the model group under a second mesh
    axis (a collective of the group), on the host."""
    model = state.model
    whole: Dict[str, Any] = {"model": {k: _cpu(v) for k, v in full_state_dict(model).items()},
                             "optimizer": None, "accum": None}
    if zero:
        return whole
    if sharding_of(model) is None:
        whole["optimizer"] = _optimizer_on_host(state.optimizer)
        whole["accum"] = None if state.accum is None else [_cpu(a) for a in state.accum]
        return whole
    opt = full_optimizer_state(model, state.optimizer.state_dict())
    whole["optimizer"] = {"param_groups": opt["param_groups"],
                          "state": {i: {k: _cpu(v) if torch.is_tensor(v) else v
                                        for k, v in st.items()}
                                    for i, st in opt["state"].items()}}
    whole["accum"] = (None if state.accum is None
                      else [_cpu(a) for a in full_like_params(model, state.accum)])
    return whole


def _payload(state: MercuryState, config: TrainConfig, rows: List[Dict[str, Any]],
             whole: Dict[str, Any]) -> Dict[str, Any]:
    zero = config.zero_sharding
    return {
        "format": FORMAT,
        "step": state.step, "updates": state.updates, "mini_step": state.mini_step,
        "world_size": config.world_size, "grad_accum_steps": config.grad_accum_steps,
        "zero_sharding": zero, "device": state.stream.perm.device.type,
        "model": whole["model"],
        # Under ZeRO both are in the rank rows.
        "optimizer": whole["optimizer"],
        "accum": whole["accum"],
        "ranks": rows,
    }


# ------------------------------------------------------------------ digests
def _digest(t: torch.Tensor) -> str:
    """sha256 of a host tensor's bytes in its logical order (bfloat16 and
    bool included: the bytes are read as uint8)."""
    return hashlib.sha256(t.detach().contiguous().reshape(-1).view(torch.uint8)
                          .numpy()).hexdigest()


def tensor_digests(tree: Any, prefix: str = "") -> Dict[str, str]:
    """The sha256 of every tensor of a payload, keyed by its path
    (``model/conv1.weight``, ``ranks/0/ema_value``)."""
    if torch.is_tensor(tree):
        return {prefix: _digest(tree)}
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {}
    out: Dict[str, str] = {}
    for key, value in items:
        out.update(tensor_digests(value, f"{prefix}/{key}" if prefix else str(key)))
    return out


class _HashingFile:
    """A binary file that hashes the bytes written to it as they pass, so
    the whole-file digest costs no second read."""

    def __init__(self, f) -> None:
        self._f = f
        self.name = f.name
        self.sha = hashlib.sha256()
        self.nbytes = 0
        self.hash_s = 0.0

    def write(self, data) -> int:
        t0 = time.perf_counter()
        self.sha.update(data)
        self.hash_s += time.perf_counter() - t0
        self.nbytes += memoryview(data).nbytes
        return self._f.write(data)

    def flush(self) -> None:
        self._f.flush()


# ------------------------------------------------------------------- writes
def _fsync_dir(path: str) -> None:
    """Flush the directory entry of a rename: without it a crash right
    after ``os.replace`` can lose the new name."""
    fd = os.open(os.path.dirname(path) or ".", os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _replace_atomically(path: str, write: Callable[[Any], None], mode: str) -> None:
    """``write(f)`` into ``path.tmp``, flushed to disk, renamed to
    ``path`` and the directory flushed; a failure removes the ``.tmp``."""
    tmp = path + ".tmp"
    try:
        with open(tmp, mode) as f:
            write(f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
    _fsync_dir(path)


def _write(path: str, payload: Dict[str, Any], *, manifest: bool = False,
           faults=None) -> None:
    """The file, then (with ``manifest``) its sidecar. The injected
    ``ckpt_io_error`` raises before the file is opened, leaving nothing
    behind, as a full disk would."""
    if faults is not None and faults.fire("ckpt_io_error") is not None:
        raise OSError("ckpt_io_error: injected checkpoint write failure")
    t0 = time.perf_counter()
    out: List[_HashingFile] = []

    def save(f) -> None:
        target = f
        if manifest:
            target = _HashingFile(f)
            out.append(target)
        torch.save(payload, target)

    _replace_atomically(path, save, "wb")
    write_s = time.perf_counter() - t0
    digest_s = 0.0
    if manifest:
        hashed = out[0]
        t1 = time.perf_counter()
        tensors = tensor_digests(payload)
        digest_s = hashed.hash_s + time.perf_counter() - t1
        write_s -= hashed.hash_s
        doc = {"schema": MANIFEST_SCHEMA, "step": int(payload["step"]),
               "file": os.path.basename(path), "sha256": hashed.sha.hexdigest(),
               "bytes": hashed.nbytes, "format": FORMAT, "tensors": tensors}
        # After the payload's rename: a crash in between leaves a file
        # without a sidecar (restored unverified), never a sidecar without
        # its file.
        _replace_atomically(manifest_path(path),
                            lambda f: json.dump(doc, f, indent=1, sort_keys=True), "w")
    _note_times(write_s=write_s, digest_s=digest_s)


def _write_with_retries(path: str, payload: Dict[str, Any], *, retries: int = 0,
                        retry_backoff_s: float = 0.25, manifest: bool = False,
                        faults=None) -> None:
    """:func:`_write`, tried again after an ``OSError`` up to ``retries``
    times, ``retry_backoff_s·2^k`` seconds apart; every failed attempt
    counts into :func:`write_failures`."""
    attempt = 0
    while True:
        try:
            _write(path, payload, manifest=manifest, faults=faults)
            return
        except OSError as exc:
            attempt += 1
            _count_write_failure()
            if attempt > max(int(retries), 0):
                raise
            delay = retry_backoff_s * (2 ** (attempt - 1))
            _log.warning("checkpoint write %s failed (attempt %d/%d): %s; retrying in "
                         "%.2f s", path, attempt, retries + 1, exc, delay)
            time.sleep(delay)


def prune(directory: str, keep: int) -> None:
    """Keep the newest ``keep`` checkpoints and their sidecars (``keep <=
    0`` keeps all). Called only after a write that landed."""
    if keep <= 0:
        return
    for step in all_steps(directory)[:-keep]:
        path = checkpoint_path(directory, step)
        for p in (path, manifest_path(path)):
            try:
                os.unlink(p)
            except OSError:
                pass


def save_checkpoint(directory: str, state: MercuryState, config: TrainConfig,
                    keep: int = 0, *, retries: int = 0, retry_backoff_s: float = 0.25,
                    manifest: bool = False, faults=None, journal=None) -> str:
    """Write ``state`` to ``directory/ckpt_<state.step>.pt`` and prune to
    the newest ``keep``; return the path. Called by every rank at W>1:
    rank 0 writes, and every rank returns once rank 0 is done (the barrier
    is reached even when the write raised on rank 0, which then raises).
    ``journal`` records the written file as ``checkpoint/written``."""
    group, _ = _data(state)
    rows = gather_to_rank0(_rank_row(state, config.zero_sharding), group)
    whole = _whole(state, config.zero_sharding)
    path = checkpoint_path(directory, state.step)
    try:
        if rank() == 0:
            os.makedirs(directory, exist_ok=True)
            _write_with_retries(path, _payload(state, config, rows, whole), retries=retries,
                                retry_backoff_s=retry_backoff_s, manifest=manifest,
                                faults=faults)
            prune(directory, keep)
            _journal_written(journal, state.step, path, manifest)
    finally:
        if world() > 1:
            dist.barrier()
    return path


def _journal_written(journal, step: int, path: str, manifest: bool) -> None:
    """Journal a durable file (nothing without a journal; never raises)."""
    if journal is None:
        return
    try:
        journal.emit("checkpoint/written", int(step),
                     detail={"path": path, "manifest": bool(manifest)})
    except Exception:
        pass


class AsyncSave:
    """A checkpoint write in flight on a non-daemon thread. :meth:`join`
    waits for it and raises what the writer raised; ``failure_cb(exc)``
    runs on the writer thread as soon as it fails."""

    def __init__(self, target: Callable[[], None], name: str,
                 failure_cb: Optional[Callable[[BaseException], None]] = None) -> None:
        self._exc: Optional[BaseException] = None

        def runner() -> None:
            try:
                target()
            except BaseException as e:  # raised again at join()
                self._exc = e
                if failure_cb is not None:
                    try:
                        failure_cb(e)
                    except Exception:
                        _log.warning("checkpoint failure_cb raised", exc_info=True)

        self._thread = threading.Thread(target=runner, name=name, daemon=False)
        self._thread.start()

    def done(self) -> bool:
        """The writer has ended, written or failed."""
        return not self._thread.is_alive()

    def failed(self) -> Optional[BaseException]:
        """The writer's exception, if it failed (does not wait)."""
        return self._exc

    def join(self, timeout: Optional[float] = 600.0) -> None:
        """Wait for the write; raise the writer's exception, or
        ``TimeoutError`` (its cause the writer's exception, if any) when it
        is still running after ``timeout`` seconds."""
        self._thread.join(timeout=timeout)
        if self._thread.is_alive():
            _log.warning("checkpoint writer %r still running after %.0f s",
                         self._thread.name, timeout)
            raise TimeoutError(f"checkpoint write ({self._thread.name}) did not finish "
                               f"within {timeout:.0f} s") from self._exc
        if self._exc is not None:
            raise self._exc


def save_checkpoint_async(directory: str, state: MercuryState, config: TrainConfig,
                          keep: int = 0, *, retries: int = 0,
                          retry_backoff_s: float = 0.25, manifest: bool = False,
                          faults=None, failure_cb=None, journal=None) -> Optional[AsyncSave]:
    """Copy ``state`` to the host here (the next step updates it in
    place), then serialize, digest, write and prune on a thread; return its
    :class:`AsyncSave`. At W>1 the gather to rank 0 and the barrier must
    stay on the caller's thread, so the save is synchronous there and
    returns None."""
    if world() > 1:
        save_checkpoint(directory, state, config, keep, retries=retries,
                        retry_backoff_s=retry_backoff_s, manifest=manifest, faults=faults,
                        journal=journal)
        return None
    os.makedirs(directory, exist_ok=True)
    path = checkpoint_path(directory, state.step)
    payload = _payload(state, config, [_rank_row(state, config.zero_sharding)],
                       _whole(state, config.zero_sharding))
    step = state.step

    def write() -> None:
        _write_with_retries(path, payload, retries=retries, retry_backoff_s=retry_backoff_s,
                            manifest=manifest, faults=faults)
        prune(directory, keep)
        # On the writer thread: when the file became durable.
        _journal_written(journal, step, path, manifest)

    return AsyncSave(write, f"ckpt-write-{state.step}", failure_cb)


# ----------------------------------------------------------------- restores
def _sweep_stale_tmps(directory: str, min_age_s: float = STALE_TMP_S) -> None:
    """Rank 0 removes the ``.tmp`` files a crash left behind, those older
    than ``min_age_s``: a younger one may be a write in flight."""
    if rank() != 0:
        return
    now = time.time()
    try:
        names = os.listdir(directory)
    except OSError:
        return
    for name in names:
        if _TMP.fullmatch(name):
            path = os.path.join(directory, name)
            try:
                if now - os.path.getmtime(path) >= min_age_s:
                    os.unlink(path)
            except OSError:
                pass


def _load_manifest(path: str) -> Optional[Dict[str, Any]]:
    """The sidecar, or None when it is missing, unreadable or of another
    schema: the file is then restored unverified."""
    try:
        with open(manifest_path(path)) as f:
            doc = json.load(f)
    except (OSError, ValueError):
        return None
    if not isinstance(doc, dict) or doc.get("schema") != MANIFEST_SCHEMA:
        return None
    return doc


def load_checkpoint(directory: str, step: int, verify: bool = True) -> Dict[str, Any]:
    """The payload of ``ckpt_<step>.pt`` on the host. With ``verify`` and
    a readable sidecar, the file's sha256 is checked before it is loaded
    and every tensor's after; a mismatch raises ``ValueError`` naming the
    check (and the tensor)."""
    path = checkpoint_path(directory, step)
    name = os.path.basename(path)
    t0 = time.perf_counter()
    with open(path, "rb") as f:
        blob = f.read()
    read_s = time.perf_counter() - t0
    doc = _load_manifest(path) if verify else None
    verify_s = 0.0
    if doc is not None:
        t1 = time.perf_counter()
        got = hashlib.sha256(blob).hexdigest()
        verify_s += time.perf_counter() - t1
        if got != doc.get("sha256"):
            raise ValueError(f"{name} sha256 mismatch: manifest {str(doc.get('sha256'))[:12]}…, "
                             f"file {got[:12]}… ({len(blob)} bytes vs {doc.get('bytes')} "
                             "recorded)")
    t1 = time.perf_counter()
    ckpt = torch.load(io.BytesIO(blob), map_location="cpu", weights_only=True)
    load_s = time.perf_counter() - t1
    if doc is not None and doc.get("tensors"):
        t1 = time.perf_counter()
        have = tensor_digests(ckpt)
        for key, want in doc["tensors"].items():
            if key not in have:
                raise ValueError(f"{name} manifest names tensor {key!r}, absent from the file")
            if have[key] != want:
                raise ValueError(f"{name} tensor {key!r} sha256 mismatch (a corrupt value "
                                 "survived loading)")
        verify_s += time.perf_counter() - t1
    _note_times(read_s=read_s, verify_s=verify_s, load_s=load_s)
    return ckpt


def _journal_verified(journal, directory: str, step: int, verify: bool) -> None:
    """Journal a file that loaded and passed its sidecar's checks (nothing
    without a journal, a sidecar or ``verify``; never raises)."""
    if journal is None or not verify:
        return
    path = checkpoint_path(directory, step)
    doc = _load_manifest(path)
    if doc is None:
        return
    try:
        journal.emit("checkpoint/verified", int(step),
                     detail={"path": path, "leaves": len(doc.get("tensors") or {})})
    except Exception:
        pass


def _agreed_steps(steps: List[int]) -> List[int]:
    """Rank 0's newest :data:`MAX_CANDIDATES` steps on every rank (the
    ranks' listings of a shared directory may differ)."""
    if world() == 1:
        return steps
    buf = torch.full((MAX_CANDIDATES,), -1, dtype=torch.int64, device=host_flag_device())
    mine = steps[-MAX_CANDIDATES:]
    if rank() == 0 and mine:
        buf[:len(mine)] = torch.tensor(mine, dtype=torch.int64)
    dist.broadcast(buf, src=0)
    return [int(s) for s in buf.tolist() if s >= 0]


def _all_ranks(ok: bool) -> bool:
    """Whether ``ok`` holds on every rank (the minimum of a flag)."""
    if world() == 1:
        return ok
    flag = torch.tensor([1.0 if ok else 0.0], device=host_flag_device())
    dist.all_reduce(flag, op=dist.ReduceOp.MIN)
    return bool(flag.item() > 0.5)


def restore_checkpoint(directory: str, state: MercuryState, config: TrainConfig,
                       step: Optional[int] = None, *, verify: bool = True,
                       journal=None) -> int:
    """Load ``directory/ckpt_<step>.pt`` into ``state`` in place, this
    rank's row of sampler state included; return the step.

    With ``step=None``: rank 0 first sweeps stale ``.tmp`` files, then the
    newest file is tried, and one that does not load or fails its manifest
    (``verify``) is passed over with a warning for the next-older one; at
    W>1 the ranks walk rank 0's list and agree on each file. If every file
    fails, ``RuntimeError``. An explicit ``step`` never falls back. A
    checkpoint saved at another ``world_size`` (``restore_elastic`` takes
    it), another ``grad_accum_steps``, another ``zero_sharding`` or on
    another device type raises ``ValueError`` naming the field, before the
    state is touched. ``journal`` records each verified file and each
    fall back (``checkpoint/fallback``)."""
    if step is not None:
        ckpt = load_checkpoint(directory, step, verify)
        _journal_verified(journal, directory, step, verify)
        _apply(ckpt, checkpoint_path(directory, step), state, config)
        return step
    _sweep_stale_tmps(directory)
    steps = _agreed_steps(all_steps(directory))
    if not steps:
        raise FileNotFoundError(
            f"no checkpoint ckpt_<step>.pt in {directory!r} (TrainConfig.checkpoint_dir)")
    errors = []
    for candidate in reversed(steps):
        try:
            ckpt, err = load_checkpoint(directory, candidate, verify), None
            _journal_verified(journal, directory, candidate, verify)
        except Exception as e:  # a torn or corrupt file: try an older one
            ckpt, err = None, e
        if _all_ranks(err is None):
            _apply(ckpt, checkpoint_path(directory, candidate), state, config)
            return candidate
        if err is not None:
            errors.append((candidate, err))
            _log.warning("checkpoint ckpt_%d.pt in %s failed to restore (%s: %s); trying "
                         "an older one", candidate, directory, type(err).__name__, err)
            reason = f"{type(err).__name__}: {err}"
        else:
            _log.warning("checkpoint ckpt_%d.pt in %s loaded here but failed on another "
                         "rank; trying an older one", candidate, directory)
            reason = "peer process failed to restore it"
        if journal is not None:
            try:
                journal.emit("checkpoint/fallback", int(candidate),
                             detail={"rejected_step": int(candidate), "reason": reason})
            except Exception:
                pass
    raise RuntimeError(
        f"all {len(steps)} checkpoints in {directory} failed to restore"
        + (f"; the newest error here: {errors[0][1]!r}" if errors
           else " (the failures were on other ranks)"))


def _apply(ckpt: Dict[str, Any], path: str, state: MercuryState, config: TrainConfig
           ) -> None:
    """Check that ``ckpt`` belongs to a run like this one, then load it
    into ``state``."""
    device = state.stream.perm.device
    for field, have in (("format", FORMAT), ("world_size", config.world_size),
                        ("zero_sharding", config.zero_sharding),
                        ("grad_accum_steps", config.grad_accum_steps),
                        ("device", device.type)):
        saved = ckpt.get(field, False)
        if saved != have:
            hint = (" (restore_elastic restores it at another world size)"
                    if field == "world_size" else "")
            raise ValueError(
                f"{path} was saved with {field}={saved!r}, this run has {field}={have!r}: "
                f"a restore takes only the same one{hint}")
    row = ckpt["ranks"][_data(state)[1]]
    if (row["table"] is None) != (state.scoretable is None):
        raise ValueError(f"{path} and this run differ in sampler: one keeps a "
                         "score table, the other does not")
    for key, _, field in _CARRIED:
        if (row.get(key) is None) != (getattr(state, key) is None):
            raise ValueError(f"{path} and this run differ in {field}: one carries "
                             f"a {key}, the other does not")
    if row.get("pending") is not None and not config.host_stream:
        raise ValueError(f"{path} was saved by a data_placement='host_stream' run (its "
                         "stream and generator are depth steps ahead): restore it into one")
    saved = row.get("pending")
    if saved is not None and len(saved["draws"]) != config.prefetch_depth:
        raise ValueError(f"{path} was saved with prefetch_depth={len(saved['draws'])}, "
                         f"this run has prefetch_depth={config.prefetch_depth}")
    # A sharded model keeps its slices of the whole tensors.
    load_full_state_dict(state.model, ckpt["model"])
    own = row if config.zero_sharding else ckpt
    state.optimizer.load_state_dict(local_optimizer_state(state.model, own["optimizer"]))
    if state.accum is not None:
        accum = own["accum"] if config.zero_sharding else local_like_params(
            state.model, own["accum"])
        for acc, saved_acc in zip(state.accum, accum):
            acc.copy_(saved_acc)
    state.step, state.updates, state.mini_step = (
        ckpt["step"], ckpt["updates"], ckpt["mini_step"])
    state.ema = EMAState(row["ema_value"].to(device), row["ema_count"].to(device))
    state.stream = ShardStream(row["perm"].to(device), row["cursor"])
    state.generator.set_state(row["generator"])
    if state.scoretable is not None:
        state.scoretable = ScoreTableState(row["table"].to(device), row["table_cursor"])
    if state.sel_counts is not None:
        counts = row.get("sel_counts")
        state.sel_counts = (torch.zeros_like(state.sel_counts) if counts is None
                            else counts.to(device))
    state.pending = None if saved is None else pending_from_host(saved, device)
    for key, cls, _ in _CARRIED:
        setattr(state, key, carried_from_host(cls, row.get(key), device))
