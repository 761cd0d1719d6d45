"""Durable checkpoints of the port (``train/checkpoint.py``) on the CPU:
the cases of the JAX package's ``TestDurability``, ``TestCrashSafety``,
``TestAsyncCheckpoint`` and ``TestSweepStaleTmps`` (``tests/test_checkpoint.py``)
held for the port's own file format.

The sha256 sidecar is written beside every file and checked on restore; a
flipped byte makes the restore fall back to the older file, bit-equal to an
explicit restore of it; the per-tensor digest names the damaged tensor; a
missing or corrupt sidecar means an unverified restore; write retries count
every failed attempt and prune nothing after a failure; the async save
writes the state of its step although the run has moved on, and ``join``
(or ``fit``) raises a writer's error; at two gloo ranks a read failure on one
rank moves both to the older file. Every comparison is exact. Tiny sizes: a
[1, 1]-stage ResNet of width 8, batch 4, a pool of 16.
"""

import hashlib
import json
import logging
import os
import threading
import time

import pytest

torch = pytest.importorskip("torch")

from mercury_tpu_torch import TrainConfig, Trainer  # noqa: E402
from mercury_tpu_torch.faults import FaultPlane  # noqa: E402
from mercury_tpu_torch.parallel.distributed import spawn  # noqa: E402
from mercury_tpu_torch.train import checkpoint  # noqa: E402
from test_torch_port_ranks import fallback_rank, state_tensors, tiny_resnet  # noqa: E402

COMMON = dict(dataset="synthetic", world_size=1, batch_size=4, presample_batches=4,
              compute_dtype="float32", num_epochs=1, steps_per_epoch=8, eval_every=0,
              log_every=0, seed=0)


@pytest.fixture(autouse=True, scope="module")
def one_intra_op_thread():
    """One intra-op thread: the tiny steps run 30-50× slower with torch's
    thread pool on cores the test workers share."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _trainer(seed=0, **kw) -> Trainer:
    return Trainer(TrainConfig(**{**COMMON, **kw}), device="cpu", model=tiny_resnet(seed=seed))


def _assert_equal(got: dict, want: dict, what: str) -> None:
    assert got.keys() == want.keys(), what
    differ = [k for k in want if not torch.equal(got[k], want[k])]
    assert not differ, f"{what}: {differ}"


def _two_saves(d):
    """A trainer saved after steps 1 and 2 into ``d``; its state at each."""
    tr = _trainer()
    states = {}
    for _ in range(2):
        tr.train_step()
        tr.save(d)
        states[tr.state.step] = state_tensors(tr.state)
    return tr, states


def _tensor_offset(path, t) -> int:
    """Where the bytes of ``t`` (a distinctive tensor) lie in the file."""
    blob = open(path, "rb").read()
    at = blob.find(t.contiguous().view(torch.uint8).numpy().tobytes())
    assert at > 0
    return at


def _flip(path, at: int) -> None:
    blob = bytearray(open(path, "rb").read())
    blob[at] ^= 0xFF
    open(path, "wb").write(bytes(blob))


def _sha(path) -> str:
    return hashlib.sha256(open(path, "rb").read()).hexdigest()


# ----------------------------------------------------------------- manifests
def test_manifest_sidecar_written_and_verified(tmp_path):
    d = str(tmp_path)
    tr = _trainer()
    tr.train_step()
    path = tr.save(d)
    doc = json.loads(open(checkpoint.manifest_path(path)).read())
    assert doc["schema"] == "mercury-ckpt-manifest-v1" and doc["step"] == 1
    assert doc["file"] == "ckpt_1.pt" and doc["format"] == checkpoint.FORMAT
    assert doc["bytes"] == os.path.getsize(path) and doc["sha256"] == _sha(path)
    payload = torch.load(path, weights_only=True)
    assert doc["tensors"] == checkpoint.tensor_digests(payload)
    assert {"model/conv.weight", "ranks/0/ema_value", "ranks/0/generator",
            "optimizer/state/0/exp_avg"} <= set(doc["tensors"])
    assert doc["tensors"]["model/conv.weight"] == hashlib.sha256(
        payload["model"]["conv.weight"].numpy().tobytes()).hexdigest()
    fresh = _trainer(seed=1)
    assert fresh.restore(d) == 1
    _assert_equal(state_tensors(fresh.state), state_tensors(tr.state), "verified restore")
    times = checkpoint.timings()
    assert times["verify_s"] > 0 and times["digest_s"] > 0 and times["write_s"] > 0


def test_manifest_off_writes_no_sidecar(tmp_path):
    tr = _trainer(checkpoint_manifest=False)
    path = tr.save(str(tmp_path))
    assert os.listdir(tmp_path) == ["ckpt_0.pt"] and os.path.exists(path)
    assert checkpoint.timings()["digest_s"] == 0.0


def test_bitflip_falls_back_bit_identically(tmp_path):
    """A flipped byte inside a tensor of the newest file (which still
    loads: the silent corruption a torn-file check misses) is caught by the
    file's digest; the restore falls back to step 1, bit-equal to an
    explicit restore of it, and both continue equal."""
    d = str(tmp_path)
    tr, states = _two_saves(d)
    newest = checkpoint.checkpoint_path(d, 2)
    _flip(newest, _tensor_offset(newest, tr.state.model.conv.weight.detach()) + 5)
    walked = _trainer(seed=1)
    assert walked.restore(d) == 1
    explicit = _trainer(seed=1)
    assert explicit.restore(d, step=1) == 1
    _assert_equal(state_tensors(walked.state), states[1], "fallback vs saved step 1")
    for _ in range(2):
        a, b = walked.train_step(), explicit.train_step()
        assert torch.equal(a["train/loss"], b["train/loss"])
    _assert_equal(state_tensors(walked.state), state_tensors(explicit.state),
                  "continued fallback vs explicit")
    with pytest.raises(ValueError, match="ckpt_2.pt sha256 mismatch"):
        checkpoint.load_checkpoint(d, 2, verify=True)
    # Unverified, the flipped file loads, with the flipped value in it.
    raw = checkpoint.load_checkpoint(d, 2, verify=False)
    assert not torch.equal(raw["model"]["conv.weight"], tr.state.model.conv.weight)


def test_auto_resume_falls_back_and_warns(tmp_path):
    d = str(tmp_path)
    tr, states = _two_saves(d)
    newest = checkpoint.checkpoint_path(d, 2)
    _flip(newest, _tensor_offset(newest, tr.state.model.conv.weight.detach()))
    kept = _Kept()
    checkpoint._log.addHandler(kept)
    try:
        resumed = _trainer(seed=1, checkpoint_dir=d, auto_resume=True)
    finally:
        checkpoint._log.removeHandler(kept)
    assert resumed.state.step == 1
    _assert_equal(state_tensors(resumed.state), states[1], "auto_resume fallback")
    assert any("ckpt_2.pt" in m and "sha256 mismatch" in m for m in kept.messages), kept.messages


class _Kept(logging.Handler):
    """Keeps each record's message."""

    def __init__(self):
        super().__init__()
        self.messages = []

    def emit(self, record):
        self.messages.append(record.getMessage())


@pytest.mark.parametrize("where", ["manifest", "payload"])
def test_per_tensor_digest_names_the_damaged_tensor(tmp_path, where):
    """The whole-file digest passes (the sidecar's entry tampered with, or
    a flipped value with the file's digest brought up to date), and the
    per-tensor digest rejects the file naming the tensor."""
    d = str(tmp_path)
    tr = _trainer()
    tr.train_step()
    path = tr.save(d)
    man = checkpoint.manifest_path(path)
    doc = json.loads(open(man).read())
    if where == "manifest":
        doc["tensors"]["model/fc.weight"] = "0" * 64
        key = "model/fc.weight"
    else:
        _flip(path, _tensor_offset(path, tr.state.model.conv.weight.detach()))
        doc["sha256"] = _sha(path)
        key = "model/conv.weight"
    open(man, "w").write(json.dumps(doc))
    with pytest.raises(ValueError, match=f"tensor '{key}' sha256 mismatch"):
        checkpoint.load_checkpoint(d, 1, verify=True)
    with pytest.raises(RuntimeError, match="failed to restore"):
        _trainer(seed=1).restore(d)
    assert _trainer(seed=1, checkpoint_verify=False).restore(d) == 1


@pytest.mark.parametrize("sidecar", ["missing", "garbage", "other-schema"])
def test_missing_or_corrupt_sidecar_restores_unverified(tmp_path, sidecar):
    d = str(tmp_path)
    tr = _trainer()
    tr.train_step()
    path = tr.save(d)
    man = checkpoint.manifest_path(path)
    if sidecar == "missing":
        os.unlink(man)
    elif sidecar == "garbage":
        open(man, "w").write("{not json")
    else:
        doc = json.loads(open(man).read())
        doc["schema"], doc["sha256"] = "another-v9", "0" * 64
        open(man, "w").write(json.dumps(doc))
    fresh = _trainer(seed=1)
    assert fresh.restore(d) == 1
    _assert_equal(state_tensors(fresh.state), state_tensors(tr.state), "unverified")
    assert checkpoint.timings()["verify_s"] == 0.0


# --------------------------------------------------------------- crash safety
def test_stray_tmp_is_no_checkpoint_and_torn_newest_falls_back(tmp_path):
    """A crash's ``.tmp`` of a newer step is not listed; a torn newest file
    (cut in half) is passed over for the older one."""
    d = str(tmp_path)
    _, states = _two_saves(d)
    (tmp_path / "ckpt_9.pt.tmp").write_bytes(b"partial")
    assert checkpoint.latest_step(d) == 2
    newest = checkpoint.checkpoint_path(d, 2)
    data = open(newest, "rb").read()
    open(newest, "wb").write(data[: len(data) // 2])
    os.unlink(checkpoint.manifest_path(newest))
    fresh = _trainer(seed=1)
    assert fresh.restore(d) == 1
    _assert_equal(state_tensors(fresh.state), states[1], "torn newest")


def test_all_corrupt_raises_and_explicit_step_never_falls_back(tmp_path):
    d = str(tmp_path)
    tr, _ = _two_saves(d)
    newest = checkpoint.checkpoint_path(d, 2)
    _flip(newest, _tensor_offset(newest, tr.state.model.conv.weight.detach()))
    with pytest.raises(ValueError, match="sha256 mismatch"):
        _trainer(seed=1).restore(d, step=2)
    (tmp_path / "ckpt_1.pt").write_bytes(b"garbage")
    fresh = _trainer(seed=1)
    with pytest.raises(RuntimeError, match="all 2 checkpoints .* failed to restore"):
        fresh.restore(d)
    assert fresh.state.step == 0


# ------------------------------------------------------------ writes, retries
def test_directory_is_flushed_after_each_rename(tmp_path, monkeypatch):
    """The payload's and the sidecar's renames are each followed by an
    fsync of the directory."""
    synced = []
    monkeypatch.setattr(checkpoint, "_fsync_dir", synced.append)
    path = _trainer().save(str(tmp_path))
    assert synced == [path, checkpoint.manifest_path(path)]


def test_keep_prunes_payload_and_sidecar(tmp_path):
    d = str(tmp_path)
    tr = _trainer(checkpoint_keep=2)
    for _ in range(4):
        tr.train_step()
        tr.save(d)
    assert checkpoint.all_steps(d) == [3, 4]
    assert sorted(os.listdir(d)) == ["ckpt_3.pt", "ckpt_3.pt.manifest.json",
                                     "ckpt_4.pt", "ckpt_4.pt.manifest.json"]


def test_retry_absorbs_one_failure_and_counts_it(tmp_path):
    faults = FaultPlane("ckpt_io_error@step=0")
    tr = _trainer()
    before = checkpoint.write_failures()
    path = checkpoint.save_checkpoint(str(tmp_path), tr.state, tr.config, retries=1,
                                      retry_backoff_s=0.01, manifest=True, faults=faults)
    assert os.path.exists(path) and os.path.exists(checkpoint.manifest_path(path))
    assert checkpoint.write_failures() == before + 1
    assert faults.stats() == {"fault/injected": 1.0, "fault/armed": 0.0}


def test_exhausted_retries_raise_count_every_attempt_and_prune_nothing(tmp_path):
    d = str(tmp_path)
    tr = _trainer()
    tr.train_step()
    older = checkpoint.save_checkpoint(d, tr.state, tr.config, keep=1, manifest=True)
    tr.train_step()
    faults = FaultPlane("ckpt_io_error@step=0;ckpt_io_error@step=0")
    before = checkpoint.write_failures()
    with pytest.raises(OSError, match="ckpt_io_error"):
        checkpoint.save_checkpoint(d, tr.state, tr.config, keep=1, retries=1,
                                   retry_backoff_s=0.01, manifest=True, faults=faults)
    assert checkpoint.write_failures() == before + 2
    assert sorted(os.listdir(d)) == [os.path.basename(older),
                                     os.path.basename(older) + ".manifest.json"]


def test_fit_counts_a_retried_write_in_its_record(tmp_path):
    """``ckpt_io_error@step=4`` arms when the clock reads 4; fit's clock
    is the step count before each step, so the save of step 4 runs at 3
    and the fault fires at step 6's. The write lands at its second attempt,
    and the next log record carries one more ``checkpoint/write_failures``."""
    tr = _trainer(checkpoint_dir=str(tmp_path), checkpoint_every=2, log_every=2,
                  fault_spec="ckpt_io_error@step=4", checkpoint_retry_backoff_s=0.01)
    records = []
    tr.logger.add_observer(lambda r: records.append(dict(r)))
    before = checkpoint.write_failures()
    tr.fit(steps=8)
    tr.logger.flush()
    by_step = {int(r["step"]): r for r in records if "checkpoint/write_failures" in r}
    assert sorted(by_step) == [2, 4, 6, 8]
    assert [by_step[s]["checkpoint/write_failures"] - before for s in (2, 4, 6, 8)] == [
        0, 0, 0, 1]
    assert by_step[8]["fault/injected"] == 1.0 and by_step[8]["fault/armed"] == 0.0
    assert checkpoint.all_steps(str(tmp_path)) == [4, 6, 8]
    tr.close()


def test_fit_raises_when_every_write_fails(tmp_path):
    tr = _trainer(checkpoint_dir=str(tmp_path), checkpoint_every=1,
                  fault_spec="ckpt_io_error@step=0,every=1", checkpoint_write_retries=0)
    with pytest.raises(OSError, match="ckpt_io_error"):
        tr.fit(steps=3)
    assert os.listdir(tmp_path) == []


# --------------------------------------------------------------------- async
def test_async_save_round_trips(tmp_path):
    tr = _trainer()
    tr.train_step()
    handle = checkpoint.save_checkpoint_async(str(tmp_path), tr.state, tr.config,
                                              manifest=True)
    handle.join()
    assert handle.done() and handle.failed() is None
    fresh = _trainer(seed=1)
    assert fresh.restore(str(tmp_path)) == 1
    _assert_equal(state_tensors(fresh.state), state_tensors(tr.state), "async round trip")


def test_async_file_holds_the_state_of_its_step(tmp_path, monkeypatch):
    """The writer is held until the run has taken two more steps (whose
    Adam updates change the parameters and moments in place): the file
    still holds the state at the step of the save."""
    tr = _trainer()
    tr.train_step()
    at_save = state_tensors(tr.state)
    go = threading.Event()
    save = torch.save

    def held(obj, f, *args, **kwargs):
        assert go.wait(30)
        return save(obj, f, *args, **kwargs)

    monkeypatch.setattr(checkpoint.torch, "save", held)
    handle = checkpoint.save_checkpoint_async(str(tmp_path), tr.state, tr.config,
                                              manifest=True)
    for _ in range(2):
        tr.train_step()
    assert not handle.done()
    go.set()
    handle.join()
    monkeypatch.undo()
    fresh = _trainer(seed=1)
    assert fresh.restore(str(tmp_path)) == 1
    _assert_equal(state_tensors(fresh.state), at_save, "async file vs state at its step")
    assert not torch.equal(at_save["model.conv.weight"], tr.state.model.conv.weight)


def test_async_failure_cb_fires_on_the_writer_and_join_reraises(tmp_path):
    tr = _trainer()
    seen = []

    def cb(exc):
        seen.append((exc, threading.current_thread().name))

    handle = checkpoint.save_checkpoint_async(
        str(tmp_path), tr.state, tr.config, faults=FaultPlane("ckpt_io_error@step=0"),
        failure_cb=cb)
    with pytest.raises(OSError, match="ckpt_io_error"):
        handle.join()
    assert handle.done() and isinstance(handle.failed(), OSError)
    ((exc, thread),) = seen
    assert isinstance(exc, OSError) and thread == "ckpt-write-0"
    assert os.listdir(tmp_path) == []


def test_fit_with_async_leaves_no_write_in_flight(tmp_path):
    d = str(tmp_path)
    tr = _trainer(checkpoint_dir=d, checkpoint_every=3, async_checkpoint=True)
    tr.fit(steps=7)
    assert tr._ckpt_thread is None
    assert not [t for t in threading.enumerate() if t.name.startswith("ckpt-write-")]
    assert checkpoint.all_steps(d) == [3, 6, 7]
    assert all(os.path.exists(checkpoint.manifest_path(checkpoint.checkpoint_path(d, s)))
               for s in (3, 6, 7))
    fresh = _trainer(seed=1)
    assert fresh.restore(d) == 7
    _assert_equal(state_tensors(fresh.state), state_tensors(tr.state), "fit async")


def test_fit_with_async_raises_a_failed_write(tmp_path):
    tr = _trainer(checkpoint_dir=str(tmp_path), checkpoint_every=2, async_checkpoint=True,
                  fault_spec="ckpt_io_error@step=0,every=1", checkpoint_write_retries=0)
    with pytest.raises(OSError, match="ckpt_io_error"):
        tr.fit(steps=5)
    assert tr._ckpt_thread is None
    assert not [t for t in threading.enumerate() if t.name.startswith("ckpt-write-")]


# ---------------------------------------------------------------- stale tmps
def _aged(d, name, age_s):
    path = d / name
    path.write_bytes(b"x")
    then = time.time() - age_s
    os.utime(str(path), (then, then))
    return path


def test_sweep_age_boundary(tmp_path):
    stale = _aged(tmp_path, "ckpt_3.pt.tmp", 400.0)
    at_boundary = _aged(tmp_path, "ckpt_4.pt.tmp", 301.0)
    sidecar = _aged(tmp_path, "ckpt_3.pt.manifest.json.tmp", 400.0)
    fresh = _aged(tmp_path, "ckpt_5.pt.tmp", 0.0)
    checkpoint._sweep_stale_tmps(str(tmp_path))
    assert not stale.exists() and not at_boundary.exists() and not sidecar.exists()
    assert fresh.exists()


def test_sweep_leaves_what_is_not_a_tmp(tmp_path):
    payload = _aged(tmp_path, "ckpt_1.pt", 9999.0)
    sidecar = _aged(tmp_path, "ckpt_1.pt.manifest.json", 9999.0)
    checkpoint._sweep_stale_tmps(str(tmp_path), min_age_s=1.0)
    assert payload.exists() and sidecar.exists()


def test_sweep_custom_min_age(tmp_path):
    young = _aged(tmp_path, "ckpt_2.pt.tmp", 5.0)
    checkpoint._sweep_stale_tmps(str(tmp_path), min_age_s=60.0)
    assert young.exists()
    checkpoint._sweep_stale_tmps(str(tmp_path), min_age_s=1.0)
    assert not young.exists()


def test_sweep_only_on_rank_0_and_on_the_restore_walk(tmp_path, monkeypatch):
    stale = _aged(tmp_path, "ckpt_9.pt.tmp", 9999.0)
    monkeypatch.setattr(checkpoint, "rank", lambda: 1)
    checkpoint._sweep_stale_tmps(str(tmp_path), min_age_s=1.0)
    assert stale.exists()
    monkeypatch.undo()
    checkpoint._sweep_stale_tmps(str(tmp_path / "never_created"))
    tr = _trainer()
    tr.save(str(tmp_path))
    _trainer(seed=1).restore(str(tmp_path))
    assert not stale.exists()


# ------------------------------------------------------------------ two ranks
def test_two_ranks_agree_on_the_fallback(tmp_path):
    """W=2 over gloo: rank 1 alone fails to read the newest file; both
    ranks restore step 1, each bit-equal to its explicit restore of it."""
    ranks = spawn(fallback_rank, 2, "gloo", {**COMMON, "world_size": 2}, str(tmp_path))
    assert [r["step"] for r in ranks] == [1, 1]
    for r in ranks:
        _assert_equal(r["walked"], r["explicit"], f"rank {r['rank']} walked vs explicit")
    assert not torch.equal(ranks[0]["walked"]["stream.perm"], ranks[1]["walked"]["stream.perm"])
