"""Checkpoints of the port (``train/checkpoint.py``, ``Trainer.save`` /
``restore``, the cadence of ``fit`` and ``auto_resume``) on the CPU.

A run saved in the middle of an accumulation window (``grad_accum_steps=2``)
and resumed in a fresh ``Trainer`` continues bit for bit: every tensor and
cursor (``test_torch_port_ranks.state_tensors``) is ``torch.equal`` to the
uninterrupted run's, for the pool step, for the scoretable step with the
fused ingest, and at two gloo ranks, where rank 0 alone writes the one
file and each rank gets its own sampler state back. Tiny sizes: a [1,
1]-stage ResNet of width 8, batch 4, a pool of 16 (or a window of 8).
"""

import os

import pytest

torch = pytest.importorskip("torch")

from mercury_tpu_torch import TrainConfig, Trainer  # noqa: E402
from mercury_tpu_torch.parallel.distributed import spawn  # noqa: E402
from mercury_tpu_torch.train import checkpoint  # noqa: E402
from test_torch_port_ranks import checkpoint_rank, tiny_resnet  # noqa: E402

COMMON = dict(dataset="synthetic", world_size=1, batch_size=4, presample_batches=4,
              compute_dtype="float32", num_epochs=1, steps_per_epoch=6, eval_every=0,
              log_every=0, seed=0, grad_accum_steps=2)
PATHS = {"pool": {},
         "scoretable-fused": dict(sampler="scoretable", refresh_size=8, fused_input=True)}


def _trainer(**kw) -> Trainer:
    return Trainer(TrainConfig(**{**COMMON, **kw}), device="cpu", model=tiny_resnet(seed=0))


def _assert_equal(got: dict, want: dict, what: str) -> None:
    assert got.keys() == want.keys(), what
    differ = [k for k in want if not torch.equal(got[k], want[k])]
    assert not differ, f"{what}: {differ}"


@pytest.mark.parametrize("path", list(PATHS))
def test_resume_mid_window_is_bit_exact(tmp_path, path):
    """Saved after three microsteps (an update, then the middle of the
    next window), resumed in a fresh Trainer with other weights, three more
    microsteps (an update among them): the restored state is the saved one
    and both runs end equal."""
    threads = torch.get_num_threads()
    try:
        out = checkpoint_rank({**COMMON, **PATHS[path]}, str(tmp_path), 3, 3)
    finally:
        torch.set_num_threads(threads)
    assert out["step"] == 3 and int(out["saved"]["mini_step"]) == 1
    assert int(out["saved"]["updates"]) == 1
    assert sorted(os.listdir(tmp_path)) == ["ckpt_3.pt", "ckpt_3.pt.manifest.json"]
    _assert_equal(out["restored"], out["saved"], "restored vs saved")
    _assert_equal(out["resumed"], out["live"], "resumed vs uninterrupted")
    assert int(out["live"]["updates"]) == 3 and int(out["live"]["step"]) == 6
    assert ("table.scores" in out["live"]) == (path != "pool")
    assert any(k.startswith("optimizer.") for k in out["saved"])


def test_cadence_keep_and_auto_resume(tmp_path):
    """checkpoint_every=2, checkpoint_keep=2: fit(steps=5) saves at 2 and 4 and
    at its end, and keeps the newest two; a Trainer with auto_resume starts
    from step 5, and fit() ends at total_steps (6) with a final save."""
    d = str(tmp_path)
    kw = dict(checkpoint_dir=d, checkpoint_every=2, checkpoint_keep=2)
    first = _trainer(**kw)
    first.fit(steps=5)
    assert checkpoint.all_steps(d) == [4, 5]
    assert sorted(os.listdir(d)) == ["ckpt_4.pt", "ckpt_4.pt.manifest.json",
                                     "ckpt_5.pt", "ckpt_5.pt.manifest.json"]
    resumed = _trainer(auto_resume=True, **kw)
    assert resumed.state.step == 5 and resumed.state.mini_step == 1
    assert resumed.total_steps == 6
    resumed.fit()
    assert resumed.state.step == 6 and resumed.state.updates == 3
    assert checkpoint.all_steps(d) == [5, 6]
    # Without auto_resume the directory is not read.
    assert _trainer(**kw).state.step == 0


def test_checkpoint_every_zero_saves_only_at_the_end(tmp_path):
    tr = _trainer(checkpoint_dir=str(tmp_path), checkpoint_every=0, checkpoint_keep=0)
    tr.fit(steps=3)
    tr.fit(steps=2)
    assert checkpoint.all_steps(str(tmp_path)) == [3, 5]


def _edit(path, **fields):
    """Rewrite the file with ``fields`` changed; its sha256 sidecar no
    longer describes it and goes, so the file restores unverified."""
    ckpt = torch.load(path, weights_only=True)
    ckpt.update(fields)
    torch.save(ckpt, path)
    os.unlink(checkpoint.manifest_path(path))


@pytest.mark.parametrize("field,edit,kw", [
    ("world_size", dict(world_size=2), {}),
    ("grad_accum_steps", None, dict(grad_accum_steps=1)),
    ("device", dict(device="cuda"), {}),
    ("sampler", None, PATHS["scoretable-fused"]),
    ("format", dict(format=0), {}),
])
def test_restore_refuses_another_run(tmp_path, field, edit, kw):
    """A checkpoint of another world size (``restore_elastic`` takes it),
    another accumulation, another device type (a CUDA generator state
    cannot seed a CPU generator), another sampler or another file format
    raises before the state is touched."""
    src = _trainer()
    src.train_step()
    path = src.save(str(tmp_path))
    if edit:
        _edit(path, **edit)
    dst = _trainer(**kw)
    before = {k: v.clone() for k, v in dst.state.model.state_dict().items()}
    with pytest.raises(ValueError, match=field):
        dst.restore(str(tmp_path))
    assert dst.state.step == 0
    assert all(torch.equal(v, before[k]) for k, v in dst.state.model.state_dict().items())


def test_missing_directory_or_checkpoint_raises(tmp_path):
    tr = _trainer()
    with pytest.raises(ValueError, match="checkpoint_dir"):
        tr.save()
    with pytest.raises(ValueError, match="checkpoint_dir"):
        tr.restore()
    with pytest.raises(FileNotFoundError, match="checkpoint_dir"):
        tr.restore(str(tmp_path / "absent"))
    with pytest.raises(FileNotFoundError):
        tr.restore(str(tmp_path), step=7)


def test_torn_file_is_never_a_checkpoint(tmp_path):
    """A write cut short leaves only ``ckpt_<step>.pt.tmp``, which is not
    listed; a failed save removes its own temporary file."""
    d = str(tmp_path)
    (tmp_path / "ckpt_9.pt.tmp").write_bytes(b"torn")
    (tmp_path / "ckpt_x.pt").write_bytes(b"not a step")
    assert checkpoint.all_steps(d) == [] and checkpoint.latest_step(d) is None
    tr = _trainer(checkpoint_dir=d, auto_resume=True)
    assert tr.state.step == 0
    tr.train_step()
    tr.save()
    assert checkpoint.all_steps(d) == [1]

    def fail(*args, **kwargs):
        raise OSError("disk full")

    save, torch.save = torch.save, fail
    try:
        with pytest.raises(OSError, match="disk full"):
            tr.save()
    finally:
        torch.save = save
    assert sorted(os.listdir(d)) == ["ckpt_1.pt", "ckpt_1.pt.manifest.json",
                                     "ckpt_9.pt.tmp", "ckpt_x.pt"]


def test_two_ranks_one_writer_own_rows(tmp_path):
    """W=2 over gloo: the ranks save in the middle of a window, rank 0
    alone writes the one file, each rank gets back its own stream
    permutation (they differ) and both continuations are bit-equal."""
    kw = {**COMMON, "world_size": 2}
    ranks = spawn(checkpoint_rank, 2, "gloo", kw, str(tmp_path), 3, 3)
    assert sorted(os.listdir(tmp_path)) == ["ckpt_3.pt", "ckpt_3.pt.manifest.json"]
    path = str(tmp_path / "ckpt_3.pt")
    assert [r["path"] for r in ranks] == [path, path]
    assert [len(r["writes"]) for r in ranks] == [1, 0]
    assert ranks[0]["writes"][0].endswith("ckpt_3.pt.tmp")
    for r in ranks:
        assert r["step"] == 3 and int(r["saved"]["mini_step"]) == 1
        _assert_equal(r["restored"], r["saved"], f"rank {r['rank']} restored vs saved")
        _assert_equal(r["resumed"], r["live"], f"rank {r['rank']} resumed vs uninterrupted")
    perms = [r["restored"]["stream.perm"] for r in ranks]
    assert not torch.equal(perms[0], perms[1])
    assert not torch.equal(ranks[0]["saved"]["generator"], ranks[1]["saved"]["generator"])
    # The replicas stay equal.
    for k, v in ranks[0]["resumed"].items():
        if k.startswith(("model.", "optimizer.", "accum.")):
            assert torch.equal(v, ranks[1]["resumed"][k]), k
