"""Async scoring at two ranks: the device backend's lockstep, on the CPU.

One spawn of two gloo ranks (the rank body is
``test_torch_port_ranks.lockstep_rank``) with ``scorer_backend="device"``
and ``snapshot_every=2``:

- each rank's ``score_once`` chunk is row ``r`` of the ``[2, R]`` chunk of
  a JAX ``ScorerService`` with ``jax.process_count`` patched to 2 (as the
  JAX package's lockstep test does), the port fed JAX's crops and flips of
  ``split(fold_in(base, seq), 2)[r]`` (rtol 1e-5);
- ``Trainer.fit(steps=8)``, twice: chunk ``q`` carries snapshot ``q``'s
  step and is applied at the tick after snapshot ``q+1``, on every rank
  (JAX's ``test_lockstep_delivers_one_snapshot_behind``), and each rank's
  final table is bit-equal between the two runs;
- a restore in a live run (to step 4, after step 6's snapshot armed a
  chunk of the old trajectory) applies no chunk of the old trajectory, and
  the run goes on bit for bit as a fresh Trainer restored from the same
  checkpoint (which drops the chunk its own step-0 snapshot armed);
- ``cards_in_use`` gathers every rank's card, and ``reserve_scorer_device``
  picks the first card no rank trains on.

Sizes: the tiny ResNet, batch 4, windows of 8, 64 images in two Dirichlet
shards.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from mercury_tpu.config import TrainConfig as JConfig  # noqa: E402
from mercury_tpu.parallel.mesh import host_cpu_mesh  # noqa: E402
from mercury_tpu.sampling import scorer_service as jsvc_mod  # noqa: E402
from mercury_tpu_torch.data import cifar  # noqa: E402
from mercury_tpu_torch.data.partition import partition_data  # noqa: E402
from mercury_tpu_torch.data.pipeline import make_sharded_dataset  # noqa: E402
from mercury_tpu_torch.parallel.distributed import reserve_scorer_device, spawn  # noqa: E402

from test_torch_port_async_scoring import (  # noqa: E402, F401
    COMMON,
    MEAN,
    N_TRAIN,
    R,
    STD,
    _augment,
    _jax_model,
    _port_model,
    jax_weights,
)
from test_torch_port_ranks import lockstep_rank  # noqa: E402

W, STEPS, EVERY, RUNS, RESTORE_AT = 2, 8, 2, 2, 4


@pytest.fixture(scope="module")
def lockstep(jax_weights, tmp_path_factory):
    js, params, stats = jax_weights
    (x, y), (xt, yt) = cifar.synthetic_cifar(10, N_TRAIN, 8, seed=0)
    shards = partition_data(y, W, "hetero", alpha=0.5, seed=0, min_size=10)
    shard_indices = make_sharded_dataset((x, y), (xt, yt), shards, MEAN, STD, 10,
                                         device=torch.device("cpu")).shard_indices.numpy()
    config_kw = dict(COMMON, world_size=W, scorer_backend="device", snapshot_every=EVERY,
                     eval_every=0, log_every=0)

    mp = pytest.MonkeyPatch()
    mp.setattr(jax, "process_count", lambda: W)
    try:
        jsvc = jsvc_mod.ScorerService(
            x, y, shard_indices, _jax_model(), MEAN, STD,
            JConfig(model="resnet18", **{**COMMON, "scorer_backend": "device"}),
            train_mesh=host_cpu_mesh(W))
        assert jsvc.summary()["lockstep"]
        jsvc.close()
        jsvc.snapshot(js.params, js.batch_stats, 5)
        jchunks = [jsvc.score_once() for _ in range(2)]
    finally:
        mp.undo()
    base = jax.random.fold_in(jax.random.key(0), 0x5C0)
    augs = [[_augment(k, R) for k in jax.random.split(jax.random.fold_in(base, seq), W)]
            for seq in range(2)]
    state_dict = _port_model(params, stats).state_dict()
    results = spawn(lockstep_rank, W, "gloo", config_kw,
                    (x, y, xt, yt, shards, MEAN, STD), state_dict, augs, RUNS, STEPS,
                    str(tmp_path_factory.mktemp("lockstep_ckpt")), RESTORE_AT)
    return dict(results=results, jchunks=jchunks, shard_len=shard_indices.shape[1])


@pytest.mark.parametrize("rank", range(W))
def test_rank_chunk_is_jax_row(lockstep, rank):
    out = lockstep["results"][rank]
    assert out["summary"]["lockstep"] and out["summary"]["chunk_shape"] == [1, R]
    for k, (c, jc) in enumerate(zip(out["chunks"], lockstep["jchunks"])):
        assert c.step == jc.step == 5
        np.testing.assert_array_equal(c.slots.numpy(), jc.slots[rank])
        np.testing.assert_array_equal(c.slots.numpy(),
                                      (k * R + np.arange(R)) % lockstep["shard_len"])
        np.testing.assert_allclose(c.scores.numpy(), jc.scores[rank], rtol=1e-5,
                                   err_msg=f"rank {rank} chunk {k}")


@pytest.mark.parametrize("rank", range(W))
def test_lockstep_delivers_one_snapshot_behind(lockstep, rank):
    """Snapshots at 0, 2, 4, 6, 8; chunk q (snapshot q's step) is queued
    at snapshot q+1 and applied at the next tick, in every run."""
    for run in lockstep["results"][rank]["runs"]:
        assert run["snapshots"] == list(range(0, STEPS + 1, EVERY))
        assert run["applied"] == [(s + EVERY + 1, s) for s in range(0, STEPS - EVERY, EVERY)]
        assert np.isfinite(run["loss"])
        assert len(run["waits"]) == STEPS // EVERY
        summary = run["summary"]
        assert summary["lockstep"] and summary["chunks_applied"] == len(run["applied"])
        assert summary["tenants"][0]["discarded"] == 0


@pytest.mark.parametrize("rank", range(W))
def test_lockstep_tables_are_bit_equal_across_runs(lockstep, rank):
    runs = lockstep["results"][rank]["runs"]
    assert len(runs) == RUNS
    assert torch.equal(runs[0]["table"], runs[1]["table"])
    assert runs[0]["loss"] == runs[1]["loss"]
    # Each rank's table is of its own shard.
    assert not torch.equal(runs[0]["table"], lockstep["results"][1 - rank]["runs"][0]["table"])


@pytest.mark.parametrize("rank", range(W))
def test_lockstep_restore_drops_the_old_trajectory(lockstep, rank):
    """After the restore to step 4 only the restored run's chunks are
    applied: snapshot 4's at the tick after snapshot 6, as in a run never
    interrupted; the old trajectory's chunk (snapshot 6 of the live run,
    snapshot 0 of the fresh Trainer), ready long before the restore, is
    dropped."""
    restored = lockstep["results"][rank]["restored"]
    for name in ("live", "fresh"):
        run = restored[name]
        assert run["step"] == RESTORE_AT, name
        assert run["snapshots"] == list(range(RESTORE_AT, STEPS + 1, EVERY)), name
        assert run["applied"] == [(RESTORE_AT + EVERY + 1, RESTORE_AT)], name
        assert run["summary"]["snapshot_step"] == STEPS, name
        assert np.isfinite(run["loss"]), name


@pytest.mark.parametrize("rank", range(W))
def test_lockstep_restore_matches_a_fresh_restore(lockstep, rank):
    restored = lockstep["results"][rank]["restored"]
    assert torch.equal(restored["live"]["table"], restored["fresh"]["table"])
    assert restored["live"]["loss"] == restored["fresh"]["loss"]


@pytest.mark.parametrize("rank", range(W))
def test_cards_in_use_gathers_every_rank(lockstep, rank):
    cards = lockstep["results"][rank]["cards"]
    assert cards == [2, 3]
    own = torch.device("cuda", 2 + rank)
    assert reserve_scorer_device(own, cards, visible=4) == torch.device("cuda", 0)
    assert reserve_scorer_device(own, [0, 1, *cards], visible=4) == own
