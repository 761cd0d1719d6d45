"""Elastic restore of the port (``train/elastic.py``,
``Trainer.restore_elastic``, ``auto_resume`` across world sizes) on the
CPU, held to the JAX package's ``mercury_tpu/train/elastic.py``.

The resharding of ZeRO's chunks, the ``[W, L]`` shard index matrix and the
carried score table, ledger and cursors go through the JAX functions and
the port's on the same numpy inputs (the JAX functions read only
``trainer.config`` and ``trainer.dataset.y_train``, so a stub stands in for
its Trainer); every comparison is exact. Then whole runs: two gloo ranks
save (pool, ZeRO in the middle of an accumulation window, host_stream,
scoretable with its ledger) and one rank restores, and one rank saves and
two gloo ranks restore: the model, the BN buffers, the Adam moments and the
accumulator exact, the EMA the old ranks' mean with their largest count,
the steps going on with finite losses. Tiny sizes: a [1, 1]-stage ResNet of
width 8, batch 4, the 5000-image synthetic set.
"""

import collections
import shutil
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from mercury_tpu.train import elastic as jelastic  # noqa: E402
from mercury_tpu_torch import TrainConfig, Trainer  # noqa: E402
from mercury_tpu_torch.data.pipeline import ShardStream  # noqa: E402
from mercury_tpu_torch.models.resnet import BasicBlock, ResNet, init_weights  # noqa: E402
from mercury_tpu_torch.parallel.distributed import spawn  # noqa: E402
from mercury_tpu_torch.sampling.scoretable import ScoreTableState  # noqa: E402
from mercury_tpu_torch.train import checkpoint, elastic  # noqa: E402
from mercury_tpu_torch.utils.tree import zero_chunk_size  # noqa: E402
from test_torch_port_ranks import (  # noqa: E402
    elastic_restore_rank,
    elastic_save_rank,
    state_tensors,
    tiny_resnet,
)

COMMON = dict(dataset="synthetic", world_size=1, batch_size=4, presample_batches=4,
              compute_dtype="float32", num_epochs=1, steps_per_epoch=8, eval_every=0,
              log_every=0, seed=0)
ARMS = {"pool": {},
        "zero": dict(zero_sharding=True, grad_accum_steps=2),
        "stream": dict(data_placement="host_stream"),
        "table": dict(sampler="scoretable", refresh_size=8)}
SAVED_AT = 3   # the middle of the second window under grad_accum_steps=2
JStream = collections.namedtuple("JStream", "perm cursor")
JTable = collections.namedtuple("JTable", "scores cursor")


@pytest.fixture(autouse=True, scope="module")
def one_intra_op_thread():
    """One intra-op thread: the tiny steps run 30-50× slower with torch's
    thread pool on cores the test workers share."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def two_rank_files(tmp_path_factory):
    """Each arm at W=2 (one gloo spawn): three steps, then a save."""
    root = tmp_path_factory.mktemp("w2")
    dirs = {arm: str(root / arm) for arm in ARMS}
    jobs = [({**COMMON, **kw, "world_size": 2}, dirs[arm], SAVED_AT)
            for arm, kw in ARMS.items()]
    ranks = spawn(elastic_save_rank, 2, "gloo", jobs)
    assert all(np.isfinite(losses).all() for r in ranks for losses in r)
    return dirs


def _trainer(seed=1, **kw) -> Trainer:
    return Trainer(TrainConfig(**{**COMMON, **kw}), device="cpu", model=tiny_resnet(seed=seed))


def _raw(directory):
    return torch.load(checkpoint.checkpoint_path(directory, SAVED_AT), weights_only=True)


def _stub(labels, rank=0, state=None, **cfg):
    config = types.SimpleNamespace(**{**dict(noniid=True, dirichlet_alpha=0.5, seed=3,
                                              min_shard_size=10), **cfg})
    return types.SimpleNamespace(config=config, rank=rank, state=state,
                                 dataset=types.SimpleNamespace(y_train=labels))


# -------------------------------------------------- parity with the JAX functions
@pytest.mark.parametrize("w_old,w_new,n", [(2, 1, 10), (1, 2, 11), (2, 3, 7), (4, 2, 13),
                                           (3, 3, 9)])
def test_reshard_zero_opt_matches_the_jax_package(w_old, w_new, n):
    rng = np.random.default_rng(w_old * 10 + w_new)
    c_old, c_new = zero_chunk_size(n, w_old), zero_chunk_size(n, w_new)
    mu = np.zeros((w_old * c_old,), np.float32)
    nu = np.zeros((w_old * c_old,), np.float32)
    mu[:n], nu[:n] = rng.normal(size=n), rng.random(n)
    mu, nu = mu.reshape(w_old, c_old), nu.reshape(w_old, c_old)
    count = np.full((w_old,), 7, np.int32)
    want = jelastic._reshard_zero_opt(
        {"mu": mu, "nu": nu, "count": count},
        {"mu": np.zeros((w_new, c_new), np.float32), "nu": np.zeros((w_new, c_new), np.float32),
         "count": np.zeros((w_new,), np.int32)}, w_old, w_new, n)
    old = [{"step": torch.tensor(7.0), "exp_avg": torch.from_numpy(mu[r]),
            "exp_avg_sq": torch.from_numpy(nu[r])} for r in range(w_old)]
    got = elastic._reshard_zero_opt(old, w_new, n)
    assert len(got) == w_new
    np.testing.assert_array_equal(np.stack([g["exp_avg"].numpy() for g in got]), want["mu"])
    np.testing.assert_array_equal(np.stack([g["exp_avg_sq"].numpy() for g in got]), want["nu"])
    assert [float(g["step"]) for g in got] == [float(c) for c in want["count"]]


@pytest.mark.parametrize("noniid", [True, False])
@pytest.mark.parametrize("w", [1, 2, 3, 4])
def test_shard_index_matrix_matches_the_jax_package(w, noniid):
    labels = np.random.default_rng(1).integers(0, 10, 200).astype(np.int32)
    stub = _stub(labels, noniid=noniid)
    np.testing.assert_array_equal(elastic._shard_index_matrix(stub, w),
                                  jelastic._shard_index_matrix(stub, w))
    torch_stub = _stub(torch.from_numpy(labels), noniid=noniid)
    np.testing.assert_array_equal(elastic._shard_index_matrix(torch_stub, w),
                                  jelastic._shard_index_matrix(stub, w))


@pytest.mark.parametrize("ledger", [True, False])
@pytest.mark.parametrize("w_old,w_new", [(2, 1), (1, 2), (2, 3), (3, 2)])
def test_carried_state_matches_the_jax_package(w_old, w_new, ledger):
    """The same old rows through both: this rank's stream cursor, score
    table and its cursor, and ledger equal the JAX function's row."""
    rng = np.random.default_rng(w_old * 7 + w_new)
    labels = rng.integers(0, 10, 120).astype(np.int32)
    stub = _stub(labels)
    old_sidx = jelastic._shard_index_matrix(stub, w_old)
    new_sidx = jelastic._shard_index_matrix(stub, w_new)
    l_old, l_new = old_sidx.shape[1], new_sidx.shape[1]
    scores = rng.random((w_old, l_old)).astype(np.float32) * 3
    counts = rng.integers(0, 5, (w_old, l_old)).astype(np.int32)
    cursors = rng.integers(0, l_old, w_old)
    table_cursors = rng.integers(0, l_old, w_old)
    perms = np.stack([rng.permutation(l_old) for _ in range(w_old)])
    new_perm = np.stack([rng.permutation(l_new) for _ in range(w_new)])
    ema_val = 1.25
    old = types.SimpleNamespace(stream=JStream(perms, cursors),
                                scoretable=JTable(scores, table_cursors),
                                sel_counts=counts if ledger else None)
    template = types.SimpleNamespace(
        stream=JStream(new_perm, np.zeros(w_new, np.int32)),
        scoretable=JTable(np.ones((w_new, l_new), np.float32), np.zeros(w_new, np.int32)),
        sel_counts=np.zeros((w_new, l_new), np.int32) if ledger else None)
    want = jelastic._carry_streamed_state(stub, old, template, w_old, w_new, ema_val)
    rows = [dict(perm=torch.from_numpy(perms[r]), cursor=int(cursors[r]),
                 table=torch.from_numpy(scores[r]), table_cursor=int(table_cursors[r]),
                 sel_counts=torch.from_numpy(counts[r]) if ledger else None)
            for r in range(w_old)]
    for r in range(w_new):
        state = types.SimpleNamespace(
            stream=ShardStream(torch.from_numpy(new_perm[r]), 0),
            scoretable=ScoreTableState(torch.ones(l_new), 0),
            sel_counts=torch.zeros(l_new, dtype=torch.int32) if ledger else None)
        got = elastic._carry_streamed_state(_stub(labels, rank=r, state=state), rows,
                                            w_old, w_new, ema_val)
        assert got["stream"].cursor == int(np.asarray(want["stream"].cursor)[r])
        assert torch.equal(got["stream"].perm, state.stream.perm)
        np.testing.assert_array_equal(got["scoretable"].scores.numpy(),
                                      np.asarray(want["scoretable"].scores)[r])
        assert got["scoretable"].cursor == int(np.asarray(want["scoretable"].cursor)[r])
        if ledger:
            assert got["sel_counts"].dtype == torch.int32
            np.testing.assert_array_equal(got["sel_counts"].numpy(),
                                          np.asarray(want["sel_counts"])[r])
        else:
            assert "sel_counts" not in got and "sel_counts" not in want


def test_elastic_seed_is_deterministic_and_moves_with_the_step():
    assert elastic.elastic_seed(0, 0, 3) == elastic.elastic_seed(0, 0, 3)
    seeds = {elastic.elastic_seed(0, r, s) for r in range(3) for s in (0, 3, 4)}
    assert len(seeds) == 9 and all(0 <= s < 2 ** 63 for s in seeds)


# ------------------------------------------------------------- W=2 → W=1
def test_shrink_pool_carries_model_optimizer_and_ema(two_rank_files):
    d = two_rank_files["pool"]
    raw = _raw(d)
    tr = _trainer()
    assert tr.restore_elastic(d) == SAVED_AT
    got = state_tensors(tr.state)
    for k, v in raw["model"].items():
        assert torch.equal(got[f"model.{k}"], v), k
    for i, st in raw["optimizer"]["state"].items():
        for k, v in st.items():
            assert torch.equal(got[f"optimizer.{i}.{k}"], v), (i, k)
    values = np.asarray([row["ema_value"].item() for row in raw["ranks"]], np.float32)
    assert got["ema.value"].item() == float(np.mean(values))
    assert got["ema.count"].item() == max(int(row["ema_count"]) for row in raw["ranks"])
    assert (tr.state.step, tr.state.updates, tr.state.mini_step) == (SAVED_AT, SAVED_AT, 0)
    losses = torch.stack([tr.train_step()["train/loss"] for _ in range(2)])
    assert torch.isfinite(losses).all() and tr.state.step == SAVED_AT + 2


def test_shrink_zero_reshards_moments_and_accumulator_mid_window(two_rank_files):
    d = two_rank_files["zero"]
    raw = _raw(d)
    tr = _trainer(**ARMS["zero"])
    n = sum(p.numel() for p in tr.state.model.parameters())
    tr.restore_elastic(d)
    assert (tr.state.step, tr.state.updates, tr.state.mini_step) == (SAVED_AT, 1, 1)
    st = tr.state.optimizer.state_dict()["state"][0]
    rows = raw["ranks"]
    for key in ("exp_avg", "exp_avg_sq"):
        want = torch.cat([row["optimizer"]["state"][0][key] for row in rows])[:n]
        assert torch.equal(st[key], want), key
    assert torch.equal(st["step"], rows[0]["optimizer"]["state"][0]["step"])
    assert torch.equal(tr.state.accum[0], torch.cat([row["accum"][0] for row in rows])[:n])
    tr.train_step()
    assert (tr.state.updates, tr.state.mini_step) == (2, 0)
    assert all(torch.isfinite(p).all() for p in tr.state.model.parameters())


@pytest.mark.parametrize("carry", [True, False])
def test_shrink_host_stream_carries_the_cursor_only_when_asked(two_rank_files, carry):
    d = two_rank_files["stream"]
    raw = _raw(d)
    kw = dict(**ARMS["stream"], stream_checkpoint_cursor=carry)
    bare = _trainer(**kw)
    fresh_cursor = bare.state.stream.cursor
    elastic.elastic_restore(d, bare)
    l_old = raw["ranks"][0]["perm"].numel()
    l_new = bare.state.stream.perm.numel()
    frac = float(np.mean(np.asarray([row["cursor"] for row in raw["ranks"]], np.float64))) / l_old
    want = min(int(frac * l_new), l_new) if carry else fresh_cursor
    assert bare.state.stream.cursor == want and bare.state.pending is None
    bare.close()
    tr = _trainer(**kw)
    tr.restore_elastic(d)
    # The ring is primed anew, from the re-seeded generator, for the new shard.
    assert tr.state.pending is not None and tr.state.pending.slots.shape[0] == 2
    losses = torch.stack([tr.train_step()["train/loss"] for _ in range(3)])
    assert torch.isfinite(losses).all()
    tr.close()


def test_shrink_repartitions_the_score_table_and_ledger(two_rank_files):
    """The W=1 table equals the JAX function's on the saved rows, and a
    plain recomputation from the shard matrices; the ledger keeps its
    total."""
    d = two_rank_files["table"]
    raw = _raw(d)
    rows = raw["ranks"]
    tr = _trainer(**ARMS["table"])
    tr.restore_elastic(d)
    labels = tr.dataset.y_train.numpy()
    stub = _stub(labels, **{k: getattr(tr.config, k) for k in
                            ("noniid", "dirichlet_alpha", "seed", "min_shard_size")})
    old_sidx = jelastic._shard_index_matrix(stub, 2)
    ema_val = float(np.mean(np.asarray([row["ema_value"].item() for row in rows], np.float32)))
    old = types.SimpleNamespace(
        stream=JStream(np.stack([row["perm"].numpy() for row in rows]),
                       np.asarray([row["cursor"] for row in rows])),
        scoretable=JTable(np.stack([row["table"].numpy() for row in rows]),
                          np.asarray([row["table_cursor"] for row in rows])),
        sel_counts=np.stack([row["sel_counts"].numpy() for row in rows]))
    l_new = tr.dataset.shard_len
    template = types.SimpleNamespace(
        stream=JStream(np.zeros((1, l_new), np.int64), np.zeros(1, np.int32)),
        scoretable=JTable(np.ones((1, l_new), np.float32), np.zeros(1, np.int32)),
        sel_counts=np.zeros((1, l_new), np.int32))
    want = jelastic._carry_streamed_state(stub, old, template, 2, 1, ema_val)
    table = tr.state.scoretable
    np.testing.assert_array_equal(table.scores.numpy(), np.asarray(want["scoretable"].scores)[0])
    assert table.cursor == int(np.asarray(want["scoretable"].cursor)[0])
    np.testing.assert_array_equal(tr.state.sel_counts.numpy(), np.asarray(want["sel_counts"])[0])
    plain = np.full(labels.size, ema_val, np.float32)
    plain[old_sidx.reshape(-1)] = old.scoretable.scores.reshape(-1)
    np.testing.assert_array_equal(table.scores.numpy(),
                                  plain[tr.dataset.shard_indices[0].numpy()])
    assert int(tr.state.sel_counts.sum()) == int(old.sel_counts.sum()) == 2 * SAVED_AT * 4
    assert torch.isfinite(tr.train_step()["train/loss"])


def test_auto_resume_takes_the_elastic_path(two_rank_files, tmp_path):
    d = str(tmp_path / "pool")
    shutil.copytree(two_rank_files["pool"], d)   # the fit below saves into it
    raw = _raw(d)
    tr = _trainer(checkpoint_dir=d, auto_resume=True)
    assert tr.state.step == SAVED_AT and tr._auto_resumed
    got = state_tensors(tr.state)
    assert all(torch.equal(got[f"model.{k}"], v) for k, v in raw["model"].items())
    # The first fit runs to the end of the schedule.
    tr.fit()
    assert tr.state.step == tr.total_steps == COMMON["steps_per_epoch"]


def test_the_reseeded_generator_is_deterministic(two_rank_files):
    d = two_rank_files["pool"]
    a, b, fresh = _trainer(), _trainer(), _trainer()
    a.restore_elastic(d)
    b.restore_elastic(d)
    want = torch.Generator().manual_seed(elastic.elastic_seed(0, 0, SAVED_AT)).get_state()
    assert torch.equal(a.state.generator.get_state(), b.state.generator.get_state())
    assert torch.equal(a.state.generator.get_state(), want)
    assert not torch.equal(a.state.generator.get_state(), fresh.state.generator.get_state())
    assert torch.equal(a.train_step()["train/loss"], b.train_step()["train/loss"])


def test_refusals(two_rank_files):
    wide = ResNet([1, 1], BasicBlock, num_classes=10, num_filters=16)
    init_weights(wide, torch.Generator().manual_seed(0))
    other = Trainer(TrainConfig(**COMMON), device="cpu", model=wide)
    with pytest.raises(ValueError, match="model differs"):
        other.restore_elastic(two_rank_files["pool"])
    with pytest.raises(ValueError, match="zero_sharding"):
        _trainer(grad_accum_steps=2).restore_elastic(two_rank_files["zero"])
    with pytest.raises(ValueError, match="grad_accum_steps"):
        _trainer(zero_sharding=True).restore_elastic(two_rank_files["zero"])
    plain = _trainer()
    with pytest.raises(ValueError, match="world_size=2.*restore_elastic"):
        plain.restore(two_rank_files["pool"])
    assert plain.state.step == 0


# ------------------------------------------------------------- W=1 → W=2
def test_grow_from_one_rank_to_two(tmp_path):
    """One rank saves each arm, two gloo ranks restore it (the pool file
    also by auto_resume): exact model, moments re-chunked, the table
    repartitioned onto each rank's shard."""
    arms = ("pool", "zero", "table")
    saved = {}
    for arm in arms:
        d = str(tmp_path / arm)
        tr = _trainer(seed=0, **ARMS[arm])
        for _ in range(SAVED_AT):
            tr.train_step()
        tr.save(d)
        saved[arm] = dict(dir=d, raw=_raw(d), shard=tr.dataset.shard_indices[0].numpy())
    jobs = [({**COMMON, **ARMS[arm], "world_size": 2}, saved[arm]["dir"], False)
            for arm in arms] + [({**COMMON, "world_size": 2}, saved["pool"]["dir"], True)]
    ranks = spawn(elastic_restore_rank, 2, "gloo", jobs)
    for r, out in enumerate(ranks):
        pool, zero, table, auto = out
        for job in (pool, zero, table, auto):
            assert job["rank"] == r and job["step"] == SAVED_AT
            assert np.isfinite(job["losses"]).all()
        for job, arm in ((pool, "pool"), (auto, "pool"), (zero, "zero"), (table, "table")):
            model = saved[arm]["raw"]["model"]
            assert all(torch.equal(job["restored"][f"model.{k}"], v) for k, v in model.items())
        adam = saved["pool"]["raw"]["optimizer"]["state"][0]
        assert torch.equal(pool["restored"]["optimizer.0.exp_avg"], adam["exp_avg"])
        old = saved["zero"]["raw"]["ranks"][0]
        n = old["optimizer"]["state"][0]["exp_avg"].numel()
        c = zero_chunk_size(n, 2)
        for key in ("exp_avg", "exp_avg_sq"):
            full = torch.nn.functional.pad(old["optimizer"]["state"][0][key], (0, 2 * c - n))
            assert torch.equal(zero["restored"][f"optimizer.0.{key}"], full[r * c:(r + 1) * c])
        full = torch.nn.functional.pad(old["accum"][0], (0, 2 * c - n))
        assert torch.equal(zero["restored"]["accum.0"], full[r * c:(r + 1) * c])
        assert int(zero["restored"]["mini_step"]) == 1
        # The table: a plain recomputation over this rank's real shard.
        row = saved["table"]["raw"]["ranks"][0]
        plain = np.full(5000, float(row["ema_value"]), np.float32)
        plain[saved["table"]["shard"]] = row["table"].numpy()
        np.testing.assert_array_equal(table["restored"]["table.scores"].numpy(),
                                      plain[table["shard_row"].numpy()])
    assert not torch.equal(ranks[0][0]["restored"]["generator"],
                           ranks[1][0]["restored"]["generator"])
