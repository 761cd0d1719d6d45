"""Async refresh, the supervised ladder and ``restore_elastic`` under a
second mesh axis, held to the port's own unsharded runs on the CPU (the
JAX package runs them through GSPMD, with no sharded layout to compare).

- **Async refresh** (``refresh_mode="async"``, the host fleet, one
  worker): one scorer a model group, on its first rank, scoring an
  unsharded copy against the whole parameters the group gathers at each
  snapshot; the chunks it applies are broadcast to the group. Chunks are
  given through ``score_once`` and applied at given ages, as the async
  tests hold the fleet (``test_torch_port_async_scoring``): at W=1 × F=2
  (a tiny ResNet of width 16) and W=1 × T=2 (the Transformer at d_model
  32). The second rank's table equals the first's bit for bit after every
  step; F=2 equals W=1 bit for bit (tables, losses, selections), as the
  FSDP step does (``test_torch_port_fsdp``).
- **The ladder** at W=1 × T=2 with live workers and ``scorer_die`` at
  budget 0: the level is agreed over every rank, so both ranks descend
  and climb back at the same ticks, and their tables stay bit-equal
  through the async, sync and probe refreshes.
- **restore_elastic** of a W=2 file into W=1 × F=2 and W=1 × T=2: the
  gathered model and Adam state equal the file's exactly, the EMA is the
  mean of the two old rows, and the next steps equal a W=1 elastic
  restore of the same file (bit for bit under FSDP; under TP losses rtol
  1e-6, parameters atol 1e-3 and selections bit-equal, as
  ``test_torch_port_mesh`` holds T=2 to T=1).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from mercury_tpu_torch.parallel.distributed import spawn  # noqa: E402
from test_torch_port_ranks import (  # noqa: E402
    mesh_async_rank,
    mesh_rank,
    no_fleet_workers,
    one_thread,
)

N = 2
IMAGE = dict(model="resnet18", dataset="synthetic", world_size=1, batch_size=4,
             presample_batches=2, steps_per_epoch=8, num_epochs=1, eval_every=0, log_every=0,
             compute_dtype="float32", seed=0)
SEQ = dict(IMAGE, model="transformer", dataset="synthetic_seq", augmentation="none")
SMALL = dict(name="transformer", sample_shape=(32, 16), d_model=32, num_heads=2,
             num_layers=2, max_len=32)
ASYNC = dict(sampler="scoretable", refresh_size=8, refresh_mode="async", scorer_workers=1,
             snapshot_every=2, scorer_throttle_s=0.0)
# Each step's chunk age at its tick (None: no chunk before that step).
AGES = [None, 0, 2, 1, None, 3, 0]
ARMS = {"fsdp": (IMAGE, {"tiny_resnet": 16}, "fsdp_parallel"),
        "tp": (SEQ, SMALL, "tensor_parallel")}
# The ladder at budget 0: without probes it stays at sync (the training
# thread scores every second step); with them the probe at the descent's
# tick revives the workers and climbs back.
LADDER = dict(SEQ, **ASYNC, tensor_parallel=N, steps_per_epoch=24, supervise=True,
              supervisor_backoff_s=0.0, supervisor_restart_budget=0,
              supervisor_sync_every=2, fault_spec="scorer_die@step=3")
PROBES = (0, 4)
LADDER_STEPS = 16


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """W=2 saves (two gloo ranks), then one spawn of two ranks for the
    async arms, the ladder and the elastic restores; the W=1 references
    in this process."""
    root = tmp_path_factory.mktemp("mesh_async")
    dirs = {name: str(root / name) for name in ARMS}
    saves = [dict(config=dict(cfg, world_size=2), model=model, steps=2, save=dirs[name],
                  save_at=2) for name, (cfg, model, _) in ARMS.items()]
    spawn(mesh_rank, 2, "gloo", saves)
    restores = {name: dict(config=cfg, model=model, steps=3, restore_elastic=dirs[name])
                for name, (cfg, model, _) in ARMS.items()}
    jobs = [("async", dict(config=dict(cfg, **ASYNC, **{axis: N}), model=model, ages=AGES))
            for cfg, model, axis in ARMS.values()]
    jobs += [("ladder", dict(config=dict(LADDER, supervisor_probe_every=every), model=SMALL,
                             steps=LADDER_STEPS)) for every in PROBES]
    jobs += [("mesh", dict(job, config=dict(job["config"], **{ARMS[name][2]: N})))
             for name, job in restores.items()]
    ranks = spawn(mesh_async_rank, N, "gloo", jobs)
    with one_thread():
        with no_fleet_workers():
            from test_torch_port_ranks import async_steps

            one = async_steps(dict(config=dict(IMAGE, **ASYNC), model=ARMS["fsdp"][1],
                                   ages=AGES))
        elastic_one = {name: mesh_rank([job])[0] for name, job in restores.items()}
    files = {name: torch.load(f"{d}/ckpt_2.pt", weights_only=False) for name, d in dirs.items()}
    return dict(ranks=ranks, one=one, elastic_one=elastic_one, files=files)


@pytest.mark.parametrize("arm", list(ARMS))
def test_model_group_applies_the_same_chunks(runs, arm):
    """One scorer, on the group's first rank; the second rank's table,
    loss and selection equal the first's at every step, and both applied
    the given chunks at the given ages."""
    i = list(ARMS).index(arm)
    lead, other = (r[i] for r in runs["ranks"])
    assert lead["has_scorer"] and not other["has_scorer"]
    assert not [t for t in other["threads"] if t.startswith("mercury-scorer")]
    want = [(t + 1, t + 1 - a) for t, a in enumerate(AGES) if a is not None]
    assert lead["applied"] == other["applied"] == want
    for a, b in zip(lead["tables"], other["tables"]):
        assert torch.equal(a, b)
    assert lead["losses"] == other["losses"]
    for a, b in zip(lead["selected"], other["selected"]):
        assert torch.equal(a, b)


def test_fsdp_async_is_bit_equal_to_one_rank(runs):
    one = runs["one"]
    for rank in runs["ranks"]:
        port = rank[0]
        assert port["applied"] == one["applied"]
        assert port["losses"] == one["losses"]
        for a, b in zip(port["tables"], one["tables"]):
            assert torch.equal(a, b)
        for a, b in zip(port["selected"], one["selected"]):
            assert torch.equal(a, b)


@pytest.mark.parametrize("probe_every", PROBES)
def test_ladder_is_agreed_across_the_model_group(runs, probe_every):
    """The death on the scorer's rank descends both ranks at one tick
    (agreed over every rank: the second rank has no scorer); without
    probes both stay at sync, whose chunks the first rank scores and
    broadcasts, and with them both climb back at that tick. The tables
    stay equal at every refresh."""
    lead, other = (r[len(ARMS) + PROBES.index(probe_every)] for r in runs["ranks"])
    assert lead["has_scorer"] and not other["has_scorer"]
    assert lead["levels"] == other["levels"]
    assert len(lead["levels"]) == LADDER_STEPS
    moves = [[(t["step"], t["from"], t["to"]) for t in r["transitions"]]
             for r in (lead, other)]
    assert moves[0] == moves[1]
    assert "exhausted" in lead["transitions"][0]["reason"]
    assert "agreed across the ranks" in other["transitions"][0]["reason"]
    if probe_every:
        assert [m[2] for m in moves[0]] == ["sync", "async"]
    else:
        assert [m[2] for m in moves[0]] == ["sync"]
        assert lead["levels"][-1][1] == 1
        # The sync refreshes: a chunk every second step after the descent.
        sync = [a for a in lead["applied"] if a[0] > moves[0][0][0]]
        assert sync and all(step == chunk for step, chunk in sync)
    assert lead["applied"] == other["applied"]
    for a, b in zip(lead["tables"], other["tables"]):
        assert torch.equal(a, b)


@pytest.mark.parametrize("arm", list(ARMS))
def test_restore_elastic_into_a_second_axis(runs, arm):
    """The gathered model and Adam state are the file's exactly; the EMA
    is the old rows' mean; the steps after it are a W=1 restore's."""
    i = len(ARMS) + len(PROBES) + list(ARMS).index(arm)
    raw = runs["files"][arm]
    one = runs["elastic_one"][arm]
    rows = raw["ranks"]
    assert len(rows) == 2
    ema = float(np.mean(np.asarray([r["ema_value"].item() for r in rows], np.float32)))
    for rank in runs["ranks"]:
        port = rank[i]
        restored = port["restored"]
        assert port["step0"] == 2
        assert restored["full"].keys() == raw["model"].keys()
        for k, v in raw["model"].items():
            assert torch.equal(restored["full"][k], v), k
        for j, st in raw["optimizer"]["state"].items():
            for key, v in st.items():
                assert torch.equal(restored["adam"][j][key], v), (j, key)
        assert restored["ema"] == (ema, max(int(r["ema_count"].item()) for r in rows))
        for a, b in zip(port["selected"], one["selected"]):
            assert torch.equal(a, b)
        if arm == "fsdp":
            assert port["losses"] == one["losses"]
            for k, v in one["full"].items():
                assert torch.equal(port["full"][k], v), k
        else:
            np.testing.assert_allclose(port["losses"], one["losses"], rtol=1e-6)
            for k, v in one["full"].items():
                np.testing.assert_allclose(port["full"][k].numpy(), v.numpy(), rtol=0,
                                           atol=1e-3, err_msg=k)
