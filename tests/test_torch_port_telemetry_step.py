"""The port's step telemetry against the JAX package's ``make_train_step``
with ``telemetry=True``, in float32 on the CPU, at the tiny sizes of
``test_torch_port_step.py``: a [1, 1]-stage ResNet of width 8, batch 4, a
pool of 16 (or a table of 64 slots with a refresh window of 8), 64 images,
the JAX step's own draws (its key split 8 ways, ``mercury_tpu/train/
step.py:855-856``) and its kernels in interpret mode.

The pool step runs once with ``variance_probe_every=1``. The sync
scoretable step with the fused ingest runs ``TABLE_STEPS`` steps; before
each, the port's parameters, table, cursor, EMA and step come from the JAX
state, so every step starts from the same values, while the port's ledger
adds up its own draws.

Tolerances: ESS, clip share and EMA drift rtol 1e-5 (float32 losses of
two frameworks' forwards, as ``train/pool_loss``); ``train/grad_norm`` rtol
1e-4 (the per-element gradients agree to rtol 1e-3, atol 1e-5);
``var_ratio`` rtol 1e-4; the histograms bin for bin, the ages and the
ledger exactly.
"""

from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import chip_smoke  # noqa: E402
from mercury_tpu.config import TrainConfig as JConfig  # noqa: E402
from mercury_tpu.models import resnet as jres  # noqa: E402
from mercury_tpu.obs import sampler_health as jsh  # noqa: E402
from mercury_tpu.parallel.mesh import host_cpu_mesh  # noqa: E402
from mercury_tpu.train import state as jstate  # noqa: E402
from mercury_tpu.train.step import make_train_step as jmake_train_step  # noqa: E402
from mercury_tpu_torch import TrainConfig, Trainer  # noqa: E402
from mercury_tpu_torch.data import cifar  # noqa: E402
from mercury_tpu_torch.data.pipeline import ShardStream, make_sharded_dataset  # noqa: E402
from mercury_tpu_torch.models import resnet as tres  # noqa: E402
from mercury_tpu_torch.models.convert import params_from_flax, scoretable_from_jax  # noqa: E402
from mercury_tpu_torch.obs.diagnostics import table_ages  # noqa: E402
from mercury_tpu_torch.parallel.distributed import spawn  # noqa: E402
from mercury_tpu_torch.sampling.importance import EMAState  # noqa: E402
from mercury_tpu_torch.train.state import create_state  # noqa: E402
from mercury_tpu_torch.train.step import Augment, Draws, make_train_step  # noqa: E402
from test_torch_port_ranks import monitor_rank  # noqa: E402

B, PRESAMPLE, R, N_TRAIN, STEPS, TABLE_STEPS = 4, 4, 8, 64, 10, 3
POOL = B * PRESAMPLE
MEAN, STD = cifar.CIFAR10_MEAN, cifar.CIFAR10_STD
COMMON = dict(dataset="synthetic", world_size=1, batch_size=B, presample_batches=PRESAMPLE,
              compute_dtype="float32", num_epochs=1, steps_per_epoch=STEPS, seed=0)
TABLE = dict(sampler="scoretable", refresh_size=R, fused_input=True)
SCALARS = ("sampler/ess", "sampler/clip_frac", "sampler/ema_drift")
# The keys of the step before telemetry (telemetry=False), and the sparse
# rate and the experts' aux, which the JAX step returns with or without
# telemetry.
UNTRACED_KEYS = {"train/loss", "train/acc", "train/pool_loss", "train/sparse_rate",
                 "train/moe_aux", "sampler/selected", "sampler/probs"}


def _np_tree(tree):
    return jax.tree_util.tree_map(lambda a: np.array(a), tree)


def _augment_draws(key, n):
    k_crop, k_flip, _ = jax.random.split(key, 3)
    return (torch.tensor(np.array(jax.random.randint(k_crop, (n, 2), 0, 9), np.int32)),
            torch.tensor(np.array(jax.random.bernoulli(k_flip, shape=(n,)))))


def _draws(rng, table):
    """The JAX step's draws from its key ``rng``."""
    _, k_aug, k_sel, k_aug2 = jax.random.split(rng, 8)[:4]
    aug = Augment(*_augment_draws(k_aug, R if table else POOL))
    aug2 = Augment(*_augment_draws(k_aug2, B)) if table else None
    uniforms = torch.tensor(np.array(jax.random.uniform(k_sel, (1, B), jnp.float32)))
    return Draws(perm=None, aug=aug, uniforms=uniforms, aug2=aug2)


def _host(metrics):
    return {k: np.asarray(v) for k, v in metrics.items()}


def _run(jcfg_kw, tcfg_kw, steps):
    """``steps`` steps of the JAX step and of the port's from the same
    values; each port step starts from the JAX state of that step."""
    table = tcfg_kw.get("sampler") == "scoretable"
    (x, y), (xt, yt) = cifar.synthetic_cifar(10, N_TRAIN, 8, seed=0)
    jm = jres.ResNet(stage_sizes=[1, 1], block_cls=jres.BasicBlock, num_classes=10,
                     num_filters=8, compute_dtype=jnp.float32)
    jcfg = JConfig(model="resnet18", use_pallas=True, telemetry=True, **COMMON, **jcfg_kw)
    tx = jstate.make_optimizer("adam", jcfg.lr, STEPS)
    js = jstate.create_state(jax.random.key(0), jm, tx, jnp.zeros((1, 32, 32, 3), jnp.float32),
                             1, N_TRAIN, with_scoretable=table, with_sel_counts=table)
    step_fn = jmake_train_step(jm, tx, jcfg, host_cpu_mesh(1), MEAN, STD)
    shard = jnp.asarray(np.arange(N_TRAIN, dtype=np.int32)[None, :])

    tcfg = TrainConfig(**COMMON, **tcfg_kw)
    dataset = make_sharded_dataset((x, y), (xt, yt), [np.arange(N_TRAIN)], MEAN, STD, 10,
                                   device=torch.device("cpu"))
    ts = create_state(tres.ResNet([1, 1], tres.BasicBlock, num_classes=10, num_filters=8),
                      "cpu", 0, N_TRAIN, "adam", tcfg.lr, STEPS, with_scoretable=table,
                      with_sel_counts=tcfg.use_ledger)
    tstep = make_train_step(tcfg, dataset)
    out = []
    for _ in range(steps):
        # Copied before the JAX step, which may donate its state.
        ts.model.load_state_dict(params_from_flax(_np_tree(js.params),
                                                  _np_tree(js.batch_stats)))
        ts.ema = EMAState(torch.tensor(np.array(js.ema.value[0])),
                          torch.tensor(np.array(js.ema.count[0])))
        ts.step = int(js.step)
        if table:
            ts.scoretable = scoretable_from_jax(np.array(js.scoretable.scores[0]),
                                                np.array(js.scoretable.cursor[0]))
        else:
            ts.stream = ShardStream(torch.tensor(np.array(js.stream.perm[0]),
                                                 dtype=torch.long),
                                    int(js.stream.cursor[0]))
        cursor = None if not table else ts.scoretable.cursor
        draws = _draws(js.rng[0], table)
        tm = _host(tstep(ts, draws))
        js, jmetrics = step_fn(js, jnp.asarray(x), jnp.asarray(y), shard)
        out.append(dict(port=tm, jax=_host(jmetrics), cursor=cursor, draws=draws))
    return dict(steps=out, ts=ts, js=js, jcfg=jcfg)


@pytest.fixture(scope="module")
def pool():
    return _run(dict(variance_probe_every=1), dict(variance_probe_every=1), 1)


@pytest.fixture(scope="module")
def table():
    return _run(TABLE, TABLE, TABLE_STEPS)


def _check_draws(step):
    """The port drew the JAX step's batch: each uniform lies outside the
    boundary band of the CDF's summation order (see test_torch_port_ops)."""
    probs = step["port"]["sampler/probs"].astype(np.float64)
    u = step["draws"].uniforms.numpy()[0]
    assert np.min(np.abs(np.cumsum(probs)[None, :] - u[:, None])) > 1e-6


def _check_scalars(step):
    tm, jm = step["port"], step["jax"]
    for key in SCALARS:
        np.testing.assert_allclose(tm[key], jm[key], rtol=1e-5, err_msg=key)
    np.testing.assert_allclose(tm["train/grad_norm"], jm["train/grad_norm"], rtol=1e-4)
    assert float(tm["train/grad_norm"]) > 0
    for key in jsh.hist_keys("w_hist"):
        assert tm[key].dtype == np.int32 and tm[key] == jm[key], key
    assert sum(int(tm[k]) for k in jsh.hist_keys("w_hist")) == B


def test_pool_step_keys_match(pool):
    step = pool["steps"][0]
    tkeys, jkeys = set(step["port"]), set(step["jax"])
    assert tkeys - chip_smoke.PORT_ONLY_KEYS == jkeys - chip_smoke.JAX_ONLY_KEYS
    assert jkeys - {"sampler_dist/var_ratio"} == chip_smoke.JAX_STEP_KEYS["pool"]


def test_pool_step_telemetry_matches(pool):
    step = pool["steps"][0]
    _check_draws(step)
    _check_scalars(step)
    assert 0.0 < float(step["port"]["sampler/ess"]) <= 1.0


def test_pool_step_probe_matches(pool):
    tm, jm = pool["steps"][0]["port"], pool["steps"][0]["jax"]
    assert float(jm["sampler_dist/var_ratio"]) > 0
    np.testing.assert_allclose(tm["sampler_dist/var_ratio"], jm["sampler_dist/var_ratio"],
                               rtol=1e-4)


def test_table_step_keys_match(table):
    for step in table["steps"]:
        tkeys, jkeys = set(step["port"]), set(step["jax"])
        assert tkeys - chip_smoke.PORT_ONLY_KEYS == jkeys - chip_smoke.JAX_ONLY_KEYS
        assert jkeys == chip_smoke.JAX_STEP_KEYS["scoretable"]


def test_table_steps_telemetry_match(table):
    for step in table["steps"]:
        _check_draws(step)
        _check_scalars(step)
        tm, jm = step["port"], step["jax"]
        for key in jsh.hist_keys("score_hist"):
            assert tm[key] == jm[key], key
        assert sum(int(tm[k]) for k in jsh.hist_keys("score_hist")) == N_TRAIN
        ages = table_ages(step["cursor"], N_TRAIN, R).numpy()
        for name, want in (("min", ages.min()), ("max", ages.max())):
            assert tm[f"sampler/table_age_{name}"] == jm[f"sampler/table_age_{name}"] == want
        assert tm["sampler/table_age_mean"] == jm["sampler/table_age_mean"]


def test_table_ledger_equals_jax(table):
    """One count an occurrence of every trained slot, as the JAX ledger
    counts them, and as the drawn slots add up."""
    ledger = table["ts"].sel_counts
    assert ledger.dtype == torch.int32
    np.testing.assert_array_equal(ledger.numpy(), np.asarray(table["js"].sel_counts[0]))
    drawn = np.concatenate([s["port"]["sampler/selected"] for s in table["steps"]])
    np.testing.assert_array_equal(ledger.numpy(), np.bincount(drawn, minlength=N_TRAIN))
    assert int(ledger.sum()) == TABLE_STEPS * B


def _tiny(**kw):
    base = dict(COMMON, eval_every=0, log_every=0, steps_per_epoch=8)
    base.update(kw)
    model = tres.ResNet([1, 1], tres.BasicBlock, num_classes=10, num_filters=8)
    tres.init_weights(model, torch.Generator().manual_seed(0))
    return Trainer(TrainConfig(**base), device="cpu", model=model)


def test_uniform_arm():
    m = _tiny(use_importance_sampling=False).train_step()
    assert float(m["sampler/ess"]) == 1.0
    assert float(m["sampler/clip_frac"]) == 0.0 and float(m["sampler/ema_drift"]) == 0.0
    assert not any(k.startswith("sampler_dist/") for k in m)
    assert float(m["train/grad_norm"]) > 0


@pytest.mark.parametrize("kw", [{}, TABLE], ids=["pool", "scoretable"])
def test_telemetry_off_is_the_untraced_step(kw):
    tr = _tiny(telemetry=False, variance_probe_every=2, **kw)
    assert tr.state.sel_counts is None and tr.sampler_monitor is None
    for _ in range(2):
        assert set(tr.train_step()) == UNTRACED_KEYS
    assert tr.state.sel_counts is None


def _aten_ops(trainer):
    """The ATen ops of one step (the second), in order."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Record(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.ops = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.ops.append(str(func))
            return func(*args, **(kwargs or {}))

    trainer.train_step()
    with Record() as rec:
        trainer.train_step()
    return rec.ops


@pytest.mark.parametrize("kw,n_off,n_added", [
    ({}, 455, 34), (TABLE, 512, 50), (dict(use_importance_sampling=False), 389, 15),
], ids=["pool", "scoretable", "uniform"])
def test_telemetry_only_adds_ops(kw, n_off, n_added):
    """With telemetry off the step runs the ops of the step before
    telemetry (``n_off``, the count that step's tree gives); telemetry
    only inserts its own ``n_added`` among them."""
    off = _aten_ops(_tiny(telemetry=False, **kw))
    on = _aten_ops(_tiny(**kw))
    assert (len(off), len(on) - len(off)) == (n_off, n_added)
    rest = iter(on)
    assert all(op in rest for op in off)  # off is a subsequence of on


def test_probe_sentinel_off_cadence():
    tr = _tiny(variance_probe_every=2)
    ratios = [float(tr.train_step()["sampler_dist/var_ratio"]) for _ in range(4)]
    assert ratios[0] == ratios[2] == -1.0
    assert ratios[1] > 0 and ratios[3] > 0


def test_trainer_log_record_carries_the_monitor():
    """At a log tick ``fit`` writes to its metric stream, and returns, the
    monitor's seven keys, equal to the JAX monitor's on the same ``[1, L]``
    arrays; nothing on other steps."""
    tr = _tiny(log_every=3, **TABLE)
    out = tr.fit(steps=3)
    record = tr.logger.latest_record()
    assert record["step"] == 3
    assert chip_smoke.MONITOR_KEYS <= set(out) and chip_smoke.MONITOR_KEYS <= set(record)
    st = tr.state
    jstate_np = SimpleNamespace(
        sel_counts=st.sel_counts.numpy()[None],
        scoretable=SimpleNamespace(scores=st.scoretable.scores.numpy()[None]),
        ema=SimpleNamespace(value=st.ema.value.numpy()[None]))
    ds = tr.dataset
    want = jsh.SamplerHealthMonitor(ds.shard_indices.numpy(), ds.y_train.numpy(),
                                    ds.num_classes, tr.config.is_alpha).stats(jstate_np)
    assert want.keys() == chip_smoke.MONITOR_KEYS
    for k, v in want.items():
        assert out[k] == pytest.approx(v, rel=1e-12), k
        assert record[k] == pytest.approx(v, rel=1e-12), k
    assert 0.0 <= out["sampler_dist/gini"] <= 1.0
    assert not chip_smoke.MONITOR_KEYS & set(tr.fit(steps=1))  # step 4: no tick
    assert tr.logger.latest_record()["step"] == 3
    tr.close()


def test_ledger_counts_each_duplicate():
    """A table whose mass sits on one slot outside the refresh window
    draws it B times in a step: the ledger counts it B times."""
    tr = _tiny(**TABLE)
    scores = torch.full((tr.dataset.shard_len,), 1e-3)
    scores[40] = 1e6
    tr.state.scoretable = tr.state.scoretable._replace(scores=scores)
    m = tr.train_step()
    assert m["sampler/selected"].tolist() == [40] * B
    assert int(tr.state.sel_counts[40]) == B and int(tr.state.sel_counts.sum()) == B


def test_monitor_at_two_ranks():
    """At W=2 rank 0 logs the monitor's keys of both ranks' ``[2, L]``
    ledger, table and EMA (gathered at the tick), equal to the JAX
    monitor's on those arrays; rank 1 logs none."""
    kw = dict(COMMON, **TABLE, world_size=2, eval_every=0, log_every=3, steps_per_epoch=8)
    r0, r1 = spawn(monitor_rank, 2, "gloo", kw, 3)
    assert chip_smoke.MONITOR_KEYS <= set(r0["out"])
    assert not chip_smoke.MONITOR_KEYS & set(r1["out"])
    assert not torch.equal(r0["sel_counts"], r1["sel_counts"])
    state = SimpleNamespace(
        sel_counts=np.stack([r["sel_counts"].numpy() for r in (r0, r1)]),
        scoretable=SimpleNamespace(scores=np.stack([r["scores"].numpy() for r in (r0, r1)])),
        ema=SimpleNamespace(value=np.stack([r["ema"].numpy() for r in (r0, r1)])))
    assert int(state.sel_counts.sum()) == 2 * 3 * B
    want = jsh.SamplerHealthMonitor(r0["shard_indices"].numpy(), r0["labels"].numpy(), 10,
                                    0.5).stats(state)
    for k, v in want.items():
        assert r0["out"][k] == pytest.approx(v, rel=1e-12), k


def test_ledger_survives_a_checkpoint(tmp_path):
    """The ledger round trip; a file without a ledger (telemetry off)
    restores into zeros; a file with one restores into a run without
    telemetry without it."""
    live = _tiny(**TABLE)
    for _ in range(3):
        live.train_step()
    assert int(live.state.sel_counts.sum()) == 3 * B
    live.save(str(tmp_path / "on"))
    fresh = _tiny(**TABLE)
    fresh.restore(str(tmp_path / "on"))
    assert torch.equal(fresh.state.sel_counts, live.state.sel_counts)
    off = _tiny(telemetry=False, **TABLE)
    off.restore(str(tmp_path / "on"))
    assert off.state.sel_counts is None
    off.train_step()
    off.save(str(tmp_path / "off"))
    fresh.restore(str(tmp_path / "off"))
    assert fresh.state.step == 4
    ledger = fresh.state.sel_counts
    assert ledger.shape == (fresh.dataset.shard_len,) and not ledger.any()
