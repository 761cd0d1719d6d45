"""``scan_steps``: K steps a call, against K single calls and against the
JAX package's scanned chunk, on the CPU.

The port runs the step body K times in a row and stacks each metric into
``[K]`` (the JAX package runs the chunk as one ``lax.scan``). From the
same seed a chunked ``fit`` leaves the state bit-equal to single steps
(the same draws from the same generator, the same ``set_lr`` each step),
and a chunk's log record holds the chunk's means, as
``tests/test_train_step.py:300-330`` pins them for the JAX Trainer. One
K=2 chunk runs against JAX's ``make_train_step(..., scan_steps=2)`` from
the same weights, stream, EMA and draws (each step's from the JAX key,
split 8 ways as ``mercury_tpu/train/step.py:855-856`` splits it; the next
step's key is the split's last). Tiny sizes: a [1, 1]-stage ResNet of
width 8, batch 4, a pool of 16, 64 images.

Tolerances: the port against itself, none (bit-equal); the chunk's means
against single steps' to rtol 1e-6 (both reduce the same float32 values);
against JAX, those of ``test_torch_port_step.py``: the first step's loss to
rtol 1e-5, the second's to 1e-4, parameters to 2·lr a step.
"""

import dataclasses
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from mercury_tpu.config import TrainConfig as JConfig  # noqa: E402
from mercury_tpu.models import resnet as jres  # noqa: E402
from mercury_tpu.parallel.mesh import host_cpu_mesh  # noqa: E402
from mercury_tpu.train import state as jstate  # noqa: E402
from mercury_tpu.train.step import make_train_step as jmake_train_step  # noqa: E402
from mercury_tpu_torch import TrainConfig, Trainer  # noqa: E402
from mercury_tpu_torch.data import cifar  # noqa: E402
from mercury_tpu_torch.data.pipeline import ShardStream, make_sharded_dataset  # noqa: E402
from mercury_tpu_torch.models import resnet as tres  # noqa: E402
from mercury_tpu_torch.models.convert import params_from_flax  # noqa: E402
from mercury_tpu_torch.sampling.importance import EMAState  # noqa: E402
from mercury_tpu_torch.train import checkpoint  # noqa: E402
from mercury_tpu_torch.train.state import create_state  # noqa: E402
from mercury_tpu_torch.train.step import Augment, Draws, make_train_step  # noqa: E402

B, PRESAMPLE, N_TRAIN = 4, 4, 64
POOL = B * PRESAMPLE
MEAN, STD = cifar.CIFAR10_MEAN, cifar.CIFAR10_STD
# The JAX Trainer's warning for a cadence a chunk can step over
# (mercury_tpu/train/trainer.py:489-494).
WARNING = ("warning: {name}={every} is not a multiple of scan_steps={k}; cadence "
           "actions fire at most once per chunk (at chunk boundaries)")


def _tiny_model():
    model = tres.ResNet([1, 1], tres.BasicBlock, num_classes=10, num_filters=8)
    tres.init_weights(model, torch.Generator().manual_seed(0))
    return model


def _trainer(**kw):
    """A CPU Trainer of the tiny ResNet on 64 synthetic images (16 to
    test)."""
    base = dict(dataset="synthetic", world_size=1, batch_size=B, presample_batches=PRESAMPLE,
                compute_dtype="float32", num_epochs=1, steps_per_epoch=7, eval_every=0,
                log_every=0, seed=0)
    base.update(kw)
    (x, y), (xt, yt) = cifar.synthetic_cifar(10, N_TRAIN, 16, seed=0)
    dataset = make_sharded_dataset((x, y), (xt, yt), [np.arange(N_TRAIN)], MEAN, STD, 10,
                                   device=torch.device("cpu"),
                                   placement=base.get("data_placement", "replicated"))
    return Trainer(TrainConfig(**base), dataset=dataset, device="cpu", model=_tiny_model())


def _state_of(tr):
    st = tr.state
    adam = {i: {k: v.clone() for k, v in s.items() if torch.is_tensor(v)}
            for i, s in st.optimizer.state_dict()["state"].items()}
    table = None if st.scoretable is None else (st.scoretable.scores.clone(),
                                                st.scoretable.cursor)
    return dict(model={k: v.clone() for k, v in st.model.state_dict().items()}, adam=adam,
                step=st.step, updates=st.updates, ema=(float(st.ema.value), int(st.ema.count)),
                stream=(st.stream.perm.clone(), st.stream.cursor), table=table,
                generator=st.generator.get_state(),
                lr=st.optimizer.param_groups[0]["lr"])


def _assert_same_state(a, b):
    for k, v in a["model"].items():
        assert torch.equal(v, b["model"][k]), k
    for i, s in a["adam"].items():
        for k, v in s.items():
            assert torch.equal(v, b["adam"][i][k]), (i, k)
    assert (a["step"], a["updates"], a["ema"], a["lr"]) == (b["step"], b["updates"], b["ema"],
                                                           b["lr"])
    assert torch.equal(a["stream"][0], b["stream"][0]) and a["stream"][1] == b["stream"][1]
    assert torch.equal(a["generator"], b["generator"])
    if a["table"] is not None:
        assert torch.equal(a["table"][0], b["table"][0]) and a["table"][1] == b["table"][1]


@pytest.mark.parametrize("sampler", ["pool", "scoretable"])
def test_chunks_leave_the_state_of_single_steps(sampler):
    """``scan_steps=3`` over 7 steps (chunks of 3, 3, then a single step)
    against 7 single steps, from the same seed."""
    single = _trainer(sampler=sampler)
    single.fit()
    chunked = _trainer(sampler=sampler, scan_steps=3)
    calls = []
    chunk = chunked.train_chunk
    step = chunked.train_step
    chunked.train_chunk = lambda *a, **kw: calls.append(3) or chunk(*a, **kw)
    chunked.train_step = lambda *a, **kw: calls.append(1) or step(*a, **kw)
    chunked.fit()
    assert calls == [3, 3, 1] and chunked.state.step == 7
    _assert_same_state(_state_of(chunked), _state_of(single))


def test_chunk_metrics_are_k_series():
    """Every metric of a chunk is ``[K, ...]``: the scalars ``[K]``, the
    drawn positions ``[K, B]`` and the pool's distribution ``[K, P]``; row
    i is the i-th single step's."""
    single, chunked = _trainer(), _trainer(scan_steps=3)
    steps = [single.train_step() for _ in range(3)]
    metrics = chunked.train_chunk()
    assert set(metrics) == set(steps[0])
    assert metrics["train/loss"].shape == (3,) and metrics["train/moe_aux"].shape == (3,)
    assert metrics["sampler/selected"].shape == (3, B)
    assert metrics["sampler/probs"].shape == (3, POOL)
    for key, series in metrics.items():
        for i in range(3):
            assert torch.equal(series[i], steps[i][key]), (key, i)


def test_logged_records_are_chunk_means(tmp_path):
    """``log_every=3``: the records at steps 3 and 6 carry the means of the
    chunks' ``[3]`` series, as the JAX Trainer logs them; not the last
    step's value."""
    single = _trainer()
    per_step = [single.train_step() for _ in range(6)]
    log_dir = str(tmp_path / "run")
    with _trainer(scan_steps=3, log_every=3, log_dir=log_dir) as tr:
        tr.fit(steps=6)
    records = [json.loads(line) for line in open(os.path.join(log_dir, "metrics.jsonl"))]
    assert [r["step"] for r in records] == [3, 6]
    for r, lo in zip(records, (0, 3)):
        for key in ("train/loss", "train/acc", "train/pool_loss", "sampler/ess",
                    "train/moe_aux"):
            series = np.array([float(m[key]) for m in per_step[lo:lo + 3]], np.float32)
            np.testing.assert_allclose(r[key], float(np.mean(series)), rtol=1e-6, err_msg=key)
        losses = [float(m["train/loss"]) for m in per_step[lo:lo + 3]]
        assert abs(r["train/loss"] - losses[-1]) > 1e-8
        assert "sampler/selected" not in r and "sampler/probs" not in r
        assert r["perf/steps_per_s"] > 0


def test_cadences_fire_once_a_chunk(tmp_path, capsys):
    """``crossed(every, at, advanced)``: with K=3 and ``checkpoint_every=2``
    the saves land at the chunk boundaries 3 and 6, then at the end (7);
    the warning is the JAX Trainer's text. The supervisor ticks and the
    anomaly engine's step times advance once a call, by the call's steps."""
    tr = _trainer(scan_steps=3, checkpoint_dir=str(tmp_path), checkpoint_every=2,
                  supervise=True)
    out = capsys.readouterr().out
    assert WARNING.format(name="checkpoint_every", every=2, k=3) in out
    assert "log_every" not in out and "eval_every" not in out
    ticks, times = [], []
    tick = tr.supervisor.tick
    observe = tr.anomaly.observe_step_time
    tr.supervisor.tick = lambda step: ticks.append(step) or tick(step)
    tr.anomaly.observe_step_time = lambda step, dt, steps=1: (
        times.append((step, steps)) or observe(step, dt, steps=steps))
    result = tr.fit()
    assert checkpoint.all_steps(str(tmp_path)) == [3, 6, 7]
    assert ticks == [3, 6, 7] and times == [(3, 3), (6, 3), (7, 1)]
    assert np.isfinite(result["train/loss"])
    tr.close()


def test_refusals_are_jax_s():
    """The variance probe and host_stream refuse ``scan_steps > 1`` with
    the JAX step's messages; ``scan_steps`` defaults to 1."""
    jm = jres.ResNet(stage_sizes=[1, 1], block_cls=jres.BasicBlock, num_classes=10,
                     num_filters=8)
    tx = jstate.make_optimizer("adam", 1e-3, 10)
    for kw in (dict(variance_probe_every=2), dict(data_placement="host_stream")):
        jcfg = JConfig(dataset="synthetic", world_size=1, **kw)
        with pytest.raises(ValueError) as want:
            jmake_train_step(jm, tx, jcfg, host_cpu_mesh(1), MEAN, STD, scan_steps=2)
        with pytest.raises(ValueError) as got:
            _trainer(scan_steps=2, **kw)
        assert str(got.value) == str(want.value)
    assert TrainConfig().scan_steps == JConfig().scan_steps == 1
    assert "scan_steps" in {f.name for f in dataclasses.fields(TrainConfig)}


def _draws(rng):
    """A pool step's draws from the JAX worker's key: the crops and flips
    from ``k_aug``, the draw's uniforms from ``k_sel``."""
    _, k_aug, k_sel = jax.random.split(rng, 8)[:3]
    k_crop, k_flip, _ = jax.random.split(k_aug, 3)
    return Draws(perm=None,
                 aug=Augment(crop=torch.tensor(np.array(jax.random.randint(k_crop, (POOL, 2),
                                                                           0, 9))),
                             flip=torch.tensor(np.array(jax.random.bernoulli(k_flip,
                                                                             shape=(POOL,))))),
                 uniforms=torch.tensor(np.array(jax.random.uniform(k_sel, (1, B),
                                                                   jnp.float32))))


def test_one_chunk_matches_jax_s_scanned_chunk():
    (x, y), (xt, yt) = cifar.synthetic_cifar(10, N_TRAIN, 8, seed=0)
    jm = jres.ResNet(stage_sizes=[1, 1], block_cls=jres.BasicBlock, num_classes=10,
                     num_filters=8, compute_dtype=jnp.float32)
    common = dict(dataset="synthetic", world_size=1, batch_size=B, presample_batches=PRESAMPLE,
                  compute_dtype="float32", num_epochs=1, steps_per_epoch=10, seed=0,
                  scan_steps=2)
    jcfg = JConfig(model="resnet18", use_pallas=True, telemetry=False, **common)
    tcfg = TrainConfig(**common)
    tx = jstate.make_optimizer("adam", jcfg.lr, 10)
    jst = jstate.create_state(jax.random.key(0), jm, tx, jnp.zeros((1, 32, 32, 3), jnp.float32),
                              1, N_TRAIN)
    rng0 = jst.rng[0]
    # The next step's key is the last of the 8-way split (k_next).
    draws = [_draws(rng0), _draws(jax.random.split(rng0, 8)[7])]
    tm = tres.ResNet([1, 1], tres.BasicBlock, num_classes=10, num_filters=8)
    tm.load_state_dict(params_from_flax(jax.tree_util.tree_map(np.array, jst.params),
                                        jax.tree_util.tree_map(np.array, jst.batch_stats)))
    dataset = make_sharded_dataset((x, y), (xt, yt), [np.arange(N_TRAIN)], MEAN, STD, 10,
                                   device=torch.device("cpu"))
    ts = create_state(tm, "cpu", 0, N_TRAIN, "adam", tcfg.lr, 10)
    ts.stream = ShardStream(perm=torch.tensor(np.array(jst.stream.perm[0]), dtype=torch.long),
                            cursor=0)
    ts.ema = EMAState(torch.tensor(float(jst.ema.value[0])), torch.tensor(0, dtype=torch.int32))
    tmetrics = make_train_step(tcfg, dataset, scan_steps=2)(ts, draws)
    chunk = jmake_train_step(jm, tx, jcfg, host_cpu_mesh(1), MEAN, STD, scan_steps=2)
    shard = jnp.asarray(np.arange(N_TRAIN, dtype=np.int32)[None, :])
    jst, jmetrics = chunk(jst, jnp.asarray(x), jnp.asarray(y), shard)
    for key in ("train/loss", "train/pool_loss"):
        want = np.asarray(jmetrics[key])
        assert want.shape == tuple(tmetrics[key].shape) == (2,)
        np.testing.assert_allclose(float(tmetrics[key][0]), want[0], rtol=1e-5, err_msg=key)
        np.testing.assert_allclose(float(tmetrics[key][1]), want[1], rtol=1e-4, err_msg=key)
    np.testing.assert_array_equal(tmetrics["train/acc"].numpy(), np.asarray(jmetrics["train/acc"]))
    expect = params_from_flax(jax.tree_util.tree_map(np.array, jst.params),
                              jax.tree_util.tree_map(np.array, jst.batch_stats))
    got = ts.model.state_dict()
    for name, want in expect.items():
        if "running_" in name:
            np.testing.assert_allclose(got[name].numpy(), want.numpy(), rtol=1e-5, atol=1e-6,
                                       err_msg=name)
        else:
            np.testing.assert_allclose(got[name].numpy(), want.numpy(), atol=2 * jcfg.lr * 2,
                                       err_msg=name)
    assert ts.step == 2 and ts.stream.cursor == int(np.asarray(jst.stream.cursor[0])) == 2 * POOL
