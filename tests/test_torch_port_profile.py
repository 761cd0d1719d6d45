"""The port's ``train/profile.py`` and FLOP count on a tiny CPU trainer:
``timing_breakdown`` gives the six segments of the JAX package's, as
non-negative floats (the numbers are host noise; only their shape and
sanity are held, as ``tests/test_profile.py`` holds JAX's); ``trace``
writes a Chrome trace; ``flops_per_step`` equals the closed form
``2·M·P + 3·2·M·B`` less the first convolution's input gradient
(``2·M₁·B``), with M the multiply-adds of one image's forward counted from
the layers' shapes, and leaves the trainer's state bit-equal.
"""

import json
import os

import pytest

torch = pytest.importorskip("torch")

from mercury_tpu_torch import TrainConfig, Trainer  # noqa: E402
from mercury_tpu_torch.models.resnet import BasicBlock, ResNet, init_weights  # noqa: E402
from mercury_tpu_torch.obs.accounting import flops_per_step, scoring_forwards  # noqa: E402
from mercury_tpu_torch.train.profile import timing_breakdown, trace  # noqa: E402

EXPECTED_KEYS = {"step_time", "ff_time", "bp_time", "fb_time", "is_time", "sync_time"}
B, PRESAMPLE, R = 4, 4, 8


def _tiny(**kw):
    base = dict(dataset="synthetic", world_size=1, batch_size=B, presample_batches=PRESAMPLE,
                compute_dtype="float32", num_epochs=1, steps_per_epoch=4, eval_every=0,
                log_every=0, seed=0)
    base.update(kw)
    model = ResNet([1, 1], BasicBlock, num_classes=10, num_filters=8)
    init_weights(model, torch.Generator().manual_seed(0))
    return Trainer(TrainConfig(**base), device="cpu", model=model)


def test_timing_breakdown_six_nonnegative_segments():
    with _tiny() as tr:
        before = tr.state.step
        out = timing_breakdown(tr, iters=2)
        assert tr.state.step == before + 3  # the warm call and two timed steps
    assert set(out) == EXPECTED_KEYS
    for key, value in out.items():
        assert isinstance(value, float) and value >= 0.0, (key, value)
    assert out["bp_time"] <= out["fb_time"] + 1e-12
    assert out["step_time"] > 0 and out["is_time"] > 0


def test_trace_writes_a_chrome_trace(tmp_path):
    log_dir = str(tmp_path / "trace")
    with _tiny() as tr, trace(log_dir):
        tr.train_step()
    path = os.path.join(log_dir, "trace.json")
    events = json.load(open(path))["traceEvents"]
    assert any("conv" in str(e.get("name", "")) for e in events)


def _macs(model):
    """Multiply-adds of one 32×32 image's forward, in all and of the first
    convolution, from each layer's shapes (a real forward with hooks)."""
    macs = []

    def hook(mod, inputs, output):
        if isinstance(mod, torch.nn.Conv2d):
            kh, kw = mod.kernel_size
            macs.append(output.numel() * mod.in_channels // mod.groups * kh * kw)
        else:
            macs.append(output.numel() * mod.in_features)

    handles = [m.register_forward_hook(hook) for m in model.modules()
               if isinstance(m, (torch.nn.Conv2d, torch.nn.Linear))]
    with torch.no_grad():
        model(torch.zeros(2, 3, 32, 32), train=False, keep_stats=False)
    for h in handles:
        h.remove()
    return sum(macs) // 2, macs[0] // 2


@pytest.mark.parametrize("kw,scored", [
    (dict(), B * PRESAMPLE),
    (dict(sampler="scoretable", refresh_size=R), R),
    (dict(use_importance_sampling=False), 0),
    (dict(score_refresh_every=4), B * PRESAMPLE / 4),
    (dict(variance_probe_every=2), B * PRESAMPLE + B / 2),
], ids=["pool", "scoretable", "uniform", "cadence", "probe"])
def test_flops_per_step_is_the_closed_form(kw, scored):
    with _tiny(**kw) as tr:
        assert sum(rows * share for rows, share in scoring_forwards(tr.config)) == scored
        m, m_first = _macs(tr.state.model)
        want = 2 * m * scored + 3 * 2 * m * B - 2 * m_first * B
        assert flops_per_step(tr) == pytest.approx(want, rel=1e-12)


@pytest.mark.parametrize("name,kw", [
    ("smallcnn", {}),
    ("vgg11", {}),
    ("mobilenetv2", dict(width_mult=0.25)),
], ids=["smallcnn", "vgg11", "mobilenetv2"])
@pytest.mark.parametrize("sampler", ["pool", "uniform"])
def test_flops_per_step_is_the_closed_form_for_each_family(name, kw, sampler):
    """The same closed form on the image families: VGG's Dense head and
    MobileNetV2's depthwise 3×3s, whose weight gradient counts its groups'
    work alone."""
    from mercury_tpu_torch.models import create_model

    model = create_model(name, 10, torch.Generator().manual_seed(0), **kw)
    config = dict(dataset="synthetic", world_size=1, batch_size=B,
                  presample_batches=PRESAMPLE, compute_dtype="float32", num_epochs=1,
                  steps_per_epoch=4, eval_every=0, log_every=0, seed=0,
                  use_importance_sampling=sampler == "pool")
    scored = B * PRESAMPLE if sampler == "pool" else 0
    with Trainer(TrainConfig(**config), device="cpu", model=model) as tr:
        m, m_first = _macs(tr.state.model)
        want = 2 * m * scored + 3 * 2 * m * B - 2 * m_first * B
        assert flops_per_step(tr) == pytest.approx(want, rel=1e-12)


def test_counting_leaves_the_trainer_as_it_was():
    with _tiny() as tr:
        tr.train_step()
        st = tr.state
        model_before = {k: v.clone() for k, v in st.model.state_dict().items()}
        grads_before = [None if p.grad is None else p.grad.clone()
                        for p in st.model.parameters()]
        ema_before = (st.ema.value.clone(), st.ema.count.clone())
        gen_before, cpu_rng = st.generator.get_state(), torch.get_rng_state()
        step, updates, cursor = st.step, st.updates, st.stream.cursor
        assert flops_per_step(tr) > 0
        for k, v in st.model.state_dict().items():
            assert torch.equal(v, model_before[k]), k
        for p, g in zip(st.model.parameters(), grads_before):
            assert (p.grad is None and g is None) or torch.equal(p.grad, g)
        assert torch.equal(st.ema.value, ema_before[0]) and torch.equal(st.ema.count,
                                                                        ema_before[1])
        assert torch.equal(st.generator.get_state(), gen_before)
        assert torch.equal(torch.get_rng_state(), cpu_rng)
        assert (st.step, st.updates, st.stream.cursor) == (step, updates, cursor)
