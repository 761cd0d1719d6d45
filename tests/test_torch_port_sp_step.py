"""The port's data × seq Mercury step (``train/sp_step.py``) against the
JAX package's (``mercury_tpu/train/sp_step.py``), on the CPU.

The JAX steps run on a ``2 × 2`` (data × seq) mesh of four virtual CPU
devices, the port's on four gloo ranks of ``make_tp_mesh(2, 2, "data",
"seq")`` (one spawn a file; the rank body is
``test_torch_port_ranks.sp_step_rank``), with JAX's test model
(``tests/test_sequence_parallel.py``: T=64, F=12, C=5, N=64, d_model 32, 2
heads, 2 blocks, batch 4, presample 2) from the JAX weights
(``params_from_flax``), under SGD. The port gets each worker's JAX stream
permutation and the JAX draws: the JAX step draws by
``jax.random.categorical`` over its pool's ``p``, read off the step through
a wrapped ``draw_with_replacement`` (``jax.debug.callback``), and the port
is fed that draw as uniforms at the middle of each drawn index's CDF
interval.

Cases here: the Mercury step with ring attention and zigzag causal, three
steps each, telemetry on; the parameters' layout. The MoE arm and
``make_dp_sp_train_step`` are ``test_torch_port_sp_train_step.py``'s, with
these helpers. Tolerances, the JAX package's for its sequence-sharded steps
against its unsharded ones (``tests/test_sequence_parallel.py``): a step's
loss rtol 1e-5, the parameters after it rtol 1e-4 and atol 1e-5, three
steps' losses rtol 5e-3; the pool loss, ESS, clip share and drift rtol 1e-5
and the gradient's norm rtol 1e-4. The selections are the JAX draws
exactly, and equal on the two ranks of each sequence group.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax import lax  # noqa: E402
from jax.sharding import Mesh  # noqa: E402

from mercury_tpu.models import TransformerClassifier as JTransformer  # noqa: E402
from mercury_tpu.sampling import importance as jimp  # noqa: E402
from mercury_tpu_torch.models.convert import flax_leaves, params_from_flax  # noqa: E402
from mercury_tpu_torch.models.transformer import TransformerClassifier  # noqa: E402
from mercury_tpu_torch.parallel.distributed import spawn  # noqa: E402
from test_torch_port_config_step import _uniforms_for  # noqa: E402
from test_torch_port_ranks import sp_step_rank  # noqa: E402

T, F, C, N = 64, 12, 5, 64
WD, S, B, PRESAMPLE, STEPS, LR = 2, 2, 4, 2, 3, 0.05
MERCURY = {"ring": dict(sp_impl="ring"),
           "zigzag": dict(sp_impl="zigzag", causal=True),
           "moe0": dict(num_layers=1, moe_experts=2, aux_weight=0.0),
           "moe10": dict(num_layers=1, moe_experts=2, aux_weight=10.0)}
TRAIN = {"ring": dict(sp_impl="ring"), "zigzag": dict(sp_impl="zigzag", causal=True),
         "ulysses": dict(sp_impl="ulysses")}
TELEMETRY = ("train/pool_loss", "sampler/ess", "sampler/clip_frac", "sampler/ema_drift")


def _np_tree(tree):
    return jax.tree_util.tree_map(lambda a: np.array(a), tree)


def _model_kw(kw):
    return dict(num_classes=C, d_model=32, num_heads=2, num_layers=kw.get("num_layers", 2),
                max_len=T, causal=kw.get("causal", False),
                moe_experts=kw.get("moe_experts"), sp_axis="seq",
                sp_impl=kw.get("sp_impl", "ring"))


def _data():
    x = jax.random.normal(jax.random.key(40), (N, T, F))
    y = jnp.asarray(np.random.default_rng(41).integers(0, C, N))
    return x, y


def _mesh():
    return Mesh(np.array(jax.devices()[:WD * S]).reshape(WD, S), ("data", "seq"))


def _jax_mercury(kw, x, y):
    """JAX's Mercury step: its initial weights and streams, each step's
    draws as uniforms a worker, its metrics and the parameters after the
    first step."""
    import optax

    from mercury_tpu.train import sp_step as jsp

    model = JTransformer(**_model_kw(kw))
    tx = optax.sgd(LR)
    steps = 1 if "moe_experts" in kw else STEPS
    state = jsp.init_sp_mercury_state(jax.random.key(7), model, tx, x[:1], WD, N)
    init = params_from_flax(_np_tree(state.params), {})
    perms = [np.array(state.stream.perm[w]) for w in range(WD)]
    step = jsp.make_dp_sp_mercury_step(model, tx, _mesh(), batch_size=B,
                                       presample_batches=PRESAMPLE,
                                       moe_aux_weight=kw.get("aux_weight", 0.01),
                                       telemetry=True)
    seen, original = [], jimp.draw_with_replacement

    def record(data, seq, probs, drawn):
        seen.append((int(data), int(seq), np.array(probs), np.array(drawn)))

    def spy(key, probs, n):
        drawn = original(key, probs, n)
        jax.debug.callback(record, lax.axis_index("data"), lax.axis_index("seq"), probs, drawn)
        return drawn

    metrics, uniforms, selected, params = [], [], [], None
    jimp.draw_with_replacement = spy
    try:
        for _ in range(steps):
            seen.clear()
            state, m = step(state, x, y)
            metrics.append({k: float(v) for k, v in m.items()})
            jax.effects_barrier()
            by = {(d, s): (p, i) for d, s, p, i in seen}
            assert sorted(by) == [(d, s) for d in range(WD) for s in range(S)]
            for d in range(WD):
                # JAX's seq ranks of a worker draw alike too.
                np.testing.assert_array_equal(by[d, 0][1], by[d, 1][1])
            uniforms.append([_uniforms_for(*by[d, 0]) for d in range(WD)])
            selected.append([by[d, 0][1] for d in range(WD)])
            if params is None:
                params = params_from_flax(_np_tree(state.params), {})
    finally:
        jimp.draw_with_replacement = original
    return dict(init=init, perms=perms, uniforms=uniforms, metrics=metrics,
                selected=selected, params=params,
                ema=np.asarray(state.ema.value))


def _jax_train(kw, x, y):
    """One step of JAX's ``make_dp_sp_train_step`` on the first 4 rows."""
    import optax

    from mercury_tpu.train.sp_step import make_dp_sp_train_step

    model = JTransformer(**_model_kw(kw))
    dense = model.clone(sp_axis=None)
    tx = optax.sgd(LR)
    xb, yb = x[:B], y[:B]
    params = dense.init(jax.random.key(31), xb, train=False)["params"]
    init = params_from_flax(_np_tree(params), {})
    p2, _, loss = make_dp_sp_train_step(model, tx, _mesh())(params, tx.init(params), xb, yb)
    return dict(init=init, loss=float(loss), params=params_from_flax(_np_tree(p2), {}),
                batch=(np.asarray(xb), np.asarray(yb)))


def run_both(mercury, train=()):
    """JAX's Mercury steps of the ``mercury`` cases and train steps of the
    ``train`` cases, then the port's on four gloo ranks: the JAX results
    and the port's by case, and each rank's place."""
    x, y = _data()
    ref, jobs, names = {}, [], []
    for name in mercury:
        kw = MERCURY[name]
        r = ref[f"mercury/{name}"] = _jax_mercury(kw, x, y)
        jobs.append(dict(kind="mercury", model=dict(_model_kw(kw), in_features=F),
                         state_dict=r["init"], lr=LR, perms=r["perms"],
                         uniforms=r["uniforms"], aux_weight=kw.get("aux_weight", 0.01)))
        names.append(f"mercury/{name}")
    for name in train:
        kw = TRAIN[name]
        r = ref[f"train/{name}"] = _jax_train(kw, x, y)
        jobs.append(dict(kind="train", model=dict(_model_kw(kw), in_features=F),
                         state_dict=r["init"], lr=LR, batch=r["batch"]))
        names.append(f"train/{name}")
    ranks = spawn(sp_step_rank, WD * S, "gloo", jobs, np.asarray(x), np.asarray(y))
    ports = {name: [r["jobs"][i] for r in ranks] for i, name in enumerate(names)}
    return ref, ports, ranks


@pytest.fixture(scope="module")
def both():
    return run_both(("ring", "zigzag"))


def _check_params(got, want):
    assert got.keys() == want.keys()
    for k, w in want.items():
        np.testing.assert_allclose(got[k].numpy(), w.numpy(), rtol=1e-4, atol=1e-5,
                                   err_msg=k)


@pytest.mark.parametrize("name", ["ring", "zigzag"])
def test_mercury_step_matches_jax(both, name):
    ref, ports, _ = both
    want = ref[f"mercury/{name}"]
    for port in ports[f"mercury/{name}"]:
        losses = [float(m["train/loss"]) for m in port["metrics"]]
        jlosses = [m["train/loss"] for m in want["metrics"]]
        np.testing.assert_allclose(losses[0], jlosses[0], rtol=1e-5)
        np.testing.assert_allclose(losses, jlosses, rtol=5e-3)
        _check_params(port["params"], want["params"])
        for t, m in enumerate(port["metrics"]):
            for key in TELEMETRY:
                np.testing.assert_allclose(float(m[key]), want["metrics"][t][key], rtol=1e-5,
                                           atol=1e-7, err_msg=f"step {t} {key}")
            np.testing.assert_allclose(float(m["train/grad_norm"]),
                                       want["metrics"][t]["train/grad_norm"], rtol=1e-4)
        np.testing.assert_allclose(port["ema"], want["ema"][0], rtol=1e-5)


def test_seq_ranks_draw_jax_s_indices(both):
    """Every rank draws its worker's JAX indices at every step, so the two
    ranks of a sequence group draw the same."""
    ref, ports, ranks = both
    for name in ("ring", "zigzag"):
        for r, port in zip(ranks, ports[f"mercury/{name}"]):
            for t, m in enumerate(port["metrics"]):
                np.testing.assert_array_equal(
                    m["sampler/selected"].numpy(), ref[f"mercury/{name}"]["selected"][t]
                    [r["data_rank"]], err_msg=f"{name} step {t} rank {r['rank']}")
    assert [(r["data_rank"], r["seq_rank"]) for r in ranks] == [(0, 0), (0, 1), (1, 0), (1, 1)]


def test_parameters_do_not_change_with_sp_axis():
    """The SP model's parameters are the dense model's, names, shapes and
    Flax paths, so ``params_from_flax`` carries JAX's weights across
    unchanged (JAX's SP model initializes through its axis-free clone)."""
    kw = _model_kw({})
    dense = TransformerClassifier(**{**kw, "sp_axis": None}, in_features=F)
    for impl in ("ring", "zigzag", "ulysses"):
        sp = TransformerClassifier(**{**kw, "sp_impl": impl}, in_features=F)
        assert [(k, v.shape) for k, v in sp.state_dict().items()] == \
            [(k, v.shape) for k, v in dense.state_dict().items()]
        assert flax_leaves(sp) == flax_leaves(dense)
    x, _ = _data()
    params = JTransformer(**{**kw, "sp_axis": None}).init(jax.random.key(1), x[:1],
                                                          train=False)["params"]
    sp.load_state_dict(params_from_flax(_np_tree(params), {}))
