"""``scoring_dtype`` in the port: the candidate-scoring forward (and the
grad-variance probe) in bf16 while training runs in float32, and the
scorer-only ingest (the scoretable's refresh window) emitting bf16.

On the CPU the port scores under CPU bf16 autocast (``scoring_dtype`` is
the caller's explicit ask, so it holds on any device), its input cast to
bf16 first, as the JAX package's bf16 ``scoring_model`` (the same Flax
ResNet with ``compute_dtype=bfloat16``) casts its input and computes.

Tolerances:
- the per-sample scores against the JAX bf16 scorer's: rtol 1e-2. The two
  round to bf16 (8 bits of mantissa, 2⁻⁸ ≈ 3.9e-3 relative) at different
  places: torch's autocast keeps BN and the pooling in float32 where Flax
  casts each layer's output to bf16. At this size they differ by about
  1e-3, and both sit about 2e-3 from the float32 scores.
- the bf16 fused ingest of the refresh window, replicated and streamed:
  bit-equal to the interpret-mode ``augment_normalize_pallas(...,
  out_dtype=bfloat16)`` fed the same key's crops and flips.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from mercury_tpu.models import resnet as jres  # noqa: E402
from mercury_tpu.ops import augment_normalize_pallas  # noqa: E402
from mercury_tpu.sampling.importance import per_sample_loss  # noqa: E402
from mercury_tpu_torch import TrainConfig, Trainer  # noqa: E402
from mercury_tpu_torch.data import cifar  # noqa: E402
from mercury_tpu_torch.data.pipeline import make_sharded_dataset  # noqa: E402
from mercury_tpu_torch.models import resnet as tres  # noqa: E402
from mercury_tpu_torch.models.convert import params_from_flax  # noqa: E402
from mercury_tpu_torch.ops import reference  # noqa: E402
from mercury_tpu_torch.train.state import Augment, Draws  # noqa: E402
from mercury_tpu_torch.train.step import scoring_forward  # noqa: E402

from test_torch_port_ranks import tiny_resnet  # noqa: E402

B, R, N_TRAIN = 4, 8, 24
MEAN, STD = cifar.CIFAR10_MEAN, cifar.CIFAR10_STD
COMMON = dict(dataset="synthetic", world_size=1, batch_size=B, presample_batches=2,
              compute_dtype="float32", num_epochs=1, steps_per_epoch=10, eval_every=0,
              log_every=0, seed=0)
TABLE = dict(sampler="scoretable", refresh_size=R, fused_input=True)


@pytest.fixture(autouse=True, scope="module")
def one_intra_op_thread():
    """The tiny steps here run one intra-op thread: with the test workers
    sharing the host's cores, torch's thread pool made each step of this
    size 30-50× slower (its barriers wait on descheduled threads)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def scorers():
    """The JAX bf16 and float32 scorers and the port's, from the same
    weights, over 16 normalized images."""
    rng = np.random.default_rng(0)
    images = rng.normal(0, 1, (16, 32, 32, 3)).astype(np.float32)
    labels = rng.integers(0, 10, 16).astype(np.int32)

    def jax_model(dtype):
        return jres.ResNet(stage_sizes=[1, 1], block_cls=jres.BasicBlock, num_classes=10,
                           num_filters=8, compute_dtype=dtype)

    variables = jax_model(jnp.float32).init(jax.random.key(1), jnp.zeros((1, 32, 32, 3)),
                                           train=False)

    def jax_scores(dtype):
        x = jnp.asarray(images).astype(dtype)
        logits, _ = jax_model(dtype).apply(variables, x, train=True, mutable=["batch_stats"])
        return np.asarray(per_sample_loss(logits.astype(jnp.float32), jnp.asarray(labels)))

    tm = tres.ResNet([1, 1], tres.BasicBlock, num_classes=10, num_filters=8)
    tm.load_state_dict(params_from_flax(jax.tree_util.tree_map(np.array, variables["params"]),
                                        jax.tree_util.tree_map(np.array,
                                                               variables["batch_stats"])))
    before = {k: v.clone() for k, v in tm.state_dict().items()}

    def port_scores(scoring_dtype):
        cfg = TrainConfig(world_size=1, compute_dtype="float32", scoring_dtype=scoring_dtype)
        logits = scoring_forward(tm, torch.from_numpy(images), cfg)
        assert logits.dtype == torch.float32
        return reference.nll_forward(logits, torch.from_numpy(labels)).numpy()

    out = dict(jax16=jax_scores(jnp.bfloat16), jax32=jax_scores(jnp.float32),
               port16=port_scores("bfloat16"), port32=port_scores("float32"),
               port_none=port_scores(None))
    out["stats_kept"] = all(torch.equal(v, tm.state_dict()[k]) for k, v in before.items())
    return out


def test_bf16_scores_match_the_jax_bf16_scorer(scorers):
    np.testing.assert_allclose(scorers["port16"], scorers["jax16"], rtol=1e-2)


def test_bf16_scores_are_bf16_and_float32_scores_are_float32(scorers):
    """The bf16 scorer really rounds (it is off the float32 scores by
    bf16-sized amounts); "float32" and None (float32 training on the CPU)
    are the float32 forward, which matches JAX's to rtol 1e-5."""
    gap = np.abs(scorers["port16"] - scorers["port32"]) / np.abs(scorers["port32"])
    assert 1e-5 < gap.max() < 2e-2
    np.testing.assert_array_equal(scorers["port32"], scorers["port_none"])
    np.testing.assert_allclose(scorers["port32"], scorers["jax32"], rtol=1e-5)
    assert scorers["stats_kept"]


def _window_input(trainer, draws=None):
    """The first forward's input in one step (the refresh window's scoring
    forward), back in NHWC."""
    seen = []
    hook = trainer.state.model.register_forward_pre_hook(
        lambda mod, args: seen.append(args[0].detach().clone()) if not seen else None)
    try:
        trainer.train_step(draws)
    finally:
        hook.remove()
    return seen[0].permute(0, 2, 3, 1)


@pytest.mark.parametrize("placement", ["replicated", "host_stream"])
def test_bf16_window_ingest_is_bit_equal_to_the_tpu_kernel(placement):
    """The refresh window of step 0 (slots 0 … R−1 of the one shard) goes
    to the scorer as bf16, bit-equal to the interpret-mode TPU kernel's
    bf16 output for the same crops and flips."""
    (x, y), (xt, yt) = cifar.synthetic_cifar(10, N_TRAIN, 8, seed=0)
    ds = make_sharded_dataset((x, y), (xt, yt), [np.arange(N_TRAIN)], MEAN, STD, 10,
                              device=torch.device("cpu"), placement=placement)
    cfg = TrainConfig(**COMMON, **TABLE, data_placement=placement, scoring_dtype="bfloat16")
    key = jax.random.key(7)
    k_crop, k_flip, _ = jax.random.split(key, 3)
    aug = Augment(torch.tensor(np.array(jax.random.randint(k_crop, (R, 2), 0, 9), np.int32)),
                  torch.tensor(np.array(jax.random.bernoulli(k_flip, shape=(R,)))))
    tr = Trainer(cfg, dataset=ds, device="cpu", model=tiny_resnet(0))
    try:
        if placement == "host_stream":
            # Step 0 trains on the ring's front: give it this window's draws.
            ring = tr.state.pending
            tr.state.pending = ring._replace(draws=(ring.draws[0]._replace(aug=aug),)
                                             + ring.draws[1:])
            got = _window_input(tr)
        else:
            draws = Draws(perm=None, aug=aug, uniforms=torch.rand(1, B),
                          aug2=Augment(torch.zeros(B, 2, dtype=torch.int32),
                                       torch.zeros(B, dtype=torch.bool)))
            got = _window_input(tr, draws)
    finally:
        tr.close()
    want = augment_normalize_pallas(key, jnp.asarray(x[:R]), MEAN, STD,
                                    out_dtype=jnp.bfloat16, use_kernel=True)
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == (R, 32, 32, 3)
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want.astype(jnp.float32)))


@pytest.mark.parametrize("kw", [dict(), TABLE, dict(TABLE, data_placement="host_stream"),
                                dict(data_placement="host_stream", variance_probe_every=2)],
                         ids=["pool", "scoretable", "scoretable-host_stream",
                              "pool-host_stream-probe"])
def test_bf16_scoring_trains(kw):
    """Float32 training with a bf16 scorer: finite losses, the pool loss the
    mean of the bf16 scores, and the probe (run by the scorer) finite."""
    cfg = TrainConfig(**{**COMMON, **kw}, scoring_dtype="bfloat16")
    tr = Trainer(cfg, device="cpu", model=tiny_resnet(0))
    try:
        out = [tr.train_step() for _ in range(4)]
        assert all(np.isfinite(float(m["train/loss"])) for m in out)
        assert all(np.isfinite(float(m["train/pool_loss"])) for m in out)
        if cfg.use_probe:
            assert float(out[1]["sampler_dist/var_ratio"]) > 0
            assert float(out[0]["sampler_dist/var_ratio"]) == -1.0
    finally:
        tr.close()


@pytest.mark.parametrize("kw,field", [
    (dict(scoring_dtype="bfloat16", use_importance_sampling=False), "scoring_dtype"),
    (dict(scoring_dtype="float16"), "scoring_dtype"),
])
def test_scoring_dtype_rejections(kw, field):
    with pytest.raises(ValueError, match=field):
        TrainConfig(world_size=1, **kw)
