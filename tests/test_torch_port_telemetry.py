"""The port's telemetry functions (``mercury_tpu_torch/obs/``, and
``per_sample_grad_norm_bound``) against the JAX package's, on the same
seeded numpy inputs, on the CPU.

Tolerances: rtol 1e-6 on the float32 scalars (sums in another order);
the table's ages exact, except the float32 mean at L=50,000, whose sum of
float32 ages rounds past 2²⁴ in XLA's order (rtol 1e-6); the histograms
bin for bin, on values more than 1e-5 relative from every bin edge (a
one-ulp difference of two ``log`` implementations moves a value on an
edge); the numpy host half equal or rtol 1e-12.
"""

import math
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from mercury_tpu.obs import diagnostics as jdiag  # noqa: E402
from mercury_tpu.obs import sampler_health as jsh  # noqa: E402
from mercury_tpu.sampling import importance as jimp  # noqa: E402
from mercury_tpu_torch import TrainConfig  # noqa: E402
from mercury_tpu_torch.obs import diagnostics as tdiag  # noqa: E402
from mercury_tpu_torch.obs import sampler_health as tsh  # noqa: E402
from mercury_tpu_torch.sampling import importance as timp  # noqa: E402

EDGE_PAIRS = [(tsh.SCORE_HIST_LO, tsh.SCORE_HIST_HI),
              (tsh.WEIGHT_HIST_LO, tsh.WEIGHT_HIST_HI)]


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _scaled_probs(rng, n, b):
    """``N·p`` of a batch of ``b`` drawn from ``n`` candidates with
    exponential scores."""
    p = rng.exponential(1.0, n)
    p /= p.sum()
    return (p[rng.integers(0, n, b)] * n).astype(np.float32)


@pytest.mark.parametrize("n,b,seed", [(320, 32, 0), (5000, 32, 1), (16, 4, 2)])
def test_ess_clip_drift_match(n, b, seed):
    rng = np.random.default_rng(seed)
    sp = _scaled_probs(rng, n, b)
    losses = rng.exponential(1.0, n).astype(np.float32)
    losses[: n // 8] = 0.0
    ema, prev, mean = np.float32(rng.uniform(0, 2)), np.float32(1.3), np.float32(0.7)
    for ema_v in (ema, np.float32(0.0)):
        np.testing.assert_allclose(
            float(tdiag.clip_fraction(_t(losses), _t(ema_v), 0.5)),
            float(jdiag.clip_fraction(jnp.asarray(losses), jnp.asarray(ema_v), 0.5)),
            rtol=1e-6)
    np.testing.assert_allclose(float(tdiag.ess_fraction(_t(sp))),
                               float(jdiag.ess_fraction(jnp.asarray(sp))), rtol=1e-6)
    assert float(tdiag.ema_drift(_t(mean), _t(prev))) == float(
        jdiag.ema_drift(jnp.asarray(mean), jnp.asarray(prev)))


def test_forced_clip_and_unit_weights():
    """Zero losses under a zero EMA all sit at the floor; unit weights give
    an ESS of exactly 1."""
    zeros = np.zeros(320, np.float32)
    assert float(tdiag.clip_fraction(_t(zeros), torch.tensor(0.0))) == 1.0 == float(
        jdiag.clip_fraction(jnp.asarray(zeros), jnp.float32(0.0)))
    ones = np.ones(32, np.float32)
    assert float(tdiag.ess_fraction(_t(ones))) == 1.0 == float(
        jdiag.ess_fraction(jnp.asarray(ones)))


@pytest.mark.parametrize("n_slots,refresh,cursors", [
    (5000, 64, [0, 64, 4992, 1280]),
    (37, 8, list(range(37))),
    (50_000, 64, [0, 49_984]),
])
def test_table_ages_match(n_slots, refresh, cursors):
    lo, mean, hi = tdiag.table_age_summary(n_slots, refresh)
    for cursor in cursors:
        want = np.asarray(jdiag.table_ages(jnp.int32(cursor), n_slots, refresh))
        np.testing.assert_array_equal(tdiag.table_ages(cursor, n_slots, refresh).numpy(),
                                      want)
        jlo, jmean, jhi = (float(v) for v in
                           jdiag.table_age_summary(jnp.int32(cursor), n_slots, refresh))
        assert (lo, hi) == (jlo, jhi)
        if n_slots * (n_slots // refresh) < 2 ** 24:  # the float32 sum is exact
            assert mean == jmean
        else:
            np.testing.assert_allclose(mean, jmean, rtol=1e-6)


def test_global_grad_norm_matches():
    rng = np.random.default_rng(3)
    shapes = [(64, 3, 3, 3), (64,), (128, 64, 3, 3), (10, 512), (10,)]
    grads = [rng.normal(0, 1e-2, s).astype(np.float32) for s in shapes]
    np.testing.assert_allclose(
        float(tdiag.global_grad_norm([_t(g) for g in grads])),
        float(jdiag.global_grad_norm([jnp.asarray(g) for g in grads])), rtol=1e-6)


def _edge_distance(x, lo, hi, bins=tsh.HIST_BINS):
    """Least relative distance of each value above ``lo`` to a bin edge."""
    edges = tsh.hist_bin_edges(lo, hi, bins)
    x = np.asarray(x, np.float64)[:, None]
    return np.min(np.abs(x / edges[None, :] - 1.0), axis=1)


@pytest.mark.parametrize("lo,hi", EDGE_PAIRS)
@pytest.mark.parametrize("size,sigma", [(1, 1.0), (57, 2.0), (4096, 6.0)])
def test_log_bin_histogram_matches(lo, hi, size, sigma):
    x = np.random.default_rng(size).lognormal(0.0, sigma, size).astype(np.float32)
    assert np.min(_edge_distance(x, lo, hi)) > 1e-5
    got = tsh.log_bin_histogram(_t(x), lo, hi)
    assert got.dtype == torch.int32 and int(got.sum()) == size
    np.testing.assert_array_equal(got.numpy(), np.asarray(
        jsh.log_bin_histogram(jnp.asarray(x), lo, hi)))
    np.testing.assert_array_equal(got.numpy(), tsh.log_bin_histogram_np(x, lo, hi))
    np.testing.assert_array_equal(tsh.log_bin_histogram_np(x, lo, hi),
                                  jsh.log_bin_histogram_np(x, lo, hi))


@pytest.mark.parametrize("lo,hi", EDGE_PAIRS)
def test_log_bin_histogram_edges_and_clamps(lo, hi):
    """Every edge exactly, zero, below ``lo``, ``lo``, ``hi``, above it,
    1, +inf, −inf and NaN: the counts total the values (the ends clamp)
    and equal the JAX package's, NaN in bin 0 as its numpy reference puts
    it."""
    edges = tsh.hist_bin_edges(lo, hi).astype(np.float32)
    x = np.concatenate([edges, np.float32([0.0, lo / 10, lo, hi, hi * 10, 1.0, np.inf,
                                           -np.inf])])
    got = tsh.log_bin_histogram(_t(x), lo, hi).numpy()
    np.testing.assert_array_equal(got, np.asarray(jsh.log_bin_histogram(jnp.asarray(x), lo, hi)))
    np.testing.assert_array_equal(got, jsh.log_bin_histogram_np(x, lo, hi))
    assert int(got.sum()) == x.size
    nan = tsh.log_bin_histogram(torch.tensor([math.nan, 1e-30, 0.0]), lo, hi).numpy()
    np.testing.assert_array_equal(nan, jsh.log_bin_histogram_np(
        np.float32([math.nan, 1e-30, 0.0]), lo, hi))
    assert nan[0] == 3
    top = tsh.log_bin_histogram(torch.tensor([1e30, math.inf]), lo, hi).numpy()
    assert top[-1] == 2 and top.sum() == 2


def test_hist_keys_and_edges_match():
    for family in ("score_hist", "w_hist"):
        assert tsh.hist_keys(family) == jsh.hist_keys(family)
        assert len(tsh.hist_keys(family)) == tsh.HIST_BINS == jsh.HIST_BINS
    assert (tsh.SCORE_HIST_LO, tsh.SCORE_HIST_HI, tsh.WEIGHT_HIST_LO, tsh.WEIGHT_HIST_HI) == (
        jsh.SCORE_HIST_LO, jsh.SCORE_HIST_HI, jsh.WEIGHT_HIST_LO, jsh.WEIGHT_HIST_HI)
    for lo, hi in EDGE_PAIRS:
        np.testing.assert_array_equal(tsh.hist_bin_edges(lo, hi), jsh.hist_bin_edges(lo, hi))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_variance_probe_ratio_matches(seed):
    rng = np.random.default_rng(seed)
    g = rng.uniform(0.05, 1.4, 32).astype(np.float32)
    sp = _scaled_probs(rng, 320, 32)
    np.testing.assert_allclose(
        float(tsh.variance_probe_ratio(_t(g), _t(sp))),
        float(jsh.variance_probe_ratio(jnp.asarray(g), jnp.asarray(sp))), rtol=1e-6)
    ones = np.ones(32, np.float32)
    assert float(tsh.variance_probe_ratio(_t(g), _t(ones))) == 1.0 == float(
        jsh.variance_probe_ratio(jnp.asarray(g), jnp.asarray(ones)))


@pytest.mark.parametrize("c", [10, 100])
@pytest.mark.parametrize("label_smoothing", [0.0, 0.1])
def test_per_sample_grad_norm_bound_matches(c, label_smoothing):
    rng = np.random.default_rng(c)
    z = rng.normal(0, 3, (64, c)).astype(np.float32)
    y = rng.integers(0, c, 64).astype(np.int32)
    want = np.asarray(jimp.per_sample_grad_norm_bound(jnp.asarray(z), jnp.asarray(y),
                                                      label_smoothing))
    got = timp.per_sample_grad_norm_bound(_t(z), _t(y), label_smoothing)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)


def _ledger_case(seed, w=3, length=40, n=100, classes=10):
    rng = np.random.default_rng(seed)
    sidx = np.stack([rng.permutation(n)[:length] for _ in range(w)])
    counts = rng.integers(0, 6, (w, length)).astype(np.int32)
    counts[0, :5] = 0
    labels = rng.integers(0, classes - 1, n)  # the last class absent
    scores = rng.exponential(1.0, (w, length)).astype(np.float32)
    ema = rng.uniform(0.2, 2.0, w).astype(np.float32)
    return sidx, counts, labels, scores, ema, n, classes


@pytest.mark.parametrize("seed", [0, 1])
def test_host_half_matches(seed):
    sidx, counts, labels, scores, ema, n, classes = _ledger_case(seed)
    glob = tsh.ledger_global_counts(counts, sidx, n)
    np.testing.assert_array_equal(glob, jsh.ledger_global_counts(counts, sidx, n))
    assert glob.sum() == counts.sum()
    assert tsh.gini(glob) == pytest.approx(jsh.gini(glob), rel=1e-12)
    assert tsh.gini(np.zeros(5)) == jsh.gini(np.zeros(5)) == 0.0
    for share in (0.2, 0.9):
        assert tsh.class_spread(glob, labels, classes, share) == pytest.approx(
            jsh.class_spread(glob, labels, classes, share), rel=1e-12)
    probs = tsh.table_probs_np(scores, ema, 0.5)
    np.testing.assert_allclose(probs, jsh.table_probs_np(scores, ema, 0.5), rtol=1e-12)
    for c in (counts, counts[0]):
        p = probs if c.ndim == 2 else probs[0]
        assert tsh.bias_audit(c, p) == pytest.approx(jsh.bias_audit(c, p), rel=1e-12)
    assert tsh.bias_audit(np.zeros_like(counts), probs) == jsh.bias_audit(
        np.zeros_like(counts), probs)
    assert tsh.sparkline(np.arange(16)) == jsh.sparkline(np.arange(16))
    assert tsh.sparkline(np.zeros(4)) == jsh.sparkline(np.zeros(4))


@pytest.mark.parametrize("seed", [0, 1])
def test_monitor_matches_the_jax_monitor(seed):
    """The seven keys of one ``[W, L]`` ledger, table and EMA, from a
    namespace of numpy arrays (the JAX monitor's ``state``), from tensors
    and from the gathered rows."""
    sidx, counts, labels, scores, ema, _, classes = _ledger_case(seed)
    state = SimpleNamespace(sel_counts=counts, scoretable=SimpleNamespace(scores=scores),
                            ema=SimpleNamespace(value=ema))
    want = jsh.SamplerHealthMonitor(sidx, labels, classes, 0.5).stats(state)
    assert len(want) == 7
    mon = tsh.SamplerHealthMonitor(sidx, labels, classes, 0.5)
    tstate = SimpleNamespace(sel_counts=_t(counts), scoretable=SimpleNamespace(
        scores=_t(scores)), ema=SimpleNamespace(value=_t(ema)))
    for got in (mon.stats(state), mon.stats(tstate), mon.stats_of(counts, scores, ema)):
        assert got.keys() == want.keys()
        for k, v in want.items():
            assert got[k] == pytest.approx(v, rel=1e-12), k
    assert mon.stats(SimpleNamespace(sel_counts=None)) == {}


def test_config_fields_and_validation():
    cfg = TrainConfig(world_size=1)
    assert cfg.telemetry is True and cfg.variance_probe_every == 0
    assert not cfg.use_probe and not cfg.use_ledger
    assert TrainConfig(world_size=1, sampler="scoretable").use_ledger
    assert not TrainConfig(world_size=1, sampler="scoretable", telemetry=False).use_ledger
    assert TrainConfig(world_size=1, variance_probe_every=4).use_probe
    assert not TrainConfig(world_size=1, variance_probe_every=4,
                           use_importance_sampling=False).use_probe
    assert not TrainConfig(world_size=1, variance_probe_every=4, telemetry=False).use_probe
    with pytest.raises(ValueError, match="variance_probe_every"):
        TrainConfig(world_size=1, variance_probe_every=-1)
