"""The port's ResNet against the Flax ResNet of the JAX package, from the
same weights (``params_from_flax``), in float32 on the CPU."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import flax.linen as fnn  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from mercury_tpu.models import resnet as jres  # noqa: E402
from mercury_tpu_torch.models import create_model  # noqa: E402
from mercury_tpu_torch.models import resnet as tres  # noqa: E402
from mercury_tpu_torch.models.convert import params_from_flax  # noqa: E402

# Forward tolerance: the same float32 math in another order (XLA vs ATen
# convolutions and reductions) over a few layers.
LOGITS_ATOL = 1e-4


def _pair(block="basic", stage_sizes=(1, 1), seed=0):
    jblock = jres.BasicBlock if block == "basic" else jres.Bottleneck
    tblock = tres.BasicBlock if block == "basic" else tres.Bottleneck
    jm = jres.ResNet(stage_sizes=list(stage_sizes), block_cls=jblock,
                     num_classes=10, num_filters=8, compute_dtype=jnp.float32)
    x = np.random.default_rng(seed).normal(0, 1, (6, 32, 32, 3)).astype(np.float32)
    variables = jm.init(jax.random.key(seed), jnp.asarray(x), train=False)
    # Non-trivial running stats so eval mode tests the conversion of them.
    stats = jax.tree_util.tree_map(
        lambda a: a + 0.1 * np.random.default_rng(seed + 1).uniform(0.5, 1.5, a.shape),
        variables["batch_stats"])
    variables = {"params": variables["params"], "batch_stats": stats}
    tm = tres.ResNet(list(stage_sizes), tblock, num_classes=10, num_filters=8)
    tm.load_state_dict(params_from_flax(variables["params"], variables["batch_stats"]))
    return jm, variables, tm, x


def _nchw(x):
    return torch.from_numpy(x).permute(0, 3, 1, 2).contiguous()


@pytest.mark.parametrize("block", ["basic", "bottleneck"])
def test_eval_forward_matches_flax(block):
    jm, variables, tm, x = _pair(block)
    ref = np.asarray(jm.apply(variables, jnp.asarray(x), train=False))
    with torch.no_grad():
        ours = tm(_nchw(x), train=False).numpy()
    np.testing.assert_allclose(ours, ref, atol=LOGITS_ATOL)


def test_train_forward_and_running_stats_match_flax():
    """Train mode normalizes with batch statistics and updates the running
    ones with the biased variance, as Flax does (``F.batch_norm`` alone
    would store the unbiased one)."""
    jm, variables, tm, x = _pair("basic", stage_sizes=(1, 1, 1))
    ref, new_state = jm.apply(variables, jnp.asarray(x), train=True,
                              mutable=["batch_stats"])
    ours = tm(_nchw(x), train=True, keep_stats=True)
    np.testing.assert_allclose(ours.detach().numpy(), np.asarray(ref),
                               atol=LOGITS_ATOL)
    expect = params_from_flax(variables["params"], new_state["batch_stats"])
    got = tm.state_dict()
    for k in expect:
        if "running_" in k:
            np.testing.assert_allclose(got[k].numpy(), expect[k].numpy(),
                                       rtol=1e-5, atol=1e-6, err_msg=k)


def test_scoring_forward_keeps_running_stats():
    _, _, tm, x = _pair("basic")
    before = {k: v.clone() for k, v in tm.state_dict().items()}
    with torch.no_grad():
        tm(_nchw(x), train=True, keep_stats=False)
    for k, v in tm.state_dict().items():
        assert torch.equal(v, before[k]), k
    tm(_nchw(x), train=True, keep_stats=True)
    assert not torch.equal(tm.bn.running_mean, before["bn.running_mean"])


def test_resnet18_param_count():
    model = create_model("resnet18", 10, torch.Generator().manual_seed(0))
    assert sum(p.numel() for p in model.parameters()) == 11_173_962


def test_stride2_needs_same_padding():
    """XLA's SAME pads a stride-2 3×3 conv (0, 1); PyTorch's padding=1 pads
    (1, 1) and shifts the output by a pixel."""
    rng = np.random.default_rng(3)
    x = rng.normal(0, 1, (2, 32, 32, 4)).astype(np.float32)
    conv = fnn.Conv(6, (3, 3), strides=(2, 2), use_bias=False)
    variables = conv.init(jax.random.key(0), jnp.asarray(x))
    ref = np.asarray(conv.apply(variables, jnp.asarray(x))).transpose(0, 3, 1, 2)
    w = torch.tensor(np.asarray(variables["params"]["kernel"])).permute(3, 2, 0, 1)
    same = tres.SameConv2d(4, 6, 3, stride=2)
    same.weight.data.copy_(w)
    with torch.no_grad():
        ours = same(_nchw(x)).numpy()
        symmetric = F.conv2d(_nchw(x), w, stride=2, padding=1).numpy()
    np.testing.assert_allclose(ours, ref, atol=1e-5)
    assert symmetric.shape == ref.shape
    assert np.abs(symmetric - ref).max() > 0.1


def test_convert_rejects_unknown_module():
    with pytest.raises(KeyError, match="Mystery_0"):
        params_from_flax({"Mystery_0": {}}, {})
