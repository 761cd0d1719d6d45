"""``Trainer.predict`` and ``Trainer.per_class_accuracy`` of the port against
the JAX package's inference path, in float32 on the CPU.

The JAX side is composed from the package's own functions, as its
``Trainer.predict`` composes them: ``mercury_tpu.data.pipeline.
normalize_images`` (``/255`` for uint8 only), then ``model.apply(...,
train=False)``. Both sides hold the same weights (``params_from_flax``) and
random running statistics, so the eval-mode BN does real work. Logits to
rtol 1e-5, atol 1e-6 (float32 through the same convolutions, summed in
another order by XLA and ATen). Tiny sizes: a [1, 1]-stage ResNet of width
8, 64 test images.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from mercury_tpu.data.pipeline import normalize_images as jnormalize  # noqa: E402
from mercury_tpu.models import resnet as jres  # noqa: E402
from mercury_tpu_torch import TrainConfig, Trainer  # noqa: E402
from mercury_tpu_torch.models import resnet as tres  # noqa: E402
from mercury_tpu_torch.models.convert import params_from_flax  # noqa: E402

N = 64
TOL = dict(rtol=1e-5, atol=1e-6)


def _np_tree(tree):
    return jax.tree_util.tree_map(lambda a: np.array(a), tree)


@pytest.fixture(scope="module")
def setup():
    jm = jres.ResNet(stage_sizes=[1, 1], block_cls=jres.BasicBlock, num_classes=10,
                     num_filters=8, compute_dtype=jnp.float32)
    variables = _np_tree(jm.init(jax.random.key(0), jnp.zeros((1, 32, 32, 3)), train=False))
    rng = np.random.default_rng(0)
    stats = jax.tree_util.tree_map(
        lambda a: (rng.uniform(0.5, 2.0, a.shape) if a.ndim and a.min() == 1.0
                   else rng.normal(0.0, 0.3, a.shape)).astype(np.float32),
        variables["batch_stats"])
    variables["batch_stats"] = stats
    tm = tres.ResNet([1, 1], tres.BasicBlock, num_classes=10, num_filters=8)
    tm.load_state_dict(params_from_flax(variables["params"], stats))
    trainer = Trainer(TrainConfig(dataset="synthetic", world_size=1, compute_dtype="float32",
                                  num_epochs=1, steps_per_epoch=1, seed=0),
                      device="cpu", model=tm)
    ds = trainer.dataset

    def jax_predict(x):
        return np.asarray(jm.apply(variables, jnormalize(jnp.asarray(x), ds.mean, ds.std),
                                   train=False))

    return trainer, jax_predict, ds.x_test[:N].numpy()


@pytest.mark.parametrize("form", ["uint8", "float", "single", "tensor"])
def test_predict_matches_the_jax_forward(setup, form):
    trainer, jax_predict, x = setup
    if form == "float":
        x = x.astype(np.float32) / 255
    elif form == "single":
        x = x[5]
    got = trainer.predict(torch.as_tensor(x) if form == "tensor" else x)
    want = jax_predict(x if x.ndim == 4 else x[None])
    assert got.dtype == torch.float32 and got.device.type == "cpu"
    assert tuple(got.shape) == want.shape == ((1, 10) if form == "single" else (N, 10))
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_uint8_and_scaled_float_agree(setup):
    """uint8 is scaled by 1/255, float is not: predict(x) equals
    predict(x.float() / 255), and predict(x.float()) does not."""
    trainer, _, x = setup
    xt = torch.as_tensor(x)
    assert torch.equal(trainer.predict(xt), trainer.predict(xt.float() / 255))
    assert not torch.allclose(trainer.predict(xt), trainer.predict(xt.float()))


def test_predict_accuracy_equals_evaluate(setup):
    """Over the whole test split (1000 images: three full batches of 256
    and a wrapped one) the argmax accuracy is evaluate's, exactly."""
    trainer, _, _ = setup
    ds = trainer.dataset
    pred = trainer.predict(ds.x_test).argmax(-1)
    acc = int((pred == ds.y_test.long()).sum()) / ds.x_test.shape[0]
    assert acc == trainer.evaluate(include_train=False)["test/eval_acc"]


@pytest.mark.parametrize("train", [False, True])
def test_per_class_accuracy_counts_predictions(setup, train):
    """Against a numpy count over predict's argmax; a class absent from
    the split (relabelled away) is NaN."""
    trainer, _, _ = setup
    ds = trainer.dataset
    x, y = (ds.x_train, ds.y_train) if train else (ds.x_test, ds.y_test)
    y = torch.where(y == 3, 4, y)
    split = dict(x_train=x, y_train=y) if train else dict(x_test=x, y_test=y)
    trainer.dataset = dataclasses.replace(ds, **split)
    try:
        got = trainer.per_class_accuracy(train=train)
    finally:
        trainer.dataset = ds
    pred = trainer.predict(x).argmax(-1).numpy()
    labels = y.numpy()
    assert got.dtype == torch.float64 and tuple(got.shape) == (10,)
    for c in range(10):
        members = labels == c
        if c == 3:
            assert not members.any() and np.isnan(got[c].item())
        else:
            assert got[c].item() == np.mean(pred[members] == c), c
