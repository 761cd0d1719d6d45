"""The port's image datasets against the JAX package's loader (the same
bytes, labels and ``info`` from the same seed), and a Trainer of the new
image models on the CPU. The sequence datasets are held so in
``test_torch_port_sequence_data.py``."""

import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from mercury_tpu.data import cifar as jcifar  # noqa: E402
from mercury_tpu_torch import TrainConfig, Trainer  # noqa: E402
from mercury_tpu_torch.data import cifar as tcifar  # noqa: E402

IMAGE_DATASETS = ("synthetic_tail", "synthetic_hard", "digits", "digits_imb")
MODELS = ("smallcnn", "vgg11", "vgg13", "vgg16", "vgg19", "mobilenetv2", "mobilenet_v2")
SMALL = dict(synthetic_train_size=300, synthetic_test_size=60)


@pytest.mark.parametrize("seed", [0, 7])
@pytest.mark.parametrize("name", IMAGE_DATASETS)
def test_dataset_identical(name, seed):
    want = jcifar.load_dataset(name, seed=seed, **SMALL)
    got = tcifar.load_dataset(name, seed=seed, **SMALL)
    for split_want, split_got in zip(want[:2], got[:2]):
        for a, b in zip(split_want, split_got):
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_array_equal(a, b)
    assert got[0][0].dtype == np.uint8 and got[0][0].shape[1:] == (32, 32, 3)
    assert got[0][1].dtype == np.int32
    assert set(got[2]) == set(want[2])
    for k, v in want[2].items():
        if isinstance(v, np.ndarray):
            assert got[2][k].dtype == v.dtype
            np.testing.assert_array_equal(got[2][k], v)
        else:
            assert got[2][k] == v, k
    assert got[2]["num_classes"] == (20 if name.startswith("synthetic") else 10)


@pytest.mark.parametrize("seed", [0, 7])
def test_digits_imb_keeps_a_tenth_of_classes_5_to_9(seed):
    (_, y_bal), test_bal, _ = tcifar.load_dataset("digits", seed=seed)
    (_, y_imb), test_imb, _ = tcifar.load_dataset("digits_imb", seed=seed)
    full, kept = np.bincount(y_bal, minlength=10), np.bincount(y_imb, minlength=10)
    np.testing.assert_array_equal(kept[:5], full[:5])
    np.testing.assert_array_equal(
        kept[5:], [max(int(round(0.1 * n)), 8) for n in full[5:]])
    # The test split stays balanced, and the same.
    np.testing.assert_array_equal(test_bal[1], test_imb[1])
    assert len(y_bal) + len(test_bal[1]) == 1797


@pytest.mark.parametrize("difficulty,label_noise", [
    ("uniform", 0.0), ("uniform", 0.3), ("heavy_tail", 0.0), ("heavy_tail", 0.3)])
def test_synthetic_difficulty_and_label_noise_identical(difficulty, label_noise):
    args = (5, 120, 40, 16, 3)
    want = jcifar.synthetic_cifar(*args, difficulty=difficulty, label_noise=label_noise)
    got = tcifar.synthetic_cifar(*args, difficulty=difficulty, label_noise=label_noise)
    for a, b in zip(want[0] + want[1], got[0] + got[1]):
        np.testing.assert_array_equal(a, b)
    clean = tcifar.synthetic_cifar(*args, difficulty=difficulty)
    flipped = (got[0][1] != clean[0][1]).mean()
    assert (flipped > 0.1) == (label_noise > 0)
    np.testing.assert_array_equal(got[1][1], clean[1][1])  # test labels stay clean


def test_unknown_difficulty_raises_as_jax():
    for module in (jcifar, tcifar):
        with pytest.raises(ValueError, match="unknown difficulty 'spiky'"):
            module.synthetic_cifar(2, 4, 4, difficulty="spiky")


@pytest.mark.parametrize("name", ["digits", "digits_imb"])
def test_digits_without_sklearn_raise_import_error(name, monkeypatch):
    monkeypatch.setitem(sys.modules, "sklearn.datasets", None)
    with pytest.raises(ImportError, match=name):
        tcifar.load_dataset(name)


@pytest.mark.parametrize("dataset", IMAGE_DATASETS)
@pytest.mark.parametrize("model", MODELS)
def test_config_accepts_the_image_family(model, dataset):
    cfg = TrainConfig(model=model, dataset=dataset, world_size=1)
    assert (cfg.model, cfg.dataset) == (model, dataset)


def test_smallcnn_trainer_on_digits_imb(tmp_path):
    """The model-agnostic parts of the Trainer with SmallCNN on the CPU:
    fit with telemetry, predict, per_class_accuracy, evaluate, a save and
    restore, and an elastic restore at the same world size."""
    cfg = TrainConfig(model="smallcnn", dataset="digits_imb", world_size=1, batch_size=8,
                      presample_batches=4, compute_dtype="float32", num_epochs=1,
                      steps_per_epoch=4, eval_every=0, log_every=2, seed=0,
                      checkpoint_dir=str(tmp_path / "ckpt"))
    trainer = Trainer(cfg, device="cpu")
    assert type(trainer.state.model).__name__ == "SmallCNN"
    assert trainer.dataset.num_classes == 10 and not trainer.dataset.synthetic
    result = trainer.fit()
    assert trainer.state.step == 4
    assert np.isfinite(result["train/loss"]) and 0.0 <= result["test/eval_acc"] <= 1.0
    assert 0 < float(trainer.train_step()["sampler/ess"]) <= 1
    logits = trainer.predict(trainer.dataset.x_test[:5].numpy())
    assert logits.shape == (5, 10) and logits.dtype == torch.float32
    per_class = trainer.per_class_accuracy()
    assert per_class.shape == (10,) and bool(torch.isfinite(per_class).all())
    weights = {k: v.clone() for k, v in trainer.state.model.state_dict().items()}
    path = trainer.save()
    trainer.train_step()
    assert trainer.restore() == 5 and path.endswith("ckpt_5.pt")
    for k, v in trainer.state.model.state_dict().items():
        assert torch.equal(v, weights[k]), k
    trainer.train_step()
    assert trainer.restore_elastic(step=5) == 5
    for k, v in trainer.state.model.state_dict().items():
        assert torch.equal(v, weights[k]), k
    ev = trainer.evaluate()
    assert np.isfinite(ev["test/eval_loss"])
    trainer.close()
