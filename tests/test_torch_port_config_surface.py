"""The functions and modules behind the port's config surface against the JAX
package's, on the CPU, from the same numpy inputs and the JAX package's own
random draws: the IID transforms and cutout, the smoothed loss and the
gradient-norm score, ResNet-101/152, and the CIFAR-100 data.

Transforms run the JAX functions eagerly (no ``jax.jit``). The port's draws
come from the JAX key splits: ``k_crop, k_flip, k_aff = split(k_aug, 3)``,
``oy = randint(k_crop, ...)``, ``ox = randint(fold_in(k_crop, 1), ...)``,
``k1, k2 = split(k_aff)`` for the angles and scales, and the cutout
centres likewise from ``k_cut``. Tolerances: resize, affine and the IID
transforms atol 1e-5 (bilinear weights and the rotation in float32, summed
in another order); crops, flips and cutout bit-equal; loss and score rtol
1e-6, atol 1e-7; the deep ResNets' logits rtol 1e-4, atol 1e-5 in eval
mode and in float64 train mode, and float32 train mode held to the float64
logits (see ``test_deep_resnets_train_float32``).

The data tests that fall back to the synthetic set search no shared
default directory: ``_SEARCH_DIRS`` is emptied in both packages for them.
"""

import dataclasses
import io
import pickle
import tarfile

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from mercury_tpu.data import cifar as jcifar  # noqa: E402
from mercury_tpu.data import pipeline as jpipe  # noqa: E402
from mercury_tpu.data import transforms as jtr  # noqa: E402
from mercury_tpu.models import resnet as jres  # noqa: E402
from mercury_tpu.sampling import importance as jimp  # noqa: E402
from mercury_tpu_torch import TrainConfig, Trainer  # noqa: E402
from mercury_tpu_torch.data import cifar as tcifar  # noqa: E402
from mercury_tpu_torch.data import pipeline as tpipe  # noqa: E402
from mercury_tpu_torch.data import transforms as ttr  # noqa: E402
from mercury_tpu_torch.models import create_model  # noqa: E402
from mercury_tpu_torch.models import resnet as tres  # noqa: E402
from mercury_tpu_torch.models.convert import params_from_flax  # noqa: E402
from mercury_tpu_torch.sampling import importance as timp  # noqa: E402

import chip_smoke  # noqa: E402

N = 8


def _images(n=N, seed=0):
    """Normalized float32 NHWC images from uint8 ones, with a constant
    image and one whose only non-zero pixels are a one-pixel stripe on the
    left and top edges (the resize's edge handling)."""
    raw = np.random.default_rng(seed).integers(0, 256, (n, 32, 32, 3), dtype=np.uint8)
    raw[0] = 173
    raw[1] = 0
    raw[1, :, 0, :] = 255
    raw[1, 0, :, :] = 200
    x = np.asarray(jpipe.normalize_images(jnp.asarray(raw), jcifar.CIFAR10_MEAN,
                                          jcifar.CIFAR10_STD))
    assert np.array_equal(x, tpipe.normalize_images(torch.tensor(raw), tcifar.CIFAR10_MEAN,
                                                    tcifar.CIFAR10_STD).numpy())
    return x


def _crop_draws(key, n, hi):
    """The offsets ``random_crop_to_batch`` draws from ``key``, ``[n, 2]``."""
    oy = jax.random.randint(key, (n,), 0, hi + 1)
    ox = jax.random.randint(jax.random.fold_in(key, 1), (n,), 0, hi + 1)
    return torch.tensor(np.stack([np.asarray(oy), np.asarray(ox)], 1))


def _iid_draws(key, n):
    """Crop offsets, flips, angles (radians) and scales as
    ``augment_batch_iid`` draws them from ``key``."""
    k_crop, k_flip, k_aff = jax.random.split(key, 3)
    k1, k2 = jax.random.split(k_aff)
    theta = jnp.deg2rad(jax.random.uniform(k1, (n,), minval=-10.0, maxval=10.0))
    scale = jax.random.uniform(k2, (n,), minval=0.9, maxval=1.1)
    return (_crop_draws(k_crop, n, 3),
            torch.tensor(np.asarray(jax.random.bernoulli(k_flip, shape=(n,)))),
            torch.tensor(np.asarray(theta)), torch.tensor(np.asarray(scale)))


# ------------------------------------------------------------------ transforms
@pytest.mark.parametrize("size", [35, 33])
def test_resize_matches_jax(size):
    x = _images()
    want = np.asarray(jtr.resize_batch(jnp.asarray(x), size))
    got = ttr.resize_batch(torch.tensor(x), size).numpy()
    assert got.shape == want.shape == (N, size, size, 3)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    # The constant image stays constant, the stripe stays on the edge.
    np.testing.assert_allclose(got[0], np.broadcast_to(x[0, 0, 0], got[0].shape),
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(got[1, 2:, 0], np.broadcast_to(x[1, 1, 0], got[1, 2:, 0].shape),
                               rtol=0, atol=1e-5)


def test_crop_flip_and_cutout_bit_equal():
    x = _images()
    key = jax.random.key(4)
    resized = jtr.resize_batch(jnp.asarray(x), 35)
    want = np.asarray(jpipe.random_crop_to_batch(key, resized, 32))
    got = tpipe.random_crop_to_batch(torch.tensor(np.asarray(resized)),
                                     *_crop_draws(key, N, 3).T, 32).numpy()
    np.testing.assert_array_equal(got, want)
    flip = jax.random.bernoulli(key, shape=(N,))
    np.testing.assert_array_equal(
        tpipe.hflip_batch(torch.tensor(x), torch.tensor(np.asarray(flip))).numpy(),
        np.asarray(jpipe.hflip_batch(key, jnp.asarray(x))))
    want = np.asarray(jpipe.cutout_batch(key, jnp.asarray(x), 16))
    got = ttr.cutout_batch(torch.tensor(x), _crop_draws(key, N, 31), 16).numpy()
    np.testing.assert_array_equal(got, want)
    assert (got == 0).any(axis=-1).any() and not np.array_equal(got, x)


def test_noniid_augment_with_cutout_bit_equal():
    """``augment_batch`` with cutout centres: the JAX pipeline's crop, flip
    and cutout from ``k_crop, k_flip, k_cut = split(key, 3)``."""
    x = _images()
    key = jax.random.key(6)
    k_crop, k_flip, k_cut = jax.random.split(key, 3)
    want = np.asarray(jpipe.augment_batch(key, jnp.asarray(x), use_cutout=True))
    crop = torch.tensor(np.asarray(jax.random.randint(k_crop, (N, 2), 0, 9)))
    flip = torch.tensor(np.asarray(jax.random.bernoulli(k_flip, shape=(N,))))
    got = tpipe.augment_batch(torch.tensor(x), crop, flip, 4,
                              cut=_crop_draws(k_cut, N, 31)).numpy()
    np.testing.assert_array_equal(got, want)


def test_affine_matches_jax_and_identity():
    x = _images()
    key = jax.random.key(7)
    # affine_batch splits its own key into the angle and scale draws.
    k1, k2 = jax.random.split(key)
    theta = torch.tensor(np.asarray(jnp.deg2rad(
        jax.random.uniform(k1, (N,), minval=-10.0, maxval=10.0))))
    scale = torch.tensor(np.asarray(jax.random.uniform(k2, (N,), minval=0.9, maxval=1.1)))
    want = np.asarray(jtr.affine_batch(key, jnp.asarray(x), 10.0, 0.9, 1.1))
    got = ttr.affine_batch(torch.tensor(x), theta, scale).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    same = ttr.affine_batch(torch.tensor(x), torch.zeros(N), torch.ones(N)).numpy()
    np.testing.assert_allclose(same, x, rtol=0, atol=1e-5)


def test_iid_train_and_eval_transforms_match_jax():
    x = _images()
    key = jax.random.key(8)
    want = np.asarray(jtr.augment_batch_iid(key, jnp.asarray(x)))
    got = ttr.augment_batch_iid(torch.tensor(x), *_iid_draws(key, N)).numpy()
    assert got.shape == (N, 32, 32, 3)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    want = np.asarray(jtr.eval_transform_iid(key, jnp.asarray(x)))
    got = ttr.eval_transform_iid(torch.tensor(x), _crop_draws(key, N, 1)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


# ------------------------------------------------------------------ scores and loss
@pytest.mark.parametrize("classes", [10, 100])
@pytest.mark.parametrize("smoothing", [0.0, 0.1])
@pytest.mark.parametrize("fn", ["per_sample_loss", "per_sample_grad_norm_bound"])
def test_loss_and_score_match_jax(fn, smoothing, classes):
    rng = np.random.default_rng(classes)
    z = (rng.normal(0, 3, (64, classes))).astype(np.float32)
    y = rng.integers(0, classes, 64).astype(np.int32)
    want = np.asarray(getattr(jimp, fn)(jnp.asarray(z), jnp.asarray(y), smoothing))
    got = getattr(timp, fn)(torch.tensor(z), torch.tensor(y), smoothing).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


# ------------------------------------------------------------------ models
def _deep_pair(depth, x):
    """The JAX ResNet-``depth`` (width 4, 100 classes), its variables, and
    the port's model carrying them. The variables do not depend on the
    image size: they are initialised on two 8×8 crops of ``x``."""
    jm = getattr(jres, f"ResNet{depth}")(num_classes=100, num_filters=4,
                                         compute_dtype=jnp.float32)
    variables = jm.init(jax.random.key(depth), jnp.asarray(x[:2, :8, :8]), train=False)
    tm = getattr(tres, f"ResNet{depth}")(num_classes=100, num_filters=4)
    tm.load_state_dict(params_from_flax(variables["params"], variables["batch_stats"]))
    return jm, variables, tm


def _jax_train_logits64(depth, variables, x):
    """The JAX model's train-mode logits in float64 on the float32 weights."""
    with jax.enable_x64(True):
        jm64 = getattr(jres, f"ResNet{depth}")(num_classes=100, num_filters=4,
                                               compute_dtype=jnp.float64,
                                               param_dtype=jnp.float64)
        v64 = jax.tree_util.tree_map(lambda a: jnp.asarray(np.asarray(a, np.float64)),
                                     variables)
        want, _ = jm64.apply(v64, jnp.asarray(x, jnp.float64), train=True,
                             mutable=["batch_stats"])
        return np.asarray(want)


@pytest.mark.parametrize("depth", [101, 152])
def test_deep_resnets_match_flax(depth):
    """ResNet-101/152 at width 4 with 100 classes, two 8×8 images: the JAX
    weights carried across by ``params_from_flax``; logits in eval mode in
    float32, and in train mode (batch statistics) with both models in
    float64 on the same float32 weights. Float32 train mode is held in
    ``test_deep_resnets_train_float32``."""
    x = np.random.default_rng(depth).normal(0, 1, (2, 8, 8, 3)).astype(np.float32)
    jm, variables, tm = _deep_pair(depth, x)
    nchw = torch.tensor(x).permute(0, 3, 1, 2).contiguous()
    with torch.no_grad():
        got = tm(nchw, train=False).numpy()
    np.testing.assert_allclose(got, np.asarray(jm.apply(variables, jnp.asarray(x), train=False)),
                               rtol=1e-4, atol=1e-5)
    with torch.no_grad():
        got = tm.double()(nchw.double(), train=True, keep_stats=False).numpy()
    np.testing.assert_allclose(got, _jax_train_logits64(depth, variables, x),
                               rtol=1e-4, atol=1e-5)


def train_float32_readings(depth):
    """The largest absolute differences of ResNet-``depth``'s train-mode
    logits (width 4, 100 classes, eight 32×32 images) from the JAX float64
    ones: the port's float64 and float32 forwards, JAX's float32 forward,
    and the port's float32 forward with Flax's E[x²] − E[x]² variance (its
    synced batch norm, at one rank); and the port's float32 from JAX's.
    ``python -c "from tests.test_torch_port_config_surface import
    train_float32_readings as r; print(r(101), r(152))"`` prints them."""
    x = np.random.default_rng(depth).normal(0, 1, (8, 32, 32, 3)).astype(np.float32)
    jm, variables, tm = _deep_pair(depth, x)
    want64 = _jax_train_logits64(depth, variables, x)
    jax32, _ = jm.apply(variables, jnp.asarray(x), train=True, mutable=["batch_stats"])
    jax32 = np.asarray(jax32)
    nchw = torch.tensor(x).permute(0, 3, 1, 2).contiguous()
    norms = [m for m in tm.modules() if isinstance(m, tres.BatchNorm)]
    with torch.no_grad():
        port32 = tm(nchw, train=True, keep_stats=False).numpy()
        for m in norms:
            m.sync = True
        flax_var32 = tm(nchw, train=True, keep_stats=False).numpy()
        for m in norms:
            m.sync = False
        port64 = tm.double()(nchw.double(), train=True, keep_stats=False).numpy()

    def gap(a, b):
        return float(np.abs(a - b).max())

    return {"port64": gap(port64, want64), "port32": gap(port32, want64),
            "jax32": gap(jax32, want64), "port32_flax_variance": gap(flax_var32, want64),
            "port32_vs_jax32": gap(port32, jax32)}


@pytest.mark.parametrize("depth", [101, 152])
def test_deep_resnets_train_float32(depth):
    """The float32 train-mode path that the card runs, held to the JAX
    float64 logits (``train_float32_readings``). The port's float64 logits
    equal them to 1e-5 (read: 0.0), its float32 ones lie within 5e-4 (read:
    9.4e-5 at depth 101, 2.2e-4 at 152) and no further than JAX's own
    float32 ones (read: 7.9e-4, 3.1e-3), and the two float32 results differ
    by at most 5e-3 (read: 7.7e-4, 3.1e-3). So float32 rtol 1e-4 between
    the packages cannot hold, and it is XLA:CPU's float32 forward that
    strays from the float64 answer. The batch norm's variance formula is
    not the cause: with Flax's E[x²] − E[x]² the port's float32 logits also
    stay within 5e-4 (read: 1.2e-4, 2.4e-4)."""
    r = train_float32_readings(depth)
    assert r["port64"] <= 1e-5
    assert r["port32"] <= 5e-4 and r["port32_flax_variance"] <= 5e-4
    assert r["port32"] <= r["jax32"]
    assert r["port32_vs_jax32"] <= 5e-3


@pytest.mark.parametrize("name,classes", sorted(k for k in chip_smoke.PARAMETERS
                                                 if k[0].startswith("resnet")))
def test_full_width_parameter_count_equals_jax(name, classes):
    """Counted from the JAX init's shapes (``jax.eval_shape``: no forward
    runs) and from the port's model on the meta device; the smoke holds
    the card's model to the same number."""
    depth = name[len("resnet"):]
    jm = getattr(jres, f"ResNet{depth}")(num_classes=classes)
    shapes = jax.eval_shape(lambda: jm.init(jax.random.key(0), jnp.zeros((1, 32, 32, 3)),
                                            train=False))
    want = sum(int(np.prod(a.shape)) for a in jax.tree_util.tree_leaves(shapes["params"]))
    with torch.device("meta"):
        model = getattr(tres, f"ResNet{depth}")(num_classes=classes)
    assert sum(p.numel() for p in model.parameters()) == want
    assert chip_smoke.PARAMETERS[name, classes] == want
    with pytest.raises(ValueError, match="resnet200"):
        create_model("resnet200", classes)


# ------------------------------------------------------------------ data
@pytest.fixture
def no_default_dirs(monkeypatch):
    """Neither package searches a shared default directory or
    ``$MERCURY_TPU_DATA``."""
    monkeypatch.delenv("MERCURY_TPU_DATA", raising=False)
    for module in (jcifar, tcifar):
        monkeypatch.setattr(module, "_SEARCH_DIRS", ())


def _cifar100_tarball(path, extra):
    """A ``cifar-100-python.tar.gz`` at ``path`` holding the pickled
    ``train`` and ``test`` splits under ``cifar-100-python/``, and the
    ``extra`` members (name → bytes); returns the splits."""
    rng = np.random.default_rng(3)
    members, splits = dict(extra), {}
    for name, n in (("train", 10), ("test", 4)):
        x = rng.integers(0, 256, (n, 32, 32, 3), dtype=np.uint8)
        y = rng.integers(0, 100, n)
        splits[name] = (x, y.astype(np.int32))
        members[f"cifar-100-python/{name}"] = pickle.dumps(
            {"data": x.transpose(0, 3, 1, 2).reshape(n, -1), "fine_labels": y.tolist()})
    with tarfile.open(path, "w:gz") as tf:
        for name, data in members.items():
            info = tarfile.TarInfo(name)
            info.size = len(data)
            tf.addfile(info, io.BytesIO(data))
    return splits


def test_cifar100_without_files_is_jax_synthetic(no_default_dirs):
    kw = dict(synthetic_train_size=300, synthetic_test_size=50, seed=102)
    with pytest.warns(UserWarning, match="cifar100"):
        jtrain, jtest, jinfo = jcifar.load_dataset("cifar100", **kw)
    with pytest.warns(UserWarning, match="cifar100"):
        ttrain, ttest, tinfo = tcifar.load_dataset("cifar100", **kw)
    for a, b in zip((*jtrain, *jtest), (*ttrain, *ttest)):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype
    assert tinfo["num_classes"] == jinfo["num_classes"] == 100
    assert tinfo["synthetic"] and jinfo["synthetic"]
    for k in ("mean", "std"):
        np.testing.assert_array_equal(tinfo[k], jinfo[k])
        assert tinfo[k].dtype == np.float32


def test_cifar100_npz_in_data_dir_loads_the_same(tmp_path):
    rng = np.random.default_rng(1)
    arrays = dict(x_train=rng.integers(0, 256, (20, 32, 32, 3), dtype=np.uint8),
                  y_train=rng.integers(0, 100, 20).astype(np.int64),
                  x_test=rng.integers(0, 256, (6, 32, 32, 3), dtype=np.uint8),
                  y_test=rng.integers(0, 100, 6).astype(np.int64))
    np.savez(tmp_path / "cifar100.npz", **arrays)
    jtrain, jtest, jinfo = jcifar.load_dataset("cifar100", data_dir=str(tmp_path))
    ttrain, ttest, tinfo = tcifar.load_dataset("cifar100", data_dir=str(tmp_path))
    for a, b in zip((*jtrain, *jtest), (*ttrain, *ttest)):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype
    np.testing.assert_array_equal(ttrain[0], arrays["x_train"])
    assert ttrain[1].dtype == np.int32
    assert not tinfo["synthetic"] and tinfo["num_classes"] == 100
    np.testing.assert_array_equal(tinfo["mean"], jinfo["mean"])


def test_search_dirs_equal_jax():
    assert tcifar._SEARCH_DIRS == jcifar._SEARCH_DIRS


@pytest.mark.parametrize("named", ["data_dir", "env"])
def test_archive_unpacks_under_a_named_directory(tmp_path, monkeypatch, no_default_dirs,
                                                 named):
    """A tarball under ``data_dir`` or ``$MERCURY_TPU_DATA`` is unpacked
    and loaded."""
    splits = _cifar100_tarball(tmp_path / "cifar-100-python.tar.gz", {})
    if named == "env":
        monkeypatch.setenv("MERCURY_TPU_DATA", str(tmp_path))
    kw = {"data_dir": str(tmp_path)} if named == "data_dir" else {}
    train, test, info = tcifar.load_dataset("cifar100", **kw)
    assert not info["synthetic"] and info["num_classes"] == 100
    for got, want in ((train, splits["train"]), (test, splits["test"])):
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])


def test_archive_in_a_default_directory_stays_packed(tmp_path, monkeypatch, no_default_dirs):
    """The same tarball in a default search directory (a shared one such
    as ``/tmp/mercury_tpu_data``) is not unpacked: nothing is written there
    and the loader falls back to the synthetic set."""
    _cifar100_tarball(tmp_path / "cifar-100-python.tar.gz", {})
    monkeypatch.setattr(tcifar, "_SEARCH_DIRS", (str(tmp_path),))
    with pytest.warns(UserWarning, match="cifar100"):
        _, _, info = tcifar.load_dataset("cifar100")
    assert info["synthetic"]
    assert [p.name for p in tmp_path.iterdir()] == ["cifar-100-python.tar.gz"]


def test_archive_member_outside_its_directory_is_refused(tmp_path, no_default_dirs):
    """Unpacking uses tarfile's ``"data"`` filter: a member that would land
    outside the data directory raises and is not written."""
    root = tmp_path / "root"
    root.mkdir()
    _cifar100_tarball(root / "cifar-100-python.tar.gz", {"../escaped": b"x"})
    with pytest.raises(tarfile.OutsideDestinationError):
        tcifar.load_dataset("cifar100", data_dir=str(root))
    assert not (tmp_path / "escaped").exists()


def test_trainer_refuses_a_num_classes_the_dataset_lacks(no_default_dirs):
    with pytest.raises(ValueError, match=r"config.num_classes=10 but dataset 'cifar100' "
                                         r"has 100 classes"):
        Trainer(TrainConfig(dataset="cifar100", num_classes=10, world_size=1), device="cpu")


def test_trainer_builds_cifar100_from_data_dir(tmp_path):
    """``data_dir`` reaches the loader, and ``num_classes`` equal to the
    dataset's is accepted."""
    rng = np.random.default_rng(2)
    np.savez(tmp_path / "cifar100.npz",
             x_train=rng.integers(0, 256, (64, 32, 32, 3), dtype=np.uint8),
             y_train=rng.integers(0, 100, 64), x_test=rng.integers(0, 256, (8, 32, 32, 3),
                                                                   dtype=np.uint8),
             y_test=rng.integers(0, 100, 8))
    model = tres.ResNet([1, 1], tres.BasicBlock, num_classes=100, num_filters=4)
    tr = Trainer(TrainConfig(dataset="cifar100", num_classes=100, data_dir=str(tmp_path),
                             world_size=1, batch_size=4, presample_batches=2,
                             compute_dtype="float32"), device="cpu", model=model)
    assert tr.dataset.num_classes == 100 and not tr.dataset.synthetic
    assert tr.dataset.n_train == 64
    np.testing.assert_array_equal(tr.dataset.mean, tcifar.CIFAR100_MEAN)


def test_new_fields_default_as_in_jax():
    from mercury_tpu.config import TrainConfig as JConfig

    jfields = {f.name: f.default for f in dataclasses.fields(JConfig)}
    tfields = {f.name: f.default for f in dataclasses.fields(TrainConfig)}
    new = ("step_budget", "label_smoothing", "importance_score", "num_classes", "data_dir",
           "cutout", "use_pallas")
    assert {k: tfields[k] for k in new} == {k: jfields[k] for k in new}
    assert tfields["step_budget"] == 1e7 and tfields["use_pallas"] is None
