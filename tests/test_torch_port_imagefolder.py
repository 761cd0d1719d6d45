"""``dataset="imagefolder"`` in the port: ``data/imagefolder.py`` and the
streamed ``ImageFolderSource`` against the JAX package's, on a tiny folder
of PNGs written with PIL into a temporary directory (images of several
sizes, an RGBA and a grayscale one, a file that is not an image). Arrays,
labels, class names and the normalization statistics must be bit-equal;
a Trainer trains on the folder, its pixels streamed from the host.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
Image = pytest.importorskip("PIL.Image")

from mercury_tpu.data import imagefolder as jif  # noqa: E402
from mercury_tpu.data.stream import ImageFolderSource as JImageFolderSource  # noqa: E402
from mercury_tpu_torch import TrainConfig, Trainer  # noqa: E402
from mercury_tpu_torch.data import imagefolder as tif  # noqa: E402
from mercury_tpu_torch.data.stream import ImageFolderSource, PrefetchPipeline  # noqa: E402

from test_torch_port_ranks import tiny_resnet  # noqa: E402

CLASSES = ("cat", "ant", "bee")


@pytest.fixture(autouse=True, scope="module")
def one_intra_op_thread():
    """The tiny steps here run one intra-op thread: with the test workers
    sharing the host's cores, torch's thread pool made each step of this
    size 30-50× slower (its barriers wait on descheduled threads)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _write(root, per_class=6, seed=0):
    rng = np.random.default_rng(seed)
    for c, name in enumerate(CLASSES):
        d = root / name
        d.mkdir(parents=True)
        for i in range(per_class):
            h, w = int(rng.integers(9, 40)), int(rng.integers(9, 40))
            pixels = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
            img = Image.fromarray(pixels)
            if i == 1:
                img = img.convert("L")
            elif i == 2:
                img = img.convert("RGBA")
            img.save(d / f"img_{c}_{i:02d}.png")
        (d / "notes.txt").write_text("not an image")
    return root


@pytest.fixture(scope="module")
def folder(tmp_path_factory):
    return _write(tmp_path_factory.mktemp("imagefolder"))


@pytest.mark.parametrize("image_size", [12, 32])
def test_loader_is_bit_equal_to_the_jax_package(folder, image_size):
    got = tif.load_imagefolder_dataset(str(folder), image_size=image_size, seed=3)
    want = jif.load_imagefolder_dataset(str(folder), image_size=image_size, seed=3)
    for split in (0, 1):
        for a, b in zip(got[split], want[split]):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    assert got[0][0].shape[1:] == (image_size, image_size, 3)
    assert got[2]["classes"] == want[2]["classes"] == sorted(CLASSES)
    assert got[2]["num_classes"] == 3 and not got[2]["synthetic"]
    for k in ("mean", "std"):
        np.testing.assert_array_equal(got[2][k], want[2][k])
    paths, labels, classes = tif.list_image_folder(str(folder))
    jpaths, jlabels, _ = jif.list_image_folder(str(folder))
    assert paths == jpaths and len(paths) == 18 and classes == sorted(CLASSES)
    np.testing.assert_array_equal(labels, jlabels)


def test_train_test_layout_and_mismatch(tmp_path):
    _write(tmp_path / "train")
    _write(tmp_path / "test", per_class=2, seed=1)
    (x, y), (xt, yt), info = tif.load_imagefolder_dataset(str(tmp_path), image_size=8)
    want = jif.load_imagefolder_dataset(str(tmp_path), image_size=8)
    np.testing.assert_array_equal(x, want[0][0])
    np.testing.assert_array_equal(xt, want[1][0])
    assert (len(x), len(xt)) == (18, 6)
    (tmp_path / "test" / "wasp").mkdir()
    Image.fromarray(np.zeros((4, 4, 3), np.uint8)).save(tmp_path / "test" / "wasp" / "a.png")
    with pytest.raises(ValueError, match="class mismatch"):
        tif.load_imagefolder_dataset(str(tmp_path), image_size=8)
    with pytest.raises(FileNotFoundError):
        tif.list_image_folder(str(tmp_path / "test" / "wasp"))


@pytest.mark.parametrize("workers", [0, 2])
def test_streamed_source_gathers_as_the_jax_one(folder, workers):
    """Only the gathered rows are decoded; row i is row i of the eager
    array, and two decode threads give what none does."""
    src = ImageFolderSource(str(folder), image_size=16, decode_workers=workers)
    jsrc = JImageFolderSource(str(folder), image_size=16)
    gidx = np.array([17, 0, 5, 5, 11])
    got = np.empty((5, 16, 16, 3), np.uint8)
    want = np.empty_like(got)
    src.gather(gidx, got)
    jsrc.gather(gidx, want)
    src.close()
    jsrc.close()
    np.testing.assert_array_equal(got, want)
    eager, labels, _ = tif.load_image_folder(str(folder), 16)
    np.testing.assert_array_equal(got, eager[gidx])
    np.testing.assert_array_equal(src.labels, labels)
    assert (len(src), src.row_shape, src.dtype) == (18, (16, 16, 3), np.uint8)
    with pytest.raises(ValueError, match="image_size"):
        ImageFolderSource(str(folder), image_size=None)


def test_streamed_source_through_the_pipeline(folder):
    src = ImageFolderSource(str(folder), image_size=8, decode_workers=2)
    pipe = PrefetchPipeline(src, rows=3, device="cpu", depth=2)
    try:
        pipe.push(np.array([1, 2, 3]))
        pipe.push(torch.tensor([4, 5, 6]))
        eager = tif.load_image_folder(str(folder), 8)[0]
        np.testing.assert_array_equal(pipe.pop().numpy(), eager[[1, 2, 3]])
        np.testing.assert_array_equal(pipe.pop().numpy(), eager[[4, 5, 6]])
    finally:
        pipe.close()


@pytest.mark.parametrize("placement", ["host_stream", "replicated"])
def test_trainer_on_an_image_folder(folder, placement):
    """The JAX Trainer's build: decoded once, resized to image_size, the
    statistics the train split's; three steps train."""
    cfg = TrainConfig(dataset="imagefolder", data_dir=str(folder), image_size=16,
                      world_size=1, batch_size=4, presample_batches=2,
                      compute_dtype="float32", num_epochs=1, steps_per_epoch=3,
                      eval_every=0, log_every=0, seed=0, data_placement=placement)
    tr = Trainer(cfg, device="cpu", model=tiny_resnet(0))
    try:
        ds = tr.dataset
        assert ds.num_classes == 3 and not ds.synthetic and ds.n_train == 17
        assert isinstance(ds.x_train, np.ndarray) == (placement == "host_stream")
        want = jif.load_imagefolder_dataset(str(folder), image_size=16, seed=0)
        np.testing.assert_array_equal(np.asarray(ds.x_train), want[0][0])
        np.testing.assert_array_equal(ds.mean, want[2]["mean"])
        out = tr.fit(steps=3)
        assert np.isfinite(out["train/loss"]) and "test/eval_acc" in out
    finally:
        tr.close()


def test_imagefolder_needs_data_dir():
    with pytest.raises(ValueError, match="data_dir"):
        TrainConfig(dataset="imagefolder", world_size=1)
