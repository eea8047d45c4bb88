"""The port's native IO library (its own copy of ``native/ppst_io.cpp``, built
at first use) against ppst_tpu's ``data.native`` built from the JAX
package's source with ``native/build.sh``'s flags: every function bit for
bit, the CelebAMask native batches exactly, and a failed build raising
instead of falling back to PIL."""

import argparse
import pathlib
import subprocess

import numpy as np
import pytest
from PIL import Image

from ppst_tpu.data import ConfigurableDataLoader as JaxLoader
from ppst_tpu.data import native as jax_native
from ppst_tpu_torch.data import ConfigurableDataLoader, native
from ppst_tpu_torch.data.celebamask_dataset import CelebAMaskDataset

ROOT = pathlib.Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def jax_lib(tmp_path_factory):
    """ppst_tpu's library, compiled from ``native/ppst_io.cpp`` with
    ``native/build.sh``'s command into a temporary directory (the repo's own
    ``native/libppst_io.so`` may come from another host)."""
    flags = (ROOT / "native" / "build.sh").read_text().split("g++", 1)[1].split("ppst_io.cpp")[0]
    assert flags.split() == native.CXX_FLAGS, flags
    out = tmp_path_factory.mktemp("jax_native") / "libppst_io.so"
    subprocess.run(["g++", *flags.split(), str(ROOT / "native" / "ppst_io.cpp"), "-o", str(out)],
                   check=True)
    mp = pytest.MonkeyPatch()
    mp.setattr(jax_native, "_LIB_PATH", str(out))
    mp.setattr(jax_native, "_lib", None)
    assert jax_native.available()
    yield jax_native
    mp.undo()


def test_source_is_the_jax_package_code():
    """The port's copy differs from ``native/ppst_io.cpp`` in its header
    comment only, and no module of the port loads the JAX package's
    library."""
    def code(path):
        text = path.read_text()
        return text[text.index("#include"):]

    assert code(native.SOURCE) == code(ROOT / "native" / "ppst_io.cpp")
    for f in (ROOT / "ppst_tpu_torch").rglob("*.py"):
        assert "libppst_io" not in f.read_text(), f
    assert "libppst_io" not in (ROOT / "chip_smoke.py").read_text()
    lib = native.build()
    assert lib.parent == ROOT / "ppst_tpu_torch" / "_build" and lib.name.startswith("ppst_io_")


@pytest.mark.parametrize("shape,out_hw", [((61, 47, 3), (32, 32)), ((20, 30, 3), (57, 41)),
                                          ((33, 33, 1), (16, 24)), ((40, 24), (40, 24))])
def test_native_functions_equal_jax(jax_lib, shape, out_hw):
    """``resize_u8`` bilinear and nearest (down, up, one channel, same size),
    ``to_pm1`` with and without the flip and ``one_hot_mask`` (labels at and
    above the class count included), bit for bit."""
    rng = np.random.default_rng(sum(shape))
    img = (rng.random(shape) * 255).astype(np.uint8)
    for nearest in (False, True):
        got = native.resize_u8(img, out_hw, nearest=nearest)
        want = jax_lib.resize_u8(img, out_hw, nearest=nearest)
        assert got.dtype == np.uint8 and got.shape == want.shape
        np.testing.assert_array_equal(got, want)
    for flip in (False, True):
        np.testing.assert_array_equal(native.to_pm1(img, flip=flip), jax_lib.to_pm1(img, flip=flip))
        labels = rng.integers(0, 5, shape[:2]).astype(np.uint8)
        np.testing.assert_array_equal(native.one_hot_mask(labels, 3, flip=flip),
                                      jax_lib.one_hot_mask(labels, 3, flip=flip))


def _pairs(root, rng, n=5):
    (root / "img").mkdir(parents=True)
    (root / "mask").mkdir()
    for i in range(n):
        h, w = 70 + 3 * i, 53 + 5 * i
        Image.fromarray((rng.random((h, w, 3)) * 255).astype(np.uint8)).save(
            root / "img" / f"{i}.png")
        Image.fromarray(rng.integers(0, 3, (h, w)).astype(np.uint8)).save(
            root / "mask" / f"{i}.png")


def _opt(root, **kw):
    base = dict(dataset_mode="celebamask", dataroot=str(root / "img"),
                dataroot2=str(root / "mask"), preprocess="resize", load_size=48, crop_size=48,
                isTrain=True, no_flip=False, phase="train", batch_size=2, shuffle_dataset=None,
                seed=4, nThreads=3, native_io=True)
    return argparse.Namespace(**dict(base, **kw))


def test_celebamask_native_batches_equal_jax(jax_lib, tmp_path, rng):
    """``--native_io true --preprocess resize``: each item (flipped or not,
    epochs 0 and 1) and the training loader's batches equal ppst_tpu's native
    path exactly; the native path is not the PIL path."""
    from ppst_tpu.data.celebamask_dataset import CelebAMaskDataset as JaxCelebAMask

    _pairs(tmp_path, rng)
    opt = _opt(tmp_path)
    ours, theirs = CelebAMaskDataset(opt), JaxCelebAMask(opt)
    assert ours.native and theirs.native is not None
    flips = 0
    for epoch in (0, 1):
        ours.set_epoch(epoch)
        theirs.set_epoch(epoch)
        for i in range(len(ours)):
            got, want = ours[i], theirs[i]
            assert got["path_A"] == want["path_A"]
            np.testing.assert_array_equal(got["real_A"], want["real_A"])
            np.testing.assert_array_equal(got["mask_A"], want["mask_A"])
            flips += bool(ours.item_rng(i).random() < 0.5)
    assert 0 < flips < 10
    pil = CelebAMaskDataset(_opt(tmp_path, native_io=False))[0]["real_A"]
    assert not np.array_equal(pil, ours[0]["real_A"])

    loader, jax_loader = ConfigurableDataLoader(opt), JaxLoader(opt)
    try:
        for _ in range(3):  # two batches of epoch 0, the first of epoch 1
            got, want = next(loader), next(jax_loader)
            assert got["path_A"] == want["path_A"]
            np.testing.assert_array_equal(got["real_A"], want["real_A"])
            np.testing.assert_array_equal(got["mask_A"], want["mask_A"])
    finally:
        loader.close()
        jax_loader._stop_worker()


def test_failed_build_raises(tmp_path, rng, monkeypatch):
    """With no working compiler the library is not available, its functions
    raise, and ``--native_io true`` is refused instead of taking PIL's path,
    which stays usable without the option."""
    monkeypatch.setattr(native, "CXX", str(tmp_path / "missing" / "g++"))
    monkeypatch.setattr(native, "_lib", None)
    _pairs(tmp_path, rng, n=2)
    assert not native.available()
    with pytest.raises(RuntimeError, match="cannot be built"):
        native.to_pm1(np.zeros((2, 2, 3), np.uint8))
    with pytest.raises(RuntimeError, match="cannot be built"):
        CelebAMaskDataset(_opt(tmp_path))
    item = CelebAMaskDataset(_opt(tmp_path, native_io=False))[1]
    assert item["real_A"].shape == (48, 48, 3) and item["mask_A"].shape == (48, 48, 3)
