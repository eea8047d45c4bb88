"""The port's packed datasets against ppst_tpu's: ``.pak`` files and
``dataset_tools`` output byte for byte, the ``lmdb``-mode loader's batches,
per-item transforms (W3), the refusal of an LMDB directory without ``lmdb``,
and the grid evaluator reading a pack's keys."""

import argparse
import io
import sys

import numpy as np
import pytest
from PIL import Image
from test_torch_train_common import NARROW as NARROW_D
from test_torch_train_common import seed_checkpoint

from ppst_tpu.data import ConfigurableDataLoader as JaxLoader
from ppst_tpu.data.dataset_tools import images_to_pack as jax_images_to_pack
from ppst_tpu.data.packed import write_pack as jax_write_pack
from ppst_tpu_torch import test as test_cli
from ppst_tpu_torch.data import ConfigurableDataLoader, dataset_tools
from ppst_tpu_torch.data.packed import PackReader, open_reader, write_pack
from ppst_tpu_torch.optimizers.ppst_optimizer import PPSTOptimizer


def _png(arr) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="PNG")
    return buf.getvalue()


def _folder(root, rng):
    """content/ and style/ images of odd sizes, a grayscale PNG, a JPEG and a
    file that is not an image."""
    for sub, n in (("content", 2), ("style", 3)):
        (root / sub).mkdir(parents=True)
        for i in range(n):
            h, w = 30 + 7 * i, 41 - 3 * i
            Image.fromarray((rng.random((h, w, 3)) * 255).astype(np.uint8)).save(
                root / sub / f"{sub}{i}.png")
    Image.fromarray((rng.random((19, 23)) * 255).astype(np.uint8)).save(root / "style" / "g.png")
    Image.fromarray((rng.random((24, 24, 3)) * 255).astype(np.uint8)).save(root / "j.jpg")
    (root / "notes.txt").write_text("not an image")


def test_write_pack_is_byte_identical_to_jax(tmp_path, rng):
    """The same (key, bytes) items give the same file, and the reader gives
    the blobs back by key, with the keys sorted."""
    items = [(f"dir/{k}.png", _png((rng.random((9 + k, 5, 3)) * 255).astype(np.uint8)))
             for k in (3, 1, 2)]
    write_pack(str(tmp_path / "port.pak"), items)
    jax_write_pack(str(tmp_path / "jax.pak"), items)
    assert (tmp_path / "port.pak").read_bytes() == (tmp_path / "jax.pak").read_bytes()
    reader = open_reader(str(tmp_path / "port.pak"))
    assert isinstance(reader, PackReader) and len(reader) == 3
    assert reader.keys == sorted(k for k, _ in items)
    for key, blob in items:
        assert reader.get(key) == blob


def test_dataset_tools_is_byte_identical_to_jax(tmp_path, rng):
    """``python -m ppst_tpu_torch.data.dataset_tools`` on a folder writes the
    file the JAX package's ``images_to_pack`` writes: sorted paths, RGB PNGs,
    keys relative to the folder."""
    _folder(tmp_path / "in", rng)
    dataset_tools.main(["--input", str(tmp_path / "in"), "--output", str(tmp_path / "port.pak")])
    jax_images_to_pack(str(tmp_path / "in"), str(tmp_path / "jax.pak"))
    assert (tmp_path / "port.pak").read_bytes() == (tmp_path / "jax.pak").read_bytes()
    reader = PackReader(str(tmp_path / "port.pak"))
    assert reader.keys == ["content/content0.png", "content/content1.png", "j.jpg",
                           "style/g.png", "style/style0.png", "style/style1.png",
                           "style/style2.png"]
    gray = np.asarray(Image.open(io.BytesIO(reader.get("style/g.png"))))
    assert gray.shape == (19, 23, 3)


def _loader_opt(pak, **kw):
    base = dict(dataset_mode="lmdb", dataroot=str(pak), preprocess="resize", load_size=24,
                crop_size=24, isTrain=False, no_flip=True, phase="test", batch_size=3,
                shuffle_dataset=None, seed=5, nThreads=2)
    return argparse.Namespace(**dict(base, **kw))


def _batches(loader, n):
    try:
        return [next(loader) for _ in range(n)]
    finally:
        loader.close()


@pytest.fixture
def pak(tmp_path, rng):
    _folder(tmp_path / "in", rng)
    path = tmp_path / "d.pak"
    dataset_tools.images_to_pack(str(tmp_path / "in"), str(path))
    return path


def test_lmdb_loader_batches_match_jax(pak):
    """No random transform: the test-time loader's batches (one pass, in key
    order, the last one short) equal ppst_tpu's, pixels and keys."""
    got = list(ConfigurableDataLoader(_loader_opt(pak)))
    loader = JaxLoader(_loader_opt(pak))
    want = list(loader)
    loader._stop_worker()
    assert [b["real_A"].shape[0] for b in got] == [3, 3, 1]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g["path_A"] == w["path_A"]
        np.testing.assert_array_equal(g["real_A"], w["real_A"])


def test_lmdb_flips_do_not_depend_on_threads(pak):
    """W3: each item's flip and crop come from its own RNG, so the training
    loader's batches (shuffled, flipped, cropped) are the same on 1 and 4
    threads, and some items are flipped."""
    kw = dict(isTrain=True, no_flip=False, phase="train", preprocess="resize_and_crop",
              load_size=28, batch_size=2)
    one = _batches(ConfigurableDataLoader(_loader_opt(pak, nThreads=1, **kw)), 6)
    four = _batches(ConfigurableDataLoader(_loader_opt(pak, nThreads=4, **kw)), 6)
    for a, b in zip(one, four):
        assert a["path_A"] == b["path_A"]
        np.testing.assert_array_equal(a["real_A"], b["real_A"])
    plain = {k: v for b in _batches(ConfigurableDataLoader(_loader_opt(pak, nThreads=1)), 3)
             for k, v in zip(b["path_A"], b["real_A"])}
    flips = 0
    for b in _batches(ConfigurableDataLoader(_loader_opt(
            pak, isTrain=True, no_flip=False, phase="train", nThreads=4)), 3):
        for k, v in zip(b["path_A"], b["real_A"]):
            flipped = np.array_equal(v, plain[k][:, ::-1])
            assert flipped or np.array_equal(v, plain[k]), k
            flips += flipped
    assert 0 < flips < 6


def test_directory_dataroot_needs_lmdb(tmp_path, monkeypatch):
    """An LMDB directory is read only where ``lmdb`` imports (neither this
    host nor the card's machine has it; it is hidden here in any case): the
    reader and the dataset raise an ImportError that names it."""
    monkeypatch.setitem(sys.modules, "lmdb", None)
    with pytest.raises(ImportError, match="lmdb"):
        open_reader(str(tmp_path))
    with pytest.raises(ImportError, match="lmdb"):
        ConfigurableDataLoader(_loader_opt(tmp_path))


def test_training_step_refuses_a_batch_without_masks(pak):
    """The lmdb dataset carries no mask_A (as in the JAX package): a training
    step says so instead of failing on a missing key."""
    batch = _batches(ConfigurableDataLoader(_loader_opt(pak)), 1)[0]
    assert "mask_A" not in batch
    with pytest.raises(ValueError, match="mask_A"):
        PPSTOptimizer.prepare_images(argparse.Namespace(bundle=None), batch)


NARROW_FLAGS = ["--netE_scale_capacity", "0.25", "--netE2_scale_capacity", "0.25",
                "--global_code_ch", "64", "--spatial_code_ch", "16", "--netG_resnet_ch", "32",
                "--netG_scale_capacity", "0.125", "--netD_scale_capacity", "0.125"]


def test_grid_from_pack_equals_grid_from_folder(tmp_path, rng):
    """``python -m ppst_tpu_torch.test`` with the grid evaluator on a pack
    (``--dataset_mode lmdb``) writes the PNGs it writes from the folder the
    pack was made from: the pack's relative keys under ``content/`` are the
    contents."""
    root = tmp_path / "in"
    for sub, n in (("content", 1), ("style", 2)):
        (root / sub).mkdir(parents=True)
        for i in range(n):
            Image.fromarray((rng.random((64, 64, 3)) * 255).astype(np.uint8)).save(
                root / sub / f"{sub}{i}.png")
    dataset_tools.images_to_pack(str(root), str(tmp_path / "grid.pak"))
    weights = seed_checkpoint(tmp_path / "seed.pth", **NARROW_D)
    pages = {}
    for mode, dataroot in (("imagefolder", root), ("lmdb", tmp_path / "grid.pak")):
        test_cli.main(["--device", "cpu", "--name", "ppst", "--evaluation_metrics",
                       "content_style_grid_generation", "--dataset_mode", mode, "--dataroot",
                       str(dataroot), "--preprocess", "resize", "--load_size", "64",
                       "--crop_size", "64", "--result_dir", str(tmp_path / mode),
                       "--checkpoint", weights, *NARROW_FLAGS])
        pages[mode] = (tmp_path / mode / "ppst" / "results" / "contentstylegridgeneration"
                       / "test_latest" / "images")
    files = sorted(p.name for p in pages["imagefolder"].iterdir())
    assert files == sorted(p.name for p in pages["lmdb"].iterdir())
    # blank + 2 styles, then the content and its 2 pairs
    assert len(files) == 6 and any("content0_style1" in f for f in files)
    for f in files:
        assert (pages["imagefolder"] / f).read_bytes() == (pages["lmdb"] / f).read_bytes(), f
