"""The port's data layer against ppst_tpu's: every ``--preprocess`` mode on
odd-sized images with the same random draws (exact), the datasets' retry on
an unreadable file, and the prefetching loader's batches across epochs and
phase switches (exact), with no producer thread left behind."""

import threading

import jax
import numpy as np
import pytest
from PIL import Image

from ppst_tpu.data import ConfigurableDataLoader as JaxLoader
from ppst_tpu.data import base_dataset as jax_bd
from ppst_tpu.data.celebamask_dataset import CelebAMaskDataset as JaxCelebAMask
from ppst_tpu.data.imagefolder_dataset import ImageFolderDataset as JaxImageFolder
from ppst_tpu_torch import parallel
from ppst_tpu_torch.data import ConfigurableDataLoader
from ppst_tpu_torch.data import base_dataset as bd
from ppst_tpu_torch.data.celebamask_dataset import CelebAMaskDataset
from ppst_tpu_torch.data.imagefolder_dataset import ImageFolderDataset
from ppst_tpu_torch.options import TrainOptions
from ppst_tpu_torch.train import cli
from ppst_tpu_torch.util.util import copyconf

MODES = ["fixsize", "resize", "scale_width", "scale_shortside", "scale_longside", "zoom",
         "centercrop", "crop", "trim", "scale_width_and_crop", "scale_shortside_and_crop",
         "scale_longside_and_centercrop", "resize_and_crop", "zoom_and_crop",
         "scale_width_and_zoom_and_trim", "none"]
# (w, h): wider, taller, smaller than the crop, and not multiples of 16
SIZES = [(53, 37), (45, 70), (27, 21)]


def _opt(tmp_path, *extra):
    """The training options of the data layer, without the training CLI's
    checks of the batch against the world."""
    return cli.parse(["--name", "x", "--device", "cpu", "--checkpoints_dir", str(tmp_path),
                      "--dataroot", str(tmp_path / "img"), "--dataroot2",
                      str(tmp_path / "mask"), "--load_size", "40", "--crop_size", "32",
                      "--seed", "3", *extra], TrainOptions())


def _write_pairs(root, sizes):
    rng = np.random.default_rng(1)
    (root / "img").mkdir()
    (root / "mask").mkdir()
    for i, (w, h) in enumerate(sizes):
        Image.fromarray((rng.random((h, w, 3)) * 255).astype(np.uint8)).save(
            root / "img" / f"{i}.png")
        Image.fromarray(rng.integers(0, 3, (h, w)).astype(np.uint8)).save(
            root / "mask" / f"{i}.png")


@pytest.mark.parametrize("mode", MODES)
def test_preprocess_modes_match_jax_exactly(tmp_path, mode):
    """Each mode, at train time (flip drawn) and at test time, on RGB with
    bicubic and on labels with nearest: the same draws and the same pixels
    as ppst_tpu; then to_tensor with and without normalization and
    get_transform with grayscale and without conversion."""
    rng = np.random.default_rng(0)
    for is_train in (True, False):
        opt = copyconf(_opt(tmp_path, "--preprocess", mode), isTrain=is_train)
        for k, (w, h) in enumerate(SIZES):
            img = Image.fromarray((rng.random((h, w, 3)) * 255).astype(np.uint8))
            lab = Image.fromarray(rng.integers(0, 3, (h, w)).astype(np.uint8))
            seed = 100 * k + is_train
            params = bd.sample_transform_params(opt, img.size, bd.random.Random(seed))
            assert params == jax_bd.sample_transform_params(opt, img.size,
                                                            jax_bd.random.Random(seed))
            for x, method in ((img, bd.BICUBIC), (lab, Image.NEAREST)):
                got = bd.apply_transform(opt, x, params, method)
                want = jax_bd.apply_transform(opt, x, params, method)
                assert got.size == want.size and got.size[0] % 16 == 0
                np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
            for normalize in (True, False):
                np.testing.assert_array_equal(bd.to_tensor(img, normalize),
                                              jax_bd.to_tensor(img, normalize))
            for kw in (dict(grayscale=True), dict(convert=False)):
                got = bd.get_transform(opt, params, **kw)(img)
                want = jax_bd.get_transform(opt, params, **kw)(img)
                np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def test_train_cli_defaults_to_scale_width_and_crop(tmp_path):
    """The train CLI's --preprocess default is JAX's; a 520 x 600 image
    scales to 512 x 591 and is cropped to 512 x 512."""
    opt = cli.parse(["--name", "x", "--device", "cpu", "--checkpoints_dir", str(tmp_path)])
    assert opt.preprocess == "scale_width_and_crop" and opt.preprocess_crop_padding is None
    img = Image.new("RGB", (520, 600))
    params = bd.sample_transform_params(opt, img.size, bd.random.Random(0))
    assert params["crop_pos"] is not None
    assert bd.apply_transform(opt, img, params).size == (512, 512)


def _unreadable(path):
    path.write_bytes(b"not an image")


def test_imagefolder_retry_matches_jax(tmp_path):
    """F5: an unreadable file is replaced by the item that the shared
    ((seed * 1000003) + epoch) * 1000003 + index RNG picks, as in ppst_tpu
    (at seed 3 the port's former seed * 1000003 + index picked item 3, not
    2). At epoch 1 that RNG picks the unreadable item itself: ppst_tpu
    recurses until the stack overflows, the port takes the RNG's next
    draw (item 3)."""
    _write_pairs(tmp_path, SIZES * 3)
    _unreadable(tmp_path / "img" / "4.png")
    opt = _opt(tmp_path, "--preprocess", "scale_width_and_crop")
    port, ref = ImageFolderDataset(opt), JaxImageFolder(opt)
    assert port.replacement(4) == 2
    for i in range(len(ref)):
        a, b = port[i], ref[i]
        assert a["path_A"] == b["path_A"]
        np.testing.assert_array_equal(a["real_A"], b["real_A"])
    assert port[4]["path_A"] == str(tmp_path / "img" / "2.png")
    for ds in (port, ref):
        ds.set_epoch(1)
    with pytest.raises(RecursionError):
        ref[4]
    assert port[4]["path_A"] == str(tmp_path / "img" / "3.png")


def test_celebamask_retry_matches_jax(tmp_path):
    """F6: an unreadable image is reported and replaced, not raised, by
    the item ppst_tpu picks; image and mask keep one flip and crop."""
    _write_pairs(tmp_path, SIZES * 2)
    _unreadable(tmp_path / "img" / "2.png")
    opt = _opt(tmp_path, "--preprocess", "scale_width_and_crop")
    port, ref = CelebAMaskDataset(opt), JaxCelebAMask(opt)
    for i in range(len(ref)):
        a, b = port[i], ref[i]
        assert a["path_A"] == b["path_A"] != str(tmp_path / "img" / "2.png")
        np.testing.assert_array_equal(a["real_A"], b["real_A"])
        np.testing.assert_array_equal(a["mask_A"], b["mask_A"])
        np.testing.assert_array_equal(a["mask_A"].sum(-1), np.ones((32, 32)))


def _loader_threads():
    return [t for t in threading.enumerate()
            if t.name.startswith("ppst-loader") and t.is_alive()]


def _same(a, b):
    assert a["path_A"] == b["path_A"]
    np.testing.assert_array_equal(a["real_A"], b["real_A"])
    np.testing.assert_array_equal(a["mask_A"], b["mask_A"])


@pytest.mark.parametrize("threads", ["1", "4"])
def test_loader_matches_jax_through_phase_switches(tmp_path, threads):
    """Train batches over two epochs, then a whole test pass (in order,
    the ragged tail kept), then train again from epoch 0, as ppst_tpu's
    loader gives them; one producer at a time, none after close()."""
    _write_pairs(tmp_path, (SIZES * 2)[:5])
    opt = _opt(tmp_path, "--batch_size", "2", "--nThreads", threads)
    port, ref = ConfigurableDataLoader(opt), JaxLoader(opt)
    try:
        for _ in range(5):  # 2 batches an epoch
            _same(next(port), next(ref))
        assert port.epoch == ref.epoch == 2
        for phase in ("test", "train"):
            port.set_phase(phase)
            ref.set_phase(phase)
            assert len([t for t in _loader_threads() if t.name == "ppst-loader"]) <= 1
            if phase == "test":
                got, want = list(port), list(ref)
                assert [len(b["path_A"]) for b in got] == [2, 2, 1]
                for a, b in zip(got, want, strict=True):
                    _same(a, b)
        for _ in range(4):
            _same(next(port), next(ref))
    finally:
        port.close()
    assert not _loader_threads()


@pytest.mark.parametrize("rank", [0, 1])
def test_rank_slices_match_jax_shards(tmp_path, monkeypatch, rank):
    """Under two ranks, training rank ``rank`` loads its contiguous half of
    every global batch: the same paths and pixels as ppst_tpu's loader with
    two processes at the same process index, over two shuffled epochs with
    random crops and flips; and the half is that of the world-1 batch."""
    _write_pairs(tmp_path, (SIZES * 3)[:8])
    opt = _opt(tmp_path, "--batch_size", "4", "--nThreads", "2")
    whole = ConfigurableDataLoader(opt)
    try:
        full = [next(whole) for _ in range(4)]  # 2 batches an epoch
    finally:
        whole.close()
    monkeypatch.setattr(parallel, "world_size", lambda: 2)
    monkeypatch.setattr(parallel, "rank", lambda: rank)
    monkeypatch.setattr(jax, "process_count", lambda: 2)
    monkeypatch.setattr(jax, "process_index", lambda: rank)
    port, ref = ConfigurableDataLoader(opt), JaxLoader(opt)
    try:
        assert (port.num_shards, port.shard_rank) == (ref.num_shards, ref.shard_rank) \
            == (2, rank)
        half = slice(2 * rank, 2 * rank + 2)
        for batch in full:
            got = next(port)
            _same(got, next(ref))
            assert got["path_A"] == batch["path_A"][half]
            np.testing.assert_array_equal(got["real_A"], batch["real_A"][half])
            np.testing.assert_array_equal(got["mask_A"], batch["mask_A"][half])
        assert port.epoch == ref.epoch == 1
    finally:
        port.close()
        ref._stop_worker()
    assert not _loader_threads()


def test_one_pass_reads_the_producer_it_started(tmp_path):
    """Iterating a fresh one-pass phase reads the pass that initialize
    started, without restarting it; a second or a half-read pass starts
    again from its first batch, as ppst_tpu's loader does."""
    _write_pairs(tmp_path, SIZES)
    opt = _opt(tmp_path, "--batch_size", "2", "--nThreads", "2", "--phase", "test",
               "--preprocess", "resize")
    port, ref = ConfigurableDataLoader(opt), JaxLoader(opt)
    try:
        started = port._worker
        assert iter(port) is port and port._worker is started
        want = list(ref)
        for got in (list(port), list(port)):
            for a, b in zip(got, want, strict=True):
                _same(a, b)
        next(iter(port))
        for a, b in zip(port, want, strict=True):
            _same(a, b)
    finally:
        port.close()
    assert not _loader_threads()


def test_loader_stops_a_blocked_producer(tmp_path):
    """set_phase stops a producer blocked on the full queue (PREFETCH
    batches ahead) without deadlock, however often it switches."""
    _write_pairs(tmp_path, SIZES * 4)
    loader = ConfigurableDataLoader(_opt(tmp_path, "--batch_size", "1", "--nThreads", "2"))
    try:
        for i in range(6):
            loader._worker.join(timeout=0.05)  # let it fill the queue
            loader.set_phase(("test", "train")[i % 2])
            assert len([t for t in _loader_threads() if t.name == "ppst-loader"]) <= 1
        assert next(loader)["real_A"].shape == (1, 32, 32, 3)
    finally:
        loader.close()
    assert not _loader_threads()


def test_loader_raises_the_producers_error(tmp_path):
    """A batch that fails to load (items of two shapes, which do not stack)
    raises in the consumer, not in a thread nobody reads."""
    _write_pairs(tmp_path, SIZES)
    loader = ConfigurableDataLoader(_opt(tmp_path, "--batch_size", "3", "--nThreads", "2",
                                         "--phase", "test", "--preprocess", "scale_width"))
    try:
        with pytest.raises(ValueError):
            list(loader)
    finally:
        loader.close()
    assert not _loader_threads()
