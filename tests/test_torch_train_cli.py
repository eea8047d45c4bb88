"""``python -m ppst_tpu_torch.train`` on the CPU, its checkpoints read by
ppst_tpu and by the port's inference CLI, and the data layer against
ppst_tpu's (the same items and the same batches)."""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image
from test_torch_train_common import NARROW

from ppst_tpu.data import ConfigurableDataLoader as JaxLoader
from ppst_tpu.data.celebamask_dataset import CelebAMaskDataset as JaxCelebAMask
from ppst_tpu.models.config import PPSTConfig as JaxConfig
from ppst_tpu.models.ppst import PPSTModel as JaxModel
from ppst_tpu.util.convert_torch import load_reference_checkpoint
from ppst_tpu_torch import test as test_cli
from ppst_tpu_torch.data import ConfigurableDataLoader
from ppst_tpu_torch.data.base_dataset import sample_transform_params
from ppst_tpu_torch.data.celebamask_dataset import CelebAMaskDataset
from ppst_tpu_torch.models.config import PPSTConfig
from ppst_tpu_torch.models.generator import make_fixed_noise
from ppst_tpu_torch.models.ppst import PPSTModel, take_rows
from ppst_tpu_torch.train import cli
from ppst_tpu_torch.train.bundle import create_model

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WIDTH_FLAGS = [f"--{k}={v}" for k, v in NARROW.items() if k != "crop_size"]
LOSS_KEYS = {"D_real", "D_rec", "D_mix", "D_R1", "D_total", "G_L1", "G_L1_cyc", "G_GAN_rec",
             "G_GAN_mix", "G_styleContmix", "G_styleContrec", "Mask_warp", "image_warp_reg",
             "L1_dist"}


def _args(ckpt, extra=()):
    # 4 steps of 2 images: D, G, D + R1 (R1 every 2nd D step), G
    return ["--device", "cpu", "--name", "run", "--checkpoints_dir", str(ckpt),
            "--dataset_mode", "synthetic", "--synthetic_size", "6", "--crop_size", "64",
            "--load_size", "64", "--batch_size", "2", "--total_nimgs", "8", "--print_freq", "4",
            "--save_freq", "4", "--R1_once_every", "2", "--nThreads", "2", *WIDTH_FLAGS,
            *extra]


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    ckpt = tmp_path_factory.mktemp("ckpt")
    cli.main(_args(ckpt))
    return ckpt / "run"


def test_train_cli_writes_checkpoint_and_logs(trained):
    assert (trained / "0k_checkpoint.pth").is_file()
    assert os.readlink(trained / "latest_checkpoint.pth") == "0k_checkpoint.pth"
    assert (trained / "iter.txt").read_text().strip() == "4"
    log = (trained / "loss_log.txt").read_text().splitlines()
    last = log[-1]
    assert last.startswith("(iters: 4")
    assert {tok[:-1] for tok in last.split(") ", 1)[1].split() if tok.endswith(":")} == LOSS_KEYS
    raw = torch.load(trained / "latest_checkpoint.pth", weights_only=True)
    assert {"state_dict", "rscl", "num_d_iters", "optimizers", "steps"} <= set(raw)
    assert raw["steps"] == 8 and raw["num_d_iters"] == 2
    assert raw["rscl"]["ptrs"].tolist() == [12, 12, 12, 12]  # 2 G steps of 6 keys a scale
    assert set(raw["optimizers"]) == {"G", "E1", "E2", "D"}


def test_continue_train_restores_state(trained, tmp_path):
    """--continue_train restores the image count (iter.txt), the weights,
    the RSCL state, the D-step count and the four optimizers' moments."""
    raw = torch.load(trained / "latest_checkpoint.pth", weights_only=True)
    opt = cli.parse(_args(trained.parent, ["--continue_train", "true"]))
    bundle = create_model(opt)
    for k, v in bundle.model.state_dict().items():
        assert torch.equal(v, raw["state_dict"][k]), k
    assert torch.equal(bundle.model.rscl_queues, raw["rscl"]["queues"])
    assert bundle.model.rscl_ptrs.tolist() == raw["rscl"]["ptrs"].tolist()
    assert bundle.model.num_d_iters == 2
    for k, o in bundle.optimizers.items():
        saved = raw["optimizers"][k]["state"]
        for i, st in o.state_dict()["state"].items():
            assert torch.equal(st["exp_avg_sq"], saved[i]["exp_avg_sq"]), (k, i)
    assert cli.IterationCounter(opt).steps_so_far == 4


def test_resumed_run_trains_on(trained, tmp_path):
    """The resumed CLI run goes on from the recorded image count to the new
    total and writes the next checkpoint."""
    cli.main(_args(trained.parent, ["--continue_train", "true", "--total_nimgs", "12",
                                    "--save_freq", "1000"]))
    raw = torch.load(trained / "latest_checkpoint.pth", weights_only=True)
    assert raw["steps"] == 12 and raw["num_d_iters"] == 4


def test_checkpoint_serves_in_jax_and_in_the_port(trained, rng, tmp_path):
    """The checkpoint converts to ppst_tpu's trees (convert_torch) and both
    packages stylize with it alike: the grid path (extraction, then the
    pairs with the guided filter), with pinned noise, because trained noise
    gains are no longer zero; the tolerance of test_torch_stylize.py.
    ``python -m ppst_tpu_torch.test --checkpoint`` serves it."""
    path = str(trained / "0k_checkpoint.pth")
    params = jax.tree.map(jnp.asarray, load_reference_checkpoint(path, crop_size=64))
    assert set(params) == {"E1", "E2", "G", "D"}
    model = PPSTModel(PPSTConfig(**NARROW), device="cpu", seed=5)
    model.load_reference_checkpoint(path)
    assert any(p.abs().sum() > 0 for k, p in model.G.named_parameters() if "noise" in k)
    images = rng.uniform(-1, 1, (4, 64, 64, 3)).astype(np.float32)
    gen = torch.Generator().manual_seed(3)
    n_ext = [n.numpy() for n in make_fixed_noise(model.cfg, gen, 4, 64)]
    n_dec = [n.numpy() for n in make_fixed_noise(model.cfg, gen, 2, 64)]
    ci, si = np.array([0, 1]), np.array([1, 0])
    jmodel = JaxModel(JaxConfig(**NARROW), lpips_variables={})

    def jax_grid(p, x, ne, nd):
        bank = jmodel.grid_extract(p, x, jax.random.PRNGKey(0), noises=ne)
        cb = jax.tree.map(lambda v: v[:2], bank)
        sb = jax.tree.map(lambda v: v[2:], bank)
        return jmodel.grid_pairs(p, cb, sb, ci, si, jax.random.PRNGKey(0),
                                 smooth_target=x[:2], noises=nd)

    want = jax.jit(jax_grid)(params, jnp.asarray(images), [jnp.asarray(n) for n in n_ext],
                             [jnp.asarray(n) for n in n_dec])
    x = torch.from_numpy(images)
    bank = model.grid_extract(x, noises=[torch.from_numpy(n) for n in n_ext])
    cb = {k: take_rows(v, slice(None, 2)) for k, v in bank.items()}
    sb = {k: take_rows(v, slice(2, None)) for k, v in bank.items()}
    got = model.grid_pairs(cb, sb, ci, si, smooth_target=x[:2],
                           noises=[torch.from_numpy(n) for n in n_dec])
    assert np.abs(got.numpy() - np.asarray(want)).max() <= 1e-3

    imgs = []
    for name in ("content", "style"):
        p = tmp_path / f"{name}.png"
        Image.fromarray((rng.random((64, 64, 3)) * 255).astype(np.uint8)).save(p)
        imgs.append(str(p))
    (ev,) = test_cli.main(["--device", "cpu", "--name", "ppst", "--checkpoint", path,
                           "--evaluation_metrics", "simple_swapping", "--input_structure_image",
                           imgs[0], "--input_texture_image", imgs[1], "--preprocess", "resize",
                           "--load_size", "64", "--crop_size", "64",
                           "--result_dir", str(tmp_path / "res"), *WIDTH_FLAGS]).evaluators
    assert np.asarray(Image.open(ev.paths[0])).shape == (64, 64, 3)


def _losses(run_dir):
    """The loss values printed at step 4 in ``loss_log.txt`` (after the
    times; a resumed run appends later lines)."""
    lines = (run_dir / "loss_log.txt").read_text().splitlines()
    return next(line for line in lines if line.startswith("(iters: 4,")).split(") ", 1)[1]


def test_train_cli_remat_knobs(trained, tmp_path):
    """``--remat_taps true --remat_blocks true`` reach the model and opt.txt,
    and the run's losses are those of the same steps without them (the
    ``trained`` fixture): they only recompute."""
    bundle = cli.main(_args(tmp_path, ["--remat_taps", "true", "--remat_blocks", "true"]))
    assert bundle.model.cfg.remat_taps and bundle.model.cfg.remat_blocks
    opt = (tmp_path / "run" / "opt.txt").read_text()
    assert "remat_taps: True" in opt and "remat_blocks: True" in opt
    assert _losses(tmp_path / "run") == _losses(trained)


def _loss_lines(run_dir):
    """The loss values of every line of ``loss_log.txt`` (times dropped)."""
    return [line.split(") ", 1)[1] for line in (run_dir / "loss_log.txt").read_text().splitlines()
            if line.startswith("(iters:")]


def test_train_cli_snapshots_and_swap_visualization(tmp_path):
    """--display_freq 2 saves a snapshot at every step and
    --evaluation_metrics swap_visualization at --evaluation_freq 4 writes its
    grid page. Both draw noise from generators of their own: the losses and
    the final weights are those of the same run with the no-op evaluator at
    the same frequency and a snapshot only at image 0. (Either evaluation
    switches the loader to its test phase and back, which restarts the
    training epoch, as in ppst_tpu.)"""
    cli.main(_args(tmp_path / "a", ["--display_freq", "2", "--evaluation_metrics",
                                    "swap_visualization", "--evaluation_freq", "4",
                                    "--swap_num_columns", "2", "--swap_num_images", "2"]))
    cli.main(_args(tmp_path / "b", ["--evaluation_metrics", "none", "--evaluation_freq", "4"]))
    run_a, run_b = tmp_path / "a" / "run", tmp_path / "b" / "run"
    snaps = sorted(p.name for p in (run_a / "snapshots").glob("*.png"))
    assert snaps == [f"{i:09d}.png" for i in (0, 2, 4, 6)]
    for name in snaps:  # rows real, layout, rec, mix of the batch's 2 images
        assert np.asarray(Image.open(run_a / "snapshots" / name)).shape == (256, 128, 3)
    assert [p.name for p in (run_b / "snapshots").glob("*.png")] == ["000000000.png"]
    page = run_a / "snapshots" / "test_0k"
    assert (page / "index.html").is_file()
    (grid,) = (page / "images").glob("*.png")
    assert np.asarray(Image.open(grid)).shape == (192, 192, 3)
    assert _loss_lines(run_a) == _loss_lines(run_b) and len(_loss_lines(run_a)) == 2
    a = torch.load(run_a / "latest_checkpoint.pth", weights_only=True)
    b = torch.load(run_b / "latest_checkpoint.pth", weights_only=True)
    for k, v in a["state_dict"].items():
        assert torch.equal(v, b["state_dict"][k]), k


def test_train_cli_refusals(tmp_path, monkeypatch):
    """--num_gpus 2 in a process that no launcher started (a world of one) is
    refused, and simple_swapping without its two images, as in ppst_tpu; a
    global batch that 2 x the world size does not divide is refused before
    anything is written; without a card and without --device cpu the CLI
    raises before writing."""
    for extra in (["--num_gpus", "2"], ["--evaluation_metrics", "simple_swapping"]):
        with pytest.raises(SystemExit):
            cli.parse(_args(tmp_path, extra))
    with pytest.raises(ValueError, match="global batch"):
        cli.main(_args(tmp_path, ["--batch_size", "3"]))
    assert not (tmp_path / "run").exists()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = _args(tmp_path)
    with pytest.raises(RuntimeError, match="--device cpu"):
        cli.main(args[2:])
    assert not (tmp_path / "run").exists()


def test_train_module_entry_point():
    """``python -m ppst_tpu_torch.train`` is the CLI (its --help)."""
    out = subprocess.run([sys.executable, "-m", "ppst_tpu_torch.train", "--help"], cwd=ROOT,
                         capture_output=True, text=True, check=True, timeout=120)
    assert "--continue_train" in out.stdout and "--device" in out.stdout


def _write_celebamask(root, n=3, size=(40, 48)):
    rng = np.random.default_rng(1)
    (root / "img").mkdir()
    (root / "mask").mkdir()
    for i in range(n):
        Image.fromarray((rng.random(size + (3,)) * 255).astype(np.uint8)).save(
            root / "img" / f"{i}.jpg")
        Image.fromarray(rng.integers(0, 3, size).astype(np.uint8)).save(root / "mask" / f"{i}.png")


def test_celebamask_items_match_jax(tmp_path):
    """Image from dataroot, 3-class one-hot mask from dataroot2, one shared
    flip per item: the same arrays as ppst_tpu's dataset, item for item."""
    _write_celebamask(tmp_path)
    opt = cli.parse(["--name", "x", "--device", "cpu", "--checkpoints_dir", str(tmp_path),
                     "--dataroot", str(tmp_path / "img"), "--dataroot2",
                     str(tmp_path / "mask"), "--load_size", "32", "--crop_size", "32",
                     "--preprocess", "resize"])
    port, ref = CelebAMaskDataset(opt), JaxCelebAMask(opt)
    flips = set()
    for i in range(len(ref)):
        a, b = port[i], ref[i]
        assert a["real_A"].shape == (32, 32, 3) and a["mask_A"].shape == (32, 32, 3)
        np.testing.assert_array_equal(a["real_A"], b["real_A"])
        np.testing.assert_array_equal(a["mask_A"], b["mask_A"])
        np.testing.assert_array_equal(a["mask_A"].sum(-1), np.ones((32, 32)))
        flips.add(sample_transform_params(opt, (48, 40), port.item_rng(i))["flip"])
    assert flips == {True, False}  # both branches of the shared flip ran


def test_data_at_crop_1024(tmp_path):
    """1024px training data: the synthetic and CelebAMask (resize) items and
    the loader's batches are 1024 x 1024, the same arrays as ppst_tpu's."""
    _write_celebamask(tmp_path, n=2)
    opt = cli.parse(["--name", "x", "--device", "cpu", "--checkpoints_dir", str(tmp_path),
                     "--dataroot", str(tmp_path / "img"), "--dataroot2",
                     str(tmp_path / "mask"), "--load_size", "1024", "--crop_size", "1024",
                     "--batch_size", "2", "--nThreads", "2", "--preprocess", "resize"])
    a, b = CelebAMaskDataset(opt)[1], JaxCelebAMask(opt)[1]
    assert a["real_A"].shape == (1024, 1024, 3) and a["mask_A"].shape == (1024, 1024, 3)
    np.testing.assert_array_equal(a["real_A"], b["real_A"])
    np.testing.assert_array_equal(a["mask_A"], b["mask_A"])
    opt.dataset_mode, opt.synthetic_size = "synthetic", 3
    port, ref = next(ConfigurableDataLoader(opt)), next(JaxLoader(opt))
    assert port["real_A"].shape == (2, 1024, 1024, 3) and port["mask_A"].shape == (2, 1024, 1024, 3)
    np.testing.assert_array_equal(port["real_A"], ref["real_A"])
    np.testing.assert_array_equal(port["mask_A"], ref["mask_A"])


def test_loader_batches_match_jax(tmp_path):
    """The training loader's batches, across an epoch boundary (reshuffled
    with random.Random(1000 + epoch)), equal ppst_tpu's."""
    opt = cli.parse(["--name", "x", "--device", "cpu", "--checkpoints_dir", str(tmp_path),
                     "--dataset_mode", "synthetic", "--synthetic_size", "5",
                     "--crop_size", "32", "--batch_size", "2", "--nThreads", "2"])
    port, ref = ConfigurableDataLoader(opt), JaxLoader(opt)
    for _ in range(5):
        a, b = next(port), next(ref)
        assert a["path_A"] == b["path_A"]
        np.testing.assert_array_equal(a["real_A"], b["real_A"])
        np.testing.assert_array_equal(a["mask_A"], b["mask_A"])
