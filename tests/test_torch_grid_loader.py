"""The grid evaluator (``content_style_1t1_generation``) on the loader, as the
reference launcher's test recipe runs it: a CelebAMask tree of ``content/``
and ``style/`` images with their masks paired by sorted order, through
ppst_tpu's ``GroupEvaluator`` and through the port's test CLI from the same
weights (the port's seed weights, carried by ``convert_torch``; their noise
gains are zero, so neither side's noise enters): the same PNG names, pixels
within one uint8 step. The train CLI's ``GroupEvaluator`` runs the same grid
at its evaluation. NARROW at crop 64, float32, on the CPU."""

import contextlib
import io
import shlex

import jax
import numpy as np
import pytest
from PIL import Image
from test_torch_train_common import NARROW, jax_params, seed_checkpoint

import ppst_tpu.data as jax_data
from ppst_tpu.evaluation import GroupEvaluator as JaxGroupEvaluator
from ppst_tpu.models.config import PPSTConfig as JaxConfig
from ppst_tpu.models.ppst import PPSTModel as JaxModel
from ppst_tpu.options import TestOptions as JaxTestOptions
from ppst_tpu.train.bundle import ModelBundle as JaxBundle
from ppst_tpu_torch import test as test_cli
from ppst_tpu_torch.models.config import PPSTConfig
from ppst_tpu_torch.models.ppst import PPSTModel
from ppst_tpu_torch.train import cli as train_cli

WIDTH_FLAGS = [f"--{k}={v}" for k, v in NARROW.items() if k != "crop_size"]
PAGE = ("contentstylegridgeneration", "test_latest", "images")


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """img/{content,style}/ with 2 images each (80 x 80) and label/ with a
    3-class mask per image, in the images' sorted order; the seed weights."""
    root = tmp_path_factory.mktemp("celebamask")
    rng = np.random.default_rng(5)
    k = 0
    for sub in ("content", "style"):
        (root / "img" / sub).mkdir(parents=True)
        for i in range(2):
            Image.fromarray((rng.random((80, 80, 3)) * 255).astype(np.uint8)).save(
                root / "img" / sub / f"{sub[0]}{i}.png")
            (root / "label").mkdir(exist_ok=True)
            Image.fromarray(rng.integers(0, 3, (80, 80)).astype(np.uint8)).save(
                root / "label" / f"{k}.png")
            k += 1
    weights = seed_checkpoint(root / "seed.pth", **NARROW)
    args = ["--name", "run", "--dataset_mode", "CelebAMask", "--dataroot", str(root / "img"),
            "--dataroot2", str(root / "label"), "--preprocess", "scale_width", "--load_size",
            "64", "--crop_size", "64", "--batch_size", "1", "--dataname", "test1",
            "--evaluation_metrics", "content_style_1t1_generation", *WIDTH_FLAGS]
    return root, weights, args


def _pngs(page):
    return {p.name: np.asarray(Image.open(p)) for p in page.iterdir()}


@pytest.fixture(scope="module")
def port_grid(tree):
    root, weights, args = tree
    test_cli.main(args + ["--result_dir", str(root / "port"), "--device", "cpu",
                          "--checkpoint", weights])
    return _pngs(root.joinpath("port", "run", "test1", *PAGE))


def test_grid_on_celebamask_matches_jax(tree, port_grid):
    root, weights, args = tree
    model = PPSTModel(PPSTConfig(**NARROW), device="cpu")
    model.load_reference_checkpoint(weights)
    bundle = JaxBundle.__new__(JaxBundle)
    bundle.model = JaxModel(JaxConfig(**NARROW), lpips_variables={})
    bundle.params, bundle.rng = jax_params(model), jax.random.PRNGKey(0)
    command = "python test.py " + shlex.join(args + ["--result_dir", str(root / "jax")])
    with contextlib.redirect_stdout(io.StringIO()):
        opt = JaxTestOptions().parse(command=command)
    JaxGroupEvaluator(opt).evaluate(bundle, jax_data.create_dataset(opt), opt.resume_iter)
    want = _pngs(root.joinpath("jax", "run", "test1", *PAGE))
    # blank + 2 styles, then each content and its 2 pairs
    assert sorted(port_grid) == sorted(want) and len(want) == 9
    assert any("c1_s0" in name for name in want)
    for name, img in want.items():
        assert port_grid[name].shape == img.shape == (64, 64, 3), name
        assert np.abs(port_grid[name].astype(int) - img.astype(int)).max() <= 1, name


def test_grid_runs_from_the_train_cli(tree, port_grid, tmp_path):
    """A D and a G step on the tree at ``--lr 0`` (the weights stay the
    seed's), then the grid at the evaluation of image 2 under
    ``snapshots/test_2``: the test CLI's PNGs."""
    root, _, args = tree
    with contextlib.redirect_stdout(io.StringIO()):
        train_cli.main(args + ["--device", "cpu", "--checkpoints_dir", str(tmp_path),
                               "--batch_size", "2", "--total_nimgs", "4", "--lr", "0",
                               "--evaluation_freq", "2", "--nThreads", "2"])
    got = _pngs(tmp_path / "run" / "snapshots" / "test_2" / "images")
    assert sorted(got) == sorted(port_grid)
    for name, img in got.items():
        assert np.abs(img.astype(int) - port_grid[name].astype(int)).max() <= 1, name
