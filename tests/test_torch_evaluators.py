"""The port's evaluation surface against ppst_tpu's: the GroupEvaluator's
metric parsing, SSIM / PSNR / LPIPS, the training snapshot's visuals and
the swap-visualization grid at NARROW in float32 with the same weights, and
the inference CLI running the loader evaluators."""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image
from test_torch_train_common import NARROW, jax_params

from ppst_tpu.evaluation import find_evaluator_classes as jax_find_evaluator_classes
from ppst_tpu.evaluation import metrics as jax_metrics
from ppst_tpu.evaluation.swap_visualization_evaluator import (
    SwapVisualizationEvaluator as JaxSwapVisualization,
)
from ppst_tpu.models.config import PPSTConfig as JaxConfig
from ppst_tpu.models.ppst import PPSTModel as JaxModel
from ppst_tpu.ops import lpips as jax_lpips
from ppst_tpu.train.bundle import ModelBundle as JaxBundle
from ppst_tpu_torch import test as test_cli
from ppst_tpu_torch.data import ConfigurableDataLoader
from ppst_tpu_torch.evaluation import GroupEvaluator, find_evaluator_classes, metrics
from ppst_tpu_torch.evaluation.swap_visualization_evaluator import SwapVisualizationEvaluator
from ppst_tpu_torch.models.config import PPSTConfig
from ppst_tpu_torch.options import AugmentedArgumentParser, module_command
from ppst_tpu_torch.options import TestOptions as PortTestOptions
from ppst_tpu_torch.models.ppst import PPSTModel
from ppst_tpu_torch.ops.lpips import LPIPS
from ppst_tpu_torch.util.from_flax import lpips_from_flax

WIDTH_FLAGS = [f"--{k}={v}" for k, v in NARROW.items() if k != "crop_size"]


@pytest.mark.parametrize("metrics_flag", [
    "none", "swap_visualization", "trainswap_visualization", "testswap_visualization,trainnone",
    "simple_swapping", "content_style_1t1_generation", "content_style_grid_generation,none", ""])
def test_metric_parsing_matches_jax(metrics_flag):
    """Comma lists with train/test prefixes (test by default) resolve to the
    evaluator classes and phases of ppst_tpu's, the alias included."""
    opt = SimpleNamespace(evaluation_metrics=metrics_flag)
    classes, phases = find_evaluator_classes(opt)
    want_classes, want_phases = jax_find_evaluator_classes(opt)
    assert [c.__name__ for c in classes] == [c.__name__ for c in want_classes]
    assert phases == want_phases


def test_group_evaluator_flags_and_refusals():
    """``--evaluation_metrics`` and each selected evaluator's flags are added;
    every evaluator of ppst_tpu's, the serving ones included, runs on the
    loader; an unknown metric is an error."""
    parser = AugmentedArgumentParser()
    parser.custom_command = module_command("ppst_tpu_torch.train", [
        "--evaluation_metrics", "trainswap_visualization", "--swap_num_columns", "3"])
    GroupEvaluator.modify_commandline_options(parser, True)
    opt = parser.parse_args()
    assert opt.swap_num_columns == 3 and opt.swap_num_images == 16
    (ev,) = GroupEvaluator(opt).evaluators
    assert isinstance(ev, SwapVisualizationEvaluator) and ev.target_phase == "train"
    opt = SimpleNamespace(evaluation_metrics="none,content_style_1t1_generation,simple_swapping")
    assert [(type(e).__name__, e.target_phase) for e in GroupEvaluator(opt).evaluators] == [
        ("NoneEvaluator", "test"), ("ContentStyleGridGenerationEvaluator", "test"),
        ("SimpleSwappingEvaluator", "test")]
    with pytest.raises(ValueError, match="no evaluator"):
        find_evaluator_classes(SimpleNamespace(evaluation_metrics="fid"))


def test_ssim_psnr_lpips_match_jax(rng):
    """Within 1e-5 (SSIM, PSNR) and 1e-4 relative (LPIPS, the same random
    backbone carried over)."""
    a = rng.random((2, 24, 20, 3)).astype(np.float32)
    b = np.clip(a + rng.normal(0, 0.1, a.shape), 0, 1).astype(np.float32)
    b[1, :12] = 0.5  # a flat region: the clamped variances
    for name in ("ssim", "psnr"):
        got = getattr(metrics, name)(a, b).numpy()
        want = np.asarray(getattr(jax_metrics, name)(jnp.asarray(a), jnp.asarray(b)))
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5, err_msg=name)
    variables = jax_lpips.init_params()
    module = LPIPS()
    module.load_state_dict(lpips_from_flax(variables))
    x = rng.uniform(-1, 1, (2, 64, 64, 3)).astype(np.float32)
    y = rng.uniform(-1, 1, (2, 64, 64, 3)).astype(np.float32)
    got = metrics.lpips_distance(torch.from_numpy(x), torch.from_numpy(y), module).numpy()
    want = np.asarray(jax_metrics.lpips_distance(jnp.asarray(x), jnp.asarray(y), variables))
    np.testing.assert_allclose(got.ravel(), want.ravel(), rtol=1e-4)


@pytest.fixture(scope="module")
def models():
    """The port's NARROW model and ppst_tpu's with its weights. The noise
    gains are zero at init, so neither side's noise draws enter."""
    model = PPSTModel(PPSTConfig(**NARROW), device="cpu", seed=2)
    return model, JaxModel(JaxConfig(**NARROW), lpips_variables={}), jax_params(model)


def test_snapshot_visuals_match_jax(models, rng):
    """{real, layout, rec, mix} of a batch of 4 within 1e-3 of ppst_tpu's
    get_visuals_for_snapshot (layout: the structure code's PCA, resized)."""
    model, jmodel, params = models
    real = rng.uniform(-1, 1, (4, 64, 64, 3)).astype(np.float32)
    want = jmodel.get_visuals_for_snapshot(params, jnp.asarray(real), jax.random.PRNGKey(0))
    got = model.get_visuals_for_snapshot(torch.from_numpy(real))
    assert list(got) == list(want) == ["real", "layout", "rec", "mix"]
    for k in want:
        assert got[k].shape == want[k].shape, k
        err = np.abs(got[k].numpy() - np.asarray(want[k])).max()
        assert err <= 1e-3, (k, err)


def test_swap_grid_matches_jax(models, rng):
    """The (N+1) x (N+1) grid of 3 images within 2 uint8 levels of
    ppst_tpu's evaluator on its bundle with the same weights."""
    model, jmodel, params = models
    opt = SimpleNamespace(load_size=64, swap_num_columns=3, dtype="float32")
    images = [rng.uniform(-1, 1, (1, 64, 64, 3)).astype(np.float32) for _ in range(3)]
    bundle = JaxBundle.__new__(JaxBundle)
    bundle.model, bundle.params, bundle.rng = jmodel, params, jax.random.PRNGKey(0)
    want = JaxSwapVisualization(opt, "test").generate_mix_grid(bundle, images)
    got = SwapVisualizationEvaluator(opt, "test").generate_mix_grid(model, images)
    assert got.shape == want.shape == (256, 256, 3) and got.dtype == np.uint8
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 2


def test_test_cli_runs_swap_visualization(models, tmp_path, rng):
    """``python -m ppst_tpu_torch.test --evaluation_metrics
    swap_visualization,none`` over a folder: the GroupEvaluator on a
    test-phase loader writes the grid page; the loader's phase is restored
    around each evaluator."""
    data = tmp_path / "imgs"
    data.mkdir()
    for i in range(3):
        Image.fromarray((rng.random((70, 64, 3)) * 255).astype(np.uint8)).save(
            data / f"{i}.png")
    weights = tmp_path / "seed.pth"
    torch.save(models[0].state_dict(), weights)
    args = ["--device", "cpu", "--name", "ppst", "--checkpoint", str(weights),
            "--dataset_mode", "imagefolder", "--dataroot", str(data), "--load_size", "64",
            "--crop_size", "64", "--preprocess", "scale_width_and_crop", "--result_dir",
            str(tmp_path / "res"), "--swap_num_columns", "2", "--swap_num_images", "4",
            "--nThreads", "2", *WIDTH_FLAGS]
    test_cli.main(["--evaluation_metrics", "swap_visualization,none", *args])
    page = tmp_path / "res" / "ppst" / "results" / "swapvisualization" / "test_latest"
    assert (page / "index.html").is_file()
    grids = sorted((page / "images").glob("*.png"))
    # 3 images in grids of 2: one full grid, then the pass runs out after 1
    shapes = [np.asarray(Image.open(p)).shape for p in grids]
    assert shapes == [(192, 192, 3), (128, 128, 3)]
    for p in grids:
        assert len(np.unique(np.asarray(Image.open(p)))) > 2
    with pytest.raises(SystemExit):  # simple_swapping without its two images
        test_cli.main(["--evaluation_metrics", "swap_visualization,simple_swapping", *args])

    opt = PortTestOptions().parse(command=module_command(
        "ppst_tpu_torch.test", ["--name", "x", "--dataset_mode", "imagefolder", "--dataroot",
                                str(data), "--preprocess", "resize", "--load_size", "64"]))
    opt.phase, opt.evaluation_metrics = "train", "testnone"
    loader = ConfigurableDataLoader(opt)
    try:
        GroupEvaluator(opt).evaluate(models[0], loader)
        assert loader.phase == "train" and loader.repeat
    finally:
        loader.close()
