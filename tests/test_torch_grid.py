"""The port's grid serving (``grid_extract`` + ``grid_pairs``, dense and
blockwise) against ppst_tpu's, against the port's own per-pair pipeline, and
the grid evaluator CLI end to end on the CPU.

Noise is pinned with ``make_fixed_noise`` arrays drawn by the port and handed
to both sides, with nonzero noise gains, so batch composition cannot change
the draws (as ``tests/test_grid_serving.py`` does).
"""

import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image
from test_torch_train_common import NARROW_G as NARROW
from test_torch_train_common import seed_checkpoint

from ppst_tpu.models.config import PPSTConfig as JaxConfig
from ppst_tpu.models.ppst import PPSTModel as JaxModel
from ppst_tpu.util.convert_torch import convert_reference_state_dict
from ppst_tpu_torch import test as cli
from ppst_tpu_torch.evaluation.content_style_grid_generation_evaluator import (
    ContentStyleGridGenerationEvaluator,
)
from ppst_tpu_torch.models.config import PPSTConfig
from ppst_tpu_torch.models.generator import make_fixed_noise
from ppst_tpu_torch.models.ppst import PPSTModel, take_rows
from ppst_tpu_torch.nn.layers import NoiseInjection
from ppst_tpu_torch.util.util import tensor2im

CROP = 64
CI, SI = [0, 0, 1, 1], [0, 1, 0, 1]
ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def grid():
    model = PPSTModel(PPSTConfig(**NARROW), device="cpu")
    with torch.no_grad():
        for i, m in enumerate(mod for mod in model.modules() if isinstance(mod, NoiseInjection)):
            m.weight.fill_(0.1 + 0.05 * i)
    params = convert_reference_state_dict({k: v.numpy() for k, v in model.state_dict().items()},
                                          crop_size=64)
    imgs = torch.from_numpy(
        np.random.default_rng(0).standard_normal((4, CROP, CROP, 3)).astype(np.float32) * 0.3)
    n_ext = make_fixed_noise(model.cfg, torch.Generator().manual_seed(5), 4, CROP)
    n_dec = make_fixed_noise(model.cfg, torch.Generator().manual_seed(6), 4, CROP)
    return model, JaxModel(JaxConfig(**NARROW), lpips_variables={}), params, imgs, n_ext, n_dec


def _banks(bank):
    return ({k: take_rows(v, slice(None, 2)) for k, v in bank.items()},
            {k: take_rows(v, slice(2, None)) for k, v in bank.items()})


@pytest.fixture(scope="module")
def jax_banks(grid):
    """JAX's content and style banks from the same images and noise."""
    _, jmodel, params, imgs, n_ext, _ = grid
    bank = jax.jit(lambda p, x, n: jmodel.grid_extract(p, x, jax.random.PRNGKey(1), noises=n))(
        params, jnp.asarray(imgs.numpy()), [jnp.asarray(n.numpy()) for n in n_ext])
    return tuple(jax.tree.map(lambda a, s=s: a[s], bank) for s in (slice(None, 2), slice(2, None)))


@pytest.mark.parametrize("blockwise", [False, True])
def test_grid_pairs_match_jax(grid, jax_banks, blockwise):
    """4 pairs over 2 contents x 2 styles, with the guided filter; within the
    1e-3 of the float32 stylize tests."""
    model, jmodel, params, imgs, n_ext, n_dec = grid
    c_bank, s_bank = _banks(model.grid_extract(imgs, noises=n_ext))
    got = model.grid_pairs(c_bank, s_bank, CI, SI, smooth_target=imgs[:2], noises=n_dec,
                           blockwise=blockwise)
    want = jax.jit(lambda p, cb, sb, t, n: jmodel.grid_pairs(
        p, cb, sb, jnp.asarray(CI), jnp.asarray(SI), jax.random.PRNGKey(2), smooth_target=t,
        noises=n, blockwise=blockwise))(params, *jax_banks, jnp.asarray(imgs[:2].numpy()),
                                        [jnp.asarray(n.numpy()) for n in n_dec])
    assert got.shape == (4, CROP, CROP, 3)
    err = np.abs(got.numpy() - np.asarray(want))
    assert err.max() <= 1e-3, err.max()


def test_grid_pairs_match_per_pair_pipeline(grid):
    """Batched pairs against the port's per-pair pipeline: per-image
    extraction with the same noise rows and E2 recomputed in full from the
    style image (what the reference's encode2 does), as
    tests/test_grid_serving.py holds the JAX package."""
    model, _, _, imgs, n_ext, n_dec = grid
    c_bank, s_bank = _banks(model.grid_extract(imgs, noises=n_ext))
    out = model.grid_pairs(c_bank, s_bank, CI, SI, smooth_target=imgs[:2], noises=n_dec)
    for k, (c, s) in enumerate(zip(CI, SI)):
        ext_c = model.grid_extract(imgs[c : c + 1], noises=[n[c : c + 1] for n in n_ext])
        ext_s = model.grid_extract(imgs[2 + s : 3 + s],
                                   noises=[n[2 + s : 3 + s] for n in n_ext])
        corr = model.corrm(ext_s["desc"], ext_c["desc"])
        _, gl_w = model.encode2(imgs[2 + s : 3 + s], corr, corr_out_hw=(CROP // 8, CROP // 8))
        want = model.decode(ext_c["sp"], gl_w, target=imgs[c : c + 1],
                            noises=[n[k : k + 1] for n in n_dec])
        np.testing.assert_allclose(out[k : k + 1].numpy(), want.numpy(), atol=2e-4, rtol=1e-4,
                                   err_msg=f"grid pair {k} (content {c}, style {s})")


def test_to_uint8_matches_tensor2im():
    x = torch.linspace(-1.3, 1.3, 2 * 5 * 7 * 3).reshape(2, 5, 7, 3)
    for dt in (torch.float32, torch.bfloat16):
        got = PPSTModel.to_uint8(x.to(dt))
        assert got.dtype == torch.uint8
        np.testing.assert_array_equal(got.numpy(), tensor2im(x.to(dt)))


def _folder(root, sizes):
    """content/ and style/ PNGs of the given (h, w) sizes."""
    rng = np.random.default_rng(0)
    for sub, hw in sizes:
        for i, (h, w) in enumerate(hw):
            (root / sub).mkdir(parents=True, exist_ok=True)
            arr = (rng.random((h, w, 3)) * 255).astype(np.uint8)
            Image.fromarray(arr).save(root / sub / f"{sub}{i}.png")
    return root


def _grid_args(tmp_path, data, *extra):
    return ["--name", "ppst", "--dataset_mode", "imagefolder", "--dataroot", str(data),
            "--evaluation_metrics", "content_style_1t1_generation", "--load_size", "64",
            "--crop_size", "64", "--result_dir", str(tmp_path / "results"),
            "--checkpoint", seed_checkpoint(tmp_path / "seed.pth", crop_size=CROP), *extra]


def test_grid_cli_writes_page_on_cpu(tmp_path):
    """``python -m ppst_tpu_torch.test`` on 2 contents x 2 styles of 64px:
    the batched path, full width, bf16 with the fused tap's plain version."""
    data = _folder(tmp_path / "imgs", [("content", [(64, 64)] * 2), ("style", [(64, 64)] * 2)])
    subprocess.run([sys.executable, "-m", "ppst_tpu_torch.test", "--device", "cpu",
                    "--dtype", "bfloat16", "--fused_tap", "true", "--preprocess", "resize",
                    *_grid_args(tmp_path, data)], cwd=ROOT, check=True, timeout=300)
    results = tmp_path / "results"
    assert list(results.rglob("index.html")), "no HTML grid written"
    imgs = list(results.rglob("*.png"))
    # 2 contents x 2 styles + the 2 contents, the 2 styles and the blank
    assert len(imgs) >= 7
    for p in imgs:
        assert np.asarray(Image.open(p)).shape == (64, 64, 3)


def test_grid_cli_mixed_shapes_run_per_pair(tmp_path, monkeypatch):
    """Images of two shapes take the per-pair path."""
    calls = []
    per_pair = ContentStyleGridGenerationEvaluator._evaluate_pairwise
    monkeypatch.setattr(ContentStyleGridGenerationEvaluator, "_evaluate_pairwise",
                        lambda self, *a: calls.append(1) or per_pair(self, *a))
    data = _folder(tmp_path / "imgs", [("content", [(64, 80)]), ("style", [(64, 64)] * 2)])
    (ev,) = cli.main(["--device", "cpu", "--preprocess", "scale_shortside", "--batch_size",
                      "1", *_grid_args(tmp_path, data)]).evaluators
    assert calls == [1] and Path(ev.page).exists()
    shapes = sorted(np.asarray(Image.open(p)).shape
                    for p in (tmp_path / "results").rglob("*.png"))
    # blank + 2 styles at 64x64; the content and its 2 stylizations at 64x80
    assert shapes == [(64, 64, 3)] * 3 + [(64, 80, 3)] * 3


def test_grid_cli_refuses_cpu_fallback(tmp_path, monkeypatch):
    """Without --device cpu and without a card, the grid CLI raises and
    writes nothing."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    data = _folder(tmp_path / "imgs", [("content", [(64, 64)]), ("style", [(64, 64)])])
    with pytest.raises(RuntimeError, match="--device cpu"):
        cli.main(_grid_args(tmp_path, data))
    assert not (tmp_path / "results").exists()
