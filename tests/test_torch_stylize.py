"""The port's main paths end to end: ``stylize`` and ``stylize_fused`` against
``ppst_tpu.models.ppst.PPSTModel``'s, the bf16 fused-tap feature branch
against JAX's, and the ``python -m ppst_tpu_torch.test`` CLI on the CPU.

Weights are drawn by the port and carried over by ``convert_torch``. Their
noise gains are zero at init, so the two frameworks' noise draws do not
enter the comparison.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image
from test_torch_train_common import seed_checkpoint

from ppst_tpu.models.config import PPSTConfig as JaxConfig
from ppst_tpu.models.generator import Generator as JaxG
from ppst_tpu.models.ppst import PPSTModel as JaxModel
from ppst_tpu.util.convert_torch import convert_reference_state_dict
from ppst_tpu_torch import test as cli
from ppst_tpu_torch.models.config import PPSTConfig
from ppst_tpu_torch.models.ppst import PPSTModel

NARROW = dict(crop_size=64, netE_scale_capacity=0.25, netE2_scale_capacity=0.25,
              global_code_ch=64, spatial_code_ch=16, netG_resnet_ch=32,
              netG_scale_capacity=0.125)


def _pair(cfg_kw):
    model = PPSTModel(PPSTConfig(**cfg_kw), device="cpu")
    params = convert_reference_state_dict(
        {k: v.numpy() for k, v in model.state_dict().items()}, crop_size=cfg_kw["crop_size"])
    return model, params


@pytest.fixture(scope="module")
def f32_pair():
    model, params = _pair(NARROW)
    return model, JaxModel(JaxConfig(**NARROW), lpips_variables={}), params


@pytest.mark.parametrize("alpha,smooth", [(1.0, True), (0.5, False)])
def test_stylize_matches_jax_f32(f32_pair, rng, alpha, smooth):
    model, jmodel, params = f32_pair
    content = rng.uniform(-1, 1, (2, 64, 64, 3)).astype(np.float32)
    style = rng.uniform(-1, 1, (2, 64, 64, 3)).astype(np.float32)
    want = jmodel.stylize(params, jnp.asarray(content), jnp.asarray(style),
                          jax.random.PRNGKey(0), alpha=alpha, smooth_target=smooth)
    got = model.stylize(torch.from_numpy(content), torch.from_numpy(style),
                        torch.Generator().manual_seed(0), alpha=alpha, smooth_target=smooth)
    assert got.shape == (2, 64, 64, 3) and got.dtype == torch.float32
    # target 1e-3 on the [-1, 1] output; float32 sums in other orders through
    # ~60 layers, a T = 0.01 softmax and the guided filter
    err = np.abs(got.numpy() - np.asarray(want))
    assert err.max() <= 1e-3, err.max()


@pytest.mark.parametrize("smooth", [True, False])
def test_stylize_fused_matches_jax_f32(f32_pair, rng, smooth):
    """The blockwise path: the port's plain K3 against JAX's Pallas kernel in
    interpret mode, inside the whole pipeline."""
    model, jmodel, params = f32_pair
    content = rng.uniform(-1, 1, (2, 64, 64, 3)).astype(np.float32)
    style = rng.uniform(-1, 1, (2, 64, 64, 3)).astype(np.float32)
    want = jmodel.stylize_fused(params, jnp.asarray(content), jnp.asarray(style),
                                jax.random.PRNGKey(0), smooth_target=smooth)
    got = model.stylize_fused(torch.from_numpy(content), torch.from_numpy(style),
                              torch.Generator().manual_seed(0), smooth_target=smooth)
    assert got.shape == (2, 64, 64, 3) and got.dtype == torch.float32
    # the tolerance of test_stylize_matches_jax_f32
    err = np.abs(got.numpy() - np.asarray(want))
    assert err.max() <= 1e-3, err.max()


def test_feature_branch_bf16_fused_tap_matches_jax(rng):
    """G's feature branch in bf16 with fused_tap: the JAX side runs its Pallas
    tap (interpret mode) under ``jax.jit`` with its parameters as JAX arrays,
    as the JAX package runs; the port runs its tap's plain version.

    (Parameters left as numpy arrays would not test JAX's bf16 path: there
    ``numpy_bf16_weight * python_float`` promotes to float32, and from the
    first style modulation on the JAX generator runs in float32.)

    Two bf16 computations of this depth differ by about as much as each
    differs from float32: JAX eager against JAX jit differs by 2.26% mean /
    15.4% max of the output's RMS, the port against JAX jit by 2.30% / 17.0%
    (rgb; feat and feat1 1.94-1.97% / 12-17%). The bound is the largest of
    these readings with a margin of 30%: 3% on average, 22% at worst."""
    kw = dict(NARROW, fused_tap=True)
    model, params = _pair(kw)
    cfg = JaxConfig(**kw)
    sp = rng.standard_normal((2, 8, 8, cfg.spatial_code_ch)).astype(np.float32)
    gl = [rng.standard_normal((2, cfg.style_dim)).astype(np.float32) for _ in range(4)]
    g_params = jax.tree.map(jnp.asarray, params["G"])
    want = jax.jit(lambda p, s, g: JaxG(cfg).apply(
        {"params": p}, s, g, extract_features=True, rngs={"noise": jax.random.PRNGKey(0)}))(
        g_params, jnp.asarray(sp).astype(jnp.bfloat16),
        [jnp.asarray(g).astype(jnp.bfloat16) for g in gl])
    with torch.no_grad():
        got = model.G(torch.from_numpy(sp).bfloat16(),
                      [torch.from_numpy(g).bfloat16() for g in gl], extract_features=True)
    for name, a, b in zip(("rgb", "feat", "feat1"), got, want):
        assert a.dtype == torch.bfloat16 and b.dtype == jnp.bfloat16
        a, b = a.float().numpy(), np.asarray(b.astype(jnp.float32))
        rms = np.sqrt(np.mean(b * b))
        err = np.abs(a - b)
        assert err.max() <= 0.22 * rms and err.mean() <= 0.03 * rms, (
            name, err.max(), err.mean(), rms)


def _cli_args(tmp_path, rng):
    paths = []
    for name in ("content", "style"):
        arr = (rng.random((80, 72, 3)) * 255).astype(np.uint8)
        p = tmp_path / f"{name}.png"
        Image.fromarray(arr).save(p)
        paths.append(str(p))
    return ["--name", "ppst", "--evaluation_metrics", "simple_swapping",
            "--input_structure_image", paths[0], "--input_texture_image", paths[1],
            "--preprocess", "resize", "--load_size", "64", "--crop_size", "64",
            "--result_dir", str(tmp_path / "results"),
            "--checkpoint", seed_checkpoint(tmp_path / "seed.pth", crop_size=64)]


def test_cli_writes_png_on_cpu(tmp_path, rng):
    """Full-width model at crop 64, bf16 with the fused tap (its plain
    version on the CPU), two texture mix alphas."""
    (ev,) = cli.main(_cli_args(tmp_path, rng) + [
        "--device", "cpu", "--dtype", "bfloat16", "--fused_tap", "true",
        "--texture_mix_alphas", "0.5", "1.0"]).evaluators
    out = ev.paths
    assert [p.rsplit("/", 1)[1] for p in out] == ["content_style_0.50.png",
                                                   "content_style_1.00.png"]
    for p in out:
        img = np.asarray(Image.open(p))
        assert img.shape == (64, 64, 3)


def test_cli_refuses_cpu_fallback(tmp_path, rng, monkeypatch):
    """Without --device cpu and without a card, the CLI raises instead of
    running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        cli.main(_cli_args(tmp_path, rng))
    assert not (tmp_path / "results").exists()
