"""The port's E1, E2 and G against ppst_tpu's in float32 on the CPU, at crop
64 with the default depths and narrow widths. Weights are drawn by the port
and carried over by ``convert_reference_state_dict``; G's noise gains are
set nonzero and its noise is pinned with the same numpy arrays on both
sides."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ppst_tpu.models.config import PPSTConfig as JaxConfig
from ppst_tpu.models.encoder_col import ColorEncoder as JaxE2
from ppst_tpu.models.encoder_con import ContentEncoder as JaxE1
from ppst_tpu.models.generator import Generator as JaxG
from ppst_tpu.util.convert_torch import convert_reference_state_dict
from ppst_tpu_torch.models.config import PPSTConfig
from ppst_tpu_torch.models.generator import make_fixed_noise
from ppst_tpu_torch.models.ppst import PPSTModel
from ppst_tpu_torch.nn.layers import NoiseInjection

NARROW = dict(crop_size=64, netE_scale_capacity=0.25, netE2_scale_capacity=0.25,
              global_code_ch=64, spatial_code_ch=16, netG_resnet_ch=32,
              netG_scale_capacity=0.125)
B, S, GRID = 2, 64, 8
# float32 through ~30 convs and instance norms; sums run in other orders
TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module")
def nets():
    model = PPSTModel(PPSTConfig(**NARROW), device="cpu")
    with torch.no_grad():
        for i, m in enumerate(mod for mod in model.modules()
                              if isinstance(mod, NoiseInjection)):
            m.weight.fill_(0.1 + 0.05 * i)
    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    return model, convert_reference_state_dict(sd, crop_size=64), JaxConfig(**NARROW)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **tol)


def test_e1(nets, rng):
    model, params, cfg = nets
    x = rng.uniform(-1, 1, (B, S, S, 3)).astype(np.float32)
    want = JaxE1(cfg).apply({"params": params["E1"]}, jnp.asarray(x))
    with torch.no_grad():
        got = model.E1(torch.from_numpy(x))
    assert got.shape == (B, GRID, GRID, cfg.spatial_code_ch)
    _close(got, want)


@pytest.mark.parametrize("content_grid", [None, (6, 6)])
def test_e2_vectors_trunk_and_warp(nets, rng, content_grid):
    """Plain vectors and trunk, then the warp stage from the cached trunk in
    warped_only mode, with a square correspondence or a smaller content
    grid (corr_out_hw)."""
    model, params, cfg = nets
    e2 = JaxE2(cfg)
    x = rng.uniform(-1, 1, (B, S, S, 3)).astype(np.float32)
    lq = GRID * GRID if content_grid is None else content_grid[0] * content_grid[1]
    logits = rng.standard_normal((B, lq, GRID * GRID)).astype(np.float32) * 3
    corr = np.array(jax.nn.softmax(jnp.asarray(logits), -1))
    variables = {"params": params["E2"]}

    want, want_trunk = e2.apply(variables, jnp.asarray(x), return_trunk=True)
    want_w = e2.apply(variables, None, corrmatrix=jnp.asarray(corr), trunk=want_trunk,
                      corr_out_hw=content_grid, warped_only=True)
    with torch.no_grad():
        got, trunk = model.E2(torch.from_numpy(x), return_trunk=True)
        got_w = model.E2(None, corrmatrix=torch.from_numpy(corr), trunk=trunk,
                         corr_out_hw=content_grid, warped_only=True)
    assert len(got.vectors) == 4 and got_w.vectors == () and len(got_w.vectors_w) == 4
    for a, b in zip(trunk, want_trunk):
        _close(a, b)
    for a, b in zip(got.vectors + got_w.vectors_w, want.vectors + want_w.vectors_w):
        assert a.shape == (B, cfg.style_dim)
        _close(a, b)


def test_generator_rgb_and_features(nets, rng):
    model, params, cfg = nets
    sp = rng.standard_normal((B, GRID, GRID, cfg.spatial_code_ch)).astype(np.float32)
    gl = [rng.standard_normal((B, cfg.style_dim)).astype(np.float32) for _ in range(4)]
    noises = [rng.standard_normal(tuple(n.shape)).astype(np.float32)
              for n in make_fixed_noise(PPSTConfig(**NARROW), torch.Generator(), B, S)]
    rgb, feat, feat1 = JaxG(cfg).apply(
        {"params": params["G"]}, jnp.asarray(sp), [jnp.asarray(g) for g in gl],
        extract_features=True, noises=[jnp.asarray(n) for n in noises])
    with torch.no_grad():
        got = model.G(torch.from_numpy(sp), [torch.from_numpy(g) for g in gl],
                      extract_features=True, noises=[torch.from_numpy(n) for n in noises])
    assert got[0].shape == (B, S, S, 3)
    assert got[1].shape == (B, GRID, GRID, cfg.g_fuse_ch)
    assert got[2].shape == (B, 4 * GRID, 4 * GRID, cfg.netG_resnet_ch // 4)
    for a, b in zip(got, (rgb, feat, feat1)):
        _close(a, b)
    # the noise is live: another draw moves the image
    with torch.no_grad():
        other = model.G(torch.from_numpy(sp), [torch.from_numpy(g) for g in gl],
                        generator=torch.Generator().manual_seed(1))
    assert (other - got[0]).abs().max() > 1e-3
