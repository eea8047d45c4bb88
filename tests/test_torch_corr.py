"""The port's correspondence ops and guided filter against ppst_tpu's, on
the CPU, with inputs from numpy."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ppst_tpu.ops import corr as jc
from ppst_tpu.ops.guided_filter import guided_filter as jax_guided_filter
from ppst_tpu_torch.ops import corr as tc
from ppst_tpu_torch.ops.guided_filter import guided_filter

# float32: sums in other orders; values of size ~1 agree to ~1e-6
TOL = dict(rtol=1e-5, atol=1e-5)


def _rand(rng, shape):
    return rng.standard_normal(shape).astype(np.float32)


def _both(x, dtype="float32"):
    return jnp.asarray(x).astype(dtype), torch.from_numpy(x).to(getattr(torch, dtype))


def _np(v):
    if isinstance(v, torch.Tensor):
        return v.float().numpy()
    return np.asarray(v.astype(jnp.float32))


def test_rselfcorr(rng):
    xj, xt = _both(_rand(rng, (2, 16, 16, 8)))
    np.testing.assert_allclose(_np(tc.rselfcorr(xt)), _np(jc.rselfcorr(xj)), **TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_corrm(rng, dtype):
    """bf16: the logits must be float32 products of the bf16-rounded
    descriptors; bf16 logits at T = 0.01 would be off by up to ~0.8 and move
    the softmax far beyond one bf16 step of its output."""
    fea, fea0 = _rand(rng, (2, 8, 8, 40)), _rand(rng, (2, 8, 8, 40))
    (fj, ft), (f0j, f0t) = _both(fea, dtype), _both(fea0, dtype)
    want = _np(jc.corrm(fj, f0j, split=24))
    got = _np(tc.corrm(ft, f0t, split=24))
    tol = TOL if dtype == "float32" else dict(rtol=1e-2, atol=2e-3)
    np.testing.assert_allclose(got, want, **tol)
    np.testing.assert_allclose(got.sum(-1), 1.0, atol=1e-5 if dtype == "float32" else 0.05)


@pytest.mark.parametrize("case", ["flat", "flat_out_hw", "block"])
def test_warp(rng, case):
    if case == "flat":
        fea, lq, lk, out_hw = _rand(rng, (2, 6, 6, 5)), 36, 36, None
    elif case == "flat_out_hw":
        fea, lq, lk, out_hw = _rand(rng, (2, 6, 6, 5)), 24, 36, (4, 6)
    else:  # 2x2 blocks moving as units
        fea, lq, lk, out_hw = _rand(rng, (2, 12, 12, 5)), 36, 36, None
    corr = rng.random((2, lq, lk)).astype(np.float32)
    corr /= corr.sum(-1, keepdims=True)
    want = jc.warp(jnp.asarray(fea), jnp.asarray(corr), out_hw=out_hw)
    got = tc.warp(torch.from_numpy(fea), torch.from_numpy(corr), out_hw=out_hw)
    np.testing.assert_allclose(_np(got), _np(want), **TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_adaptive_avg_pool(rng, dtype):
    xj, xt = _both(_rand(rng, (2, 16, 12, 3)), dtype)
    want = _np(jc.adaptive_avg_pool(xj, (4, 3)))
    got = _np(tc.adaptive_avg_pool(xt, (4, 3)))
    # bf16: both round after each axis; the float32 sums differ in order only
    tol = TOL if dtype == "float32" else dict(rtol=8e-3, atol=8e-3)
    np.testing.assert_allclose(got, want, **tol)


@pytest.mark.parametrize("out_hw", [(16, 16), (32, 32), (4, 4), (8, 8), (12, 20)])
def test_resize_bilinear(rng, out_hw):
    """Upscales, the exact 2x downscale (mean pooling), identity, and a
    non-integer resize, all without antialiasing."""
    xj, xt = _both(_rand(rng, (2, 8, 8, 3)))
    np.testing.assert_allclose(_np(tc.resize_bilinear(xt, out_hw)),
                               _np(jc.resize_bilinear(xj, out_hw)), **TOL)


def test_warp_resize(rng):
    fea = _rand(rng, (2, 16, 16, 4))
    corr = rng.random((2, 16, 16)).astype(np.float32)
    corr /= corr.sum(-1, keepdims=True)
    want = jc.warp_resize(jnp.asarray(fea), jnp.asarray(corr))
    got = tc.warp_resize(torch.from_numpy(fea), torch.from_numpy(corr))
    np.testing.assert_allclose(_np(got), _np(want), **TOL)


def test_guided_filter(rng):
    """The reference's settings (radius 30, eps (0.02*255)^2) on 0..255
    images larger than the window, so border windows are truncated."""
    guide = (rng.random((2, 72, 64, 3)) * 255).astype(np.float32)
    src = (rng.random((2, 72, 64, 3)) * 255).astype(np.float32)
    want = np.asarray(jax_guided_filter(jnp.asarray(guide), jnp.asarray(src)))
    got = guided_filter(torch.from_numpy(guide), torch.from_numpy(src)).numpy()
    # values of size ~100 through a 3x3 solve per pixel; float32 sums
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=2e-3)
