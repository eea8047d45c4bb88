"""The port's blockwise correspondence warp (K3) and E2's ``corr_qk`` route
against ppst_tpu's on the CPU.

On the CPU the port's ``corr_warp_blockwise`` runs its plain PyTorch version;
the JAX side runs its Pallas kernel in interpret mode, as
``tests/test_corr_pallas.py`` does. The CUDA kernel itself is held against
the plain version on the card by ``chip_smoke.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ppst_tpu.models.config import PPSTConfig as JaxConfig
from ppst_tpu.models.encoder_col import ColorEncoder as JaxE2
from ppst_tpu.ops import corr_pallas as jcp
from ppst_tpu.util.convert_torch import _SD, convert_e2
from ppst_tpu_torch.models.config import PPSTConfig
from ppst_tpu_torch.models.encoder_col import ColorEncoder
from ppst_tpu_torch.nn.layers import init_weights
from ppst_tpu_torch.ops import corr_warp_cuda as cw
from ppst_tpu_torch.ops.corr import corrm

# float32 through a T = 0.01 softmax, sums in other orders (as
# tests/test_corr_pallas.py::test_matches_dense_path)
TOL = dict(rtol=2e-4, atol=2e-5)


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


@pytest.mark.parametrize("fn", [cw.corr_warp_blockwise_reference, cw.corr_warp_blockwise])
def test_matches_jax_blockwise(rng, fn):
    """(2, 256, 64) with Cv 32; JAX runs its kernel with blocks 128 x 64."""
    b, l, c, cv = 2, 256, 64, 32
    q = jcp._normalize_desc(jnp.asarray(rng.standard_normal((b, l, c)), jnp.float32), split=32)
    k = jcp._normalize_desc(jnp.asarray(rng.standard_normal((b, l, c)), jnp.float32), split=32)
    v = rng.standard_normal((b, l, cv)).astype(np.float32)
    want = jcp.corr_warp_blockwise(q, k, jnp.asarray(v), block_q=128, block_k=64)
    got = fn(_t(q), _t(k), _t(v))
    assert got.shape == (b, l, cv) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("content_hw,style_hw,c,cv", [
    ((16, 16), (16, 16), 64, 32),
    ((16, 8), (8, 8), 512, 16),  # the content and style grids differ at inference
])
def test_fused_corr_warp_matches_jax(rng, content_hw, style_hw, c, cv):
    fea = rng.standard_normal((1, *style_hw, c)).astype(np.float32)
    fea0 = rng.standard_normal((1, *content_hw, c)).astype(np.float32)
    vals = rng.standard_normal((1, *style_hw, cv)).astype(np.float32)
    want = jcp.fused_corr_warp(jnp.asarray(fea), jnp.asarray(fea0), jnp.asarray(vals),
                               block_q=64, block_k=32)
    got = cw.fused_corr_warp(_t(fea), _t(fea0), _t(vals))
    assert got.shape == (1, *content_hw, cv)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_awkward_length_matches_jax_dense_fallback(rng):
    """L = 100 is no multiple of JAX's blocks, so JAX takes its dense
    fallback; the port's plain version is the same function."""
    b, l, c, cv = 1, 100, 32, 8
    q, k = (jcp._normalize_desc(jnp.asarray(rng.standard_normal((b, l, c)), jnp.float32))
            for _ in range(2))
    v = rng.standard_normal((b, l, cv)).astype(np.float32)
    want = jcp.corr_warp_blockwise(q, k, jnp.asarray(v))
    got = cw.corr_warp_blockwise(_t(q), _t(k), _t(v))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_normalize_desc_matches_jax(rng, dtype):
    """float32 within float32 rounding; bfloat16 within one bf16 step of the
    result (2^-8 of values below 1 in magnitude), since the port rounds once
    at the end and JAX's eager bf16 ops round on the way."""
    x = (rng.standard_normal((2, 64, 288)) * 3 + 0.5).astype(np.float32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    want = np.asarray(jcp._normalize_desc(jnp.asarray(x).astype(jdt)).astype(jnp.float32))
    got = cw.normalize_desc(_t(x).to(tdt))
    assert got.dtype == tdt
    atol = 1e-6 if dtype == "float32" else 2.0**-8
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0, atol=atol)


def test_wrapper_refuses_other_devices():
    """Off the CPU there is no plain-version path: a device the kernel does
    not serve raises."""
    q = torch.empty((1, 8, 16), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        cw.corr_warp_blockwise(q, q, q)


@pytest.fixture(scope="module")
def e2_pair():
    """Full-width E2 at crop 128: port weights carried to JAX."""
    cfg = PPSTConfig(crop_size=128)
    e2 = ColorEncoder(cfg)
    init_weights(e2, torch.Generator().manual_seed(0))
    params = convert_e2(_SD({k: v.numpy() for k, v in e2.state_dict().items()}))
    return e2, JaxE2(JaxConfig(crop_size=128)), params


def test_e2_corr_qk_matches_corrmatrix_and_jax(e2_pair, rng):
    """E2's corr_qk route against its own dense corrmatrix route and against
    JAX's corr_qk route (tolerance of
    tests/test_corr_pallas.py::test_e2_corr_qk_matches_corrmatrix)."""
    e2, je2, params = e2_pair
    x = rng.standard_normal((2, 128, 128, 3)).astype(np.float32)
    desc = rng.standard_normal((2, 16, 16, 512)).astype(np.float32)
    desc0 = rng.standard_normal((2, 16, 16, 512)).astype(np.float32)
    q = cw.normalize_desc(_t(desc0).reshape(2, 256, 512))
    k = cw.normalize_desc(_t(desc).reshape(2, 256, 512))
    with torch.no_grad():
        fused = e2(_t(x), corr_qk=(q, k), corr_out_hw=(16, 16)).vectors_w
        dense = e2(_t(x), corrmatrix=corrm(_t(desc), _t(desc0))).vectors_w
    jq = jcp._normalize_desc(jnp.asarray(desc0).reshape(2, 256, 512))
    jk = jcp._normalize_desc(jnp.asarray(desc).reshape(2, 256, 512))
    want = je2.apply({"params": params}, jnp.asarray(x), corr_qk=(jq, jk),
                     corr_out_hw=(16, 16)).vectors_w
    assert len(fused) == len(dense) == len(want) == 4
    for a, d, w in zip(fused, dense, want):
        np.testing.assert_allclose(a.numpy(), d.numpy(), rtol=2e-3, atol=2e-4)
        np.testing.assert_allclose(a.numpy(), np.asarray(w), rtol=2e-3, atol=2e-4)
