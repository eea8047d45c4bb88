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


# chip_smoke.py's CORR_BF16_MAX and CORR_BF16_MEAN: the card's check of the
# bf16 kernel against its plain version, in units of max|v|
CARD_BF16_MAX, CARD_BF16_MEAN = 1e-2, 2e-4


def _emulate_bf16_kernel(q, k, v, temperature, block=64):
    """The bf16 kernel's arithmetic, written out: keys in tiles of ``block``,
    float32 logits of bf16 q and k, exp2 with log2(e)/T folded into the
    exponent, a running max and sum in float32, P rounded to bf16 per tile
    for the P V product, and the output rounded once."""
    scale2 = torch.tensor((1.0 / temperature) * 1.4426950408889634, dtype=torch.float32)
    b, lq, _ = q.shape
    lk, cv = v.shape[1], v.shape[2]
    m = torch.full((b, lq, 1), float("-inf"))
    l = torch.zeros((b, lq, 1))
    o = torch.zeros((b, lq, cv))
    for k0 in range(0, lk, block):
        s = torch.matmul(q.float(), k[:, k0:k0 + block].float().transpose(1, 2))
        mx = torch.maximum(m, s.amax(-1, keepdim=True))
        corr = torch.exp2((m - mx) * scale2)
        p = torch.exp2(s * scale2 - mx * scale2)
        l = l * corr + p.sum(-1, keepdim=True)
        o = o * corr + torch.matmul(p.bfloat16().float(), v[:, k0:k0 + block].float())
        m = mx
    return (o / l).bfloat16()


@pytest.mark.parametrize("lq,lk,cv", [(1024, 1024, 32), (520, 1000, 256)])
def test_blocked_bf16_arithmetic_within_card_tolerance(rng, lq, lk, cv):
    """The kernel's blocked arithmetic against the plain version at C = 512,
    T = 0.01 on unit-norm descriptors (logits up to +-100), within the
    tolerances the card's check holds the kernel to; (520, 1000) has a ragged
    last key tile. Shows on the CPU that those tolerances have margin."""
    c = 512
    q = cw.normalize_desc(torch.from_numpy(rng.standard_normal((1, lq, c)).astype(np.float32)))
    k = cw.normalize_desc(torch.from_numpy(rng.standard_normal((1, lk, c)).astype(np.float32)))
    v = torch.from_numpy(rng.standard_normal((1, lk, cv)).astype(np.float32))
    q, k, v = q.bfloat16(), k.bfloat16(), v.bfloat16()
    got = _emulate_bf16_kernel(q, k, v, 0.01)
    want = cw.corr_warp_blockwise_reference(q, k, v, 0.01)
    vmax = v.float().abs().max().item()
    err = (got.float() - want.float()).abs()
    print(f"blocked bf16 arithmetic at ({lq}, {lk}, {c}, {cv}): max {err.max().item() / vmax:.2e}"
          f" max|v|, mean {err.mean().item() / vmax:.2e} max|v|")
    assert got.shape == want.shape and torch.isfinite(got.float()).all()
    assert err.max().item() <= CARD_BF16_MAX * vmax
    assert err.mean().item() <= CARD_BF16_MEAN * vmax


def _qkv(b, lq, lk, c, cv, dtype=torch.bfloat16):
    return (torch.zeros((b, lq, c), dtype=dtype), torch.zeros((b, lk, c), dtype=dtype),
            torch.zeros((b, lk, cv), dtype=dtype))


@pytest.mark.parametrize("shape,dtype", [
    ((1, 16384, 16384, 512, 32), torch.bfloat16),   # the 1024px path, narrowest E2 scale
    ((8, 4096, 4096, 512, 256), torch.bfloat16),    # the 512px grid's dispatch
    ((1, 200, 136, 512, 48), torch.bfloat16),       # chip_smoke.py's odd shape
    ((1, 64, 64, 8, 512), torch.bfloat16),          # Cv above 256: passes of 256 columns
    ((2, 300, 200, 288, 40), torch.float32),        # the float32 kernel
    ((1, 32, 32, 600, 12), torch.float32),          # float32 has no channel limit
])
def test_check_inputs_takes(shape, dtype):
    b, lq, lk, c, cv = shape
    assert cw.check_inputs(*_qkv(b, lq, lk, c, cv, dtype)) == (b, lq, c, lk, cv)


@pytest.mark.parametrize("args,match", [
    (_qkv(1, 64, 64, 520, 32), "C <= 512"),          # Q no longer fits in shared memory
    (_qkv(1, 64, 64, 100, 32), "multiples of 8"),    # TMA rows of 16-byte multiples
    (_qkv(1, 64, 64, 512, 12), "multiples of 8"),
    (_qkv(1, 64, 64, 512, 32)[:2] + (torch.zeros((1, 63, 32), dtype=torch.bfloat16),),
     "do not agree"),
    (_qkv(1, 64, 64, 512, 32)[:2] + (torch.zeros((1, 64, 32)),), "float32 or all bfloat16"),
    ((torch.zeros((64, 512)),) * 3, "3-D"),
    (_qkv(65536, 1, 1, 8, 8), "oversized"),
])
def test_check_inputs_refuses(args, match):
    """What the kernel does not take raises before any launch; the wrapper
    runs this check on every CUDA call."""
    with pytest.raises(ValueError, match=match):
        cw.check_inputs(*args)
