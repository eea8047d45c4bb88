"""The port's differentiable blockwise correspondence (``ops.corr_blockwise``,
the 1024px training route) against ppst_tpu's, in values and in the
gradients of q, k and v, and against the port's own dense ``corrm`` +
``warp`` (mirrors tests/test_corr_blockwise.py). Float32 on the CPU.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ppst_tpu.ops import corr_blockwise as jcb
from ppst_tpu_torch.models.config import PPSTConfig
from ppst_tpu_torch.models.encoder_col import ColorEncoder
from ppst_tpu_torch.nn.layers import init_weights
from ppst_tpu_torch.ops import corr_blockwise as cb
from ppst_tpu_torch.ops.corr import corrm, warp

NARROW_E2 = dict(crop_size=64, netE2_scale_capacity=0.25, global_code_ch=64)


def _close_to_max(got, want, name, rel=1e-4):
    """Within ``rel`` of the largest |want|: float32 sums in another order
    than XLA's, which the backward of the T = 0.01 softmax amplifies by 1/T
    (measured: 1.8e-5 of the largest q gradient)."""
    err = np.abs(got - want).max()
    assert err <= rel * np.abs(want).max(), (name, err, np.abs(want).max())


def _t(x):
    return torch.from_numpy(np.array(x)).requires_grad_(True)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_normalize_desc_matches_jax(rng, dtype):
    """Centred head of ``split`` channels, L2 over channels in float32, one
    rounding to the input dtype: equal to JAX's up to float32 rounding."""
    fea = rng.standard_normal((2, 4, 6, 24)).astype(np.float32)
    x = torch.from_numpy(fea).to(getattr(torch, dtype))
    want = np.asarray(jcb.normalize_desc(jnp.asarray(x.float().numpy()).astype(dtype), split=8),
                      np.float32)
    got = cb.normalize_desc(x, split=8)
    assert got.shape == (2, 24, 24) and got.dtype == x.dtype
    tol = 1e-6 if dtype == "float32" else 2.0**-8
    np.testing.assert_allclose(got.float().numpy(), want, rtol=tol, atol=1e-6)


@pytest.mark.parametrize("block", [16, 64, 24])
def test_corr_warp_scan_matches_jax_values_and_grads(rng, block):
    """softmax(q k^T / T) v by row blocks of 16 (four blocks), 64 (one) and
    24 (does not divide Lq = 64: one block, as in JAX), value and the
    gradients of sum(out * w) for q, k and v."""
    b, lq, lk, c, cv = 2, 64, 48, 24, 6
    q = np.asarray(jcb.normalize_desc(jnp.asarray(rng.standard_normal((b, 8, 8, c)),
                                                  jnp.float32), split=8))
    k = np.asarray(jcb.normalize_desc(jnp.asarray(rng.standard_normal((b, 6, 8, c)),
                                                  jnp.float32), split=8))
    v = rng.standard_normal((b, lk, cv)).astype(np.float32)
    w = rng.standard_normal((b, lq, cv)).astype(np.float32)

    def jloss(q, k, v):
        return jnp.sum(jcb.corr_warp_scan(q, k, v, block=block) * w)

    val, grads = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1, 2)))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tq, tk, tv = _t(q), _t(k), _t(v)
    out = cb.corr_warp_scan(tq, tk, tv, block=block)
    loss = (out * torch.from_numpy(w)).sum()
    loss.backward()
    assert out.shape == (b, lq, cv)
    np.testing.assert_allclose(loss.item(), float(val), rtol=1e-5)
    for name, a, g in (("q", tq, grads[0]), ("k", tk, grads[1]), ("v", tv, grads[2])):
        _close_to_max(a.grad.numpy(), np.asarray(g), name)


def test_corr_warp_scan_matches_port_dense_values_and_grads(rng):
    """The scan (four blocks) against the port's dense corrm + warp on the
    same features, values and gradients (tests/test_corr_blockwise.py's
    first test, in the port)."""
    b, g, c, cv = 2, 8, 24, 6
    fea = _t(rng.standard_normal((b, g, g, c)).astype(np.float32))
    fea0 = _t(rng.standard_normal((b, g, g, c)).astype(np.float32))
    v = _t(rng.standard_normal((b, g * g, cv)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((b, g * g, cv)).astype(np.float32))

    def grads(fn):
        for t in (fea, fea0, v):
            t.grad = None
        val = fn()
        val.backward()
        return val.item(), [t.grad.clone() for t in (fea, fea0, v)]

    vd, gd = grads(lambda: (warp(v.reshape(b, g, g, cv), corrm(fea, fea0, split=8))
                            .reshape(b, -1, cv) * w).sum())
    vb, gb = grads(lambda: (cb.corr_warp_scan(cb.normalize_desc(fea0, split=8),
                                              cb.normalize_desc(fea, split=8), v, block=16)
                            * w).sum())
    np.testing.assert_allclose(vb, vd, rtol=1e-5)
    for name, a, d in zip(("fea", "fea0", "v"), gb, gd):
        np.testing.assert_allclose(a.numpy(), d.numpy(), rtol=1e-4, atol=1e-5,
                                   err_msg=f"grad of {name}")


def test_corr_warp_scan_recomputes_each_block(rng, monkeypatch):
    """Under grad each row block runs under torch.utils.checkpoint: its
    forward once, and once more in the backward; without grad (and for a
    single block) no recompute."""
    calls = []
    real = cb._warp_block

    def spy(*args):
        calls.append(args[0].shape[1])
        return real(*args)

    monkeypatch.setattr(cb, "_warp_block", spy)
    q = _t(rng.standard_normal((1, 64, 8)).astype(np.float32))
    v = _t(rng.standard_normal((1, 64, 3)).astype(np.float32))
    cb.corr_warp_scan(q, q, v, block=16).sum().backward()
    assert calls == [16] * 8
    calls.clear()
    with torch.no_grad():
        cb.corr_warp_scan(q, q, v, block=16)
    cb.corr_warp_scan(q, q, v, block=64).sum().backward()
    assert calls == [16] * 4 + [64]


@pytest.mark.parametrize("path", ["flat", "block"])
def test_warp_qk_matches_jax(rng, path):
    """warp_qk's flat path (H*W == Lk) and its block path (s x s pixel
    blocks move as units, here s = 4), against JAX's and the port's dense
    warp."""
    b, g, c = 2, 4, 16
    s = 1 if path == "flat" else 4
    q = np.array(jcb.normalize_desc(jnp.asarray(rng.standard_normal((b, g, g, c)),
                                                 jnp.float32), split=8))
    k = np.array(jcb.normalize_desc(jnp.asarray(rng.standard_normal((b, g, g, c)),
                                                 jnp.float32), split=8))
    img = rng.standard_normal((b, g * s, g * s, 3)).astype(np.float32)
    want = np.asarray(jcb.warp_qk(jnp.asarray(img), jnp.asarray(q), jnp.asarray(k), block=8))
    got = cb.warp_qk(torch.from_numpy(img), torch.from_numpy(q), torch.from_numpy(k), block=8)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    logits = torch.from_numpy(q) @ torch.from_numpy(k).transpose(1, 2) / 0.01
    dense = warp(torch.from_numpy(img), torch.softmax(logits, dim=-1))
    np.testing.assert_allclose(got.numpy(), dense.numpy(), rtol=1e-5, atol=1e-5)


def test_e2_corr_qk_takes_the_scan_under_corr_blockwise(rng, monkeypatch):
    """With cfg.corr_blockwise E2's corr_qk route warps every scale through
    the scan (not K3) and matches the dense corrmatrix route of the same
    weights; without the flag it stays on K3's wrapper."""
    cfg = PPSTConfig(**NARROW_E2, corr_blockwise=True, corr_block=16)
    e2 = ColorEncoder(cfg)
    init_weights(e2, torch.Generator().manual_seed(0))
    dense_e2 = ColorEncoder(PPSTConfig(**NARROW_E2))
    dense_e2.load_state_dict(e2.state_dict())
    x = torch.from_numpy(rng.uniform(-1, 1, (2, 64, 64, 3)).astype(np.float32))
    desc = torch.from_numpy(rng.standard_normal((2, 8, 8, 24)).astype(np.float32))
    n = cb.normalize_desc(desc, split=8)
    scans = []
    real = cb._warp_block
    monkeypatch.setattr(cb, "_warp_block", lambda *a: scans.append(1) or real(*a))
    with torch.no_grad():
        got = e2(x, corr_qk=(n.flip(0), n)).vectors_w
        want = dense_e2(x, corrmatrix=corrm(desc, desc.flip(0), split=8)).vectors_w
        assert len(scans) == 4 * 4  # four scales, four row blocks each
        scans.clear()
        dense_e2(x, corr_qk=(n.flip(0), n))
        assert not scans
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-4, atol=1e-5)
