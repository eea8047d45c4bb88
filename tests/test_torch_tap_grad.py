"""The fused tap's backward (K2's plain version) against ppst_tpu's Pallas
backward, and the tap's autograd wiring.

On the CPU the port's backward runs ``fused_tap_1x1_bwd_reference``; the JAX
side runs ``tap_pallas``'s backward kernels in interpret mode, as its own
tests do. The CUDA kernel is compared with the plain version on the card by
``chip_smoke.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ppst_tpu.ops import tap_pallas
from ppst_tpu_torch.models.generator import _FeatureTap
from ppst_tpu_torch.nn.layers import init_weights
from ppst_tpu_torch.ops import tap_cuda

NAMES = ["dx", "dw1", "db1", "da1", "dw2", "db2", "da2"]


def _inputs(rng, shape=(2, 16, 16, 128)):
    b, h, w, cin = shape
    x32 = rng.standard_normal(shape).astype(np.float32)
    w1 = (rng.standard_normal((64, cin)) * 0.1).astype(np.float32)  # (out, in)
    b1 = (rng.standard_normal((64,)) * 0.1).astype(np.float32)
    w2 = (rng.standard_normal((64, 64)) * 0.1).astype(np.float32)
    b2 = (rng.standard_normal((64,)) * 0.1).astype(np.float32)
    a1, a2 = np.float32(0.25), np.float32(-0.1)
    g = rng.standard_normal((b, h, w, 64)).astype(np.float32)
    return x32, w1, b1, a1, w2, b2, a2, g


def _torch_args(x32, w1, b1, a1, w2, b2, a2):
    t = torch.from_numpy
    return (t(x32).bfloat16(), t(w1), t(b1), torch.tensor([a1]), t(w2), t(b2),
            torch.tensor([a2]))


def _jax_args(x32, w1, b1, a1, w2, b2, a2):
    # JAX's layout: (in, out) weights, scalar slopes
    return (jnp.asarray(x32).astype(jnp.bfloat16), jnp.asarray(w1.T), jnp.asarray(b1),
            jnp.float32(a1), jnp.asarray(w2.T), jnp.asarray(b2), jnp.float32(a2))


def _jax_grads_port_layout(grads):
    dx, dw1, db1, da1, dw2, db2, da2 = (np.asarray(v, np.float64) for v in grads)
    return [dx, dw1.T, db1, da1.reshape(1), dw2.T, db2, da2.reshape(1)]


def _np(v):
    return v.detach().double().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def test_tap_bwd_plain_matches_pallas_bwd(rng):
    """Both backwards on the SAME residuals (JAX's forward's t, u and
    statistics) and cotangent: float32 formulas on both sides, sums in other
    orders. Target 1e-4 of each gradient's max; the bias gradients (a
    mathematical zero, see test_tap_grad_matches_f32_twin) to 1e-4 of the
    largest gradient."""
    x32, w1, b1, a1, w2, b2, a2, g = _inputs(rng)
    jargs = _jax_args(x32, w1, b1, a1, w2, b2, a2)
    gj = jnp.asarray(g).astype(jnp.bfloat16)
    _, res = tap_pallas._fused_tap_impl(True, *jargs)
    want = _jax_grads_port_layout(tap_pallas._fused_tap_bwd(True, res, gj))

    x, t, u, m1, r1, m2, r2, m3, r3 = (np.asarray(v.astype(jnp.float32)) for v in res[:9])
    mr = np.concatenate([np.stack([m[:, 0], r[:, 0]], 1).reshape(-1)
                         for m, r in ((m1, r1), (m2, r2), (m3, r3))])
    tt = lambda v: torch.from_numpy(np.array(v))  # noqa: E731
    got = tap_cuda.fused_tap_1x1_bwd_reference(
        tt(x).bfloat16(), tt(t).bfloat16(), tt(u).bfloat16(), tt(mr), tt(w1), tt(w2),
        torch.tensor([a1]), torch.tensor([a2]), tt(g).bfloat16())
    overall = max(np.abs(v).max() for v in want)
    for name, a, b in zip(NAMES, got, want):
        a = _np(a)
        assert a.shape == b.shape, (name, a.shape, b.shape)
        scale = overall if name.startswith("db") else np.abs(b).max()
        assert np.abs(a - b).max() <= 1e-4 * scale, (name, np.abs(a - b).max(), scale)


def _port_grads(args, g, need_dx=True):
    args = [a.clone().requires_grad_(a.dtype == torch.float32 or need_dx) for a in args]
    out = tap_cuda.fused_tap_1x1(*args)
    out.backward(g)
    return [a.grad for a in args]


def test_tap_grad_matches_jax_vjp(rng):
    """End to end under each framework's autodiff: torch autograd of the
    port's ``fused_tap_1x1`` (plain forward, plain backward) against
    ``jax.vjp`` of JAX's (Pallas forward and backward, interpret mode).

    Here each side's backward reads its own forward's residuals, and the two
    forwards round a few values of t and u to neighbouring bf16 steps
    (test_torch_tap). Where such a value sits at a PReLU kink, one pixel's
    term of a gradient changes: with other seeds at this size that moved
    dW2 by up to 6% of its max. On this fixture's inputs the gradients agree
    to 1.7e-4 of their max (dW2) and dx, stored in bf16, to one bf16 step;
    the bounds are 1e-3 and 2^-8 of the max. The exact check of the
    backward's arithmetic is test_tap_bwd_plain_matches_pallas_bwd."""
    x32, w1, b1, a1, w2, b2, a2, g = _inputs(rng)
    jargs = _jax_args(x32, w1, b1, a1, w2, b2, a2)
    out, vjp = jax.vjp(tap_pallas.fused_tap_1x1, *jargs)
    want = _jax_grads_port_layout(vjp(jnp.asarray(g).astype(out.dtype)))
    got = _port_grads(_torch_args(x32, w1, b1, a1, w2, b2, a2), torch.from_numpy(g).bfloat16())
    overall = max(np.abs(v).max() for v in want)
    for name, a, b in zip(NAMES, got, want):
        a = _np(a).reshape(b.shape)
        scale = overall if name.startswith("db") else np.abs(b).max()
        tol = 2.0**-8 if name == "dx" else 1e-3
        assert np.abs(a - b).max() <= tol * scale, (name, np.abs(a - b).max(), scale)


def _f32_twin(x, w1, b1, a1, w2, b2, a2):
    """Autograd-able float32 twin of the chain: the forward's bf16 roundings
    (product inputs, t, u, output) as identity-gradient roundings, so its
    gradients carry no bf16 rounding of the cotangents."""
    def rnd(v):
        return v + (v.to(torch.bfloat16).float() - v).detach()

    def inorm(v):
        m = v.mean((1, 2), keepdim=True)
        var = (v * v).mean((1, 2), keepdim=True) - m * m
        return (v - m) * torch.rsqrt(var.clamp_min(0) + 1e-5)

    def prelu(v, a):
        return v.clamp_min(0) + a * v.clamp_max(0)

    t = rnd(rnd(inorm(x.float())) @ rnd(w1).t() + b1)
    u = rnd(rnd(prelu(inorm(t), a1)) @ rnd(w2).t() + b2)
    return rnd(prelu(inorm(u), a2))


def test_tap_grad_matches_f32_twin(rng):
    """Mirror of tests/test_pallas_kernels.py::test_tap_pallas_grad: the
    port's backward against autograd of the float32 twin, every gradient
    within 2% of its max; the bias gradients (a per-channel shift cancels in
    the next instance norm) at noise level."""
    x32, w1, b1, a1, w2, b2, a2, g = _inputs(rng)
    args = _torch_args(x32, w1, b1, a1, w2, b2, a2)
    gt = torch.from_numpy(g)
    got = _port_grads(args, gt.bfloat16())
    twin_args = [a.clone().float().requires_grad_() for a in args]
    (_f32_twin(*twin_args) * gt).sum().backward()
    want = [a.grad for a in twin_args]
    overall = max(_np(v).__abs__().max() for v in want)
    for name, a, b in zip(NAMES, got, want):
        a, b = _np(a), _np(b)
        assert np.isfinite(a).all(), name
        if name.startswith("db"):
            assert np.abs(b).max() < 0.02 * overall, name
            assert np.abs(a).max() <= max(np.abs(b).max(), 0.01 * overall), name
            continue
        assert np.abs(a - b).max() <= 0.02 * np.abs(b).max(), (name, np.abs(a - b).max())


def test_tap_grad_skips_dx(rng, monkeypatch):
    """With an input that needs no gradient (the generator's detached taps)
    the backward is asked for no dx, and none is computed."""
    x32, w1, b1, a1, w2, b2, a2, g = _inputs(rng, (1, 8, 8, 128))
    seen = []
    real = tap_cuda.fused_tap_1x1_bwd_reference

    def spy(*args, **kw):
        seen.append(args[-1] if len(args) == 10 else kw.get("need_dx", True))
        return real(*args, **kw)

    monkeypatch.setattr(tap_cuda, "fused_tap_1x1_bwd_reference", spy)
    grads = _port_grads(_torch_args(x32, w1, b1, a1, w2, b2, a2),
                        torch.from_numpy(g).bfloat16(), need_dx=False)
    assert seen == [False]
    assert grads[0] is None and all(v is not None for v in grads[1:])


def test_tap_inference_keeps_no_graph(rng):
    """Without grad the forward runs alone: no autograd node, the same bits
    as with grad."""
    x32, w1, b1, a1, w2, b2, a2, _ = _inputs(rng, (1, 8, 8, 128))
    args = [a.requires_grad_() if a.dtype == torch.float32 else a
            for a in _torch_args(x32, w1, b1, a1, w2, b2, a2)]
    with torch.inference_mode():
        plain = tap_cuda.fused_tap_1x1(*args)
    assert plain.grad_fn is None
    assert torch.equal(plain, tap_cuda.fused_tap_1x1(*args).detach())


def test_feature_tap_module_grad_wiring(rng):
    """Mirror of test_tap_pallas_grad_module_wiring: _FeatureTap(fused=True)
    in bf16 passes gradients to its four parameters' tensors and they track
    the bf16 composite's (whose autograd rounds cotangents to bf16, W2):
    cosine > 0.98, slopes of the same sign and ballpark, biases at noise
    level."""
    taps = []
    for fused in (False, True):
        tap = _FeatureTap(128, conv1x1=True, feature_ch=256, fused=fused)
        init_weights(tap, torch.Generator().manual_seed(0))
        taps.append(tap)
    x = torch.from_numpy(rng.standard_normal((2, 16, 16, 128)).astype(np.float32)).bfloat16()
    cot = torch.from_numpy(rng.standard_normal((2, 16, 16, 64)).astype(np.float32))
    for tap in taps:
        (tap(x).float() * cot).sum().backward()
    ref, fused = ({k: p.grad for k, p in t.named_parameters()} for t in taps)
    overall = max(v.abs().max().item() for v in ref.values())
    for k in ref:
        a, b = _np(fused[k]).ravel(), _np(ref[k]).ravel()
        assert np.isfinite(a).all(), k
        if np.abs(b).max() < 0.02 * overall:
            assert np.abs(a).max() <= max(np.abs(b).max(), 0.01 * overall), k
        elif a.size > 1:
            cos = a @ b / (np.linalg.norm(a) * np.linalg.norm(b) + 1e-12)
            assert cos > 0.98, (k, cos)
        else:
            assert np.sign(a) == np.sign(b) and abs(a - b) <= 0.5 * abs(b) + 0.01 * overall, k


def test_fused_tap_bwd_rejects_non_cuda_devices():
    e = lambda *s, dt=torch.float32: torch.empty(s, dtype=dt, device="meta")  # noqa: E731
    x, t = e(1, 4, 4, 128, dt=torch.bfloat16), e(1, 4, 4, 64, dt=torch.bfloat16)
    with pytest.raises(ValueError, match="unsupported device"):
        tap_cuda.fused_tap_1x1_bwd(x, t, t, e(384), e(64, 128), e(64, 64), e(1), e(1), t)
