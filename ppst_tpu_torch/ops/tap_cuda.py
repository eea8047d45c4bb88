"""The generator's 1x1 feature tap as one fused chain:
IN -> conv1x1 -> IN -> PReLU -> conv1x1 -> IN -> PReLU, forward (K1) and
backward (K2).

Counterpart of ``ppst_tpu/ops/tap_pallas.py::fused_tap_1x1`` and its custom
VJP. On a CUDA tensor the forward launches the hand-written kernel in
``csrc/tap.cu`` and the backward the one in ``csrc/tap_bwd.cu`` (whose headers
give the designs and their bounds); on a CPU tensor they run
``fused_tap_1x1_reference`` and ``fused_tap_1x1_bwd_reference``, the plain
PyTorch versions of the same arithmetic. There is no other path.

``fused_tap_1x1`` is differentiable through ``_FusedTap``, a
``torch.autograd.Function``. Its backward applies the instance-norm backward
identity stage by stage in float32, as the Pallas kernels do, rather than
autograd of the bf16 forward (which would round the cotangents at t, u and
the output). dx is computed only when the input needs a gradient. Without
grad (inference) the forward runs alone and keeps no residuals.

The kernels are compiled with ``nvcc`` for sm_90a at first use into
``ppst_tpu_torch/_build/`` and bound through ``ctypes`` (``ops._nvcc``).
While a profiler runs, each call's host side on the card is the span
``ppst.op:tap_fwd:<B>,<H>,<W>,<Cin>`` or ``ppst.op:tap_bwd:<B>,<H>,<W>,<Cin>,<dx>``
(``util.spans``; dx 1 where it is computed), beside the ``.launches`` counts.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from ppst_tpu_torch.ops import _nvcc
from ppst_tpu_torch.util.spans import span

_EPS = 1e-5
_CIN, _COUT = 128, 64
# the six small gradients in one float32 buffer, each at a 16-byte aligned
# offset: (name, offset, shape)
_GRADS = (("dw1", 0, (_COUT, _CIN)), ("db1", 8192, (_COUT,)), ("da1", 8256, (1,)),
          ("dw2", 8260, (_COUT, _COUT)), ("db2", 12356, (_COUT,)), ("da2", 12420, (1,)))
_GRAD_FLOATS = 12424


@functools.lru_cache(maxsize=None)
def _lib():
    lib = _nvcc.load("tap")
    fn = lib.ppst_fused_tap_fwd
    fn.argtypes = [ctypes.c_void_p] * 12 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.ppst_fused_tap_fwd_scratch_floats.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.ppst_fused_tap_fwd_scratch_floats.restype = ctypes.c_long
    return lib


@functools.lru_cache(maxsize=None)
def _bwd_lib():
    lib = _nvcc.load("tap_bwd")
    fn = lib.ppst_fused_tap_bwd
    fn.argtypes = [ctypes.c_void_p] * 17 + [ctypes.c_int] * 2 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.ppst_fused_tap_bwd_scratch_floats.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.ppst_fused_tap_bwd_scratch_floats.restype = ctypes.c_long
    return lib


def _inorm(v):
    """One-pass float32 instance norm over H, W of NHWC ``v``: the normalized
    values, and the mean and rstd as (B, C)."""
    v32 = v.float()
    m = v32.mean((1, 2), keepdim=True)
    ms = (v32 * v32).mean((1, 2), keepdim=True)
    r = torch.rsqrt((ms - m * m).clamp_min(0.0) + _EPS)
    return (v32 - m) * r, m[:, 0, 0], r[:, 0, 0]


def _mm(v, w):
    """bf16(v) @ bf16(w)^T with float32 sums: products of bf16 values are
    exact in float32 (and in TF32), so the float32 product is that sum."""
    return torch.matmul(v.to(torch.bfloat16).float(), w.to(torch.bfloat16).float().t())


def _prelu(v, a):
    return v.clamp_min(0.0) + a * v.clamp_max(0.0)


def _slopes(a1, a2, device):
    return (torch.as_tensor(a1, device=device).float().reshape(()),
            torch.as_tensor(a2, device=device).float().reshape(()))


def split_stats(mr, batch, channels=(_CIN, _COUT, _COUT)):
    """The residual statistics ``mr`` (the kernels' layout: (B, 2, C) mean
    and rstd of x, then of t, then of u, back to back) as (m1, r1, m2, r2,
    m3, r3), each (B, 1, 1, C) for NHWC broadcasting."""
    out, lo = [], 0
    for c in channels:
        s = mr[lo : lo + batch * 2 * c].view(batch, 2, 1, 1, c)
        out += [s[:, 0], s[:, 1]]
        lo += batch * 2 * c
    return out


def _forward_reference(x, w1, b1, a1, w2, b2, a2):
    """The plain forward and its residuals (t, u, mr)."""
    a1, a2 = _slopes(a1, a2, x.device)
    n1, m1, r1 = _inorm(x)
    t = (_mm(n1, w1) + b1.float()).to(torch.bfloat16)
    n2, m2, r2 = _inorm(t)
    u = (_mm(_prelu(n2, a1), w2) + b2.float()).to(torch.bfloat16)
    n3, m3, r3 = _inorm(u)
    mr = torch.cat([torch.stack(p, 1).reshape(-1) for p in ((m1, r1), (m2, r2), (m3, r3))])
    return _prelu(n3, a2).to(x.dtype), (t, u, mr)


def fused_tap_1x1_reference(x, w1, b1, a1, w2, b2, a2):
    """Plain PyTorch version of the forward kernel: float32 instance norms
    and epilogues, bf16 only at the product inputs and at t, u and the output."""
    return _forward_reference(x, w1, b1, a1, w2, b2, a2)[0]


def check_inputs(x, w1, b1, a1, w2, b2, a2, *, t=None, u=None, mr=None, g=None,
                 name="fused_tap_1x1", device_type="cuda"):
    """Raise ValueError unless the kernels take these arguments: the forward's
    (x, w1, b1, a1, w2, b2, a2) and, for the backward, the residuals t, u, mr
    and the cotangent g (b1 and b2 may then be None). Every CUDA call runs it;
    ``device_type`` lets the CPU tests check the rules on CPU tensors."""
    if x.device.type != device_type:
        raise ValueError(f"{name}: unsupported device {x.device}")
    if x.dtype != torch.bfloat16 or x.dim() != 4:
        raise ValueError(f"{name}: x must be 4-D bfloat16, got {x.dtype} {tuple(x.shape)}")
    bsz, h, w, cin = x.shape
    if cin != _CIN or tuple(w1.shape) != (_COUT, _CIN) or tuple(w2.shape) != (_COUT, _COUT):
        raise ValueError(
            f"{name}: the kernel takes x (B, H, W, 128), w1 (64, 128) and w2 (64, 64); "
            f"got x {tuple(x.shape)}, w1 {tuple(w1.shape)}, w2 {tuple(w2.shape)}")
    if not 1 <= bsz <= 65535:
        raise ValueError(f"{name}: batch {bsz} outside 1..65535")
    if not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError(f"{name}: x must be contiguous and 16-byte aligned")
    for v in (b1, b2):
        if v is not None and tuple(v.shape) != (_COUT,):
            raise ValueError(f"{name}: b1/b2 must be (64,), got {tuple(v.shape)}")
    if a1.numel() != 1 or a2.numel() != 1:
        raise ValueError(f"{name}: a1 and a2 must hold one value each")
    for v_name, v in (("t", t), ("u", u), ("g", g)):
        if v is not None and (v.dtype != torch.bfloat16 or tuple(v.shape) != (bsz, h, w, _COUT)):
            raise ValueError(f"{name}: {v_name} must be bfloat16 {(bsz, h, w, _COUT)}, got "
                             f"{v.dtype} {tuple(v.shape)}")
    if mr is not None and (mr.dtype != torch.float32
                           or mr.numel() != bsz * 2 * (_CIN + 2 * _COUT)):
        raise ValueError(f"{name}: mr must hold the forward's float32 statistics")
    for v in (w1, b1, a1, w2, b2, a2, t, u, mr, g):
        if v is not None and v.device != x.device:
            raise ValueError(f"{name}: an argument is on {v.device}, x on {x.device}")


def _forward(x, w1, b1, a1, w2, b2, a2):
    """The forward and its residuals (t, u, mr): the kernel on CUDA, the plain
    version on the CPU."""
    if x.device.type == "cpu":
        return _forward_reference(x, w1, b1, a1, w2, b2, a2)
    with span("op:tap_fwd", x.shape):
        return _forward_cuda(x, w1, b1, a1, w2, b2, a2)


def _forward_cuda(x, w1, b1, a1, w2, b2, a2):
    check_inputs(x, w1, b1, a1, w2, b2, a2)
    bsz, h, w, cin = x.shape
    n = h * w
    dev = x.device
    lib = _lib()
    with torch.cuda.device(dev):
        # t, u and out apart (callers keep them); mr (the residual statistics)
        # and the kernel's partial statistics in one buffer
        t, u, out = (torch.empty((bsz, h, w, _COUT), dtype=torch.bfloat16, device=dev)
                     for _ in range(3))
        n_mr = bsz * 2 * (_CIN + 2 * _COUT)
        buf = torch.empty((n_mr + lib.ppst_fused_tap_fwd_scratch_floats(bsz, n),),
                          dtype=torch.float32, device=dev)
        mr = buf[:n_mr]
        args = [x, w1.detach().to(torch.bfloat16).contiguous(), b1.detach().float().contiguous(),
                a1.detach().float().reshape(1), w2.detach().to(torch.bfloat16).contiguous(),
                b2.detach().float().contiguous(), a2.detach().float().reshape(1), t, u, out,
                buf[n_mr:], mr]
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.ppst_fused_tap_fwd(*[a.data_ptr() for a in args], bsz, n, cin, _COUT, _COUT,
                                     stream)
    _nvcc.check(lib, err, "fused_tap_1x1")
    fused_tap_1x1.launches += 1
    return out, (t, u, mr)


def fused_tap_1x1_bwd_reference(x, t, u, mr, w1, w2, a1, a2, g, need_dx=True):
    """Plain PyTorch version of the backward kernel, in float32 with the
    Pallas kernels' identities (tap_pallas.py:217-223): given the forward's
    input, residuals (t, u, mr) and the output's cotangent ``g``, returns
    (dx or None, dw1, db1, da1, dw2, db2, da2); weights in (out, in) layout."""
    bsz = x.shape[0]
    m1, r1, m2, r2, m3, r3 = split_stats(mr, bsz, (x.shape[-1], t.shape[-1], u.shape[-1]))
    a1, a2 = _slopes(a1, a2, x.device)
    sh = (0, 1, 2)
    n3 = (u.float() - m3) * r3
    g32 = g.float()
    dn3 = g32 * torch.where(n3 > 0, 1.0, a2)
    da2 = (g32 * n3.clamp_max(0.0)).sum()
    du = r3 * (dn3 - dn3.mean((1, 2), keepdim=True) - n3 * (dn3 * n3).mean((1, 2), keepdim=True))
    n2 = (t.float() - m2) * r2
    p2 = _prelu(n2, a1)
    dw2 = torch.einsum("bhwo,bhwi->oi", du, p2)
    dp2 = torch.matmul(du, w2.to(torch.bfloat16).float())
    da1 = (dp2 * n2.clamp_max(0.0)).sum()
    dn2 = dp2 * torch.where(n2 > 0, 1.0, a1)
    dt = r2 * (dn2 - dn2.mean((1, 2), keepdim=True) - n2 * (dn2 * n2).mean((1, 2), keepdim=True))
    n1 = (x.float() - m1) * r1
    dw1 = torch.einsum("bhwc,bhwj->cj", dt, n1)
    dx = None
    if need_dx:
        dn1 = torch.matmul(dt, w1.to(torch.bfloat16).float())
        dx = (r1 * (dn1 - dn1.mean((1, 2), keepdim=True)
                    - n1 * (dn1 * n1).mean((1, 2), keepdim=True))).to(x.dtype)
    return dx, dw1, dt.sum(sh), da1.reshape(1), dw2, du.sum(sh), da2.reshape(1)


def fused_tap_1x1_bwd(x, t, u, mr, w1, w2, a1, a2, g, need_dx=True):
    """Backward of the fused tap: (dx or None, dw1, db1, da1, dw2, db2, da2),
    gradients in float32 and weights in (out, in) layout, dx in x's dtype.

    ``t``, ``u`` and ``mr`` are the forward's residuals; ``g`` the output's
    cotangent. CPU tensors run the plain version; CUDA tensors launch the
    kernel (bf16 x, t, u and g; Cin = 128, C1 = C2 = 64), anything else raises.
    """
    if x.device.type == "cpu":
        return fused_tap_1x1_bwd_reference(x, t, u, mr, w1, w2, a1, a2, g, need_dx)
    with span("op:tap_bwd", x.shape, int(bool(need_dx))):
        return _bwd_cuda(x, t, u, mr, w1, w2, a1, a2, g, need_dx)


def _bwd_cuda(x, t, u, mr, w1, w2, a1, a2, g, need_dx):
    check_inputs(x, w1, None, a1, w2, None, a2, t=t, u=u, mr=mr, g=g, name="fused_tap_1x1_bwd")
    bsz, h, w, _ = x.shape
    n = h * w
    dev = x.device
    lib = _bwd_lib()
    with torch.cuda.device(dev):
        # the six small gradients in one buffer, viewed; dx apart
        grads = torch.empty((_GRAD_FLOATS,), dtype=torch.float32, device=dev)
        outs = [grads[o : o + math.prod(shape)].view(shape) for _, o, shape in _GRADS]
        dx = torch.empty_like(x) if need_dx else None
        scratch = torch.empty((lib.ppst_fused_tap_bwd_scratch_floats(bsz, n),),
                              dtype=torch.float32, device=dev)
        ins = [x, t.contiguous(), u.contiguous(), g.contiguous(), mr.contiguous(),
               w1.detach().to(torch.bfloat16).contiguous(),
               w2.detach().to(torch.bfloat16).contiguous(),
               a1.detach().float().reshape(1), a2.detach().float().reshape(1)]
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.ppst_fused_tap_bwd(*[v.data_ptr() for v in ins + outs],
                                     dx.data_ptr() if dx is not None else None,
                                     scratch.data_ptr(), bsz, n, stream)
    _nvcc.check(lib, err, "fused_tap_1x1_bwd")
    fused_tap_1x1_bwd.launches += 1
    return (dx, *outs)


class _FusedTap(torch.autograd.Function):
    """The fused tap under autograd: K1 forward, K2 backward (their plain
    versions on the CPU)."""

    @staticmethod
    def forward(ctx, x, w1, b1, a1, w2, b2, a2):
        out, (t, u, mr) = _forward(x, w1, b1, a1, w2, b2, a2)
        ctx.save_for_backward(x, t, u, mr, w1, w2, a1, a2)
        return out

    @staticmethod
    def backward(ctx, g):
        x, t, u, mr, w1, w2, a1, a2 = ctx.saved_tensors
        dx, dw1, db1, da1, dw2, db2, da2 = fused_tap_1x1_bwd(
            x, t, u, mr, w1, w2, a1, a2, g.to(torch.bfloat16), need_dx=ctx.needs_input_grad[0])
        return (dx, dw1.to(w1.dtype), db1, da1.reshape(a1.shape), dw2.to(w2.dtype), db2,
                da2.reshape(a2.shape))


def fused_tap_1x1(x, w1, b1, a1, w2, b2, a2):
    """IN(x) @ w1^T + b1 -> IN -> PReLU(a1) -> @ w2^T + b2 -> IN -> PReLU(a2).

    ``x``: (B, H, W, Cin) bfloat16, NHWC. ``w1`` (C1, Cin) and ``w2``
    (C2, C1) in PyTorch's (out, in) layout, float32, cast to bf16 for the
    products; ``b1``/``b2`` float32; ``a1``/``a2`` PReLU slopes (one-element
    tensors). Returns (B, H, W, C2) bfloat16.

    CPU tensors run the plain version. CUDA tensors launch the kernel, which
    takes Cin = 128 and C1 = C2 = 64 only, and anything else raises.
    Differentiable when grad is enabled and an argument requires it.
    """
    args = (x, w1, b1, a1, w2, b2, a2)
    if torch.is_grad_enabled() and any(torch.is_tensor(v) and v.requires_grad for v in args):
        return _FusedTap.apply(*args)
    return _forward(*args)[0]


fused_tap_1x1.launches = 0
fused_tap_1x1_bwd.launches = 0
