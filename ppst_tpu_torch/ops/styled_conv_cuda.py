"""The generator's fused StyledConv: 3x3 conv + noise + biases + leaky ReLU +
instance norm + style modulation as one chain, forward (K6) and backward.

Counterpart of ``ppst_tpu/ops/styled_conv_pallas.py::styled_conv3x3`` and its
custom VJP. With every additive bias folded into ``b_total``::

    pre = conv3x3(x, w) + gain * noise + b_total
    a   = lrelu(pre, 0.2) * sqrt(2)                      # stored in x's dtype
    n   = (a - mean_hw(a)) * rsqrt(var_hw(a) + 1e-5)     # float32 sums of the float32 a
    out = n * (style_scale + 1) + style_shift

The rounding points are the Pallas kernels': the statistics come from the
float32 ``a``, the apply and the backward read the stored ``a``, the backward
stores ``dpre`` in x's dtype for dx and dW and sums db and dgain from the
float32 ``dpre``, and noise is cast to x's dtype (so float32 noise does not
promote a bf16 chain, unlike the composite). dW is returned in float32, the
weight's dtype, where the Pallas kernel returns it in bf16 (ROADMAP W1).

On a CUDA tensor the forward launches the hand-written kernels of
``csrc/styled_conv.cu`` and the backward those of ``csrc/styled_conv_bwd.cu``
(whose headers give the designs and their bounds), with dx through
``styled_conv.cu``'s plain conv; on a CPU tensor they run
``styled_conv3x3_reference`` and ``styled_conv3x3_bwd_reference``, the plain
PyTorch versions of the same arithmetic. There is no other path. The conv
core (forward and dx) and dW are TMA-fed, warp-specialised ``wgmma``
kernels over haloed input windows: a tile of 4 x 64 pixels reads each
64-channel chunk of x once for all nine taps.

``styled_conv3x3`` is differentiable through ``_StyledConv3x3``, a
``torch.autograd.Function``; dx is computed only when the input needs a
gradient. Without grad (inference, the D step's generator passes) the forward
runs alone and keeps nothing. The kernels are compiled with ``nvcc`` for
sm_90a at first use into ``ppst_tpu_torch/_build/`` and bound through
``ctypes`` (``ops._nvcc``). While a profiler runs, each call's host side on
the card is the span ``ppst.op:styled_conv:<B>,<H>,<W>,<Cin>,<Cout>`` or
``ppst.op:styled_conv_bwd:<B>,<H>,<W>,<Cin>,<Cout>,<dx>`` (``util.spans``; x's
shape, the weight's output width, dx 1 where it is computed).
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch
import torch.nn.functional as F

from ppst_tpu_torch.ops import _nvcc
from ppst_tpu_torch.util.spans import span

_EPS = 1e-5
_SLOPE = 0.2
_SQRT2 = math.sqrt(2.0)
_MAX_COUT = 2048  # the backward's elementwise passes hold one thread per 8 channels
_MAX_DW_FLOATS = 64 << 20  # the backward's float32 dW partials: at least one slice of 9 Cin Cout
_MAX_BYTES = 1 << 40  # TMA's limit on a tensor map's byte strides: one image of x, dpre or a


@functools.lru_cache(maxsize=None)
def _lib():
    lib = _nvcc.load("styled_conv")
    lib.ppst_styled_conv_fwd.argtypes = [ctypes.c_void_p] * 12 + [ctypes.c_int] * 5 + [
        ctypes.c_void_p]
    lib.ppst_styled_conv_fwd.restype = ctypes.c_int
    lib.ppst_conv3x3.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    lib.ppst_conv3x3.restype = ctypes.c_int
    lib.ppst_styled_conv_scratch_floats.argtypes = [ctypes.c_int] * 4
    lib.ppst_styled_conv_scratch_floats.restype = ctypes.c_long
    return lib


@functools.lru_cache(maxsize=None)
def _bwd_lib():
    lib = _nvcc.load("styled_conv_bwd")
    lib.ppst_styled_conv_bwd.argtypes = [ctypes.c_void_p] * 13 + [ctypes.c_int] * 6 + [
        ctypes.c_void_p]
    lib.ppst_styled_conv_bwd.restype = ctypes.c_int
    lib.ppst_styled_conv_bwd_scratch_floats.argtypes = [ctypes.c_int] * 5
    lib.ppst_styled_conv_bwd_scratch_floats.restype = ctypes.c_long
    return lib


def _conv(x, w):
    """Float32 3x3 conv with zero padding 1 of NHWC ``x`` and an (out, in, 3, 3)
    kernel."""
    return F.conv2d(x.permute(0, 3, 1, 2), w, padding=1).permute(0, 2, 3, 1)


def _bc(v):
    """(B, C) -> (B, 1, 1, C) float32, for NHWC broadcasting."""
    return v.float()[:, None, None, :]


def _forward_reference(x, w, noise, gain, b_total, s1, shift):
    """The plain forward and its residuals (a, mean, rstd)."""
    pre = (_conv(x.float(), w.to(x.dtype).float())
           + gain.float() * noise.to(x.dtype).float() + b_total.float())
    a32 = torch.where(pre >= 0, pre, pre * _SLOPE) * _SQRT2
    count = x.shape[1] * x.shape[2]
    mean = a32.sum((1, 2)) / count
    var = ((a32 * a32).sum((1, 2)) / count - mean * mean).clamp_min(0.0)
    rstd = torch.rsqrt(var + _EPS)
    a = a32.to(x.dtype)
    out = ((a.float() - _bc(mean)) * _bc(rstd)) * _bc(s1) + _bc(shift)
    return out.to(x.dtype), (a, mean, rstd)


def styled_conv3x3_reference(x, w, noise, gain, b_total, s1, shift):
    """Plain PyTorch version of the forward kernels: float32 arithmetic with
    the kernels' roundings (products of x's dtype, ``a`` and the output
    stored in it). ``s1`` is style_scale + 1; ``w`` is (Cout, Cin, 3, 3)."""
    return _forward_reference(x, w, noise, gain, b_total, s1, shift)[0]


def check_shapes(x_shape, w_shape, noise_shape, name="styled_conv3x3", backward=False):
    """Raise ValueError for a shape the kernels do not take, before any
    launch: x (B, H, W, Cin) and w (Cout, Cin, 3, 3) with Cin and Cout
    multiples of 16, Cout <= 2048, 1 <= B <= 65535, H W <= 2^30, an image
    of x or of the output under 2^40 bytes (TMA's stride limit) and, for the
    backward, 9 Cin Cout float32 partials within 64 Mi; noise (B, H, W, 1)."""
    x_shape, w_shape = tuple(x_shape), tuple(w_shape)
    if len(x_shape) != 4:
        raise ValueError(f"{name}: x must be 4-D (B, H, W, Cin), got {x_shape}")
    bsz, h, wd, cin = x_shape
    cout = w_shape[0] if w_shape else 0
    if (len(w_shape) != 4 or w_shape[1:] != (cin, 3, 3) or cin % 16 or cout % 16
            or not 16 <= cin or not 16 <= cout <= _MAX_COUT):
        raise ValueError(f"{name}: the kernel takes x (B, H, W, Cin) and w (Cout, Cin, 3, 3) with "
                         f"Cin and Cout multiples of 16, Cout <= {_MAX_COUT}; got x "
                         f"{x_shape}, w {w_shape}")
    if not 1 <= bsz <= 65535 or h < 1 or wd < 1 or h * wd > 2**30:
        raise ValueError(f"{name}: shape {x_shape} outside the kernel's range")
    if h * wd * max(cin, cout) * 2 >= _MAX_BYTES:
        raise ValueError(f"{name}: an image of {h * wd * max(cin, cout) * 2} bytes is past the "
                         f"tensor maps' {_MAX_BYTES}")
    if backward and 9 * cin * cout > _MAX_DW_FLOATS:
        raise ValueError(f"{name}: 9 Cin Cout = {9 * cin * cout} dW partials exceed "
                         f"{_MAX_DW_FLOATS}")
    if tuple(noise_shape) != (bsz, h, wd, 1):
        raise ValueError(f"{name}: noise must be {(bsz, h, wd, 1)}, got {tuple(noise_shape)}")


def _check(x, w, noise, name, backward=False):
    if x.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {x.device}")
    if x.dtype != torch.bfloat16 or x.dim() != 4:
        raise ValueError(f"{name}: x must be 4-D bfloat16, got {x.dtype} {tuple(x.shape)}")
    check_shapes(x.shape, w.shape, noise.shape, name, backward)
    for v in (w, noise):
        if v.device != x.device:
            raise ValueError(f"{name}: an argument is on {v.device}, x on {x.device}")


def _vec(v, shape, name, what):
    v = v.detach().float().contiguous()
    if tuple(v.shape) != shape:
        raise ValueError(f"{name}: {what} must be {shape}, got {tuple(v.shape)}")
    return v


def _aligned(name, *tensors):
    for t in tensors:
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name}: inputs must be contiguous and 16-byte aligned")


def _forward(x, w, noise, gain, b_total, s1, shift):
    """The forward and its residuals (a, mean, rstd): the kernels on CUDA, the
    plain version on the CPU."""
    if x.device.type == "cpu":
        return _forward_reference(x, w, noise, gain, b_total, s1, shift)
    with span("op:styled_conv", x.shape, w.shape[0]):
        return _forward_cuda(x, w, noise, gain, b_total, s1, shift)


def _forward_cuda(x, w, noise, gain, b_total, s1, shift):
    name = "styled_conv3x3"
    _check(x, w, noise, name)
    bsz, h, wd, cin = x.shape
    cout = w.shape[0]
    x = x.contiguous()
    nz = noise.detach().to(torch.bfloat16).contiguous()
    _aligned(name, x, nz)
    dev = x.device
    bf16 = dict(dtype=torch.bfloat16, device=dev)
    lib = _lib()
    args = [
        x,
        w.detach().to(torch.bfloat16).permute(2, 3, 0, 1).contiguous(),  # (9, Cout, Cin)
        nz,
        _vec(gain.reshape(-1), (1,), name, "gain"),
        _vec(b_total, (cout,), name, "b_total"),
        _vec(s1, (bsz, cout), name, "s1"),
        _vec(shift, (bsz, cout), name, "shift"),
        torch.empty((bsz, h, wd, cout), **bf16),  # a
        torch.empty((bsz, h, wd, cout), **bf16),  # out
        torch.empty((bsz, cout), dtype=torch.float32, device=dev),  # mean
        torch.empty((bsz, cout), dtype=torch.float32, device=dev),  # rstd
        torch.empty((lib.ppst_styled_conv_scratch_floats(bsz, h, wd, cout),),
                    dtype=torch.float32, device=dev),
    ]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.ppst_styled_conv_fwd(*[v.data_ptr() for v in args], bsz, h, wd, cin, cout,
                                       stream)
    _nvcc.check(lib, err, name)
    styled_conv3x3.launches += 1
    return args[8], (args[7], args[9], args[10])


def styled_conv3x3_bwd_reference(x, w, noise, a, mean, rstd, s1, g, need_dx=True):
    """Plain PyTorch version of the backward kernels, float32 with the Pallas
    kernels' identities (styled_conv_pallas.py:205-290): given the forward's
    input, its residuals (a, mean, rstd), s1 and the output's cotangent ``g``,
    returns (dx or None, dw, dgain, db_total, dstyle_scale, dstyle_shift);
    dw (Cout, Cin, 3, 3) float32, dx in x's dtype."""
    count = a.shape[1] * a.shape[2]
    m, r, s = _bc(mean), _bc(rstd), _bc(s1)
    a32, g32 = a.float(), g.float()
    n = (a32 - m) * r
    dn = g32 * s
    s1m = dn.sum((1, 2), keepdim=True) * (1.0 / count)
    s2m = (dn * n).sum((1, 2), keepdim=True) * (1.0 / count)
    dscale, dshift = (g32 * n).sum((1, 2)), g32.sum((1, 2))
    dpre32 = r * (dn - s1m - n * s2m) * _SQRT2 * torch.where(a32 >= 0, 1.0, _SLOPE)
    db = dpre32.sum((0, 1, 2))
    dgain = (dpre32 * noise.to(x.dtype).float()).sum().reshape(1)
    dpre = dpre32.to(x.dtype).float()
    wk = w.to(x.dtype).float()
    dx = _conv(dpre, wk.flip(2, 3).transpose(0, 1)).to(x.dtype) if need_dx else None
    dw = torch.nn.grad.conv2d_weight(x.float().permute(0, 3, 1, 2), tuple(w.shape),
                                     dpre.permute(0, 3, 1, 2), padding=1)
    return dx, dw, dgain, db, dscale, dshift


def _bwd_parts(x, w, noise, a, mean, rstd, s1, g, need_dx=True):
    """Check and prepare the backward on CUDA tensors. Returns (run, outs):
    ``run(part)`` launches passes 1-2 ("dpre": dpre, the sums, db, dgain),
    "dw" (from x and dpre) or, with ``need_dx``, "dx" (the transposed conv
    of dpre) on the current stream; outs = (dx or None, dw, dgain, db, sums)."""
    name = "styled_conv3x3_bwd"
    _check(x, w, noise, name, backward=True)
    bsz, h, wd, cin = x.shape
    cout = w.shape[0]
    for what, v in (("a", a), ("g", g)):
        if v.dtype != torch.bfloat16 or tuple(v.shape) != (bsz, h, wd, cout):
            raise ValueError(f"{name}: {what} must be bfloat16 {(bsz, h, wd, cout)}, got "
                             f"{v.dtype} {tuple(v.shape)}")
    x, a, g = x.contiguous(), a.contiguous(), g.contiguous()
    nz = noise.detach().to(torch.bfloat16).contiguous()
    _aligned(name, x, a, g, nz)
    dev = x.device
    f32 = dict(dtype=torch.float32, device=dev)
    lib = _bwd_lib()
    ins = [x, a, g, nz, _vec(mean, (bsz, cout), name, "mean"),
           _vec(rstd, (bsz, cout), name, "rstd"), _vec(s1, (bsz, cout), name, "s1")]
    dpre = torch.empty((bsz, h, wd, cout), dtype=torch.bfloat16, device=dev)
    sums = torch.empty((bsz, 4, cout), **f32)
    outs = [dpre, sums, torch.empty((cout,), **f32), torch.empty((1,), **f32),
            torch.empty((cout, cin, 3, 3), **f32),
            torch.empty((lib.ppst_styled_conv_bwd_scratch_floats(bsz, h, wd, cin, cout),), **f32)]
    dx = wt = None
    if need_dx:
        dx = torch.empty_like(x)
        # the transposed conv: dpre correlated with the flipped kernel, in and
        # out swapped, (9, Cin, Cout)
        wt = w.detach().to(torch.bfloat16).flip(2, 3).permute(2, 3, 1, 0).contiguous()
    bufs = ins + outs  # held by run: the kernels read and write them after this returns

    def run(part):
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            if part == "dx":
                err = _lib().ppst_conv3x3(dpre.data_ptr(), wt.data_ptr(), dx.data_ptr(), bsz, h,
                                          wd, cout, cin, stream)
                _nvcc.check(_lib(), err, name)
                return
            err = lib.ppst_styled_conv_bwd(*[v.data_ptr() for v in bufs], bsz, h, wd, cin, cout,
                                           {"dpre": 1, "dw": 2}[part], stream)
        _nvcc.check(lib, err, name)

    return run, (dx, outs[4], outs[3], outs[2], sums)


def styled_conv3x3_bwd(x, w, noise, a, mean, rstd, s1, g, need_dx=True):
    """Backward of the fused StyledConv: (dx or None, dw, dgain, db_total,
    dstyle_scale, dstyle_shift), every gradient float32 but dx (x's dtype);
    dw in the (Cout, Cin, 3, 3) layout of ``w``.

    ``a``, ``mean`` and ``rstd`` are the forward's residuals, ``s1`` its
    style_scale + 1, ``g`` the output's cotangent. CPU tensors run the plain
    version; CUDA tensors launch the kernels (bf16 x, a and g; the shapes
    ``check_shapes`` takes), and anything else raises.
    """
    if x.device.type == "cpu":
        return styled_conv3x3_bwd_reference(x, w, noise, a, mean, rstd, s1, g, need_dx)
    with span("op:styled_conv_bwd", x.shape, w.shape[0], int(bool(need_dx))):
        run, (dx, dw, dgain, db, sums) = _bwd_parts(x, w, noise, a, mean, rstd, s1, g, need_dx)
        run("dpre")
        run("dw")
        if need_dx:
            run("dx")
        styled_conv3x3_bwd.launches += 1
        return dx, dw, dgain, db, sums[:, 2].contiguous(), sums[:, 3].contiguous()


class _StyledConv3x3(torch.autograd.Function):
    """The fused StyledConv under autograd: K6 forward and backward (their
    plain versions on the CPU). Keeps x, w, noise, s1 and the forward's a,
    mean and rstd."""

    @staticmethod
    def forward(ctx, x, w, noise, gain, b_total, s1, shift):
        out, (a, mean, rstd) = _forward(x, w, noise, gain, b_total, s1, shift)
        ctx.save_for_backward(x, w, noise, a, mean, rstd, s1)
        ctx.gain_shape = gain.shape
        return out

    @staticmethod
    def backward(ctx, g):
        x, w, noise, a, mean, rstd, s1 = ctx.saved_tensors
        dx, dw, dgain, db, dscale, dshift = styled_conv3x3_bwd(
            x, w, noise, a, mean, rstd, s1, g.to(x.dtype), need_dx=ctx.needs_input_grad[0])
        return dx, dw, None, dgain.reshape(ctx.gain_shape), db, dscale, dshift


def styled_conv3x3(x, w, noise, gain, b_total, style_scale, style_shift):
    """The fused StyledConv chain (module docstring).

    ``x`` (B, H, W, Cin); ``w`` (Cout, Cin, 3, 3), PyTorch's layout, cast to
    x's dtype for the products; ``noise`` (B, H, W, 1), cast to x's dtype;
    ``gain`` a one-element tensor; ``b_total`` (Cout,), the sum of the conv's,
    the StyledConv's and the activation's biases; ``style_scale`` and
    ``style_shift`` (B, Cout) from the StyleMod linear. Returns (B, H, W, Cout)
    in x's dtype, differentiable in everything but ``noise``.

    CPU tensors run the plain version. CUDA tensors launch the kernels, which
    take bf16 x of the shapes ``check_shapes`` takes, and anything else raises.
    """
    args = (x, w, noise, gain, b_total, style_scale + 1.0, style_shift)
    if torch.is_grad_enabled() and any(torch.is_tensor(v) and v.requires_grad for v in args):
        return _StyledConv3x3.apply(*args)
    return _forward(*args)[0]


styled_conv3x3.launches = 0
styled_conv3x3_bwd.launches = 0
