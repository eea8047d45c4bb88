"""The generator's 1x1 feature tap as one fused chain (K1):
IN -> conv1x1 -> IN -> PReLU -> conv1x1 -> IN -> PReLU.

Counterpart of ``ppst_tpu/ops/tap_pallas.py::fused_tap_1x1`` (forward). On a
CUDA tensor ``fused_tap_1x1`` launches the hand-written kernel in
``csrc/tap.cu`` (whose header gives the design and its bound); on a CPU
tensor it runs ``fused_tap_1x1_reference``, the plain PyTorch version of the
same arithmetic. There is no other path.

The kernel is compiled with ``nvcc`` for sm_90a at first use into
``ppst_tpu_torch/_build/`` and bound through ``ctypes`` (``ops._nvcc``).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ppst_tpu_torch.ops import _nvcc

_EPS = 1e-5
_CHUNK = 256  # pixels per block of the kernel (kChunk in tap.cu)
_CIN, _COUT = 128, 64


@functools.lru_cache(maxsize=None)
def _lib():
    lib = _nvcc.load("tap")
    fn = lib.ppst_fused_tap_fwd
    fn.argtypes = [ctypes.c_void_p] * 12 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


def _inorm(v):
    """One-pass float32 instance norm over H, W of NHWC ``v``."""
    v32 = v.float()
    m = v32.mean((1, 2), keepdim=True)
    ms = (v32 * v32).mean((1, 2), keepdim=True)
    var = (ms - m * m).clamp_min(0.0)
    return (v32 - m) * torch.rsqrt(var + _EPS)


def _mm(v, w):
    """bf16(v) @ bf16(w)^T with float32 sums: products of bf16 values are
    exact in float32 (and in TF32), so the float32 product is that sum."""
    return torch.matmul(v.to(torch.bfloat16).float(), w.to(torch.bfloat16).float().t())


def _prelu(v, a):
    return v.clamp_min(0.0) + a * v.clamp_max(0.0)


def fused_tap_1x1_reference(x, w1, b1, a1, w2, b2, a2):
    """Plain PyTorch version of the kernel: float32 instance norms and
    epilogues, bf16 only at the product inputs and at t, u and the output."""
    a1 = torch.as_tensor(a1, device=x.device).float()
    a2 = torch.as_tensor(a2, device=x.device).float()
    t = (_mm(_inorm(x), w1) + b1.float()).to(torch.bfloat16)
    u = (_mm(_prelu(_inorm(t), a1), w2) + b2.float()).to(torch.bfloat16)
    return _prelu(_inorm(u), a2).to(x.dtype)


def fused_tap_1x1(x, w1, b1, a1, w2, b2, a2):
    """IN(x) @ w1^T + b1 -> IN -> PReLU(a1) -> @ w2^T + b2 -> IN -> PReLU(a2).

    ``x``: (B, H, W, Cin) bfloat16, NHWC. ``w1`` (C1, Cin) and ``w2``
    (C2, C1) in PyTorch's (out, in) layout, float32, cast to bf16 for the
    products; ``b1``/``b2`` float32; ``a1``/``a2`` PReLU slopes (one-element
    tensors). Returns (B, H, W, C2) bfloat16.

    CPU tensors run the plain version. CUDA tensors launch the kernel, which
    takes Cin = 128 and C1 = C2 = 64 only, and anything else raises.
    """
    if x.device.type == "cpu":
        return fused_tap_1x1_reference(x, w1, b1, a1, w2, b2, a2)
    if x.device.type != "cuda":
        raise ValueError(f"fused_tap_1x1: unsupported device {x.device}")
    if x.dtype != torch.bfloat16 or x.dim() != 4:
        raise ValueError(f"fused_tap_1x1: x must be 4-D bfloat16, got {x.dtype} {tuple(x.shape)}")
    bsz, h, w, cin = x.shape
    if (cin != _CIN or tuple(w1.shape) != (_COUT, _CIN) or tuple(w2.shape) != (_COUT, _COUT)
            or tuple(b1.shape) != (_COUT,) or tuple(b2.shape) != (_COUT,)):
        raise ValueError(
            "fused_tap_1x1: the kernel takes x (B, H, W, 128), w1 (64, 128), "
            f"w2 (64, 64), b1/b2 (64,); got x {tuple(x.shape)}, w1 {tuple(w1.shape)}, "
            f"w2 {tuple(w2.shape)}, b1 {tuple(b1.shape)}, b2 {tuple(b2.shape)}")
    if a1.numel() != 1 or a2.numel() != 1:
        raise ValueError("fused_tap_1x1: a1 and a2 must hold one value each")
    if not 1 <= bsz <= 65535:
        raise ValueError(f"fused_tap_1x1: batch {bsz} outside 1..65535")
    for name, v in (("w1", w1), ("b1", b1), ("a1", a1), ("w2", w2), ("b2", b2), ("a2", a2)):
        if v.device != x.device:
            raise ValueError(f"fused_tap_1x1: {name} is on {v.device}, x on {x.device}")
    if not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError("fused_tap_1x1: x must be contiguous and 16-byte aligned")

    n = h * w
    nblk = -(-n // _CHUNK)
    dev = x.device
    args = [
        x,
        w1.to(torch.bfloat16).contiguous(), b1.float().contiguous(), a1.float().reshape(1),
        w2.to(torch.bfloat16).contiguous(), b2.float().contiguous(), a2.float().reshape(1),
        torch.empty((bsz, h, w, _COUT), dtype=torch.bfloat16, device=dev),  # t
        torch.empty((bsz, h, w, _COUT), dtype=torch.bfloat16, device=dev),  # u
        torch.empty((bsz, h, w, _COUT), dtype=torch.bfloat16, device=dev),  # out
        torch.empty((bsz, nblk, 2, _CIN), dtype=torch.float32, device=dev),  # partial stats
        torch.empty((bsz, 2, _CIN), dtype=torch.float32, device=dev),  # mean, rstd
    ]
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.ppst_fused_tap_fwd(*[a.data_ptr() for a in args], bsz, n, cin,
                                     _COUT, _COUT, stream)
    _nvcc.check(lib, err, "fused_tap_1x1")
    fused_tap_1x1.launches += 1
    return args[9]


fused_tap_1x1.launches = 0
