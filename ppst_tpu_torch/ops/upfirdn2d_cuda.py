"""Separable FIR filter with zero pads and a downsample (K4) on NHWC tensors.

Counterpart of ``ppst_tpu/ops/upfirdn2d_pallas.py``. On a CUDA tensor
``upfirdn2d_cuda`` launches the hand-written kernel in ``csrc/upfirdn2d.cu``
(whose header gives the design and its bound); on a CPU tensor it runs
``upfirdn2d_cuda_reference``, the plain PyTorch version of the same function.
There is no other path. Like the TPU kernel it is a standalone op: the
networks fold the blur into their convolutions (``ops/upfirdn2d.py``).

The kernel is compiled with ``nvcc`` for sm_90a at first use into
``ppst_tpu_torch/_build/`` and bound through ``ctypes`` (``ops._nvcc``).
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ppst_tpu_torch.ops import _nvcc

MAX_TAPS = 8
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


@functools.lru_cache(maxsize=None)
def _lib():
    lib = _nvcc.load("upfirdn2d")
    fn = lib.ppst_upfirdn2d
    fn.argtypes = ([ctypes.c_void_p] * 2 + [ctypes.c_int] * 7
                   + [ctypes.POINTER(ctypes.c_float)] + [ctypes.c_int] * 3 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return lib


def _check_args(x, taps, down, pad, up):
    """The filter's taps (float64) and output size; raises on what the
    kernel does not take, on any device (as the TPU kernel asserts)."""
    taps = np.asarray(taps, np.float64).reshape(-1)
    p0, p1 = int(pad[0]), int(pad[1])
    if up != 1:
        raise ValueError(f"upfirdn2d_cuda: up must be 1, got {up}")
    if down not in (1, 2):
        raise ValueError(f"upfirdn2d_cuda: down must be 1 or 2, got {down}")
    if p0 < 0 or p1 < 0:
        raise ValueError(f"upfirdn2d_cuda: pads must be non-negative, got {(p0, p1)}")
    if not 1 <= taps.size <= MAX_TAPS:
        raise ValueError(f"upfirdn2d_cuda: 1 to {MAX_TAPS} taps, got {taps.size}")
    if x.dim() != 4:
        raise ValueError(f"upfirdn2d_cuda: x must be NHWC, got shape {tuple(x.shape)}")
    _, h, w, _ = x.shape
    t = taps.size
    if min(h, w) + p0 + p1 < t:
        raise ValueError(f"upfirdn2d_cuda: {h}x{w} padded by {(p0, p1)} is smaller than "
                         f"{t} taps")
    return taps, (p0, p1), ((h + p0 + p1 - t) // down + 1, (w + p0 + p1 - t) // down + 1)


def upfirdn2d_cuda_reference(x, taps, down: int = 1, pad=(0, 0), up: int = 1):
    """Plain PyTorch version: zero-pad, correlate with the flipped taps along
    W then H keeping every ``down``-th sample, in float32, rounded once to
    ``x``'s dtype."""
    taps, (p0, p1), (oh, ow) = _check_args(x, taps, down, pad, up)
    f = taps[::-1].astype(np.float32)
    xp = torch.nn.functional.pad(x.float(), (0, 0, p0, p1, p0, p1))
    span_h, span_w = down * (oh - 1) + 1, down * (ow - 1) + 1
    rows = sum(float(f[k]) * xp[:, :, k : k + span_w : down] for k in range(len(f)))
    out = sum(float(f[k]) * rows[:, k : k + span_h : down] for k in range(len(f)))
    return out.to(x.dtype)


def upfirdn2d_cuda(x, taps, down: int = 1, pad=(0, 0), up: int = 1):
    """``upfirdn2d`` of NHWC ``x`` with the separable 1-D ``taps`` (at most
    8, normalized by the caller), up = 1, ``down`` in {1, 2} and
    non-negative ``pad`` (pad0, pad1) on both spatial axes. Returns (B,
    (H + p0 + p1 - T) // down + 1, same for W, C) in ``x``'s dtype.

    CPU tensors run the plain version. CUDA tensors launch the kernel
    (float32 or bfloat16, any C), and anything else raises.
    """
    if x.device.type == "cpu":
        return upfirdn2d_cuda_reference(x, taps, down, pad, up)
    taps, (p0, _), (oh, ow) = _check_args(x, taps, down, pad, up)
    if x.device.type != "cuda":
        raise ValueError(f"upfirdn2d_cuda: unsupported device {x.device}")
    if x.dtype not in _DTYPES:
        raise ValueError(f"upfirdn2d_cuda: x must be float32 or bfloat16, got {x.dtype}")
    b, h, w, c = x.shape
    if min(b, c) < 1:
        raise ValueError(f"upfirdn2d_cuda: empty shape {tuple(x.shape)}")
    x = x.contiguous()
    out = torch.empty((b, oh, ow, c), dtype=x.dtype, device=x.device)
    flipped = (ctypes.c_float * len(taps))(*[float(v) for v in taps[::-1]])
    lib = _lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.ppst_upfirdn2d(x.data_ptr(), out.data_ptr(), _DTYPES[x.dtype], b, h, w, c,
                                 oh, ow, flipped, len(taps), p0, down, stream)
    _nvcc.check(lib, err, "upfirdn2d_cuda")
    upfirdn2d_cuda.launches += 1
    return out


upfirdn2d_cuda.launches = 0
