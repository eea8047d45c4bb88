"""Bias + leaky ReLU + gain (K5) on NHWC tensors.

Counterpart of ``ppst_tpu/ops/fused_act_pallas.py``. On a CUDA tensor
``fused_leaky_relu_cuda`` launches the hand-written kernel in
``csrc/fused_act.cu`` (whose header gives the design and its bound); on a CPU
tensor it runs ``fused_leaky_relu_cuda_reference``, the plain PyTorch version
of the same function. There is no other path. Like the TPU kernel it is a
standalone op: the networks run bias and activation as a convolution's
epilogue (``ops/fused_act.py``).

The kernel is compiled with ``nvcc`` for sm_90a at first use into
``ppst_tpu_torch/_build/`` and bound through ``ctypes`` (``ops._nvcc``).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ppst_tpu_torch.ops import _nvcc
from ppst_tpu_torch.ops.fused_act import SQRT2, fused_leaky_relu

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


@functools.lru_cache(maxsize=None)
def _lib():
    lib = _nvcc.load("fused_act")
    fn = lib.ppst_fused_leaky_relu
    fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_longlong, ctypes.c_int]
                   + [ctypes.c_float] * 2 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return lib


# The plain PyTorch version is the port's op itself: its add, slope product and
# gain product each round to x's dtype, as the kernel does.
fused_leaky_relu_cuda_reference = fused_leaky_relu


def fused_leaky_relu_cuda(x, bias, negative_slope: float = 0.2, scale: float = SQRT2):
    """``where(y >= 0, y, negative_slope * y) * scale`` with ``y = x +
    bias``, bias (C,) cast to ``x``'s dtype first, on ``x`` whose last axis
    is C (NHWC). Returns a tensor of ``x``'s shape and dtype.

    CPU tensors run the plain version. CUDA tensors launch the kernel
    (float32 or bfloat16), and anything else raises.
    """
    if x.dim() < 1 or x.numel() < 1 or tuple(bias.shape) != (x.shape[-1],):
        raise ValueError(f"fused_leaky_relu_cuda: bias must be (C,) of x's last axis, got x "
                         f"{tuple(x.shape)}, bias {tuple(bias.shape)}")
    if x.device.type == "cpu":
        return fused_leaky_relu_cuda_reference(x, bias, negative_slope, scale)
    if x.device.type != "cuda" or bias.device != x.device:
        raise ValueError(f"fused_leaky_relu_cuda: unsupported device: x on {x.device}, bias on "
                         f"{bias.device}")
    if x.dtype not in _DTYPES:
        raise ValueError(f"fused_leaky_relu_cuda: x must be float32 or bfloat16, got {x.dtype}")
    c = x.shape[-1]
    x = x.contiguous()
    b = bias.detach().to(x.dtype).contiguous()
    out = torch.empty_like(x)
    lib = _lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.ppst_fused_leaky_relu(x.data_ptr(), b.data_ptr(), out.data_ptr(),
                                        _DTYPES[x.dtype], x.numel(), c, negative_slope, scale,
                                        stream)
    _nvcc.check(lib, err, "fused_leaky_relu_cuda")
    fused_leaky_relu_cuda.launches += 1
    return out


fused_leaky_relu_cuda.launches = 0
