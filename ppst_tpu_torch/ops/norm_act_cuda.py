"""K8: an instance norm and what follows it as one hand-written kernel pair,
on bf16 NHWC tensors, for passes without gradient: the conv's bias before
the norm, a residual after it, and leaky ReLU x sqrt(2) or PReLU, each
optional. It runs every instance norm of extraction: E1's ConvLayers, G's
3x3 feature taps and the fuse blocks' ``_ResidualBlock``s.

Its plain version is the composite itself, ``nn.layers.norm_act_chain``
(which the grad and float32 paths run): on a CPU tensor ``norm_act`` runs
it; on a CUDA tensor it launches the two kernels of ``csrc/norm_act.cu``
(whose header gives the design and its bound), which round where the
composite rounds and sum the statistics in another (fixed) order. There is
no other path. It replaces no TPU kernel: XLA fused this chain on the TPU.

The kernels are compiled with ``nvcc`` for sm_90a at first use into
``ppst_tpu_torch/_build/`` and bound through ``ctypes`` (``ops._nvcc``).
While a profiler runs, each call's host side on the card is the span
``ppst.op:norm_act:<B>,<H>,<W>,<C>,<R>,<P>`` (``util.spans``; R is 1 with a
residual, P the float32 parameter values read: C for the pre-bias, C for the
leaky ReLU's bias, 1 for the slope), the shape ``benchmark/roofline/
norm_act.py`` gives a call; ``norm_act.launches`` counts its kernel
launches, two a call.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ppst_tpu_torch.ops import _nvcc
from ppst_tpu_torch.ops._slabs import MAX_BATCH, MAX_C, counters, plan, threads
from ppst_tpu_torch.util.spans import span

# ppst_norm_act's parameters: y, pre_bias, residual, act_bias, slope; out,
# scratch, counters; B, n, C, slabs; the stream
ENTRY_ARGTYPES = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4 + [ctypes.c_void_p]


@functools.lru_cache(maxsize=None)
def _lib():
    lib = _nvcc.load("norm_act")
    lib.ppst_norm_act.argtypes = ENTRY_ARGTYPES
    lib.ppst_norm_act.restype = ctypes.c_int
    for name, args in (("ppst_norm_act_scratch_floats", [ctypes.c_int] * 3),
                       ("ppst_norm_act_counters", [ctypes.c_int] * 2)):
        getattr(lib, name).argtypes = args
        getattr(lib, name).restype = ctypes.c_longlong
    lib.ppst_norm_act_resident.argtypes = [ctypes.c_int]
    lib.ppst_norm_act_resident.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def _card(device: torch.device, c: int) -> tuple:
    """(SMs, blocks of every pass an SM holds) on ``device`` for C channels."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return sms, _lib().ppst_norm_act_resident(threads(c)[0])


def check_inputs(y, pre_bias=None, residual=None, act_bias=None, slope=None):
    """Raise ``ValueError`` unless the kernels take these arguments: y (B, H,
    W, C) bf16, contiguous and 16-byte aligned, C a multiple of 8 up to 2048;
    pre_bias and act_bias None or (C,) float32 contiguous; slope None or one
    float32; not both act_bias and slope; residual None or bf16, y's shape,
    contiguous and 16-byte aligned; all on y's device."""
    name = "norm_act"
    if y.dim() != 4 or y.dtype != torch.bfloat16 or not y.is_contiguous():
        raise ValueError(f"{name}: y must be contiguous bf16 (B, H, W, C), got {y.dtype} "
                         f"{tuple(y.shape)} strides {y.stride()}")
    b, h, w, c = y.shape
    if c % 8 or not 8 <= c <= MAX_C or not 1 <= b <= MAX_BATCH or h * w < 1:
        raise ValueError(f"{name}: C must be a multiple of 8 in [8, {MAX_C}] and B in "
                         f"[1, {MAX_BATCH}], got {tuple(y.shape)}")
    if y.data_ptr() % 16:
        raise ValueError(f"{name}: y must be 16-byte aligned")
    for label, v in (("pre_bias", pre_bias), ("act_bias", act_bias)):
        if v is not None and (v.dtype != torch.float32 or tuple(v.shape) != (c,)
                              or not v.is_contiguous()):
            raise ValueError(f"{name}: {label} must be contiguous float32 ({c},), got {v.dtype} "
                             f"{tuple(v.shape)}")
    if slope is not None and (slope.dtype != torch.float32 or slope.numel() != 1):
        raise ValueError(f"{name}: slope must be one float32, got {slope.dtype} "
                         f"{tuple(slope.shape)}")
    if act_bias is not None and slope is not None:
        raise ValueError(f"{name}: one activation: leaky ReLU (act_bias) or PReLU (slope)")
    if residual is not None and (residual.dtype != torch.bfloat16 or residual.shape != y.shape
                                 or not residual.is_contiguous() or residual.data_ptr() % 16):
        raise ValueError(f"{name}: residual must be contiguous 16-byte aligned bf16 "
                         f"{tuple(y.shape)}, got {residual.dtype} {tuple(residual.shape)}")
    for v in (pre_bias, residual, act_bias, slope):
        if v is not None and v.device != y.device:
            raise ValueError(f"{name}: an argument is on {v.device}, y on {y.device}")


def norm_act(y, pre_bias=None, residual=None, act_bias=None, slope=None):
    """An instance norm and what follows it (``nn.layers.norm_act_chain``,
    which gives the arithmetic): ``y`` (B, H, W, C) a convolution's output
    before its bias ``pre_bias`` (C,); ``residual`` (B, H, W, C) added after
    the norm; then leaky ReLU x sqrt(2) after adding ``act_bias`` (C,), or
    PReLU with the scalar ``slope`` (1,), or no activation. Returns (B, H, W,
    C) in y's dtype.

    CPU tensors run the composite. CUDA tensors launch the kernels, which
    take what ``check_inputs`` takes, and anything else raises before any
    launch."""
    if y.device.type == "cpu":
        from ppst_tpu_torch.nn.layers import norm_act_chain

        return norm_act_chain(y, pre_bias, residual, act_bias, slope)
    if y.device.type != "cuda":
        raise ValueError(f"norm_act: unsupported device {y.device}")
    c = y.shape[-1]
    params = c * (pre_bias is not None) + c * (act_bias is not None) + (slope is not None)
    with span("op:norm_act", y.shape, residual is not None, params):
        return _launch(y, pre_bias, residual, act_bias, slope)


def _ptr(v):
    return None if v is None else v.data_ptr()


def _launch(y, pre_bias=None, residual=None, act_bias=None, slope=None):
    check_inputs(y, pre_bias, residual, act_bias, slope)
    b, h, w, c = y.shape
    n = h * w
    dev = y.device
    lib = _lib()
    with torch.cuda.device(dev):
        slabs = plan(b, n, c, *_card(dev, c))
        out = torch.empty_like(y)
        scratch = torch.empty((lib.ppst_norm_act_scratch_floats(b, c, slabs),),
                              dtype=torch.float32, device=dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        tickets = counters(dev, stream, lib.ppst_norm_act_counters(b, slabs))
        err = lib.ppst_norm_act(
            y.data_ptr(), _ptr(pre_bias), _ptr(residual), _ptr(act_bias), _ptr(slope),
            out.data_ptr(), scratch.data_ptr(), tickets.data_ptr(), b, n, c, slabs, stream)
    _nvcc.check(lib, err, "norm_act")
    norm_act.launches += 2
    return out


norm_act.launches = 0
