"""The StyledConv epilogue as one hand-written kernel: what follows G's
convolution in a StyledConv (the conv's bias, the noise, StyledConv's bias,
the activation's bias, leaky ReLU and its gain, the instance norm and the
style modulation) on bf16 NHWC tensors, for passes without gradient.

Its plain version is the composite itself, ``nn.layers.styled_conv_epilogue``
(which the grad and float32 paths run): on a CPU tensor ``styled_epilogue``
runs it; on a CUDA tensor it launches the two kernels of
``csrc/styled_epilogue.cu`` (whose header gives the design and its bound),
which round where the composite rounds and sum the statistics in another
(fixed) order. There is no other path. It replaces no TPU kernel: XLA fused
this chain on the TPU (``ppst_tpu/nn/layers.py`` StyledConv).

The kernels are compiled with ``nvcc`` for sm_90a at first use into
``ppst_tpu_torch/_build/`` and bound through ``ctypes`` (``ops._nvcc``).
While a profiler runs, each call's host side on the card is the span
``ppst.op:styled_epilogue:<B>,<H>,<W>,<C>`` (``util.spans``), beside the
``.launches`` count.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ppst_tpu_torch.ops import _nvcc
from ppst_tpu_torch.ops._slabs import MAX_BATCH, MAX_C, counters, plan, threads
from ppst_tpu_torch.util.spans import span


# ppst_styled_epilogue's parameters: y, noise, the three biases, gain, style;
# style's row stride; out, scratch, counters; B, n, C, slabs; the stream
ENTRY_ARGTYPES = ([ctypes.c_void_p] * 7 + [ctypes.c_longlong] + [ctypes.c_void_p] * 3
                  + [ctypes.c_int] * 4 + [ctypes.c_void_p])


@functools.lru_cache(maxsize=None)
def _lib():
    lib = _nvcc.load("styled_epilogue")
    fn = lib.ppst_styled_epilogue
    fn.argtypes = ENTRY_ARGTYPES
    fn.restype = ctypes.c_int
    for name, args in (("ppst_styled_epilogue_scratch_floats", [ctypes.c_int] * 3),
                       ("ppst_styled_epilogue_counters", [ctypes.c_int] * 2)):
        getattr(lib, name).argtypes = args
        getattr(lib, name).restype = ctypes.c_longlong
    lib.ppst_styled_epilogue_resident.argtypes = [ctypes.c_int]
    lib.ppst_styled_epilogue_resident.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def _card(device: torch.device, c: int) -> tuple:
    """(SMs, blocks of either pass an SM holds) on ``device`` for C channels."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return sms, _lib().ppst_styled_epilogue_resident(threads(c)[0])


def check_inputs(y, conv_bias, gain, noise, bias, act_bias, style):
    """Raise ``ValueError`` unless the kernels take these arguments: y (B, H,
    W, C) bf16, contiguous and 16-byte aligned, C a multiple of 8 up to 2048;
    the three biases (C,) and gain (1,) float32; noise None (with gain None)
    or (B, H, W, 1) bf16 contiguous; style (B, 2C) bf16 with unit channel
    stride (its rows may lie further apart); all on y's device."""
    name = "styled_epilogue"
    if y.dim() != 4 or y.dtype != torch.bfloat16 or not y.is_contiguous():
        raise ValueError(f"{name}: y must be contiguous bf16 (B, H, W, C), got {y.dtype} "
                         f"{tuple(y.shape)} strides {y.stride()}")
    b, h, w, c = y.shape
    if c % 8 or not 8 <= c <= MAX_C or not 1 <= b <= MAX_BATCH or h * w < 1:
        raise ValueError(f"{name}: C must be a multiple of 8 in [8, {MAX_C}] and B in "
                         f"[1, {MAX_BATCH}], got {tuple(y.shape)}")
    if y.data_ptr() % 16:
        raise ValueError(f"{name}: y must be 16-byte aligned")
    for label, v in (("conv_bias", conv_bias), ("bias", bias), ("act_bias", act_bias)):
        if v.dtype != torch.float32 or tuple(v.shape) != (c,) or not v.is_contiguous():
            raise ValueError(f"{name}: {label} must be contiguous float32 ({c},), got {v.dtype} "
                             f"{tuple(v.shape)}")
    if (noise is None) != (gain is None):
        raise ValueError(f"{name}: noise and gain come together")
    if noise is not None:
        if gain.dtype != torch.float32 or gain.numel() != 1:
            raise ValueError(f"{name}: gain must be one float32, got {gain.dtype} "
                             f"{tuple(gain.shape)}")
        if (noise.dtype != torch.bfloat16 or tuple(noise.shape) != (b, h, w, 1)
                or not noise.is_contiguous()):
            raise ValueError(f"{name}: noise must be contiguous bf16 {(b, h, w, 1)}, got "
                             f"{noise.dtype} {tuple(noise.shape)}")
    if (style.dtype != torch.bfloat16 or style.dim() != 2 or style.shape[0] != b
            or style.shape[1] != 2 * c or style.stride(1) != 1 or style.stride(0) < 2 * c):
        raise ValueError(f"{name}: style must be bf16 ({b}, {2 * c}) with unit channel stride, "
                         f"got {style.dtype} {tuple(style.shape)} strides {style.stride()}")
    for v in (conv_bias, gain, noise, bias, act_bias, style):
        if v is not None and v.device != y.device:
            raise ValueError(f"{name}: an argument is on {v.device}, y on {y.device}")


def styled_epilogue(y, conv_bias, gain, noise, bias, act_bias, style):
    """StyledConv's chain after its convolution (``nn.layers.
    styled_conv_epilogue``, which gives the arithmetic): ``y`` (B, H, W, C)
    the convolution's output before its bias; ``conv_bias``, ``bias`` and
    ``act_bias`` (C,); ``gain`` (1,) and ``noise`` (B, H, W, 1), or both
    None; ``style`` (B, 2C), the StyleMod linear's [scale, shift]. Returns
    (B, H, W, C) in y's dtype.

    CPU tensors run the composite. CUDA tensors launch the kernels, which
    take what ``check_inputs`` takes, and anything else raises before any
    launch."""
    if y.device.type == "cpu":
        from ppst_tpu_torch.nn.layers import styled_conv_epilogue

        return styled_conv_epilogue(y, conv_bias, gain, noise, bias, act_bias, style)
    if y.device.type != "cuda":
        raise ValueError(f"styled_epilogue: unsupported device {y.device}")
    with span("op:styled_epilogue", y.shape):
        return _launch(y, conv_bias, gain, noise, bias, act_bias, style)


def _launch(y, conv_bias, gain, noise, bias, act_bias, style):
    check_inputs(y, conv_bias, gain, noise, bias, act_bias, style)
    b, h, w, c = y.shape
    n = h * w
    dev = y.device
    lib = _lib()
    with torch.cuda.device(dev):
        slabs = plan(b, n, c, *_card(dev, c))
        out = torch.empty_like(y)
        scratch = torch.empty((lib.ppst_styled_epilogue_scratch_floats(b, c, slabs),),
                              dtype=torch.float32, device=dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        tickets = counters(dev, stream, lib.ppst_styled_epilogue_counters(b, slabs))
        # without noise the kernels read a float where the gain would be, and ignore it
        gain_ptr = (conv_bias if gain is None else gain).data_ptr()
        err = lib.ppst_styled_epilogue(
            y.data_ptr(), None if noise is None else noise.data_ptr(), conv_bias.data_ptr(),
            bias.data_ptr(), act_bias.data_ptr(), gain_ptr, style.data_ptr(), style.stride(0),
            out.data_ptr(), scratch.data_ptr(), tickets.data_ptr(), b, n, c, slabs, stream)
    _nvcc.check(lib, err, "styled_epilogue")
    styled_epilogue.launches += 1
    return out


styled_epilogue.launches = 0
