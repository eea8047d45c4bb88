"""Separable FIR filter with zero pads and a downsample (K4) on NHWC tensors.

Counterpart of ``ppst_tpu/ops/upfirdn2d_pallas.py``. On a CUDA tensor
``upfirdn2d_cuda`` launches the hand-written kernel in ``csrc/upfirdn2d.cu``
(whose header gives the design and its bound); on a CPU tensor it runs
``upfirdn2d_cuda_reference``, the plain PyTorch version of the same function.
There is no other path. Like the TPU kernel it is a standalone op: the
networks fold the blur into their convolutions (``ops/upfirdn2d.py``).

The kernel has two routes, chosen from the shape and the pointers by
``tma_route`` (never from a failure), each counted in
``upfirdn2d_cuda.route_launches``: the persistent TMA-fed separable stencil
when C * itemsize is a multiple of 16 and both pointers are 16-byte aligned
(its items are laid out by ``tma_plan``), else one thread per output pixel.

The kernel is compiled with ``nvcc`` for sm_90a at first use into
``ppst_tpu_torch/_build/`` and bound through ``ctypes`` (``ops._nvcc``).
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import numpy as np
import torch

from ppst_tpu_torch.ops import _nvcc

MAX_TAPS = 8
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# the TMA route's limits, as csrc/upfirdn2d.cu sets them (kConsumers,
# kStages, kMaxBox, kMaxSmem): 256 consumer threads a block (one an output
# column and 16-byte channel group of a strip), a ring of 3 bands, box sides
# of at most 256 elements, 232448 bytes of shared memory a block
TMA_CONSUMERS, RING_STAGES, MAX_BOX, MAX_SMEM = 256, 3, 256, 232448
# tma_plan's choices: bands of about STAGE_BYTES, BLOCKS_PER_SM blocks an SM
STAGE_BYTES, BLOCKS_PER_SM = 32768, 2
MAX_STRIP_COLUMNS, MAX_BAND_ROWS, MIN_ITEM_ROWS = 64, 32, 8


def bind(lib):
    """Set the argument types of ``lib``'s C entries (a build of an earlier
    source may lack ``ppst_upfirdn2d_tma``) and return ``lib``."""
    base = ([ctypes.c_void_p] * 2 + [ctypes.c_int] * 7 + [ctypes.POINTER(ctypes.c_float)]
            + [ctypes.c_int] * 3)
    lib.ppst_upfirdn2d.argtypes = base + [ctypes.c_void_p]
    lib.ppst_upfirdn2d.restype = ctypes.c_int
    if hasattr(lib, "ppst_upfirdn2d_tma"):
        lib.ppst_upfirdn2d_tma.argtypes = (base + [ctypes.c_int] * len(TmaPlan.ENTRY_FIELDS)
                                           + [ctypes.c_void_p])
        lib.ppst_upfirdn2d_tma.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def _lib():
    return bind(_nvcc.load("upfirdn2d"))


@functools.lru_cache(maxsize=None)
def _sm_count(index):
    return torch.cuda.get_device_properties(index).multi_processor_count


def tma_route(x, out, ntaps) -> bool:
    """Whether ``x`` -> ``out`` takes the TMA route: the tensor map's strides
    need C * itemsize a multiple of 16 bytes and both pointers 16-byte
    aligned, and the kernel takes at most MAX_TAPS taps."""
    return (x.shape[-1] * x.element_size() % 16 == 0 and x.data_ptr() % 16 == 0
            and out.data_ptr() % 16 == 0 and ntaps <= MAX_TAPS)


class TmaPlan(NamedTuple):
    """The TMA route's items: ``groups`` 16-byte channel groups a pixel,
    ``cg`` a strip, ``tw`` output columns a strip, ``bw`` input columns and
    ``rows`` input rows a band, ``rh`` output rows an item; ``ncs``,
    ``nxs`` and ``nys`` strips along channels, columns and rows, ``items``
    in all; ``stage`` bytes a band and ``smem`` bytes of shared memory a
    block, on ``grid`` persistent blocks. The kernel takes the fields from
    ``cg`` on (``ENTRY_FIELDS``) as they are and only checks them."""

    oh: int
    ow: int
    groups: int
    cg: int
    tw: int
    bw: int
    rows: int
    rh: int
    ncs: int
    nxs: int
    nys: int
    items: int
    stage: int
    smem: int
    grid: int

    ENTRY_FIELDS = ("cg", "tw", "bw", "rows", "rh", "ncs", "nxs", "nys", "items", "stage", "smem",
                    "grid")


@functools.lru_cache(maxsize=None)
def tma_plan(shape, itemsize, ntaps, down, pad, sms):
    """The TMA route's ``TmaPlan`` for NHWC ``shape`` on ``sms`` SMs. A
    strip is ``cg``
    16-byte channel groups (up to 256 bytes of a pixel) x ``tw`` output
    columns (at most 256 threads, and no wider than the output); a band is
    ``rows`` input rows x ``bw`` columns, about STAGE_BYTES; an item is
    ``rh`` output rows of a strip. ``rh`` minimises the rows of the busiest
    block, ceil(items / blocks) x (input rows of an item), over segments of
    at least MIN_ITEM_ROWS rows; ties go to fewer segments (less halo)."""
    b, h, w, c = shape
    t, (p0, p1) = ntaps, pad
    oh, ow = (h + p0 + p1 - t) // down + 1, (w + p0 + p1 - t) // down + 1
    groups = c * itemsize // 16
    cg = min(16, groups)
    tw = min(MAX_STRIP_COLUMNS, TMA_CONSUMERS // cg, ow)
    bw = (tw - 1) * down + t
    rows = max(1, min(MAX_BAND_ROWS, STAGE_BYTES // (bw * cg * 16)))
    ncs, nxs = -(-groups // cg), -(-ow // tw)
    strips = b * ncs * nxs
    blocks = BLOCKS_PER_SM * sms
    best = None
    for segs in range(1, max(1, oh // MIN_ITEM_ROWS) + 1):
        rh = -(-oh // segs)
        nys = -(-oh // rh)
        cost = math.ceil(strips * nys / blocks) * ((rh - 1) * down + t)
        if best is None or cost < best[0]:
            best = (cost, rh, nys)
    _, rh, nys = best
    items = strips * nys
    stage = -(-rows * bw * cg * 16 // 128) * 128
    smem = RING_STAGES * (stage + 16) + 128  # the ring, its mbarriers, 128-byte alignment
    return TmaPlan(oh, ow, groups, cg, tw, bw, rows, rh, ncs, nxs, nys, items, stage, smem,
                   min(items, blocks))


def c_entry(lib, x, out, taps, down, pad, route):
    """``lib``'s C entry for ``route`` ("tma", planned by ``tma_plan``, or
    "generic") and its arguments but the last: NHWC ``x`` filtered by
    ``taps`` (as given; flipped here) into ``out``. ``entry(*args,
    stream)`` launches it and returns its error code."""
    b, h, w, c = x.shape
    oh, ow = out.shape[1:3]
    flipped = (ctypes.c_float * len(taps))(*[float(v) for v in np.asarray(taps)[::-1]])
    args = (x.data_ptr(), out.data_ptr(), _DTYPES[x.dtype], b, h, w, c, oh, ow, flipped,
            len(taps), pad[0], down)
    if route == "generic":
        return lib.ppst_upfirdn2d, args
    plan = tma_plan(tuple(x.shape), x.element_size(), len(taps), down, tuple(pad),
                    _sm_count(x.device.index))
    return lib.ppst_upfirdn2d_tma, (*args, *(getattr(plan, f) for f in plan.ENTRY_FIELDS))


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
    (float32 or bfloat16, any C) on the route ``tma_route`` picks, and
    anything else raises.
    """
    if x.device.type == "cpu":
        return upfirdn2d_cuda_reference(x, taps, down, pad, up)
    taps, (p0, p1), (oh, ow) = _check_args(x, taps, down, pad, up)
    if x.device.type != "cuda":
        raise ValueError(f"upfirdn2d_cuda: unsupported device {x.device}")
    if x.dtype not in _DTYPES:
        raise ValueError(f"upfirdn2d_cuda: x must be float32 or bfloat16, got {x.dtype}")
    b, h, w, c = x.shape
    if min(b, c) < 1:
        raise ValueError(f"upfirdn2d_cuda: empty shape {tuple(x.shape)}")
    x = x.contiguous()
    out = torch.empty((b, oh, ow, c), dtype=x.dtype, device=x.device)
    route = "tma" if tma_route(x, out, len(taps)) else "generic"
    lib = _lib()
    entry, args = c_entry(lib, x, out, taps, down, (p0, p1), route)
    with torch.cuda.device(x.device):
        err = entry(*args, torch.cuda.current_stream(x.device).cuda_stream)
    _nvcc.check(lib, err, f"upfirdn2d_cuda ({route} route)")
    upfirdn2d_cuda.launches += 1
    upfirdn2d_cuda.route_launches[route] += 1
    return out


upfirdn2d_cuda.launches = 0
upfirdn2d_cuda.route_launches = {"tma": 0, "generic": 0}
