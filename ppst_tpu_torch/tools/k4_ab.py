"""K4 (upfirdn2d) on one card: checked against its plain version, timed
against an earlier version of its source and against the one PyTorch call
that computes the same function.

    python -m ppst_tpu_torch.tools.k4_ab --quick
    python -m ppst_tpu_torch.tools.k4_ab [--parent DIR]

``--quick`` builds ``csrc/upfirdn2d.cu``, prints ptxas's report of it
(registers, shared memory and spills of each instance), runs G's blur at the
record shape (8, 512, 512, 128) bf16, D's downsample at the same shape, an
odd float32 shape with three taps (the TMA route's general instance) and an
odd shape of each dtype on the generic route, each once through the wrapper,
synchronises, compares each with the plain version (``within``, the
tolerances ``chip_smoke.py`` and ``tests/test_torch_fir_tiles.py`` hold K4
to) and stops.

Otherwise it checks and times the kernel at G's blur and D's downsample at
(8, 512, 512, 128) and at (8, 128, 128, 512) (down 1, pad (2, 1)) and (8,
256, 256, 256) (down 2, pad (1, 1)), in bf16 and float32, straight through
its C interface (no wrapper host time; the wrapper's time beside it), with
the library call beside it: one depthwise ``torch.nn.functional.conv2d`` on
a channels-last view of x, weight outer(f, f) of the flipped taps, groups=C,
stride=down and symmetric padding p0 (its first OH x OW outputs are K4's).
With ``--parent DIR``, a checkout of an earlier commit, that commit's
``ppst_tpu_torch/csrc/upfirdn2d.cu`` is built as well and timed in turns with
this one (earlier, this, this, earlier) through its ``ppst_upfirdn2d``. One
JSON line per shape, with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from ppst_tpu_torch.ops import _nvcc
from ppst_tpu_torch.ops import upfirdn2d_cuda as fir
from ppst_tpu_torch.tools import card

# the memory rate of an H100 SXM (NVIDIA's data sheet)
H100_BYTES = 3.35e12
# K4 against its plain version (both sum in float32, in another order, and
# round once): float32 within 1e-5 of max(1, max|out|); bf16 within one bf16
# step (2^-7 relative) of each element plus that float32 bound (outputs near
# zero, where the two float32 sums differ by more than a bf16 step)
K4_F32_MAX, K4_BF16_REL = 1e-5, 2.0**-7
BLUR = (1, 3, 3, 1)
# (shape, dtype, taps, pad, down)
QUICK = [((8, 512, 512, 128), torch.bfloat16, BLUR, (2, 1), 1),
         ((8, 512, 512, 128), torch.bfloat16, BLUR, (1, 1), 2),
         ((3, 37, 21, 24), torch.float32, (1, 2, 1), (2, 1), 2),
         ((2, 19, 33, 20), torch.bfloat16, (1, 2, 3), (1, 2), 1),
         ((2, 19, 33, 3), torch.float32, (1, 2, 3), (1, 2), 2)]
TIMED = [(shape, dt, BLUR, pad, down)
         for dt in (torch.bfloat16, torch.float32)
         for shape, pad, down in (((8, 512, 512, 128), (2, 1), 1), ((8, 512, 512, 128), (1, 1), 2),
                                  ((8, 128, 128, 512), (2, 1), 1), ((8, 256, 256, 256), (1, 1), 2))]


def within(got, want):
    """K4's output ``got`` against the plain version's ``want``: (whether
    it has the shape, is finite and lies within K4_F32_MAX / K4_BF16_REL,
    the largest absolute error)."""
    if got.shape != want.shape:
        return False, float("inf")
    err = (got.float() - want.float()).abs()
    tol = K4_F32_MAX * max(1.0, want.float().abs().max().item())
    if got.dtype != torch.float32:
        tol = K4_BF16_REL * want.float().abs() + tol
    ok = bool(torch.isfinite(got.float()).all().item() and (err <= tol).all().item())
    return ok, err.max().item()


def library_call(x, taps, down, pad):
    """The one PyTorch call that computes K4's function: a depthwise conv2d
    of the channels-last view of NHWC ``x`` (weight outer(f, f) of the
    flipped taps, stride ``down``, symmetric padding p0, which needs p0 >=
    p1); returns the call and the slice of its NCHW output that equals K4's
    NHWC output."""
    p0, p1 = pad
    if p0 < p1:
        raise ValueError(f"library_call: symmetric padding needs p0 >= p1, got {pad}")
    c = x.shape[3]
    f = torch.tensor(np.asarray(taps, np.float64)[::-1].copy(), dtype=torch.float32)
    weight = torch.outer(f, f).to(x.device, x.dtype).expand(c, 1, -1, -1)
    weight = weight.contiguous(memory_format=torch.channels_last)
    xc = x.permute(0, 3, 1, 2)  # NCHW shape, channels-last strides: no copy

    def call():
        return F.conv2d(xc, weight, stride=down, padding=p0, groups=c)

    def as_nhwc(y):
        oh = (x.shape[1] + p0 + p1 - len(taps)) // down + 1
        ow = (x.shape[2] + p0 + p1 - len(taps)) // down + 1
        return y[:, :, :oh, :ow].permute(0, 2, 3, 1)

    return call, as_nhwc


def build(src: Path):
    """Build ``src``, print ptxas's report, bind its C entries."""
    t0 = time.perf_counter()
    path = _nvcc.build(src)
    print(f"[build] {src} in {time.perf_counter() - t0:.1f} s", flush=True)
    for line in _nvcc.ptxas_summary(path):
        print(f"[ptxas] {line}", flush=True)
    lib = ctypes.CDLL(str(path))
    lib.ppst_cuda_error_string.argtypes = [ctypes.c_int]
    lib.ppst_cuda_error_string.restype = ctypes.c_char_p
    return fir.bind(lib)


def c_call(lib, x, out, taps, down, pad, route):
    """A launch of ``lib``'s entry for ``route`` ("tma" or "generic") into
    ``out``, as the wrapper launches it (the arguments made beforehand: the
    time is the C call's alone)."""
    entry, args = fir.c_entry(lib, x, out, taps, down, pad, route)

    def run():
        err = entry(*args, torch.cuda.current_stream().cuda_stream)
        _nvcc.check(lib, err, f"upfirdn2d ({route})")

    return run


def check(x, k, down, pad, name):
    """The wrapper against the plain version (``within``), and the same
    bits again; returns (ok, max_abs_err, route)."""
    before = dict(fir.upfirdn2d_cuda.route_launches)
    got = fir.upfirdn2d_cuda(x, k, down=down, pad=pad)
    torch.cuda.synchronize()
    route = next(r for r, n in fir.upfirdn2d_cuda.route_launches.items() if n != before[r])
    ok, mx = within(got, fir.upfirdn2d_cuda_reference(x, k, down=down, pad=pad))
    ok = ok and torch.equal(got, fir.upfirdn2d_cuda(x, k, down=down, pad=pad))
    print(f"[check] {name}: route {route}, max_abs_err {mx}, deterministic and within: {ok}",
          flush=True)
    return ok, mx, route


def times(fns, reps=20):
    """Median ms of each of ``fns``, in turns (forward then reversed order)."""
    for f in fns:
        for _ in range(3):
            f()
    out = [[] for _ in fns]
    for r in range(reps):
        order = range(len(fns)) if r % 2 == 0 else reversed(range(len(fns)))
        for i in order:
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            fns[i]()
            end.record()
            torch.cuda.synchronize()
            out[i].append(start.elapsed_time(end))
    return [statistics.median(t) for t in out]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--parent", type=Path, default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("k4_ab: no CUDA device", file=sys.stderr)
        return 1
    name = card()
    print(name, flush=True)
    torch.backends.cudnn.allow_tf32 = False
    new = build(_nvcc.PKG / "csrc" / "upfirdn2d.cu")
    fir._lib()
    old = build(args.parent / "ppst_tpu_torch" / "csrc" / "upfirdn2d.cu") if args.parent else None
    failed = False
    g = torch.Generator(device="cuda").manual_seed(5)
    for shape, dt, taps, pad, down in QUICK if args.quick else TIMED:
        x = torch.randn(shape, generator=g, device="cuda").to(dt)
        k = np.asarray(taps, np.float32) / sum(taps)
        label = f"{shape} {str(dt).split('.')[-1]} taps {taps} pad {pad} down {down}"
        ok, mx, route = check(x, k, down, pad, label)
        failed |= not ok
        if args.quick:
            continue
        want = fir.upfirdn2d_cuda_reference(x, k, down=down, pad=pad)
        out = torch.empty_like(want)
        lib_fn, as_nhwc = library_call(x, k, down, pad)
        lib_err = (as_nhwc(lib_fn()).float() - want.float()).abs().max().item()
        fns = [c_call(new, x, out, k, down, pad, route), lib_fn,
               lambda: fir.upfirdn2d_cuda(x, k, down=down, pad=pad)]
        if old is not None:
            fns.append(c_call(old, x, torch.empty_like(want), k, down, pad, "generic"))
        ms = times(fns)
        nbytes = (x.numel() + want.numel()) * x.element_size()
        bound_ms = nbytes / H100_BYTES * 1e3
        rec = dict(shape=shape, dtype=str(dt).split(".")[-1], pad=pad, down=down, route=route,
                   ms=ms[0], wrapper_ms=ms[2], library_ms=ms[1],
                   parent_ms=ms[3] if old is not None else None, bound_ms=bound_ms,
                   share_of_bound=bound_ms / ms[0],
                   parent_share=bound_ms / ms[3] if old is not None else None,
                   max_abs_err=mx, library_max_abs_err=lib_err, card=name)
        print(json.dumps(rec), flush=True)
    print("k4_ab:", "FAILED" if failed else "ok", flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
