"""K1 and K2 (the fused feature tap, forward and backward) on one card:
checked against their plain versions, timed against an earlier version of
their sources, with each launch's device time.

    python -m ppst_tpu_torch.tools.tap_ab --quick
    python -m ppst_tpu_torch.tools.tap_ab [--parent DIR]

``--quick`` builds ``csrc/tap.cu`` and ``csrc/tap_bwd.cu``, prints ptxas's
report of both, runs the forward and the backward (with and without dx) once
at (2, 512, 512, 128) and once at the odd (3, 40, 24, 128), synchronises,
compares each with the plain version (``chip_smoke.py``'s tolerances) and
stops.

Otherwise it checks and times K1 at (2, 512, 512, 128), (16, 512, 512, 128)
and (2, 1024, 1024, 128), and K2 at (4, 512, 512, 128) and (2, 1024, 1024,
128), with and without dx: the time through the C interface, through the
wrapper (``ops/tap_cuda.py``), the wrapper's host time per call (the enqueue
time of back-to-back calls), and each launch's device time from one profiled
call. With ``--parent DIR``, a checkout of an earlier commit, that commit's
``tap.cu`` and ``tap_bwd.cu`` are built as well and timed in turns with this
tree's, both called the same way through their C interfaces, and profiled
the same way. One JSON line per shape, with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

from ppst_tpu_torch.ops import _nvcc
from ppst_tpu_torch.ops import tap_cuda

# the dense bf16 rate and memory rate of an H100 SXM (NVIDIA's data sheet)
H100_BF16_FLOPS, H100_BYTES = 989e12, 3.35e12
# chip_smoke.py's tolerances: K1 within TAP_MAX_ABS and a mean of
# TAP_MEAN_ABS; K2 each gradient within TAP_BWD_REL of its max, the bias
# gradients (a mathematical zero) at noise level
TAP_MAX_ABS, TAP_MEAN_ABS, TAP_BWD_REL = 0.06, 5e-3, 0.02
NAMES = ("dx", "dw1", "db1", "da1", "dw2", "db2", "da2")
QUICK = [(2, 512, 512, 128), (3, 40, 24, 128)]
FWD_SHAPES = [(2, 512, 512, 128), (16, 512, 512, 128), (2, 1024, 1024, 128)]
BWD_SHAPES = [(4, 512, 512, 128), (2, 1024, 1024, 128)]
# design traffic in bytes a pixel: K1 reads x twice, writes and reads t and u,
# writes out; K2 (this design) reads u, g; t, u, g; t, u, g, x (and with dx
# t, u, g, x again and writes dx)
K1_DESIGN_BYTES = 1152
K2_DESIGN_BYTES = {False: 1280, True: 2176}


def card() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def build(csrc: Path):
    """Build ``csrc``'s tap.cu and tap_bwd.cu, print ptxas's report, return
    the libraries (forward, backward) with their C interfaces bound."""
    libs = []
    for name in ("tap", "tap_bwd"):
        t0 = time.perf_counter()
        path = _nvcc.build(csrc / f"{name}.cu")
        print(f"[build] {csrc / name}.cu in {time.perf_counter() - t0:.1f} s", flush=True)
        for line in _nvcc.ptxas_summary(path):
            print(f"[ptxas] {name}.cu {line}", flush=True)
        for line in _nvcc.log(path).read_text().splitlines():
            if "arning" in line or "erialized" in line:
                print(f"[ptxas] {name}.cu {line.strip()}", flush=True)
        lib = ctypes.CDLL(str(path))
        lib.ppst_cuda_error_string.argtypes = [ctypes.c_int]
        lib.ppst_cuda_error_string.restype = ctypes.c_char_p
        libs.append(lib)
    fwd, bwd = libs
    fwd.ppst_fused_tap_fwd.argtypes = [ctypes.c_void_p] * 12 + [ctypes.c_int] * 5 + [
        ctypes.c_void_p]
    bwd.ppst_fused_tap_bwd.argtypes = [ctypes.c_void_p] * 17 + [ctypes.c_int] * 2 + [
        ctypes.c_void_p]
    bwd.ppst_fused_tap_bwd_scratch_floats.argtypes = [ctypes.c_int] * 2
    bwd.ppst_fused_tap_bwd_scratch_floats.restype = ctypes.c_long
    if hasattr(fwd, "ppst_fused_tap_fwd_scratch_floats"):
        fwd.ppst_fused_tap_fwd_scratch_floats.argtypes = [ctypes.c_int] * 2
        fwd.ppst_fused_tap_fwd_scratch_floats.restype = ctypes.c_long
    return fwd, bwd


def fwd_scratch_floats(lib, bsz, n):
    """Floats of the forward's scratch: exported since the persistent design;
    the four-pass design before it took (B, ceil(n / 256), 2, 128)."""
    if hasattr(lib, "ppst_fused_tap_fwd_scratch_floats"):
        return lib.ppst_fused_tap_fwd_scratch_floats(bsz, n)
    return bsz * -(-n // 256) * 2 * 128


def stream():
    return torch.cuda.current_stream().cuda_stream


def c_forward(lib, args):
    """A build's forward called straight through its C interface."""
    x, w1, b1, a1, w2, b2, a2 = args
    bsz, h, w, cin = x.shape
    n = h * w
    f32 = dict(dtype=torch.float32, device="cuda")
    bufs = [w1.bfloat16().contiguous(), b1.float().contiguous(), a1.float().reshape(1),
            w2.bfloat16().contiguous(), b2.float().contiguous(), a2.float().reshape(1)]
    outs = [torch.empty((bsz, h, w, 64), dtype=torch.bfloat16, device="cuda") for _ in range(3)]
    part = torch.empty((fwd_scratch_floats(lib, bsz, n),), **f32)
    mr = torch.empty((bsz * 2 * (128 + 2 * 64),), **f32)
    keep = [x, *bufs, *outs, part, mr]  # alive as long as run is
    ptrs = [v.data_ptr() for v in keep]

    def run():
        assert keep
        _nvcc.check(lib, lib.ppst_fused_tap_fwd(*ptrs, bsz, n, cin, 64, 64, stream()),
                    "tap_ab forward")

    return run, outs[2]


def c_backward(lib, x, t, u, mr, w1, w2, a1, a2, g, need_dx):
    """A build's backward called straight through its C interface."""
    bsz, h, w, _ = x.shape
    n = h * w
    f32 = dict(dtype=torch.float32, device="cuda")
    outs = [torch.empty(s, **f32) for s in ((64, 128), (64,), (1,), (64, 64), (64,), (1,))]
    dx = torch.empty_like(x) if need_dx else None
    scratch = torch.empty((lib.ppst_fused_tap_bwd_scratch_floats(bsz, n),), **f32)
    ins = [x, t, u, g, mr, w1.bfloat16().contiguous(), w2.bfloat16().contiguous(),
           a1.float().reshape(1), a2.float().reshape(1)]
    keep = ins + outs  # alive as long as run is
    ptrs = [v.data_ptr() for v in keep]

    def run():
        assert keep
        _nvcc.check(lib, lib.ppst_fused_tap_bwd(*ptrs, dx.data_ptr() if need_dx else None,
                                                scratch.data_ptr(), bsz, n, stream()),
                    "tap_ab backward")

    return run, (dx, *outs)


def inputs(shape, seed):
    """chip_smoke.py's kernel-phase inputs of K1 and K2."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn(shape, generator=g, device="cuda").bfloat16()
    w1 = torch.randn((64, 128), generator=g, device="cuda") * 0.1
    b1 = torch.randn((64,), generator=g, device="cuda") * 0.1
    w2 = torch.randn((64, 64), generator=g, device="cuda") * 0.1
    b2 = torch.randn((64,), generator=g, device="cuda") * 0.1
    a1 = torch.full((1,), 0.25, device="cuda")
    a2 = torch.full((1,), -0.1, device="cuda")
    cot = torch.randn(shape[:3] + (64,), generator=g, device="cuda").bfloat16()
    return (x, w1, b1, a1, w2, b2, a2), cot


def check_forward(args, got, shape, what):
    want = tap_cuda.fused_tap_1x1_reference(*args)
    err = (got.float() - want.float()).abs()
    mx, mean = err.max().item(), err.mean().item()
    ok = bool(torch.isfinite(got.float()).all().item() and mx <= TAP_MAX_ABS
              and mean <= TAP_MEAN_ABS)
    print(f"[check] {what} forward {shape}: max_abs_err {mx} mean_abs_err {mean} (tolerance "
          f"{TAP_MAX_ABS} / {TAP_MEAN_ABS}); within: {ok}", flush=True)
    return ok, mx


def check_backward(bargs, got, shape, need_dx, what):
    want = tap_cuda.fused_tap_1x1_bwd_reference(*bargs, need_dx)
    overall = max(v.abs().max().item() for v in want if v is not None)
    rel, ok, worst = {}, True, 0.0
    for name, a, b in zip(NAMES, got, want):
        if b is None:
            continue
        a, b = a.float(), b.float()
        bmax = b.abs().max().item()
        worst = max(worst, (a - b).abs().max().item())
        if name.startswith("db"):
            rel[name] = a.abs().max().item() / overall
            ok &= bmax < 0.02 * overall and rel[name] <= max(bmax / overall, 0.01)
        else:
            rel[name] = (a - b).abs().max().item() / bmax
            ok &= rel[name] <= TAP_BWD_REL
        ok &= bool(torch.isfinite(a).all().item())
    print(f"[check] {what} backward {shape} dx={need_dx}: max |error| / max |grad| "
          + ", ".join(f"{k} {v:.3g}" for k, v in rel.items())
          + f" (tolerance {TAP_BWD_REL}; db* as |grad| / largest); within: {bool(ok)}",
          flush=True)
    return bool(ok), worst


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


def host_ms(fn, calls=30):
    """Host time of one call: the enqueue time of ``calls`` back-to-back
    calls, without synchronising between them (the card runs behind)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    ms = (time.perf_counter() - t0) * 1e3 / calls
    torch.cuda.synchronize()
    return ms


def kernel_ms(fn, reps=3):
    """Device ms and launches of each CUDA kernel ``fn`` launches, averaged
    over ``reps`` profiled calls after a warm one: {kernel: [ms, launches]}
    a call."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        us = getattr(e, "device_time_total", None) or getattr(e, "cuda_time_total", 0)
        if us and e.count:
            name = e.key.replace("(anonymous namespace)::", "").removeprefix("void ")
            name = name.split("(")[0][:60]
            ms, k = out.get(name, (0.0, 0))
            out[name] = [ms + us / 1e3 / reps, k + e.count / reps]
    return out


def launches(profile):
    return sum(k for _, k in profile.values())


def bounds(shape, need_dx=None):
    """(least bytes, ms at the card's memory rate, design-traffic ms): K1 when
    ``need_dx`` is None, else K2."""
    b, h, w, cin = shape
    pix = b * h * w
    if need_dx is None:
        least = pix * (cin + 64) * 2 + (128 * 64 + 64 * 64) * 2
        design = pix * K1_DESIGN_BYTES
    else:
        least = pix * (cin + 3 * 64) * 2 + (pix * cin * 2 if need_dx else 0)
        design = pix * K2_DESIGN_BYTES[need_dx]
    return least, least / H100_BYTES * 1e3, design / H100_BYTES * 1e3


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--parent", type=Path, action="append", default=[],
                    help="a checkout of an earlier commit; may be given more than once")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("tap_ab: no CUDA device", file=sys.stderr)
        return 1
    name = card()
    print(name, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    new = build(_nvcc.PKG / "csrc")
    olds = [build(d / "ppst_tpu_torch" / "csrc") for d in args.parent]
    labels = ["this tree"] + [str(d) for d in args.parent]
    failed = False

    if args.quick:
        for i, shape in enumerate(QUICK):
            fargs, cot = inputs(shape, i)
            out, res = tap_cuda._forward(*fargs)
            torch.cuda.synchronize()
            ok, _ = check_forward(fargs, out, shape, "wrapper")
            ok &= torch.equal(out, tap_cuda._forward(*fargs)[0])
            x, w1, _, a1, w2, _, a2 = fargs
            bargs = (x, *res, w1, w2, a1, a2, cot)
            for need_dx in (False, True):
                got = tap_cuda.fused_tap_1x1_bwd(*bargs, need_dx)
                torch.cuda.synchronize()
                bok, _ = check_backward(bargs, got, shape, need_dx, "wrapper")
                again = tap_cuda.fused_tap_1x1_bwd(*bargs, need_dx)
                ok &= bok and all((a is None and b is None) or torch.equal(a, b)
                                  for a, b in zip(got, again))
            print(f"[check] {shape}: within and deterministic: {ok}", flush=True)
            failed |= not ok
        print("tap_ab:", "FAILED" if failed else "ok", flush=True)
        return 1 if failed else 0

    for i, shape in enumerate(FWD_SHAPES):
        fargs, _ = inputs(shape, i)
        runs = [c_forward(lib, fargs) for lib, _ in [new] + olds]
        for (run, out), label in zip(runs, labels):
            run()
            torch.cuda.synchronize()
            ok, mx = check_forward(fargs, out, shape, label)
            failed |= not ok
        wrap = lambda: tap_cuda._forward(*fargs)  # noqa: E731
        ms = times([wrap] + [r for r, _ in runs])
        least, least_ms, design_ms = bounds(shape)
        profiles = [kernel_ms(r) for r, _ in runs]
        rec = dict(kernel="K1", shape=shape, wrapper_ms=ms[0], wrapper_host_ms=host_ms(wrap),
                   c_ms=ms[1], bound_ms=least_ms, bound_by="bytes",
                   share_of_bound=least_ms / ms[1], design_ms=design_ms,
                   share_of_design=design_ms / ms[1], device_kernels=profiles[0],
                   launches=launches(profiles[0]), max_abs_err=mx, card=name)
        rec["parents"] = [dict(dir=label, c_ms=m, device_kernels=p, launches=launches(p))
                          for label, m, p in zip(labels[1:], ms[2:], profiles[1:])]
        print(json.dumps(rec), flush=True)
        del fargs, runs
        torch.cuda.empty_cache()

    for i, shape in enumerate(BWD_SHAPES):
        fargs, cot = inputs(shape, 10 + i)
        x, w1, _, a1, w2, _, a2 = fargs
        _, res = tap_cuda._forward(*fargs)
        bargs = (x, *res, w1, w2, a1, a2, cot)
        for need_dx in (False, True):
            runs = [c_backward(lib, *bargs, need_dx) for _, lib in [new] + olds]
            worst = 0.0
            for (run, got), label in zip(runs, labels):
                run()
                torch.cuda.synchronize()
                ok, err = check_backward(bargs, got, shape, need_dx, label)
                worst = max(worst, err)
                failed |= not ok
            wrap = lambda: tap_cuda.fused_tap_1x1_bwd(*bargs, need_dx)  # noqa: E731
            ms = times([wrap] + [r for r, _ in runs])
            least, least_ms, design_ms = bounds(shape, need_dx)
            profiles = [kernel_ms(r) for r, _ in runs]
            rec = dict(kernel="K2", shape=shape, need_dx=need_dx, wrapper_ms=ms[0],
                       wrapper_host_ms=host_ms(wrap), c_ms=ms[1], bound_ms=least_ms,
                       bound_by="bytes", share_of_bound=least_ms / ms[1], design_ms=design_ms,
                       share_of_design=design_ms / ms[1], device_kernels=profiles[0],
                       launches=launches(profiles[0]), max_abs_err=worst, card=name)
            rec["parents"] = [dict(dir=label, c_ms=m, device_kernels=p, launches=launches(p))
                              for label, m, p in zip(labels[1:], ms[2:], profiles[1:])]
            print(json.dumps(rec), flush=True)
            del runs
        del fargs, cot, res, bargs
        torch.cuda.empty_cache()
    print("tap_ab:", "FAILED" if failed else "ok", flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
