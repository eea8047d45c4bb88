"""K6 (the fused StyledConv, forward and backward) on one card: checked
against its plain versions, timed against an earlier version of its sources
and against the unfused StyledConv.

    python -m ppst_tpu_torch.tools.k6_ab --quick
    python -m ppst_tpu_torch.tools.k6_ab [--parent DIR]

``--quick`` builds ``csrc/styled_conv.cu`` and ``csrc/styled_conv_bwd.cu``,
prints ptxas's report of both, runs the forward and the backward (with dx)
once at the record shape (8, 512, 512, 128 -> 128) and once at the odd (1,
20, 36, 48 -> 80), synchronises, compares each with the plain version and
stops.

Otherwise it checks and times both at every shape of ``chip_smoke.py``'s
``K6_SHAPES`` (the 512px generator's, heads to up-block conv2s) and the
1024px up-block conv2 (2, 1024, 1024, 128 -> 128): the forward beside the
unfused StyledConv, the backward whole and in its parts (passes 1-2, dW, dx),
and each kernel's device time in one profiled forward and backward. With
``--parent DIR``, a checkout of an earlier commit, that commit's
``styled_conv.cu`` and ``styled_conv_bwd.cu`` are built as well and timed in
turns with this tree's, both called the same way, straight through their C
interfaces (``kernel_*`` keys: the forward, the backward without dx as one
call, then dx), so that neither carries the Python wrapper's host time. One
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

import torch

from ppst_tpu_torch.ops import _nvcc
from ppst_tpu_torch.ops import styled_conv_cuda as sc
from ppst_tpu_torch.tools import card

# the dense bf16 rate and memory rate of an H100 SXM (NVIDIA's data sheet)
H100_BF16_FLOPS, H100_BYTES = 989e12, 3.35e12
# chip_smoke.py's tolerances: the output within K6_MAX max(1, max|ref|) and a
# mean of K6_MEAN; each gradient within K6_BWD_REL max(max|ref|, 0.01 largest)
K6_MAX, K6_MEAN, K6_BWD_REL = 0.02, 1e-4, 0.01
RECORD, ODD = (8, 512, 512, 128, 128), (1, 20, 36, 48, 80)
SHAPES = [(8, 64, 64, 256, 384), (8, 64, 64, 512, 512), (8, 128, 128, 512, 512),
          (8, 256, 256, 256, 256), (8, 512, 512, 128, 128), (16, 512, 512, 128, 128),
          (2, 1024, 1024, 128, 128)]
NAMES = ("dx", "dw", "dgain", "db", "dscale", "dshift")


def build(csrc: Path):
    """Build ``csrc``'s two K6 sources, print ptxas's report, return the
    libraries (forward, backward)."""
    libs = []
    for name in ("styled_conv", "styled_conv_bwd"):
        t0 = time.perf_counter()
        path = _nvcc.build(csrc / f"{name}.cu")
        print(f"[build] {csrc / name}.cu in {time.perf_counter() - t0:.1f} s", flush=True)
        for line in _nvcc.ptxas_summary(path):
            print(f"[ptxas] {name}.cu {line}", flush=True)
        lib = ctypes.CDLL(str(path))
        lib.ppst_cuda_error_string.argtypes = [ctypes.c_int]
        lib.ppst_cuda_error_string.restype = ctypes.c_char_p
        libs.append(lib)
    fwd, bwd = libs
    bwd.has_parts = "int parts" in (csrc / "styled_conv_bwd.cu").read_text()
    fwd.ppst_styled_conv_fwd.argtypes = [ctypes.c_void_p] * 12 + [ctypes.c_int] * 5 + [
        ctypes.c_void_p]
    fwd.ppst_conv3x3.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fwd.ppst_styled_conv_scratch_floats.argtypes = [ctypes.c_int] * 4
    fwd.ppst_styled_conv_scratch_floats.restype = ctypes.c_long
    bwd.ppst_styled_conv_bwd_scratch_floats.argtypes = [ctypes.c_int] * 5
    bwd.ppst_styled_conv_bwd_scratch_floats.restype = ctypes.c_long
    return fwd, bwd


def c_calls(fwd, bwd, args, res, cot):
    """A build's forward, backward without dx, and dx, called straight
    through its C interface as the wrappers call it: the backward in one call
    (with ``parts`` = 3 where its C interface has that argument, as this
    tree's has), dx through ppst_conv3x3."""
    parts = [3] if bwd.has_parts else []
    bwd.ppst_styled_conv_bwd.argtypes = [ctypes.c_void_p] * 13 + [ctypes.c_int] * (
        5 + len(parts)) + [ctypes.c_void_p]
    x, w, noise, gain, bt, s1, shift = args
    a, mean, rstd = res
    bsz, h, wd, cin = x.shape
    cout = w.shape[0]
    nz = noise.bfloat16().contiguous()
    f32 = dict(dtype=torch.float32, device="cuda")
    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731
    fargs = [x, w.bfloat16().permute(2, 3, 0, 1).contiguous(), nz, gain.float(), bt.float(), s1,
             shift, torch.empty_like(a), torch.empty_like(a), torch.empty_like(mean),
             torch.empty_like(rstd),
             torch.empty((fwd.ppst_styled_conv_scratch_floats(bsz, h, wd, cout),), **f32)]
    bouts = [torch.empty_like(a), torch.empty((bsz, 4, cout), **f32), torch.empty((cout,), **f32),
             torch.empty((1,), **f32), torch.empty((cout, cin, 3, 3), **f32),
             torch.empty((bwd.ppst_styled_conv_bwd_scratch_floats(bsz, h, wd, cin, cout),), **f32)]
    bins = [x, a, cot, nz, mean, rstd, s1]
    wt = w.bfloat16().flip(2, 3).permute(2, 3, 1, 0).contiguous()
    dx = torch.empty_like(x)

    def forward():
        _nvcc.check(fwd, fwd.ppst_styled_conv_fwd(*[v.data_ptr() for v in fargs], bsz, h, wd,
                                                  cin, cout, stream()), "parent forward")

    def backward():
        _nvcc.check(bwd, bwd.ppst_styled_conv_bwd(*[v.data_ptr() for v in bins + bouts], bsz, h,
                                                  wd, cin, cout, *parts, stream()),
                    "parent backward")

    def conv_dx():
        _nvcc.check(fwd, fwd.ppst_conv3x3(bouts[0].data_ptr(), wt.data_ptr(), dx.data_ptr(), bsz,
                                          h, wd, cout, cin, stream()), "parent dx")

    return forward, backward, conv_dx


def inputs(shape, seed):
    """chip_smoke.py's styled_conv_inputs: bf16 activations and noise,
    He-scaled float32 weights, nonzero gain and biases."""
    b, h, w, cin, cout = shape
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn((b, h, w, cin), generator=g, device="cuda").bfloat16()
    wt = torch.randn((cout, cin, 3, 3), generator=g, device="cuda") * (2.0 / (9 * cin)) ** 0.5
    noise = torch.randn((b, h, w, 1), generator=g, device="cuda").bfloat16()
    gain = torch.full((1,), 0.3, device="cuda")
    bt = torch.randn((cout,), generator=g, device="cuda") * 0.1
    s1 = (torch.randn((b, cout), generator=g, device="cuda") * 0.3 + 1.0).bfloat16().float()
    shift = torch.randn((b, cout), generator=g, device="cuda") * 0.3
    cot = torch.randn((b, h, w, cout), generator=g, device="cuda").bfloat16()
    return (x, wt, noise, gain, bt, s1, shift), cot


def bound_ms(shape, backward=False):
    """chip_smoke.py's styled_conv_bound on an H100 SXM: (ms, bound_by)."""
    b, h, w, cin, cout = shape
    pix = b * h * w
    ops = 2 * pix * 9 * cin * cout * (2 if backward else 1)
    if backward:
        nbytes = pix * (2 * cin + 2 * cout + 1) * 2 + 9 * cin * cout * 4
    else:
        nbytes = pix * (cin + cout + 1) * 2 + 9 * cin * cout * 2 + 4 * cout * (1 + 2 * b)
    t_bytes, t_ops = nbytes / H100_BYTES, ops / H100_BF16_FLOPS
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def check(args, cot, shape):
    """The forward and the backward with dx against their plain versions,
    and each run twice for the same bits. Returns (ok, residuals, max error)."""
    got, res = sc._forward(*args)
    torch.cuda.synchronize()
    want = sc.styled_conv3x3_reference(*args)
    err = (got.float() - want.float()).abs()
    mx, mean = err.max().item(), err.mean().item()
    tol = K6_MAX * max(1.0, want.float().abs().max().item())
    ok = bool(torch.isfinite(got.float()).all().item() and mx <= tol and mean <= K6_MEAN
              and torch.equal(got, sc._forward(*args)[0]))
    print(f"[check] forward {shape}: max_abs_err {mx} mean_abs_err {mean} (tolerance {tol} / "
          f"{K6_MEAN}); deterministic and within: {ok}", flush=True)
    del got, want, err
    x, w, noise, _, _, s1, _ = args
    bargs = (x, w, noise, *res, s1, cot)
    got = sc.styled_conv3x3_bwd(*bargs)
    torch.cuda.synchronize()
    want = sc.styled_conv3x3_bwd_reference(*bargs)
    overall = max(v.abs().max().item() for v in want)
    rel, worst = {}, 0.0
    for name, u, v in zip(NAMES, got, want):
        gap = (u.float() - v.float()).abs().max().item()
        worst = max(worst, gap)
        rel[name] = gap / max(v.abs().max().item(), 0.01 * overall)
    again = sc.styled_conv3x3_bwd(*bargs)
    bok = bool(all(r <= K6_BWD_REL for r in rel.values()) and got[1].dtype == torch.float32
               and all(torch.isfinite(u.float()).all().item() for u in got)
               and all(torch.equal(u, v) for u, v in zip(got, again)))
    print(f"[check] backward {shape}: max |error| / max(max |grad|, 0.01 largest) "
          + ", ".join(f"{k} {v:.3g}" for k, v in rel.items())
          + f" (tolerance {K6_BWD_REL}); dW float32, deterministic and within: {bok}", flush=True)
    return ok and bok, res, max(mx, worst)


def times(fns, reps=10):
    """Median ms of each of ``fns``, in turns (forward then reversed order)."""
    for f in fns:
        for _ in range(2):
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


def kernel_ms(fn, reps=3):
    """Device ms of each CUDA kernel ``fn`` launches, averaged over ``reps``
    profiled calls after a warm one: {kernel name: ms a call}."""
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
            out[name] = out.get(name, 0.0) + us / 1e3 / reps
    return out


def composite(shape, seed):
    """The port's unfused StyledConv (cuDNN conv and elementwise kernels) at
    ``shape``, bf16, with pinned bf16 noise, as chip_smoke.py times it."""
    from ppst_tpu_torch.nn.layers import StyledConv, init_weights

    b, h, w, cin, cout = shape
    gen = torch.Generator(device="cuda").manual_seed(seed)
    m = StyledConv(cin, cout, 3, style_dim=2048)
    init_weights(m, torch.Generator().manual_seed(0))
    m.cuda()
    latent = torch.randn((b, 2048), generator=gen, device="cuda").bfloat16()
    noise = torch.randn((b, h, w, 1), generator=gen, device="cuda").bfloat16()
    x = torch.randn((b, h, w, cin), generator=gen, device="cuda").bfloat16()

    def run():
        with torch.no_grad():
            return m(x, latent, noise)

    return run


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--parent", type=Path, action="append", default=[],
                    help="a checkout of an earlier commit; may be given more than once")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("k6_ab: no CUDA device", file=sys.stderr)
        return 1
    name = card()
    print(name, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    new = build(_nvcc.PKG / "csrc")
    olds = [build(d / "ppst_tpu_torch" / "csrc") for d in args.parent]
    failed = False
    for i, shape in enumerate([RECORD, ODD] if args.quick else SHAPES):
        fargs, cot = inputs(shape, i)
        ok, res, mx = check(fargs, cot, shape)
        failed |= not ok
        if args.quick:
            continue
        x, w, noise, _, _, s1, _ = fargs
        run, _ = sc._bwd_parts(x, w, noise, *res, s1, cot)
        fns = [lambda: sc._forward(*fargs), composite(shape, i)]
        bfns = [lambda: sc.styled_conv3x3_bwd(x, w, noise, *res, s1, cot),
                lambda: run("dpre"), lambda: run("dw"), lambda: run("dx")]
        for lib in [new] + olds:
            p_fwd, p_bwd, p_dx = c_calls(*lib, fargs, res, cot)
            fns.append(p_fwd)
            bfns += [p_bwd, p_dx]
        ms, bms = times(fns), times(bfns)
        fwd_kernels = kernel_ms(fns[0])
        bwd_kernels = kernel_ms(bfns[0])
        fb, fby = bound_ms(shape)
        bb, bby = bound_ms(shape, backward=True)
        rec = dict(shape=shape, fwd_ms=ms[0], composite_ms=ms[1], fwd_bound_ms=fb,
                   fwd_bound_by=fby, fwd_share_of_bound=fb / ms[0], bwd_ms=bms[0],
                   bwd_passes_ms=bms[1], bwd_dw_ms=bms[2], bwd_dx_ms=bms[3], bwd_bound_ms=bb,
                   bwd_bound_by=bby, bwd_share_of_bound=bb / bms[0], max_abs_err=mx,
                   fwd_kernel_ms=fwd_kernels, bwd_kernel_ms=bwd_kernels, card=name)
        # the forward, the backward without dx and dx called through the C
        # interfaces: this tree's, then each earlier version's in --parent order
        calls = [dict(fwd_ms=ms[2 + k], bwd_ms=bms[4 + 2 * k] + bms[5 + 2 * k],
                      bwd_no_dx_ms=bms[4 + 2 * k], dx_ms=bms[5 + 2 * k])
                 for k in range(1 + len(olds))]
        rec.update({f"kernel_{key}": v for key, v in calls[0].items()})
        rec["parents"] = [dict(dir=str(d), **c) for d, c in zip(args.parent, calls[1:])]
        print(json.dumps(rec), flush=True)
        del fargs, cot, res, run, fns, bfns
        torch.cuda.empty_cache()
    print("k6_ab:", "FAILED" if failed else "ok", flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
