"""K3 (the blockwise correspondence warp) on one card: checked against its
plain version, timed against an earlier version of its source and against
``scaled_dot_product_attention``.

    python -m ppst_tpu_torch.tools.k3_ab --quick
    python -m ppst_tpu_torch.tools.k3_ab [--parent DIR]

``--quick`` builds ``csrc/corr_warp.cu``, prints ptxas's report of it, runs
one launch at (1, 16384, 16384, 512, 256) and one at the odd (1, 200, 136,
512, 48), synchronises, compares each with the plain version and stops.

Otherwise it checks and times the kernel at the 1024px path's four E2 widths
(1, 16384, 16384, 512, Cv = 32, 64, 128, 256) and the 512px grid's (8, 4096,
4096, 512, 256), with SDPA (EFFICIENT_ATTENTION, scale 1/T) and the plain
version beside it. With ``--parent DIR``, a checkout of an earlier commit,
that commit's ``ppst_tpu_torch/csrc/corr_warp.cu`` is built as well and timed
in turns with this one (earlier, this, this, earlier). One JSON line per shape,
with the card's name and power limit.
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
import torch.nn.functional as F

from ppst_tpu_torch.ops import _nvcc
from ppst_tpu_torch.ops import corr_warp_cuda as cw
from ppst_tpu_torch.tools import card

# the dense bf16 rate of an H100 SXM (NVIDIA's data sheet)
H100_BF16_FLOPS = 989e12
# chip_smoke.py's tolerances, in units of max|v|
BF16_MAX, BF16_MEAN = 1e-2, 2e-4
QUICK = [(1, 16384, 16384, 512, 256), (1, 200, 136, 512, 48)]
TIMED = [(1, 16384, 16384, 512, cv) for cv in (32, 64, 128, 256)] + [(8, 4096, 4096, 512, 256)]


def build(src: Path):
    """Build ``src`` and bind its ``ppst_corr_warp``; prints ptxas's report."""
    t0 = time.perf_counter()
    lib_path = _nvcc.build(src)
    print(f"[build] {src} in {time.perf_counter() - t0:.1f} s", flush=True)
    for line in _nvcc.ptxas_summary(lib_path):
        print(f"[ptxas] {line}", flush=True)
    lib = ctypes.CDLL(str(lib_path))
    lib.ppst_corr_warp.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
                                   + [ctypes.c_float, ctypes.c_void_p])
    lib.ppst_corr_warp.restype = ctypes.c_int
    lib.ppst_cuda_error_string.argtypes = [ctypes.c_int]
    lib.ppst_cuda_error_string.restype = ctypes.c_char_p

    def run(q, k, v, temperature=0.01):
        b, lq, c = q.shape
        lk, cv = v.shape[1], v.shape[2]
        out = torch.empty((b, lq, cv), dtype=v.dtype, device=v.device)
        err = lib.ppst_corr_warp(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), 1, b,
                                 lq, lk, c, cv, 1.0 / temperature,
                                 torch.cuda.current_stream().cuda_stream)
        _nvcc.check(lib, err, str(src))
        return out

    return run


def inputs(shape, seed):
    b, lq, lk, c, cv = shape
    g = torch.Generator(device="cuda").manual_seed(seed)
    q = cw.normalize_desc(torch.randn((b, lq, c), generator=g, device="cuda")).bfloat16()
    k = cw.normalize_desc(torch.randn((b, lk, c), generator=g, device="cuda")).bfloat16()
    v = torch.randn((b, lk, cv), generator=g, device="cuda").bfloat16()
    return q, k, v


def check(fn, q, k, v, shape):
    got = fn(q, k, v)
    torch.cuda.synchronize()
    want = cw.corr_warp_blockwise_reference(q, k, v)
    vmax = v.float().abs().max().item()
    err = (got.float() - want.float()).abs()
    mx, mean = err.max().item(), err.mean().item()
    ok = bool(torch.isfinite(got.float()).all().item() and mx <= BF16_MAX * vmax
              and mean <= BF16_MEAN * vmax and torch.equal(got, fn(q, k, v)))
    print(f"[check] {shape}: max_abs_err {mx} mean_abs_err {mean} (tolerance "
          f"{BF16_MAX * vmax} / {BF16_MEAN * vmax}), deterministic and within: {ok}", flush=True)
    return ok, mx


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
        print("k3_ab: no CUDA device", file=sys.stderr)
        return 1
    name = card()
    print(name, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    new = build(_nvcc.PKG / "csrc" / "corr_warp.cu")
    old = build(args.parent / "ppst_tpu_torch" / "csrc" / "corr_warp.cu") if args.parent else None
    failed = False
    for i, shape in enumerate(QUICK if args.quick else TIMED):
        q, k, v = inputs(shape, i)
        ok, mx = check(new, q, k, v, shape)
        failed |= not ok
        if args.quick:
            continue
        b, lq, lk, c, cv = shape
        ops = 2 * b * lq * lk * (c + cv)
        bound_ms = ops / H100_BF16_FLOPS * 1e3
        q4, k4, v4 = q[:, None], k[:, None], v[:, None]
        fns = [lambda: new(q, k, v),
               lambda: F.scaled_dot_product_attention(q4, k4, v4, scale=100.0),
               lambda: cw.corr_warp_blockwise_reference(q, k, v)]
        if old is not None:
            fns.append(lambda: old(q, k, v))
        ms = times(fns)
        rec = dict(shape=shape, ms=ms[0], sdpa_ms=ms[1], plain_ms=ms[2],
                   parent_ms=ms[3] if old is not None else None, bound_ms=bound_ms,
                   share_of_bound=bound_ms / ms[0], max_abs_err=mx, card=name)
        print(json.dumps(rec), flush=True)
    print("k3_ab:", "FAILED" if failed else "ok", flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
