#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``ppst_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which stops the run with a non-zero exit when it fails:

1. prints the card's name and power limit, builds the hand-written kernels
   from ``ppst_tpu_torch/csrc`` and prints the build time;
2. kernel phase: every kernel against its plain PyTorch version on the card
   (bf16, TF32 off) at the main path's shapes and an odd shape, with its time,
   the plain version's time and the least time the card could take;
3. path phase: 512px ``stylize`` at full width in bf16 with the fused tap and
   the guided filter, batch 1 then batch 8 pairs, with seeded weights; checks
   the output and that the main path launched every kernel; a small float32
   input is held against the CPU run of the same code;
4. runs ``python -m ppst_tpu_torch.test --device cuda`` on two generated
   512px PNGs and checks the PNG it writes.

Then it prints the ``kernels`` line and, last, the ``ok`` line. Without a
CUDA device it exits non-zero before printing any result.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
# (substring of the card's name, memory bytes/s, dense bf16 operations/s):
# NVIDIA's data sheets (dense rates, without sparsity)
CARDS = [("H100 80GB HBM3", 3.35e12, 989e12),  # H100 SXM
         ("H100 NVL", 3.9e12, 835e12), ("H100 PCIe", 2.0e12, 756e12),
         ("H200", 4.8e12, 989e12)]
# K1's tolerance, as in tests/test_pallas_kernels.py::test_fused_tap_matches_composite
TAP_MAX_ABS, TAP_MEAN_ABS = 0.06, 5e-3


def card_peaks(name):
    for key, bw, flops in CARDS:
        if key in name:
            return bw, flops
    raise RuntimeError(f"no memory/compute peaks recorded for {name!r}; add them to CARDS")


def cuda_ms(fn, reps=25, other=None):
    """Median milliseconds of ``fn`` over ``reps`` warm launches, each timed
    with CUDA events. With ``other``, the two alternate and both medians are
    returned (plain, kernel, kernel, plain, ... within one call)."""
    fns = [fn] if other is None else [fn, other]
    for f in fns:
        for _ in range(3):
            f()
    times = [[] for _ in fns]
    for r in range(reps):
        order = list(range(len(fns))) if r % 2 == 0 else list(reversed(range(len(fns))))
        for i in order:
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            fns[i]()
            end.record()
            torch.cuda.synchronize()
            times[i].append(start.elapsed_time(end))
    meds = [statistics.median(t) for t in times]
    return meds[0] if other is None else meds


def kernel_phase(tap_cuda, bw, flops, card):
    """K1 against its plain version; returns the kernel's record."""
    g = torch.Generator(device="cuda").manual_seed(0)
    max_err = 0.0
    record = None
    for shape in [(2, 512, 512, 128), (16, 512, 512, 128), (3, 40, 24, 128)]:
        x = torch.randn(shape, generator=g, device="cuda").bfloat16()
        w1 = torch.randn((64, 128), generator=g, device="cuda") * 0.1
        b1 = torch.randn((64,), generator=g, device="cuda") * 0.1
        w2 = torch.randn((64, 64), generator=g, device="cuda") * 0.1
        b2 = torch.randn((64,), generator=g, device="cuda") * 0.1
        a1 = torch.full((1,), 0.25, device="cuda")
        a2 = torch.full((1,), -0.1, device="cuda")
        args = (x, w1, b1, a1, w2, b2, a2)
        got = tap_cuda.fused_tap_1x1(*args)
        torch.cuda.synchronize()
        want = tap_cuda.fused_tap_1x1_reference(*args)
        err = (got.float() - want.float()).abs()
        mx, mean = err.max().item(), err.mean().item()
        ok = (got.shape == want.shape and torch.isfinite(got.float()).all().item()
              and mx <= TAP_MAX_ABS and mean <= TAP_MEAN_ABS)
        print(f"[kernel] fused_tap_1x1 {shape}: max_abs_err {mx} mean_abs_err {mean} "
              f"(tolerance {TAP_MAX_ABS} / {TAP_MEAN_ABS})", flush=True)
        if not ok:
            raise AssertionError(f"fused_tap_1x1 disagrees with its plain version at {shape}")
        if not torch.equal(got, tap_cuda.fused_tap_1x1(*args)):
            raise AssertionError("fused_tap_1x1 is not deterministic")
        max_err = max(max_err, mx)
        if shape[1] < 512:
            continue
        b, h, w, cin = shape
        pixels = b * h * w
        # least traffic: x read once, out written once, weights and biases read once
        min_bytes = pixels * (cin + 64) * 2 + (128 * 64 + 64 * 64) * 2 + 4 * 130
        # traffic of the four-pass design: x twice, t and u written and read, out
        design_bytes = pixels * (2 * cin * 2 + 4 * 64 * 2 + 64 * 2)
        ops = 2 * pixels * (128 * 64 + 64 * 64)
        bound_ms = max(min_bytes / bw, ops / flops) * 1e3
        bound_by = "bytes" if min_bytes / bw >= ops / flops else "operations"
        ms, plain_ms = cuda_ms(lambda: tap_cuda.fused_tap_1x1(*args),
                               other=lambda: tap_cuda.fused_tap_1x1_reference(*args))
        print(f"[kernel] fused_tap_1x1 {shape}: {ms:.4f} ms, plain {plain_ms:.4f} ms, "
              f"bound {bound_ms:.4f} ms ({min_bytes / 1e6:.1f} MB at {bw / 1e12} TB/s, "
              f"{bound_by}), four-pass design traffic {design_bytes / 1e6:.1f} MB -> "
              f"{design_bytes / bw * 1e3:.4f} ms, {ops / 1e9:.2f} GFLOP; {card}", flush=True)
        if record is None:  # the batch-1 pair's extraction shape
            record = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by)
    record["max_abs_err"] = max_err
    return record


def small_reference_check(PPSTConfig, PPSTModel):
    """A narrow float32 model at crop 64 on the card against the same code on
    the CPU (which the tests hold against ppst_tpu)."""
    narrow = dict(crop_size=64, netE_scale_capacity=0.25, netE2_scale_capacity=0.25,
                  global_code_ch=64, spatial_code_ch=16, netG_resnet_ch=32,
                  netG_scale_capacity=0.125)
    rng = np.random.default_rng(0)
    c = torch.from_numpy(rng.uniform(-1, 1, (2, 64, 64, 3)).astype(np.float32))
    s = torch.from_numpy(rng.uniform(-1, 1, (2, 64, 64, 3)).astype(np.float32))
    outs = []
    for dev in ("cpu", "cuda"):
        model = PPSTModel(PPSTConfig(**narrow), device=dev, seed=0)
        out = model.stylize(c.to(dev), s.to(dev), torch.Generator(device=dev).manual_seed(0),
                            smooth_target=True)
        outs.append(out.float().cpu())
    err = (outs[0] - outs[1]).abs().max().item()
    print(f"[path] crop-64 float32 stylize, card vs CPU: max_abs_err {err} (tolerance 1e-3)",
          flush=True)
    if not err <= 1e-3:
        raise AssertionError("stylize on the card disagrees with the CPU run")


def path_phase(tap_cuda, PPSTConfig, PPSTModel, card):
    """512px full-width bf16 stylize with the fused tap; returns K1's launches."""
    cfg = PPSTConfig(crop_size=512, fused_tap=True, dtype="bfloat16")
    model = PPSTModel(cfg, device="cuda", seed=0)
    gen = torch.Generator(device="cuda").manual_seed(0)
    content8 = (torch.rand((8, 512, 512, 3), generator=gen, device="cuda") * 2 - 1).bfloat16()
    style8 = content8.roll(1, dims=0)
    calls = 0

    def run(content, style):
        nonlocal calls
        calls += 1
        out = model.stylize(content, style, gen, smooth_target=True)
        torch.cuda.synchronize()
        return out

    tap_cuda.fused_tap_1x1.launches = 0
    out1 = run(content8[:1], style8[:1])  # warm-up
    lat = []
    for _ in range(10):
        t0 = time.perf_counter()
        out1 = run(content8[:1], style8[:1])
        lat.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.reset_peak_memory_stats()
    out8 = run(content8, style8)  # warm-up
    reps = 5
    t0 = time.perf_counter()
    for _ in range(reps):
        out8 = run(content8, style8)
    pairs_s = 8 * reps / (time.perf_counter() - t0)
    launches = tap_cuda.fused_tap_1x1.launches

    for out, b in ((out1, 1), (out8, 8)):
        if out.shape != (b, 512, 512, 3) or not torch.isfinite(out).all().item():
            raise AssertionError(f"stylize batch {b}: bad output {tuple(out.shape)}")
    if out8.std().item() < 1e-3:
        raise AssertionError("stylize output is constant")
    if launches != calls:
        raise AssertionError(f"fused_tap_1x1 launched {launches} times in {calls} stylize "
                             "calls (one per extraction pass expected)")
    print(json.dumps({
        "path": "stylize", "crop": 512, "dtype": "bfloat16", "fused_tap": True,
        "smooth_target": True, "batch1_latency_ms_p50": statistics.median(lat),
        "batch1_latency_ms": lat, "batch8_pairs_per_s": pairs_s,
        "batch8_peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
        "stylize_calls": calls, "fused_tap_launches": launches, "card": card}), flush=True)
    return launches


def cli_phase():
    from PIL import Image

    with tempfile.TemporaryDirectory() as tmp:
        rng = np.random.default_rng(0)
        paths = []
        for name in ("content", "style"):
            p = os.path.join(tmp, f"{name}.png")
            Image.fromarray((rng.random((512, 512, 3)) * 255).astype(np.uint8)).save(p)
            paths.append(p)
        t0 = time.perf_counter()
        subprocess.run(
            [sys.executable, "-m", "ppst_tpu_torch.test", "--device", "cuda",
             "--evaluation_metrics", "simple_swapping", "--dtype", "bfloat16",
             "--fused_tap", "true", "--preprocess", "resize", "--load_size", "512",
             "--crop_size", "512", "--input_structure_image", paths[0],
             "--input_texture_image", paths[1], "--result_dir", os.path.join(tmp, "results")],
            cwd=ROOT, check=True, timeout=600)
        out = os.path.join(tmp, "results", "ppst", "results", "simpleswapping",
                           "content_style_1.00.png")
        shape = np.asarray(Image.open(out)).shape
        if shape != (512, 512, 3):
            raise AssertionError(f"CLI wrote an image of shape {shape}")
        print(f"[cli] python -m ppst_tpu_torch.test wrote {shape} in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from ppst_tpu_torch.models.config import PPSTConfig
    from ppst_tpu_torch.models.ppst import PPSTModel
    from ppst_tpu_torch.ops import tap_cuda

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    bw, flops = card_peaks(torch.cuda.get_device_name(0))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.perf_counter()
    tap_cuda._lib()
    print(f"[build] csrc/tap.cu built and loaded in {time.perf_counter() - t0:.1f} s",
          flush=True)

    k1 = kernel_phase(tap_cuda, bw, flops, card)
    launches = path_phase(tap_cuda, PPSTConfig, PPSTModel, card)
    small_reference_check(PPSTConfig, PPSTModel)
    cli_phase()

    print(json.dumps({"kernels": [{
        "name": "fused_tap_1x1", "route": "cuda", "source": "ppst_tpu_torch/csrc/tap.cu",
        "replaces": "ppst_tpu/ops/tap_pallas.py:135", "launches": launches,
        "max_abs_err": k1["max_abs_err"], "ms": k1["ms"], "plain_ms": k1["plain_ms"],
        "bound_ms": k1["bound_ms"], "bound_by": k1["bound_by"], "library_ms": None,
    }]}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
