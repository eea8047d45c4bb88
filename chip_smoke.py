#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``ppst_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which stops the run with a non-zero exit when it fails:

1. build: prints the card's name and power limit, builds the hand-written
   kernels from ``ppst_tpu_torch/csrc`` (one ``nvcc`` per source, all at
   once) and prints each build time;
2. kernel: every kernel against its plain PyTorch version on the card (TF32
   off) at the main paths' shapes and an odd shape, with its determinism, its
   time, the plain version's time, the time of the one PyTorch call that
   computes the same function where there is one, and the least time the
   card could take;
3. path: 512px ``stylize`` at full width in bf16 with the fused tap and the
   guided filter, batch 1 then batch 8 pairs; then 1024px ``stylize_fused``
   (the blockwise correspondence) at batch 1; each checks its output and the
   kernels it launched;
4. grid: a 512px 4x8 grid, dense and blockwise on the same banks, and a
   1024px 2x4 blockwise grid, with pairs/s amortized over extraction;
5. reference: a narrow float32 model at crop 64 on the card against the CPU
   run of the same code (``stylize``, ``stylize_fused``, blockwise
   ``grid_pairs``), and the narrow generator's bf16-vs-float32 distance on
   the card and on the CPU;
6. cli: ``python -m ppst_tpu_torch.test --device cuda`` on two generated
   512px PNGs (simple_swapping), then the grid evaluator on a generated
   folder of 2 + 2 512px PNGs.

Each phase prints its seconds. Then the script prints the ``kernels`` line
and, last, the ``ok`` line. Without a CUDA device it exits non-zero before
printing any result.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch
import torch.nn.functional as F

ROOT = os.path.dirname(os.path.abspath(__file__))
# (substring of the card's name, memory bytes/s, dense bf16 operations/s):
# NVIDIA's data sheets (dense rates, without sparsity)
CARDS = [("H100 80GB HBM3", 3.35e12, 989e12),  # H100 SXM
         ("H100 NVL", 3.9e12, 835e12), ("H100 PCIe", 2.0e12, 756e12),
         ("H200", 4.8e12, 989e12)]
# K1's tolerance, as in tests/test_pallas_kernels.py::test_fused_tap_matches_composite
TAP_MAX_ABS, TAP_MEAN_ABS = 0.06, 5e-3
# K3's tolerance against its plain version, in units of max|v|. bf16: the
# kernel rounds P to bf16 for the P V product (as the TPU's one-pass dot did)
# and the output once, each 2^-9 relative; float32: sums in another order.
# Measured on an H100: at most one bf16 step of the output (0.003 max|v|), a
# mean of 5.4e-5 max|v|; float32 5e-7 max|v|.
CORR_BF16_MAX, CORR_BF16_MEAN, CORR_F32_MAX = 1e-2, 2e-4, 1e-5
# (B, Lq, Lk, C, Cv, dtype): 512px and 1024px at the narrowest and widest E2
# scale, an odd rectangular shape, and a float32 shape with ragged tails
CORR_SHAPES = [(1, 4096, 4096, 512, 32, torch.bfloat16), (1, 4096, 4096, 512, 256, torch.bfloat16),
               (1, 16384, 16384, 512, 32, torch.bfloat16),
               (1, 16384, 16384, 512, 256, torch.bfloat16),
               (1, 200, 136, 512, 48, torch.bfloat16), (2, 300, 200, 288, 40, torch.float32)]
# blockwise against dense grid outputs on the [-1, 1] scale, both in bf16: the
# two round the correspondence at different places. Measured on an H100:
# 0.0137 max, 0.00156 mean; the bound leaves 3.5x.
GRID_MAX_ABS, GRID_MEAN_ABS = 0.05, 0.005
NARROW = dict(crop_size=64, netE_scale_capacity=0.25, netE2_scale_capacity=0.25,
              global_code_ch=64, spatial_code_ch=16, netG_resnet_ch=32,
              netG_scale_capacity=0.125)


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


def sdpa_backend(q, k, v, scale):
    """The backend PyTorch's scaled_dot_product_attention picks for these
    inputs."""
    from torch.nn.attention import SDPBackend

    return SDPBackend(torch._fused_sdp_choice(q, k, v, scale=scale)).name


def corr_warp_phase(cw, bw, flops, card):
    """K3 against its plain version; returns its record at the 1024px path's
    narrowest E2 scale."""
    g = torch.Generator(device="cuda").manual_seed(1)
    max_err, record = 0.0, None
    for b, lq, lk, c, cv, dt in CORR_SHAPES:
        # descriptors as the path makes them: unit rows; logits reach +-100
        q = cw.normalize_desc(torch.randn((b, lq, c), generator=g, device="cuda")).to(dt)
        k = cw.normalize_desc(torch.randn((b, lk, c), generator=g, device="cuda")).to(dt)
        v = torch.randn((b, lk, cv), generator=g, device="cuda").to(dt)
        shape = (b, lq, lk, c, cv, str(dt).split(".")[-1])
        got = cw.corr_warp_blockwise(q, k, v)
        torch.cuda.synchronize()
        want = cw.corr_warp_blockwise_reference(q, k, v)
        vmax = v.float().abs().max().item()
        err = (got.float() - want.float()).abs()
        mx, mean = err.max().item(), err.mean().item()
        bf16 = dt == torch.bfloat16
        tol_max = (CORR_BF16_MAX if bf16 else CORR_F32_MAX) * vmax
        tol_mean = (CORR_BF16_MEAN if bf16 else CORR_F32_MAX) * vmax
        print(f"[kernel] corr_warp_blockwise {shape}: max_abs_err {mx} mean_abs_err {mean} "
              f"(tolerance {tol_max} / {tol_mean}, max|v| {vmax})", flush=True)
        if not (got.shape == want.shape and torch.isfinite(got.float()).all().item()
                and mx <= tol_max and mean <= tol_mean):
            raise AssertionError(f"corr_warp_blockwise disagrees with its plain version at {shape}")
        if not torch.equal(got, cw.corr_warp_blockwise(q, k, v)):
            raise AssertionError(f"corr_warp_blockwise is not deterministic at {shape}")
        max_err = max(max_err, mx)
        if not (bf16 and lq >= 4096):
            continue
        # least traffic: q, k and v read once, out written once; operations of
        # both products at the dense bf16 rate
        min_bytes = (q.numel() + k.numel() + v.numel() + b * lq * cv) * 2
        ops = 2 * b * lq * lk * (c + cv)
        bound_ms = max(min_bytes / bw, ops / flops) * 1e3
        bound_by = "bytes" if min_bytes / bw >= ops / flops else "operations"
        ms, plain_ms = cuda_ms(lambda: cw.corr_warp_blockwise(q, k, v),
                               other=lambda: cw.corr_warp_blockwise_reference(q, k, v))
        q4, k4, v4 = q[:, None], k[:, None], v[:, None]
        backend = sdpa_backend(q4, k4, v4, 100.0)
        library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(q4, k4, v4, scale=100.0))
        print(f"[kernel] corr_warp_blockwise {shape}: {ms:.4f} ms, plain {plain_ms:.4f} ms, "
              f"scaled_dot_product_attention ({backend}) {library_ms:.4f} ms, bound "
              f"{bound_ms:.4f} ms ({bound_by}: {ops / 1e9:.1f} GFLOP at {flops / 1e12} "
              f"TFLOP/s, {min_bytes / 1e6:.1f} MB at {bw / 1e12} TB/s); {card}", flush=True)
        if lq == 16384 and cv == 32:
            record = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                          library_ms=library_ms)
    record["max_abs_err"] = max_err
    return record


def reset_launches(*kernels):
    for k in kernels:
        k.launches = 0


def small_reference_check(PPSTConfig, PPSTModel):
    """A narrow float32 model at crop 64 on the card against the same code on
    the CPU (which the tests hold against ppst_tpu): ``stylize``,
    ``stylize_fused`` and blockwise ``grid_pairs``, which run K3's float32
    kernel inside the path. Then the narrow generator's bf16 distance from
    float32 on the card and on the CPU (ROADMAP fault F1)."""
    from ppst_tpu_torch.models.generator import make_fixed_noise
    from ppst_tpu_torch.models.ppst import take_rows

    rng = np.random.default_rng(0)
    c = torch.from_numpy(rng.uniform(-1, 1, (2, 64, 64, 3)).astype(np.float32))
    s = torch.from_numpy(rng.uniform(-1, 1, (2, 64, 64, 3)).astype(np.float32))
    outs = {}
    for dev in ("cpu", "cuda"):
        model = PPSTModel(PPSTConfig(**NARROW), device=dev, seed=0)
        gen = lambda: torch.Generator(device=dev).manual_seed(0)  # noqa: E731
        cd, sd = c.to(dev), s.to(dev)
        noises = make_fixed_noise(model.cfg, torch.Generator().manual_seed(5), 4, 64)
        bank = model.grid_extract(torch.cat([cd, sd]), noises=[n.to(dev) for n in noises])
        c_bank = {k: take_rows(v, slice(None, 2)) for k, v in bank.items()}
        s_bank = {k: take_rows(v, slice(2, None)) for k, v in bank.items()}
        outs[dev] = {
            "stylize": model.stylize(cd, sd, gen(), smooth_target=True),
            "stylize_fused": model.stylize_fused(cd, sd, gen(), smooth_target=True),
            "grid_pairs_blockwise": model.grid_pairs(
                c_bank, s_bank, [0, 0, 1, 1], [0, 1, 0, 1], smooth_target=cd,
                noises=[n.to(dev) for n in noises], blockwise=True),
        }
    for name in outs["cpu"]:
        err = (outs["cpu"][name] - outs["cuda"][name].float().cpu()).abs().max().item()
        print(f"[reference] crop-64 float32 {name}, card vs CPU: max_abs_err {err} "
              "(tolerance 1e-3)", flush=True)
        if not err <= 1e-3:
            raise AssertionError(f"{name} on the card disagrees with the CPU run")

    # the composite 1x1 tap: K1 takes only the full-width tap's channels
    sp = rng.standard_normal((2, 8, 8, 16)).astype(np.float32)
    gl = [rng.standard_normal((2, 64)).astype(np.float32) for _ in range(4)]
    dist = {}
    for dev in ("cpu", "cuda"):
        model = PPSTModel(PPSTConfig(**NARROW), device=dev, seed=0)
        spd, gld = torch.from_numpy(sp).to(dev), [torch.from_numpy(g).to(dev) for g in gl]
        with torch.inference_mode():
            f32 = model.G(spd, gld, extract_features=True)
            bf16 = model.G(spd.bfloat16(), [g.bfloat16() for g in gld], extract_features=True)
        for name, a, b in zip(("rgb", "feat", "feat1"), bf16, f32):
            rms = b.pow(2).mean().sqrt().item()
            err = (a.float() - b).abs()
            dist[f"{dev}_{name}"] = [err.mean().item() / rms, err.max().item() / rms]
    print(json.dumps({"f1_narrow_generator_bf16_vs_f32": dist,
                      "unit": "(mean, max) |bf16 - f32| / RMS(f32)"}), flush=True)


def path_phase(tap_cuda, cw, PPSTConfig, PPSTModel, card):
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

    reset_launches(tap_cuda.fused_tap_1x1, cw.corr_warp_blockwise)
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
    if cw.corr_warp_blockwise.launches:
        raise AssertionError("the dense stylize path launched the blockwise kernel")

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


def fused_path_phase(tap_cuda, cw, PPSTConfig, PPSTModel, card):
    """1024px full-width bf16 stylize_fused (the blockwise correspondence)
    with the fused tap and the guided filter at batch 1; returns K3's
    launches."""
    model = PPSTModel(PPSTConfig(crop_size=1024, fused_tap=True, dtype="bfloat16"),
                      device="cuda", seed=0)
    gen = torch.Generator(device="cuda").manual_seed(0)
    content, style = (torch.rand((2, 1024, 1024, 3), generator=gen, device="cuda") * 2 - 1
                      ).bfloat16().chunk(2)
    reset_launches(tap_cuda.fused_tap_1x1, cw.corr_warp_blockwise)
    out = model.stylize_fused(content, style, gen, smooth_target=True)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    lat = []
    for _ in range(10):
        t0 = time.perf_counter()
        out = model.stylize_fused(content, style, gen, smooth_target=True)
        torch.cuda.synchronize()
        lat.append((time.perf_counter() - t0) * 1e3)
    calls = 11
    k1, k3 = tap_cuda.fused_tap_1x1.launches, cw.corr_warp_blockwise.launches
    peak = torch.cuda.max_memory_allocated() / 2**30

    if out.shape != (1, 1024, 1024, 3) or not torch.isfinite(out).all().item():
        raise AssertionError(f"stylize_fused: bad output {tuple(out.shape)}")
    if out.float().std().item() < 1e-3:
        raise AssertionError("stylize_fused output is constant")
    if k3 != 4 * calls or k1 != calls:
        raise AssertionError(f"stylize_fused launched K3 {k3} and K1 {k1} times in {calls} "
                             "calls (4 and 1 per call expected)")
    # K3's share of the call: its four launches at the path's shapes (one per
    # E2 scale, Cv = 32, 64, 128, 256), timed alone
    q = cw.normalize_desc(torch.randn((1, 16384, 512), generator=gen, device="cuda")).bfloat16()
    k = cw.normalize_desc(torch.randn((1, 16384, 512), generator=gen, device="cuda")).bfloat16()
    k3_ms = sum(cuda_ms(lambda v=v: cw.corr_warp_blockwise(q, k, v), reps=10)
                for v in (torch.randn((1, 16384, cv), generator=gen, device="cuda").bfloat16()
                          for cv in (32, 64, 128, 256)))
    p50 = statistics.median(lat)
    print(json.dumps({
        "path": "stylize_fused", "crop": 1024, "dtype": "bfloat16", "fused_tap": True,
        "smooth_target": True, "batch1_latency_ms_p50": p50, "batch1_latency_ms": lat,
        "peak_mem_gib": peak, "calls": calls, "corr_warp_launches": k3,
        "fused_tap_launches": k1, "corr_warp_ms_per_call": k3_ms,
        "corr_warp_share_of_p50": k3_ms / p50, "card": card}), flush=True)
    return k3


def grid_phase(tap_cuda, cw, PPSTConfig, PPSTModel, card):
    """Grid serving as the evaluator runs it: one extraction over every image
    (chunked by the evaluator's rule), then pair batches with the guided
    filter. pairs/s counts the whole grid, extraction included, as
    tools/bench_grid.py does. Noise is pinned, in bf16."""
    from ppst_tpu_torch.models.generator import make_fixed_noise
    from ppst_tpu_torch.models.ppst import cat_banks, take_rows

    def setup(crop, n_c, n_s, batch):
        model = PPSTModel(PPSTConfig(crop_size=crop, fused_tap=True, dtype="bfloat16"),
                          device="cuda", seed=0)
        gen = torch.Generator(device="cuda").manual_seed(0)
        imgs = (torch.rand((n_c + n_s, crop, crop, 3), generator=gen, device="cuda") * 2 - 1
                ).bfloat16()
        ext = [n.bfloat16() for n in make_fixed_noise(model.cfg, gen, n_c + n_s, crop)]
        dec = [n.bfloat16() for n in make_fixed_noise(model.cfg, gen, batch, crop)]
        chunk = max(4, (16 * 512 * 512) // (crop * crop))

        def extract():
            bank = cat_banks([model.grid_extract(imgs[o : o + chunk],
                                                 noises=[n[o : o + chunk] for n in ext])
                              for o in range(0, n_c + n_s, chunk)])
            return ({k: take_rows(v, slice(None, n_c)) for k, v in bank.items()},
                    {k: take_rows(v, slice(n_c, None)) for k, v in bank.items()})

        def pairs(banks, blockwise):
            idx = torch.arange(n_c * n_s, device="cuda")
            return torch.cat([model.grid_pairs(*banks, idx[o : o + batch] // n_s,
                                               idx[o : o + batch] % n_s,
                                               smooth_target=imgs[:n_c], noises=dec,
                                               blockwise=blockwise)
                              for o in range(0, n_c * n_s, batch)])

        return extract, pairs

    def measure(extract, pairs, blockwise, iters, n_pairs):
        out = pairs(extract(), blockwise)  # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches(tap_cuda.fused_tap_1x1, cw.corr_warp_blockwise)
        t0 = time.perf_counter()
        for _ in range(iters):
            out = pairs(extract(), blockwise)
        torch.cuda.synchronize()
        pairs_s = n_pairs * iters / (time.perf_counter() - t0)
        if not torch.isfinite(out.float()).all().item() or out.float().std().item() < 1e-3:
            raise AssertionError("grid output is not finite or constant")
        return pairs_s, tap_cuda.fused_tap_1x1.launches, cw.corr_warp_blockwise.launches, out

    report = {"card": card}
    # 512px 4 x 8: 12 images in one extraction pass, 4 dispatches of 8 pairs
    extract, pairs = setup(512, 4, 8, 8)
    banks = extract()
    dense, block = pairs(banks, False), pairs(banks, True)
    diff = (dense.float() - block.float()).abs()
    report["grid512_blockwise_vs_dense"] = {"max_abs": diff.max().item(),
                                            "mean_abs": diff.mean().item()}
    print(f"[grid] 512px 4x8, blockwise vs dense on the same banks: max_abs "
          f"{diff.max().item()} mean_abs {diff.mean().item()} (tolerance {GRID_MAX_ABS} / "
          f"{GRID_MEAN_ABS})", flush=True)
    if not (diff.max().item() <= GRID_MAX_ABS and diff.mean().item() <= GRID_MEAN_ABS):
        raise AssertionError("the blockwise grid disagrees with the dense grid")
    for blockwise in (False, True):
        pairs_s, k1, k3, _ = measure(extract, pairs, blockwise, 3, 32)
        want_k3 = 3 * 4 * 4 if blockwise else 0
        if k1 != 3 or k3 != want_k3:
            raise AssertionError(f"512px grid (blockwise={blockwise}): K1 {k1}, K3 {k3} launches "
                                 f"in 3 grids (3 and {want_k3} expected)")
        report[f"grid512_4x8_{'blockwise' if blockwise else 'dense'}_pairs_per_s"] = pairs_s
        report[f"grid512_4x8_{'blockwise' if blockwise else 'dense'}_peak_mem_gib"] = (
            torch.cuda.max_memory_allocated() / 2**30)
    del extract, pairs, banks, dense, block
    # 1024px 2 x 4 blockwise: extraction in chunks of 4 (4 + 2), 2 dispatches of 4 pairs
    extract, pairs = setup(1024, 2, 4, 4)
    pairs_s, k1, k3, out = measure(extract, pairs, True, 2, 8)
    if out.shape != (8, 1024, 1024, 3) or k1 != 2 * 2 or k3 != 2 * 2 * 4:
        raise AssertionError(f"1024px grid: output {tuple(out.shape)}, K1 {k1} and K3 {k3} "
                             "launches in 2 grids (4 and 16 expected)")
    report["grid1024_2x4_blockwise_pairs_per_s"] = pairs_s
    report["grid1024_2x4_blockwise_peak_mem_gib"] = torch.cuda.max_memory_allocated() / 2**30
    print(json.dumps(report), flush=True)


def cli_phase():
    from PIL import Image

    rng = np.random.default_rng(0)
    common = ["--device", "cuda", "--dtype", "bfloat16", "--fused_tap", "true",
              "--preprocess", "resize", "--load_size", "512", "--crop_size", "512"]
    with tempfile.TemporaryDirectory() as tmp:
        paths = []
        for name in ("content", "style"):
            p = os.path.join(tmp, f"{name}.png")
            Image.fromarray((rng.random((512, 512, 3)) * 255).astype(np.uint8)).save(p)
            paths.append(p)
        t0 = time.perf_counter()
        subprocess.run(
            [sys.executable, "-m", "ppst_tpu_torch.test", *common,
             "--evaluation_metrics", "simple_swapping", "--input_structure_image", paths[0],
             "--input_texture_image", paths[1], "--result_dir", os.path.join(tmp, "results")],
            cwd=ROOT, check=True, timeout=600)
        out = os.path.join(tmp, "results", "ppst", "results", "simpleswapping",
                           "content_style_1.00.png")
        shape = np.asarray(Image.open(out)).shape
        if shape != (512, 512, 3):
            raise AssertionError(f"CLI wrote an image of shape {shape}")
        print(f"[cli] python -m ppst_tpu_torch.test wrote {shape} in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)

        data = os.path.join(tmp, "grid")
        for sub in ("content", "style"):
            os.makedirs(os.path.join(data, sub))
            for i in range(2):
                Image.fromarray((rng.random((512, 512, 3)) * 255).astype(np.uint8)).save(
                    os.path.join(data, sub, f"{sub}{i}.png"))
        t0 = time.perf_counter()
        subprocess.run(
            [sys.executable, "-m", "ppst_tpu_torch.test", *common,
             "--evaluation_metrics", "content_style_grid_generation", "--dataset_mode",
             "imagefolder", "--dataroot", data, "--result_dir", os.path.join(tmp, "grid_results")],
            cwd=ROOT, check=True, timeout=600)
        page = os.path.join(tmp, "grid_results", "ppst", "results", "contentstylegridgeneration",
                            "test_latest")
        pngs = [f for f in os.listdir(os.path.join(page, "images")) if f.endswith(".png")]
        shapes = {np.asarray(Image.open(os.path.join(page, "images", f))).shape for f in pngs}
        if not os.path.exists(os.path.join(page, "index.html")) or len(pngs) < 7 or shapes != {
                (512, 512, 3)}:
            raise AssertionError(f"grid CLI wrote {len(pngs)} PNGs of shapes {shapes}")
        print(f"[cli] grid evaluator wrote index.html and {len(pngs)} PNGs in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)


def build_phase():
    """Build every kernel source at once, one nvcc each, and load them."""
    from ppst_tpu_torch.ops import _nvcc, corr_warp_cuda, tap_cuda

    def build(name):
        t0 = time.perf_counter()
        _nvcc.build(_nvcc.PKG / "csrc" / f"{name}.cu")
        return time.perf_counter() - t0

    names = ("tap", "corr_warp")
    with ThreadPoolExecutor(len(names)) as pool:
        for name, secs in zip(names, pool.map(build, names)):
            print(f"[build] csrc/{name}.cu built in {secs:.1f} s", flush=True)
    tap_cuda._lib()
    corr_warp_cuda._lib()


def phase(name, fn, *args):
    t0 = time.perf_counter()
    out = fn(*args)
    print(f"[phase] {name}: {time.perf_counter() - t0:.1f} s", flush=True)
    return out


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from ppst_tpu_torch.models.config import PPSTConfig
    from ppst_tpu_torch.models.ppst import PPSTModel
    from ppst_tpu_torch.ops import corr_warp_cuda, tap_cuda

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    bw, flops = card_peaks(torch.cuda.get_device_name(0))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    phase("build", build_phase)
    k1 = phase("kernel fused_tap_1x1", kernel_phase, tap_cuda, bw, flops, card)
    k3 = phase("kernel corr_warp_blockwise", corr_warp_phase, corr_warp_cuda, bw, flops, card)
    k1_launches = phase("path stylize 512px", path_phase, tap_cuda, corr_warp_cuda,
                        PPSTConfig, PPSTModel, card)
    k3_launches = phase("path stylize_fused 1024px", fused_path_phase, tap_cuda, corr_warp_cuda,
                        PPSTConfig, PPSTModel, card)
    phase("grid", grid_phase, tap_cuda, corr_warp_cuda, PPSTConfig, PPSTModel, card)
    phase("reference", small_reference_check, PPSTConfig, PPSTModel)
    phase("cli", cli_phase)

    print(json.dumps({"kernels": [
        {"name": "fused_tap_1x1", "route": "cuda", "source": "ppst_tpu_torch/csrc/tap.cu",
         "replaces": "ppst_tpu/ops/tap_pallas.py:135", "launches": k1_launches,
         "max_abs_err": k1["max_abs_err"], "ms": k1["ms"], "plain_ms": k1["plain_ms"],
         "bound_ms": k1["bound_ms"], "bound_by": k1["bound_by"], "library_ms": None},
        {"name": "corr_warp_blockwise", "route": "cuda",
         "source": "ppst_tpu_torch/csrc/corr_warp.cu",
         "replaces": "ppst_tpu/ops/corr_pallas.py:72", "launches": k3_launches,
         "max_abs_err": k3["max_abs_err"], "ms": k3["ms"], "plain_ms": k3["plain_ms"],
         "bound_ms": k3["bound_ms"], "bound_by": k3["bound_by"],
         "library_ms": k3["library_ms"]},
    ]}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
