#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``ppst_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which stops the run with a non-zero exit when it fails:

1. build: prints the card's name and power limit, builds the hand-written
   kernels from ``ppst_tpu_torch/csrc`` (one ``nvcc`` per source, all at
   once) and prints each build time and ptxas's registers, shared memory
   and spills of K1's, K2's, K3's, K6's and K4's kernels;
2. kernel: every kernel against its plain PyTorch version on the card (TF32
   off) at the main paths' shapes and an odd shape, with its determinism, its
   time, the plain version's time, the time of the one PyTorch call that
   computes the same function where there is one, and the least time the
   card could take; the fused tap's backward (K2) with and without dx; the
   fused StyledConv (K6) with the unfused StyledConv's time beside it, and
   its backward with and without dx and its split (passes 1-2, dW, dx), each
   with its share of the bound; the standalone upfirdn2d (K4: each case's
   route, the record and mid shapes on the TMA route, the cuDNN depthwise
   conv2d that computes the same function as its library call) and bias +
   leaky ReLU (K5) with the port's composite ops' times beside them;
3. path: 512px ``stylize`` at full width in bf16 with the fused tap and the
   guided filter, batch 1 then batch 8 pairs; then 1024px ``stylize_fused``
   (the blockwise correspondence) at batch 1; then 512px ``stylize`` with the
   fused StyledConv too (K6 22 times a call), its output against the unfused
   path's, and one 1024px ``stylize_fused`` call with it; each checks its
   output and the kernels it launched;
4. grid: a 512px 4x8 grid, dense and blockwise on the same banks, and a
   1024px 2x4 blockwise grid, with pairs/s amortized over extraction;
5. train: 512px full-width training in bf16 with the fused tap at batch 4
   (D, G and D+R1 steps through ``train.steps``): step times, training
   images/s, peak memory, every loss, every network moving, and the
   launches of K1 and K2 (K2 once per G step) and K3 (none);
   then ``remat_save_kernels`` off, on, off again and on again (the first
   D and G steps' losses bit-equal, no kernel prepared again in the first
   G backward with the knob on and some without it, its gradients on
   against off within 4 times the spread between runs of one setting, the
   next pair's step times and peak memory);
   then the same with the fused StyledConv (K6 and its backward counted);
   then 1024px training at batch 2 in the JAX package's 1024px mode (the
   blockwise differentiable correspondence, unbatched D passes, nested
   remat; K1 three times a G step, K3 and K6 never), and again with the
   blockwise correspondence alone;
   validate: the training-validation tools at 256px, batch 2 (their own
   synthetic stream; 36 D + G iterations, lazy R1 in the 1st, 17th, 33rd):
   ``tools/bf16_validation.py``'s float32 run, its bf16 run with the fused
   tap (K1, K2) and with the fused StyledConv too (K6 and its backward),
   each bf16 run's G-side tail means against float32's within a bound, then
   ``tools/lpips_ablation.py``'s runs with the cycle-warp LPIPS term on and
   off; each run finite, every network moving, each kernel launched as its
   configuration says;
6. reference: a narrow float32 model at crop 64 on the card against the CPU
   run of the same code (``stylize``, ``stylize_fused``, blockwise
   ``grid_pairs``; the D step's, the R1 penalty's and the G step's losses
   and gradients), the narrow generator's bf16-vs-float32 distance on the
   card and on the CPU, the training check again with the 1024px mode's
   knobs, and the narrow bf16 model with the fused StyledConv on the card
   against the CPU (generator outputs, one G step); the smoothing filter
   at 512 x 512, f_radius 15, on the card against the CPU, and its time,
   and its PIL wrapper on the card (its default) against the CPU;
7. cli: ``python -m ppst_tpu_torch.test --device cuda`` (seed weights saved
   as a checkpoint and passed with ``--checkpoint``) on two generated
   512px PNGs (simple_swapping), again with ``--fused_styled_conv true``, then
   the grid evaluator on a generated folder of 2 + 2 512px PNGs; ``python -m
   ppst_tpu_torch.train --device cuda`` at 512px, batch 2, then
   ``--continue_train``, then its checkpoint served by ``python -m
   ppst_tpu_torch.test --checkpoint``; then the training CLI in this
   process at 512px, bf16 with the fused tap, on a generated CelebAMask
   folder of 520 x 600 images (scale_width_and_crop), with snapshots every 4
   images and the swap_visualization evaluator at image 8, then
   ``--continue_train``: its snapshots, grid page and K1/K2 launches, the
   peak memory around each evaluation, and ``data`` ms/img from the loss
   log beside the loader's own cost of one batch; then the grid evaluator on
   a ``.pak`` made by ``python -m ppst_tpu_torch.data.dataset_tools`` from a
   folder of 2 + 4 512px PNGs (``--dataset_mode lmdb``), its PNGs identical
   to the same folder's grid; then the training CLI under ``python -m
   torch.distributed.run --nproc_per_node 1`` on NCCL at 512px, bf16 with the
   fused tap, on CelebAMask pairs through the native IO library, with
   background checkpoint saves and ``--profile_dir`` (K1 and K2 counted in
   the trace of steps 10-14), a background save checked against a blocking
   one of the same state, a G step's wall alone and with a background save,
   its copy to the host or its ``torch.save`` in flight (what a save costs
   the loop), ``--continue_train`` from it, and the loader's ms per image
   with and without the native library; last, the reference launcher's
   recipes through ``python -m ppst_tpu_torch.experiments CelebA``, in this
   process: ``dry``, the train line on a generated CelebAMask tree (bf16,
   fused tap, 16 images, swap_visualization; ``opt.txt``, ``opt.pkl``, the
   checkpoints, K1 and K2 counted), then the test line's grid on a tree of
   2 contents and 4 styles with no ``--checkpoint`` (it finds the train
   run's), its PNGs bit-equal to the same grid from ``--dataset_mode
   imagefolder``.

Each phase prints its seconds. Then the script prints the ``kernels`` line
and, last, the ``ok`` line. Without a CUDA device it exits non-zero before
printing any result.
"""

from __future__ import annotations

import contextlib
import json
import os
import re
import statistics
import subprocess
import sys
import tempfile
import threading
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
# Measured on an H100 (the wgmma kernel, ppst_tpu_torch/tools/k3_ab.py): at
# most one bf16 step of the output (0.0031 max|v|), a mean of 3.1e-5 max|v|;
# float32 5e-7 max|v|.
CORR_BF16_MAX, CORR_BF16_MEAN, CORR_F32_MAX = 1e-2, 2e-4, 1e-5
# (B, Lq, Lk, C, Cv, dtype): 512px at the narrowest and widest E2 scale,
# 1024px at all four (the path's widths), an odd rectangular shape, a float32
# shape with ragged tails, and the 512px grid's dispatch of 8 pairs
CORR_SHAPES = [(1, 4096, 4096, 512, 32, torch.bfloat16), (1, 4096, 4096, 512, 256, torch.bfloat16),
               (1, 16384, 16384, 512, 32, torch.bfloat16),
               (1, 16384, 16384, 512, 256, torch.bfloat16),
               (1, 200, 136, 512, 48, torch.bfloat16), (2, 300, 200, 288, 40, torch.float32),
               (1, 16384, 16384, 512, 64, torch.bfloat16),
               (1, 16384, 16384, 512, 128, torch.bfloat16),
               (8, 4096, 4096, 512, 256, torch.bfloat16)]
# blockwise against dense grid outputs on the [-1, 1] scale, both in bf16: the
# two round the correspondence at different places. Measured on an H100:
# 0.0137 max, 0.00156 mean; the bound leaves 3.5x.
GRID_MAX_ABS, GRID_MEAN_ABS = 0.05, 0.005
# 512px stylize with the fused StyledConv against the unfused path, same
# weights (nonzero noise gains and biases), pinned bf16 noise, on the [-1, 1]
# scale. Measured on the CPU at full width: 0.0053 max, 0.0012 mean at 64px,
# 0.0087 and 0.0017 at 128px; the bounds leave 5.7x and 3x over the larger.
FUSED_SC_MAX_ABS, FUSED_SC_MEAN_ABS = 0.05, 0.005
NARROW = dict(crop_size=64, netE_scale_capacity=0.25, netE2_scale_capacity=0.25,
              global_code_ch=64, spatial_code_ch=16, netG_resnet_ch=32,
              netG_scale_capacity=0.125)
# K2's tolerance, as in tests/test_pallas_kernels.py::test_tap_pallas_grad: 2%
# of each gradient's max; the bias gradients (a mathematical zero: a
# per-channel shift cancels in the next instance norm) at noise level, below
# 1% of the largest gradient. Its max_abs_err is the largest |kernel - plain|
# over every gradient, shape and dx setting.
TAP_BWD_REL = 0.02
TAP_BWD_NAMES = ("dx", "dw1", "db1", "da1", "dw2", "db2", "da2")
# card against CPU, narrow float32 training losses and gradients: the bounds of
# tests/test_torch_train.py (port against JAX on the CPU), whose max-pools
# and kinks flip where two values nearly tie
TRAIN_LOSS_RTOL, TRAIN_GRAD_RTOL, TRAIN_GRAD_ATOL, TRAIN_GRAD_COS = 1e-4, 5e-2, 5e-3, 0.995
# the same with the 1024px mode's knobs and four row blocks, where only the D
# tensors of TRAIN_TIE_REACH may instead be within a normalized L2 distance
# of 5e-2 (floored at 1e-6 of the global norm), as in
# tests/test_torch_train_blockwise.py: this batch puts one of the leaky-ReLU
# pre-activations of D's res8 conv2 within float32 noise of zero, and the
# unbatched D step's inputs, made by G passes at other batch sizes, flip it.
# The backward carries the flip to that conv and every layer before it
# (from_rgb and res64-res16 are convs 0 and 3-5, res8 is 6). Measured on an
# H100, card against CPU: only that conv's leaky-ReLU bias is outside the
# element-wise bound, 7.6% of its largest element apart and 1.4% in L2.
TRAIN_BLOCKWISE_GRAD_L2 = 5e-2
TRAIN_TIE_REACH = tuple(f"D.stylegan2_D.convs.{k}." for k in ("0", "3", "4", "5", "6.conv1",
                                                              "6.conv2"))
# K6 (the fused StyledConv) at (B, H, W, Cin, Cout): an odd shape, then the
# 512px generator's (heads at 64x64, the up-blocks' conv2 at 128-512px) at
# batch 8 (decode) and 16 (extraction), and the 1024px stylize_fused up-block
# conv2; its record is the decode's up64 conv2
K6_SHAPES = [(1, 20, 36, 48, 80), (8, 64, 64, 256, 384), (8, 64, 64, 512, 512),
             (8, 128, 128, 512, 512), (8, 256, 256, 256, 256), (8, 512, 512, 128, 128),
             (16, 512, 512, 128, 128), (2, 1024, 1024, 128, 128)]
K6_RECORD = (8, 512, 512, 128, 128)
# K6's tolerance against its plain version (TF32 off), tightened from
# test_styled_conv_pallas_fwd_bwd's 0.05 max(1, max|ref|) on the output and
# 0.04 max(max|ref|, 0.01 largest gradient) on each gradient to what an H100
# measured: the output to 0.0091 max(1, max|ref|) (a flipped bf16 rounding of
# a), a mean of 6.6e-6; dx to 0.0031 (one bf16 step), dW to 2.2e-4, the rest
# below 1e-5. The bounds leave 2-3x.
K6_MAX, K6_MEAN, K6_BWD_REL = 0.02, 1e-4, 0.01
K6_BWD_NAMES = ("dx", "dw", "dgain", "db", "dscale", "dshift")
# K4 (upfirdn2d) at (shape, dtype, taps, pad, down) and the route it must
# take: G's blur at its largest activation (the record), D's downsample, an
# odd float32 shape (the TMA route's general instance, three taps),
# asymmetric taps (a kernel that does not flip them fails there) on shapes
# whose channels take the generic route in bf16 and float32, then two timed
# mid shapes (G's blur at 128px, D's downsample at 256px). The shapes of at
# least 128 x 128 are timed. Its tolerance is tools/k4_ab.py's (``within``).
K4_CASES = [((8, 512, 512, 128), torch.bfloat16, (1, 3, 3, 1), (2, 1), 1, "tma"),
            ((8, 512, 512, 128), torch.bfloat16, (1, 3, 3, 1), (1, 1), 2, "tma"),
            ((3, 37, 21, 24), torch.float32, (1, 2, 1), (2, 1), 2, "tma"),
            ((2, 19, 33, 20), torch.bfloat16, (1, 2, 3), (1, 2), 1, "generic"),
            ((2, 19, 33, 3), torch.float32, (1, 2, 3), (1, 2), 2, "generic"),
            ((8, 128, 128, 512), torch.bfloat16, (1, 3, 3, 1), (2, 1), 1, "tma"),
            ((8, 256, 256, 256), torch.bfloat16, (1, 3, 3, 1), (1, 1), 2, "tma")]
# K5 (bias + leaky ReLU + gain) at these shapes; the first is the record. The
# kernel rounds where the plain op rounds: bitwise equal in both dtypes
# the JAX package's 1024px training mode (tools/bench_train.py --crop 1024
# --batch 2 --corr_blockwise --unbatch --remat all --remat_taps --remat_blocks
# --fused_tap, BASELINE.md), besides crop, batch, bf16 and the fused tap
TRAIN_1024_KNOBS = dict(corr_blockwise=True, unbatch_passes=True, remat=True, remat_nets="all",
                        remat_taps=True, remat_blocks=True)
K5_CASES = [((8, 512, 512, 128), torch.bfloat16), ((8, 512, 512, 128), torch.float32),
            ((3, 17, 9, 40), torch.bfloat16), ((2, 5, 7, 13), torch.bfloat16)]
# the validate phase: tools/bf16_validation.py's float32 run and two bf16 runs
# (the fused tap; the fused tap and the fused StyledConv) at 256px, batch 2,
# for VALIDATE_STEPS D + G iterations (lazy R1 in iterations 0, 16 and 32),
# then tools/lpips_ablation.py's two runs for LPIPS_STEPS. Each bf16 run's
# tail means of the generator's losses (bf16_validation.G_SIDE, over the last
# quarter) within VALIDATE_G_REL of the float32 run's, relatively: >= 3x the
# largest gap after 33-48 iterations of an H100's 120-iteration runs (PERF.md
# section 6, run V2), the two bf16 runs against float32 and the two float32
# runs against each other (G_L1 0.070, G_GAN_rec 0.067, G_styleContmix
# 0.057, Mask_warp 0.026, image_warp_reg 0.180, the last between the two
# float32 runs). The D-side losses sit near 0 and are reported only.
VALIDATE_STEPS, LPIPS_STEPS, VALIDATE_CROP, VALIDATE_BATCH = 36, 16, 256, 2
VALIDATE_G_REL = {"G_L1": 0.21, "G_L1_cyc": 0.21, "L1_dist": 0.21, "G_GAN_mix": 0.2,
                  "G_GAN_rec": 0.21, "G_styleContmix": 0.18, "G_styleContrec": 0.14,
                  "Mask_warp": 0.08, "image_warp_reg": 0.54}


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


def repeat_with_churn(fn, args, k):
    """fn(*args) while (k + 1) x 64 MB of device memory are held, so that the
    call's outputs and scratch land elsewhere than the last call's."""
    junk = torch.empty(((k + 1) << 24,), device="cuda")
    out = fn(*args)
    del junk
    return out


def kernel_phase(tap_cuda, bw, flops, card):
    """K1 against its plain version at the serving paths' shapes, the
    swap_visualization evaluator's one image at a time, the 4x8 grid's and
    the packed grid's batched extractions (4 and 6 images), an odd shape and
    1024px training's (2, 1024, 1024, 128); returns the kernel's record."""
    g = torch.Generator(device="cuda").manual_seed(0)
    max_err = 0.0
    record = None
    for shape in [(2, 512, 512, 128), (1, 512, 512, 128), (4, 512, 512, 128),
                  (6, 512, 512, 128), (16, 512, 512, 128), (3, 40, 24, 128),
                  (2, 1024, 1024, 128)]:
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
        # the same bits on repeated calls, with the allocator churned between
        # them (a race in a persistent pass shows as a few differing rows)
        if not all(torch.equal(got, repeat_with_churn(tap_cuda.fused_tap_1x1, args, k))
                   for k in range(4)):
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
        design_ms = design_bytes / bw * 1e3
        ops = 2 * pixels * (128 * 64 + 64 * 64)
        bound_ms = max(min_bytes / bw, ops / flops) * 1e3
        bound_by = "bytes" if min_bytes / bw >= ops / flops else "operations"
        ms, plain_ms = cuda_ms(lambda: tap_cuda.fused_tap_1x1(*args),
                               other=lambda: tap_cuda.fused_tap_1x1_reference(*args))
        print(f"[kernel] fused_tap_1x1 {shape}: {ms:.4f} ms, plain {plain_ms:.4f} ms, "
              f"bound {bound_ms:.4f} ms ({min_bytes / 1e6:.1f} MB at {bw / 1e12} TB/s, "
              f"{bound_by}), share of the bound {bound_ms / ms:.3f}; four-pass design traffic "
              f"{design_bytes / 1e6:.1f} MB -> {design_ms:.4f} ms, share {design_ms / ms:.3f}; "
              f"{ops / 1e9:.2f} GFLOP; {card}", flush=True)
        if record is None:  # the batch-1 pair's extraction shape
            record = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by)
    record["max_abs_err"] = max_err
    return record


def tap_bwd_phase(tap_cuda, bw, flops, card):
    """K2 against its plain version on the residuals K1 gives, at 512px
    training's shape, an odd shape and 1024px training's (2, 1024, 1024,
    128); returns its record at 512px training's, (4, 512, 512, 128) without
    dx."""
    g = torch.Generator(device="cuda").manual_seed(2)
    max_err, record = 0.0, None
    for shape in [(2, 512, 512, 128), (4, 512, 512, 128), (3, 40, 24, 128),
                  (2, 1024, 1024, 128)]:
        x = torch.randn(shape, generator=g, device="cuda").bfloat16()
        w1 = torch.randn((64, 128), generator=g, device="cuda") * 0.1
        b1 = torch.randn((64,), generator=g, device="cuda") * 0.1
        w2 = torch.randn((64, 64), generator=g, device="cuda") * 0.1
        b2 = torch.randn((64,), generator=g, device="cuda") * 0.1
        a1 = torch.full((1,), 0.25, device="cuda")
        a2 = torch.full((1,), -0.1, device="cuda")
        _, (t, u, mr) = tap_cuda._forward(x, w1, b1, a1, w2, b2, a2)
        cot = torch.randn(shape[:3] + (64,), generator=g, device="cuda").bfloat16()
        for need_dx in (False, True):
            args = (x, t, u, mr, w1, w2, a1, a2, cot, need_dx)
            got = tap_cuda.fused_tap_1x1_bwd(*args)
            torch.cuda.synchronize()
            want = tap_cuda.fused_tap_1x1_bwd_reference(*args)
            overall = max(w.abs().max().item() for w in want if w is not None)
            rel = {}
            for name, a, b in zip(TAP_BWD_NAMES, got, want):
                if b is None:
                    if a is not None:
                        raise AssertionError("fused_tap_1x1_bwd returned dx unasked")
                    continue
                a, b = a.float(), b.float()
                if not torch.isfinite(a).all().item() or a.shape != b.shape:
                    raise AssertionError(f"fused_tap_1x1_bwd {name}: bad output at {shape}")
                bmax = b.abs().max().item()
                max_err = max(max_err, (a - b).abs().max().item())
                if name.startswith("db"):
                    rel[name] = a.abs().max().item() / overall
                    ok = bmax < 0.02 * overall and rel[name] <= max(bmax / overall, 0.01)
                else:
                    rel[name] = (a - b).abs().max().item() / bmax
                    ok = rel[name] <= TAP_BWD_REL
                if not ok:
                    raise AssertionError(f"fused_tap_1x1_bwd {name} disagrees with its plain "
                                         f"version at {shape}, dx={need_dx}: {rel[name]}")
            print(f"[kernel] fused_tap_1x1_bwd {shape} dx={need_dx}: max |error| / max |grad| "
                  + ", ".join(f"{k} {v:.3g}" for k, v in rel.items())
                  + f" (tolerance {TAP_BWD_REL}; db* as |grad| / largest, noise level)", flush=True)
            for k in range(4):
                again = repeat_with_churn(tap_cuda.fused_tap_1x1_bwd, args, k)
                if not all((a is None and b is None) or torch.equal(a, b)
                           for a, b in zip(got, again)):
                    raise AssertionError("fused_tap_1x1_bwd is not deterministic")
            if shape[1] < 512:
                continue
            b, h, w, cin = shape
            pixels = b * h * w
            # least traffic: x, t, u and g read once (640 B a pixel), dx written
            min_bytes = pixels * (cin + 3 * 64) * 2 + (pixels * cin * 2 if need_dx else 0)
            # the products this call needs: dW2, dp2 and dW1 (and dn1 for dx)
            ops = 2 * pixels * (2 * 64 * 64 + 64 * 128 * (2 if need_dx else 1))
            bound_ms = max(min_bytes / bw, ops / flops) * 1e3
            bound_by = "bytes" if min_bytes / bw >= ops / flops else "operations"
            # traffic of the design: u, g; t, u, g; t, u, g, x (and with dx t, u,
            # g, x again and dx written): 1280 B a pixel, 2176 with dx
            design_ms = pixels * (2176 if need_dx else 1280) / bw * 1e3
            ms, plain_ms = cuda_ms(lambda: tap_cuda.fused_tap_1x1_bwd(*args),
                                   other=lambda: tap_cuda.fused_tap_1x1_bwd_reference(*args))
            print(f"[kernel] fused_tap_1x1_bwd {shape} dx={need_dx}: {ms:.4f} ms, plain "
                  f"{plain_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}: {min_bytes / 1e6:.1f} "
                  f"MB at {bw / 1e12} TB/s, {ops / 1e9:.2f} GFLOP at {flops / 1e12} TFLOP/s), "
                  f"share of the bound {bound_ms / ms:.3f}; design traffic {design_ms:.4f} ms, "
                  f"share {design_ms / ms:.3f}; {card}", flush=True)
            if b == 4 and not need_dx:
                record = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by)
    record["max_abs_err"] = max_err
    return record


def styled_conv_inputs(g, b, h, w, cin, cout):
    """Inputs of the fused StyledConv as the generator gives them: bf16
    activations and noise, He-scaled float32 weights, nonzero gain and biases,
    style scale and shift of the StyleMod linear's size."""
    x = torch.randn((b, h, w, cin), generator=g, device="cuda").bfloat16()
    wt = torch.randn((cout, cin, 3, 3), generator=g, device="cuda") * (2.0 / (9 * cin)) ** 0.5
    noise = torch.randn((b, h, w, 1), generator=g, device="cuda").bfloat16()
    gain = torch.full((1,), 0.3, device="cuda")
    bt = torch.randn((cout,), generator=g, device="cuda") * 0.1
    s1 = (torch.randn((b, cout), generator=g, device="cuda") * 0.3 + 1.0).bfloat16().float()
    shift = torch.randn((b, cout), generator=g, device="cuda") * 0.3
    return x, wt, noise, gain, bt, s1, shift


def styled_conv_bound(shape, bw, flops, backward=False):
    """(bound_ms, bound_by, GFLOP, MB): the products of the conv (forward) or
    of dx and dW (backward) at the dense bf16 rate against the bytes the
    function must move once (forward: x, noise and the weights in, out out;
    backward: x, a, g and noise in, dx out), at the card's memory rate."""
    b, h, w, cin, cout = shape
    pix = b * h * w
    ops = 2 * pix * 9 * cin * cout * (2 if backward else 1)
    if backward:
        nbytes = pix * (2 * cin + 2 * cout + 1) * 2 + 9 * cin * cout * 4
    else:
        nbytes = pix * (cin + cout + 1) * 2 + 9 * cin * cout * 2 + 4 * cout * (1 + 2 * b)
    by = "bytes" if nbytes / bw >= ops / flops else "operations"
    return max(nbytes / bw, ops / flops) * 1e3, by, ops / 1e9, nbytes / 1e6


def composite_styled_conv(shape, gen):
    """The port's unfused StyledConv (cuDNN conv and elementwise kernels) at
    ``shape``, bf16, with pinned bf16 noise: the yardstick of the fused op."""
    from ppst_tpu_torch.nn.layers import StyledConv, init_weights

    b, h, w, cin, cout = shape
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


def styled_conv_phase(sc, bw, flops, card):
    """K6's forward against its plain version at the generator's 512px shapes
    and an odd one; returns its record at the decode's largest shape."""
    g = torch.Generator(device="cuda").manual_seed(3)
    max_err, record = 0.0, None
    for shape in K6_SHAPES:
        args = styled_conv_inputs(g, *shape)
        got = sc._forward(*args)[0]
        torch.cuda.synchronize()
        want = sc.styled_conv3x3_reference(*args)
        err = (got.float() - want.float()).abs()
        mx, mean = err.max().item(), err.mean().item()
        tol = K6_MAX * max(1.0, want.float().abs().max().item())
        print(f"[kernel] styled_conv3x3 {shape}: max_abs_err {mx} mean_abs_err {mean} "
              f"(tolerance {tol} / {K6_MEAN})", flush=True)
        if not (got.shape == want.shape and torch.isfinite(got.float()).all().item()
                and mx <= tol and mean <= K6_MEAN):
            raise AssertionError(f"styled_conv3x3 disagrees with its plain version at {shape}")
        if not torch.equal(got, sc._forward(*args)[0]):
            raise AssertionError(f"styled_conv3x3 is not deterministic at {shape}")
        max_err = max(max_err, mx)
        if shape[1] < 64:
            continue
        bound_ms, bound_by, gflop, mb = styled_conv_bound(shape, bw, flops)
        ms, plain_ms = cuda_ms(lambda: sc._forward(*args), reps=10,
                               other=lambda: sc.styled_conv3x3_reference(*args))
        del got, want, err
        composite_ms = cuda_ms(composite_styled_conv(shape, g), reps=10)
        print(f"[kernel] styled_conv3x3 {shape}: {ms:.4f} ms, plain {plain_ms:.4f} ms, "
              f"composite StyledConv {composite_ms:.4f} ms, bound {bound_ms:.4f} ms "
              f"({bound_by}: {gflop:.1f} GFLOP at {flops / 1e12} TFLOP/s, {mb:.1f} MB at "
              f"{bw / 1e12} TB/s), {bound_ms / ms:.1%} of the bound; {card}", flush=True)
        if shape == K6_RECORD:
            record = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                          composite_ms=composite_ms)
    record["max_abs_err"] = max_err
    return record


def styled_conv_bwd_phase(sc, bw, flops, card):
    """K6's backward against its plain version on the residuals K6's forward
    gives, with dx, at the same shapes (and once without dx); returns its
    record at the decode's largest shape."""
    g = torch.Generator(device="cuda").manual_seed(4)
    max_err, record = 0.0, None
    for shape in K6_SHAPES + [K6_SHAPES[0] + ("no dx",)]:
        need_dx = shape[-1] != "no dx"
        shape = shape[:5]
        x, wt, noise, gain, bt, s1, shift = styled_conv_inputs(g, *shape)
        _, (a, mean, rstd) = sc._forward(x, wt, noise, gain, bt, s1, shift)
        cot = torch.randn(a.shape, generator=g, device="cuda").bfloat16()
        args = (x, wt, noise, a, mean, rstd, s1, cot, need_dx)
        got = sc.styled_conv3x3_bwd(*args)
        torch.cuda.synchronize()
        want = sc.styled_conv3x3_bwd_reference(*args)
        overall = max(v.abs().max().item() for v in want if v is not None)
        rel = {}
        for name, u, v in zip(K6_BWD_NAMES, got, want):
            if v is None:
                if u is not None:
                    raise AssertionError("styled_conv3x3_bwd returned dx unasked")
                continue
            u, v = u.float(), v.float()
            if not torch.isfinite(u).all().item() or u.shape != v.shape:
                raise AssertionError(f"styled_conv3x3_bwd {name}: bad output at {shape}")
            if name == "dw" and got[1].dtype != torch.float32:
                raise AssertionError("styled_conv3x3_bwd: dW is not float32")
            gap = (u - v).abs().max().item()
            max_err = max(max_err, gap)
            rel[name] = gap / max(v.abs().max().item(), 0.01 * overall)
            if rel[name] > K6_BWD_REL:
                raise AssertionError(f"styled_conv3x3_bwd {name} disagrees with its plain "
                                     f"version at {shape}, dx={need_dx}: {rel[name]}")
        print(f"[kernel] styled_conv3x3_bwd {shape} dx={need_dx}: max |error| / max(max |grad|, "
              "0.01 largest) " + ", ".join(f"{k} {v:.3g}" for k, v in rel.items())
              + f" (tolerance {K6_BWD_REL})", flush=True)
        again = sc.styled_conv3x3_bwd(*args)
        if not all((u is None and v is None) or torch.equal(u, v) for u, v in zip(got, again)):
            raise AssertionError(f"styled_conv3x3_bwd is not deterministic at {shape}")
        del got, want, again
        if shape[1] < 64 or not need_dx:
            continue
        bound_ms, bound_by, gflop, mb = styled_conv_bound(shape, bw, flops, backward=True)
        ms, plain_ms = cuda_ms(lambda: sc.styled_conv3x3_bwd(*args), reps=10,
                               other=lambda: sc.styled_conv3x3_bwd_reference(*args))
        # the split: passes 1-2 (dpre, the sums, db, dgain), dW and dx, each alone
        run, _ = sc._bwd_parts(*args)
        split = {part: cuda_ms(lambda p=part: run(p), reps=10) for part in ("dpre", "dw", "dx")}
        print(f"[kernel] styled_conv3x3_bwd {shape}: {ms:.4f} ms (passes 1-2 "
              f"{split['dpre']:.4f}, dW {split['dw']:.4f}, dx {split['dx']:.4f} ms), plain "
              f"{plain_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}: {gflop:.1f} GFLOP at "
              f"{flops / 1e12} TFLOP/s, {mb:.1f} MB at {bw / 1e12} TB/s), {bound_ms / ms:.1%} "
              f"of the bound; {card}", flush=True)
        del run
        if shape == K6_RECORD:
            record = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by)
    record["max_abs_err"] = max_err
    return record


def fir_phase(fir, bw, card):
    """K4 against its plain version (TF32 off), the route each case took, its
    determinism (with the allocator churned between calls), and at the timed
    shapes its time through the wrapper, its device time over back-to-back
    launches, the plain version's, the library call's (one cuDNN depthwise
    conv2d, ``tools/k4_ab.py``'s ``library_call``) and the port's composite
    upfirdn2d's (two cuDNN depthwise convolutions) beside the byte bound;
    returns its record at G's blur shape."""
    from ppst_tpu_torch.ops.upfirdn2d import upfirdn2d
    from ppst_tpu_torch.tools.k4_ab import K4_BF16_REL, K4_F32_MAX, library_call, within

    g = torch.Generator(device="cuda").manual_seed(5)
    max_err, record, launches0 = 0.0, None, fir.upfirdn2d_cuda.launches
    for shape, dt, taps, pad, down, expected in K4_CASES:
        x = torch.randn(shape, generator=g, device="cuda").to(dt)
        k = np.asarray(taps, np.float32) / sum(taps)

        def kernel(x):
            return fir.upfirdn2d_cuda(x, k, down=down, pad=pad)

        routes = dict(fir.upfirdn2d_cuda.route_launches)
        got = kernel(x)
        torch.cuda.synchronize()
        route = next(r for r, n in fir.upfirdn2d_cuda.route_launches.items() if n != routes[r])
        want = fir.upfirdn2d_cuda_reference(x, k, down=down, pad=pad)
        ok, mx = within(got, want)
        name = f"{shape} {str(dt).split('.')[-1]} taps {taps} pad {pad} down {down}"
        timed = min(shape[1:3]) >= 128
        print(f"[kernel] upfirdn2d_cuda {name}: route {route}, max_abs_err {mx}, bitwise "
              f"{torch.equal(got, want)} (tolerance: float32 {K4_F32_MAX} max(1, max|out|), "
              f"bf16 {K4_BF16_REL} |out|)", flush=True)
        if not ok:
            raise AssertionError(f"upfirdn2d_cuda disagrees with its plain version at {name}")
        if route != expected:
            raise AssertionError(f"upfirdn2d_cuda took the {route} route at {name}, not the "
                                 f"{expected} route")
        # the same bits on repeated calls, with the allocator churned between
        # them (a band handed back to the TMA ring too early shows as a few
        # wrong rows now and then)
        if not all(torch.equal(got, repeat_with_churn(kernel, (x,), kk)) for kk in range(4)):
            raise AssertionError(f"upfirdn2d_cuda is not deterministic at {name}")
        max_err = max(max_err, mx)
        if not timed:
            continue
        nbytes = (x.numel() + got.numel()) * x.element_size()
        bound_ms = nbytes / bw * 1e3
        ms, plain_ms = cuda_ms(lambda: kernel(x),
                               other=lambda: fir.upfirdn2d_cuda_reference(x, k, down=down,
                                                                          pad=pad))
        device_ms = cuda_ms(lambda: [kernel(x) for _ in range(20)], reps=5) / 20
        lib_fn, as_nhwc = library_call(x, k, down, pad)
        lib_err = (as_nhwc(lib_fn()).float() - want.float()).abs().max().item()
        library_ms = cuda_ms(lib_fn)
        composite_ms = cuda_ms(lambda: upfirdn2d(x, k, down=down, pad=pad))
        print(f"[kernel] upfirdn2d_cuda {name}: {ms:.4f} ms (device, 20 back to back: "
              f"{device_ms:.4f} ms), plain {plain_ms:.4f} ms, library call (cuDNN depthwise "
              f"conv2d, max_abs_err {lib_err} against the plain version) {library_ms:.4f} ms, "
              f"composite upfirdn2d (cuDNN depthwise) {composite_ms:.4f} ms, bound "
              f"{bound_ms:.4f} ms (bytes: {nbytes / 1e6:.1f} MB at {bw / 1e12} TB/s), share of "
              f"the bound {bound_ms / ms:.3f} ({bound_ms / device_ms:.3f} device); {card}",
              flush=True)
        if record is None:
            record = dict(ms=ms, device_ms=device_ms, plain_ms=plain_ms, bound_ms=bound_ms,
                          bound_by="bytes", library_ms=library_ms, composite_ms=composite_ms)
    record.update(max_abs_err=max_err, check_launches=fir.upfirdn2d_cuda.launches - launches0)
    return record


def act_phase(act, bw, card):
    """K5 against its plain version (bitwise), its determinism, and at the
    512px shapes its time and the plain op's (which is the port's composite:
    PyTorch's elementwise kernels) beside the byte bound; returns its record
    at the bf16 512px shape."""
    g = torch.Generator(device="cuda").manual_seed(6)
    max_err, record, launches0 = 0.0, None, act.fused_leaky_relu_cuda.launches
    for shape, dt in K5_CASES:
        x = torch.randn(shape, generator=g, device="cuda").to(dt)
        bias = torch.randn((shape[-1],), generator=g, device="cuda") * 0.5
        got = act.fused_leaky_relu_cuda(x, bias)
        torch.cuda.synchronize()
        want = act.fused_leaky_relu_cuda_reference(x, bias)
        mx = (got.float() - want.float()).abs().max().item()
        name = f"{shape} {str(dt).split('.')[-1]}"
        print(f"[kernel] fused_leaky_relu_cuda {name}: max_abs_err {mx}, bitwise "
              f"{torch.equal(got, want)} (tolerance: bitwise)", flush=True)
        if got.shape != want.shape or got.dtype != x.dtype or not torch.equal(got, want):
            raise AssertionError(f"fused_leaky_relu_cuda disagrees with its plain version at "
                                 f"{name}")
        if not torch.equal(got, act.fused_leaky_relu_cuda(x, bias)):
            raise AssertionError(f"fused_leaky_relu_cuda is not deterministic at {name}")
        max_err = max(max_err, mx)
        if shape[1] < 512:
            continue
        nbytes = 2 * x.numel() * x.element_size() + bias.numel() * x.element_size()
        bound_ms = nbytes / bw * 1e3
        ms, plain_ms = cuda_ms(lambda: act.fused_leaky_relu_cuda(x, bias),
                               other=lambda: act.fused_leaky_relu_cuda_reference(x, bias))
        print(f"[kernel] fused_leaky_relu_cuda {name}: {ms:.4f} ms, plain (the port's composite "
              f"fused_leaky_relu) {plain_ms:.4f} ms, bound {bound_ms:.4f} ms (bytes: "
              f"{nbytes / 1e6:.1f} MB at {bw / 1e12} TB/s); {card}", flush=True)
        if record is None:
            record = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by="bytes")
    record.update(max_abs_err=max_err,
                  check_launches=act.fused_leaky_relu_cuda.launches - launches0)
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
              f"TFLOP/s, {min_bytes / 1e6:.1f} MB at {bw / 1e12} TB/s), "
              f"{bound_ms / ms:.1%} of the bound; {card}", flush=True)
        if lq == 16384 and cv == 32:
            record = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                          library_ms=library_ms)
    record["max_abs_err"] = max_err
    return record


def kernel_wrappers():
    """Every kernel wrapper of the port, each with its launch count."""
    from ppst_tpu_torch.ops import (corr_warp_cuda, fused_act_cuda, styled_conv_cuda, tap_cuda,
                                    upfirdn2d_cuda)

    return (tap_cuda.fused_tap_1x1, tap_cuda.fused_tap_1x1_bwd, corr_warp_cuda.corr_warp_blockwise,
            styled_conv_cuda.styled_conv3x3, styled_conv_cuda.styled_conv3x3_bwd,
            upfirdn2d_cuda.upfirdn2d_cuda, fused_act_cuda.fused_leaky_relu_cuda)


def reset_launches():
    for k in kernel_wrappers():
        k.launches = 0


# K4's and K5's launches on the path phases, each read just after a path ran
# from counts set to 0 (no path of the port runs them)
STANDALONE_PATH_LAUNCHES = {"upfirdn2d_cuda": 0, "fused_leaky_relu_cuda": 0}


def read_standalone_launches():
    """Adds K4's and K5's launches since the last reset_launches() to
    STANDALONE_PATH_LAUNCHES."""
    for k in kernel_wrappers():
        if k.__name__ in STANDALONE_PATH_LAUNCHES:
            STANDALONE_PATH_LAUNCHES[k.__name__] += k.launches


def check_no_backward(path):
    """A serving path launches no backward kernel."""
    for k in kernel_wrappers():
        if k.__name__.endswith("_bwd") and k.launches:
            raise AssertionError(f"{path} launched {k.__name__} {k.launches} times")


def nonzero_styled_conv_params(model, gains=True, seed=7):
    """Seeded nonzero StyledConv biases (and noise gains), zero at init, so
    that their handling by the fused and the unfused paths shows."""
    from ppst_tpu_torch.nn.layers import StyledConv

    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in model.G.modules():
            if isinstance(m, StyledConv):
                for p in (m.conv.bias, m.bias, m.activate.bias):
                    p.copy_(torch.empty(p.shape).uniform_(-0.2, 0.2, generator=g))
                if gains and m.noise is not None:
                    m.noise.weight.copy_(torch.empty(1).uniform_(0.05, 0.2, generator=g))


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

    reset_launches()
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
    check_no_backward("stylize")
    read_standalone_launches()

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
    reset_launches()
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
    check_no_backward("stylize_fused")
    read_standalone_launches()

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


def styled_conv_path_phase(tap_cuda, cw, sc, PPSTConfig, PPSTModel, card):
    """512px full-width bf16 stylize with the fused tap, the fused StyledConv
    and the guided filter, batch 1 then batch 8 pairs; its output against the
    unfused path's on the same weights with pinned bf16 noise; then one 1024px
    ``stylize_fused`` call with the option on. Returns K6's launches in the
    512px calls."""
    import dataclasses

    from ppst_tpu_torch.models.generator import make_fixed_noise
    from ppst_tpu_torch.models.ppst import take_rows

    cfg = PPSTConfig(crop_size=512, fused_tap=True, fused_styled_conv=True, dtype="bfloat16")
    model = PPSTModel(cfg, device="cuda", seed=0)
    nonzero_styled_conv_params(model)
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

    reset_launches()
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
    peak = torch.cuda.max_memory_allocated() / 2**30
    k1, k3, k6 = (tap_cuda.fused_tap_1x1.launches, cw.corr_warp_blockwise.launches,
                  sc.styled_conv3x3.launches)
    check_no_backward("stylize with the fused StyledConv")
    read_standalone_launches()
    for out, b in ((out1, 1), (out8, 8)):
        if out.shape != (b, 512, 512, 3) or not torch.isfinite(out.float()).all().item():
            raise AssertionError(f"fused StyledConv stylize batch {b}: bad output")
    # two G passes a call (the batched extraction and the decode), 11 K6 each
    if k6 != 22 * calls or k1 != calls or k3:
        raise AssertionError(f"fused StyledConv stylize launched K6 {k6}, K1 {k1} and K3 {k3} "
                             f"times in {calls} calls ({22 * calls}, {calls} and 0 expected)")

    # against the unfused path: the same weights, pinned bf16 noise
    unfused = PPSTModel(dataclasses.replace(cfg, fused_styled_conv=False), device="cuda", seed=0)
    unfused.load_state_dict(model.state_dict())
    c, s = content8[:2], style8[:2]
    ext = [n.bfloat16() for n in make_fixed_noise(cfg, gen, 4, 512)]
    dec = [n.bfloat16() for n in make_fixed_noise(cfg, gen, 2, 512)]

    def pinned(m):
        bank = m.grid_extract(torch.cat([c, s]), noises=ext)
        return m.grid_pairs({k: take_rows(v, slice(None, 2)) for k, v in bank.items()},
                            {k: take_rows(v, slice(2, None)) for k, v in bank.items()},
                            [0, 1], [0, 1], smooth_target=c, noises=dec).float()

    diff = (pinned(model) - pinned(unfused)).abs()
    mx, mean = diff.max().item(), diff.mean().item()
    print(f"[path] 512px stylize, fused StyledConv vs unfused, pinned bf16 noise: max_abs {mx} "
          f"mean_abs {mean} (tolerance {FUSED_SC_MAX_ABS} / {FUSED_SC_MEAN_ABS})", flush=True)
    if not (mx <= FUSED_SC_MAX_ABS and mean <= FUSED_SC_MEAN_ABS):
        raise AssertionError("the fused StyledConv path disagrees with the unfused path")
    del unfused, model

    # 1024px: the up64 conv2 runs K6 at (2, 1024, 1024, 128) in the extraction
    big = PPSTModel(dataclasses.replace(cfg, crop_size=1024), device="cuda", seed=0)
    c1, s1 = (torch.rand((2, 1024, 1024, 3), generator=gen, device="cuda") * 2 - 1
              ).bfloat16().chunk(2)
    reset_launches()
    t0 = time.perf_counter()
    out = big.stylize_fused(c1, s1, gen, smooth_target=True)
    torch.cuda.synchronize()
    first_ms = (time.perf_counter() - t0) * 1e3
    k6_1024 = sc.styled_conv3x3.launches
    check_no_backward("1024px stylize_fused with the fused StyledConv")
    read_standalone_launches()
    if (out.shape != (1, 1024, 1024, 3) or not torch.isfinite(out.float()).all().item()
            or k6_1024 != 22 or cw.corr_warp_blockwise.launches != 4):
        raise AssertionError(f"1024px stylize_fused with the fused StyledConv: output "
                             f"{tuple(out.shape)}, K6 {k6_1024} launches (22 expected)")
    print(json.dumps({
        "path": "stylize", "crop": 512, "dtype": "bfloat16", "fused_tap": True,
        "fused_styled_conv": True, "smooth_target": True,
        "batch1_latency_ms_p50": statistics.median(lat), "batch1_latency_ms": lat,
        "batch8_pairs_per_s": pairs_s, "batch8_peak_mem_gib": peak, "stylize_calls": calls,
        "styled_conv_launches": k6, "fused_tap_launches": k1,
        "fused_vs_unfused_max_abs": mx, "fused_vs_unfused_mean_abs": mean,
        "stylize_fused_1024_first_call_ms": first_ms, "stylize_fused_1024_styled_conv_launches":
            k6_1024, "card": card}), flush=True)
    return k6


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
        reset_launches()
        t0 = time.perf_counter()
        for _ in range(iters):
            out = pairs(extract(), blockwise)
        torch.cuda.synchronize()
        check_no_backward("grid serving")
        read_standalone_launches()
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


def synthetic_batch(gen, b, crop):
    """Images and masks as ppst_tpu_torch.data.synthetic_dataset makes them
    (smooth random images, blocky one-hot 3-region masks), on the card."""
    low = torch.randn((b, crop // 8, crop // 8, 3), generator=gen, device="cuda")
    img = (low.repeat_interleave(8, 1).repeat_interleave(8, 2) * 0.5).clamp(-1, 1)
    region = torch.randint(0, 3, (b, crop // 16, crop // 16), generator=gen, device="cuda")
    region = region.repeat_interleave(16, 1).repeat_interleave(16, 2)
    return img, F.one_hot(region, 3).float()


def train_phase(tap_cuda, cw, sc, PPSTConfig, PPSTModel, card, fused_styled_conv=False,
                rounds=4, crop=512, batch=4, knobs=None, k1_per_g=2):
    """Full-width bf16 training with the fused tap, at ``crop`` and
    ``batch`` (512px and 4 by default, with the default remat: every G pass
    recomputed in the backward): one warm-up round of D, G and D+R1 steps,
    then ``rounds - 1`` timed rounds; with ``fused_styled_conv`` the
    generator's non-upsampled StyledConvs run K6. ``knobs``: more
    configuration fields (the 1024px mode's); ``k1_per_g``: K1's launches in
    a G step, as the CPU tests count them for that configuration. Returns
    the launches of K2, K6 and K6's backward."""
    from ppst_tpu_torch.train.steps import TrainSteps

    model = PPSTModel(PPSTConfig(crop_size=crop, dtype="bfloat16", fused_tap=True,
                                 fused_styled_conv=fused_styled_conv, **(knobs or {})),
                      device="cuda", seed=0)
    steps = TrainSteps(model)
    gen = torch.Generator(device="cuda").manual_seed(0)
    real, mask = synthetic_batch(gen, batch, crop)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    kinds = {"d": steps.d_step, "g": steps.g_step, "r1": steps.d_step_r1}
    times, counts, losses = {k: [] for k in kinds}, dict.fromkeys(kinds, 0), {}
    reset_launches()
    torch.cuda.reset_peak_memory_stats()
    for _ in range(rounds):
        for kind, step in kinds.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = step(real, mask, gen)
            torch.cuda.synchronize()
            times[kind].append((time.perf_counter() - t0) * 1e3)
            counts[kind] += 1
            losses.update({k: v.item() for k, v in out.items()})
    peak = torch.cuda.max_memory_allocated() / 2**30
    # K2's scratch in a G step, at the feature tap's shape (batch, crop, crop, 128)
    k2_scratch = tap_cuda._bwd_lib().ppst_fused_tap_bwd_scratch_floats(batch, crop * crop) * 4
    k1, k2, k3 = (tap_cuda.fused_tap_1x1.launches, tap_cuda.fused_tap_1x1_bwd.launches,
                  cw.corr_warp_blockwise.launches)
    k6, k6b = sc.styled_conv3x3.launches, sc.styled_conv3x3_bwd.launches
    read_standalone_launches()
    t = {k: statistics.median(v[1:]) for k, v in times.items()}
    img_s = 2 * batch / (t["d"] + t["g"] + (t["r1"] - t["d"]) / 16) * 1e3

    bad = [k for k, v in losses.items() if not np.isfinite(v)]
    if bad:
        raise AssertionError(f"non-finite training losses: {bad}")
    still = [net for net in ("E1", "E2", "G", "D")
             if all(torch.equal(v, before[k]) for k, v in model.state_dict().items()
                    if k.startswith(net + "."))]
    if still:
        raise AssertionError(f"training did not move {still}")
    # feature passes: one in each D step, two in each G step (its forward and
    # the remat recompute of the g_ext pass; three with remat_taps, whose
    # checkpoint of the tap recomputes it once more in the backward)
    want_k1 = counts["d"] + counts["r1"] + k1_per_g * counts["g"]
    if k2 != counts["g"] or k1 != want_k1 or k3:
        raise AssertionError(f"training launched K1 {k1}, K2 {k2}, K3 {k3} times in "
                             f"{counts} steps ({want_k1}, {counts['g']} and 0 expected)")
    # K6: 11 per G pass. A D or D+R1 step makes two passes without grad; a G
    # step three (g_ext, g_mix, g_cyc), each once more in its recompute. K6's
    # backward: 11 for each G pass whose output carries gradient to G's trunk
    # (g_mix and g_cyc; the feature taps read a detached trunk).
    want_k6 = 22 * (counts["d"] + counts["r1"]) + 66 * counts["g"] if fused_styled_conv else 0
    want_k6b = 22 * counts["g"] if fused_styled_conv else 0
    if k6 != want_k6 or k6b != want_k6b:
        raise AssertionError(f"training launched K6 {k6} and K6's backward {k6b} times in "
                             f"{counts} steps ({want_k6} and {want_k6b} expected)")
    print(json.dumps({
        "path": "train", "crop": crop, "batch": batch, "dtype": "bfloat16", "fused_tap": True,
        "fused_styled_conv": fused_styled_conv, "remat_nets": model.cfg.remat_nets,
        "knobs": knobs or {},
        "d_step_ms": t["d"], "g_step_ms": t["g"], "d_r1_step_ms": t["r1"], "step_ms": times,
        "train_img_per_s": img_s, "peak_mem_gib": peak, "k2_scratch_bytes": k2_scratch,
        "losses": losses, "steps": counts,
        "fused_tap_launches": k1, "fused_tap_bwd_launches": k2, "corr_warp_launches": k3,
        "styled_conv_launches": k6, "styled_conv_bwd_launches": k6b, "card": card}), flush=True)
    return k2, k6, k6b


def train_1024_phase(tap_cuda, cw, sc, PPSTConfig, PPSTModel, card):
    """1024px full-width bf16 training at batch 2 in the JAX package's
    1024px mode (TRAIN_1024_KNOBS): a warm-up round and two timed rounds, K1
    three times a G step (the nested checkpoint of the tap, counted on the
    CPU by tests/test_torch_train_blockwise.py), K2 once, K3 and K6 never.
    Then the same reading with ``corr_blockwise`` alone (G passes recomputed,
    nothing else): whether the card needs the other memory knobs, compared
    by the two settings' ``g_step_ms``. Returns K2's launches in the
    first."""
    k2, _, _ = train_phase(tap_cuda, cw, sc, PPSTConfig, PPSTModel, card, rounds=3, crop=1024,
                           batch=2, knobs=TRAIN_1024_KNOBS, k1_per_g=3)
    torch.cuda.empty_cache()
    train_phase(tap_cuda, cw, sc, PPSTConfig, PPSTModel, card, rounds=3, crop=1024, batch=2,
                knobs=dict(corr_blockwise=True), k1_per_g=2)
    return k2


def launch_counts():
    return {k.__name__: k.launches for k in kernel_wrappers()}


def validate_phase(card, steps=VALIDATE_STEPS, lpips_steps=LPIPS_STEPS):
    """The training-validation tools on the card: bf16_validation's float32
    run and its bf16 runs with the fused tap (K1, K2) and with the fused
    StyledConv too (K6, K6's backward), then lpips_ablation's two runs
    (bf16, the fused tap). Each run must be finite and move every network,
    launch the kernels its configuration runs (K1 once a D step and twice a
    G step, K2 once a G step, K6 22 a D step and 66 a G step, its backward
    22 a G step) and no other, and each bf16 run's G-side tail means must
    stay within VALIDATE_G_REL of the float32 run's. Returns each kernel's
    launches over the phase."""
    from ppst_tpu_torch.tools import bf16_validation, lpips_ablation, stream

    arms = [("f32", bf16_validation.run, ("float32",), {}),
            ("bf16 fused_tap", bf16_validation.run, ("bfloat16",), dict(fused_tap=True)),
            ("bf16 fused_tap+fused_styled_conv", bf16_validation.run, ("bfloat16",),
             dict(fused_tap=True, fused_styled_conv=True)),
            ("lpips A (cycwarp 5)", lpips_ablation.run, (5.0,), dict(fused_tap=True)),
            ("lpips B (cycwarp 0)", lpips_ablation.run, (0.0,), dict(fused_tap=True))]
    total, runs, failures = dict.fromkeys(launch_counts(), 0), {}, []
    for name, fn, args, cfg in arms:
        n = lpips_steps if fn is lpips_ablation.run else steps
        seed = lpips_ablation.SEED if fn is lpips_ablation.run else bf16_validation.SEED
        reset_launches()
        t0 = time.perf_counter()
        run = fn(*args, n, VALIDATE_CROP, VALIDATE_BATCH, seed, "cuda", **cfg)
        secs = time.perf_counter() - t0
        counts = launch_counts()
        read_standalone_launches()
        for k, v in counts.items():
            total[k] += v
        torch.cuda.empty_cache()
        runs[name] = run
        fused_tap, fused_sc = cfg.get("fused_tap", False), cfg.get("fused_styled_conv", False)
        want = {"fused_tap_1x1": 3 * n if fused_tap else 0,
                "fused_tap_1x1_bwd": n if fused_tap else 0,
                "styled_conv3x3": 88 * n if fused_sc else 0,
                "styled_conv3x3_bwd": 22 * n if fused_sc else 0}
        if not stream.finite(run.rows):
            failures.append(f"{name}: non-finite losses")
        still = [net for net, d in run.moved.items() if not d > 0]
        if still:
            failures.append(f"{name}: {still} did not move")
        wrong = {k: (counts[k], v) for k, v in want.items() if counts[k] != v}
        wrong.update({k: (v, 0) for k, v in counts.items() if k not in want and v})
        if wrong:
            failures.append(f"{name}: launches (counted, expected) {wrong}")
        record = {"validate": name, "steps": n, "crop": VALIDATE_CROP, "batch": VALIDATE_BATCH,
                  "run": f"{fn.__module__}.run{args}", "config": cfg,
                  "seconds": secs, "img_per_sec": run.img_per_sec,
                  "peak_mem_gib": run.peak_mem_gib, "finite": stream.finite(run.rows),
                  "moved": run.moved, "launches": counts,
                  "tail_means": {k: stream.tail_mean(run.rows, k)
                                 for k in sorted(set().union(*run.rows))}}
        if name.startswith("bf16"):
            summary = bf16_validation.summarize(runs["f32"].rows, run.rows)
            record["rel_to_f32"] = {k: v["rel"] for k, v in summary.items()}
            over = {k: (summary[k]["rel"], VALIDATE_G_REL[k]) for k in bf16_validation.G_SIDE
                    if not summary[k]["rel"] <= VALIDATE_G_REL[k]}
            if over:
                failures.append(f"{name}: G-side tail means off float32's by (gap, bound) {over}")
        print(json.dumps(dict(record, card=card)), flush=True)
    a, b = runs["lpips A (cycwarp 5)"], runs["lpips B (cycwarp 0)"]
    if not (all(r["image_warp_reg"] > 0 for r in a.rows)
            and not any("image_warp_reg" in r for r in b.rows)):
        failures.append("lpips ablation: image_warp_reg not in run A only")
    print(json.dumps({"validate": "lpips_ablation summary",
                      "summary": lpips_ablation.summarize(a.rows, b.rows), "card": card}),
          flush=True)
    if failures:
        raise AssertionError("; ".join(failures))
    return total


def train_reference_check(PPSTConfig, PPSTModel, knobs=None):
    """The narrow float32 model's D-step, R1 and G-step losses and gradients
    on the card against the CPU run of the same code (which the tests hold
    against ppst_tpu), from the same weights and batch; with ``knobs`` (the
    1024px mode's) a tensor of TRAIN_TIE_REACH may instead be held in
    normalized L2."""
    kw = dict(NARROW, netD_scale_capacity=0.125, **(knobs or {}))
    rng = np.random.default_rng(0)
    real = torch.from_numpy(rng.uniform(-1, 1, (2, 64, 64, 3)).astype(np.float32))
    region = np.kron(rng.integers(0, 3, (2, 4, 4)), np.ones((1, 16, 16), np.int64))
    mask = torch.from_numpy(np.stack([region == i for i in range(3)], -1).astype(np.float32))
    runs = {}
    for dev in ("cpu", "cuda"):
        model = PPSTModel(PPSTConfig(**kw), device=dev, seed=0)
        r, m = real.to(dev), mask.to(dev)
        for kind in ("d", "r1", "g"):
            model.zero_grad(set_to_none=True)
            gen = torch.Generator(device=dev).manual_seed(0)
            metrics, nets = {}, ("D",)
            if kind == "d":
                losses = model.discriminator_losses(r, m, gen)
            elif kind == "r1":
                losses = model.r1_loss(r)
            else:
                losses, metrics, _ = model.generator_losses(r, m, gen)
                nets = ("G", "E1", "E2")
            sum(losses.values()).backward(
                inputs=[p for n in nets for p in getattr(model, n).parameters()])
            grads = {k: p.grad.double().cpu() for k, p in model.named_parameters()
                     if p.grad is not None and k.split(".")[0] in nets}
            runs[(dev, kind)] = ({k: v.item() for k, v in dict(losses, **metrics).items()}, grads)
    report = {}
    for kind in ("d", "r1", "g"):
        (lc, gc), (lg, gg) = runs[("cpu", kind)], runs[("cuda", kind)]
        loss_err = max(abs(lg[k] - v) / max(abs(v), 1e-3) for k, v in lc.items())
        scale = max(v.abs().max().item() for v in gc.values())
        total = sum(v.pow(2).sum().item() for v in gc.values()) ** 0.5
        worst_rel, worst_cos, worst_l2, by_l2 = 0.0, 1.0, 0.0, []
        for k, w in gc.items():
            if "noise" in k:  # noise gains: their gradient is the (device-drawn) noise's
                continue
            err = (gg[k] - w).abs().max().item()
            wmax = w.abs().max().item()
            l2 = (gg[k] - w).norm().item() / max(w.norm().item(), 1e-6 * total)
            worst_l2 = max(worst_l2, l2)
            if err > TRAIN_GRAD_RTOL * wmax + TRAIN_GRAD_ATOL * scale:
                if not (knobs and k.startswith(TRAIN_TIE_REACH)
                        and l2 <= TRAIN_BLOCKWISE_GRAD_L2):
                    raise AssertionError(f"{kind} gradient of {k} on the card: {err} (max "
                                         f"{wmax}), normalized L2 {l2}")
                by_l2.append([k, err / max(wmax, 1e-30), l2])
            worst_rel = max(worst_rel, err / max(wmax, 1e-30) if wmax > 1e-3 * scale else 0.0)
            if wmax > 1e-3 * scale:
                cos = (gg[k].flatten() @ w.flatten()).item() / (gg[k].norm() * w.norm()).item()
                worst_cos = min(worst_cos, cos)
        if set(lg) != set(lc) or loss_err > TRAIN_LOSS_RTOL or worst_cos < TRAIN_GRAD_COS:
            raise AssertionError(f"{kind} step on the card disagrees with the CPU run: losses "
                                 f"{loss_err}, gradient cosine {worst_cos}")
        report[kind] = {"loss_max_rel_err": loss_err, "grad_max_rel_err": worst_rel,
                        "grad_max_normalized_l2": worst_l2, "grad_min_cosine": worst_cos,
                        "held_in_l2_instead": by_l2, "losses": sorted(lc)}
    print(json.dumps({"train_reference_crop64_f32_card_vs_cpu": report, "knobs": knobs or {}}),
          flush=True)


def fused_reference_check(PPSTConfig, PPSTModel):
    """The narrow model in bf16 with the fused StyledConv on the card (K6)
    against the same code on the CPU (K6's plain versions, which the tests hold
    against ppst_tpu): the generator's outputs with pinned bf16 noise and
    nonzero noise gains and biases, and one G step's losses and gradients
    (zero noise gains there: the two devices draw different noise). bf16
    rounds at other places on the two devices, so each is read against the
    CPU's float32 run: the card's bf16 distance from it within 1.5x the CPU's
    bf16 distance; the G step's per-network gradient cosine with the CPU's
    bf16 step at least 0.75 and with the float32 step no more than 0.05
    below the CPU bf16 step's. (One bf16 G step at these widths is far from
    float32 on any device: the CPU's bf16 gradients have cosines of 0.78
    (E1) to 0.90 (G) with its float32 ones. Measured on an H100: the card's
    bf16 outputs 2.18%, 1.72%, 1.87% of the RMS from float32 against the
    CPU's 2.18%, 1.71%, 1.88%; gradient cosines with the CPU's bf16 step
    0.83 (E1) to 0.95 (E2), and with the float32 step 0.02-0.06 above the
    CPU bf16 step's.)"""
    from ppst_tpu_torch.models.generator import make_fixed_noise

    # the narrow feature tap has 8 channels, which K1 does not take
    kw = dict(NARROW, netD_scale_capacity=0.125, dtype="bfloat16", fused_styled_conv=True)
    rng = np.random.default_rng(0)
    sp = torch.from_numpy(rng.standard_normal((2, 8, 8, 16)).astype(np.float32))
    gl = [torch.from_numpy(rng.standard_normal((2, 64)).astype(np.float32)) for _ in range(4)]
    noises = make_fixed_noise(PPSTConfig(**kw), torch.Generator().manual_seed(5), 2, 64)
    real = torch.from_numpy(rng.uniform(-1, 1, (2, 64, 64, 3)).astype(np.float32))
    region = np.kron(rng.integers(0, 3, (2, 4, 4)), np.ones((1, 16, 16), np.int64))
    mask = torch.from_numpy(np.stack([region == i for i in range(3)], -1).astype(np.float32))
    runs = {}
    for run, dev, dtype in (("cpu32", "cpu", torch.float32), ("cpu16", "cpu", torch.bfloat16),
                            ("card16", "cuda", torch.bfloat16)):
        model = PPSTModel(PPSTConfig(**kw), device=dev, seed=0)
        nonzero_styled_conv_params(model)
        with torch.inference_mode():
            outs = model.G(sp.to(dev, dtype), [g.to(dev, dtype) for g in gl],
                           extract_features=True, noises=[n.to(dev, dtype) for n in noises])
        model = PPSTModel(PPSTConfig(**kw), device=dev, seed=0)
        nonzero_styled_conv_params(model, gains=False)
        losses, _, _ = model.generator_losses(real.to(dev, dtype), mask.to(dev, dtype),
                                              torch.Generator(device=dev).manual_seed(0))
        sum(losses.values()).backward(
            inputs=[p for n in ("G", "E1", "E2") for p in getattr(model, n).parameters()])
        grads = {k: p.grad.double().cpu().ravel() for k, p in model.named_parameters()
                 if p.grad is not None and k.split(".")[0] in ("G", "E1", "E2")}
        runs[run] = ([o.float().cpu() for o in outs], {k: v.item() for k, v in losses.items()},
                     grads)
    (o32, l32, g32), (o16, l16, g16), (oc, lc, gc) = (runs[k] for k in ("cpu32", "cpu16",
                                                                         "card16"))
    report = {}
    for name, a, b, r in zip(("rgb", "feat", "feat1"), oc, o16, o32):
        rms = r.pow(2).mean().sqrt().item()
        card, cpu = (a - r).abs().mean().item() / rms, (b - r).abs().mean().item() / rms
        report[f"g_{name}_bf16_vs_f32_card_cpu"] = [card, cpu]
        report[f"g_{name}_card_vs_cpu_bf16"] = (a - b).abs().mean().item() / rms
        if not (torch.isfinite(a).all().item() and card <= 1.5 * cpu):
            raise AssertionError(f"the fused generator's {name} on the card is {card} of the RMS "
                                 f"from float32, the CPU's bf16 {cpu}")
    loss_err = max(abs(lc[k] - v) / max(abs(v), 1e-2) for k, v in l16.items())
    if set(lc) != set(l16) or not all(np.isfinite(v) for v in lc.values()) or loss_err > 0.03:
        raise AssertionError(f"the fused bf16 G step's losses on the card: {lc} against {l16}")
    report["g_step_loss_max_rel_err"] = loss_err

    def cos(a, b):
        return (a @ b).item() / (a.norm() * b.norm()).item()

    for net in ("G", "E1", "E2"):
        scale = max(v.abs().max().item() for k, v in g32.items() if k.startswith(net + "."))
        keep = [k for k, v in g32.items() if k.startswith(net + ".") and "noise" not in k
                and v.abs().max().item() > 1e-3 * scale]
        c, b, r = (torch.cat([g[k] for k in keep]) for g in (gc, g16, g32))
        report[f"g_step_{net}_cos_card_cpu_bf16"] = cos(c, b)
        report[f"g_step_{net}_cos_f32_card_cpu"] = [cos(c, r), cos(b, r)]
        if not (torch.isfinite(c).all().item() and cos(c, b) >= 0.75
                and cos(c, r) >= cos(b, r) - 0.05):
            raise AssertionError(f"the fused bf16 G step's {net} gradients on the card: {report}")
    print(json.dumps({"fused_styled_conv_reference_crop64_bf16_card_vs_cpu": report}),
          flush=True)


def train_cli_phase():
    """The training CLI on the card at 512px full width, batch 2, float32
    (the reference's defaults): 4 steps (D, G, D+R1, G), then 4 more after
    --continue_train, then the checkpoint served by the inference CLI."""
    from PIL import Image

    rng = np.random.default_rng(1)
    with tempfile.TemporaryDirectory() as tmp:
        ck = os.path.join(tmp, "ck")
        common = [sys.executable, "-m", "ppst_tpu_torch.train", "--device", "cuda", "--name",
                  "smoke", "--checkpoints_dir", ck, "--dataset_mode", "synthetic",
                  "--crop_size", "512", "--load_size", "512", "--batch_size", "2",
                  "--print_freq", "4", "--R1_once_every", "2", "--nThreads", "4"]
        for extra in (["--total_nimgs", "8"], ["--total_nimgs", "16", "--continue_train", "true"]):
            if "--continue_train" in extra:
                # the resumed run starts at the image count iter.txt recorded
                with open(os.path.join(ck, "smoke", "iter.txt")) as f:
                    resumed_steps = (16 - int(f.read())) // 2
            t0 = time.perf_counter()
            out = subprocess.run(common + extra, cwd=ROOT, check=True, timeout=600,
                                 capture_output=True, text=True).stdout
            print(f"[cli] python -m ppst_tpu_torch.train {' '.join(extra)}: "
                  f"{time.perf_counter() - t0:.1f} s; last lines: "
                  f"{' | '.join(out.strip().splitlines()[-3:])}", flush=True)
        raw = torch.load(os.path.join(ck, "smoke", "latest_checkpoint.pth"), map_location="cpu",
                         weights_only=True)
        with open(os.path.join(ck, "smoke", "loss_log.txt")) as f:
            log = f.read()
        want_d = 2 + (resumed_steps + 1) // 2  # D first, then every other step
        if raw["steps"] != 16 or raw["num_d_iters"] != want_d or "G_styleContmix" not in log:
            raise AssertionError(f"the train CLI's checkpoint reads steps {raw['steps']} and "
                                 f"{raw['num_d_iters']} D steps (16 and {want_d} expected)")
        paths = []
        for name in ("content", "style"):
            p = os.path.join(tmp, f"{name}.png")
            Image.fromarray((rng.random((512, 512, 3)) * 255).astype(np.uint8)).save(p)
            paths.append(p)
        t0 = time.perf_counter()
        subprocess.run(
            [sys.executable, "-m", "ppst_tpu_torch.test", "--device", "cuda", "--name", "ppst",
             "--evaluation_metrics", "simple_swapping", "--checkpoint",
             os.path.join(ck, "smoke", "latest_checkpoint.pth"), "--preprocess", "resize",
             "--load_size", "512", "--crop_size", "512", "--input_structure_image", paths[0],
             "--input_texture_image", paths[1], "--result_dir", os.path.join(tmp, "res")],
            cwd=ROOT, check=True, timeout=600)
        img = np.asarray(Image.open(os.path.join(tmp, "res", "ppst", "results", "simpleswapping",
                                                 "content_style_1.00.png")))
        if img.shape != (512, 512, 3):
            raise AssertionError(f"the served checkpoint gave an image of shape {img.shape}")
        print(f"[cli] python -m ppst_tpu_torch.test --checkpoint served the trained checkpoint "
              f"in {time.perf_counter() - t0:.1f} s", flush=True)


def cli_train_eval_phase(tap_cuda, card):
    """The training CLI in this process, 512px full width, bf16 with the
    fused tap, batch 2, on a generated CelebAMask folder of 8 images of 520 x
    600 (``scale_width_and_crop`` scales them to 512 x 591 and crops): 8
    steps with a snapshot every 4 images and the swap_visualization
    evaluator (2 images) at image 8, then --continue_train from image 8
    (iter.txt) to 16. Checks the snapshots, the grid page and K1's and K2's
    launches; prints the time of each snapshot (and of its PNG write) and
    evaluation, the memory around each evaluation, ``data`` ms/img from
    loss_log.txt and the wait of each training step's ``next()`` beside the
    loader's own cost of one batch. Returns K1's and K2's launches."""
    import signal

    from PIL import Image

    from ppst_tpu_torch.data import create_dataset
    from ppst_tpu_torch.train import cli

    from ppst_tpu_torch.data import ConfigurableDataLoader

    rng = np.random.default_rng(2)
    evals, snapshot_ms, snapshot_png_ms, train_next_ms = [], [], [], []
    group_evaluate, save_snapshot = cli.GroupEvaluator.evaluate, cli.save_snapshot
    save_image = cli.save_image  # the snapshot's PNG write
    loader_next = ConfigurableDataLoader.__next__

    def timed_next(self):
        t0 = time.perf_counter()
        out = loader_next(self)
        if self.phase == "train":
            train_next_ms.append((time.perf_counter() - t0) * 1e3)
        return out

    def timed_png(*args):
        t0 = time.perf_counter()
        save_image(*args)
        snapshot_png_ms.append((time.perf_counter() - t0) * 1e3)

    def timed_snapshot(*args):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        save_snapshot(*args)
        torch.cuda.synchronize()
        snapshot_ms.append((time.perf_counter() - t0) * 1e3)

    def measured_evaluate(self, *args):
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        out = group_evaluate(self, *args)
        torch.cuda.synchronize()
        evals.append({"eval_ms": (time.perf_counter() - t0) * 1e3,
                      "allocated_before_gib": before / 2**30,
                      "peak_during_gib": torch.cuda.max_memory_allocated() / 2**30,
                      "allocated_after_gib": torch.cuda.memory_allocated() / 2**30})
        return out

    with tempfile.TemporaryDirectory() as tmp:
        for sub in ("img", "mask"):
            os.makedirs(os.path.join(tmp, sub))
        for i in range(8):
            Image.fromarray((rng.random((600, 520, 3)) * 255).astype(np.uint8)).save(
                os.path.join(tmp, "img", f"{i}.png"))
            Image.fromarray(rng.integers(0, 3, (600, 520)).astype(np.uint8)).save(
                os.path.join(tmp, "mask", f"{i}.png"))
        run = os.path.join(tmp, "ck", "snap")
        args = ["--device", "cuda", "--name", "snap", "--checkpoints_dir",
                os.path.join(tmp, "ck"), "--dataset_mode", "celebamask", "--dataroot",
                os.path.join(tmp, "img"), "--dataroot2", os.path.join(tmp, "mask"),
                "--crop_size", "512", "--load_size", "512", "--batch_size", "2", "--dtype",
                "bfloat16", "--fused_tap", "true", "--display_freq", "4",
                "--evaluation_metrics", "swap_visualization", "--evaluation_freq", "8",
                "--swap_num_columns", "2", "--swap_num_images", "2", "--total_nimgs", "16",
                "--save_freq", "8", "--print_freq", "2", "--nThreads", "4"]
        handlers = {s: signal.getsignal(s) for s in (signal.SIGTERM, signal.SIGINT)}
        cli.GroupEvaluator.evaluate, cli.save_snapshot = measured_evaluate, timed_snapshot
        cli.save_image = timed_png
        ConfigurableDataLoader.__next__ = timed_next
        launches, secs, peaks = [], [], []
        try:
            for extra in ([], ["--continue_train", "true"]):
                reset_launches()
                torch.cuda.reset_peak_memory_stats()
                t0 = time.perf_counter()
                cli.main(args + extra)
                torch.cuda.synchronize()
                secs.append(time.perf_counter() - t0)
                peaks.append(torch.cuda.max_memory_allocated() / 2**30)
                launches.append((tap_cuda.fused_tap_1x1.launches,
                                 tap_cuda.fused_tap_1x1_bwd.launches))
                for k in kernel_wrappers():
                    if k not in (tap_cuda.fused_tap_1x1, tap_cuda.fused_tap_1x1_bwd) \
                            and k.launches:
                        raise AssertionError(f"the training CLI launched {k.__name__}")
                read_standalone_launches()
        finally:
            cli.GroupEvaluator.evaluate, cli.save_snapshot = group_evaluate, save_snapshot
            cli.save_image = save_image
            ConfigurableDataLoader.__next__ = loader_next
            for s, h in handlers.items():
                signal.signal(s, h)

        # 8 steps from image 0 (D, G, ...), then 4 from image 8 (iter.txt):
        # K1 once a D step and twice a G step (its forward and the remat of
        # the feature pass), once per image of each evaluation (its feature
        # extraction), never in a snapshot (no feature branch); K2 once a G
        # step
        want = [(4 + 2 * 4 + 2, 4), (2 + 2 * 2 + 2, 2)]
        if launches != want:
            raise AssertionError(f"the training CLI launched K1 and K2 {launches} times "
                                 f"({want} expected)")
        raw = torch.load(os.path.join(run, "latest_checkpoint.pth"), map_location="cpu",
                         weights_only=True)
        if raw["steps"] != 16 or raw["num_d_iters"] != 6:
            raise AssertionError(f"the resumed run saved steps {raw['steps']} and "
                                 f"{raw['num_d_iters']} D steps (16 and 6 expected)")
        snaps = sorted(f for f in os.listdir(os.path.join(run, "snapshots"))
                       if f.endswith(".png"))
        shapes = {np.asarray(Image.open(os.path.join(run, "snapshots", f))).shape for f in snaps}
        want_snaps = [f"{i:09d}.png" for i in (0, 4, 8, 12)]
        if snaps != want_snaps or shapes != {(4 * 512, 2 * 512, 3)}:
            raise AssertionError(f"snapshots {snaps} of shapes {shapes}")
        page = os.path.join(run, "snapshots", "test_0k")
        (grid_png,) = os.listdir(os.path.join(page, "images"))
        grid = np.asarray(Image.open(os.path.join(page, "images", grid_png)))
        cells = [grid[r * 512:(r + 1) * 512, c * 512:(c + 1) * 512]
                 for r in range(3) for c in range(3) if (r, c) != (0, 0)]
        if not os.path.exists(os.path.join(page, "index.html")) or grid.shape != (
                1536, 1536, 3) or any(cell.min() == cell.max() for cell in cells):
            raise AssertionError(f"the swap grid is {grid.shape} or has a flat cell")
        with open(os.path.join(run, "loss_log.txt")) as f:
            log_lines = [line for line in f if line.startswith("(iters:")]
        # a run's first line has no section times yet: each EMA leaves out its cold first sample
        data_ms = [float(line.split("data: ")[1].split("ms/img")[0]) for line in log_lines
                   if "data: " in line]
        if len(log_lines) != 12 or "G_styleContmix" not in log_lines[-1]:
            raise AssertionError(f"loss_log.txt has {len(log_lines)} loss lines")

        # the loader alone: a fresh one of the same options; once its queue is
        # full, take every batch it holds ready, then time the next ones, each
        # loaded with nothing else running
        loader = create_dataset(cli.parse(args))
        try:
            t0 = time.perf_counter()
            while not loader._queue.full() and time.perf_counter() - t0 < 60:
                time.sleep(0.01)
            for _ in range(loader.PREFETCH + 1):
                next(loader)
            batch_ms = []
            for _ in range(3):
                t0 = time.perf_counter()
                next(loader)
                batch_ms.append((time.perf_counter() - t0) * 1e3)
        finally:
            loader.close()
    print(json.dumps({
        "path": "cli train snapshots+eval", "crop": 512, "batch": 2, "dtype": "bfloat16",
        "fused_tap": True, "run_s": secs, "peak_mem_gib": peaks, "evaluations": evals,
        "snapshot_ms": snapshot_ms, "snapshot_png_ms": snapshot_png_ms,
        "data_ms_per_img_logged": data_ms,
        "train_next_ms_per_step": train_next_ms,
        "train_next_ms_per_img_p50": statistics.median(train_next_ms) / 2,
        "loader_batch_ms_alone": batch_ms,
        "loader_ms_per_img_alone": statistics.median(batch_ms) / 2,
        "fused_tap_launches": launches,
        "card": card}), flush=True)
    return sum(k1 for k1, _ in launches), sum(k2 for _, k2 in launches)


def pak_grid_phase(tap_cuda, card):
    """The grid evaluator through ``python -m ppst_tpu_torch.test``'s entry
    point, in this process, at 512px, bf16, fused tap: 2 content and 4 style
    PNGs packed by ``python -m ppst_tpu_torch.data.dataset_tools``'s entry
    point and read with ``--dataset_mode lmdb``, then the same folder with
    ``imagefolder``.
    The two pages' PNGs must be identical. Returns K1's launches in both."""
    from PIL import Image

    from ppst_tpu_torch import test as test_cli
    from ppst_tpu_torch.data import dataset_tools

    rng = np.random.default_rng(3)
    with tempfile.TemporaryDirectory() as tmp:
        data = os.path.join(tmp, "grid")
        for sub, n in (("content", 2), ("style", 4)):
            os.makedirs(os.path.join(data, sub))
            for i in range(n):
                Image.fromarray((rng.random((512, 512, 3)) * 255).astype(np.uint8)).save(
                    os.path.join(data, sub, f"{sub}{i}.png"))
        pak = os.path.join(tmp, "grid.pak")
        weights = seed_weights(os.path.join(tmp, "seed.pth"))
        t0 = time.perf_counter()
        dataset_tools.main(["--input", data, "--output", pak])
        pack_s = time.perf_counter() - t0
        pages, launches, secs = {}, [], []
        for mode, root in (("lmdb", pak), ("imagefolder", data)):
            out = os.path.join(tmp, mode)
            reset_launches()
            t0 = time.perf_counter()
            test_cli.main(["--device", "cuda", "--name", "ppst", "--checkpoint", weights,
                           "--dtype", "bfloat16", "--fused_tap", "true",
                           "--preprocess", "resize", "--load_size", "512", "--crop_size", "512",
                           "--evaluation_metrics", "content_style_grid_generation",
                           "--dataset_mode", mode, "--dataroot", root, "--result_dir", out])
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
            launches.append(tap_cuda.fused_tap_1x1.launches)
            for k in kernel_wrappers():
                if k is not tap_cuda.fused_tap_1x1 and k.launches:
                    raise AssertionError(f"the grid CLI launched {k.__name__}")
            read_standalone_launches()
            pages[mode] = os.path.join(out, "ppst", "results", "contentstylegridgeneration",
                                       "test_latest", "images")
        files = sorted(os.listdir(pages["lmdb"]))
        if files != sorted(os.listdir(pages["imagefolder"])) or len(files) != 1 + 4 + 2 * 5:
            raise AssertionError(f"the grid from the pack wrote {files}")
        for f in files:
            a, b = (np.asarray(Image.open(os.path.join(pages[m], f))) for m in pages)
            if a.shape != (512, 512, 3) or not np.array_equal(a, b):
                raise AssertionError(f"{f}: the grid from the pack differs from the folder's")
        # one batched extraction of the 6 images: K1 once a run
        if launches != [1, 1]:
            raise AssertionError(f"the grid CLI launched K1 {launches} times ([1, 1] expected)")
    print(json.dumps({"path": "cli test grid from .pak", "crop": 512, "contents": 2,
                      "styles": 4, "pack_s": pack_s, "run_s": dict(zip(pages, secs)),
                      "pngs_identical": len(files), "fused_tap_launches": launches,
                      "card": card}), flush=True)
    return sum(launches)


def celebamask_tree(root, rng, names, size):
    """``root/img/<name>.png`` of ``size`` (w, h) and a 3-class mask for each,
    ``root/label/<k>.png`` in the images' sorted order. Returns the two
    folders."""
    from PIL import Image

    img, label = os.path.join(root, "img"), os.path.join(root, "label")
    for k, name in enumerate(sorted(names)):
        os.makedirs(os.path.dirname(os.path.join(img, name)), exist_ok=True)
        os.makedirs(label, exist_ok=True)
        Image.fromarray((rng.random(size[::-1] + (3,)) * 255).astype(np.uint8)).save(
            os.path.join(img, f"{name}.png"))
        Image.fromarray(rng.integers(0, 3, size[::-1]).astype(np.uint8)).save(
            os.path.join(label, f"{k}.png"))
    return img, label


def launcher_phase(tap_cuda, card):
    """The reference launcher's two recipes through the port
    (``python -m ppst_tpu_torch.experiments CelebA``), in this process, so
    that K1 and K2 are counted: ``dry``'s lines; the train line with a
    generated CelebAMask tree of 8 pairs of 520 x 600, bf16, the fused tap,
    16 images, a checkpoint every 8 and swap_visualization at image 8
    (``opt.txt``'s default column, ``opt.pkl``, the checkpoints, the grid
    page); then the test line (the grid, ``content_style_1t1_generation``)
    on a tree of 2 contents and 4 styles of 512 x 512 with masks, with no
    ``--checkpoint``: it must find the train run's, and its PNGs must equal,
    bit for bit, those of the same grid from ``--dataset_mode imagefolder``
    with that checkpoint. Prints each run's wall time, the train run's
    img/s and step times, the grid's pairs/s and peak memory. Returns K1's
    and K2's launches."""
    import contextlib
    import io
    import pickle
    import signal

    from PIL import Image

    from ppst_tpu_torch import test as test_cli
    from ppst_tpu_torch.evaluation import GroupEvaluator
    from ppst_tpu_torch.experiments import find_launcher_using_name
    from ppst_tpu_torch.experiments.__main__ import main as experiments_main
    from ppst_tpu_torch.optimizers.ppst_optimizer import PPSTOptimizer
    from ppst_tpu_torch.options import program_args
    from ppst_tpu_torch.train import cli

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        experiments_main(["CelebA", "dry"])
    dry = out.getvalue().splitlines()
    launcher = find_launcher_using_name("CelebA")()
    (train_line,), (test_line,) = launcher.commands(), launcher.test_commands()
    if dry != [train_line] or not train_line.startswith("python -m ppst_tpu_torch.train ") \
            or not test_line.startswith("python -m ppst_tpu_torch.test "):
        raise AssertionError(f"the launcher printed {dry}; test line {test_line}")

    rng = np.random.default_rng(6)
    step_ms, evals = [], []
    train_step, group_evaluate = PPSTOptimizer.train_one_step, GroupEvaluator.evaluate

    def timed_step(self, *args):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses = train_step(self, *args)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        return losses

    def measured_evaluate(self, *args):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        metrics = group_evaluate(self, *args)
        torch.cuda.synchronize()
        evals.append({"eval_ms": (time.perf_counter() - t0) * 1e3,
                      "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30})
        return metrics

    with tempfile.TemporaryDirectory() as tmp:
        img, label = celebamask_tree(os.path.join(tmp, "train"), rng,
                                     [f"{i}" for i in range(8)], (520, 600))
        test_img, test_label = celebamask_tree(
            os.path.join(tmp, "test"), rng,
            [f"content/c{i}" for i in range(2)] + [f"style/s{i}" for i in range(4)], (512, 512))
        ck = os.path.join(tmp, "ck")
        train_argv = program_args(train_line) + [
            "--dataroot", img, "--dataroot2", label, "--checkpoints_dir", ck, "--device", "cuda",
            "--dtype", "bfloat16", "--fused_tap", "true", "--total_nimgs", "16", "--save_freq",
            "8", "--evaluation_freq", "8"]
        handlers = {s: signal.getsignal(s) for s in (signal.SIGTERM, signal.SIGINT)}
        PPSTOptimizer.train_one_step, GroupEvaluator.evaluate = timed_step, measured_evaluate
        secs, launches = {}, {}
        try:
            reset_launches()
            t0 = time.perf_counter()
            cli.main(train_argv)
            torch.cuda.synchronize()
            secs["train"] = time.perf_counter() - t0
            launches["train"] = (tap_cuda.fused_tap_1x1.launches,
                                 tap_cuda.fused_tap_1x1_bwd.launches)
            read_standalone_launches()
            common = program_args(test_line) + [
                "--dataroot", test_img, "--dataroot2", test_label, "--checkpoints_dir", ck,
                "--device", "cuda", "--dtype", "bfloat16", "--fused_tap", "true"]
            for name, extra in (("grid", []), ("grid from the folder", [
                    "--dataset_mode", "imagefolder", "--checkpoint",
                    os.path.join(ck, "CelebAMaskHQ_default", "latest_checkpoint.pth")])):
                reset_launches()
                t0 = time.perf_counter()
                test_cli.main(common + ["--result_dir", os.path.join(tmp, name)] + extra)
                torch.cuda.synchronize()
                secs[name] = time.perf_counter() - t0
                launches[name] = (tap_cuda.fused_tap_1x1.launches,
                                  tap_cuda.fused_tap_1x1_bwd.launches)
                read_standalone_launches()
        finally:
            PPSTOptimizer.train_one_step, GroupEvaluator.evaluate = train_step, group_evaluate
            for s, h in handlers.items():
                signal.signal(s, h)
        for k in kernel_wrappers():
            if k not in (tap_cuda.fused_tap_1x1, tap_cuda.fused_tap_1x1_bwd) and k.launches:
                raise AssertionError(f"the launcher's runs launched {k.__name__}")

        run = os.path.join(ck, "CelebAMaskHQ_default")
        with open(os.path.join(run, "opt.txt")) as f:
            opt_txt = f.read()
        for line in ("dataroot", "preprocess", "total_nimgs", "evaluation_metrics"):
            if not re.search(rf"^ +{line}: .*\t\[default: ", opt_txt, re.M):
                raise AssertionError(f"opt.txt's {line} line has no default column")
        with open(os.path.join(run, "opt.pkl"), "rb") as f:
            opt = vars(pickle.load(f))
        if opt["name"] != "CelebAMaskHQ_default" or opt["dataset_mode"] != "CelebAMask" \
                or opt["checkpoints_dir"] != ck or not opt["continue_train"]:
            raise AssertionError(f"opt.pkl holds {opt}")
        raw = torch.load(os.path.join(run, "latest_checkpoint.pth"), map_location="cpu",
                         weights_only=True)
        if raw["steps"] != 16 or raw["num_d_iters"] != 4:
            raise AssertionError(f"the train run saved steps {raw['steps']} and "
                                 f"{raw['num_d_iters']} D steps (16 and 4 expected)")
        swaps = os.path.join(run, "snapshots", "test_0k")
        swap_pngs = sorted(os.listdir(os.path.join(swaps, "images")))
        if not os.path.exists(os.path.join(swaps, "index.html")) or len(swap_pngs) != 2:
            raise AssertionError(f"swap_visualization wrote {swap_pngs}")
        # 4 D and 4 G steps: K1 once a D step and twice a G step, once for
        # each of the 8 images of swap_visualization's two grids; K2 once a
        # G step. The grid: one batched extraction of the 6 images.
        want = {"train": (4 + 2 * 4 + 8, 4), "grid": (1, 0), "grid from the folder": (1, 0)}
        if launches != want:
            raise AssertionError(f"K1 and K2 launched {launches} times ({want} expected)")
        pages = [os.path.join(tmp, name, "CelebAMaskHQ_default", "test1",
                              "contentstylegridgeneration", "test_latest") for name in
                 ("grid", "grid from the folder")]
        files = sorted(os.listdir(os.path.join(pages[0], "images")))
        if not os.path.exists(os.path.join(pages[0], "index.html")) or len(files) != 1 + 4 + 2 * 5 \
                or files != sorted(os.listdir(os.path.join(pages[1], "images"))):
            raise AssertionError(f"the grid wrote {files}")
        for f in files:
            a, b = (np.asarray(Image.open(os.path.join(p, "images", f))) for p in pages)
            if a.shape != (512, 512, 3) or not np.array_equal(a, b):
                raise AssertionError(f"{f}: the grid from CelebAMask differs from the folder's")
    train_evals, grid_evals = evals[:1], evals[1:]
    print(json.dumps({
        "path": "cli launcher CelebA", "crop": 512, "batch": 2, "dtype": "bfloat16",
        "fused_tap": True, "run_s": secs, "train_step_ms": step_ms,
        "train_img_per_s_wall": 16 / secs["train"],
        "train_img_per_s_steps": 2 * len(step_ms) / sum(step_ms) * 1e3,
        "swap_visualization": train_evals, "grid_pairs": 2 * 4,
        "grid_evaluations": grid_evals,
        "grid_pairs_per_s": [8 / (e["eval_ms"] / 1e3) for e in grid_evals],
        "pngs_identical": len(files), "launches_k1_k2": launches, "card": card}), flush=True)
    return sum(v[0] for v in launches.values()), sum(v[1] for v in launches.values())


def smooth_filter_phase(card):
    """The smoothing filter (no kernel of its own: plain PyTorch) at 512 x
    512, f_radius 15, f_edge 0.1, on the card (TF32 off) against the CPU run
    of the same code, within 1e-3; its time on the card. Then the PIL
    wrapper, as a user calls it (on the card by default), against its CPU
    run within one uint8 step."""
    from PIL import Image

    from ppst_tpu_torch.ops.smooth_filter import smooth_local_affine
    from ppst_tpu_torch.smooth_filter import smooth_filter

    gen = torch.Generator().manual_seed(8)
    stylized, content = (torch.rand((1, 512, 512, 3), generator=gen) for _ in range(2))
    want = smooth_local_affine(stylized, content, f_radius=15, f_edge=0.1)
    s_dev, c_dev = stylized.cuda(), content.cuda()
    got = smooth_local_affine(s_dev, c_dev, f_radius=15, f_edge=0.1)
    err = (got.cpu() - want).abs().max().item()
    if not err <= 1e-3:
        raise AssertionError(f"smooth_local_affine on the card is {err} from the CPU's")
    ms = cuda_ms(lambda: smooth_local_affine(s_dev, c_dev, f_radius=15, f_edge=0.1), reps=5)
    init, content_img = (Image.fromarray((t[0].numpy() * 255).astype(np.uint8))
                         for t in (stylized, content))
    png_card = np.asarray(smooth_filter(init, content_img), np.int16)
    png_cpu = np.asarray(smooth_filter(init, content_img, device="cpu"), np.int16)
    png_err = int(np.abs(png_card - png_cpu).max())
    if png_card.shape != (512, 512, 3) or png_err > 1:
        raise AssertionError(f"smooth_filter on the card: shape {png_card.shape}, "
                             f"{png_err} uint8 steps from the CPU's")
    print(json.dumps({"path": "smooth_filter", "shape": [1, 512, 512, 3], "f_radius": 15,
                      "f_edge": 0.1, "max_abs_err_vs_cpu": err, "ms": ms,
                      "pil_wrapper_uint8_steps_vs_cpu": png_err, "card": card}),
          flush=True)


def remat_save_kernels_phase(tap_cuda, PPSTConfig, PPSTModel, card, crop=512, batch=4):
    """512px full-width bf16 training with the fused tap at batch 4, with
    ``remat`` (every G pass recomputed), ``remat_save_kernels`` off, on, off
    again and on again, each from the same seed weights and batch: a D and a
    G step, then a D and a G step timed, with the peak memory of that pair.
    Held: the first pair's losses are bit-equal across the four (the D step
    and G's forward do not depend on the knob); the first G step's backward
    prepares no kernel again with the knob on and some without it
    (``KernelRecomputeCounter``); and its gradients with the knob on are as
    close to those with it off as two runs of one setting are to each other
    (the card's backward sums with atomics, so two runs are not bitwise
    equal): for each of G, E1 and E2, the normalized L2 distance of all its
    gradients as one vector, on against off, within 4 times the larger of
    off against off again and on against on again (bit-equal where both are
    0). Per tensor the distance says nothing: a bias that an instance norm
    follows has a gradient of rounding noise alone, about sqrt(2) apart
    between any two runs. The second pair follows the first
    pair's updates, where Adam turns last-bit differences into whole steps:
    its losses' largest relative differences are printed, not held. Returns
    K1's and K2's launches."""
    from ppst_tpu_torch.models.ppst import KernelRecomputeCounter
    from ppst_tpu_torch.train.steps import GE_KEYS, TrainSteps

    def grad_distance(a, b):
        """Each network's normalized L2 distance, its gradients as one vector."""
        return {k: (sum((x - y).double().norm() ** 2 for x, y in zip(a[k], b[k]))
                    / sum(y.double().norm() ** 2 for y in b[k])).sqrt().item() for k in b}

    runs, grads, spread = {}, {}, {}
    reset_launches()
    for name, knob in (("off", False), ("on", True), ("off again", False), ("on again", True)):
        model = PPSTModel(PPSTConfig(crop_size=crop, dtype="bfloat16", fused_tap=True,
                                     remat_save_kernels=knob), device="cuda", seed=0)
        steps = TrainSteps(model)
        gen = torch.Generator(device="cuda").manual_seed(0)
        real, mask = synthetic_batch(gen, batch, crop)
        losses, ms = [], {}
        for i, kind in enumerate(("d", "g", "d", "g")):
            if i == 2:
                torch.cuda.reset_peak_memory_stats()
            counter = KernelRecomputeCounter() if i == 1 else contextlib.nullcontext()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with counter:
                out = (steps.d_step if kind == "d" else steps.g_step)(real, mask, gen)
            torch.cuda.synchronize()
            ms[kind] = (time.perf_counter() - t0) * 1e3
            losses.append({k: v.item() for k, v in out.items()})
            if i == 1:
                recomputed = counter.count
                g = {k: [p.grad.float().clone() for p in getattr(model, k).parameters()]
                     for k in GE_KEYS}
                if name.endswith(" again"):
                    first = name.split()[0]
                    spread[first] = grad_distance(g, grads[first])
                else:
                    grads[name] = g
                del g
        runs[name] = {"d_step_ms": ms["d"], "g_step_ms": ms["g"],
                      "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
                      "kernel_ops_recomputed_in_g_backward": recomputed, "losses": losses}
        del model, steps
        torch.cuda.empty_cache()
    k1, k2 = tap_cuda.fused_tap_1x1.launches, tap_cuda.fused_tap_1x1_bwd.launches
    read_standalone_launches()
    on_vs_off = grad_distance(grads["on"], grads["off"])
    del grads
    torch.cuda.empty_cache()
    first = {name: run["losses"][:2] for name, run in runs.items()}
    if any(v != first["off"] for v in first.values()):
        raise AssertionError(f"remat_save_kernels changed the first D and G steps' losses: "
                             f"{first}")
    recomputed = {name: run["kernel_ops_recomputed_in_g_backward"] for name, run in runs.items()}
    if any(n != 0 for name, n in recomputed.items() if name.startswith("on")) or any(
            n == 0 for name, n in recomputed.items() if name.startswith("off")):
        raise AssertionError(f"the G backward prepared kernels again {recomputed} times "
                             "(none with the knob on, some with it off expected)")
    bound = {k: 4 * max(spread["off"][k], spread["on"][k]) for k in GE_KEYS}
    if any(not on_vs_off[k] <= bound[k] for k in GE_KEYS):
        raise AssertionError(f"the first G step's gradients, knob on against off, are "
                             f"{on_vs_off} apart (normalized L2) against {bound} (4 x the "
                             f"larger of off/off again and on/on again, {spread})")
    if (k1, k2) != (4 * 6, 4 * 2):
        raise AssertionError(f"K1 and K2 launched {k1} and {k2} times (24 and 8 expected)")

    def second_pair_rel(a, b):
        return max(abs(x[k] - y[k]) / max(abs(y[k]), 1e-30)
                   for x, y in zip(a["losses"][2:], b["losses"][2:]) for k in y)

    print(json.dumps({"path": "train remat_save_kernels", "crop": crop, "batch": batch,
                      "dtype": "bfloat16", "fused_tap": True,
                      **{name: {k: v for k, v in run.items() if k != "losses"}
                         for name, run in runs.items()},
                      "first_pair_losses_bit_equal": True,
                      "first_g_grads_normalized_l2": {
                          "on_vs_off": on_vs_off, "off_again_vs_off": spread["off"],
                          "on_again_vs_on": spread["on"], "bound": bound},
                      "second_pair_max_rel_diff": {
                          "on_vs_off": second_pair_rel(runs["on"], runs["off"]),
                          "off_again_vs_off": second_pair_rel(runs["off again"], runs["off"]),
                          "on_again_vs_on": second_pair_rel(runs["on again"], runs["on"])},
                      "launches_k1_k2": [k1, k2], "card": card}), flush=True)
    return k1, k2


def loader_ms_per_img(opt):
    """The training loader alone: once its queue is full, take the batches it
    holds ready, then time the next three, each loaded with nothing else
    running; the median in ms per image."""
    from ppst_tpu_torch.data import create_dataset

    loader = create_dataset(opt)
    try:
        t0 = time.perf_counter()
        while not loader._queue.full() and time.perf_counter() - t0 < 60:
            time.sleep(0.01)
        for _ in range(loader.PREFETCH + 1):
            next(loader)
        batch_ms = []
        for _ in range(3):
            t0 = time.perf_counter()
            next(loader)
            batch_ms.append((time.perf_counter() - t0) * 1e3)
    finally:
        loader.close()
    return statistics.median(batch_ms) / opt.batch_size


def torchrun_phase(tap_cuda, card):
    """The training CLI under ``python -m torch.distributed.run --standalone
    --nproc_per_node 1`` on NCCL, 512px full width, bf16, fused tap, batch
    2, on 8 generated CelebAMask pairs of 520 x 600 read through the native
    IO library (``--preprocess resize --native_io true``): 16 steps with a
    checkpoint in the background every 8 images and a profile of steps 10-14;
    K1 and K2 counted in the trace. Then, in this process (K1 and K2 counted
    by their wrappers), the final
    checkpoint loaded, a blocking save and a background save of the same
    state with a training step taken while it is written (the two must be
    equal; memory around it), a G step's wall alone and with a background
    save, the save's copy to the host alone or its ``torch.save`` alone on
    another thread, and ``--continue_train`` from the background
    checkpoint through the CLI's entry point in this process; the loader
    alone with ``--native_io`` true and false. Returns K1's and K2's
    launches (trace and this process)."""
    import signal

    from PIL import Image

    from ppst_tpu_torch.optimizers.ppst_optimizer import PPSTOptimizer
    from ppst_tpu_torch.train import cli
    from ppst_tpu_torch.train.bundle import create_model

    rng = np.random.default_rng(4)
    with tempfile.TemporaryDirectory() as tmp:
        for sub in ("img", "mask"):
            os.makedirs(os.path.join(tmp, sub))
        for i in range(8):
            Image.fromarray((rng.random((600, 520, 3)) * 255).astype(np.uint8)).save(
                os.path.join(tmp, "img", f"{i}.png"))
            Image.fromarray(rng.integers(0, 3, (600, 520)).astype(np.uint8)).save(
                os.path.join(tmp, "mask", f"{i}.png"))
        prof = os.path.join(tmp, "prof")
        args = ["--num_gpus", "1", "--device", "cuda", "--name", "ddp", "--dataset_mode",
                "celebamask", "--dataroot", os.path.join(tmp, "img"), "--dataroot2",
                os.path.join(tmp, "mask"), "--preprocess", "resize", "--load_size", "512",
                "--crop_size", "512", "--native_io", "true", "--batch_size", "2",
                "--dtype", "bfloat16", "--fused_tap", "true", "--save_freq", "8",
                "--print_freq", "2", "--nThreads", "4"]
        torchrun = [sys.executable, "-m", "torch.distributed.run", "--standalone",
                    "--nproc_per_node", "1", "-m", "ppst_tpu_torch.train"]
        ck = os.path.join(tmp, "ck")
        t0 = time.perf_counter()
        run = subprocess.run(torchrun + args + ["--checkpoints_dir", ck, "--total_nimgs", "32",
                                                "--profile_dir", prof],
                             cwd=ROOT, timeout=600, capture_output=True, text=True)
        run_s = time.perf_counter() - t0
        if run.returncode:
            raise AssertionError(f"torchrun failed ({run.returncode}):\n"
                                 f"{run.stdout[-3000:]}\n{run.stderr[-3000:]}")
        lines = run.stdout.splitlines()
        if not any("[parallel] rank 0 of 1 on nccl" in ln for ln in lines):
            raise AssertionError("the torchrun run did not join an NCCL group")
        loop_ms = [float(ln.split(": ")[1].split(" ms")[0]) for ln in lines
                   if ln.startswith("Checkpoint of image")]
        writer_ms = [float(ln.split(" in the background in ")[1].split(" ms")[0])
                     for ln in lines if " in the background in " in ln]
        final_ms = [float(ln.rsplit(" in ", 1)[1].split(" ms")[0]) for ln in lines
                    if ln.startswith("Saved checkpoint at") and "background" not in ln]
        if len(loop_ms) != 4 or len(writer_ms) != 4 or len(final_ms) != 1:
            raise AssertionError(f"saves: {loop_ms} on the loop, {writer_ms} written, "
                                 f"{final_ms} blocking (4, 4 and 1 expected)")
        with open(os.path.join(ck, "ddp", "loss_log.txt")) as f:
            log = [ln for ln in f if ln.startswith("(iters:")]
        losses = [float(tok) for ln in log for tok in ln.split(") ", 1)[1].split()[1::2]]
        if len(log) != 16 or not np.isfinite(losses).all() or "G_styleContmix" not in log[-1]:
            raise AssertionError(f"loss_log.txt: {len(log)} lines, finite "
                                 f"{np.isfinite(losses).all()}")
        with open(os.path.join(prof, "trace_rank0.json")) as f:
            events = json.load(f)["traceEvents"]
        names = [e.get("name", "") for e in events]
        kernels = [n for e, n in zip(events, names) if e.get("cat") == "kernel"]
        steps = sorted({int(n.split("#")[1]) for n in names if n.startswith("ProfilerStep#")})
        if any("moments_kernel" in n for n in kernels):
            raise AssertionError("the trace holds K6 kernels; the run has no fused StyledConv")
        # K1 ends each launch with one apply_kernel (csrc/tap.cu, its first
        # argument a TMA descriptor), K2 starts with one pass_a_kernel; steps
        # 10-14 are D, G, D, G, D: K1 1 + 2 + 1 + 2 + 1, K2 once a G step
        k1_names = {n for n in kernels if "::apply_kernel(CUtensorMap" in n}
        k1_trace = sum(n in k1_names for n in kernels)
        k2_trace = sum("::pass_a_kernel(" in n for n in kernels)
        if steps != [10, 11, 12, 13, 14] or (k1_trace, k2_trace) != (7, 2):
            raise AssertionError(
                f"the trace holds steps {steps}, K1 {k1_trace} and K2 {k2_trace} times "
                f"(steps 10-14, 7 and 2 expected); K1's names {sorted(k1_names)}, kernels "
                f"named apply_kernel {sorted({n for n in kernels if 'apply_kernel' in n})}")

        # a background save and a blocking one of the same state, a step taken
        # while the background one is written
        opt = cli.parse(args + ["--checkpoints_dir", ck, "--continue_train", "true"])
        bundle = create_model(opt)
        optimizer = PPSTOptimizer(opt, bundle)
        from ppst_tpu_torch.data import create_dataset

        loader = create_dataset(opt)
        try:
            data = next(loader)
        finally:
            loader.close()
        reset_launches()
        optimizer.train_one_step(data, 32)  # D, G, D, G from here
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        optimizer.train_one_step(data, 34)
        torch.cuda.synchronize()
        first_g_step_ms = (time.perf_counter() - t0) * 1e3
        step_peak = torch.cuda.max_memory_allocated()  # a G step's
        optimizer.train_one_step(data, 36)
        blocking_dir, background_dir = os.path.join(tmp, "blocking"), os.path.join(tmp, "bg")
        bundle.opt.checkpoints_dir = blocking_dir
        t0 = time.perf_counter()
        bundle.save(38)
        blocking_ms = (time.perf_counter() - t0) * 1e3
        bundle.opt.checkpoints_dir = background_dir
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        bundle.save(38, blocking=False)
        on_loop_ms = (time.perf_counter() - t0) * 1e3
        with_clones = torch.cuda.memory_allocated()
        optimizer.train_one_step(data, 38)  # a G step while the save is written
        torch.cuda.synchronize()
        step_with_save_ms = (time.perf_counter() - t0) * 1e3
        bundle.join_pending_save()
        save_peak = torch.cuda.max_memory_allocated()
        after = torch.cuda.memory_allocated()
        k1_here = tap_cuda.fused_tap_1x1.launches
        k2_here = tap_cuda.fused_tap_1x1_bwd.launches
        read_standalone_launches()
        if (k1_here, k2_here) != (1 + 2 + 1 + 2, 2):
            raise AssertionError(f"4 steps launched K1 {k1_here} and K2 {k2_here} times")
        want = torch.load(os.path.join(blocking_dir, "ddp", "0k_checkpoint.pth"),
                          map_location="cpu", weights_only=True)
        got = torch.load(os.path.join(background_dir, "ddp", "latest_checkpoint.pth"),
                         map_location="cpu", weights_only=True)
        ckpt_bytes = os.path.getsize(os.path.join(blocking_dir, "ddp", "0k_checkpoint.pth"))

        def leaves(tree, prefix=""):
            if isinstance(tree, dict):
                for k, v in tree.items():
                    yield from leaves(v, f"{prefix}/{k}")
            elif isinstance(tree, (list, tuple)):
                for i, v in enumerate(tree):
                    yield from leaves(v, f"{prefix}/{i}")
            else:
                yield prefix, tree

        w_leaves, g_leaves = dict(leaves(want)), dict(leaves(got))
        if w_leaves.keys() != g_leaves.keys():
            raise AssertionError("the background checkpoint holds other entries")
        for k, w in w_leaves.items():
            same = torch.equal(w, g_leaves[k]) if isinstance(w, torch.Tensor) else w == g_leaves[k]
            if not same:
                raise AssertionError(f"the background checkpoint differs at {k}")

        # what a background save costs the loop: a G step's wall alone, and
        # with on another thread the whole save (its clones taken on this
        # thread, inside the wall), the writer's copy to the host alone (into
        # the pinned memory that earlier copies left cached, with that cache
        # emptied first, as in a process's first save, or into pageable
        # memory), or torch.save alone of the same payload already on the host;
        # three rounds, the variants in turns
        from ppst_tpu_torch.train.bundle import _map_tensors

        images, mask = optimizer.prepare_images(data)
        bundle.opt.checkpoints_dir = os.path.join(tmp, "timing")
        clones = _map_tensors(bundle._payload(40), lambda t: t.detach().clone())

        def copy_to_host(pinned=True):
            stream = torch.cuda.Stream()
            with torch.cuda.stream(stream):
                _map_tensors(clones, lambda t: t.to("cpu", non_blocking=pinned))
            stream.synchronize()

        def on_thread(fn):
            def start():
                worker = threading.Thread(target=fn)
                worker.start()
                return worker.join
            return start

        def background_save():
            bundle.save(40, blocking=False)
            return bundle.join_pending_save

        during = {"alone": None, "background_save": background_save,
                  "copy_to_host": on_thread(copy_to_host),
                  "copy_to_host_pageable": on_thread(lambda: copy_to_host(pinned=False)),
                  "torch_save": on_thread(lambda: torch.save(want, os.path.join(tmp, "h.pth")))}
        empty_host_cache = getattr(torch._C, "_host_emptyCache", None)  # not in every build
        if empty_host_cache is not None:
            during["copy_to_host_fresh_pinned"] = on_thread(copy_to_host)
        g_step_ms = {k: [] for k in during}
        done_ms = {k: [] for k in during if during[k]}
        for _ in range(3):
            for name, start in during.items():
                if name == "copy_to_host_fresh_pinned":
                    empty_host_cache()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                join = start() if start else None
                optimizer.train_generator_one_step(images, mask)
                torch.cuda.synchronize()
                g_step_ms[name].append((time.perf_counter() - t0) * 1e3)
                if join:
                    join()
                    done_ms[name].append((time.perf_counter() - t0) * 1e3)
        del clones, bundle, optimizer
        torch.cuda.empty_cache()
        with open(os.path.join(background_dir, "ddp", "iter.txt"), "w") as f:
            f.write("38\n")
        handlers = {sig: signal.getsignal(sig) for sig in (signal.SIGTERM, signal.SIGINT)}
        reset_launches()
        t0 = time.perf_counter()
        try:
            cli.main(args + ["--checkpoints_dir", background_dir, "--continue_train", "true",
                             "--total_nimgs", "42"])
        finally:
            for sig, h in handlers.items():
                signal.signal(sig, h)
        torch.cuda.synchronize()
        resume_s = time.perf_counter() - t0
        k1_resume = tap_cuda.fused_tap_1x1.launches
        k2_resume = tap_cuda.fused_tap_1x1_bwd.launches
        read_standalone_launches()
        if (k1_resume, k2_resume) != (1 + 2, 1):
            raise AssertionError(f"the resumed D and G steps launched K1 {k1_resume} and K2 "
                                 f"{k2_resume} times (3 and 1 expected)")
        raw = torch.load(os.path.join(background_dir, "ddp", "latest_checkpoint.pth"),
                         map_location="cpu", weights_only=True)
        # from image 38 a D and a G step: one D step more than the checkpoint
        # held (a run that did not load it would count 1)
        if raw["steps"] != 42 or raw["num_d_iters"] != got["num_d_iters"] + 1:
            raise AssertionError(f"the resumed run saved image {raw['steps']} after "
                                 f"{raw['num_d_iters']} D steps (42 and "
                                 f"{got['num_d_iters'] + 1} expected)")

        loader_ms = {native: loader_ms_per_img(cli.parse(
            args[:args.index("--native_io")] + ["--native_io", native]
            + args[args.index("--native_io") + 2:] + ["--checkpoints_dir", ck]))
            for native in ("true", "false")}
    gib = 2**30
    print(json.dumps({
        "path": "cli train torchrun native+async+profile", "crop": 512, "batch": 2,
        "dtype": "bfloat16", "fused_tap": True, "world": 1, "backend": "nccl",
        "run_s": run_s, "resume_s": resume_s,
        "background_save_ms_on_loop": loop_ms, "background_save_ms_written": writer_ms,
        "final_blocking_save_ms": final_ms[0],
        "checkpoint_bytes": ckpt_bytes, "blocking_save_ms": blocking_ms,
        "background_save_ms_on_loop_here": on_loop_ms,
        "step_with_background_save_ms": step_with_save_ms,
        "first_g_step_ms": first_g_step_ms, "g_step_ms": g_step_ms,
        "in_flight_done_ms": done_ms,
        "allocated_before_gib": before / gib, "step_peak_gib": step_peak / gib,
        "allocated_with_clones_gib": with_clones / gib,
        "step_with_save_peak_gib": save_peak / gib, "allocated_after_gib": after / gib,
        "loader_ms_per_img_native": loader_ms["true"], "loader_ms_per_img_pil": loader_ms["false"],
        "losses_finite": len(losses), "trace_steps": steps,
        "trace_launches": {"fused_tap_1x1": k1_trace, "fused_tap_1x1_bwd": k2_trace},
        "launches_here": {"fused_tap_1x1": k1_here + k1_resume,
                          "fused_tap_1x1_bwd": k2_here + k2_resume},
        "card": card}), flush=True)
    return k1_trace + k1_here + k1_resume, k2_trace + k2_here + k2_resume


def seed_weights(path, **cfg):
    """The weights a full-width PPSTModel draws from seed 0, saved as a
    checkpoint for the inference CLI's ``--checkpoint`` (it serves no weights
    it does not load)."""
    from ppst_tpu_torch.models.config import PPSTConfig
    from ppst_tpu_torch.models.ppst import PPSTModel

    torch.save(PPSTModel(PPSTConfig(**cfg), device="cpu", seed=0).state_dict(), path)
    return path


def cli_phase():
    """The inference CLI in its own processes on seed weights saved as a
    checkpoint: simple_swapping, again with the fused StyledConv, and the
    grid evaluator on a folder of 2 + 2 512px PNGs."""
    from PIL import Image

    rng = np.random.default_rng(0)
    with tempfile.TemporaryDirectory() as tmp:
        common = ["--device", "cuda", "--name", "ppst", "--dtype", "bfloat16", "--fused_tap",
                  "true", "--preprocess", "resize", "--load_size", "512", "--crop_size", "512",
                  "--checkpoint", seed_weights(os.path.join(tmp, "seed.pth"))]
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
        t0 = time.perf_counter()
        subprocess.run(
            [sys.executable, "-m", "ppst_tpu_torch.test", *common, "--fused_styled_conv", "true",
             "--evaluation_metrics", "simple_swapping", "--input_structure_image", paths[0],
             "--input_texture_image", paths[1], "--result_dir", os.path.join(tmp, "fused")],
            cwd=ROOT, check=True, timeout=600)
        shape = np.asarray(Image.open(os.path.join(
            tmp, "fused", "ppst", "results", "simpleswapping", "content_style_1.00.png"))).shape
        if shape != (512, 512, 3):
            raise AssertionError(f"CLI with --fused_styled_conv wrote an image of shape {shape}")
        print(f"[cli] python -m ppst_tpu_torch.test --fused_styled_conv true wrote {shape} in "
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
    from ppst_tpu_torch.ops import (_nvcc, corr_warp_cuda, fused_act_cuda, styled_conv_cuda,
                                    tap_cuda, upfirdn2d_cuda)

    def build(name):
        t0 = time.perf_counter()
        _nvcc.build(_nvcc.PKG / "csrc" / f"{name}.cu")
        return time.perf_counter() - t0

    names = ("tap", "tap_bwd", "corr_warp", "styled_conv", "styled_conv_bwd", "upfirdn2d",
             "fused_act")
    with ThreadPoolExecutor(len(names)) as pool:
        for name, secs in zip(names, pool.map(build, names)):
            print(f"[build] csrc/{name}.cu built in {secs:.1f} s", flush=True)
    # K1's, K2's, K3's, K6's and K4's registers, shared memory and spills, as
    # ptxas reported them
    for name in ("tap", "tap_bwd", "corr_warp", "styled_conv", "styled_conv_bwd", "upfirdn2d"):
        for line in _nvcc.ptxas_summary(_nvcc.build(_nvcc.PKG / "csrc" / f"{name}.cu")):
            print(f"[build] ptxas {name}.cu {line}", flush=True)
    tap_cuda._lib()
    tap_cuda._bwd_lib()
    corr_warp_cuda._lib()
    styled_conv_cuda._lib()
    styled_conv_cuda._bwd_lib()
    upfirdn2d_cuda._lib()
    fused_act_cuda._lib()


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
    from ppst_tpu_torch.ops import (corr_warp_cuda, fused_act_cuda, styled_conv_cuda, tap_cuda,
                                    upfirdn2d_cuda)

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    bw, flops = card_peaks(torch.cuda.get_device_name(0))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    phase("build", build_phase)
    k1 = phase("kernel fused_tap_1x1", kernel_phase, tap_cuda, bw, flops, card)
    k2 = phase("kernel fused_tap_1x1_bwd", tap_bwd_phase, tap_cuda, bw, flops, card)
    k3 = phase("kernel corr_warp_blockwise", corr_warp_phase, corr_warp_cuda, bw, flops, card)
    k6 = phase("kernel styled_conv3x3", styled_conv_phase, styled_conv_cuda, bw, flops, card)
    k6b = phase("kernel styled_conv3x3_bwd", styled_conv_bwd_phase, styled_conv_cuda, bw, flops,
                card)
    k4 = phase("kernel upfirdn2d", fir_phase, upfirdn2d_cuda, bw, card)
    k5 = phase("kernel fused_leaky_relu", act_phase, fused_act_cuda, bw, card)
    k1_launches = phase("path stylize 512px", path_phase, tap_cuda, corr_warp_cuda,
                        PPSTConfig, PPSTModel, card)
    k3_launches = phase("path stylize_fused 1024px", fused_path_phase, tap_cuda, corr_warp_cuda,
                        PPSTConfig, PPSTModel, card)
    k6_launches = phase("path stylize 512px fused StyledConv", styled_conv_path_phase, tap_cuda,
                        corr_warp_cuda, styled_conv_cuda, PPSTConfig, PPSTModel, card)
    phase("grid", grid_phase, tap_cuda, corr_warp_cuda, PPSTConfig, PPSTModel, card)
    k2_launches, _, _ = phase("train 512px", train_phase, tap_cuda, corr_warp_cuda,
                              styled_conv_cuda, PPSTConfig, PPSTModel, card)
    torch.cuda.empty_cache()
    k1_remat, k2_remat = phase("train 512px remat_save_kernels", remat_save_kernels_phase,
                               tap_cuda, PPSTConfig, PPSTModel, card)
    k1_launches += k1_remat
    k2_launches += k2_remat
    _, _, k6b_launches = phase("train 512px fused StyledConv", train_phase, tap_cuda,
                               corr_warp_cuda, styled_conv_cuda, PPSTConfig, PPSTModel, card,
                               True)
    torch.cuda.empty_cache()
    phase("train 1024px", train_1024_phase, tap_cuda, corr_warp_cuda, styled_conv_cuda,
          PPSTConfig, PPSTModel, card)
    torch.cuda.empty_cache()
    validated = phase("validate", validate_phase, card)
    k1_launches += validated["fused_tap_1x1"]
    k2_launches += validated["fused_tap_1x1_bwd"]
    k6_launches += validated["styled_conv3x3"]
    k6b_launches += validated["styled_conv3x3_bwd"]
    phase("reference", small_reference_check, PPSTConfig, PPSTModel)
    phase("reference train", train_reference_check, PPSTConfig, PPSTModel)
    phase("reference train 1024px knobs", train_reference_check, PPSTConfig, PPSTModel,
          dict(TRAIN_1024_KNOBS, corr_block=16))
    phase("reference fused StyledConv", fused_reference_check, PPSTConfig, PPSTModel)
    phase("smooth_filter", smooth_filter_phase, card)
    phase("cli", cli_phase)
    phase("cli train", train_cli_phase)
    k1_cli, k2_cli = phase("cli train snapshots+eval", cli_train_eval_phase, tap_cuda, card)
    k1_launches += k1_cli
    k2_launches += k2_cli
    k1_launches += phase("cli test grid from .pak", pak_grid_phase, tap_cuda, card)
    k1_run, k2_run = phase("cli train torchrun native+async+profile", torchrun_phase, tap_cuda,
                           card)
    k1_launches += k1_run
    k2_launches += k2_run
    k1_cli, k2_cli = phase("cli launcher CelebA", launcher_phase, tap_cuda, card)
    k1_launches += k1_cli
    k2_launches += k2_cli

    print(json.dumps({"kernels": [
        {"name": "fused_tap_1x1", "route": "cuda", "source": "ppst_tpu_torch/csrc/tap.cu",
         "replaces": "ppst_tpu/ops/tap_pallas.py:135", "launches": k1_launches,
         "max_abs_err": k1["max_abs_err"], "ms": k1["ms"], "plain_ms": k1["plain_ms"],
         "bound_ms": k1["bound_ms"], "bound_by": k1["bound_by"], "library_ms": None},
        {"name": "fused_tap_1x1_bwd", "route": "cuda",
         "source": "ppst_tpu_torch/csrc/tap_bwd.cu",
         "replaces": "ppst_tpu/ops/tap_pallas.py:367", "launches": k2_launches,
         "max_abs_err": k2["max_abs_err"], "ms": k2["ms"], "plain_ms": k2["plain_ms"],
         "bound_ms": k2["bound_ms"], "bound_by": k2["bound_by"], "library_ms": None},
        {"name": "corr_warp_blockwise", "route": "cuda",
         "source": "ppst_tpu_torch/csrc/corr_warp.cu",
         "replaces": "ppst_tpu/ops/corr_pallas.py:72", "launches": k3_launches,
         "max_abs_err": k3["max_abs_err"], "ms": k3["ms"], "plain_ms": k3["plain_ms"],
         "bound_ms": k3["bound_ms"], "bound_by": k3["bound_by"],
         "library_ms": k3["library_ms"]},
        {"name": "styled_conv3x3", "route": "cuda", "source": "ppst_tpu_torch/csrc/styled_conv.cu",
         "replaces": "ppst_tpu/ops/styled_conv_pallas.py:146", "launches": k6_launches,
         "max_abs_err": k6["max_abs_err"], "ms": k6["ms"], "plain_ms": k6["plain_ms"],
         "bound_ms": k6["bound_ms"], "bound_by": k6["bound_by"], "library_ms": None},
        {"name": "styled_conv3x3_bwd", "route": "cuda",
         "source": "ppst_tpu_torch/csrc/styled_conv_bwd.cu",
         "replaces": "ppst_tpu/ops/styled_conv_pallas.py:304", "launches": k6b_launches,
         "max_abs_err": k6b["max_abs_err"], "ms": k6b["ms"], "plain_ms": k6b["plain_ms"],
         "bound_ms": k6b["bound_ms"], "bound_by": k6b["bound_by"], "library_ms": None},
        # K4 and K5 are standalone ops: their launches on the paths (none, no
        # path runs them), and apart from those their kernel phases' calls
        {"name": "upfirdn2d_cuda", "route": "cuda", "source": "ppst_tpu_torch/csrc/upfirdn2d.cu",
         "replaces": "ppst_tpu/ops/upfirdn2d_pallas.py:52",
         "launches": STANDALONE_PATH_LAUNCHES["upfirdn2d_cuda"],
         "check_launches": k4["check_launches"],
         "max_abs_err": k4["max_abs_err"], "ms": k4["ms"], "plain_ms": k4["plain_ms"],
         "bound_ms": k4["bound_ms"], "bound_by": k4["bound_by"],
         "library_ms": k4["library_ms"]},
        {"name": "fused_leaky_relu_cuda", "route": "cuda",
         "source": "ppst_tpu_torch/csrc/fused_act.cu",
         "replaces": "ppst_tpu/ops/fused_act_pallas.py:24",
         "launches": STANDALONE_PATH_LAUNCHES["fused_leaky_relu_cuda"],
         "check_launches": k5["check_launches"],
         "max_abs_err": k5["max_abs_err"], "ms": k5["ms"], "plain_ms": k5["plain_ms"],
         "bound_ms": k5["bound_ms"], "bound_by": k5["bound_by"], "library_ms": None},
    ]}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
