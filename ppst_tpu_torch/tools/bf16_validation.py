"""float32 against bf16 training (the port's ``tools/bf16_validation.py``).

Trains the full-width model twice from the same weights (``PPSTModel(...,
seed=0)``, the port's real init) on the same synthetic stream (seed 21):
once in float32 and once with bf16 compute (parameters, Adam's state and the
RSCL queues stay float32 in both; ``dtype`` only switches the compute, as
``train/steps.py`` casts the batch). Each iteration is a D step (with the
lazy R1 penalty every ``R1_once_every`` iterations, from the first) and a G
step on one batch. It reports each loss's tail mean over the last quarter of
the iterations, their relative gap, finiteness, and the steady images per
second of both runs.

    python -m ppst_tpu_torch.tools.bf16_validation [--steps 120] [--crop 256]
        [--batch 2] [--out results/torch_bf16_validation] [--plot-only]
        [--fused_tap] [--fused_styled_conv] [--device cpu]

``--fused_tap`` and ``--fused_styled_conv`` set those ``PPSTConfig`` fields
for the bf16 run (K1/K2 and K6/K6's backward in the loop). The run is on
CUDA unless ``--device cpu``; without a card it raises. The float32 run is
true float32 (TF32 off). Writes ``<out>/curves.json`` (the JAX tool's keys,
plus ``device``, ``bf16_config`` and ``peak_mem_gib``) and, where
matplotlib is installed, ``curves.png``.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

from ppst_tpu_torch.models.config import PPSTConfig
from ppst_tpu_torch.models.ppst import PPSTModel, resolve_device
from ppst_tpu_torch.tools import card
from ppst_tpu_torch.tools.stream import Trajectory, drive, finite
from ppst_tpu_torch.train.steps import TrainSteps

SEED = 21
# the losses of the generator's side; the D-side ones (D_real, D_rec, D_mix,
# D_total, D_R1) sit near 0, where a relative gap says little
G_SIDE = ("G_L1", "G_L1_cyc", "L1_dist", "G_GAN_mix", "G_GAN_rec", "G_styleContmix",
          "G_styleContrec", "Mask_warp", "image_warp_reg")


def run(dtype: str, steps: int, crop: int, batch: int, seed: int, device=None,
        **cfg) -> Trajectory:
    """``steps`` D + G iterations at ``crop`` and ``batch`` in ``dtype``, with
    ``cfg`` as more ``PPSTConfig`` fields."""
    model = PPSTModel(PPSTConfig(crop_size=crop, dtype=dtype, **cfg), device=device, seed=0)
    return drive(TrainSteps(model), steps, batch, crop, seed, "paired", label=dtype)


def summarize(rows_32, rows_16) -> dict:
    """Each loss of the last rows: its tail means over the last quarter of
    the iterations and their relative gap (``tools/bf16_validation.py:128-139``)."""
    keys = sorted(set(rows_32[-1]) | set(rows_16[-1]))
    k_tail = max(1, len(rows_32) // 4)
    summary = {}
    for k in keys:
        a = float(np.mean([r[k] for r in rows_32[-k_tail:] if k in r]))
        b = float(np.mean([r[k] for r in rows_16[-k_tail:] if k in r]))
        summary[k] = {"f32": a, "bf16": b, "rel": abs(a - b) / (abs(a) + 1e-8)}
    return summary


def report(t32: Trajectory, t16: Trajectory, crop: int, batch: int, device: str,
           bf16_cfg: dict) -> dict:
    """curves.json: the JAX tool's keys, plus the card (``device``), the bf16
    run's ``PPSTConfig`` fields and each run's peak memory."""
    return {"crop": crop, "batch": batch,
            "img_per_sec": {"f32": t32.img_per_sec, "bf16": t16.img_per_sec},
            "summary": summarize(t32.rows, t16.rows),
            "finite": {"f32": finite(t32.rows), "bf16": finite(t16.rows)},
            "rows_f32": t32.rows, "rows_bf16": t16.rows,
            "device": device, "bf16_config": bf16_cfg,
            "peak_mem_gib": {"f32": t32.peak_mem_gib, "bf16": t16.peak_mem_gib}}


def plot(out_dir: str) -> None:
    """Overlay the float32 and bf16 trajectories of curves.json -> curves.png."""
    with open(os.path.join(out_dir, "curves.json")) as f:
        data = json.load(f)
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    keys = [k for k in sorted(data["summary"]) if not k.startswith("D_R1")]
    cols = 3
    rows = (len(keys) + cols - 1) // cols
    fig, axes = plt.subplots(rows, cols, figsize=(4 * cols, 2.6 * rows))
    for ax, k in zip(axes.ravel(), keys):
        for rows_key, label, c in (("rows_f32", "f32", "#4477aa"),
                                   ("rows_bf16", "bf16", "#ee6677")):
            ax.plot([r[k] for r in data[rows_key] if k in r], label=label, color=c, lw=1)
        ax.set_title(k, fontsize=9)
        ax.legend(fontsize=7)
    for ax in axes.ravel()[len(keys):]:
        ax.axis("off")
    fig.suptitle(f"f32 vs bf16 training, {data['crop']}px b{data['batch']}")
    fig.tight_layout()
    fig.savefig(os.path.join(out_dir, "curves.png"), dpi=110)
    print(f"wrote {out_dir}/curves.png")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=120)
    ap.add_argument("--crop", type=int, default=256)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--out", default="results/torch_bf16_validation")
    ap.add_argument("--plot-only", action="store_true",
                    help="regenerate curves.png from an existing curves.json")
    ap.add_argument("--fused_tap", action="store_true", help="the bf16 run with K1/K2")
    ap.add_argument("--fused_styled_conv", action="store_true",
                    help="the bf16 run with K6 and its backward")
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    if args.plot_only:
        plot(args.out)
        return 0
    device = resolve_device(args.device)
    name = card(device)
    print(name, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    bf16_cfg = {k: True for k in ("fused_tap", "fused_styled_conv") if getattr(args, k)}

    print("f32 run:")
    t32 = run("float32", args.steps, args.crop, args.batch, SEED, device)
    print(f"bf16 run {bf16_cfg}:")
    t16 = run("bfloat16", args.steps, args.crop, args.batch, SEED, device, **bf16_cfg)

    data = report(t32, t16, args.crop, args.batch, name, bf16_cfg)
    print(f"{'loss':18s} {'f32 tail':>10s} {'bf16 tail':>10s} {'rel.diff':>9s}")
    for k, v in data["summary"].items():
        print(f"{k:18s} {v['f32']:10.4f} {v['bf16']:10.4f} {v['rel']:9.3f}")
    print(f"finite: f32={data['finite']['f32']} bf16={data['finite']['bf16']}")
    print(f"moved: f32 {t32.moved} bf16 {t16.moved}")
    print(f"steady img/s @{args.crop}px b{args.batch}: "
          f"f32 {t32.img_per_sec:.2f}  bf16 {t16.img_per_sec:.2f}  ({name})")
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, "curves.json"), "w") as f:
        json.dump(data, f, indent=1)
    print(f"wrote {args.out}/curves.json")
    try:
        plot(args.out)
    except ImportError as e:  # matplotlib is optional
        print(f"plot skipped: {e}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
