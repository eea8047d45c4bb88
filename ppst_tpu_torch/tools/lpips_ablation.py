"""The cycle-warp LPIPS term on and off (the port's ``tools/lpips_ablation.py``).

The reference gates its cycle-warp regularizer on a pretrained AlexNet LPIPS
(reference models/ppst_model.py:48,176-179). The port, as ``ppst_tpu``,
ships a seeded random-weight AlexNet backbone (``ops/lpips.py``). This
ablation trains the same short bf16 run twice from one init on one stream
(seed 11):

  A) the random-backbone LPIPS cycle warp (``lambda_Cycwarp`` 5, the default)
  B) the term off (``lambda_Cycwarp`` 0)

and compares their loss trajectories by tail means: the term carries a
signal (nonzero, finite), and the rest of the dynamics does not depend on it.

    python -m ppst_tpu_torch.tools.lpips_ablation [--steps 150] [--crop 256]
        [--batch 2] [--out results/torch_lpips_ablation] [--device cpu]

On CUDA unless ``--device cpu``; without a card it raises. Writes
``<out>/ablation.json`` (the JAX tool's keys, plus ``device``) and prints the
summary table.
"""

from __future__ import annotations

import argparse
import json
import os

from ppst_tpu_torch.models.config import PPSTConfig
from ppst_tpu_torch.models.ppst import PPSTModel, resolve_device
from ppst_tpu_torch.tools import card
from ppst_tpu_torch.tools.stream import Trajectory, drive, finite, tail_mean
from ppst_tpu_torch.train.steps import TrainSteps

SEED = 11
KEYS = ("D_real", "D_rec", "D_mix", "G_L1", "G_L1_cyc", "Mask_warp", "image_warp_reg",
        "G_GAN_mix", "G_GAN_rec")


def run(lambda_cycwarp: float, steps: int, crop: int, batch: int, seed: int, device=None,
        **cfg) -> Trajectory:
    """``steps`` bf16 D + G iterations with ``lambda_Cycwarp`` set, and
    ``cfg`` as more ``PPSTConfig`` fields."""
    cfg = {"dtype": "bfloat16", **cfg}
    model = PPSTModel(PPSTConfig(crop_size=crop, lambda_Cycwarp=lambda_cycwarp, **cfg),
                      device=device, seed=0)
    return drive(TrainSteps(model), steps, batch, crop, seed, "paired",
                 label=f"cycwarp={lambda_cycwarp}")


def summarize(rows_a, rows_b) -> dict:
    """Each of KEYS's tail means in both runs (None where a run has no such loss)."""
    return {k: {"cycwarp5": tail_mean(rows_a, k), "cycwarp0": tail_mean(rows_b, k)} for k in KEYS}


def report(a: Trajectory, b: Trajectory, steps: int, crop: int, batch: int,
           device: str) -> dict:
    """ablation.json: the JAX tool's keys, plus the card (``device``)."""
    return {"steps": steps, "crop": crop, "batch": batch, "summary": summarize(a.rows, b.rows),
            "finite": {"A": finite(a.rows), "B": finite(b.rows)},
            "rows_a": a.rows, "rows_b": b.rows, "device": device}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=150)
    ap.add_argument("--crop", type=int, default=256)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--out", default="results/torch_lpips_ablation")
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    name = card(device)
    print(name, flush=True)

    print("run A: random-backbone LPIPS cycle-warp (lambda=5)")
    a = run(5.0, args.steps, args.crop, args.batch, SEED, device)
    print("run B: lambda_Cycwarp=0")
    b = run(0.0, args.steps, args.crop, args.batch, SEED, device)

    data = report(a, b, args.steps, args.crop, args.batch, name)
    nan = float("nan")
    print(f"{'loss':18s} {'A tail-mean':>12s} {'B tail-mean':>12s}")
    for k, v in data["summary"].items():
        print(f"{k:18s} {v['cycwarp5'] if v['cycwarp5'] is not None else nan:12.4f} "
              f"{v['cycwarp0'] if v['cycwarp0'] is not None else nan:12.4f}")
    print(f"finite: A={data['finite']['A']} B={data['finite']['B']}")
    print(f"steady img/s @{args.crop}px b{args.batch}: A {a.img_per_sec:.2f}  "
          f"B {b.img_per_sec:.2f}  ({name})")
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, "ablation.json"), "w") as f:
        json.dump(data, f, indent=1)
    print(f"wrote {args.out}/ablation.json")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
