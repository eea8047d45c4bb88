"""Training-trajectory parity, the port's side (``tools/loss_curve_parity.py``).

Runs N alternating D/G steps of the port from given weights on the synthetic
stream of ``--seed`` (one batch a step, drawn as the JAX tool draws it) with
the reference's optimizer semantics: four Adams, D's at ``lr * c`` and
``betas ** c``, the lazy R1 penalty (times ``R1_once_every``) as a second D
update at every ``R1_once_every``-th D step, D first (reference
optimizers/ppst_optimizer.py:36-49,65-130). It writes the port's rows as
JSON, each with its ``step``, in the layout of the JAX tool's
``reference.json`` and ``ppst_tpu.json``, and compares two such files by
the JAX tool's summary: each loss's exponential moving average (decay 0.9)
on both sides, its first and last values and the largest and mean absolute
gap between the two.

The configuration is the JAX tool's stage 1 by default: ``training_stage``
1, ``lambda_Cycwarp`` 0 (the reference's LPIPS needs weights that cannot be
downloaded), ``lambda_StyleCon`` 0 (the reference's stage 1 reads an
undefined ``gl_w`` there) and ``netG_use_noise`` off (noise streams cannot
match across frameworks). The other side of the JAX tool is the reference
PyTorch repo; the port's is ``ppst_tpu``, which ``tests/test_torch_trajectory.py``
runs beside this loop at stage 2.

    python -m ppst_tpu_torch.tools.loss_curve_parity [--steps 120] [--seed 11]
        [--crop 256] [--batch 2] [--init WEIGHTS] [--against ROWS.json]
        [--out results/torch_loss_parity] [--device cpu]
    python -m ppst_tpu_torch.tools.loss_curve_parity --compare A.json B.json

``--init`` takes a reference-keyed state dict (``.pth``) or a JAX package
checkpoint (``.msgpack``); without it the weights are ``PPSTModel``'s seed 0.
``--against`` compares the run with another side's rows and writes
``<out>/summary.json``. On CUDA unless ``--device cpu``; without a card it
raises.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np

from ppst_tpu_torch.models.config import PPSTConfig
from ppst_tpu_torch.models.ppst import PPSTModel, resolve_device
from ppst_tpu_torch.tools import card
from ppst_tpu_torch.tools.stream import Trajectory, drive, ema_series
from ppst_tpu_torch.train.steps import TrainSteps

STAGE1 = dict(training_stage=1, lambda_Cycwarp=0.0, lambda_StyleCon=0.0, netG_use_noise=False)
KEYS = ("D_real", "D_rec", "G_L1", "G_GAN_rec", "D_R1")


def run(steps: int, seed: int, crop: int = 256, batch: int = 2, init=None, device=None,
        **cfg) -> Trajectory:
    """``steps`` alternating D/G steps from ``init`` (or seed-0 weights),
    with ``cfg`` over STAGE1 as more ``PPSTConfig`` fields."""
    model = PPSTModel(PPSTConfig(crop_size=crop, **{**STAGE1, **cfg}), device=device, seed=0)
    if init:
        model.load_reference_checkpoint(init)
    return drive(TrainSteps(model), steps, batch, crop, seed, "alternate", log_every=10,
                 label="port")


def compare(ref_rows, port_rows) -> dict:
    """The JAX tool's summary (``tools/loss_curve_parity.py:262-279``) of two
    trajectories, unrounded, for each of KEYS both hold."""
    summary = {}
    for k in KEYS:
        a, b = ema_series(ref_rows, k), ema_series(port_rows, k)
        n = min(len(a), len(b))
        if n == 0:
            continue
        a, b = a[:n], b[:n]
        summary[k] = {"ref_first": float(a[0]), "ref_last": float(a[-1]),
                      "port_first": float(b[0]), "port_last": float(b[-1]),
                      "max_abs_ema_gap": float(np.abs(a - b).max()),
                      "mean_abs_ema_gap": float(np.abs(a - b).mean())}
    return summary


def _load(path):
    with open(path) as f:
        return json.load(f)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=120)
    ap.add_argument("--seed", type=int, default=11)
    ap.add_argument("--crop", type=int, default=256)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--init", default=None, help="weights: a .pth state dict or a .msgpack")
    ap.add_argument("--against", default=None, help="the other side's rows (JSON)")
    ap.add_argument("--compare", nargs=2, metavar=("A", "B"), default=None,
                    help="only compare two rows files")
    ap.add_argument("--out", default="results/torch_loss_parity")
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    if args.compare:
        print(json.dumps(compare(*(_load(p) for p in args.compare)), indent=1))
        return 0
    device = resolve_device(args.device)
    print(card(device), flush=True)
    rows = run(args.steps, args.seed, args.crop, args.batch, args.init, device).rows
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, "port.json"), "w") as f:
        json.dump(rows, f)
    print(f"wrote {args.out}/port.json")
    if args.against:
        summary = compare(_load(args.against), rows)
        with open(os.path.join(args.out, "summary.json"), "w") as f:
            json.dump(summary, f, indent=1)
        print(json.dumps(summary, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
