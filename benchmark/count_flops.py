"""The FLOPs behind ``mfu.*``: each kind of step or request of a cell,
counted by ``torch.utils.flop_counter.FlopCounterMode`` over the plain
reference at the cell's shapes, float32, with no recompute (remat off), on
the meta device (nothing is computed).

    python benchmark/count_flops.py --workload CELL

prints the counts as the cell's ``flops`` (``workloads/<cell>.json`` keeps
them with this command and its date). The counter sees convolutions and
matrix products, forward and backward, and no elementwise work. A
serving request counts its entry once per call; a training step its
losses' forward and the backward its optimizer steps need.
"""

import argparse
import dataclasses
import datetime
import json
import os
import sys

import torch
from torch.utils.flop_counter import FlopCounterMode

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from harness import spec  # noqa: E402
from reference.config import PPSTConfig  # noqa: E402
from reference.model import PPSTModel  # noqa: E402


def reference_config(cell_config: dict) -> PPSTConfig:
    names = {f.name for f in dataclasses.fields(PPSTConfig)}
    cfg = PPSTConfig(**{k: v for k, v in cell_config.items() if k in names})
    return dataclasses.replace(cfg, dtype="float32", remat=False)


class _Global:
    """FlopCounterMode's module tracker, reduced to the one total: the
    tracker's backward hooks refuse ``autograd.grad`` on a leaf, which R1
    takes."""

    parents = {"Global"}

    def __enter__(self):
        return self

    def __exit__(self, *args):
        return False


def _count(fn) -> int:
    counter = FlopCounterMode(display=False)
    counter.mod_tracker = _Global()
    with counter, torch.device("meta"):
        fn()
    return int(counter.get_total_flops())


def train_flops(cfg: PPSTConfig, batch: int, dev="meta") -> dict:
    with torch.device(dev):
        model = PPSTModel(cfg)
    model.to_device(dev)
    crop = cfg.crop_size
    real = torch.zeros((batch, crop, crop, 3), device=dev)
    mask = torch.zeros((batch, crop, crop, 3), device=dev)
    d_params = list(model.D.parameters())
    ge_params = [p for k in ("G", "E1", "E2") for p in getattr(model, k).parameters()]
    noise = {"generator": None}

    def d_step():
        losses = model.discriminator_losses(real, mask, **noise)
        torch.autograd.grad(sum(losses.values()), d_params, allow_unused=True)

    def r1():
        loss = sum(model.r1_loss(real).values())
        torch.autograd.grad(loss, d_params, allow_unused=True)

    def g_step():
        losses, _, _ = model.generator_losses(real, mask, **noise)
        torch.autograd.grad(sum(losses.values()), ge_params, allow_unused=True)

    d, r, g = _count(d_step), _count(r1), _count(g_step)
    return {"D": d, "D+R1": d + r, "G": g}


def serve_flops(cfg: PPSTConfig, entry: str, batch: int, dev="meta") -> dict:
    with torch.device(dev):
        model = PPSTModel(cfg)
    model.to_device(dev)
    crop = cfg.crop_size
    x = torch.zeros((batch, crop, crop, 3), device=dev)
    gen = torch.Generator(device=dev) if dev != "meta" else None
    return {"request": _count(lambda: getattr(model, entry)(
        x, x, gen, torch.float32, smooth_target=True))}


def count(cell) -> dict:
    cfg = reference_config(cell.config)
    tr = cell.traffic
    if tr["driver"] == "train":
        return train_flops(cfg, tr["batch"])
    return serve_flops(cfg, tr["entry"], tr["batch"])


def main():
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    args = p.parse_args()
    counts = count(spec.cell(args.workload))
    today = datetime.date.today().isoformat()
    out = {k: {"flop": v, "command": f"python benchmark/count_flops.py --workload {args.workload}",
               "date": today} for k, v in counts.items()}
    print(json.dumps(out, indent=1))


if __name__ == "__main__":
    main()
