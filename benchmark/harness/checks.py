"""The numbers that decide ``correct``: the program's output against the
plain reference's, each taken where the instructions of the cell say.

Serving: the uint8 images the program returned against the reference's
float32 output put through the same uint8 conversion, in uint8 levels, per
request of the sample; the worst request counts.

Training: each of the first three steps' losses (relative gap of the
step's total), each optimizer's last gradient of its first step (the first
moment of Adam with beta1 = 0 is that gradient) and each parameter's change
over the three steps, compared leaf by leaf as the gap between the two
norms over the larger of the reference leaf's norm and the median leaf's.
"""

from __future__ import annotations

import statistics

import torch

# a leaf whose reference gradient is under this share of the median leaf's
# moves under Adam by round-off alone (a bias before an instance norm): it is
# left out of the parameters' change
NOUGHT_GRADIENT = 1e-3


def to_uint8(images: torch.Tensor) -> torch.Tensor:
    """The program's [-1, 1] -> uint8 conversion (``PPSTModel.to_uint8``)."""
    return ((images.float() + 1.0) * 127.5).clamp(0, 255).to(torch.uint8)


def image_gaps(program_u8: torch.Tensor, reference: torch.Tensor) -> dict:
    """Gaps of one request in uint8 levels: the mean over pixels, the 99.9th
    percentile and the largest."""
    d = (program_u8.float().cpu() - to_uint8(reference).float().cpu()).abs().flatten()
    k = max(1, int(round(0.999 * d.numel())))
    return {"mean_u8": d.mean().item(), "p999_u8": d.kthvalue(k).values.item(),
            "max_u8": d.max().item()}


def worst(per_request: list) -> dict:
    return {k: max(g[k] for g in per_request) for k in per_request[0]}


def loss_gaps(program: list, reference: list) -> dict:
    """The relative gap of each step's total loss, and the largest."""
    program = [step_total(p) for p in program]
    reference = [step_total(r) for r in reference]
    gaps = [abs(p - r) / max(abs(r), 1e-12) for p, r in zip(program, reference)]
    out = {"loss_gap": max(gaps)}
    out.update({f"loss_gap_step{i + 1}": g for i, g in enumerate(gaps)})
    return out


def leaf_gaps(program: dict, reference: dict, keep=None) -> list:
    """Per leaf, |norm_p - norm_r| / max(norm_r, median norm_r), sorted."""
    names = [k for k in reference if keep is None or k in keep]
    median = statistics.median(reference[k] for k in names)
    return sorted(abs(program[k] - reference[k]) / max(reference[k], median, 1e-30)
                  for k in names)


def leaf_stats(name: str, gaps: list) -> dict:
    """The worst leaf's gap, and the 90th-percentile and median leaves'."""
    n = len(gaps)
    return {name: gaps[-1], f"{name}_p90": gaps[int(0.9 * (n - 1))],
            f"{name}_median": gaps[(n - 1) // 2]}


def moving_leaves(reference_grads: dict) -> set:
    """The leaves whose reference gradient is not nought to rounding."""
    median = statistics.median(reference_grads.values())
    return {k for k, v in reference_grads.items() if v >= NOUGHT_GRADIENT * median}


def term_gaps(program: list, reference: list) -> dict:
    """The relative gap of each loss term of each step, as a share of the
    step's total."""
    out = {}
    for i, (p, r) in enumerate(zip(program, reference)):
        total = abs(step_total(r))
        for k in r:
            if k not in ("D_total", "L1_dist"):
                # a term the program did not report reads as 0
                out[f"term_gap_step{i + 1}.{k}"] = (float(abs(p.get(k, 0.0) - r[k]))
                                                    / max(total, 1e-12))
    return out


def step_total(losses: dict) -> float:
    """A step's loss: D_total for D steps, the sum of the losses for a G step
    (``L1_dist`` is a metric, counted in ``G_L1_cyc``)."""
    if "D_total" in losses:
        return float(losses["D_total"])
    return float(sum(v for k, v in losses.items() if k != "L1_dist"))
