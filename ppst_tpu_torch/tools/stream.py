"""The validation tools' synthetic stream and training loops (the port's copy
of what ``tools/bf16_validation.py``, ``tools/lpips_ablation.py`` and
``tools/loss_curve_parity.py`` of the JAX package share).

``make_batch`` draws a batch in the numpy order of those tools, so that the
two packages are fed the same batches from one seed. ``drive`` runs the
port's ``train.steps.TrainSteps`` over the stream in one of their two
schedules:

* ``"paired"`` (bf16_validation, lpips_ablation): one batch an iteration, a
  D step on it (with the lazy R1 penalty when ``i % R1_once_every == 0``)
  then a G step on the same batch; a row holds both steps' losses;
* ``"alternate"`` (loss_curve_parity): one batch a step through the
  training loop's own ``optimizers.PPSTOptimizer.train_one_step``, the
  reference's optimizer: D on even steps and G on odd ones, R1 at every
  ``R1_once_every``-th D step; a row holds one step's losses and its
  ``"step"``.

The noise comes from one explicit ``torch.Generator`` seeded from the
stream's seed. ``ema_series`` and ``tail_mean`` are the JAX tools'
summaries.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

from ppst_tpu_torch.optimizers.ppst_optimizer import PPSTOptimizer

NETS = ("E1", "E2", "G", "D")
# iterations left out of the timing (the first calls' allocations and
# cuDNN's algorithm search), as the JAX tool leaves out its compiles
WARMUP = 5


def make_batch(rng: np.random.Generator, batch: int, crop: int):
    """Images ``N(0, 0.4^2)`` clipped to [-1, 1] and one-hot masks of 3
    regions in 16-pixel blocks, NHWC float32, drawn from ``rng`` in the JAX
    tools' order (``tools/bf16_validation.py:52-60``)."""
    real = (rng.standard_normal((batch, crop, crop, 3)).astype(np.float32) * 0.4).clip(-1, 1)
    region = rng.integers(0, 3, (batch, crop // 16, crop // 16))
    region = np.kron(region, np.ones((1, 16, 16), np.int64))
    mask = np.stack([(region == k) for k in range(3)], -1).astype(np.float32)
    return real, mask


@dataclass
class Trajectory:
    rows: List[Dict[str, float]]
    # 2 x batch images over the median D + G iteration time after WARMUP
    # ("paired" only; nan where too few iterations were timed)
    img_per_sec: float = float("nan")
    # each network's normalized L2 distance between its first and last weights
    moved: Dict[str, float] = field(default_factory=dict)
    # the device's peak allocated memory during the run (None on the CPU)
    peak_mem_gib: Optional[float] = None


def _floats(*loss_dicts) -> Dict[str, float]:
    """The steps' losses as floats, fetched from the device in one transfer."""
    merged = {k: v for d in loss_dicts for k, v in d.items()}
    keys = list(merged)
    values = torch.stack([merged[k].float().reshape(()) for k in keys]).tolist()
    return dict(zip(keys, values))


def _net_weights(model):
    return {net: [p.detach().clone() for p in getattr(model, net).parameters()] for net in NETS}


def _moved(model, before) -> Dict[str, float]:
    out = {}
    for net, old in before.items():
        new = list(getattr(model, net).parameters())
        diff = sum(float((p.detach().double() - o.double()).pow(2).sum()) for p, o in zip(new, old))
        norm = sum(float(o.double().pow(2).sum()) for o in old)
        out[net] = (diff / max(norm, 1e-30)) ** 0.5
    return out


class _Bundle:
    """What ``PPSTOptimizer`` reads of a ``train.bundle.ModelBundle``."""

    def __init__(self, steps, generator):
        self.model, self.cfg, self.optimizers = steps.model, steps.cfg, steps.opts
        self.device, self.generator = steps.model.device, generator


def drive(steps, n: int, batch: int, crop: int, seed: int, schedule: str = "paired",
          log_every: int = 25, label: str = "") -> Trajectory:
    """``n`` iterations (``"paired"``) or steps (``"alternate"``) of
    ``steps`` (a ``TrainSteps``) on the stream of ``seed``."""
    if schedule not in ("paired", "alternate"):
        raise ValueError(f"unknown schedule {schedule!r}")
    model = steps.model
    device = model.device
    r1_every = steps.cfg.R1_once_every
    rng = np.random.default_rng(seed)
    gen = torch.Generator(device=device).manual_seed(seed)
    cuda = device.type == "cuda"
    before = _net_weights(model)
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    optimizer = PPSTOptimizer(None, _Bundle(steps, gen)) if schedule == "alternate" else None
    rows, times = [], []
    for i in range(n):
        real, mask = (torch.from_numpy(v).to(device) for v in make_batch(rng, batch, crop))
        t0 = time.perf_counter()
        if schedule == "paired":
            d_step = steps.d_step_r1 if i % r1_every == 0 else steps.d_step
            row = _floats(d_step(real, mask, gen), steps.g_step(real, mask, gen))
            if i >= WARMUP:
                times.append(time.perf_counter() - t0)
        else:
            losses = optimizer.train_one_step({"real_A": real, "mask_A": mask}, i)
            row = dict(step=i, **{k: float(v) for k, v in losses.items()})
        rows.append(row)
        if log_every and i % log_every == 0:
            print(f"  [{label}] step {i}: G_L1={row.get('G_L1', -1):.3f} "
                  f"D_real={row.get('D_real', -1):.3f}", flush=True)
    img_s = 2 * batch / float(np.median(times)) if times else float("nan")
    peak = torch.cuda.max_memory_allocated(device) / 2**30 if cuda else None
    return Trajectory(rows, img_s, _moved(model, before), peak)


def finite(rows) -> bool:
    return all(np.isfinite(list(r.values())).all() for r in rows)


def tail_mean(rows, key, frac=0.25):
    """The mean of ``key`` over the last ``frac`` of the rows that hold it
    (``tools/lpips_ablation.py:89-94``); None where no row holds it."""
    vals = [r[key] for r in rows if key in r]
    if not vals:
        return None
    k = max(1, int(len(vals) * frac))
    return float(np.mean(vals[-k:]))


def ema_series(rows, key, decay=0.9):
    """The exponential moving average of ``key`` over the rows that hold it
    (``tools/loss_curve_parity.py:218-225``)."""
    out, acc = [], None
    for r in rows:
        if key in r:
            acc = r[key] if acc is None else decay * acc + (1 - decay) * r[key]
            out.append(acc)
    return np.asarray(out)
