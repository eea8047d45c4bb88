"""Training traffic: ``PPSTOptimizer.train_one_step`` over a ``ModelBundle``,
fed host batches as a loader feeds them.

Set-up builds the bundle, loads the benchmark's weights, LPIPS network and
RSCL queues and seeds the training noise. The loop starts one D step before
its lazy R1 (its D-step counter at ``R1_once_every - 1``), so that its own
cadence makes the first step a D+R1 step. Set-up then drives the first
``check_steps`` steps (D+R1, G, D) through the window's own call on the
first batches and reads what the comparison needs: each step's losses, D's
last gradient of step 1 (R1's, through the double backward), G's, E1's and
E2's of step 2 and D's of step 3 (Adam's first moments: beta1 is 0), and every
parameter's change after step 3. Then ``warmup_steps`` more steps. The
window takes every step that starts before ``--seconds`` have passed, one
batch a step, each batch its own rows (the traffic's pool), R1 on every
``R1_once_every``-th D step where the loop's cadence puts it. After it: the
memory peak, then the program is freed and the reference follows the first
three steps from the same weights, batches and noise.
"""

from __future__ import annotations

import time
from types import SimpleNamespace

import numpy as np
import torch

from harness import checks, inputs, program, sites, trace, weights
from harness.run_record import Unit, derive


def _leaf_norms(named, tensors) -> dict:
    return {k: torch.linalg.vector_norm(t.float()).item() for k, t in zip(named, tensors)}


def first_moments(model, opts, keys) -> dict:
    """{parameter name: norm of Adam's first moment} of the optimizers ``keys``."""
    out = {}
    for key in keys:
        net = getattr(model, key)
        for name, p in net.named_parameters():
            # a leaf its optimizer never stepped has no moment: its gradient reads 0
            m = opts[key].state.get(p, {}).get("exp_avg")
            out[f"{key}.{name}"] = torch.linalg.vector_norm(m).item() if m is not None else 0.0
    return out


def changes(model, start: dict) -> dict:
    """{parameter name: norm of its change from ``start``}, a leaf at a time."""
    return {k: torch.linalg.vector_norm(p.detach() - start[k].to(p.device)).item()
            for k, p in model.named_parameters()}


def kind_of(trainer, r1_every: int) -> str:
    if trainer.train_mode_counter == 1:
        return "G"
    return "D+R1" if (trainer.discriminator_iter_counter + 1) % r1_every == 0 else "D"


def run(run, started: float):
    from ppst_tpu_torch.optimizers.ppst_optimizer import PPSTOptimizer
    from ppst_tpu_torch.train.bundle import ModelBundle

    tr, dev = run.cell.traffic, run.device
    pcfg, rcfg = program.configs(run.cell.config)
    batch, n_check = tr["batch"], tr["check_steps"]
    pool = inputs.host_batches(derive(run.seed, "inputs"), tr["pool_batches"], batch,
                               pcfg.crop_size, dev)
    noise_seed = derive(run.seed, "noise")
    program.free(dev)
    program.reset_peak(dev)

    w = weights.make(rcfg, derive(run.seed, "weights"), dev)
    opt = SimpleNamespace(device=dev.type, seed=0, isTrain=True)
    bundle = ModelBundle(opt, pcfg)
    program.load(bundle.model, w)
    # the start of the parameters' change, kept on the host so that the
    # program's memory peak holds no copy of the benchmark's
    start = {k: v.cpu() for k, v in w["model"].items()}
    del w
    bundle.generator.manual_seed(noise_seed)
    trainer = PPSTOptimizer(opt, bundle)
    trainer.discriminator_iter_counter = pcfg.R1_once_every - 1
    undo = sites.install(sites.kernels_of(run.cell)) if run.traced else []

    model, opts = bundle.model, bundle.optimizers
    losses, got, kinds, step = [], {}, [], 0
    for _ in range(n_check):
        kinds.append(kind_of(trainer, pcfg.R1_once_every))
        losses.append(dict(trainer.train_one_step(pool[step], step)))
        step += 1
        if step in (1, 3):
            got["D" if step == 1 else "D3"] = first_moments(model, opts, ["D"])
        elif step == 2:
            got["G"] = first_moments(model, opts, ["G", "E1", "E2"])
    got["change"] = changes(model, start)
    del start
    for _ in range(tr["warmup_steps"]):
        trainer.train_one_step(pool[step % len(pool)], step)
        step += 1

    # the window
    program.sync(dev)
    program.settle_host()
    launched = program.launches()
    run.window_start = time.perf_counter()
    run.setup_s = time.time() - started
    prof, traced, finite = None, 0, True
    trace_from = run.window_start + tr["trace_after"] * run.seconds
    while time.perf_counter() - run.window_start < run.seconds:
        kind = kind_of(trainer, pcfg.R1_once_every)
        if run.traced and prof is None and traced == 0 and time.perf_counter() >= trace_from:
            prof = trace.profiler()
            span_start = time.perf_counter()
            prof.__enter__()
        t0 = time.perf_counter()
        with trace.unit(kind):
            out = trainer.train_one_step(pool[step % len(pool)], step)
        u = Unit(kind, t0, time.perf_counter(), batch, traced=prof is not None)
        run.units.append(u)
        finite = finite and all(np.isfinite(v).all() for v in out.values())
        step += 1
        if prof is not None:
            traced += 1
            if traced == tr["trace_units"]:
                prof.__exit__(None, None, None)
                run.trace, prof = prof, None
                run.traced_span = (span_start, time.perf_counter())
    if prof is not None:
        prof.__exit__(None, None, None)
        run.trace = prof
        run.traced_span = (span_start, time.perf_counter())
    run.window_end = run.units[-1].end
    run.memory_peak_bytes = program.peak(dev)
    run.notes.append("launches in the window (the program's counters): " + ", ".join(
        f"{k} {v - launched[k]}" for k, v in program.launches().items()))
    sites.remove(undo)
    if run.trace is not None:
        run.trace = trace.reduce(run.trace)

    del bundle, trainer, model, opts, out
    program.free(dev)
    ref = reference_steps(rcfg, run.seed, pool[:n_check], noise_seed,
                          run.cell.own.get("reference", {}), dev)
    run.checks = [("nonfinite_losses", 0.0 if finite else 1.0, 0.0)]
    run.checks += compare(run.cell.own.get("limits", {}), kinds, losses, got, ref)
    run.notes += worst_leaves(got, ref)
    if run.cell.own.get("limits"):
        run.notes += uncompared(run.cell.own["limits"], losses, got, ref)


def reference_steps(rcfg, seed: int, batches: list, noise_seed: int, knobs: dict, dev,
                    control: bool = False) -> dict:
    """The reference's first steps, D+R1, G, D, in float32 with TF32 off,
    from the weights, batches and noise seed the program had; with
    ``control`` in float8 (``harness.control``)."""
    import contextlib
    import dataclasses

    from harness import control as float8
    from reference.model import PPSTModel
    from reference.steps import TrainSteps

    cfg = dataclasses.replace(rcfg, dtype="float32", **knobs)
    w = weights.make(cfg, derive(seed, "weights"), dev)
    model = PPSTModel(cfg)
    model.load_state_dict(w["model"])
    model.lpips.load_state_dict(w["lpips"])
    model.to_device(dev)
    model.set_rscl_state({k: v.clone() for k, v in w["rscl"].items()})
    steps = TrainSteps(model)
    gen = torch.Generator(device=dev).manual_seed(noise_seed)
    out, losses = {}, []
    tf32 = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    mode = float8.for_training(steps.opts) if control else contextlib.nullcontext()
    try:
        with mode:
            for i, b in enumerate(batches):
                real, mask = b["real_A"].to(dev), b["mask_A"].to(dev)
                step = (steps.d_step_r1, steps.g_step, steps.d_step)[i]
                losses.append({k: v.item() for k, v in step(real, mask, gen).items()})
                if i in (0, 2):
                    out["D" if i == 0 else "D3"] = first_moments(model, steps.opts, ["D"])
                elif i == 1:
                    out["G"] = first_moments(model, steps.opts, ["G", "E1", "E2"])
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
    out["change"] = changes(model, w["model"])
    out["losses"] = losses
    return out


def compare(limits: dict, kinds: list, losses: list, got: dict, ref: dict) -> list:
    """(name, number, limit) of the numbers the cell holds (every number
    where it sets no limit yet)."""
    if kinds != ["D+R1", "G", "D"][:len(kinds)]:
        raise RuntimeError(f"the first steps ran {kinds}, not D+R1, G, D")
    numbers = gaps(losses, got, ref)
    return [(k, v, limits.get(k)) for k, v in numbers.items() if k in limits or not limits]


def uncompared(limits: dict, losses: list, got: dict, ref: dict) -> list:
    """Lines with the numbers the cell does not hold, for the record."""
    return [f"not compared {k}: {v!r}" for k, v in gaps(losses, got, ref).items()
            if k not in limits]


def worst_leaves(got: dict, ref: dict, n: int = 4) -> list:
    """Lines naming the leaves of the largest gradient and change gaps."""
    lines = []
    grads = dict(ref["D"], **ref["G"])
    moving = checks.moving_leaves(grads)
    change = {k: v for k, v in ref["change"].items() if k in moving}
    for what, p, r in (("gradient", dict(got["D"], **got["G"]), grads),
                       ("change", got["change"], change)):
        median = sorted(r.values())[(len(r) - 1) // 2]
        worst = sorted(r, key=lambda k: -abs(p[k] - r[k]) / max(r[k], median, 1e-30))[:n]
        lines += [f"leaf {what} {k}: program {p[k]!r} reference {r[k]!r} median {median!r}"
                  for k in worst]
    return lines


def gaps(losses: list, got: dict, ref: dict) -> dict:
    """Every number the comparison can take; the cell's limits pick those it
    holds."""
    grads = dict(ref["D"], **ref["G"])
    moving = checks.moving_leaves(grads)
    out = checks.loss_gaps(losses, ref["losses"])
    out.update(checks.term_gaps(losses, ref["losses"]))
    # the D+R1 step's R1 penalty against its own size (a share of the step's
    # total, as ``term_gaps`` gives it, would hide it: it is a small term)
    out["r1_gap"] = max(abs(float(p.get("D_R1", 0.0)) - r["D_R1"])
                        / max(abs(r["D_R1"]), 1e-30)
                        for p, r in zip(losses, ref["losses"]) if "D_R1" in r)
    # step 2's terms that do not read D, whose first (sign-like) Adam step
    # turns the rounding of its gradient into whole steps of the learning rate
    out["g_terms_gap_step2"] = max(v for k, v in out.items()
                                   if k.startswith("term_gap_step2.") and "GAN" not in k)
    for net, keys in (("D", ("D",)), ("G", ("G", "E1", "E2"))):
        r = {k: v for k, v in grads.items() if k.split(".")[0] in keys}
        p = {k: v for k, v in dict(got["D"], **got["G"]).items() if k in r}
        out[f"grad_gap_median.{net}"] = checks.leaf_gaps(p, r)[(len(r) - 1) // 2]
    # step 3's plain D gradient (step 1's is R1's)
    d3 = checks.leaf_gaps(got["D3"], ref["D3"])
    out["grad_gap_median.D3"] = d3[(len(d3) - 1) // 2]
    out.update(checks.leaf_stats("grad_gap",
                                 checks.leaf_gaps(dict(got["D"], **got["G"]), grads)))
    out.update(checks.leaf_stats("change_gap",
                                 checks.leaf_gaps(got["change"], ref["change"], keep=moving)))
    return out
