"""Serving traffic: one client in a closed loop, each request a batch of
``batch`` (content, style) pairs through ``PPSTModel.<entry>`` with the
guided filter on the output (``smooth_target``).

A request runs from host images in (float32 NHWC in [-1, 1], as a loader
gives them) to uint8 images back on the host: the copy to the card, the
cast to the compute dtype, the entry, ``to_uint8`` and the copy back. Its
noise comes from the request's own generator seed. The images are a pool of
``pool_images`` drawn from the seed; request r takes the ``batch`` contents
from block r and the styles from another block, so that pairs change from
request to request. The client sends the next request when the last has
come back. Set-up builds the model, loads the benchmark's weights and runs
``warmup_requests`` requests at the window's shapes. After the window: the
memory peak, then the program is freed and the reference recomputes a
sample of the window's requests, drawn from the seed.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from harness import checks, inputs, program, sites, trace, weights
from harness.run_record import Unit, derive


def blocks(r: int, batch: int, pool: int) -> tuple:
    """(first content row, first style row) of request ``r``."""
    n = pool // batch
    c = r % n
    s = (c + 1 + (r // n) % (n - 1)) % n
    return c * batch, s * batch


def run(run, started: float):
    from ppst_tpu_torch.models.ppst import PPSTModel

    tr, dev = run.cell.traffic, run.device
    pcfg, rcfg = program.configs(run.cell.config)
    batch, crop, dtype = tr["batch"], pcfg.crop_size, getattr(torch, pcfg.dtype)
    pool = inputs.host_images(derive(run.seed, "inputs"), tr["pool_images"], crop, dev)
    program.free(dev)
    program.reset_peak(dev)

    w = weights.make(rcfg, derive(run.seed, "weights"), dev)
    model = PPSTModel(pcfg, device=dev, seed=0)
    program.load(model, w)
    del w
    entry = getattr(model, tr["entry"])
    gen = torch.Generator(device=dev)
    undo = sites.install(sites.kernels_of(run.cell)) if run.traced else []

    def request(r: int):
        c0, s0 = blocks(r, batch, len(pool))
        gen.manual_seed(derive(run.seed, "noise", r))
        content = pool[c0:c0 + batch].to(dev, non_blocking=True).to(dtype)
        style = pool[s0:s0 + batch].to(dev, non_blocking=True).to(dtype)
        out = entry(content, style, gen, smooth_target=tr["smooth_target"])
        return model.to_uint8(out).cpu()

    for r in range(-tr["warmup_requests"], 0):
        request(r)

    # the window; a seeded reservoir keeps a uniform sample of its requests
    rng = np.random.default_rng(derive(run.seed, "sample"))
    sample, k = [], tr["check_requests"]
    program.sync(dev)
    program.settle_host()
    launched = program.launches()
    run.window_start = time.perf_counter()
    run.setup_s = time.time() - started
    prof, traced, r = None, 0, 0
    trace_from = run.window_start + tr["trace_after"] * run.seconds
    while time.perf_counter() - run.window_start < run.seconds:
        if run.traced and prof is None and traced == 0 and time.perf_counter() >= trace_from:
            prof = trace.profiler()
            span_start = time.perf_counter()
            prof.__enter__()
        t0 = time.perf_counter()
        with trace.unit("request"):
            out = request(r)
        run.units.append(Unit("request", t0, time.perf_counter(), batch,
                              traced=prof is not None))
        if len(sample) < k:
            sample.append((r, out))
        else:
            j = int(rng.integers(0, r + 1))
            if j < k:
                sample[j] = (r, out)
        r += 1
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

    del model, entry, out
    program.free(dev)
    gaps = checks.worst(reference_gaps(rcfg, run.seed, tr, pool, sample, dev))
    limits = run.cell.own.get("limits", {})
    run.checks = [(name, value, limits.get(name)) for name, value in gaps.items()
                  if name in limits or not limits]
    lat = sorted(u.end - u.start for u in run.units)
    run.notes.append(f"requests {len(lat)}: median {lat[(len(lat) - 1) // 2] * 1e3!r} ms, "
                     f"sample of {len(sample)} compared")
    if limits:
        run.notes += [f"not compared {k}: {v!r}" for k, v in gaps.items() if k not in limits]


def reference_gaps(rcfg, seed: int, tr: dict, pool, sample: list, dev,
                   control: bool = False) -> list:
    """The gaps of each sampled request's uint8 output, (r, images), against
    the reference's (float32, TF32 off; in float8 with ``control``)."""
    return [checks.image_gaps(out, want)
            for (_, out), (_, want) in zip(sample, reference_outputs(rcfg, seed, tr, pool, sample,
                                                                     dev, control))]


def reference_outputs(rcfg, seed: int, tr: dict, pool, sample: list, dev,
                      control: bool = False) -> list:
    """(r, the reference's float32 output) of each sampled request r."""
    import contextlib

    from harness.control import Float8
    from reference.model import PPSTModel

    w = weights.make(rcfg, derive(seed, "weights"), dev)
    model = PPSTModel(rcfg)
    model.load_state_dict(w["model"])
    model.lpips.load_state_dict(w["lpips"])
    model.to_device(dev)
    del w
    entry = getattr(model, tr["entry"])
    gen = torch.Generator(device=dev)
    noise_dtype = getattr(torch, rcfg.dtype)
    batch = tr["batch"]
    outs = []
    tf32 = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        with Float8() if control else contextlib.nullcontext():
            for r, _ in sample:
                c0, s0 = blocks(r, batch, len(pool))
                gen.manual_seed(derive(seed, "noise", r))
                outs.append((r, entry(pool[c0:c0 + batch].to(dev), pool[s0:s0 + batch].to(dev),
                                      gen, noise_dtype, smooth_target=tr["smooth_target"])))
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
    return outs
