"""What the metric readers share: the statistics several readers take
from a run."""

from __future__ import annotations

import math

from harness import spec


def work_per_s(run):
    """The images or pairs of every unit completed in the window over the
    window's wall time."""
    return sum(u.work for u in run.units) / run.window_s


def p95_ms(run):
    """The 95th percentile (nearest rank) of every request of the window, ms."""
    lat = sorted(u.end - u.start for u in run.units)
    return lat[max(0, math.ceil(0.95 * len(lat)) - 1)] * 1e3


def mfu(run, kinds=None):
    """The model's FLOPs of the window's completed steps or requests over the
    window's seconds, as a share of the card's dense bf16 peak, in percent.
    The FLOPs of each kind of step or request are the cell's own
    (``workloads/<cell>.json``: counted once on the plain reference). In a
    traced run the traced stretch is left out of both."""
    flops = run.cell.own.get("flops", {})
    seconds, units = run.untraced_window()
    units = [u for u in units if kinds is None or u.kind in kinds]
    if not units or seconds <= 0 or any(u.kind not in flops for u in units):
        return None
    return 100.0 * sum(flops[u.kind]["flop"] for u in units) / seconds / run.peaks[1]


def idle_pct(run):
    """The share of the traced stretch in which nothing ran on the device."""
    if run.trace is None or run.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)


def roofline_pct(run, kernel: str):
    """The least time the card could take for the stretch's calls of
    ``kernel`` (each call's max(operations / peak, bytes / bandwidth), from
    ``roofline/<kernel>.py``) over the device time of the kernel's
    launches in the stretch (those its wrapper launched,
    ``Trace.kernel_seconds``), in percent; nothing where it did not run."""
    if run.trace is None:
        return None
    rf = spec.roofline(kernel)
    shapes = run.trace.site_shapes(kernel)
    seconds, launches = run.trace.kernel_seconds(rf.KERNELS, kernel)
    if not shapes or not launches or seconds <= 0:
        return None
    bw, flops = run.peaks
    bound = sum(max(rf.ops(s) / flops, rf.bytes_moved(s) / bw) for s in shapes)
    return 100.0 * bound / seconds
