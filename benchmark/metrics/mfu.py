"""The model's FLOPs of the window's completed steps or requests, counted
once on the plain reference (``workloads/<cell>.json``), over the window's
seconds, as a share of the card's dense bf16 peak; the traced stretch left
out."""

from harness.readers import mfu


def read(run):
    return mfu(run)
