"""The median wall time (host clock) of the window's G steps, the traced
stretch left out. ``train_one_step`` ends in a copy of the losses to the
host, so a step's span covers its device work."""


def read(run):
    return run.median_ms("G")
