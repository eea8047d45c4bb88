"""The median wall time (host clock) of the window's plain D steps (D+R1
steps left out), the traced stretch left out."""


def read(run):
    return run.median_ms("D")
