"""Images of every training step completed in the window over the window's
wall time (host clock). Each D, D+R1 or G step consumes one batch."""

from harness.readers import work_per_s


def read(run):
    return work_per_s(run)
