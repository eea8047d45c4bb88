"""Pairs of every request completed in the window over the window's wall
time (host clock), host images in to uint8 images back on the host."""

from harness.readers import work_per_s


def read(run):
    return work_per_s(run)
