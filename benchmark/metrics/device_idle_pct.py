"""The share of the traced stretch of whole steps or requests in which no
operation ran on the device (the union of the device operations'
intervals, from the profiler's trace)."""

from harness.readers import idle_pct


def read(run):
    return idle_pct(run)
