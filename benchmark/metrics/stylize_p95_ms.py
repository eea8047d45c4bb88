"""The 95th percentile of the window's request latencies (host clock, host
images handed over to uint8 images on the host), nearest rank over every
request of the window. ``stylize_p95_ms.512px`` is the same number of the
512px interactive cell, apart for a bound of its own: there the host's
launches set the pace."""

from harness.readers import p95_ms


def read(run):
    return p95_ms(run)
