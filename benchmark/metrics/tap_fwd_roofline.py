"""The share of its roofline that tap_fwd reached over the traced stretch:
the least time its calls could take (``roofline/tap_fwd.py``) over the device
time of its launches (the profiler's kernel events that match the file's
names)."""

from harness.readers import roofline_pct

KERNEL = "tap_fwd"


def read(run):
    return roofline_pct(run, KERNEL)
