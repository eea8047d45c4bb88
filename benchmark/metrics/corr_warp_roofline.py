"""The share of its roofline that corr_warp reached over the traced stretch:
the least time its calls could take (``roofline/corr_warp.py``) over the device
time of its launches (the profiler's kernel events that match the file's
names)."""

from harness.readers import roofline_pct

KERNEL = "corr_warp"


def read(run):
    return roofline_pct(run, KERNEL)
