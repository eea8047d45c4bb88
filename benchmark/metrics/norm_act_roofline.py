"""The share of its roofline that K8, the instance norm and what follows it
at every extraction site, reached over the traced stretch: the least time
its calls could take (``roofline/norm_act.py``) over the device time of its
launches (the profiler's kernel events that match the file's names and were
launched inside a call to its site).

In a traced run ``harness.sites`` wraps the call site of each reader's
``KERNEL``. A program without that site (a checkout from before the op) has
nothing to wrap: there the reader names no kernel, and reads nothing."""

import importlib

from harness import spec
from harness.readers import roofline_pct

NAME = "norm_act"


def __getattr__(attr):
    # read when harness.sites asks for KERNEL, after the program is imported
    if attr == "KERNEL":
        module, _, site = spec.roofline(NAME).SITE.partition(":")
        if hasattr(importlib.import_module(module), site):
            return NAME
    raise AttributeError(attr)


def read(run):
    return roofline_pct(run, NAME)
