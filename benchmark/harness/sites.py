"""Spans around the calls into the kernels' wrappers, for ``--trace 1``.

A kernel's roofline file names its call site (``SITE``:
``"<module>:<attribute path>"``, the name the program calls it by) and how
to read a call's shape (``shape(args, kwargs)``). ``install`` puts a span
``bench.site:<kernel>:<shape>`` around every call made through that name,
and returns what undoes it. The wrapped function is called as it was: its
own counters (``.launches``) count as before.
"""

from __future__ import annotations

import functools
import importlib

import torch

from harness import spec, trace


def _resolve(site: str):
    module_name, _, path = site.partition(":")
    owner = importlib.import_module(module_name)
    *parents, attr = path.split(".")
    for p in parents:
        owner = getattr(owner, p)
    return owner, attr


def kernels_of(cell) -> list:
    """The kernels whose rooflines the cell's per-layer metrics read (each
    reader names its ``KERNEL``)."""
    out = []
    for m in cell.per_layer:
        kernel = getattr(spec.metric_reader(m["name"]), "KERNEL", None)
        if kernel and kernel not in out:
            out.append(kernel)
    return out


def install(kernels) -> list:
    """Wrap each kernel's call site; returns the undo list for ``remove``."""
    undo = []
    for kernel in kernels:
        rf = spec.roofline(kernel)
        owner, attr = _resolve(rf.SITE)
        raw = owner.__dict__[attr] if isinstance(owner, type) else getattr(owner, attr)
        fn = raw.__func__ if isinstance(raw, staticmethod) else raw

        def wrapped(*args, _fn=fn, _kernel=kernel, _shape=rf.shape, **kwargs):
            shape = ",".join(str(int(v)) for v in _shape(args, kwargs))
            with torch.profiler.record_function(f"{trace.SITE}{_kernel}:{shape}"):
                return _fn(*args, **kwargs)

        functools.update_wrapper(wrapped, fn, updated=())
        setattr(owner, attr, staticmethod(wrapped) if isinstance(raw, staticmethod) else wrapped)
        undo.append((owner, attr, raw))
    return undo


def remove(undo: list):
    for owner, attr, raw in reversed(undo):
        setattr(owner, attr, raw)
