"""Named spans of the program on ``torch.profiler``'s clock.

``span("stylize:extract")`` opens ``torch.profiler.record_function(
"ppst.stylize:extract")`` while a torch profiler runs (the benchmark's
``--trace 1``, the train CLI's ``--profile_dir``), so that the span sits on
the same timeline as the device operations launched inside it. With no
profiler running it is one check of the profiler's flag and a shared null
context: spans are on exactly when someone profiles, with no option of
their own.

Names are ``ppst.<layer>:<stage>``; ``dims`` (ints, or sequences of ints
such as a tensor's shape) are appended as ``:<d0>,<d1>,...``, formatted
only when the profiler is on. No name holds ``Launch`` (a trace reader
takes such host events for the runtime's kernel launches).
"""

from __future__ import annotations

import contextlib

import torch

PREFIX = "ppst."
_OFF = contextlib.nullcontext()
_profiling = torch._C._autograd._profiler_enabled


def name_of(name: str, *dims) -> str:
    """The recorded name of ``span(name, *dims)``."""
    if dims:
        flat = [v for d in dims for v in (d if isinstance(d, (tuple, list)) else (d,))]
        name = f"{name}:{','.join(str(int(v)) for v in flat)}"
    return PREFIX + name


def span(name: str, *dims):
    """A context manager: the profiler's span ``ppst.<name>[:<dims>]`` while
    a profiler runs, else the shared null context."""
    if not _profiling():
        return _OFF
    return torch.profiler.record_function(name_of(name, *dims))
