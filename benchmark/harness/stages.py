"""Per-stage numbers of the traced stretch, from the program's own spans.

While a profiler runs, the program marks its stages as spans
``ppst.<layer>:<stage>`` on the profiler's clock (``ppst_tpu_torch/util/
spans.py``): ``stylize``'s ``ppst.stylize:extract``, ``:warp``, ``:decode``
and ``:filter``, a training step's ``ppst.step:forward``, ``:backward`` and
``:update``. ``trace.reduce`` files them among the stretch's host events.
For a span's name this gives, per unit of the stretch (step or request):

- ``device_ms``: the device time, clipped to the stretch, of the operations
  launched inside a span of that name: by the launch's time on the host,
  whatever thread launched it (autograd's backward launches from a thread of
  its own), and whole where the operation runs past its span's end;
- ``idle_ms``: each such span's length less the device's busy time inside
  it (the union of the device operations, ``Trace.intervals``).

Spans of one name that nest or overlap count once. With ``kinds`` only the
units of those kinds count (``("G",)``), and only the spans that start
inside one of them. Both give None where the stretch holds no such span
(a program without it), as ``readers.roofline_pct`` does where a kernel did
not run.
"""

from __future__ import annotations

import bisect

from harness.trace import _clip, _merge


def _spans(trace, name: str, kinds):
    """(units counted, merged intervals of the spans named ``name`` that start
    inside one of them); (0, []) where there are none."""
    units = [u for u in trace.units if kinds is None or u.name in kinds]
    inside = [e for e in trace.host if e.name == name
              and any(u.start <= e.start < u.end for u in units)]
    spans = _merge(inside, trace.start, trace.end)
    return (len(units), spans) if spans else (0, [])


def device_ms(run, span: str, kinds=None):
    """Device ms a unit of the operations launched inside the spans ``span``."""
    if run.trace is None:
        return None
    n, spans = _spans(run.trace, span, kinds)
    if not spans:
        return None
    starts = [a for a, _ in spans]
    total = 0
    for e in run.trace.device:
        if e.launched is None:
            continue
        i = bisect.bisect_right(starts, e.launched) - 1
        if i >= 0 and e.launched < spans[i][1]:
            total += _clip(e, run.trace.start, run.trace.end)
    return total / n / 1e6


def idle_ms(run, span: str, kinds=None):
    """Ms a unit in which the host was inside the spans ``span`` and nothing
    ran on the device."""
    if run.trace is None:
        return None
    n, spans = _spans(run.trace, span, kinds)
    if not spans:
        return None
    busy = run.trace.intervals
    starts = [s for s, _ in busy]
    idle = 0
    for a, b in spans:
        idle += b - a
        for s, t in busy[max(0, bisect.bisect_right(starts, a) - 1):]:
            if s >= b:
                break
            idle -= max(0, min(t, b) - max(s, a))
    return idle / n / 1e6
