"""The traced stretch of a ``--trace 1`` run, reduced from the profiler's
events.

The drivers wrap each step or request in a span ``bench.unit:<kind>`` and
each call into a kernel's wrapper in ``bench.site:<kernel>:<shape>``
(``harness.sites``). ``torch.profiler`` runs over a steady stretch of whole
units inside the window. From its events this module keeps the spans and
every operation on the device (kernels, copies, sets), and gives:

- ``window_s``: from the first unit's start to the last unit's end;
- ``busy_s``: the union of the device operations' intervals inside it, so
  that operations that overlap count once;
- per kernel, the device time of the operations whose names match and
  whose launch (the runtime call with the same correlation id) lies inside
  a span of that kernel's wrapper: kernels of other wrappers that share a
  name (K1's ``apply_kernel`` and K6's, both in anonymous namespaces) do
  not count;
- the device operations that took most time, and the idle gaps by what the
  host was doing: the innermost host operation running at each gap's middle,
  under the unit it belongs to.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Optional

import torch

UNIT, SITE = "bench.unit:", "bench.site:"
NAMED_GAPS = 200


def _ns(e, what):
    if hasattr(e, f"{what}_ns"):
        return getattr(e, f"{what}_ns")()
    return getattr(e, f"{what}_us")() * 1000


@dataclass
class Event:
    name: str
    start: int  # ns
    end: int  # ns
    launched: Optional[int] = None  # a device operation's launch on the host, ns


@dataclass
class Trace:
    units: list  # Event per step or request, in order
    sites: list  # Event per kernel-wrapper call (name: "<kernel>:<shape>")
    device: list  # Event per device operation, by start
    host: list  # Event per other host operation
    start: int = 0
    end: int = 0
    intervals: list = field(default_factory=list)  # merged device intervals in the stretch

    @property
    def window_s(self) -> float:
        return (self.end - self.start) / 1e9

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.intervals) / 1e9

    def kernel_seconds(self, pattern: str, kernel: str) -> tuple:
        """(seconds, count) of the device operations in the stretch whose
        names match ``pattern`` and which were launched inside a call into
        ``kernel``'s wrapper; (0, 0) where a matching operation's launch is
        not in the trace, since it cannot be told apart."""
        rx = re.compile(pattern)
        calls = [(e.start, e.end) for e in self.sites if e.name.partition(":")[0] == kernel]
        hits = []
        for e in self.device:
            if _clip(e, self.start, self.end) <= 0 or not rx.search(e.name):
                continue
            if e.launched is None:
                return 0.0, 0
            if any(a <= e.launched < b for a, b in calls):
                hits.append(e)
        return sum(_clip(e, self.start, self.end) for e in hits) / 1e9, len(hits)

    def site_shapes(self, kernel: str) -> list:
        """The shapes of the calls into ``kernel``'s wrapper in the stretch."""
        out = []
        for e in self.sites:
            name, _, shape = e.name.partition(":")
            if name == kernel and self.start <= e.start < self.end:
                out.append(tuple(int(v) for v in shape.split(",")))
        return out

    def breakdown(self, top: int = 10) -> dict:
        per_op = {}
        for e in self.device:
            per_op[e.name] = per_op.get(e.name, 0) + _clip(e, self.start, self.end)
        ops = sorted(per_op.items(), key=lambda kv: -kv[1])[:top]
        gaps = {}
        # the longest gaps, named by what the host was doing, summed by name
        for a, b in sorted(_gaps(self.intervals, self.start, self.end),
                           key=lambda g: g[0] - g[1])[:NAMED_GAPS]:
            who = self.host_at((a + b) // 2)
            gaps[who] = gaps.get(who, 0) + (b - a)
        idle = sorted(gaps.items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[_short(k), v / 1e9] for k, v in ops],
                "idle_gaps": [[k, v / 1e9] for k, v in idle]}

    def host_at(self, t: int) -> str:
        unit = next((u.name for u in self.units if u.start <= t < u.end), "between units")
        inner = [e for e in self.host if e.start <= t < e.end]
        op = min(inner, key=lambda e: e.end - e.start).name if inner else "no host operation"
        return f"{unit} / {_short(op)}"


def _short(name: str, n: int = 160) -> str:
    return name if len(name) <= n else name[: n - 3] + "..."


def _clip(e: Event, a: int, b: int) -> int:
    return max(0, min(e.end, b) - max(e.start, a))


def _merge(events, a: int, b: int) -> list:
    out = []
    for e in sorted(events, key=lambda e: e.start):
        s, t = max(e.start, a), min(e.end, b)
        if t <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], t)
        else:
            out.append([s, t])
    return out


def _gaps(intervals, a: int, b: int):
    at = a
    for s, t in intervals:
        if s > at:
            yield at, s
        at = max(at, t)
    if b > at:
        yield at, b


def _annotation(e) -> bool:
    test = getattr(e, "is_user_annotation", None)
    return bool(test()) if test is not None else False


def _correlation(e) -> int:
    test = getattr(e, "correlation_id", None)
    return int(test()) if test is not None else 0


def reduce(prof: torch.profiler.profile) -> Trace:
    units, sites, device, host = [], [], [], []
    launches = {}  # correlation id: host start of the runtime call that launched it
    for e in prof.profiler.kineto_results.events():
        start = _ns(e, "start")
        ev = Event(e.name(), start, start + _ns(e, "duration"))
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            # a span shows on the device's timeline too, as an annotation
            if not (_annotation(e) or ev.name.startswith(("bench.", "ProfilerStep"))):
                ev.launched = _correlation(e)
                device.append(ev)
        elif "Launch" in ev.name and _correlation(e):
            launches[_correlation(e)] = start
            host.append(ev)
        elif ev.name.startswith(UNIT):
            ev.name = ev.name[len(UNIT):]
            units.append(ev)
        elif ev.name.startswith(SITE):
            ev.name = ev.name[len(SITE):]
            sites.append(ev)
        else:
            host.append(ev)
    for ev in device:
        ev.launched = launches.get(ev.launched)
    units.sort(key=lambda e: e.start)
    device.sort(key=lambda e: e.start)
    if not units:
        raise RuntimeError("the traced stretch holds no step or request")
    tr = Trace(units, sites, device, host, units[0].start, units[-1].end)
    tr.intervals = _merge(device, tr.start, tr.end)
    return tr


def unit(kind: str):
    """The span of one step or request."""
    return torch.profiler.record_function(UNIT + kind)


def profiler():
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    return torch.profiler.profile(activities=acts)
