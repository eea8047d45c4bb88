"""What a run measured, as the metric readers see it."""

from __future__ import annotations

import hashlib
import statistics
from dataclasses import dataclass, field
from typing import Optional

from harness.spec import Cell


def derive(seed: int, tag: str, *index) -> int:
    """A 63-bit seed of its own for each use of the run's ``--seed``."""
    key = ":".join(str(v) for v in (seed, tag, *index)).encode()
    return int.from_bytes(hashlib.sha256(key).digest()[:8], "little") >> 1


@dataclass
class Unit:
    kind: str  # "D", "D+R1", "G" or "request"
    start: float  # host clock, s
    end: float
    work: int  # images or pairs completed
    traced: bool = False


@dataclass
class Run:
    cell: Cell
    seed: int
    seconds: float
    traced: bool
    device: object = None  # torch.device the program runs on
    card: str = ""
    peaks: tuple = (0.0, 0.0)  # (bytes/s, bf16 operations/s)
    setup_s: float = 0.0
    window_start: float = 0.0
    window_end: float = 0.0
    units: list = field(default_factory=list)
    memory_peak_bytes: int = 0
    trace: Optional[object] = None  # harness.trace.Trace of the traced stretch
    traced_span: tuple = (0.0, 0.0)  # host clock from the profiler's start to its stop
    notes: list = field(default_factory=list)  # lines for standard error before the checks
    checks: list = field(default_factory=list)  # (name, value, limit)

    @property
    def window_s(self) -> float:
        return self.window_end - self.window_start

    def median_ms(self, kind: str) -> Optional[float]:
        """The median duration of the window's units of ``kind``, the traced
        stretch left out."""
        d = [u.end - u.start for u in self.units if u.kind == kind and not u.traced]
        return statistics.median(d) * 1e3 if d else None

    def untraced_window(self) -> tuple:
        """(seconds, units) of the window without the traced stretch, the
        profiler's start and stop included."""
        start, stop = self.traced_span
        return self.window_s - (stop - start), [u for u in self.units if not u.traced]
