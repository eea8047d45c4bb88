"""One run: ``python benchmark/run.py --workload CELL --seed N --seconds S
--trace 0|1``.

It finds the cell's files by name (``harness.spec``), refuses to run
without the CUDA devices the cell asks for, hands the run to the driver the
traffic names (``drivers/<driver>.py``: set-up, warm-up, the measured
window, then the comparison with the plain reference), reads each of the
cell's metrics with its reader (``metrics/<name>.py``; end-to-end metrics
with ``--trace 0``, per-layer metrics with ``--trace 1``), and prints the
compared numbers beside their limits as the last lines of standard error and
one JSON line as the last line of standard output.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

from harness import imports, spec
from harness.run_record import Run


def process_start() -> float:
    """The process's start on the ``time.time()`` clock (from /proc), so that
    ``setup_s`` counts the interpreter and the imports too."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/stat") as f:
            btime = next(int(line.split()[1]) for line in f if line.startswith("btime"))
        return btime + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError, StopIteration):
        return time.time()


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None, started: float = None) -> int:
    started = process_start() if started is None else started
    args = parse(argv)
    cell = spec.cell(args.workload)

    import torch

    chips = cell.entry["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"benchmark: {args.workload} needs {chips} CUDA device(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    from harness import peaks

    run = Run(cell=cell, seed=args.seed, seconds=args.seconds, traced=bool(args.trace),
              device=torch.device("cuda"), card=torch.cuda.get_device_name(0))
    run.peaks = peaks.of(run.card)
    spec.driver(cell.traffic["driver"]).run(run, started)

    loaded = imports.forbidden_loaded()
    if loaded:
        print("benchmark: the process holds modules it may not: " + ", ".join(loaded),
              file=sys.stderr)
        return 3
    metrics = {}
    for m in (cell.per_layer if args.trace else cell.end_to_end):
        value = spec.metric_reader(m["name"]).read(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    device = {"platform": "gpu", "kind": run.card, "count": chips,
              "memory_peak_bytes": run.memory_peak_bytes}
    result = {"correct": None, "attempted": len(run.units), "failed": 0, "metrics": metrics,
              "device": device}
    if run.trace is not None:
        device["busy_s"] = run.trace.busy_s
        device["window_s"] = run.trace.window_s
        result["breakdown"] = run.trace.breakdown()
    checks = [{"name": n, "value": v, "limit": lim} for n, v, lim in run.checks]
    result["correct"] = bool(checks) and all(
        c["limit"] is not None and c["value"] <= c["limit"] for c in checks)
    result["checks"] = checks
    for line in run.notes:
        print(line, file=sys.stderr)
    for c in checks:
        print(f"check {c['name']}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
