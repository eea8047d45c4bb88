"""The program's spans in one traced run of a cell, checked against the
benchmark's own view of the same stretch.

    python benchmark/stage_check.py --workload CELL --seed N --seconds S [--all-sites]

from the root of a checkout. Runs the cell as ``run.py --trace 1`` does and
prints its result line, then one more JSON line:

- ``device_ppst``: the device operations whose names start with ``ppst.``
  (a program span filed as device work; none expected);
- ``sites``: for each kernel whose wrapper the benchmark spans
  (``harness.sites``), the calls' shapes by the benchmark's ``bench.site:``
  spans and by the program's ``ppst.op:`` spans, and whether they agree;
- ``stages``: each program stage's device ms a unit (``harness.stages``),
  their sum, and that sum's share of the device time the units launched and
  of the busy time a unit; the largest device operations of each stage, and
  of those launched in a unit but in no stage;
- ``unit_ms``: the traced units' mean wall time.

With ``--all-sites`` every kernel with a roofline file gets its wrapper's
span, not only those the cell's metrics read.
"""

import json
import os
import sys
from types import SimpleNamespace

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [HERE, os.path.dirname(HERE)]

import run as _env  # noqa: E402,F401  (the caches inside the checkout)
from harness import main, sites, spec, stages, trace  # noqa: E402

STAGES = {"request": [f"ppst.stylize:{s}" for s in ("extract", "warp", "decode", "filter")],
          "G": [f"ppst.step:{p}" for p in ("forward", "backward", "update")]}


def report(tr, kind: str) -> dict:
    """The stage numbers of the units of ``kind`` in the reduced trace."""
    units = [u for u in tr.units if u.name == kind]
    if not units:
        return {}
    run = SimpleNamespace(trace=tr)
    kinds = None if kind == "request" else (kind,)
    per = {name: stages.device_ms(run, name, kinds) for name in STAGES[kind]}
    spans = [(e.name, e.start, e.end) for e in tr.host if e.name in STAGES[kind]
             and any(u.start <= e.start < u.end for u in units)]
    launched, rest, top = 0, {}, {name: {} for name in STAGES[kind]}
    for e in tr.device:
        if e.launched is None or not any(u.start <= e.launched < u.end for u in units):
            continue
        ns = trace._clip(e, tr.start, tr.end)
        launched += ns
        stage = next((name for name, a, b in spans if a <= e.launched < b), None)
        ops = rest if stage is None else top[stage]
        ops[e.name] = ops.get(e.name, 0) + ns
    busy = sum(max(0, min(b, u.end) - max(a, u.start)) for u in units for a, b in tr.intervals)
    n = len(units)
    total = sum(v for v in per.values() if v is not None)
    return {"units": n, "device_ms": per, "sum_ms": total,
            "launched_ms": launched / n / 1e6, "busy_ms": busy / n / 1e6,
            "share_of_launched": total / (launched / n / 1e6) if launched else None,
            "share_of_busy": total / (busy / n / 1e6) if busy else None,
            "rest_ms": _largest(rest, n),
            "top_ms": {name: _largest(ops, n) for name, ops in top.items()}}


def _largest(ops: dict, n: int, k: int = 8) -> list:
    return [[trace._short(name), v / n / 1e6]
            for name, v in sorted(ops.items(), key=lambda kv: -kv[1])[:k]]


def compare_sites(tr) -> dict:
    out = {}
    kernels = sorted({e.name.partition(":")[0] for e in tr.sites})
    for k in kernels:
        bench = sorted(tr.site_shapes(k))
        prog = sorted(tuple(int(v) for v in e.name.rsplit(":", 1)[1].split(","))
                      for e in tr.host if e.name.startswith(f"ppst.op:{k}:")
                      and tr.start <= e.start < tr.end)
        out[k] = {"bench_site": len(bench), "ppst_op": len(prog), "equal": bench == prog,
                  "shapes": sorted(set(bench))}
    return out


def check(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    all_sites = "--all-sites" in argv
    if all_sites:
        argv.remove("--all-sites")
        every = sorted(f[:-3] for f in os.listdir(os.path.join(HERE, "roofline"))
                       if f.endswith(".py"))
        sites.kernels_of = lambda cell: every
    kept = []
    reduce = trace.reduce

    def keep(prof):
        kept.append(reduce(prof))
        return kept[-1]

    trace.reduce = keep
    rc = main.main(argv + ["--trace", "1"], started=main.process_start())
    if rc or not kept:
        return rc or 1
    tr = kept[-1]
    out = {"device_ppst": sorted({e.name for e in tr.device if e.name.startswith("ppst.")}),
           "sites": compare_sites(tr),
           "stages": {k: report(tr, k) for k in STAGES if any(u.name == k for u in tr.units)},
           "unit_ms": {k: sum(u.end - u.start for u in tr.units if u.name == k) / 1e6
                       / sum(u.name == k for u in tr.units)
                       for k in sorted({u.name for u in tr.units})},
           "workload": spec.cell(argv[argv.index("--workload") + 1]).name}
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(check())
