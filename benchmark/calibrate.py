"""The readings the correctness limits are set from, on the card, at the
cell's own size, in one process:

    python benchmark/calibrate.py --workload CELL --seeds 12 --control 3 \
        [--fault half_batch --fault-seeds 3] [--seconds 2] [--out FILE]

For each of ``--seeds`` seeds it drives the cell's run (a short window at
the cell's own load) and prints every number the comparison can take
against the plain reference (the lower readings). For ``--control`` more
seeds it puts the reference computed in float8 (``harness.control``) in
the program's place (the upper readings). With ``--fault`` it plants a
fault under the program's timed path on ``--fault-seeds`` seeds
(``harness/faults.py``). With ``--set KEY=JSON`` the program runs with
that configuration field instead (a witness). One JSON line per reading.
"""

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [HERE, os.path.dirname(HERE)]

import torch  # noqa: E402

from harness import peaks, spec  # noqa: E402
from harness.faults import FAULTS  # noqa: E402
from harness.run_record import Run, derive  # noqa: E402


def program_reading(cell, seed, seconds, dev):
    run = Run(cell=cell, seed=seed, seconds=seconds, traced=False, device=dev,
              card=torch.cuda.get_device_name(0) if dev.type == "cuda" else "cpu")
    run.peaks = peaks.of(run.card) if dev.type == "cuda" else (1.0, 1.0)
    t = time.time()
    spec.driver(cell.traffic["driver"]).run(run, t)
    return {"units": len(run.units), "peak_gib": run.memory_peak_bytes / 2**30,
            "setup_s": run.setup_s, "numbers": {n: v for n, v, _ in run.checks},
            "notes": run.notes}


def control_reading(cell, seed, dev):
    from harness import program

    drv = spec.driver(cell.traffic["driver"])
    tr = cell.traffic
    _, rcfg = program.configs(cell.config)
    if tr["driver"] == "train":
        from harness import inputs

        batches = inputs.host_batches(derive(seed, "inputs"), tr["check_steps"], tr["batch"],
                                      rcfg.crop_size, dev)
        knobs = cell.own.get("reference", {})
        ref = drv.reference_steps(rcfg, seed, batches, derive(seed, "noise"), knobs, dev)
        ctl = drv.reference_steps(rcfg, seed, batches, derive(seed, "noise"), knobs, dev,
                                  control=True)
        return {"numbers": drv.gaps(ctl["losses"], ctl, ref),
                "notes": drv.worst_leaves(ctl, ref)}
    from harness import checks, inputs

    pool = inputs.host_images(derive(seed, "inputs"), tr["pool_images"], rcfg.crop_size, dev)
    sample = [(r, None) for r in range(tr["check_requests"])]
    want = drv.reference_outputs(rcfg, seed, tr, pool, sample, dev)
    gaps = drv.reference_gaps(rcfg, seed, tr, pool, [(r, checks.to_uint8(o)) for r, o in want],
                              dev, control=True)
    return {"numbers": checks.worst(gaps)}


def main():
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, default=12)
    p.add_argument("--control", type=int, default=3)
    p.add_argument("--fault", choices=sorted(FAULTS))
    p.add_argument("--set", action="append", default=[], metavar="KEY=JSON",
                   help="a configuration field to run the program with instead (a witness)")
    p.add_argument("--fault-seeds", type=int, default=3)
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--first-seed", type=int, default=3_000_000_000)
    p.add_argument("--device", default="cuda")
    p.add_argument("--out")
    args = p.parse_args()
    dev = torch.device(args.device)
    cell = spec.cell(args.workload)
    cell.own = dict(cell.own, limits={})
    for kv in args.set:
        key, _, value = kv.partition("=")
        cell.config = dict(cell.config, **{key: json.loads(value)})
    out = open(args.out, "a") if args.out else None

    def emit(rec):
        line = json.dumps(dict(rec, workload=args.workload))
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()

    seeds = [args.first_seed + 7919 * i for i in range(args.seeds + args.control + args.fault_seeds)]
    for seed in seeds[:args.seeds]:
        emit(dict(program_reading(cell, seed, args.seconds, dev), kind="program", seed=seed,
                  set=args.set))
    for seed in seeds[args.seeds:args.seeds + args.control]:
        emit(dict(control_reading(cell, seed, dev), kind="control_float8", seed=seed))
    if args.fault:
        FAULTS[args.fault]()
        for seed in seeds[args.seeds + args.control:]:
            emit(dict(program_reading(cell, seed, args.seconds, dev), kind=f"fault_{args.fault}",
                      seed=seed))


if __name__ == "__main__":
    main()
