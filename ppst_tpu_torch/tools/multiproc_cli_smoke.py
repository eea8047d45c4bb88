"""Two processes over the real train CLI (the port's
``tools/multihost_cli_smoke.py``).

Runs ``python -m ppst_tpu_torch.train`` as a world of two ranks on gloo,
twice: once launched by ``python -m torch.distributed.run --nproc_per_node
2`` and once as two processes that join through the JAX package's
``PPST_NUM_PROCESSES``, ``PPST_COORDINATOR`` and ``PPST_PROCESS_ID``
(``parallel.launch_env``). Both runs are world 2 (the losses of one world
size are not another's: ``half_batch`` works per rank). It parses the two
``loss_log.txt`` files as the JAX tool does and checks that every logged
step's losses agree (within 5e-3, the JAX tool's bound: the log prints 3
decimals), and, in the second run, where each rank runs in a folder of its
own with a relative ``--checkpoints_dir``, that rank 1 wrote nothing and
rank 0 wrote ``opt.txt``, the checkpoints, ``iter.txt`` and the log. This
drives each rank's slice of the loader, the rank-0 writes and the averaged
logged losses through the CLI itself.

It runs on the CPU only: two ranks on NCCL need two GPUs.

    python -m ppst_tpu_torch.tools.multiproc_cli_smoke [--steps 6] [--crop 64]

Prints ``MULTIPROC-CLI OK`` and exits 0, or says what failed and exits 1.
"""

from __future__ import annotations

import argparse
import os
import re
import socket
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
N_PROC = 2
BATCH = 2 * N_PROC  # the global batch: 2 a rank
# the narrow widths of the port's CPU tests
WIDTHS = dict(netE_scale_capacity=0.25, netE2_scale_capacity=0.25, global_code_ch=64,
              spatial_code_ch=16, netG_resnet_ch=32, netG_scale_capacity=0.125,
              netD_scale_capacity=0.125)
MAX_GAP = 5e-3


def train_flags(steps: int, crop: int):
    return ["--device", "cpu", "--name", "smoke", "--dataset_mode", "synthetic",
            "--synthetic_size", str(4 * BATCH), "--crop_size", str(crop),
            "--load_size", str(crop), "--preprocess", "resize", "--batch_size", str(BATCH),
            "--num_gpus", str(N_PROC), "--total_nimgs", str(steps * BATCH),
            "--print_freq", str(BATCH), "--save_freq", str(2 * BATCH),
            "--evaluation_freq", "1000000", "--display_freq", "1000000",
            "--R1_once_every", "2", "--nThreads", "1",
            *[f"--{k}={v}" for k, v in WIDTHS.items()]]


def parse_log(path):
    """loss_log.txt lines '(iters: N, ...) k: v k: v ' -> [(N, {k: v})]
    (``tools/multihost_cli_smoke.py:73``)."""
    rows = []
    with open(path) as f:
        for line in f:
            m = re.match(r"\(iters: (\d+)[^)]*\) (.*)", line.strip())
            if not m:
                continue
            losses = {k: float(v) for k, v in re.findall(r"(\w+): ([-\d.eE]+)", m.group(2))}
            rows.append((int(m.group(1)), losses))
    return rows


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _env(threads: int, **extra):
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT",
                        "PPST_NUM_PROCESSES", "PPST_PROCESS_ID", "PPST_COORDINATOR")}
    path = os.pathsep.join(p for p in (ROOT, os.environ.get("PYTHONPATH")) if p)
    return dict(env, PYTHONPATH=path, OMP_NUM_THREADS=str(threads), **extra)


def _finish(procs, timeout):
    """Wait for every process; (all exited 0, their output's last lines)."""
    ok, tails = True, []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            p.kill()
            out, _ = p.communicate()
            ok = False
        ok &= p.returncode == 0
        tails.append(f"rc={p.returncode}\n" + "\n".join((out or "").strip().splitlines()[-8:]))
    return ok, tails


def _start(cmd, cwd, env):
    return subprocess.Popen(cmd, cwd=cwd, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def run(steps: int = 6, crop: int = 64, folder: str = None, timeout: float = 600) -> dict:
    """Both launches in ``folder`` (a new temporary one by default): whether
    every process exited 0 and the last lines of their output, each route's
    parsed log, and the files of each rank's folder in the second run."""
    folder = folder or tempfile.mkdtemp(prefix="ppst_mpcli_")
    threads = max(1, (os.cpu_count() or 2) // (2 * N_PROC))
    flags = train_flags(steps, crop)

    torchrun_dir = os.path.join(folder, "torchrun")
    ok_a, tails_a = _finish([_start(
        [sys.executable, "-m", "torch.distributed.run", "--nproc_per_node", str(N_PROC),
         "--master_addr", "127.0.0.1", "--master_port", str(_free_port()),
         "-m", "ppst_tpu_torch.train", "--checkpoints_dir", torchrun_dir, *flags],
        ROOT, _env(threads))], timeout)

    coordinator = f"127.0.0.1:{_free_port()}"
    rank_dirs = [os.path.join(folder, f"rank{r}") for r in range(N_PROC)]
    procs = []
    for r, cwd in enumerate(rank_dirs):
        os.makedirs(cwd)
        procs.append(_start(
            [sys.executable, "-m", "ppst_tpu_torch.train", "--checkpoints_dir", "checkpoints",
             *flags], cwd,
            _env(threads, PPST_NUM_PROCESSES=str(N_PROC), PPST_COORDINATOR=coordinator,
                 PPST_PROCESS_ID=str(r))))
    ok_b, tails_b = _finish(procs, timeout)

    out = {"ok": ok_a and ok_b, "tails": tails_a + tails_b, "logs": {}, "files": []}
    if not out["ok"]:
        return out
    out["logs"] = {"torchrun": parse_log(os.path.join(torchrun_dir, "smoke", "loss_log.txt")),
                   "ppst_env": parse_log(os.path.join(rank_dirs[0], "checkpoints", "smoke",
                                                      "loss_log.txt"))}
    out["files"] = [sorted(os.path.relpath(os.path.join(d, f), cwd)
                           for d, _, names in os.walk(cwd) for f in names) for cwd in rank_dirs]
    return out


def compare(logs, steps: int):
    """(worst absolute gap, failures) of the two routes' logged losses."""
    a, b = logs["torchrun"], logs["ppst_env"]
    failures, worst = [], 0.0
    if len(a) < steps or len(b) < steps:
        failures.append(f"too few log rows: {len(a)} torchrun, {len(b)} PPST_* ({steps} steps)")
    for (it_a, la), (it_b, lb) in zip(a, b):
        if it_a != it_b or set(la) != set(lb):
            failures.append(f"rows differ: iters {it_a} {sorted(la)} against {it_b} {sorted(lb)}")
            continue
        for k in la:
            worst = max(worst, abs(la[k] - lb[k]))
            if abs(la[k] - lb[k]) > MAX_GAP:
                failures.append(f"iters={it_a} {k}: torchrun {la[k]} PPST_* {lb[k]}")
    return worst, failures


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=6)
    ap.add_argument("--crop", type=int, default=64)
    args = ap.parse_args(argv)
    out = run(args.steps, args.crop)
    for tail in out["tails"]:
        print(f"--- {tail}")
    if not out["ok"]:
        print("MULTIPROC-CLI FAILED (a process exited non-zero)")
        return 1
    worst, failures = compare(out["logs"], args.steps)
    rank0, rank1 = out["files"]
    wanted = {os.path.join("checkpoints", "smoke", f)
              for f in ("opt.txt", "latest_checkpoint.pth", "iter.txt", "loss_log.txt")}
    if rank1:
        failures.append(f"rank 1 wrote {rank1}")
    if not wanted <= set(rank0):
        failures.append(f"rank 0 wrote {rank0}, not all of {sorted(wanted)}")
    for f in failures:
        print(f)
    print(f"{len(out['logs']['torchrun'])} logged steps of the two launches agree "
          f"(worst absolute gap {worst:.2e})")
    print("MULTIPROC-CLI FAILED" if failures else "MULTIPROC-CLI OK")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
