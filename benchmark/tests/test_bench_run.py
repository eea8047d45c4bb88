"""``benchmark/run.py`` refuses to run without the CUDA devices a cell asks
for, and prints no result then; its result line follows the contract on
the card."""

import json
import os
import subprocess
import sys

import pytest

from harness import spec

RUN = [sys.executable, str(spec.BENCH / "run.py")]


def _run(args, cwd, env=None, timeout=300):
    return subprocess.run(RUN + args, cwd=cwd, capture_output=True, text=True, timeout=timeout,
                          env=env)


def test_refuses_without_a_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    p = _run(["--workload", "ppst512.stylize.b1", "--seed", str(2**31 + 11), "--seconds", "1",
              "--trace", "0"], cwd=spec.ROOT, env=env)
    assert p.returncode != 0
    assert not p.stdout.strip()
    assert "CUDA device" in p.stderr


def test_unknown_workload_fails():
    p = _run(["--workload", "no.such.cell", "--seed", "1", "--seconds", "1"], cwd=spec.ROOT)
    assert p.returncode != 0 and not p.stdout.strip()


@pytest.mark.card
def test_result_line_on_the_card(card):
    p = _run(["--workload", "ppst512.stylize.b1", "--seed", str(2**31 + 13), "--seconds", "2",
              "--trace", "1"], cwd=spec.ROOT, timeout=600)
    assert p.returncode == 0, p.stderr[-4000:]
    out = json.loads(p.stdout.strip().splitlines()[-1])
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(out)
    assert out["device"]["platform"] == "gpu" and out["device"]["busy_s"] > 0
    assert list(out)[-1] == "checks"
    assert p.stderr.strip().splitlines()[-1].startswith("check ")
