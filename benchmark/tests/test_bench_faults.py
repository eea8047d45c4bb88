"""A run with its timed path broken underneath comes out not correct.

Each test drives a whole run of a cell (the narrow model at crop 64 on the
CPU, the harness's look for a card skipped) with one fault planted in the
program, and holds the numbers it compares to the cell's own limits: a
step that leaves the state unchanged, half of the batch left out (the mean
taken over the rest), and an answer altered where it is produced (a served
image; in training, the D+R1 step's R1 penalty left out). The
cells run on one card, so no exchange between cards can be left out. The
same run without a fault comes out correct at this size.
"""

import pytest
import torch

from harness import spec
from harness.faults import answer_altered, half_batch, r1_dropped, state_unchanged
from harness.run_record import Run

CPU = torch.device("cpu")


CASES = [("ppst512.train.b2", state_unchanged), ("ppst512.train.b2", half_batch),
         ("ppst512.train.b2", r1_dropped),
         ("ppst512.stylize.b8", half_batch), ("ppst512.stylize.b8", answer_altered),
         ("ppst512.stylize.b1", answer_altered), ("ppst1024.stylize.b1", answer_altered)]


def _correct(cell) -> tuple:
    run = Run(cell=cell, seed=2**31 + 29, seconds=0.5, traced=False, device=CPU)
    spec.driver(cell.traffic["driver"]).run(run, 0.0)
    assert run.checks and all(limit is not None for _, _, limit in run.checks)
    return all(v <= limit for _, v, limit in run.checks), run.checks


@pytest.mark.parametrize("name", sorted({c for c, _ in CASES}))
def test_sound_run_is_correct(small_cell, name):
    ok, numbers = _correct(small_cell(name))
    assert ok, numbers


@pytest.mark.parametrize("name, fault", CASES, ids=lambda v: getattr(v, "__name__", v))
def test_fault_makes_the_run_not_correct(small_cell, monkeypatch, name, fault):
    fault(monkeypatch.setattr)
    ok, numbers = _correct(small_cell(name))
    assert not ok, numbers
