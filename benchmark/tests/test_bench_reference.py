"""The plain reference (``benchmark/reference``) against the program
(``ppst_tpu_torch``) at crop 64 with narrow widths, both in float32 on the
CPU, from the benchmark's weights, inputs and noise: ``stylize``,
``stylize_fused`` and the first training steps (D+R1, G, D) through the
benchmark's own drivers."""

import dataclasses

import pytest
import torch

from harness import program, spec, weights
from harness.run_record import Run

CPU = torch.device("cpu")


def _models(cell):
    from ppst_tpu_torch.models.ppst import PPSTModel as Program
    from reference.model import PPSTModel as Reference

    pcfg, rcfg = program.configs(cell.config)
    w = weights.make(rcfg, 2**31 + 101, CPU)
    prog = Program(pcfg, device="cpu", seed=0)
    program.load(prog, w)
    ref = Reference(rcfg)
    ref.load_state_dict(w["model"])
    ref.lpips.load_state_dict(w["lpips"])
    return prog, ref.to_device(CPU), rcfg


def test_state_dict_keys_and_rules_match_the_program(small_cell):
    from ppst_tpu_torch.models.ppst import PPSTModel as Program

    cell = small_cell("ppst512.stylize.b1")
    pcfg, rcfg = program.configs(cell.config)
    prog = Program(pcfg, device="cpu", seed=0)
    w = weights.make(rcfg, 5, CPU)
    assert set(prog.state_dict()) == set(w["model"])
    assert set(prog.lpips.state_dict()) == set(w["lpips"])
    assert all(prog.state_dict()[k].shape == v.shape for k, v in w["model"].items())


@pytest.mark.parametrize("entry", ["stylize", "stylize_fused"])
def test_serving_matches_the_program_in_float32(small_cell, entry):
    cell = small_cell("ppst512.stylize.b8", dtype="float32", fused_tap=False)
    prog, ref, rcfg = _models(cell)
    gen = torch.Generator().manual_seed(17)
    content = torch.rand((2, 64, 64, 3), generator=gen) * 2 - 1
    style = torch.rand((2, 64, 64, 3), generator=gen) * 2 - 1
    got = getattr(prog, entry)(content, style, torch.Generator().manual_seed(3),
                               smooth_target=True)
    want = getattr(ref, entry)(content, style, torch.Generator().manual_seed(3), torch.float32,
                               smooth_target=True)
    assert got.shape == want.shape == (2, 64, 64, 3)
    assert (got - want).abs().max().item() < 1e-4


def test_serving_noise_is_the_programs(small_cell):
    """Noise drawn again in the program's dtype is the noise the program
    drew: with another generator seed the outputs part."""
    cell = small_cell("ppst512.stylize.b1", dtype="float32", fused_tap=False)
    prog, ref, _ = _models(cell)
    x = torch.rand((1, 64, 64, 3), generator=torch.Generator().manual_seed(1)) * 2 - 1
    y = x.flip(1)
    got = prog.stylize(x, y, torch.Generator().manual_seed(3))
    same = ref.stylize(x, y, torch.Generator().manual_seed(3), torch.float32)
    other = ref.stylize(x, y, torch.Generator().manual_seed(4), torch.float32)
    assert (got - same).abs().max().item() < 1e-4 < (got - other).abs().max().item()


def test_training_steps_match_the_program_in_float32(small_cell):
    cell = small_cell("ppst512.train.b2", dtype="float32", fused_tap=False)
    cell.own = dict(cell.own, limits={})  # every number the comparison takes
    run = Run(cell=cell, seed=2**31 + 7, seconds=0.01, traced=False, device=CPU)
    spec.driver("train").run(run, 0.0)
    numbers = {n: v for n, v, _ in run.checks}
    assert numbers["nonfinite_losses"] == 0.0
    assert numbers["loss_gap"] < 1e-6
    assert numbers["grad_gap"] < 1e-5 and numbers["change_gap"] < 1e-5


def test_reference_config_is_the_programs():
    from ppst_tpu_torch.models.config import PPSTConfig
    from reference.config import PPSTConfig as Reference

    assert [f.name for f in dataclasses.fields(PPSTConfig)] == \
        [f.name for f in dataclasses.fields(Reference)]
    assert dataclasses.asdict(PPSTConfig()) == dataclasses.asdict(Reference())


def test_lazy_r1_step_matches_the_program_in_float32(small_cell):
    """The D+R1 step (the window's every 16th D step) against the
    reference's, from the same weights, batch and noise."""
    from ppst_tpu_torch.train.steps import TrainSteps as ProgramSteps
    from reference.steps import TrainSteps as ReferenceSteps

    cell = small_cell("ppst512.train.b2", dtype="float32", fused_tap=False)
    prog, ref, _ = _models(cell)
    real = torch.rand((2, 64, 64, 3), generator=torch.Generator().manual_seed(5)) * 2 - 1
    mask = torch.nn.functional.one_hot(torch.randint(0, 3, (2, 64, 64)), 3).float()
    w = weights.make(program.configs(cell.config)[1], 2**31 + 101, CPU)
    prog.set_rscl_state(w["rscl"])
    ref.set_rscl_state({k: v.clone() for k, v in w["rscl"].items()})
    got = ProgramSteps(prog).d_step_r1(real, mask, torch.Generator().manual_seed(9))
    want = ReferenceSteps(ref).d_step_r1(real, mask, torch.Generator().manual_seed(9))
    assert set(got) == set(want) and "D_R1" in got
    assert all(abs(got[k].item() - want[k].item()) <= 1e-6 * max(1.0, abs(want[k].item()))
               for k in want)
    for (k, p), (_, q) in zip(prog.D.named_parameters(), ref.D.named_parameters()):
        assert torch.allclose(p, q, atol=1e-6), k
