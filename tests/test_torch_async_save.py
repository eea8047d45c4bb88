"""Background checkpoint saves (``ModelBundle.save(blocking=False)``), the
rank-0 gating of every file the training writes, and ``--profile_dir``, on
the CPU at NARROW."""

import json
import threading

import numpy as np
import pytest
import torch
from test_torch_train_common import NARROW, batch

from ppst_tpu_torch import parallel
from ppst_tpu_torch.optimizers.ppst_optimizer import PPSTOptimizer
from ppst_tpu_torch.options import TrainOptions
from ppst_tpu_torch.train import bundle as bundle_mod
from ppst_tpu_torch.train import cli
from ppst_tpu_torch.util.iter_counter import IterationCounter
from ppst_tpu_torch.util.visualizer import Visualizer

WIDTH_FLAGS = [f"--{k}={v}" for k, v in NARROW.items() if k != "crop_size"]


def _args(ckpt, *extra):
    return ["--device", "cpu", "--name", "run", "--checkpoints_dir", str(ckpt),
            "--dataset_mode", "synthetic", "--synthetic_size", "8", "--crop_size", "64",
            "--load_size", "64", "--batch_size", "2", "--nThreads", "1", *WIDTH_FLAGS, *extra]


@pytest.fixture
def trainer(tmp_path):
    """A NARROW bundle and optimizer after one D and one G step, so that
    every Adam holds moments."""
    opt = cli.parse(_args(tmp_path / "a"))
    bundle = bundle_mod.create_model(opt)
    optimizer = PPSTOptimizer(opt, bundle)
    real, mask = batch(seed=3)
    data = {"real_A": real, "mask_A": mask}
    for steps in (0, 2):
        optimizer.train_one_step(data, steps)
    return bundle, optimizer, data


def _load(path):
    return torch.load(path, map_location="cpu", weights_only=True)


def _flat(tree, prefix=""):
    if isinstance(tree, torch.Tensor):
        return {prefix: tree}
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}"))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(_flat(v, f"{prefix}/{i}"))
        return out
    return {prefix: tree}


def test_background_save_holds_the_state_at_its_step(trainer, tmp_path, monkeypatch):
    """A ``blocking=False`` save followed at once by a training step writes
    the state before the step: equal, leaf for leaf, to a blocking save of
    that state. The writer is held until the step has changed the weights
    and Adam's moments in place, so a save that read the live tensors would
    write the step's state (or a mix) and fail here."""
    bundle, optimizer, data = trainer
    bundle.opt.checkpoints_dir = str(tmp_path / "blocking")
    bundle.save(4)

    stepped = threading.Event()
    write = bundle._write

    def held_write(payload, steps):
        assert stepped.wait(120)
        return write(payload, steps)

    monkeypatch.setattr(bundle, "_write", held_write)
    bundle.opt.checkpoints_dir = str(tmp_path / "background")
    bundle.save(4, blocking=False)
    optimizer.train_one_step(data, 4)  # a D step: D and its Adam change in place
    stepped.set()
    bundle.join_pending_save()

    want = _flat(_load(tmp_path / "blocking" / "run" / "0k_checkpoint.pth"))
    got = _flat(_load(tmp_path / "background" / "run" / "latest_checkpoint.pth"))
    assert set(got) == set(want) and len(want) > 100
    for k, w in want.items():
        if isinstance(w, torch.Tensor):
            assert torch.equal(got[k], w), k
        else:
            assert got[k] == w, k
    # the step moved D's weights and its Adam state after the save began
    after = _flat(bundle._payload(4))
    moved = [k for k, w in want.items() if isinstance(w, torch.Tensor)
             and not torch.equal(after[k].cpu(), w)]
    assert len(moved) > 10 and all("D" in k for k in moved), moved[:5]


@pytest.mark.parametrize("surface", ["save", "join"])
def test_failing_writer_is_raised_at_the_next_save(trainer, tmp_path, monkeypatch, surface):
    """A writer's error does not pass silently: the next ``save`` (before it
    writes anything) or ``join_pending_save`` raises it, once."""
    bundle, _, _ = trainer
    bundle.opt.checkpoints_dir = str(tmp_path / "ck")

    def broken(payload, steps):
        raise OSError("disk full")

    monkeypatch.setattr(bundle, "_write", broken)
    bundle.save(2, blocking=False)
    with pytest.raises(RuntimeError, match="background checkpoint") as err:
        bundle.save(4) if surface == "save" else bundle.join_pending_save()
    assert isinstance(err.value.__cause__, OSError)
    monkeypatch.undo()
    bundle.save(6)  # the error was raised once; saving works again
    assert _load(tmp_path / "ck" / "run" / "0k_checkpoint.pth")["steps"] == 6


def test_other_ranks_write_nothing(trainer, tmp_path, monkeypatch):
    """On a rank other than 0, checkpoints (both kinds), ``opt.txt``,
    ``iter.txt`` and ``loss_log.txt`` are not written."""
    bundle, _, _ = trainer
    monkeypatch.setattr(parallel, "rank", lambda: 1)
    options = TrainOptions()
    opt = cli.parse(_args(tmp_path / "other", "--save_freq", "2"), options)
    bundle.opt = opt
    bundle.save(2)
    bundle.save(4, blocking=False)
    bundle.join_pending_save()
    options.save_options(opt)
    counter = IterationCounter(opt)
    counter.record_one_iteration()
    vis = Visualizer(opt)
    vis.print_current_losses(0, {}, {"D_real": 1.0})
    assert not (tmp_path / "other").exists()
    monkeypatch.undo()
    options.save_options(opt)
    assert (tmp_path / "other" / "run" / "opt.txt").exists()


def test_world_of_one_is_a_single_process(trainer):
    """Outside a launch the parallel helpers are the identity: rank 0 of 1,
    the gradients and losses untouched, the gather the tensor itself."""
    bundle, _, _ = trainer
    assert parallel.launch_env() is None
    assert (parallel.world_size(), parallel.rank(), parallel.is_primary()) == (1, 0, True)
    x = torch.arange(6.0).reshape(2, 3)
    assert parallel.average(x) is x and parallel.all_gather_cat(x, 1) is x
    g = torch.ones(3)
    p = torch.nn.Parameter(torch.zeros(3))
    p.grad = g
    parallel.average_grads([p])
    assert p.grad is g and torch.equal(g, torch.ones(3))
    assert bundle_mod.noise_seed(7, 0) == 7 and bundle_mod.noise_seed(7, 1) != 7


def test_profile_dir_traces_steps_10_to_14(tmp_path):
    """``--profile_dir`` on a 15-step run writes ``trace_rank0.json`` holding
    the ranges of steps 10-14 and no other step, with the steps' operators
    and the program's spans; ``opt.txt`` records the option; the final save waits for the last
    background one."""
    prof = tmp_path / "prof"
    cli.main(_args(tmp_path / "ck", "--total_nimgs", "30", "--save_freq", "8",
                   "--print_freq", "100", "--profile_dir", str(prof)))
    trace = json.loads((prof / "trace_rank0.json").read_text())
    names = [e.get("name", "") for e in trace["traceEvents"]]
    steps = sorted({int(n.split("#")[1]) for n in names if n.startswith("ProfilerStep#")})
    assert steps == [10, 11, 12, 13, 14]
    assert any(n.startswith("aten::conv") for n in names)
    # the program's spans: the loop's sections, each update's phases, a save (image 24)
    assert {f"ppst.{s}" for s in ("loop:data", "loop:train", "loop:maintenance", "step:inputs",
                                  "step:forward", "step:backward", "step:update", "step:fetch",
                                  "ckpt:save")} <= set(names)
    opt_txt = (tmp_path / "ck" / "run" / "opt.txt").read_text()
    assert f"profile_dir: {prof}" in opt_txt
    raw = _load(tmp_path / "ck" / "run" / "latest_checkpoint.pth")
    assert raw["steps"] == 30
    assert all(np.isfinite(v.numpy()).all() for v in raw["state_dict"].values())
