"""Training entry point, run as ``python -m ppst_tpu_torch.train`` (counterpart
of the JAX package's ``train.py``; reference train.py).

The flags keep the JAX CLI's names and defaults (ppst_tpu/options,
options/flags.py, the optimizer's, the datasets', the iteration counter's
and the selected evaluators'), for every flag this package ports. Added:
``--device`` (CUDA unless ``--device cpu``; it raises when CUDA is asked for
and absent). Refused with a message: the serving evaluators, which run
through ``python -m ppst_tpu_torch.test``.

One process per GPU: ``torchrun --nproc_per_node N -m ppst_tpu_torch.train
--num_gpus N ...`` (or the JAX package's ``PPST_NUM_PROCESSES``,
``PPST_PROCESS_ID`` and ``PPST_COORDINATOR``) runs N ranks on NCCL (gloo
with ``--device cpu``); ``--num_gpus`` is the world size, or 0, and
``--batch_size`` the global batch, which ``2 * N`` must divide. Each rank
loads its slice of every batch and the ranks average their gradients
(``parallel``). Only rank 0 writes checkpoints, ``opt.txt``, ``iter.txt``
and ``loss_log.txt``; with more than one rank, snapshots and evaluations are
skipped, as in the JAX package (run ``python -m ppst_tpu_torch.test`` on
the checkpoints). ``--local-rank`` is accepted and ignored.

Every ``--save_freq`` images the loop saves a checkpoint in the background
(``ModelBundle.save(blocking=False)``); the last one, and one on SIGTERM or
SIGINT, wait for it and save on the loop. ``--profile_dir DIR`` writes a
``torch.profiler`` trace (CPU and CUDA) of the run's steps 10-14 as
``DIR/trace_rank<r>.json``, for chrome://tracing or Perfetto.

Every ``--display_freq`` images the loop saves a snapshot (real, layout,
reconstruction and style mix of the batch's first 4 images) as
``<checkpoints_dir>/<name>/snapshots/<images:09d>.png``; every
``--evaluation_freq`` images it runs the ``--evaluation_metrics``
evaluators on the loader, and feeds their metrics to the loss log. Both
draw their noise from a generator of their own, seeded from ``--seed`` and
the image count, so turning them on leaves the training losses as they were.

SIGTERM and SIGINT save a checkpoint before the process exits.
"""

from __future__ import annotations

import argparse
import contextlib
import os
import signal

import numpy as np
import torch

from ppst_tpu_torch import parallel
from ppst_tpu_torch.data import create_dataset
from ppst_tpu_torch.data.celebamask_dataset import CelebAMaskDataset
from ppst_tpu_torch.evaluation import GroupEvaluator
from ppst_tpu_torch.optimizers.ppst_optimizer import PPSTOptimizer
from ppst_tpu_torch.options import add_loader_flags, add_network_flags, str2bool
from ppst_tpu_torch.train.bundle import create_model
from ppst_tpu_torch.util.iter_counter import IterationCounter
from ppst_tpu_torch.util.metric_tracker import MetricTracker
from ppst_tpu_torch.util.util import save_image, tensor2im, tile_images
from ppst_tpu_torch.util.visualizer import Visualizer


def build_parser():
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    a = p.add_argument
    # base options (ppst_tpu/options/__init__.py)
    a("--name", type=str, required=True, help="name of the experiment")
    a("--num_gpus", type=int, default=1,
      help="the number of ranks the launcher started (torchrun's WORLD_SIZE), or 0")
    a("--checkpoints_dir", type=str, default="./checkpoints/")
    a("--model", type=str, default="ppst", choices=["ppst"])
    a("--optimizer", type=str, default="ppst", choices=["ppst"])
    a("--phase", type=str, default="train")
    a("--resume_iter", type=str, default="latest")
    a("--num_classes", type=int, default=0)
    a("--seed", type=int, default=0)
    a("--batch_size", type=int, default=2)
    add_loader_flags(p, "scale_width_and_crop")
    a("--shuffle_dataset", type=str, default=None, choices=("true", "false"))
    a("--dataroot", type=str, default=".")
    a("--dataroot2", type=str, default=".")
    a("--dataset_mode", type=str, default="celebamask", help="celebamask or synthetic")
    for name, default in (("netG", "StyleGAN2Resnet"), ("netD", "StyleGAN2"),
                          ("netE1", "StyleGAN2Resnet"), ("netE2", "StyleGAN2Resnet")):
        a(f"--{name}", default=default, choices=[default])
    a("--dtype", type=str, default="float32", choices=("float32", "bfloat16"))
    a("--remat_taps", type=str2bool, default=False)
    a("--remat_blocks", type=str2bool, default=False)
    a("--fused_tap", type=str2bool, default=False)
    a("--local-rank", type=int, default=0, help="accepted for launchers; unused")
    a("--profile_dir", type=str, default=None,
      help="write a torch.profiler trace of steps 10-14 to this directory")
    a("--debug_nan", type=str2bool, default=False)
    a("--continue_train", type=str2bool, default=False)
    a("--pretrained_name", type=str, default=None)
    # model and network flags (ppst_tpu/options/flags.py)
    add_network_flags(p)
    a("--training_stage", type=int, default=2)
    a("--match_kernel", type=int, default=1)
    for name, default in (("lambda_R1", 10.0), ("lambda_L1", 3.0), ("lambda_GAN", 1.0),
                          ("lambda_StyleCon", 1.0), ("lambda_Maskwarp", 10.0),
                          ("lambda_Cycwarp", 5.0), ("nce_T", 0.07)):
        a(f"--{name}", type=float, default=default)
    # optimizer (ppst_tpu/optimizers/ppst_optimizer.py)
    a("--lr", default=0.001, type=float)
    a("--beta1", default=0.0, type=float)
    a("--beta2", default=0.99, type=float)
    a("--R1_once_every", default=16, type=int)
    # datasets
    a("--synthetic_size", default=64, type=int)
    CelebAMaskDataset.modify_commandline_options(p, True)
    # iteration counter, evaluation and snapshots
    IterationCounter.modify_commandline_options(p, True)
    a("--evaluation_metrics", default="none")
    # this package
    a("--device", default="cuda")
    return p


def parse(argv=None):
    parser = build_parser()
    try:
        GroupEvaluator.modify_commandline_options(parser, True, argv)
        opt = parser.parse_args(argv)
        opt.isTrain = True
        GroupEvaluator(opt)
    except ValueError as e:
        parser.error(str(e))
    env = parallel.launch_env()
    world = env["world"] if env else 1
    if opt.num_gpus not in (0, world):
        parser.error(f"--num_gpus {opt.num_gpus} with {world} process(es): launch one "
                     "process per GPU (torchrun --nproc_per_node N) and pass --num_gpus N")
    return opt


def save_options(opt):
    if not parallel.is_primary():
        return
    path = os.path.join(opt.checkpoints_dir, opt.name)
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "opt.txt"), "w") as f:
        for k, v in sorted(vars(opt).items()):
            f.write(f"{k:>25}: {v}\n")


def side_generator(opt, device, steps: int) -> torch.Generator:
    """The noise of a snapshot or an evaluation at image count ``steps``:
    its own stream, so the training's draws stay as they were."""
    return torch.Generator(device=device).manual_seed(opt.seed * 1000003 + steps)


def save_snapshot(opt, optimizer, data_i, steps: int):
    """Rows real, layout, rec and mix of the batch's first 4 images, tiled."""
    visuals = optimizer.get_visuals_for_snapshot(
        data_i, side_generator(opt, optimizer.bundle.device, steps))
    rows = [tensor2im(v) for v in visuals.values()]
    grid = tile_images(np.concatenate(rows, 0), picturesPerRow=rows[0].shape[0])
    save_image(grid, os.path.join(opt.checkpoints_dir, opt.name, "snapshots",
                                  f"{steps:09d}.png"))


def step_profiler(profile_dir):
    """``--profile_dir``: a ``torch.profiler`` of the run's steps 10-14 (its
    11th to 15th), as the JAX package's ``jax.profiler`` window, written as
    ``trace_rank<r>.json``; the loop calls ``step()`` after each step, and
    the trace names the steps' ranges ``ProfilerStep#10`` to ``#14``. Without
    a directory, a context that yields None."""
    if not profile_dir:
        return contextlib.nullcontext()
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)

    def export(prof):
        os.makedirs(profile_dir, exist_ok=True)
        path = os.path.join(profile_dir, f"trace_rank{parallel.rank()}.json")
        prof.export_chrome_trace(path)
        print(f"[profile] steps 10-14 traced to {path}", flush=True)

    return torch.profiler.profile(
        activities=acts, on_trace_ready=export,
        schedule=torch.profiler.schedule(wait=9, warmup=1, active=5, repeat=1))


def main(argv=None):
    opt = parse(argv)
    opt.device = str(parallel.init(opt.device))
    world = parallel.world_size()
    if opt.batch_size % (2 * world):
        raise ValueError(f"--batch_size {opt.batch_size} is the global batch: 2 x {world} "
                         "process(es) must divide it (an even batch on every rank)")
    primary = parallel.is_primary()
    bundle = create_model(opt)
    save_options(opt)
    dataset = create_dataset(opt)
    iter_counter = IterationCounter(opt)
    visualizer = Visualizer(opt)
    metric_tracker = MetricTracker(opt)
    evaluators = GroupEvaluator(opt)
    optimizer = PPSTOptimizer(opt, bundle)

    def save_and_exit(signum, frame):
        print(f"signal {signum}: saving checkpoint before exit", flush=True)
        optimizer.save(iter_counter.steps_so_far)
        raise SystemExit(0)

    signal.signal(signal.SIGTERM, save_and_exit)
    signal.signal(signal.SIGINT, save_and_exit)

    with contextlib.closing(dataset), step_profiler(opt.profile_dir) as profiler:
        while not iter_counter.completed_training():
            with iter_counter.time_measurement("data"):
                cur_data = next(dataset)
            with iter_counter.time_measurement("train"):
                losses = optimizer.train_one_step(cur_data, iter_counter.steps_so_far)
                metric_tracker.update_metrics(losses, smoothe=True)
            steps = iter_counter.steps_so_far
            with iter_counter.time_measurement("maintenance"):
                if iter_counter.needs_printing():
                    visualizer.print_current_losses(steps, iter_counter.time_measurements,
                                                    metric_tracker.current_metrics())
                if iter_counter.needs_displaying() and world == 1:
                    save_snapshot(opt, optimizer, cur_data, steps)
                if iter_counter.needs_saving():
                    optimizer.save(steps, blocking=False)
                if iter_counter.needs_evaluation():
                    if world > 1:
                        if primary:
                            print("[eval] skipped under multi-host training; run test.py on "
                                  "the checkpoints instead")
                    else:
                        metrics = evaluators.evaluate(bundle.model, dataset, steps,
                                                      side_generator(opt, bundle.device, steps))
                        metric_tracker.update_metrics(metrics, smoothe=False)
                iter_counter.record_one_iteration()
            if profiler is not None:
                profiler.step()

    optimizer.save(iter_counter.steps_so_far)
    print("Training finished.")
    return bundle


if __name__ == "__main__":
    main()
