"""Training entry point, run as ``python -m ppst_tpu_torch.train`` (counterpart
of the JAX package's ``train.py``; reference train.py).

The JAX package's command lines run unchanged (``options.TrainOptions``:
its flags, the two-pass plugin parse, ``opt.txt`` and ``opt.pkl``), plus
``--device`` (CUDA unless ``--device cpu``; it raises when CUDA is asked for
and absent).

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

import contextlib
import os
import signal

import numpy as np
import torch

from ppst_tpu_torch import parallel
from ppst_tpu_torch.data import create_dataset
from ppst_tpu_torch.evaluation import GroupEvaluator
from ppst_tpu_torch.models.ppst import resolve_device
from ppst_tpu_torch.optimizers import create_optimizer
from ppst_tpu_torch.options import TrainOptions, module_command
from ppst_tpu_torch.train.bundle import create_model
from ppst_tpu_torch.util.iter_counter import IterationCounter
from ppst_tpu_torch.util.metric_tracker import MetricTracker
from ppst_tpu_torch.util.util import save_image, tensor2im, tile_images
from ppst_tpu_torch.util.visualizer import Visualizer


class CLITrainOptions(TrainOptions):
    """``TrainOptions`` checked against the launcher's world before rank 0
    writes ``opt.txt``: ``--num_gpus`` is its size or 0, and ``2 x`` its size
    divides the global ``--batch_size``. The process joins the world then,
    on ``--device`` (which must exist), and ``opt.device`` becomes its
    rank's device."""

    def gather_options(self, command=None):
        opt = super().gather_options(command)
        env = parallel.launch_env()
        world = env["world"] if env else 1
        if opt.num_gpus not in (0, world):
            self.parser.error(f"--num_gpus {opt.num_gpus} with {world} process(es): launch "
                              "one process per GPU (torchrun --nproc_per_node N) and pass "
                              "--num_gpus N")
        if opt.batch_size % (2 * world):
            raise ValueError(f"--batch_size {opt.batch_size} is the global batch: 2 x {world} "
                             "process(es) must divide it (an even batch on every rank)")
        opt.device = str(parallel.init(resolve_device(opt.device)))
        return opt


def parse(argv=None, options=None):
    """The training options of ``argv`` (``sys.argv`` by default), by
    ``options`` (``CLITrainOptions`` by default)."""
    return (options or CLITrainOptions()).parse(
        command=module_command("ppst_tpu_torch.train", argv))


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
    world, primary = parallel.world_size(), parallel.is_primary()
    bundle = create_model(opt)
    dataset = create_dataset(opt)
    iter_counter = IterationCounter(opt)
    visualizer = Visualizer(opt)
    metric_tracker = MetricTracker(opt)
    evaluators = GroupEvaluator(opt)
    optimizer = create_optimizer(opt, bundle)

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
