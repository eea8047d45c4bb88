"""Training entry point, run as ``python -m ppst_tpu_torch.train`` (counterpart
of the JAX package's ``train.py``; reference train.py).

The flags keep the JAX CLI's names and defaults (ppst_tpu/options,
options/flags.py, the optimizer's, the datasets', the iteration counter's
and the selected evaluators'), for every flag this package ports. Added:
``--device`` (CUDA unless ``--device cpu``; it raises when CUDA is asked for
and absent). Refused with a message: ``--native_io`` and ``--num_gpus``
above 1, which are not ported yet, and the serving evaluators, which run
through ``python -m ppst_tpu_torch.test``.

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
import os
import signal

import numpy as np
import torch

from ppst_tpu_torch.data import create_dataset
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
    a("--num_gpus", type=int, default=1)
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
    a("--native_io", type=str2bool, default=False)
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
    refused = []
    if opt.native_io:
        refused.append("--native_io")
    if opt.num_gpus != 1:
        refused.append("multi-GPU training (--num_gpus)")
    if refused:
        parser.error("not ported yet: " + "; ".join(refused))
    return opt


def save_options(opt):
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


def main(argv=None):
    opt = parse(argv)
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

    try:
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
                if iter_counter.needs_displaying():
                    save_snapshot(opt, optimizer, cur_data, steps)
                if iter_counter.needs_saving():
                    optimizer.save(steps)
                if iter_counter.needs_evaluation():
                    metrics = evaluators.evaluate(bundle.model, dataset, steps,
                                                  side_generator(opt, bundle.device, steps))
                    metric_tracker.update_metrics(metrics, smoothe=False)
                iter_counter.record_one_iteration()
    finally:
        dataset.close()

    optimizer.save(iter_counter.steps_so_far)
    print("Training finished.")
    return bundle


if __name__ == "__main__":
    main()
