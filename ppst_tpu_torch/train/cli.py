"""Training entry point, run as ``python -m ppst_tpu_torch.train`` (counterpart
of the JAX package's ``train.py``; reference train.py).

The flags keep the JAX CLI's names and defaults (ppst_tpu/options,
options/flags.py, the optimizer's, the datasets' and the iteration
counter's), for every flag this package ports, but for ``--preprocess``,
which defaults to ``resize``: the canonical configuration's, and the only
training preprocess ported. Added: ``--device`` (CUDA unless ``--device
cpu``; it raises when CUDA is asked for and absent).
Refused with a message: ``--display_freq`` above 0 (training snapshots),
``--evaluation_metrics`` other than ``none`` (in-training evaluators),
``--native_io``, ``--num_gpus`` above 1 and the preprocess modes other than
``resize`` and ``scale_shortside``: none of them is ported yet.

SIGTERM and SIGINT save a checkpoint before the process exits.
"""

from __future__ import annotations

import argparse
import os
import signal

from ppst_tpu_torch.data import create_dataset
from ppst_tpu_torch.optimizers.ppst_optimizer import PPSTOptimizer
from ppst_tpu_torch.options import add_network_flags, str2bool
from ppst_tpu_torch.train.bundle import create_model
from ppst_tpu_torch.util.iter_counter import IterationCounter
from ppst_tpu_torch.util.metric_tracker import MetricTracker
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
    a("--preprocess", type=str, default="resize", choices=["resize", "scale_shortside"])
    a("--load_size", type=int, default=512)
    a("--crop_size", type=int, default=512)
    a("--no_flip", action="store_true")
    a("--shuffle_dataset", type=str, default=None, choices=("true", "false"))
    a("--dataroot", type=str, default=".")
    a("--dataroot2", type=str, default=".")
    a("--dataset_mode", type=str, default="celebamask", help="celebamask or synthetic")
    a("--nThreads", default=8, type=int)
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
    p.set_defaults(display_freq=0)
    a("--evaluation_metrics", default="none")
    # this package
    a("--device", default="cuda")
    return p


def parse(argv=None):
    parser = build_parser()
    opt = parser.parse_args(argv)
    opt.isTrain = True
    refused = []
    if opt.display_freq > 0:
        refused.append("training snapshots (--display_freq > 0)")
    if opt.evaluation_metrics != "none":
        refused.append(f"in-training evaluators (--evaluation_metrics {opt.evaluation_metrics})")
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


def main(argv=None):
    opt = parse(argv)
    bundle = create_model(opt)
    save_options(opt)
    dataset = create_dataset(opt)
    iter_counter = IterationCounter(opt)
    visualizer = Visualizer(opt)
    metric_tracker = MetricTracker(opt)
    optimizer = PPSTOptimizer(opt, bundle)

    def save_and_exit(signum, frame):
        print(f"signal {signum}: saving checkpoint before exit", flush=True)
        optimizer.save(iter_counter.steps_so_far)
        raise SystemExit(0)

    signal.signal(signal.SIGTERM, save_and_exit)
    signal.signal(signal.SIGINT, save_and_exit)

    while not iter_counter.completed_training():
        with iter_counter.time_measurement("data"):
            cur_data = next(dataset)
        with iter_counter.time_measurement("train"):
            losses = optimizer.train_one_step(cur_data, iter_counter.steps_so_far)
            metric_tracker.update_metrics(losses, smoothe=True)
        with iter_counter.time_measurement("maintenance"):
            if iter_counter.needs_printing():
                visualizer.print_current_losses(iter_counter.steps_so_far,
                                                iter_counter.time_measurements,
                                                metric_tracker.current_metrics())
            if iter_counter.needs_saving():
                optimizer.save(iter_counter.steps_so_far)
            iter_counter.record_one_iteration()

    optimizer.save(iter_counter.steps_so_far)
    print("Training finished.")
    return bundle


if __name__ == "__main__":
    main()
