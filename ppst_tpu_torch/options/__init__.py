"""The command line of ``python -m ppst_tpu_torch.train`` and
``python -m ppst_tpu_torch.test`` (counterpart of
``ppst_tpu/options/__init__.py``; reference options/__init__.py).

The JAX package's command lines run unchanged: the same base flags, the
same two-pass parse (``parse_known_args`` for the selection flags
``--optimizer``, ``--dataset_mode`` and ``--evaluation_metrics``, then each
selected plugin adds its flags, then a strict parse), the printed options,
and at train time ``opt.txt`` (every option, with ``[default: ...]`` where
it differs from its default) and ``opt.pkl`` (the namespace, pickled) under
``<checkpoints_dir>/<name>/``, by rank 0 of a ``torch.distributed`` group.
``--local-rank`` is accepted and unused.

This package adds two flags: ``--device`` (both CLIs; CUDA unless ``--device
cpu``) and ``--checkpoint`` (the test CLI's explicit checkpoint file, which
replaces the lookup of ``<checkpoints_dir>/<name>/<resume_iter>``).

``parse(command=...)`` takes a whole shell command line, as the JAX
package's does, and drops its program: ``python train.py ARGS`` or ``python
-m ppst_tpu_torch.train ARGS``; without one it reads ``sys.argv``.
"""

from __future__ import annotations

import argparse
import os
import pickle
import shlex

from ppst_tpu_torch import data, evaluation, optimizers, parallel
from ppst_tpu_torch.options.flags import add_model_flags, add_network_flags
from ppst_tpu_torch.util.iter_counter import IterationCounter
from ppst_tpu_torch.util.util import mkdirs, str2bool
from ppst_tpu_torch.util.visualizer import Visualizer

__all__ = ["AugmentedArgumentParser", "BaseOptions", "TestOptions", "TrainOptions",
           "add_loader_flags", "add_model_flags", "add_network_flags", "module_command",
           "program_args", "str2bool"]


def add_loader_flags(parser):
    """The loader's flags: its transform's and ``--nThreads``."""
    a = parser.add_argument
    a("--preprocess", type=str, default="scale_width_and_crop",
      help="keywords of the transform: fixsize, resize, scale_width, scale_shortside, "
           "scale_longside, zoom, centercrop, crop, trim (e.g. scale_width_and_crop)")
    a("--load_size", type=int, default=512)
    a("--crop_size", type=int, default=512)
    a("--preprocess_crop_padding", type=int, default=None,
      help="accepted for the JAX package's command lines; nothing reads it")
    a("--no_flip", action="store_true")
    a("--nThreads", default=8, type=int, help="threads loading the items of a batch")
    return parser


def module_command(module: str, argv) -> str | None:
    """The shell command line ``python -m module ARGS`` of the arguments
    ``argv``; None (``sys.argv``) for None."""
    return None if argv is None else shlex.join(["python", "-m", module, *argv])


def program_args(command: str) -> list:
    """The arguments of a shell command line, its program dropped: ``python
    train.py ARGS`` or ``python -m module ARGS``."""
    tokens = shlex.split(command)
    return tokens[3:] if tokens[1:2] == ["-m"] else tokens[2:]


class BaseOptions:
    def initialize(self, parser):
        a = parser.add_argument
        a("--name", type=str, required=True, help="name of the experiment")
        a("--easy_label", type=str, default="")
        a("--num_gpus", type=int, default=1,
          help="the number of ranks the launcher started (torchrun's WORLD_SIZE), or 0")
        a("--checkpoints_dir", type=str, default="./checkpoints/")
        a("--model", type=str, default="ppst")
        a("--optimizer", type=str, default="ppst")
        a("--phase", type=str, default="train")
        a("--resume_iter", type=str, default="latest",
          help="# iterations (in thousands) to resume")
        a("--num_classes", type=int, default=0)
        a("--seed", type=int, default=0)

        a("--batch_size", type=int, default=2)
        add_loader_flags(parser)
        a("--shuffle_dataset", type=str, default=None, choices=("true", "false"))

        a("--dataroot", type=str, default=".")
        a("--dataroot2", type=str, default=".")
        a("--dataset_mode", type=str, default="celebamask")

        a("--netG", default="StyleGAN2Resnet")
        a("--netD", default="StyleGAN2")
        a("--netE1", default="StyleGAN2Resnet")
        a("--netE2", default="StyleGAN2Resnet")
        a("--use_antialias", type=str2bool, default=True)

        a("--local-rank", type=int, default=0, help="accepted for launchers; unused")
        a("--dataname", type=str, default="results")
        a("--dtype", type=str, default="float32", choices=("float32", "bfloat16"),
          help="compute dtype for the conv stacks")
        a("--remat_taps", type=str2bool, default=False,
          help="recompute the generator's feature taps one at a time in the backward")
        a("--remat_blocks", type=str2bool, default=False,
          help="recompute the generator's resblocks one at a time in the backward")
        a("--fused_tap", type=str2bool, default=False,
          help="the fused 1x1 feature-tap kernel (bf16; differentiable)")
        a("--fused_styled_conv", type=str2bool, default=False,
          help="the fused StyledConv kernel for the generator's non-upsampled 3x3 convs "
               "(bf16; forward and backward)")
        a("--profile_dir", type=str, default=None,
          help="write a torch.profiler trace of steps 10-14 to this directory")
        a("--debug_nan", type=str2bool, default=False,
          help="raise on non-finite losses after every step")
        a("--device", type=str, default="cuda",
          help="cuda (the default; raises where there is none) or cpu")
        return parser

    def gather_options(self, command=None):
        parser = AugmentedArgumentParser()
        parser.custom_command = command
        parser = self.initialize(parser)

        opt, _ = parser.parse_known_args()

        parser = add_model_flags(parser, self.isTrain)
        parser = add_network_flags(parser, self.isTrain)
        parser = optimizers.get_option_setter(opt.optimizer)(parser, self.isTrain)
        parser = data.get_option_setter(opt.dataset_mode)(parser, self.isTrain)
        parser = Visualizer.modify_commandline_options(parser, self.isTrain)
        parser = IterationCounter.modify_commandline_options(parser, self.isTrain)
        parser = evaluation.get_option_setter()(parser, self.isTrain)

        opt = parser.parse_args()
        self.parser = parser
        return opt

    def format_options(self, opt) -> str:
        """Every option, sorted, with its default where it differs."""
        lines = []
        for k, v in sorted(vars(opt).items()):
            default = self.parser.get_default(k)
            comment = f"\t[default: {default}]" if v != default else ""
            lines.append("{:>25}: {:<30}{}\n".format(str(k), str(v), comment))
        return "".join(lines)

    def print_options(self, opt):
        print("----------------- Options ---------------\n" + self.format_options(opt)
              + "----------------- End -------------------")

    def option_file_path(self, opt, makedir=False):
        expr_dir = os.path.join(opt.checkpoints_dir, opt.name)
        if makedir:
            mkdirs(expr_dir)
        return os.path.join(expr_dir, "opt")

    def save_options(self, opt):
        """``opt.txt`` and ``opt.pkl``; under ``torch.distributed``, on rank 0
        only."""
        if not parallel.is_primary():
            return
        file_name = self.option_file_path(opt, makedir=True)
        with open(file_name + ".txt", "wt") as f:
            f.write(self.format_options(opt))
        with open(file_name + ".pkl", "wb") as f:
            pickle.dump(opt, f)

    def parse(self, command=None):
        """The options of ``command`` (a shell command line) or ``sys.argv``;
        at train time ``opt.txt`` and ``opt.pkl`` are written."""
        opt = self.gather_options(command)
        opt.isTrain = self.isTrain
        self.print_options(opt)
        if self.isTrain:
            self.save_options(opt)
        opt.dataroot = os.path.expanduser(opt.dataroot)
        assert opt.num_gpus <= opt.batch_size, "Batch size must not be smaller than num_gpus"
        return opt


class TrainOptions(BaseOptions):
    def __init__(self):
        self.isTrain = True

    def initialize(self, parser):
        super().initialize(parser)
        parser.add_argument("--continue_train", type=str2bool, default=False)
        parser.add_argument("--pretrained_name", type=str, default=None)
        return parser


class TestOptions(BaseOptions):
    def __init__(self):
        self.isTrain = False

    def initialize(self, parser):
        super().initialize(parser)
        parser.add_argument("--result_dir", type=str, default="results")
        parser.add_argument("--checkpoint", type=str, default=None,
                            help="a checkpoint file to serve instead of <checkpoints_dir>/"
                                 "<name>/<resume_iter>: a reference or port .pth, or a JAX "
                                 "package .msgpack")
        return parser


class AugmentedArgumentParser(argparse.ArgumentParser):
    """Parses the arguments of ``custom_command`` where no arguments are
    passed, and gives str2bool flags ``nargs="?"`` (a bare ``--flag`` is
    True), as the reference's parser does."""

    custom_command = None

    def _args(self, args):
        if args is None and self.custom_command:
            return program_args(self.custom_command)
        return args

    def parse_args(self, args=None, namespace=None):
        return super().parse_args(self._args(args), namespace)

    def parse_known_args(self, args=None, namespace=None):
        return super().parse_known_args(self._args(args), namespace)

    def add_argument(self, *args, **kwargs):
        if kwargs.get("type") is str2bool:
            kwargs.setdefault("nargs", "?")
            kwargs.setdefault("const", True)
        return super().add_argument(*args, **kwargs)
