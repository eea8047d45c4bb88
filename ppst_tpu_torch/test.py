"""Inference entry point: ``python -m ppst_tpu_torch.test`` (the reference's
``test.py --evaluation_metrics simple_swapping``).

Runs on CUDA unless ``--device cpu`` is given, and refuses to start when
CUDA is asked for and absent. ``--checkpoint`` loads a reference ``.pth``;
without it the weights are drawn from ``--seed``.
"""

from __future__ import annotations

import argparse

import torch

from ppst_tpu_torch.evaluation.simple_swapping_evaluator import SimpleSwappingEvaluator
from ppst_tpu_torch.models.config import PPSTConfig
from ppst_tpu_torch.models.ppst import PPSTModel, resolve_device

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def str2bool(v):
    if v.lower() in ("yes", "true", "t", "y", "1"):
        return True
    if v.lower() in ("no", "false", "f", "n", "0"):
        return False
    raise argparse.ArgumentTypeError("Boolean value expected.")


def build_parser():
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--evaluation_metrics", default="simple_swapping",
                   choices=["simple_swapping"])
    p.add_argument("--input_structure_image", required=True)
    p.add_argument("--input_texture_image", required=True)
    p.add_argument("--texture_mix_alphas", type=float, nargs="+", default=[1.0],
                   help="weight(s) of the texture image: 1.0 = full swap, "
                        "0.0 = reconstruction")
    p.add_argument("--preprocess", default="scale_shortside",
                   choices=["resize", "scale_shortside"])
    p.add_argument("--load_size", type=int, default=512)
    p.add_argument("--crop_size", type=int, default=512)
    p.add_argument("--result_dir", default="results")
    p.add_argument("--name", default="ppst", help="experiment name (output subfolder)")
    p.add_argument("--dataname", default="results")
    p.add_argument("--dtype", default="float32", choices=sorted(_DTYPES))
    p.add_argument("--fused_tap", type=str2bool, default=False)
    p.add_argument("--device", default="cuda")
    p.add_argument("--checkpoint", default=None, help="reference .pth state_dict")
    p.add_argument("--seed", type=int, default=0)
    return p


def main(argv=None):
    opt = build_parser().parse_args(argv)
    device = resolve_device(opt.device)
    cfg = PPSTConfig(crop_size=opt.crop_size, dtype=opt.dtype, fused_tap=opt.fused_tap)
    model = PPSTModel(cfg, device=device, seed=opt.seed)
    if opt.checkpoint:
        model.load_reference_checkpoint(opt.checkpoint)
    generator = torch.Generator(device=device).manual_seed(opt.seed)
    return SimpleSwappingEvaluator(opt).evaluate(model, generator, _DTYPES[opt.dtype])


if __name__ == "__main__":
    main()
