"""Inference entry point: ``python -m ppst_tpu_torch.test`` (the reference's
``test.py``).

``--evaluation_metrics simple_swapping`` stylizes ``--input_structure_image``
with ``--input_texture_image``. ``content_style_grid_generation`` (alias
``content_style_1t1_generation``) stylizes every content image of
``--dataroot`` (those under a ``content/`` folder) with every other image
there, and writes the grid as an HTML page.

Runs on CUDA unless ``--device cpu`` is given, and refuses to start when
CUDA is asked for and absent. ``--checkpoint`` loads a reference ``.pth`` or
a checkpoint of ``python -m ppst_tpu_torch.train`` (with the network-shape
flags it was trained with); without it the weights are drawn from
``--seed``.
"""

from __future__ import annotations

import argparse

import torch

from ppst_tpu_torch.data.imagefolder_dataset import ImageFolderDataset, iterate_batches
from ppst_tpu_torch.evaluation import ALIASES, EVALUATORS, find_evaluator_using_name
from ppst_tpu_torch.models.config import PPSTConfig
from ppst_tpu_torch.models.ppst import PPSTModel, resolve_device
from ppst_tpu_torch.options import add_network_flags, str2bool

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def build_parser():
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--evaluation_metrics", default="simple_swapping",
                   choices=sorted(EVALUATORS) + sorted(ALIASES))
    p.add_argument("--input_structure_image", help="simple_swapping's content image")
    p.add_argument("--input_texture_image", help="simple_swapping's style image")
    p.add_argument("--dataroot", default=".", help="the grid's image folder")
    p.add_argument("--dataset_mode", default="imagefolder", choices=["imagefolder"])
    p.add_argument("--batch_size", type=int, default=2, help="images per loaded batch")
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
    return add_network_flags(p)


def main(argv=None):
    parser = build_parser()
    opt = parser.parse_args(argv)
    evaluator = find_evaluator_using_name(opt.evaluation_metrics)(opt)
    grid = opt.evaluation_metrics != "simple_swapping"
    if not grid and not (opt.input_structure_image and opt.input_texture_image):
        parser.error("simple_swapping needs --input_structure_image and --input_texture_image")
    device = resolve_device(opt.device)
    cfg = PPSTConfig.from_options(opt)
    model = PPSTModel(cfg, device=device, seed=opt.seed)
    if opt.checkpoint:
        model.load_reference_checkpoint(opt.checkpoint)
    generator = torch.Generator(device=device).manual_seed(opt.seed)
    if grid:
        batches = iterate_batches(ImageFolderDataset(opt), opt.batch_size)
        return evaluator.evaluate(model, batches, generator, _DTYPES[opt.dtype])
    return evaluator.evaluate(model, generator, _DTYPES[opt.dtype])


if __name__ == "__main__":
    main()
