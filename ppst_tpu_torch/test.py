"""Inference entry point: ``python -m ppst_tpu_torch.test`` (the reference's
``test.py``).

``--evaluation_metrics simple_swapping`` stylizes ``--input_structure_image``
with ``--input_texture_image``. ``content_style_grid_generation`` (alias
``content_style_1t1_generation``) stylizes every content image of
``--dataroot`` (those under a ``content/`` folder) with every other image
there, and writes the grid as an HTML page; ``--dataset_mode lmdb`` reads
them from a ``.pak`` file (``python -m ppst_tpu_torch.data.dataset_tools``),
whose keys keep the folder's relative paths. Any other value is a
comma-separated list of loader evaluators (``swap_visualization``, ``none``;
each may carry a ``train``/``test`` phase prefix), run by a
``GroupEvaluator`` on a loader over ``--dataroot``, as the JAX package's
``test.py`` runs them.

Runs on CUDA unless ``--device cpu`` is given, and refuses to start when
CUDA is asked for and absent. ``--checkpoint`` loads a reference ``.pth``, a
checkpoint of ``python -m ppst_tpu_torch.train`` or one of the JAX package
(``.msgpack``), with the network-shape flags it was trained with; without
it the weights are drawn from ``--seed``.
"""

from __future__ import annotations

import argparse

import torch

from ppst_tpu_torch.data import ConfigurableDataLoader
from ppst_tpu_torch.evaluation import GroupEvaluator, find_evaluator_using_name
from ppst_tpu_torch.evaluation.base_evaluator import BaseEvaluator
from ppst_tpu_torch.models.config import PPSTConfig
from ppst_tpu_torch.models.ppst import PPSTModel, resolve_device
from ppst_tpu_torch.options import add_loader_flags, add_network_flags, str2bool

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def build_parser():
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--evaluation_metrics", default="simple_swapping",
                   help="simple_swapping, content_style_grid_generation (or "
                        "content_style_1t1_generation), or a comma list of swap_visualization "
                        "and none")
    p.add_argument("--input_structure_image", help="simple_swapping's content image")
    p.add_argument("--input_texture_image", help="simple_swapping's style image")
    p.add_argument("--dataroot", default=".", help="the grid's and the loader's image folder")
    p.add_argument("--dataset_mode", default="imagefolder", choices=["imagefolder", "lmdb"],
                   help="imagefolder: --dataroot is a folder; lmdb: a .pak file (or an LMDB "
                        "directory, where the lmdb module is installed)")
    p.add_argument("--batch_size", type=int, default=2, help="images per loaded batch")
    p.add_argument("--texture_mix_alphas", type=float, nargs="+", default=[1.0],
                   help="weight(s) of the texture image: 1.0 = full swap, "
                        "0.0 = reconstruction")
    add_loader_flags(p, "scale_shortside")
    p.add_argument("--result_dir", default="results")
    p.add_argument("--name", default="ppst", help="experiment name (output subfolder)")
    p.add_argument("--dataname", default="results")
    p.add_argument("--dtype", default="float32", choices=sorted(_DTYPES))
    p.add_argument("--fused_tap", type=str2bool, default=False)
    p.add_argument("--device", default="cuda")
    p.add_argument("--checkpoint", default=None,
                   help="reference or port .pth, or JAX package .msgpack checkpoint")
    p.add_argument("--seed", type=int, default=0)
    return add_network_flags(p)


def serving_evaluator_class(metric: str):
    """The serving evaluator that ``metric`` names alone, else None (a list
    of loader evaluators, checked by ``GroupEvaluator``)."""
    try:
        cls = find_evaluator_using_name(metric)
    except ValueError:
        return None
    return None if issubclass(cls, BaseEvaluator) else cls


def main(argv=None):
    parser = build_parser()
    opt, _ = parser.parse_known_args(argv)
    serving = serving_evaluator_class(opt.evaluation_metrics)
    try:
        if serving is None:
            GroupEvaluator.modify_commandline_options(parser, False, argv)
        opt = parser.parse_args(argv)
        opt.isTrain, opt.phase = False, "test"
        evaluator = serving(opt) if serving else GroupEvaluator(opt)
    except ValueError as e:
        parser.error(str(e))
    swapping = opt.evaluation_metrics == "simple_swapping"
    if swapping and not (opt.input_structure_image and opt.input_texture_image):
        parser.error("simple_swapping needs --input_structure_image and --input_texture_image")
    device = resolve_device(opt.device)
    cfg = PPSTConfig.from_options(opt)
    model = PPSTModel(cfg, device=device, seed=opt.seed)
    if opt.checkpoint:
        model.load_reference_checkpoint(opt.checkpoint)
    generator = torch.Generator(device=device).manual_seed(opt.seed)
    dtype = _DTYPES[opt.dtype]
    if swapping:
        return evaluator.evaluate(model, generator, dtype)
    dataset = ConfigurableDataLoader(opt)
    try:
        if serving:
            return evaluator.evaluate(model, dataset, generator, dtype)
        return evaluator.evaluate(model, dataset, None, generator)
    finally:
        dataset.close()


if __name__ == "__main__":
    main()
