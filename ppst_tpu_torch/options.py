"""CLI pieces shared by ``python -m ppst_tpu_torch.test`` and
``python -m ppst_tpu_torch.train``: the reference's boolean parsing, the
network-shape flags (ppst_tpu/options/flags.py's names and defaults), which
a checkpoint's reader must repeat from its training, ``--fused_styled_conv``
(a base option of ppst_tpu/options, shared by both CLIs) and the loader's
flags."""

from __future__ import annotations

import argparse


def str2bool(v):
    if v.lower() in ("yes", "true", "t", "y", "1"):
        return True
    if v.lower() in ("no", "false", "f", "n", "0"):
        return False
    raise argparse.ArgumentTypeError("Boolean value expected.")


def add_network_flags(parser):
    a = parser.add_argument
    for name, default in (("spatial_code_ch", 256), ("global_code_ch", 2048),
                          ("netE_num_downsampling_sp", 3), ("netE2_num_downsampling_gl1", 3),
                          ("netG_num_base_resnet_layers", 4), ("netG_resnet_ch", 256)):
        a(f"--{name}", type=int, default=default)
    for name in ("netE_scale_capacity", "netE2_scale_capacity", "netG_scale_capacity",
                 "netD_scale_capacity"):
        a(f"--{name}", type=float, default=1.0)
    for name in ("netE_nc_steepness", "netE2_nc_steepness"):
        a(f"--{name}", type=float, default=2.0)
    a("--netG_use_noise", type=str2bool, default=True)
    a("--use_antialias", type=str2bool, default=True)
    a("--fused_styled_conv", type=str2bool, default=False,
      help="fused StyledConv kernel for the generator's non-upsampled 3x3 convs "
           "(bf16; forward and backward)")
    return parser


def add_loader_flags(parser, preprocess: str):
    """The loader's flags, its transform's and ``--nThreads``
    (ppst_tpu/options/__init__.py's names), ``--preprocess`` defaulting to
    ``preprocess``."""
    a = parser.add_argument
    a("--preprocess", type=str, default=preprocess,
      help="keywords of the transform: fixsize, resize, scale_width, scale_shortside, "
           "scale_longside, zoom, centercrop, crop, trim (e.g. scale_width_and_crop)")
    a("--load_size", type=int, default=512)
    a("--crop_size", type=int, default=512)
    a("--preprocess_crop_padding", type=int, default=None,
      help="accepted for the JAX package's command lines; nothing reads it")
    a("--no_flip", action="store_true")
    a("--nThreads", default=8, type=int, help="threads loading the items of a batch")
    return parser
