"""CLI pieces shared by ``python -m ppst_tpu_torch.test`` and
``python -m ppst_tpu_torch.train``: the reference's boolean parsing and the
network-shape flags (ppst_tpu/options/flags.py's names and defaults), which
a checkpoint's reader must repeat from its training, and ``--fused_styled_conv``
(a base option of ppst_tpu/options, shared by both CLIs)."""

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
