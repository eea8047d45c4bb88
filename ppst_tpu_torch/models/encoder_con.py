"""E1: content (structure) encoder (counterpart of
``ppst_tpu/models/encoder_con.py``; reference
models/networks/encoder_con.py:12-92): FromRGB 1x1 -> N downsampling
ResBlocks (reflection pad, instance norm, antialias blur) -> two 1x1 convs
-> structure code (B, H/2^N, W/2^N, spatial_code_ch).
"""

from __future__ import annotations

import torch.nn as nn

from ppst_tpu_torch.models.config import PPSTConfig
from ppst_tpu_torch.nn.layers import ConvLayer, ResBlock


class ContentEncoder(nn.Module):
    def __init__(self, cfg: PPSTConfig):
        super().__init__()
        n = cfg.netE_num_downsampling_sp
        self.FromRGB = ConvLayer(3, cfg.nc_e1(0), 1)
        self.DownToSpatialCode = nn.Sequential()
        for i in range(n):
            self.DownToSpatialCode.add_module(
                f"ResBlockDownBy{2 ** i}",
                ResBlock(cfg.nc_e1(i), cfg.nc_e1(i + 1), blur_kernel=cfg.e_blur_kernel,
                         norm="in"),
            )
        nch = cfg.nc_e1(n)
        self.ToSpatialCode = nn.Sequential(
            ConvLayer(nch, nch, 1, activate=True, bias=True, norm="in"),
            ConvLayer(nch, cfg.spatial_code_ch, 1, activate=False, bias=True, norm="in"),
        )

    def forward(self, x):
        return self.ToSpatialCode(self.DownToSpatialCode(self.FromRGB(x)))
