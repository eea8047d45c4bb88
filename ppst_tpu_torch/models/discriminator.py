"""D: StyleGAN2 discriminator wrapper (counterpart of
``ppst_tpu/models/discriminator.py``; reference
models/networks/discriminator.py:5-31: core at 2.0 * netD_scale_capacity)."""

from __future__ import annotations

import torch.nn as nn

from ppst_tpu_torch.models.config import PPSTConfig
from ppst_tpu_torch.nn.discriminator_core import StyleGAN2DiscriminatorCore


class Discriminator(nn.Module):
    def __init__(self, cfg: PPSTConfig):
        super().__init__()
        self.stylegan2_D = StyleGAN2DiscriminatorCore(
            cfg.crop_size, channel_multiplier=2.0 * cfg.netD_scale_capacity,
            blur_kernel=cfg.gd_blur_kernel)

    def forward(self, x):
        """(B, H, W, 3) images -> (B, 1) scores."""
        return self.stylegan2_D(x)
