"""StyleGAN2 discriminator pyramid (counterpart of
``ppst_tpu/nn/discriminator_core.py``; reference stylegan2_layers.py:582-649).

Children carry the reference's names, which ``ppst_tpu/util/convert_torch.py``
(``convert_d``) reads: ``convs.0`` (from RGB), ``convs.<9 - i>`` for the
ResBlock at 2^i (``convs.<s>x<s>`` above 256), ``final_conv``,
``final_linear.0`` and ``final_linear.1``.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch.nn as nn

from reference.layers import ConvLayer, EqualLinear, ResBlock


def channel_schedule(channel_multiplier: float) -> dict:
    return {
        4: 512,
        8: 512,
        16: min(512, int(512 * channel_multiplier)),
        32: min(512, int(512 * channel_multiplier)),
        64: int(256 * channel_multiplier),
        128: int(128 * channel_multiplier),
        256: int(64 * channel_multiplier),
        512: int(32 * channel_multiplier),
        1024: int(16 * channel_multiplier),
    }


class StyleGAN2DiscriminatorCore(nn.Module):
    """Log2 pyramid of ResBlocks from image resolution down to 4x4, then a
    3x3 conv and a two-layer equalized MLP head. The reference's
    minibatch-stddev is commented out there and omitted here too."""

    def __init__(self, size: int, channel_multiplier: float = 2.0,
                 blur_kernel: Sequence[int] = (1, 3, 3, 1)):
        super().__init__()
        channels = channel_schedule(channel_multiplier)
        size = 2 ** int(round(math.log2(size)))
        log_size = int(math.log2(size))
        self.convs = nn.Sequential()
        self.convs.add_module("0", ConvLayer(3, channels[size], 1))
        for i in range(log_size, 2, -1):
            name = str(9 - i) if i <= 8 else f"{2 ** i}x{2 ** i}"
            self.convs.add_module(name, ResBlock(channels[2 ** i], channels[2 ** (i - 1)],
                                                 blur_kernel=blur_kernel, reflection_pad=False))
        self.final_conv = ConvLayer(channels[4], channels[4], 3)
        self.final_linear = nn.Sequential(
            EqualLinear(channels[4] * 4 * 4, channels[4], activation="fused_lrelu"),
            EqualLinear(channels[4], 1))

    def forward(self, x):
        y = self.final_conv(self.convs(x))
        # NCHW flatten order (C, H, W), as the reference's linear head reads it
        return self.final_linear(y.permute(0, 3, 1, 2).reshape(y.shape[0], -1))
