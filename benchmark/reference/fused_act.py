"""Bias + LeakyReLU + gain (counterpart of ``ppst_tpu/ops/fused_act.py``;
reference fused_act.py:93-96: ``F.leaky_relu(input + bias, slope) * scale``).

Plain PyTorch: on the main path the op follows a convolution and is
elementwise; the TPU kernel for it (``fused_act_pallas``) is off that path.
"""

import math

import torch

SQRT2 = math.sqrt(2.0)


def fused_leaky_relu(x, bias=None, negative_slope: float = 0.2, scale: float = SQRT2):
    """``leaky_relu(x + bias[channel]) * scale`` on NHWC (or (..., C)) ``x``."""
    if bias is not None:
        x = x + bias.to(x.dtype)
    return torch.where(x >= 0, x, x * negative_slope) * scale


def scaled_leaky_relu(x, negative_slope: float = 0.2):
    """ScaledLeakyReLU (reference stylegan2_layers.py:350-359)."""
    return torch.where(x >= 0, x, x * negative_slope) * SQRT2
