"""Image quality metrics (counterpart of ``ppst_tpu/evaluation/metrics.py``).

SSIM follows Wang et al. 2004 with the 11-tap Gaussian window (sigma 1.5),
K1 = 0.01, K2 = 0.03, on NHWC images in [0, value_range], averaged over
pixels and channels; PSNR per image; LPIPS through ``ops.lpips``.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def _gaussian_window(size: int = 11, sigma: float = 1.5):
    x = np.arange(size) - size // 2
    g = np.exp(-(x**2) / (2 * sigma**2))
    return (g / g.sum()).astype(np.float32)


def _filter2d(x, taps):
    """Separable depthwise filter, VALID, of an NCHW tensor."""
    c = x.shape[1]
    k = torch.as_tensor(taps, dtype=x.dtype, device=x.device)
    x = F.conv2d(x, k.view(1, 1, -1, 1).expand(c, 1, -1, 1), groups=c)
    return F.conv2d(x, k.view(1, 1, 1, -1).expand(c, 1, 1, -1), groups=c)


def ssim(a, b, value_range: float = 1.0):
    """Mean SSIM of each image; ``a``, ``b``: (B, H, W, C) in [0, value_range]."""
    a = torch.as_tensor(a).float().permute(0, 3, 1, 2) / value_range
    b = torch.as_tensor(b).float().permute(0, 3, 1, 2) / value_range
    taps = _gaussian_window()
    c1, c2 = 0.01**2, 0.03**2
    mu_a = _filter2d(a, taps)
    mu_b = _filter2d(b, taps)
    # clamp the variances: E[x^2] - mu^2 cancels to slightly negative values
    # on near-flat windows, which would push SSIM above 1
    saa = (_filter2d(a * a, taps) - mu_a**2).clamp_min(0.0)
    sbb = (_filter2d(b * b, taps) - mu_b**2).clamp_min(0.0)
    sab = _filter2d(a * b, taps) - mu_a * mu_b
    num = (2 * mu_a * mu_b + c1) * (2 * sab + c2)
    den = (mu_a**2 + mu_b**2 + c1) * (saa + sbb + c2)
    return (num / den).mean(dim=(1, 2, 3))


def psnr(a, b, value_range: float = 1.0):
    a, b = torch.as_tensor(a).float(), torch.as_tensor(b).float()
    mse = ((a - b) ** 2).mean(dim=(1, 2, 3))
    return 10.0 * torch.log10(value_range**2 / mse.clamp_min(1e-12))


def lpips_distance(a, b, module=None):
    """LPIPS of NHWC images in [-1, 1] (a random-init backbone unless
    ``module`` carries weights, e.g. from ``ops.lpips.load_torch_lpips``)."""
    from ppst_tpu_torch.ops.lpips import LPIPS

    a = torch.as_tensor(a)
    module = module if module is not None else LPIPS().to(a.device)
    with torch.no_grad():
        return module(a, torch.as_tensor(b))
