"""Photorealistic smoothing by local affine models (counterpart of
``ppst_tpu/ops/smooth_filter.py``; the reference's smooth_filter.py, three
NVRTC kernels that its pipeline never calls). The JAX package has no Pallas
kernel here, so neither has this port: plain PyTorch, NHWC in [0, 1].

1. best local affine: per pixel, the least-squares 3 x 4 affine map from
   content RGB to stylized RGB over a (2r+1)^2 window, from windowed normal
   equations (box sums of shifted copies; the JAX package takes them from
   running sums) with 1e-3 on the diagonal, solved as a batch of 4 x 4
   systems;
2. bilateral smoothing of the 12-dim affine field: spatial sigma
   f_radius / 3, range sigma f_edge on the content guide, summed over the
   window offsets in the JAX package's order (the range weight depends on
   the centre pixel, so it is not a convolution);
3. reconstruction: out = A_smoothed [content; 1].
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def _box_sum_axis(x, r: int, dim: int):
    """Border-truncated 1-D box sum along ``dim``: the 2r+1 shifted copies of
    the zero-padded ``x`` added in a fixed order, so that every device sums
    alike (a running sum over 512 pixels would round apart on the card)."""
    n = x.shape[dim]
    xp = F.pad(x, [0, 0] * (x.dim() - 1 - dim) + [r, r])
    out = xp.narrow(dim, 0, n)
    for k in range(1, 2 * r + 1):
        out = out + xp.narrow(dim, k, n)
    return out


def _box_sum(x, r: int):
    return _box_sum_axis(_box_sum_axis(x, r, 1), r, 2)


def _local_affine(content, stylized, radius: int = 1, diag: float = 1e-3):
    """Per-pixel 3 x 4 affine from windowed normal equations.
    content/stylized: (B, H, W, 3) in [0, 1]. Returns (B, H, W, 3, 4)."""
    ones = torch.ones(content.shape[:3] + (1,), dtype=content.dtype, device=content.device)
    basis = torch.cat([content, ones], dim=-1)
    mtm = _box_sum(basis[..., :, None] * basis[..., None, :], radius)
    mtm = mtm + diag * torch.eye(4, dtype=mtm.dtype, device=mtm.device)
    mts = _box_sum(basis[..., :, None] * stylized[..., None, :], radius)
    return torch.linalg.solve(mtm, mts).transpose(-1, -2)


def _bilateral_affine(affine, guide, radius: int, sigma1: float, sigma2: float):
    """The bilateral filter of the affine field ``affine`` (B, H, W, 12)
    guided by ``guide`` (B, H, W, 3); neighbours outside the image weigh 0."""
    b, h, w, _ = guide.shape
    r = radius
    # zero-padded copies and a validity mask stand in for JAX's masked rolls
    g_pad = F.pad(guide, (0, 0, r, r, r, r))
    a_pad = F.pad(affine, (0, 0, r, r, r, r))
    valid = F.pad(torch.ones((1, h, w, 1), dtype=guide.dtype, device=guide.device),
                  (0, 0, r, r, r, r))
    acc = torch.zeros_like(affine)
    wsum = torch.zeros(guide.shape[:3] + (1,), dtype=guide.dtype, device=guide.device)
    for dy in range(-r, r + 1):
        for dx in range(-r, r + 1):
            sw = np.float32(np.exp(-(dy * dy + dx * dx) / (2.0 * sigma1 * sigma1)))
            win = (slice(None), slice(r + dy, r + dy + h), slice(r + dx, r + dx + w))
            diff = torch.mean((g_pad[win] - guide) ** 2, dim=-1, keepdim=True)
            wgt = float(sw) * torch.exp(-diff / (2.0 * sigma2 * sigma2)) * valid[win]
            acc = acc + wgt * a_pad[win]
            wsum = wsum + wgt
    return acc / wsum


def smooth_local_affine(stylized, content, f_radius: int = 15, f_edge: float = 1e-1,
                        patch: int = 3):
    """NHWC [0, 1] float images -> the smoothed stylized image (B, H, W, 3)."""
    affine = _local_affine(content, stylized, radius=(patch - 1) // 2)
    b, h, w = affine.shape[:3]
    smoothed = _bilateral_affine(affine.reshape(b, h, w, 12), content, radius=f_radius,
                                 sigma1=f_radius / 3.0, sigma2=f_edge).reshape(b, h, w, 3, 4)
    ones = torch.ones((b, h, w, 1), dtype=content.dtype, device=content.device)
    basis = torch.cat([content, ones], dim=-1)
    return torch.einsum("bhwij,bhwj->bhwi", smoothed, basis)
