"""Color guided filter on the device (counterpart of
``ppst_tpu/ops/guided_filter.py``; reference photo_gif.py:25-46,
``cv2.ximgproc.guidedFilter(radius=30, eps=(0.02*255)**2)``).

He et al., "Guided Image Filtering", color-guide variant, in float32. Box
means are banded 0/1-matrix products along H and W with the border-window
normalization folded into the band, as in the JAX package: a float32
cumulative sum over 512 pixel values of squares near 255^2 would cancel
badly. Border windows are truncated and normalized by their true count.
"""

from __future__ import annotations

import torch


def _box_matrix(n: int, r: int, device):
    """(n, n) matrix with M[i, j] = 1/count_i for |i-j| <= r else 0: one
    product computes the border-truncated 1-D box mean. Built on the
    device, so no host copy waits for the stream."""
    i = torch.arange(n, device=device)
    band = ((i[:, None] - i[None, :]).abs() <= r).float()
    counts = (torch.clamp(i + r, max=n - 1) - torch.clamp(i - r, min=0) + 1).float()
    return band / counts[:, None]


def _box_mean(x, mh, mw):
    """Windowed mean of (B, H, W, ...) ``x`` over H and W."""
    b, h, w = x.shape[:3]
    ch = x.shape[3:]
    y = torch.matmul(mh, x.reshape(b, h, -1)).reshape(b, h, w, -1).transpose(1, 2)
    y = torch.matmul(mw, y.reshape(b, w, -1)).reshape(b, w, h, -1).transpose(1, 2)
    return y.reshape((b, h, w) + ch)


def guided_filter(guide, src, radius: int = 30, eps: float = (0.02 * 255.0) ** 2):
    """Edge-preserving smoothing of ``src`` (B, H, W, C) guided by the color
    image ``guide`` (B, H, W, 3). ``eps`` is in squared units of the value
    range (the reference filters 0..255 images). Returns float32."""
    guide = guide.float()
    src = src.float()
    b, h, w, _ = guide.shape
    c = src.shape[-1]
    mh = _box_matrix(h, radius, guide.device)
    mw = mh if w == h else _box_matrix(w, radius, guide.device)

    mean_i = _box_mean(guide, mh, mw)
    mean_p = _box_mean(src, mh, mw)
    gg = (guide[..., :, None] * guide[..., None, :]).reshape(b, h, w, 9)
    gs = (guide[..., :, None] * src[..., None, :]).reshape(b, h, w, 3 * c)
    corr_ii = _box_mean(gg, mh, mw).reshape(b, h, w, 3, 3)
    corr_ip = _box_mean(gs, mh, mw).reshape(b, h, w, 3, c)

    var_i = corr_ii - mean_i[..., :, None] * mean_i[..., None, :]
    var_i = var_i + eps * torch.eye(3, dtype=var_i.dtype, device=var_i.device)
    cov_ip = corr_ip - mean_i[..., :, None] * mean_p[..., None, :]

    # solve var_i a = cov_ip per pixel through the explicit 3x3 adjugate
    m = var_i
    c00 = m[..., 1, 1] * m[..., 2, 2] - m[..., 1, 2] * m[..., 2, 1]
    c01 = m[..., 1, 2] * m[..., 2, 0] - m[..., 1, 0] * m[..., 2, 2]
    c02 = m[..., 1, 0] * m[..., 2, 1] - m[..., 1, 1] * m[..., 2, 0]
    det = m[..., 0, 0] * c00 + m[..., 0, 1] * c01 + m[..., 0, 2] * c02
    adj = torch.stack(
        [
            torch.stack([c00,
                         m[..., 0, 2] * m[..., 2, 1] - m[..., 0, 1] * m[..., 2, 2],
                         m[..., 0, 1] * m[..., 1, 2] - m[..., 0, 2] * m[..., 1, 1]], -1),
            torch.stack([c01,
                         m[..., 0, 0] * m[..., 2, 2] - m[..., 0, 2] * m[..., 2, 0],
                         m[..., 0, 2] * m[..., 1, 0] - m[..., 0, 0] * m[..., 1, 2]], -1),
            torch.stack([c02,
                         m[..., 0, 1] * m[..., 2, 0] - m[..., 0, 0] * m[..., 2, 1],
                         m[..., 0, 0] * m[..., 1, 1] - m[..., 0, 1] * m[..., 1, 0]], -1),
        ],
        dim=-2,
    )
    inv = adj / det[..., None, None]
    a = torch.sum(inv[..., :, :, None] * cov_ip[..., None, :, :], dim=-2)
    b_ = mean_p - torch.sum(a * mean_i[..., :, None], dim=-2)  # (B, H, W, C)

    mean_a = _box_mean(a.reshape(b, h, w, 3 * c), mh, mw).reshape(a.shape)
    mean_b = _box_mean(b_, mh, mw)
    return torch.sum(mean_a * guide[..., :, None], dim=-2) + mean_b
