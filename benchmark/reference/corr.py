"""Semantic correspondence ops: Rselfcorr, corrm, warp, and the blockwise
warp's plain version (frozen copies of the port's ``ppst_tpu_torch/ops/corr.py``
and ``corr_warp_cuda.py`` at commit afeb803; reference
models/ppst_model.py:330-387).

All tensors are NHWC. The correspondence ``corr`` is (B, Lq, Lk) with
L = H*W of the feature grid (4096 at 512px); ``corr[b, i, :]`` is a softmax
over source positions for target position i.

Rounding follows the JAX package: statistics and the softmax in float32,
descriptors rounded to the caller's dtype before their products, which
accumulate in float32.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

# The reference adds sys.float_info.epsilon to norms (ppst_model.py:333,357).
_NORM_EPS = float(np.finfo(np.float64).eps)


def rselfcorr(fea, patch: int = 4):
    """Patchwise self-correlation descriptor (reference ppst_model.py:330-339).

    Within each ``patch x patch`` window of ``fea`` (B, H, W, C), the pixel
    vectors are centered and L2-normalized over channels; the window's
    pixel-pixel Gram matrix becomes the output channels:
    (B, H/patch, W/patch, patch^4).
    """
    b, h, w, c = fea.shape
    ph, pw = h // patch, w // patch
    e = patch * patch
    v = fea.float()
    v = v - v.mean(-1, keepdim=True)
    v = v / (torch.linalg.vector_norm(v, dim=-1, keepdim=True) + _NORM_EPS)
    v = v.to(fea.dtype).reshape(b, ph, patch, pw, patch, c)
    v = v.permute(0, 1, 3, 2, 4, 5).reshape(b, ph, pw, e, c)
    gram = torch.matmul(v, v.transpose(-1, -2))
    return gram.reshape(b, ph, pw, e * e).to(fea.dtype)


def corrm(fea, fea0, temperature: float = 0.01, split: int = 256):
    """Dense correspondence matrix (reference ppst_model.py:341-364).

    The first ``split`` channels of ``fea``/``fea0`` (B, H, W, C) are
    mean-centered per position, then both are L2-normalized over channels.
    Returns ``softmax_j(<fea0_n[i], fea_n[j]> / temperature)``, (B, L, L).
    """
    in_dtype = fea.dtype

    def _norm(x):
        b, h, w, c = x.shape
        x = x.reshape(b, h * w, c).float()
        head = x[..., :split]
        head = head - head.mean(-1, keepdim=True)
        x = torch.cat([head, x[..., split:]], dim=-1)
        x = x / (torch.linalg.vector_norm(x, dim=-1, keepdim=True) + _NORM_EPS)
        return x.to(in_dtype)

    q = _norm(fea0)  # target positions (rows)
    k = _norm(fea)  # source positions (cols)
    # The logits must be float32 before the division by the temperature: a
    # bf16 product would be off by up to ~0.8 in a logit at T = 0.01. The
    # descriptors keep their rounding to the compute dtype; their products
    # are exact in float32 and accumulate there.
    logits = torch.matmul(q.float(), k.float().transpose(1, 2)) / temperature
    return torch.softmax(logits, dim=-1).to(in_dtype)


def warp(fea, corr, out_hw=None):
    """Attention-weighted resampling (reference ppst_model.py:366-387).

    ``fea`` is (B, h, w, C), ``corr`` (B, Lq, Lk). With h*w == Lk each pixel
    moves on its own (flat path). With h*w > Lk and Lq == Lk, each image is
    a grid of s x s blocks (s = sqrt(h*w/Lk)) that move as units.
    ``out_hw`` shapes the flat path's output grid when Lq != h*w.
    """
    b, h, w, c = fea.shape
    lq, lk = corr.shape[1], corr.shape[2]
    corr = corr.to(fea.dtype)
    if h * w != lk:
        assert lq == lk, "block-warp requires a square correspondence"
        s = int(round((h * w / lk) ** 0.5))
        assert s * s * lk == h * w, (
            f"warp: feature grid {h}x{w} incompatible with corr length {lk}"
        )
        ph, pw = h // s, w // s
        blocks = fea.reshape(b, ph, s, pw, s, c).permute(0, 1, 3, 2, 4, 5)
        out = torch.matmul(corr, blocks.reshape(b, ph * pw, s * s * c))
        out = out.reshape(b, ph, pw, s, s, c).permute(0, 1, 3, 2, 4, 5)
        return out.reshape(b, h, w, c)
    out = torch.matmul(corr, fea.reshape(b, h * w, c))
    if out_hw is None:
        if lq == h * w:
            out_hw = (h, w)
        else:
            g = int(round(lq**0.5))
            assert g * g == lq, "pass out_hw for non-square target grids"
            out_hw = (g, g)
    return out.reshape(b, out_hw[0], out_hw[1], c)


def adaptive_avg_pool(x, out_hw):
    """Average-pool NHWC ``x`` to ``out_hw``, which must divide evenly.

    bfloat16 inputs pool one axis at a time with float32 sums, rounding
    after each axis, as the JAX package's pooling matmuls do."""
    b, h, w, c = x.shape
    oh, ow = out_hw
    assert h % oh == 0 and w % ow == 0, f"adaptive pool {h}x{w} -> {oh}x{ow}"
    if oh == h and ow == w:
        return x
    if x.dtype == torch.bfloat16:
        y = x.reshape(b, oh, h // oh, w, c).mean(2, dtype=torch.float32).to(x.dtype)
        y = y.reshape(b, oh, ow, w // ow, c).mean(3, dtype=torch.float32)
        return y.to(x.dtype)
    return x.reshape(b, oh, h // oh, ow, w // ow, c).mean((2, 4))


def resize_bilinear(x, out_hw):
    """Bilinear resize at half-pixel centers without antialiasing (torch's
    ``F.interpolate(mode='bilinear', align_corners=False)``). An exact 2x
    downscale under these semantics is 2x2 mean pooling."""
    b, h, w, c = x.shape
    oh, ow = out_hw
    if h == 2 * oh and w == 2 * ow:
        return adaptive_avg_pool(x, out_hw)
    y = F.interpolate(x.permute(0, 3, 1, 2), size=(oh, ow), mode="bilinear",
                      align_corners=False, antialias=False)
    return y.permute(0, 2, 3, 1)


def warp_resize(fea, corr, out_hw=None):
    """E2's warp for scales above the correspondence grid (reference
    encoder_col.py:100-131): pool ``fea`` to the source grid, warp, then
    bilinear-upsample the target grid back by the same factor. ``out_hw``
    is the target grid; it defaults to the source grid."""
    b, h, w, c = fea.shape
    lk = corr.shape[2]
    s = int(round((h * w / lk) ** 0.5))
    assert s >= 1 and (h // s) * (w // s) == lk, (
        f"warp_resize: features {h}x{w} do not pool onto corr source {lk}"
    )
    warped = warp(adaptive_avg_pool(fea, (h // s, w // s)), corr, out_hw=out_hw)
    if s == 1:
        return warped
    return resize_bilinear(warped, (warped.shape[1] * s, warped.shape[2] * s))


def normalize_desc(x, split: int = 256):
    """corrm's descriptor prep on (B, L, C): center the first ``split``
    channels per position, L2-normalize over channels, in float32, rounded
    once to ``x``'s dtype."""
    x32 = x.float()
    head = x32[..., :split]
    x32 = torch.cat([head - head.mean(-1, keepdim=True), x32[..., split:]], dim=-1)
    x32 = x32 / (torch.linalg.vector_norm(x32, dim=-1, keepdim=True) + _NORM_EPS)
    return x32.to(x.dtype)


def corr_warp_blockwise(q, k, v, temperature: float = 0.01):
    """``softmax(q k^T / temperature) v`` with the dense float32 logits (the
    port's K3 computes it without them)."""
    logits = torch.matmul(q.float(), k.float().transpose(1, 2)) / temperature
    return torch.matmul(torch.softmax(logits, dim=-1), v.float()).to(v.dtype)
