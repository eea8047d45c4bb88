"""E2: color/style encoder, dense path (counterpart of
``ppst_tpu/models/encoder_col.py``; reference
models/networks/encoder_col.py:13-251).

FromRGB -> N downsampling ResBlocks; at the input scale and after each
block, GAP+GMP pooled statistics go through a 1x1 reducer and a 3-layer MLP
projector into an L2-normalized style vector (4 scales). With
``corrmatrix`` the features are first warped through the correspondence,
giving a parallel list of *warped* style vectors. The warp at the input
scale keeps the correspondence's gradient; deeper scales warp through a
detached one (reference encoder_col.py:207). With ``mask`` (3 regions,
max-pooled 2x per scale) the heads also project each region's masked
features, and the warped features under the batch-swapped mask, for the
RSCL loss.

Warp scale factors follow the actual correspondence grid (sqrt(L)), as in
the JAX package. ``corr_qk`` warps from normalized descriptors without a
dense matrix: through the blockwise kernel K3 (``ops.corr_warp_cuda``), or
with ``cfg.corr_blockwise`` through the differentiable checkpointed scan
(``ops.corr_blockwise.corr_warp_scan``, the training route).
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ppst_tpu_torch.models.config import PPSTConfig
from ppst_tpu_torch.nn.layers import ConvLayer, ResBlock, TorchConv2d, TorchLinear
from ppst_tpu_torch.ops.corr import adaptive_avg_pool, resize_bilinear, warp, warp_resize
from ppst_tpu_torch.ops.corr_blockwise import corr_warp_scan
from ppst_tpu_torch.ops.corr_warp_cuda import corr_warp_blockwise


class E2Output(NamedTuple):
    vectors: Tuple  # 4 x (B, style_dim) style vectors, coarse last
    vectors_w: Tuple  # warped variants (empty without corrmatrix)
    projections_m: Tuple = ()  # 12 x (B, style_dim): 3 regions per scale
    projections_mw: Tuple = ()  # the warped features' under the swapped mask


def l2_normalize(x, eps: float = 1e-12):
    """torch F.normalize(dim=-1) with the norm taken in float32."""
    x32 = x.float()
    n = torch.linalg.vector_norm(x32, dim=-1, keepdim=True)
    return (x32 / n.clamp_min(eps)).to(x.dtype)


def batch_swap(x):
    """Flip each consecutive pair in the batch (reference swap(),
    ppst_model.py:59-66)."""
    assert x.shape[0] % 2 == 0, "batch size must be a multiple of 2"
    y = x.reshape((x.shape[0] // 2, 2) + tuple(x.shape[1:]))
    return torch.flip(y, dims=(1,)).reshape(x.shape)


def _max_pool2(m):
    """2x2 / 2 max-pool of NHWC ``m``."""
    return F.max_pool2d(m.permute(0, 3, 1, 2), 2, 2).permute(0, 2, 3, 1)


def _projection_head(conv1x1, projector, feat):
    """cat(GAP, GMP) -> 1x1 reducer -> ReLU/MLP -> L2 normalize
    (reference encoder_col.py:47-93)."""
    y = torch.cat([feat.mean((1, 2)), feat.amax((1, 2))], dim=-1)
    y = conv1x1(y[:, None, None, :])[:, 0, 0, :]
    return l2_normalize(projector(y))


def _warp_features(x, corr, out_hw=None, fast_pool=False):
    """Warp current-scale features through the correspondence: pool to the
    corr source grid, warp, and resize back when above grid resolution.
    ``fast_pool`` skips the resize-back (see PPSTConfig.e2_fast_warp_pool)."""
    lk = corr.shape[2]
    h, w = x.shape[1], x.shape[2]
    if h * w < lk:
        # a scale below the correspondence grid (geometries the reference
        # does not support): upsample to the grid, warp, pool back
        g = int(round(lk**0.5))
        warped = warp(resize_bilinear(x, (g, g)), corr, out_hw=out_hw)
        return adaptive_avg_pool(warped, (h, w)) if out_hw is None else warped
    if h * w > lk:
        if fast_pool:
            s = int(round((h * w / lk) ** 0.5))
            return warp(adaptive_avg_pool(x, (h // s, w // s)), corr, out_hw=out_hw)
        return warp_resize(x, corr, out_hw=out_hw)
    return warp(x, corr, out_hw=out_hw)


def _warp_features_qk(x, q_desc, k_desc, out_hw=None, fast_pool=False,
                      warp_fn=corr_warp_blockwise):
    """Like ``_warp_features``, from normalized descriptors q (B, Lq, C) and
    k (B, Lk, C) through ``warp_fn`` (the blockwise kernel, or the training
    scan), never holding the Lq x Lk matrix: pool by s = sqrt(h*w/Lk), warp,
    and resize back unless ``fast_pool``."""
    b, h, w, c = x.shape
    lk, lq = k_desc.shape[1], q_desc.shape[1]
    if out_hw is None:
        g = int(round(lq**0.5))
        out_hw = (g, g)
    s = int(round((h * w / lk) ** 0.5))
    pooled = adaptive_avg_pool(x, (h // s, w // s)) if s > 1 else x
    warped = warp_fn(q_desc, k_desc, pooled.reshape(b, lk, c))
    warped = warped.reshape(b, out_hw[0], out_hw[1], c)
    if s > 1 and not fast_pool:
        warped = resize_bilinear(warped, (out_hw[0] * s, out_hw[1] * s))
    return warped


class ColorEncoder(nn.Module):
    def __init__(self, cfg: PPSTConfig):
        super().__init__()
        self.cfg = cfg
        n_down = cfg.netE2_num_downsampling_gl1
        self.FromRGB = ConvLayer(3, cfg.nc_e2(0), 1)
        self.DownToGlobalCode1 = nn.Sequential()
        for i in range(n_down):
            self.DownToGlobalCode1.add_module(
                f"ResBlockDownBy{2 ** i}",
                ResBlock(cfg.nc_e2(i), cfg.nc_e2(i + 1), blur_kernel=cfg.e_blur_kernel),
            )
        # heads: "9" at the input scale, then "0".."n_down-1" after each block
        for key, ch in [("9", cfg.nc_e2(0))] + [
            (str(i), cfg.nc_e2(i + 1)) for i in range(n_down)
        ]:
            sd = cfg.style_dim
            self.add_module(f"conv1x1_{key}", TorchConv2d(2 * ch, ch, 1))
            self.add_module(f"projector{key}", nn.Sequential(
                nn.ReLU(), TorchLinear(ch, max(sd // 2, 1), std=0.02),
                nn.ReLU(), TorchLinear(max(sd // 2, 1), sd, std=0.02),
                nn.ReLU(), TorchLinear(sd, sd, std=0.02),
            ))

    def _head(self, key, feat):
        return _projection_head(getattr(self, f"conv1x1_{key}"),
                                getattr(self, f"projector{key}"), feat)

    def forward(self, x, corrmatrix=None, corr_out_hw=None, trunk=None,
                return_trunk=False, warped_only=False, corr_qk=None, mask=None):
        """``corrmatrix``: dense (B, Lq, Lk) correspondence; ``corr_out_hw``
        the target (content) grid when it differs from the source grid.

        ``trunk``/``return_trunk``: the per-scale conv trunk features
        (FromRGB + the downsampling blocks). A staged pipeline that already
        ran E2 on the style image passes them back instead of recomputing
        them. ``warped_only`` skips the unwarped heads.

        ``corr_qk``: instead of ``corrmatrix``, a pair of normalized
        descriptors ((B, Lq, C), (B, Lk, C)) (``ops.corr_warp_cuda.
        normalize_desc``) warped through the blockwise kernel, or with
        ``cfg.corr_blockwise`` through ``corr_warp_scan`` in row blocks of
        ``cfg.corr_block``.

        ``mask``: (B, H, W, 3) region masks for ``projections_m`` and, with
        a correspondence, ``projections_mw``."""
        assert corrmatrix is None or corr_qk is None
        # fast_pool only where the warped features are purely pooled
        fast_pool = self.cfg.e2_fast_warp_pool and mask is None
        qk_warp = (functools.partial(corr_warp_scan, block=self.cfg.corr_block)
                   if self.cfg.corr_blockwise else corr_warp_blockwise)
        swapped = batch_swap(mask) if mask is not None else None
        blocks = list(self.DownToGlobalCode1)
        keys = ["9"] + [str(i) for i in range(len(blocks))]
        vectors, vectors_w, proj_m, proj_mw, trunk_out = [], [], [], [], []
        y = None
        for s, key in enumerate(keys):
            if trunk is not None:
                y = trunk[s]
            else:
                y = self.FromRGB(x) if s == 0 else blocks[s - 1](y)
            trunk_out.append(y)
            if s > 0 and mask is not None:
                mask, swapped = _max_pool2(mask), _max_pool2(swapped)
            if not warped_only:
                vectors.append(self._head(key, y))
            yw = None
            if corrmatrix is not None:
                corr = corrmatrix if s == 0 else corrmatrix.detach()
                yw = _warp_features(y, corr, corr_out_hw, fast_pool)
            elif corr_qk is not None:
                q, k = corr_qk if s == 0 else (corr_qk[0].detach(), corr_qk[1].detach())
                yw = _warp_features_qk(y, q, k, corr_out_hw, fast_pool, qk_warp)
            if yw is not None:
                vectors_w.append(self._head(key, yw))
            if mask is not None:
                for i in range(3):
                    proj_m.append(self._head(key, y * mask[..., i : i + 1]))
                    if yw is not None:
                        proj_mw.append(self._head(key, yw * swapped[..., i : i + 1]))
        out = E2Output(tuple(vectors), tuple(vectors_w), tuple(proj_m), tuple(proj_mw))
        return (out, tuple(trunk_out)) if return_trunk else out
