"""The PIL-level smoothing filter (counterpart of the JAX package's
``smooth_filter.py``; the reference's ``smooth_filter(initImg, contentImg,
f_radius, f_edge)``): ``ops.smooth_filter.smooth_local_affine`` on the
card, or on ``device``."""

from __future__ import annotations

import numpy as np
import torch
from PIL import Image

from ppst_tpu_torch.models.ppst import resolve_device
from ppst_tpu_torch.ops.smooth_filter import smooth_local_affine


def smooth_filter(initImg, contentImg, f_radius: int = 15, f_edge: float = 1e-1,
                  device=None):
    """initImg: the stylized output, contentImg: the content image (each a
    path or a PIL image; the content is resized to the output's size).
    Runs on CUDA unless ``device`` names another (raises where CUDA is asked
    for and absent). Returns the smoothed PIL image."""
    device = resolve_device(device)
    if isinstance(initImg, str):
        initImg = Image.open(initImg).convert("RGB")
    if isinstance(contentImg, str):
        contentImg = Image.open(contentImg).convert("RGB")
    w, h = initImg.size
    contentImg = contentImg.resize((w, h))
    stylized = torch.from_numpy(np.asarray(initImg, np.float32)[None] / 255.0).to(device)
    content = torch.from_numpy(np.asarray(contentImg, np.float32)[None] / 255.0).to(device)
    out = smooth_local_affine(stylized, content, f_radius=f_radius, f_edge=f_edge)
    return Image.fromarray(np.uint8(np.clip(out[0].cpu().numpy() * 255.0, 0, 255)))
