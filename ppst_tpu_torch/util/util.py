"""Image and style-code helpers of the CLI (counterpart of the live subset of
``ppst_tpu/util/util.py``; reference util/util.py)."""

from __future__ import annotations

import os

import numpy as np
import torch


def lerp(a, b, r):
    """Texture-code interpolation (reference util/util.py:32-35) on tensors
    or (nested) lists of style vectors."""
    if isinstance(a, (list, tuple)):
        return type(a)(lerp(x, y, r) for x, y in zip(a, b))
    return a * (1 - r) + b * r


def tensor2im(x) -> np.ndarray:
    """NHWC float [-1, 1] tensor or numpy array -> uint8 NHWC numpy (batch
    preserved)."""
    x = x.detach().float().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    return np.clip((x + 1.0) * 127.5, 0, 255).astype(np.uint8)


def save_image(img: np.ndarray, path: str):
    from PIL import Image

    os.makedirs(os.path.dirname(path), exist_ok=True)
    Image.fromarray(img).save(path)
