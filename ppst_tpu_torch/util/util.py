"""Image, style-code and option helpers (counterpart of the live subset of
``ppst_tpu/util/util.py``; reference util/util.py)."""

from __future__ import annotations

import argparse
import copy
import importlib
import os

import numpy as np
import torch


def str2bool(v):
    """The reference's boolean flag values (yes/no, true/false, t/f, y/n, 1/0)."""
    if v.lower() in ("yes", "true", "t", "y", "1"):
        return True
    if v.lower() in ("no", "false", "f", "n", "0"):
        return False
    raise argparse.ArgumentTypeError("Boolean value expected.")


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


def tile_images(imgs, picturesPerRow: int = 4):
    """(B, H, W, C) -> one image, ``picturesPerRow`` images a row, the last
    row padded with zeros."""
    b = imgs.shape[0]
    rows = []
    for i in range(0, b, picturesPerRow):
        row = imgs[i : i + picturesPerRow]
        if row.shape[0] < picturesPerRow:
            pad = np.zeros((picturesPerRow - row.shape[0],) + row.shape[1:], row.dtype)
            row = np.concatenate([row, pad], 0)
        rows.append(np.concatenate(list(row), axis=1))
    return np.concatenate(rows, axis=0)


def save_image(img: np.ndarray, path: str):
    from PIL import Image

    os.makedirs(os.path.dirname(path), exist_ok=True)
    Image.fromarray(img).save(path)


def mkdirs(paths):
    if isinstance(paths, (list, tuple)):
        for p in paths:
            os.makedirs(p, exist_ok=True)
    else:
        os.makedirs(paths, exist_ok=True)


def find_class_in_module(target_cls_name: str, module_name: str):
    """Case- and underscore-insensitive class lookup (the reference's plugin
    idiom, util/util.py:61-71)."""
    target = target_cls_name.replace("_", "").lower()
    module = importlib.import_module(module_name)
    for name, cls in vars(module).items():
        if name.lower() == target and isinstance(cls, type):
            return cls
    raise ValueError(f"class {target_cls_name} not found in {module_name}")


def copyconf(default_opt, **kwargs):
    """A shallow copy of the options with ``kwargs`` set on it."""
    conf = copy.copy(default_opt)
    for k, v in kwargs.items():
        setattr(conf, k, v)
    return conf


def visualize_spatial_code(sp):
    """The structure code (B, H, W, C) as 3 channels in [-1, 1] for the
    snapshots: its top three principal components over every position of
    the batch, each scaled to its range (reference util/util.py:231-255):
    a float32 numpy PCA on the host, as in the JAX package."""
    if isinstance(sp, torch.Tensor):
        sp = sp.detach().float().cpu().numpy()
    sp = np.asarray(sp)
    b, h, w, c = sp.shape
    flat = sp.reshape(-1, c)
    flat = flat - flat.mean(0)
    _, _, vt = np.linalg.svd(flat, full_matrices=False)
    proj = flat @ vt[:3].T
    lo, hi = proj.min(0), proj.max(0)
    proj = (proj - lo) / np.maximum(hi - lo, 1e-8) * 2.0 - 1.0
    return proj.reshape(b, h, w, 3)
