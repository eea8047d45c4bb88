"""Image preprocessing of the CLI (counterpart of the ``resize`` and
``scale_shortside`` modes of ``ppst_tpu/data/base_dataset.py``; reference
data/base_dataset.py:85-153): resize, snap to a multiple of 16, convert to
float32 HWC in [-1, 1]."""

from __future__ import annotations

import numpy as np
from PIL import Image

BICUBIC = Image.BICUBIC


def _scale_shortside(img, target, method):
    w, h = img.size
    s = min(w, h)
    if s == target:
        return img
    r = target / s
    return img.resize((round(w * r), round(h * r)), method)


def _make_power_2(img, base=16, method=BICUBIC):
    w, h = img.size
    nw, nh = round(w / base) * base, round(h / base) * base
    if (nw, nh) == (w, h):
        return img
    return img.resize((nw, nh), method)


def apply_transform(opt, img: Image.Image, method=BICUBIC):
    """PIL -> PIL through the ``resize`` or ``scale_shortside`` pipeline."""
    if "resize" in opt.preprocess:
        img = img.resize((opt.load_size, opt.load_size), method)
    elif "scale_shortside" in opt.preprocess:
        img = _scale_shortside(img, opt.load_size, method)
    else:
        raise ValueError(f"--preprocess {opt.preprocess!r}: only 'resize' and "
                         "'scale_shortside' are ported")
    return _make_power_2(img, 16, method)


def to_tensor(img: Image.Image) -> np.ndarray:
    """PIL -> float32 HWC in [-1, 1]."""
    arr = np.asarray(img, dtype=np.float32) / 255.0
    if arr.ndim == 2:
        arr = arr[:, :, None]
    return (arr - 0.5) * 2.0


def get_transform(opt, method=BICUBIC):
    """Callable mirroring the reference's get_transform for the ported modes."""

    def run(img):
        return to_tensor(apply_transform(opt, img, method))

    return run
