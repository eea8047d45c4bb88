"""Dataset base class and image preprocessing (counterpart of the
``resize`` and ``scale_shortside`` modes of ``ppst_tpu/data/base_dataset.py``;
reference data/base_dataset.py:85-153): resize, snap to a multiple of 16,
flip at train time, convert to float32 HWC in [-1, 1]."""

from __future__ import annotations

import random
from abc import ABC, abstractmethod

import numpy as np
from PIL import Image

BICUBIC = Image.BICUBIC


class BaseDataset(ABC):
    def __init__(self, opt):
        self.opt = opt
        self.epoch = 0
        self.seed = getattr(opt, "seed", 0)

    def set_epoch(self, epoch: int):
        """Per-epoch augmentation stream; called by the loader."""
        self.epoch = epoch

    def item_rng(self, index: int) -> random.Random:
        """Per-(seed, epoch, item) RNG, the JAX package's: an item's
        augmentation never depends on the order items are loaded in."""
        return random.Random(((self.seed * 1000003) + self.epoch) * 1000003 + index)

    def draw_flip(self, index: int) -> bool:
        """The item's train-time horizontal flip (sample_transform_params)."""
        if not getattr(self.opt, "isTrain", False) or getattr(self.opt, "no_flip", False):
            return False
        return self.item_rng(index).random() < 0.5

    @abstractmethod
    def __len__(self):
        ...

    @abstractmethod
    def __getitem__(self, index):
        ...


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


def apply_transform(opt, img: Image.Image, method=BICUBIC, flip: bool = False):
    """PIL -> PIL through the ``resize`` or ``scale_shortside`` pipeline."""
    if "resize" in opt.preprocess:
        img = img.resize((opt.load_size, opt.load_size), method)
    elif "scale_shortside" in opt.preprocess:
        img = _scale_shortside(img, opt.load_size, method)
    else:
        raise ValueError(f"--preprocess {opt.preprocess!r}: only 'resize' and "
                         "'scale_shortside' are ported")
    img = _make_power_2(img, 16, method)
    return img.transpose(Image.FLIP_LEFT_RIGHT) if flip else img


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
