"""Dataset base class and the preprocessing pipeline (counterpart of
``ppst_tpu/data/base_dataset.py``; reference data/base_dataset.py:85-153).

``--preprocess`` is matched by keyword (fixsize / resize / scale_width /
scale_shortside / scale_longside / zoom / centercrop / crop / trim), so
``scale_width_and_crop`` scales and then crops; every image is then snapped
to a multiple of 16, flipped at train time, and converted to float32 HWC in
[-1, 1]. All random choices of an item (flip, zoom, crop position) are drawn
once from the item's own RNG into a ``params`` dict shared by every tensor
of the item, so an image and its mask stay aligned.
"""

from __future__ import annotations

import random
from abc import ABC, abstractmethod

import numpy as np
from PIL import Image

BICUBIC = Image.BICUBIC


class BaseDataset(ABC):
    @staticmethod
    def modify_commandline_options(parser, is_train):
        return parser

    def __init__(self, opt):
        self.opt = opt
        self.epoch = 0
        self.seed = getattr(opt, "seed", 0)

    def set_epoch(self, epoch: int):
        """Per-epoch augmentation stream; called by the loader."""
        self.epoch = epoch

    def item_rng(self, index: int) -> random.Random:
        """Per-(seed, epoch, item) RNG: an item's draws never depend on the
        order items are loaded in, so every ``--nThreads`` gives the same
        batches."""
        return random.Random(((self.seed * 1000003) + self.epoch) * 1000003 + index)

    def replacement(self, index: int) -> int:
        """The item that stands in for an unreadable item ``index``: the JAX
        package's pick, ``item_rng(index).randrange(len(self))``; where that
        is ``index`` itself (the JAX package then recurses until the stack
        overflows), the next draw of the same RNG that is not."""
        rng = self.item_rng(index)
        pick = rng.randrange(len(self))
        while pick == index % len(self) and len(self) > 1:
            pick = rng.randrange(len(self))
        return pick

    @abstractmethod
    def __len__(self):
        ...

    @abstractmethod
    def __getitem__(self, index):
        ...


def sample_transform_params(opt, image_size, rng: random.Random):
    """Draw every random choice of one item at once, so that its paired
    tensors transform alike."""
    params = {"flip": False, "crop_pos": None, "zoom": None}
    if getattr(opt, "isTrain", False) and not getattr(opt, "no_flip", False):
        params["flip"] = rng.random() < 0.5
    if "zoom" in opt.preprocess:
        params["zoom"] = (rng.uniform(0.8, 1.0), rng.uniform(0.8, 1.0))
    if "crop" in opt.preprocess and "centercrop" not in opt.preprocess:
        params["crop_pos"] = (rng.random(), rng.random())  # relative; resolved later
    return params


def _scale_shortside(img, target, method):
    w, h = img.size
    s = min(w, h)
    if s == target:
        return img
    r = target / s
    return img.resize((round(w * r), round(h * r)), method)


def _scale_longside(img, target, method):
    w, h = img.size
    s = max(w, h)
    if s == target:
        return img
    r = target / s
    return img.resize((round(w * r), round(h * r)), method)


def _scale_width(img, target, method):
    w, h = img.size
    if w == target:
        return img
    return img.resize((target, round(h * target / w)), method)


def _make_power_2(img, base=16, method=BICUBIC):
    w, h = img.size
    nw, nh = round(w / base) * base, round(h / base) * base
    if (nw, nh) == (w, h):
        return img
    return img.resize((nw, nh), method)


def apply_transform(opt, img: Image.Image, params=None, method=BICUBIC):
    """PIL -> PIL through the configured geometric pipeline."""
    p = opt.preprocess
    if "fixsize" in p:
        img = img.resize((opt.load_size, opt.crop_size), method)
    if "resize" in p:
        img = img.resize((opt.load_size, opt.load_size), method)
    elif "scale_width" in p:
        img = _scale_width(img, opt.load_size, method)
    elif "scale_shortside" in p:
        img = _scale_shortside(img, opt.load_size, method)
    elif "scale_longside" in p:
        img = _scale_longside(img, opt.load_size, method)

    if "zoom" in p and params and params.get("zoom"):
        zw, zh = params["zoom"]
        w, h = img.size
        img = img.resize((max(opt.crop_size, round(w * zw)),
                          max(opt.crop_size, round(h * zh))), method)

    if "centercrop" in p:
        w, h = img.size
        c = opt.crop_size
        left, top = (w - c) // 2, (h - c) // 2
        img = img.crop((left, top, left + c, top + c))
    elif "crop" in p:
        w, h = img.size
        c = opt.crop_size
        if params and params.get("crop_pos") is not None:
            rx, ry = params["crop_pos"]
            left, top = int(rx * max(w - c, 0)), int(ry * max(h - c, 0))
        else:
            left, top = max(w - c, 0) // 2, max(h - c, 0) // 2
        img = img.crop((left, top, left + c, top + c))

    if "trim" in p:
        w, h = img.size
        c = opt.crop_size
        img = img.crop(((w - min(w, c)) // 2, (h - min(h, c)) // 2,
                        (w + min(w, c)) // 2, (h + min(h, c)) // 2))

    img = _make_power_2(img, 16, method)

    if params and params.get("flip"):
        img = img.transpose(Image.FLIP_LEFT_RIGHT)
    return img


def to_tensor(img: Image.Image, normalize=True) -> np.ndarray:
    """PIL -> float32 HWC; RGB in [-1, 1] when normalized, else [0, 1]."""
    arr = np.asarray(img, dtype=np.float32) / 255.0
    if arr.ndim == 2:
        arr = arr[:, :, None]
    if normalize:
        arr = (arr - 0.5) * 2.0
    return arr


def get_transform(opt, params=None, grayscale=False, method=BICUBIC, convert=True):
    """Callable mirroring the reference's get_transform: PIL in, float32 HWC
    out (PIL with ``convert=False``)."""

    def run(img):
        if grayscale and img.mode != "L":
            img = img.convert("L")
        img = apply_transform(opt, img, params, method)
        if convert:
            return to_tensor(img)
        return img

    return run
