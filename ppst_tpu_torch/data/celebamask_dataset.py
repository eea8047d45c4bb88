"""CelebAMask-HQ paired image + mask dataset (counterpart of
``ppst_tpu/data/celebamask_dataset.py``; reference data/CelebAMask_dataset.py):
the RGB image from ``dataroot``, the 3-class mask (0 background, 1 face,
2 hair) from ``dataroot2``, one-hot to 3 channels. Image and mask share one
draw of the item's random transform. An unreadable pair is reported and
replaced by the item ``item_rng(index)`` picks, as in the JAX package (``replacement``).

``--native_io true`` under ``--preprocess resize`` takes the JAX package's
native path (``ppst_tpu/data/celebamask_dataset.py:70-81``): the image's
bilinear resize to ``load_size``, its [-1, 1] conversion with the flip, and
the mask's nearest resize and one-hot run in ``data/native.py``'s library,
and give the JAX package's native batches. Where the library does not build,
the dataset raises instead of falling back to PIL as the JAX package does;
other preprocess modes take the PIL path, as there."""

from __future__ import annotations

import numpy as np
from PIL import Image

from ppst_tpu_torch.data.base_dataset import (
    BaseDataset,
    apply_transform,
    sample_transform_params,
    to_tensor,
)
from ppst_tpu_torch.data import native
from ppst_tpu_torch.data.image_folder import make_dataset
from ppst_tpu_torch.util.util import str2bool


class CelebAMaskDataset(BaseDataset):
    NUM_CLASSES = 3

    @staticmethod
    def modify_commandline_options(parser, is_train):
        parser.add_argument("--native_io", type=str2bool, default=False,
                            help="the native resize / normalize / one-hot library "
                                 "(csrc/ppst_io.cpp) for --preprocess resize")
        return parser

    def __init__(self, opt):
        super().__init__(opt)
        self.A_paths = sorted(make_dataset(opt.dataroot))
        self.B_paths = sorted(make_dataset(opt.dataroot2))
        assert len(self.A_paths) == len(self.B_paths), (
            f"image/mask count mismatch: {len(self.A_paths)} vs {len(self.B_paths)}")
        self.native = getattr(opt, "native_io", False) and opt.preprocess == "resize"
        if self.native:
            native.library()  # raises where the library does not build

    def __len__(self):
        return len(self.A_paths)

    def __getitem__(self, index):
        a_path = self.A_paths[index % len(self)]
        b_path = self.B_paths[index % len(self)]
        try:
            img = Image.open(a_path).convert("RGB")
            msk = Image.open(b_path).convert("L")
        except OSError as err:
            print(err)
            return self[self.replacement(index)]
        params = sample_transform_params(self.opt, img.size, self.item_rng(index))
        if self.native:
            size = (self.opt.load_size, self.opt.load_size)
            flip = bool(params["flip"])
            labels = native.resize_u8(np.asarray(msk), size, nearest=True)[..., 0]
            return {"real_A": native.to_pm1(native.resize_u8(np.asarray(img), size), flip=flip),
                    "mask_A": native.one_hot_mask(labels, self.NUM_CLASSES, flip=flip),
                    "path_A": a_path}
        img = apply_transform(self.opt, img, params)
        msk = apply_transform(self.opt, msk, params, method=Image.NEAREST)
        labels = np.asarray(msk)
        one_hot = np.stack([(labels == i).astype(np.float32) for i in range(self.NUM_CLASSES)],
                           axis=-1)
        return {"real_A": to_tensor(img), "mask_A": one_hot, "path_A": a_path}
