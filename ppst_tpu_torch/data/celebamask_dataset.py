"""CelebAMask-HQ paired image + mask dataset (counterpart of
``ppst_tpu/data/celebamask_dataset.py``; reference data/CelebAMask_dataset.py):
the RGB image from ``dataroot``, the 3-class mask (0 background, 1 face,
2 hair) from ``dataroot2``, one-hot to 3 channels. Image and mask share one
draw of the item's random transform. An unreadable pair is reported and
replaced by the item ``item_rng(index)`` picks, as in the JAX package (``replacement``)."""

from __future__ import annotations

import numpy as np
from PIL import Image

from ppst_tpu_torch.data.base_dataset import (
    BaseDataset,
    apply_transform,
    sample_transform_params,
    to_tensor,
)
from ppst_tpu_torch.data.image_folder import make_dataset


class CelebAMaskDataset(BaseDataset):
    NUM_CLASSES = 3

    def __init__(self, opt):
        super().__init__(opt)
        self.A_paths = sorted(make_dataset(opt.dataroot))
        self.B_paths = sorted(make_dataset(opt.dataroot2))
        assert len(self.A_paths) == len(self.B_paths), (
            f"image/mask count mismatch: {len(self.A_paths)} vs {len(self.B_paths)}")

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
        img = apply_transform(self.opt, img, params)
        msk = apply_transform(self.opt, msk, params, method=Image.NEAREST)
        labels = np.asarray(msk)
        one_hot = np.stack([(labels == i).astype(np.float32) for i in range(self.NUM_CLASSES)],
                           axis=-1)
        return {"real_A": to_tensor(img), "mask_A": one_hot, "path_A": a_path}
