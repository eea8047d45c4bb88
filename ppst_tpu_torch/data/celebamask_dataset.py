"""CelebAMask-HQ paired image + mask dataset (counterpart of
``ppst_tpu/data/celebamask_dataset.py``; reference data/CelebAMask_dataset.py):
the RGB image from ``dataroot``, the 3-class mask (0 background, 1 face,
2 hair) from ``dataroot2``, one-hot to 3 channels. Image and mask share one
draw of the random flip, from the item's own RNG. Only the ``resize``
preprocess of the canonical configuration is ported (and ``scale_shortside``
with the inference CLI's pipeline)."""

from __future__ import annotations

import numpy as np
from PIL import Image

from ppst_tpu_torch.data.base_dataset import BaseDataset, apply_transform, to_tensor
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
        img = Image.open(self.A_paths[index]).convert("RGB")
        msk = Image.open(self.B_paths[index]).convert("L")
        flip = self.draw_flip(index)
        img = apply_transform(self.opt, img, flip=flip)
        msk = apply_transform(self.opt, msk, method=Image.NEAREST, flip=flip)
        labels = np.asarray(msk)
        one_hot = np.stack([(labels == i).astype(np.float32) for i in range(self.NUM_CLASSES)],
                           axis=-1)
        return {"real_A": to_tensor(img), "mask_A": one_hot, "path_A": self.A_paths[index]}
