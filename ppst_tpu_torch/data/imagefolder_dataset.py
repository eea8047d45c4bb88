"""Unpaired image-folder dataset (counterpart of
``ppst_tpu/data/imagefolder_dataset.py``; reference
data/imagefolder_dataset.py): items ``{real_A, path_A}`` through the
``--preprocess`` pipeline. An unreadable file is reported and replaced by
the item ``item_rng(index)`` picks, as in the JAX package (``replacement``)."""

from __future__ import annotations

from PIL import Image

from ppst_tpu_torch.data.base_dataset import (
    BaseDataset,
    apply_transform,
    sample_transform_params,
    to_tensor,
)
from ppst_tpu_torch.data.image_folder import make_dataset


class ImageFolderDataset(BaseDataset):
    def __init__(self, opt):
        super().__init__(opt)
        self.A_paths = sorted(make_dataset(opt.dataroot))

    def __len__(self):
        return len(self.A_paths)

    def __getitem__(self, index):
        path = self.A_paths[index % len(self)]
        try:
            img = Image.open(path).convert("RGB")
        except OSError as err:
            print(err)
            return self[self.replacement(index)]
        params = sample_transform_params(self.opt, img.size, self.item_rng(index))
        img = apply_transform(self.opt, img, params)
        return {"real_A": to_tensor(img), "path_A": path}
