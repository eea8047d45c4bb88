"""Unpaired image-folder dataset (counterpart of
``ppst_tpu/data/imagefolder_dataset.py``; reference
data/imagefolder_dataset.py), with what the grid evaluator needs: items
``{real_A, path_A}`` through the ``resize``/``scale_shortside`` transform, and
``iterate_batches`` to walk it once in order."""

from __future__ import annotations

import random

import numpy as np
from PIL import Image

from ppst_tpu_torch.data.base_dataset import get_transform
from ppst_tpu_torch.data.image_folder import make_dataset


class ImageFolderDataset:
    def __init__(self, opt):
        self.opt = opt
        self.A_paths = sorted(make_dataset(opt.dataroot))
        self.seed = getattr(opt, "seed", 0)
        self.transform = get_transform(opt)

    def __len__(self):
        return len(self.A_paths)

    def item_rng(self, index: int) -> random.Random:
        """Random draws of one item depend on the seed and the item alone,
        never on the order in which items are loaded."""
        return random.Random(self.seed * 1000003 + index)

    def __getitem__(self, index):
        path = self.A_paths[index % len(self)]
        try:
            img = Image.open(path).convert("RGB")
        except OSError as err:
            print(err)
            return self[self.item_rng(index).randrange(len(self))]
        return {"real_A": self.transform(img), "path_A": path}


def iterate_batches(dataset, batch_size: int):
    """One ordered pass over ``dataset`` in batches: ``real_A`` (B, H, W, 3)
    float32 numpy and ``path_A`` a list of B paths. Images of a batch must
    share one shape."""
    for lo in range(0, len(dataset), batch_size):
        items = [dataset[i] for i in range(lo, min(lo + batch_size, len(dataset)))]
        yield {"real_A": np.stack([it["real_A"] for it in items]),
               "path_A": [it["path_A"] for it in items]}
