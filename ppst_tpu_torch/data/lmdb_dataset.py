"""Packed image dataset, ``--dataset_mode lmdb`` (counterpart of
``ppst_tpu/data/lmdb_dataset.py``): ``--dataroot`` is a ``.pak`` file
(``data/packed.py``) or an LMDB directory where ``lmdb`` imports. Items are
``{real_A, path_A}`` with the pack's key as the path, through the
``--preprocess`` pipeline.

An item's random transform is drawn from its own RNG (``item_rng``), not
from one RNG shared by the loader's threads as in the JAX package, so the
batches are the same for every ``--nThreads``. Like the JAX package's, the
dataset carries no ``mask_A``: it serves the test-time loader (the grid and
the loader evaluators), not a training step.
"""

from __future__ import annotations

import io

from PIL import Image

from ppst_tpu_torch.data.base_dataset import (
    BaseDataset,
    apply_transform,
    sample_transform_params,
    to_tensor,
)
from ppst_tpu_torch.data.packed import open_reader


class LMDBDataset(BaseDataset):
    def __init__(self, opt):
        super().__init__(opt)
        self.reader = open_reader(opt.dataroot)

    def __len__(self):
        return len(self.reader)

    def __getitem__(self, index):
        key = self.reader.keys[index % len(self)]
        img = Image.open(io.BytesIO(self.reader.get(key))).convert("RGB")
        params = sample_transform_params(self.opt, img.size, self.item_rng(index))
        return {"real_A": to_tensor(apply_transform(self.opt, img, params)), "path_A": key}
