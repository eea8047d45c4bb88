"""Deterministic synthetic dataset (no disk IO) for smoke runs and
benchmarks: random smooth "portraits" and blocky 3-class masks
(counterpart of ``ppst_tpu/data/synthetic_dataset.py``, item for item)."""

from __future__ import annotations

import numpy as np

from ppst_tpu_torch.data.base_dataset import BaseDataset


class SyntheticDataset(BaseDataset):
    @staticmethod
    def modify_commandline_options(parser, is_train):
        parser.add_argument("--synthetic_size", default=64, type=int)
        return parser

    def __init__(self, opt):
        super().__init__(opt)
        self.size = getattr(opt, "synthetic_size", 64)
        self.crop = opt.crop_size

    def __len__(self):
        return self.size

    def __getitem__(self, index):
        rng = np.random.default_rng(index)
        c = self.crop
        low = rng.standard_normal((c // 8, c // 8, 3)).astype(np.float32)
        img = np.clip(np.kron(low, np.ones((8, 8, 1), np.float32)) * 0.5, -1, 1)
        region = np.kron(rng.integers(0, 3, (c // 16, c // 16)), np.ones((16, 16), np.int64))
        mask = np.stack([(region == i).astype(np.float32) for i in range(3)], -1)
        return {"real_A": img, "mask_A": mask, "path_A": f"synthetic_{index}.png"}
