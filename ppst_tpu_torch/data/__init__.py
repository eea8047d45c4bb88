"""Dataset registry and the training loader (counterpart of
``ppst_tpu/data/__init__.py``, single process).

``--dataset_mode foo`` -> module ``ppst_tpu_torch.data.foo_dataset`` -> class
``FooDataset``. ``ConfigurableDataLoader`` yields numpy batches forever at
train time, reshuffling every epoch with the JAX package's order
(``random.Random(1000 + epoch)``), so the two packages give the same batches;
items load on a thread pool of ``--nThreads`` in that order.
"""

from __future__ import annotations

import importlib
import random
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List

import numpy as np


def find_dataset_using_name(dataset_name: str):
    module = importlib.import_module(f"ppst_tpu_torch.data.{dataset_name.lower()}_dataset")
    target = dataset_name.replace("_", "") + "dataset"
    for name, cls in vars(module).items():
        if name.lower() == target.lower() and isinstance(cls, type):
            return cls
    raise NotImplementedError(f"no dataset class matching {dataset_name!r} in ppst_tpu_torch.data")


def create_dataset(opt):
    return ConfigurableDataLoader(opt)


def _collate(items: List[Dict]) -> Dict:
    out: Dict = {}
    for key in items[0]:
        vals = [it[key] for it in items]
        out[key] = np.stack(vals, 0) if isinstance(vals[0], np.ndarray) else vals
    return out


class ConfigurableDataLoader:
    """Batches of ``opt.batch_size`` items: at train time forever, dropping
    each epoch's ragged tail and reshuffling; otherwise one pass in order."""

    def __init__(self, opt):
        self.opt = opt
        self.phase = opt.phase
        self.dataset = find_dataset_using_name(opt.dataset_mode)(opt)
        self.repeat = self.shuffle = self.phase == "train"
        if self.phase != "train":
            self.shuffle = getattr(opt, "shuffle_dataset", None) == "true"
        self.batch_size = opt.batch_size
        self.length = len(self.dataset)
        self.pool = ThreadPoolExecutor(max(1, int(getattr(opt, "nThreads", 1) or 1)))
        self.epoch = 0
        self._batches = self._epoch()
        print(f"dataset [{type(self.dataset).__name__}] of size {self.length} was created. "
              f"shuffled={self.shuffle}")

    def _epoch_indices(self) -> List[int]:
        idx = list(range(self.length))
        if self.shuffle:
            random.Random(1000 + self.epoch).shuffle(idx)
        return idx

    def _epoch(self):
        if hasattr(self.dataset, "set_epoch"):
            self.dataset.set_epoch(self.epoch)
        idx = self._epoch_indices()
        bs = self.batch_size
        end = (len(idx) // bs) * bs if self.repeat else len(idx)
        for i in range(0, end, bs):
            yield _collate(list(self.pool.map(self.dataset.__getitem__, idx[i : i + bs])))

    def __iter__(self):
        return self

    def __len__(self):
        return self.length

    def __next__(self):
        try:
            return next(self._batches)
        except StopIteration:
            if not self.repeat:
                raise
            self.epoch += 1
            self._batches = self._epoch()
            return next(self._batches)
