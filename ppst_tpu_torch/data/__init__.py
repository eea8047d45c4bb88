"""Dataset registry and the loader (counterpart of ``ppst_tpu/data/__init__.py``).

``--dataset_mode foo`` -> module ``ppst_tpu_torch.data.foo_dataset`` -> class
``FooDataset``. ``ConfigurableDataLoader`` yields numpy batches: at train time
forever, reshuffling every epoch with the JAX package's order
(``random.Random(1000 + epoch)``); in any other phase one pass, in order
unless ``--shuffle_dataset true``. A producer thread loads batches
``PREFETCH`` ahead of the consumer, each item on a pool of ``--nThreads``
threads, so loading overlaps the training step; batch order and content
are those of the JAX package for every ``--nThreads``. ``set_phase`` stops
the producer and rebuilds the dataset for another phase.

Under ``torch.distributed`` the training phase's rank ``r`` of ``world``
loads only its contiguous slice ``idx[i + r·per : i + (r+1)·per]`` of each
global batch, ``per = batch_size / world`` (the reference's
DistributedSampler, ``ppst_tpu/data/__init__.py:96-98``): ``--batch_size``
stays the global batch, and every rank shuffles with the same epoch seed.
"""

from __future__ import annotations

import importlib
import queue
import random
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List

import numpy as np

from ppst_tpu_torch import parallel
from ppst_tpu_torch.data.base_dataset import BaseDataset
from ppst_tpu_torch.util.util import copyconf


def find_dataset_using_name(dataset_name: str):
    module = importlib.import_module(f"ppst_tpu_torch.data.{dataset_name.lower()}_dataset")
    target = dataset_name.replace("_", "") + "dataset"
    for name, cls in vars(module).items():
        if name.lower() == target.lower() and isinstance(cls, type) and issubclass(cls,
                                                                                   BaseDataset):
            return cls
    raise NotImplementedError(f"no BaseDataset subclass matching {dataset_name!r} in "
                              "ppst_tpu_torch.data")


def get_option_setter(dataset_name: str):
    """The flags of ``--dataset_mode`` (the name lower-cased, as the module's)."""
    return find_dataset_using_name(dataset_name).modify_commandline_options


def create_dataset(opt):
    return ConfigurableDataLoader(opt)


def _collate(items: List[Dict]) -> Dict:
    out: Dict = {}
    for key in items[0]:
        vals = [it[key] for it in items]
        out[key] = np.stack(vals, 0) if isinstance(vals[0], np.ndarray) else vals
    return out


class _Failed:
    """A producer's exception, carried through the queue to the consumer."""

    def __init__(self, error: BaseException):
        self.error = error


class ConfigurableDataLoader:
    PREFETCH = 2

    def __init__(self, opt):
        self.opt = opt
        self._worker = None
        self.initialize(opt.phase)

    def initialize(self, phase: str):
        opt = self.opt
        self.phase = phase
        self.dataset = find_dataset_using_name(opt.dataset_mode)(
            copyconf(opt, phase=phase, isTrain=phase == "train"))
        self.repeat = phase == "train"
        self.shuffle = True if phase == "train" else getattr(opt, "shuffle_dataset",
                                                             None) == "true"
        self.batch_size = opt.batch_size
        self.num_shards, self.shard_rank = ((parallel.world_size(), parallel.rank())
                                            if phase == "train" else (1, 0))
        if self.batch_size % self.num_shards:
            raise ValueError(f"batch_size {self.batch_size} must be divisible by the "
                             f"process count {self.num_shards}")
        self.length = len(self.dataset)
        self.epoch = 0
        self._start_epoch()
        print(f"dataset [{type(self.dataset).__name__}] of size {self.length} was created. "
              f"shuffled={self.shuffle}")

    def set_phase(self, target_phase: str):
        if self.phase != target_phase:
            self._stop_worker()
            self.initialize(target_phase)

    def close(self):
        """Stop the producer and its pool."""
        self._stop_worker()

    # -- iteration -------------------------------------------------------

    def _epoch_indices(self) -> List[int]:
        idx = list(range(self.length))
        if self.shuffle:
            random.Random(1000 + self.epoch).shuffle(idx)
        return idx

    def _start_epoch(self):
        self._stop_worker()
        self.dataset.set_epoch(self.epoch)
        self._queue: queue.Queue = queue.Queue(maxsize=self.PREFETCH)
        self._consumed = False
        self._stop = threading.Event()
        self._worker = threading.Thread(target=self._produce, name="ppst-loader", daemon=True)
        self._worker.start()

    def _produce(self):
        idx = self._epoch_indices()
        bs = self.batch_size
        end = (len(idx) // bs) * bs if self.repeat else len(idx)
        per = bs // self.num_shards
        lo = self.shard_rank * per
        n_threads = max(1, int(getattr(self.opt, "nThreads", 1) or 1))
        # items of a batch load on the pool in order (map keeps it), and
        # draw from their own RNGs: the batches do not depend on n_threads
        pool = (ThreadPoolExecutor(n_threads, thread_name_prefix="ppst-loader-pool")
                if n_threads > 1 else None)
        try:
            ds = self.dataset
            for i in range(0, end, bs):
                if self._stop.is_set():
                    return
                take = idx[i + lo : i + lo + per]
                items = list(pool.map(ds.__getitem__, take)) if pool else [ds[j] for j in take]
                self._queue.put(_collate(items))
        except Exception as e:  # surfaced by __next__
            self._queue.put(_Failed(e))
        finally:
            if pool is not None:
                pool.shutdown(wait=True)
            self._queue.put(None)  # end-of-epoch sentinel

    def _drain(self):
        try:
            while True:
                self._queue.get_nowait()
        except queue.Empty:
            pass

    def _stop_worker(self):
        """Stop the producer, which may be blocked in ``put`` on a full queue:
        drain the queue until it has exited."""
        if self._worker is None:
            return
        self._stop.set()
        while self._worker.is_alive():
            self._drain()
            self._worker.join(timeout=0.05)
        self._drain()
        self._worker = None

    def __iter__(self):
        """A one-pass phase starts its pass again, unless the pass that
        ``initialize`` started has not been read from yet."""
        if not self.repeat and self._consumed:
            self._start_epoch()
        return self

    def __len__(self):
        return self.length

    def __next__(self):
        self._consumed = True
        while (batch := self._queue.get()) is None:
            if not self.repeat:
                raise StopIteration
            self.epoch += 1
            self._start_epoch()
        if isinstance(batch, _Failed):
            self._worker.join()
            self._worker = None
            raise batch.error
        return batch
