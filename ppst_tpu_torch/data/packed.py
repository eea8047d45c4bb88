"""Packed single-file image datasets (counterpart of ``ppst_tpu/data/packed.py``).

A ``.pak`` file is the magic ``PPSTPAK1``, the length of a JSON index as a
little-endian u64, the index (key -> [offset, length] into the blobs, in the
order written) and the encoded blobs, concatenated. ``write_pack`` writes
the same bytes as the JAX package's for the same items. ``open_reader``
also opens an LMDB directory, where the ``lmdb`` module imports; without it
a directory raises an ``ImportError`` that names ``lmdb``.
"""

from __future__ import annotations

import json
import os
import struct
from typing import Dict, Iterable, List, Tuple

MAGIC = b"PPSTPAK1"


def write_pack(path: str, items: Iterable[Tuple[str, bytes]]):
    """``items``: (key, bytes) pairs; the blobs follow the index in their order."""
    index: Dict[str, List[int]] = {}
    blobs = []
    offset = 0
    for key, data in items:
        index[key] = [offset, len(data)]
        blobs.append(data)
        offset += len(data)
    index_bytes = json.dumps(index).encode()
    with open(path, "wb") as f:
        f.write(MAGIC)
        f.write(struct.pack("<Q", len(index_bytes)))
        f.write(index_bytes)
        for blob in blobs:
            f.write(blob)


class PackReader:
    """Random access to a ``.pak`` file's blobs by key; ``keys`` sorted."""

    def __init__(self, path: str):
        self.path = path
        with open(path, "rb") as f:
            if f.read(8) != MAGIC:
                raise ValueError(f"{path} is not a ppst pack")
            (n,) = struct.unpack("<Q", f.read(8))
            self.index = json.loads(f.read(n))
        self.data_start = 16 + n
        self.keys = sorted(self.index)

    def __len__(self):
        return len(self.keys)

    def get(self, key: str) -> bytes:
        off, length = self.index[key]
        with open(self.path, "rb") as f:
            f.seek(self.data_start + off)
            return f.read(length)


class LmdbReader:
    """The same interface over an LMDB directory (keys starting ``__`` are
    metadata and skipped, as in the JAX package)."""

    def __init__(self, path: str, lmdb):
        self.env = lmdb.open(path, readonly=True, lock=False, readahead=False)
        with self.env.begin() as txn:
            self.keys = sorted(k.decode() for k, _ in txn.cursor() if not k.startswith(b"__"))

    def __len__(self):
        return len(self.keys)

    def get(self, key: str) -> bytes:
        with self.env.begin() as txn:
            return txn.get(key.encode())


def open_reader(path: str):
    """A ``PackReader`` for a file, an ``LmdbReader`` for a directory."""
    if os.path.isdir(path):
        try:
            import lmdb
        except ImportError as e:
            raise ImportError(f"{path} is a directory, read as an LMDB database, and the "
                              "lmdb module is not installed; pack the images into a .pak "
                              "file with python -m ppst_tpu_torch.data.dataset_tools") from e
        return LmdbReader(path, lmdb)
    return PackReader(path)
