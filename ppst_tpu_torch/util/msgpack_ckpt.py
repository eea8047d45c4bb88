"""Reader of the JAX package's ``.msgpack`` checkpoints: the counterpart of
``flax.serialization.msgpack_restore`` (as ``ppst_tpu/train/bundle.py``
reads its checkpoints), written here so that the port needs neither
``msgpack`` nor ``flax`` nor ``ml_dtypes``.

It decodes the subset of msgpack that flax writes: maps, arrays, str and
bin, integers, floats, nil and booleans, and flax's ext types 1 (an ndarray:
a nested msgpack of ``(shape, dtype name as raw bytes, C-order buffer)``),
2 (a complex number) and 3 (a numpy scalar, stored as a 0-d ndarray).
Arrays flax split into ``__msgpack_chunked_array__`` maps are joined again.

An array leaf is a numpy array, or a ``torch.Tensor`` for ``bfloat16`` (numpy
has no such dtype), viewing the file's bytes without a copy where the
buffer allows (one file-sized buffer is held).
"""

from __future__ import annotations

import struct

import numpy as np
import torch

_EXT_NDARRAY, _EXT_COMPLEX, _EXT_NPSCALAR = 1, 2, 3


class _Reader:
    """msgpack decoder over a memoryview; ``raw`` leaves str as bytes, as
    ``msgpack.unpackb(raw=True)`` does."""

    def __init__(self, buf: memoryview, raw: bool = False):
        self.buf, self.pos, self.raw = buf, 0, raw

    def _take(self, n: int) -> memoryview:
        if self.pos + n > len(self.buf):
            raise ValueError("truncated msgpack data")
        out = self.buf[self.pos : self.pos + n]
        self.pos += n
        return out

    def _unpack(self, fmt: str):
        (v,) = struct.unpack_from(fmt, self.buf, self.pos)
        self.pos += struct.calcsize(fmt)
        return v

    def _str(self, n: int):
        b = self._take(n)
        return bytes(b) if self.raw else str(b, "utf-8")

    def _ext(self, n: int):
        code = self._unpack(">b")
        return _decode_ext(code, self._take(n))

    def read(self):
        t = self._unpack(">B")
        if t <= 0x7F:
            return t
        if t >= 0xE0:
            return t - 0x100
        if 0x80 <= t <= 0x8F:
            return self._map(t & 0x0F)
        if 0x90 <= t <= 0x9F:
            return [self.read() for _ in range(t & 0x0F)]
        if 0xA0 <= t <= 0xBF:
            return self._str(t & 0x1F)
        if t == 0xC0:
            return None
        if t in (0xC2, 0xC3):
            return t == 0xC3
        if t in (0xC4, 0xC5, 0xC6):  # bin 8/16/32
            return self._take(self._unpack((">B", ">H", ">I")[t - 0xC4]))
        if t in (0xC7, 0xC8, 0xC9):  # ext 8/16/32
            return self._ext(self._unpack((">B", ">H", ">I")[t - 0xC7]))
        if t == 0xCA:
            return self._unpack(">f")
        if t == 0xCB:
            return self._unpack(">d")
        if 0xCC <= t <= 0xD3:  # uint 8-64, int 8-64
            return self._unpack((">B", ">H", ">I", ">Q", ">b", ">h", ">i", ">q")[t - 0xCC])
        if 0xD4 <= t <= 0xD8:  # fixext 1/2/4/8/16
            return self._ext(1 << (t - 0xD4))
        if t in (0xD9, 0xDA, 0xDB):
            return self._str(self._unpack((">B", ">H", ">I")[t - 0xD9]))
        if t in (0xDC, 0xDD):
            return [self.read() for _ in range(self._unpack((">H", ">I")[t - 0xDC]))]
        if t in (0xDE, 0xDF):
            return self._map(self._unpack((">H", ">I")[t - 0xDE]))
        raise ValueError(f"msgpack type byte 0x{t:02x} is not one flax writes")

    def _map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.read()
            out[k] = self.read()
        return out


def unpackb(buf, raw: bool = False):
    """One msgpack object from ``buf`` (bytes-like), flax's ext types
    decoded."""
    r = _Reader(memoryview(buf), raw=raw)
    out = r.read()
    if r.pos != len(r.buf):
        raise ValueError(f"{len(r.buf) - r.pos} trailing bytes after the msgpack object")
    return out


def _ndarray_from_bytes(data: memoryview):
    shape, dtype_name, buffer = unpackb(data, raw=True)
    shape = tuple(shape)
    if dtype_name == b"bfloat16":
        if len(buffer) == 0:
            return torch.zeros(shape, dtype=torch.bfloat16)
        return torch.frombuffer(buffer, dtype=torch.bfloat16).reshape(shape)
    return np.frombuffer(buffer, dtype=np.dtype(dtype_name.decode())).reshape(shape)


def _decode_ext(code: int, data: memoryview):
    if code == _EXT_NDARRAY:
        return _ndarray_from_bytes(data)
    if code == _EXT_NPSCALAR:
        return _ndarray_from_bytes(data)[()]
    if code == _EXT_COMPLEX:
        re, im = unpackb(data)
        return complex(re, im)
    raise ValueError(f"msgpack ext type {code} is not one flax writes")


def _tuple_from_dict(d: dict):
    return tuple(d[str(i)] for i in range(len(d)))


def _unchunk(d: dict):
    shape = _tuple_from_dict(d["shape"])
    chunks = _tuple_from_dict(d["chunks"])
    if isinstance(chunks[0], torch.Tensor):
        return torch.cat(chunks).reshape(shape)
    return np.concatenate(chunks).reshape(shape)


def _unchunk_leaves(d):
    """Joins flax's chunked array leaves (``_unchunk_array_leaves_in_place``)."""
    if isinstance(d, dict):
        if "__msgpack_chunked_array__" in d:
            return _unchunk(d)
        return {k: _unchunk_leaves(v) for k, v in d.items()}
    return d


def msgpack_restore(encoded):
    """The tree of a flax ``msgpack_serialize``d payload (bytes-like; a
    read-only one is copied, so that the arrays are writable views)."""
    if memoryview(encoded).readonly:
        encoded = bytearray(encoded)
    return _unchunk_leaves(unpackb(encoded))


def read_checkpoint(path: str):
    """The tree of a JAX package checkpoint file (``<N>k_checkpoint.msgpack``):
    ``{"params": ..., "state": ...[, "opt_states": ...]}``."""
    with open(path, "rb") as f:
        buf = bytearray(f.seek(0, 2))
        f.seek(0)
        f.readinto(buf)
    return msgpack_restore(buf)
