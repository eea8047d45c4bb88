"""The loader's native image kernels through ctypes (counterpart of
``ppst_tpu/data/native.py``): ``resize_u8`` (bilinear, or nearest for label
masks), ``to_pm1`` (uint8 to float32 in [-1, 1], optionally flipped) and
``one_hot_mask``.

The library is this package's own copy of the source, ``csrc/ppst_io.cpp``,
built at first use with the JAX package's flags (``native/build.sh``:
``g++ -O3 -march=native -fopenmp -shared -fPIC``), so that its outputs are
that library's bit for bit: under ``-march=native`` the compiler contracts
the bilinear blend into FMAs, which changes its rounding. It lands in
``ppst_tpu_torch/_build/`` (ignored by git) under a name keyed by the
source, the flags, the compiler's version and this host's CPU, so a library
built for one host is never loaded on another.

Where the JAX package quietly falls back to PIL when its library is
missing, ``library()`` raises: ``--native_io true`` without a working build
is an error.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess
import threading
from pathlib import Path

import numpy as np

PKG = Path(__file__).resolve().parent.parent
SOURCE = PKG / "csrc" / "ppst_io.cpp"
BUILD = PKG / "_build"
CXX = "g++"
CXX_FLAGS = ["-O3", "-march=native", "-fopenmp", "-shared", "-fPIC"]

_lock = threading.Lock()
_lib = None


def _host_key() -> bytes:
    """What ``-march=native`` resolves from: this CPU's model and flags."""
    try:
        with open("/proc/cpuinfo") as f:
            lines = [ln for ln in f if ln.startswith(("model name", "flags", "Features"))]
        return "".join(sorted(set(lines))).encode()
    except OSError:
        return f"{platform.machine()} {platform.processor()}".encode()


def build() -> Path:
    """Compile ``csrc/ppst_io.cpp`` into ``_build/`` unless this host's
    library exists, and return its path; raise if the compiler fails."""
    try:
        version = subprocess.run([CXX, "--version"], capture_output=True, text=True,
                                 check=True).stdout
    except (OSError, subprocess.CalledProcessError) as e:
        raise RuntimeError(f"the native IO library cannot be built: {CXX} does not run "
                           f"({e})") from e
    digest = hashlib.sha1(SOURCE.read_bytes() + " ".join(CXX_FLAGS).encode()
                          + version.encode() + _host_key()).hexdigest()
    lib = BUILD / f"ppst_io_{digest[:16]}.so"
    if not lib.exists():
        BUILD.mkdir(parents=True, exist_ok=True)
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        run = subprocess.run([CXX, *CXX_FLAGS, str(SOURCE), "-o", str(tmp)],
                             capture_output=True, text=True)
        if run.returncode:
            raise RuntimeError(f"{CXX} failed on {SOURCE.name}:\n{run.stdout}{run.stderr}")
        os.replace(tmp, lib)
    return lib


def library() -> ctypes.CDLL:
    """The loaded library, built at the first call."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            u8 = ctypes.POINTER(ctypes.c_uint8)
            f32 = ctypes.POINTER(ctypes.c_float)
            i = ctypes.c_int
            lib.resize_bilinear_u8.argtypes = [u8, i, i, i, u8, i, i]
            lib.resize_nearest_u8.argtypes = [u8, i, i, i, u8, i, i]
            lib.u8_to_pm1_f32.argtypes = [u8, i, i, i, i, f32]
            lib.labels_to_onehot_f32.argtypes = [u8, i, i, i, i, f32]
            for fn in (lib.resize_bilinear_u8, lib.resize_nearest_u8, lib.u8_to_pm1_f32,
                       lib.labels_to_onehot_f32):
                fn.restype = None
            _lib = lib
        return _lib


def available() -> bool:
    """Whether the library builds and loads on this host."""
    try:
        library()
    except (RuntimeError, OSError):
        return False
    return True


def _u8p(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def _f32p(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _hwc(img: np.ndarray) -> np.ndarray:
    img = np.ascontiguousarray(img, dtype=np.uint8)
    return img[:, :, None] if img.ndim == 2 else img


def resize_u8(img: np.ndarray, out_hw, nearest: bool = False) -> np.ndarray:
    """HW or HWC uint8 resized to ``out_hw`` (half-pixel centres), HWC."""
    lib = library()
    img = _hwc(img)
    h, w, c = img.shape
    oh, ow = out_hw
    if (oh, ow) == (h, w):
        return img
    out = np.empty((oh, ow, c), np.uint8)
    fn = lib.resize_nearest_u8 if nearest else lib.resize_bilinear_u8
    fn(_u8p(img), h, w, c, _u8p(out), oh, ow)
    return out


def to_pm1(img: np.ndarray, flip: bool = False) -> np.ndarray:
    """uint8 HWC to float32 in [-1, 1], mirrored left-right if ``flip``."""
    lib = library()
    img = _hwc(img)
    h, w, c = img.shape
    out = np.empty((h, w, c), np.float32)
    lib.u8_to_pm1_f32(_u8p(img), h, w, c, int(flip), _f32p(out))
    return out


def one_hot_mask(labels: np.ndarray, num_classes: int, flip: bool = False) -> np.ndarray:
    """An HW uint8 label map as (H, W, num_classes) float32 one-hot; labels
    at or above ``num_classes`` give all zeros."""
    lib = library()
    labels = np.ascontiguousarray(labels, dtype=np.uint8)
    h, w = labels.shape
    out = np.empty((h, w, num_classes), np.float32)
    lib.labels_to_onehot_f32(_u8p(labels), h, w, num_classes, int(flip), _f32p(out))
    return out
