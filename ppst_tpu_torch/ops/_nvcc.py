"""Build and load the hand-written CUDA kernels of ``ppst_tpu_torch/csrc``.

Each source is compiled with ``nvcc`` for sm_90a into a shared library with a
plain C interface, at first use, into ``ppst_tpu_torch/_build/`` (listed in
``.gitignore``), keyed by a hash of the source, the ``*.cuh`` headers beside
it and the flags. The wrappers bind it through ``ctypes``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

PKG = Path(__file__).resolve().parent.parent
BUILD = PKG / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC"]


def nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def build(src: Path) -> Path:
    """Compile ``src`` into ``_build/<stem>_<hash>.so`` unless that exists,
    and return the library's path. The hash covers the headers beside it."""
    headers = b"".join(h.read_bytes() for h in sorted(src.parent.glob("*.cuh")))
    digest = hashlib.sha1(src.read_bytes() + headers + " ".join(NVCC_FLAGS).encode()).hexdigest()
    lib = BUILD / f"{src.stem}_{digest[:16]}.so"
    if not lib.exists():
        BUILD.mkdir(parents=True, exist_ok=True)
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        subprocess.run([nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)], check=True)
        os.replace(tmp, lib)
    return lib


def load(name: str) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<name>.cu``, with its
    ``ppst_cuda_error_string`` bound."""
    lib = ctypes.CDLL(str(build(PKG / "csrc" / f"{name}.cu")))
    lib.ppst_cuda_error_string.argtypes = [ctypes.c_int]
    lib.ppst_cuda_error_string.restype = ctypes.c_char_p
    return lib


def check(lib: ctypes.CDLL, err: int, what: str):
    """Raise if a C launcher returned a CUDA error."""
    if err != 0:
        msg = lib.ppst_cuda_error_string(err).decode()
        raise RuntimeError(f"{what}: kernel launch failed: {msg} ({err})")
