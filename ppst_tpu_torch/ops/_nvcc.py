"""Build and load the hand-written CUDA kernels of ``ppst_tpu_torch/csrc``.

Each source is compiled with ``nvcc`` for sm_90a into a shared library with a
plain C interface, at first use, into ``ppst_tpu_torch/_build/`` (listed in
``.gitignore``), keyed by a hash of the source, the ``*.cuh`` headers beside
it and the flags. ``ptxas``'s report (registers, shared memory and spills of
each kernel) is kept beside the library as ``<library>.log``. The wrappers
bind it through ``ctypes``.
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
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]


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
        run = subprocess.run([nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
                             capture_output=True, text=True)
        if run.returncode:
            raise RuntimeError(f"nvcc failed on {src.name}:\n{run.stdout}{run.stderr}")
        log(lib).write_text(run.stdout + run.stderr)
        os.replace(tmp, lib)
    return lib


def log(lib: Path) -> Path:
    """The compiler's report kept beside a built library."""
    return lib.with_name(lib.name + ".log")


def ptxas_summary(lib: Path) -> list[str]:
    """Each kernel's registers, shared memory and spills from ``lib``'s build
    report, one line per kernel."""
    if not log(lib).exists():
        return []
    lines, kernel = [], None
    for line in log(lib).read_text().splitlines():
        if "Compiling entry function" in line:
            kernel = demangle(line.split("'")[1] if "'" in line else line)
        elif kernel and ("bytes stack frame" in line or "Used" in line):
            lines.append(f"{kernel}: {line.split('info    :')[-1].strip()}")
    return lines


def demangle(name: str) -> str:
    """A kernel's C++ name without its namespace and parameters, where
    ``c++filt`` is installed; else the symbol as it is."""
    tool = shutil.which("c++filt")
    if not tool:
        return name
    full = subprocess.run([tool, name], capture_output=True, text=True).stdout.strip() or name
    full = full.replace("(anonymous namespace)::", "").removeprefix("void ")
    return full.split("(")[0].split("::")[-1]


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
