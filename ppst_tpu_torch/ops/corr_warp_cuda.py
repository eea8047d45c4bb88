"""Blockwise correspondence warp (K3): ``softmax(q k^T / T) v`` without the
Lq x Lk matrix.

Counterpart of ``ppst_tpu/ops/corr_pallas.py``. On a CUDA tensor
``corr_warp_blockwise`` launches the hand-written kernel in
``csrc/corr_warp.cu`` (whose header gives the design and its bound); on a CPU
tensor it runs ``corr_warp_blockwise_reference``, the plain PyTorch version
of the same function. There is no other path.

The kernel is compiled with ``nvcc`` for sm_90a at first use into
``ppst_tpu_torch/_build/`` and bound through ``ctypes`` (``ops._nvcc``).
While a profiler runs, each call's host side on the card is the span
``ppst.op:corr_warp:<B>,<Lq>,<Lk>,<C>,<Cv>,<itemsize>`` (``util.spans``).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ppst_tpu_torch.ops import _nvcc
from ppst_tpu_torch.ops.corr import _NORM_EPS
from ppst_tpu_torch.util.spans import span

# The bf16 kernel keeps 128 query rows x C in shared memory beside the K
# ring and two V stages: C <= 512 fits at every Cv (224 KB at Cv = 256)
_MAX_C_BF16 = 512
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


@functools.lru_cache(maxsize=None)
def _lib():
    lib = _nvcc.load("corr_warp")
    fn = lib.ppst_corr_warp
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
                   + [ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return lib


def normalize_desc(x, split: int = 256):
    """corrm's descriptor prep on (B, L, C): center the first ``split``
    channels per position, L2-normalize over channels. Computed in float32
    and rounded once to ``x``'s dtype, as XLA's fusion of the JAX version
    does."""
    x32 = x.float()
    head = x32[..., :split]
    x32 = torch.cat([head - head.mean(-1, keepdim=True), x32[..., split:]], dim=-1)
    x32 = x32 / (torch.linalg.vector_norm(x32, dim=-1, keepdim=True) + _NORM_EPS)
    return x32.to(x.dtype)


def corr_warp_blockwise_reference(q, k, v, temperature: float = 0.01):
    """Plain PyTorch version: dense float32 logits and softmax, float32
    ``@ v``, rounded to ``v``'s dtype."""
    logits = torch.matmul(q.float(), k.float().transpose(1, 2)) / temperature
    return torch.matmul(torch.softmax(logits, dim=-1), v.float()).to(v.dtype)


def check_inputs(q, k, v):
    """Raise ``ValueError`` unless the kernel takes ``q``, ``k`` and ``v``
    (wherever they lie); returns (B, Lq, C, Lk, Cv). Both kernels take 3-D
    tensors of one dtype (float32 or bfloat16) on one device with agreeing
    shapes and B <= 65535. The bfloat16 kernel also needs C <= 512 and C and
    Cv multiples of 8 (its TMA rows are 16-byte multiples); a Cv above 256
    runs as several passes of 256 columns."""
    if q.dim() != 3 or k.dim() != 3 or v.dim() != 3:
        raise ValueError("corr_warp_blockwise: q, k and v must be 3-D")
    bsz, lq, c = q.shape
    _, lk, cv = v.shape
    if tuple(k.shape) != (bsz, lk, c) or v.shape[0] != bsz:
        raise ValueError(f"corr_warp_blockwise: shapes q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)} do not agree")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _DTYPES:
        raise ValueError("corr_warp_blockwise: q, k and v must all be float32 or all "
                         f"bfloat16, got {q.dtype}, {k.dtype}, {v.dtype}")
    if k.device != q.device or v.device != q.device:
        raise ValueError("corr_warp_blockwise: q, k and v must be on one device")
    if min(bsz, lq, lk, c, cv) < 1 or bsz > 65535:
        raise ValueError(f"corr_warp_blockwise: empty or oversized shape {tuple(q.shape)}")
    if q.dtype == torch.bfloat16 and (c % 8 or cv % 8 or c > _MAX_C_BF16):
        raise ValueError(f"corr_warp_blockwise: the bfloat16 kernel takes C <= {_MAX_C_BF16} "
                         f"with C and Cv multiples of 8, got C={c}, Cv={cv}")
    return bsz, lq, c, lk, cv


def corr_warp_blockwise(q, k, v, temperature: float = 0.01):
    """``softmax(q @ k^T / temperature) @ v`` per batch entry.

    ``q`` (B, Lq, C) and ``k`` (B, Lk, C) are pre-normalized descriptors
    (``normalize_desc``), ``v`` (B, Lk, Cv) the values; all three float32 or
    all three bfloat16. Returns (B, Lq, Cv) in ``v``'s dtype.

    CPU tensors run the plain version. CUDA tensors launch the kernel at any
    Lq, Lk >= 1; for bfloat16 it takes what ``check_inputs`` lets through,
    and anything else raises.
    """
    if q.device.type == "cpu":
        return corr_warp_blockwise_reference(q, k, v, temperature)
    if q.device.type != "cuda":
        raise ValueError(f"corr_warp_blockwise: unsupported device {q.device}")
    with span("op:corr_warp", q.shape[:2], k.shape[1], q.shape[2], v.shape[2], v.element_size()):
        return _corr_warp_cuda(q, k, v, temperature)


def _corr_warp_cuda(q, k, v, temperature):
    bsz, lq, c, lk, cv = check_inputs(q, k, v)
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("corr_warp_blockwise: q, k and v must be 16-byte aligned")

    out = torch.empty((bsz, lq, cv), dtype=v.dtype, device=v.device)
    lib = _lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.ppst_corr_warp(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                                 _DTYPES[q.dtype], bsz, lq, lk, c, cv, 1.0 / temperature,
                                 stream)
    _nvcc.check(lib, err, "corr_warp_blockwise")
    corr_warp_blockwise.launches += 1
    return out


corr_warp_blockwise.launches = 0


def fused_corr_warp(fea, fea0, values_hw, temperature: float = 0.01):
    """``warp(values, corrm(fea, fea0))`` without the L x L intermediate:
    descriptors ``fea`` (B, H, W, C) (source) and ``fea0`` (B, H0, W0, C)
    (target), values (B, H, W, Cv) -> warped values (B, H0, W0, Cv)."""
    b, h, w, c = fea.shape
    h0, w0 = fea0.shape[1], fea0.shape[2]
    q = normalize_desc(fea0.reshape(b, h0 * w0, c))
    k = normalize_desc(fea.reshape(b, h * w, c))
    out = corr_warp_blockwise(q, k, values_hw.reshape(b, h * w, -1), temperature)
    return out.reshape(b, h0, w0, -1)
