"""Differentiable blockwise correspondence warp for training at high
resolution (counterpart of ``ppst_tpu/ops/corr_blockwise.py``).

At 1024px the correspondence grid has L = 16384 positions and the dense
(B, L, L) matrix of ``ops.corr.corrm`` is 1 GiB a sample in float32; the
training losses build two and differentiate through them. Here
``softmax(q k^T / T) v`` runs by row blocks, each under
``torch.utils.checkpoint``: the L x L matrix never exists, and the backward
recomputes each block's logits and softmax (the counterpart of JAX's
``lax.map(jax.checkpoint(one))``), so memory is O(block x Lk).

The rounding follows the dense ``corrm`` + ``warp``: float32 logits and
softmax, P rounded to ``v``'s dtype and multiplied with ``v`` in that dtype
(float32 sums on the card's tensor cores), the output in ``v``'s dtype. The
products are plain ``torch.matmul``:
the JAX package leaves them to XLA, outside any Pallas kernel. The
inference path's blockwise warp is the kernel K3 (``ops.corr_warp_cuda``).
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from ppst_tpu_torch.ops import corr_warp_cuda


def normalize_desc(fea, split: int = 256):
    """corrm's descriptor prep on NHWC features: center the first ``split``
    channels per position, L2-normalize over channels in float32; returns
    (B, H*W, C) in ``fea``'s dtype."""
    b, h, w, c = fea.shape
    return corr_warp_cuda.normalize_desc(fea.reshape(b, h * w, c), split)


def _warp_block(q, k, v, temperature: float):
    """softmax(q k^T / T) v for one row block of q."""
    logits = torch.matmul(q.float(), k.float().transpose(1, 2)) / temperature
    # P in v's dtype against v, as ops.corr.warp takes the dense matrix
    return torch.matmul(torch.softmax(logits, dim=-1).to(v.dtype), v)


def corr_warp_scan(q, k, v, temperature: float = 0.01, block: int = 512):
    """``softmax(q @ k^T / temperature) @ v`` by row blocks of ``block``
    queries, differentiable in q, k and v.

    ``q`` (B, Lq, C) and ``k`` (B, Lk, C) are pre-normalized descriptors
    (``normalize_desc``), ``v`` (B, Lk, Cv) the features to warp. Returns
    (B, Lq, Cv) in ``v``'s dtype. When ``block`` does not divide Lq the whole
    of q is one block (small grids only), as in the JAX package. Under grad
    each block is checkpointed; without grad the blocks just run.
    """
    lq = q.shape[1]
    block = min(block, lq)
    if lq % block:
        block = lq
    remat = torch.is_grad_enabled()
    outs = []
    for start in range(0, lq, block):
        qblk = q[:, start : start + block]
        if remat and lq > block:
            outs.append(checkpoint(_warp_block, qblk, k, v, temperature, use_reentrant=False))
        else:
            outs.append(_warp_block(qblk, k, v, temperature))
    return outs[0] if len(outs) == 1 else torch.cat(outs, dim=1)


def warp_qk(x, q, k, out_hw=None, temperature: float = 0.01, block: int = 512):
    """``ops.corr.warp`` against the implicit correspondence of descriptors
    (q, k): the flat path (H*W == Lk) and the block path (H*W > Lk: s x s
    pixel blocks move as units, reference ppst_model.py:366-387), without
    the Lq x Lk matrix."""
    b, h, w, c = x.shape
    lq, lk = q.shape[1], k.shape[1]
    if h * w != lk:
        assert lq == lk, "block-warp requires a square correspondence"
        s = int(round((h * w / lk) ** 0.5))
        assert s * s * lk == h * w, f"warp_qk: feature grid {h}x{w} incompatible with corr {lk}"
        ph, pw = h // s, w // s
        blocks = x.reshape(b, ph, s, pw, s, c).permute(0, 1, 3, 2, 4, 5)
        out = corr_warp_scan(q, k, blocks.reshape(b, ph * pw, s * s * c), temperature, block)
        out = out.reshape(b, ph, pw, s, s, c).permute(0, 1, 3, 2, 4, 5)
        return out.reshape(b, h, w, c)
    out = corr_warp_scan(q, k, x.reshape(b, h * w, c), temperature, block)
    if out_hw is None:
        g = int(round(lq**0.5))
        assert g * g == lq, "pass out_hw for non-square target grids"
        out_hw = (g, g)
    return out.reshape(b, out_hw[0], out_hw[1], c)
