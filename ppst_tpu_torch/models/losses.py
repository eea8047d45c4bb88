"""Loss primitives: LSGAN loss and the RSCL style-contrastive loss with its
queues (counterpart of ``ppst_tpu/models/losses.py``; references
models/networks/loss.py:11-18 and networks/rscl.py:17-90).

Each rank computes its losses on its local batch, which makes them the JAX
package's per-shard forms; ``rscl_enqueue`` takes the keys of every rank,
gathered in rank order, and the world size, as JAX's takes ``n_dev``.
"""

from __future__ import annotations

import numpy as np
import torch

QUEUE_SIZE = 128
NUM_QUEUES = 4
CODE_DIM = 2048


def gan_loss(pred, should_be_classified_as_real: bool):
    """Least-squares GAN loss, reduced in float32."""
    pred = pred.float()
    if should_be_classified_as_real:
        return ((pred - 1.0) ** 2).mean()
    return (pred**2).mean()


def l1_loss(a, b):
    return (a.float() - b.float()).abs().mean()


def init_rscl_state(generator: torch.Generator, code_dim: int = CODE_DIM,
                    queue_size: int = QUEUE_SIZE) -> dict:
    """4 per-scale queues of ``queue_size`` column-normalized keys and their
    ring pointers (reference rscl.py:23-40), on the generator's device."""
    q = torch.randn((NUM_QUEUES, code_dim, queue_size), generator=generator,
                    device=generator.device)
    return {"queues": q / torch.linalg.vector_norm(q, dim=1, keepdim=True),
            "ptrs": torch.zeros((NUM_QUEUES,), dtype=torch.int64, device=generator.device)}


def rscl_loss_sharded(feat_q, feat_k, feat_k0, queue, nce_T: float):
    """InfoNCE over region-major (3, B, C) stacks with the queue and the
    batch's own ``feat_k0`` keys as negatives (reference rscl.py:42-65), in
    float32. Logit columns in the reference's order: [pos | in-batch block |
    queue | k0]. The in-batch block is the constant -10 the reference's
    broadcast ``eye(1)`` mask leaves there (rscl.py:58-59)."""
    r, b, c = feat_q.shape
    q, k, k0 = (v.float().transpose(0, 1) for v in (feat_q, feat_k, feat_k0))  # (B, 3, C)
    n = b * r
    l_pos = (q * k).sum(-1, keepdim=True)
    l_queue = torch.einsum("prc,cn->prn", q, queue.float())
    l_k0 = torch.einsum("prc,qsc->prqs", q, k0).reshape(b, r, n)
    l_neg1 = torch.full((b, r, n), -10.0, device=q.device)
    logits = torch.cat([l_pos, l_neg1, l_queue, l_k0], dim=-1) / nce_T
    return -torch.log_softmax(logits, dim=-1)[..., 0].mean()


def enqueue_schedule(batch_global: int, n_dev: int):
    """(region, sample) index pairs of the reference's six sequential
    single-key enqueues per scale (reference ppst_model.py:214-219,
    rscl.py:67-69): per device, rows 0..2 of the region-major key0 and keyw
    stacks. Returns two (6 * n_dev,) index arrays (regions, samples); the
    first half indexes key0, the second keyw."""
    b_local = batch_global // n_dev
    regions, samples = [], []
    for r in range(3):
        for d in range(n_dev):
            regions.append(r // b_local)
            samples.append(d * b_local + r % b_local)
    return np.asarray(regions * 2, np.int64), np.asarray(samples * 2, np.int64)


def rscl_enqueue(state: dict, layer: int, key0_rs, keyw_rs, world: int = 1) -> dict:
    """Ring-buffer write of one scale's 6 * ``world`` keys from the (3,
    B_global, C) region-major stacks of every rank's keys in rank order
    (detached by the caller), as the reference's six enqueues of
    ``concat_all_gather``-ed keys. Returns a new state; the queues stay
    float32 whatever the keys' dtype."""
    regions, samples = enqueue_schedule(key0_rs.shape[1], world)
    half = len(regions) // 2
    keys = torch.cat([key0_rs[regions[:half], samples[:half]],
                      keyw_rs[regions[half:], samples[half:]]]).to(state["queues"].dtype)
    n, queue_size = keys.shape[0], state["queues"].shape[-1]
    ptr = state["ptrs"][layer]
    pos = (ptr + torch.arange(n, device=ptr.device)) % queue_size
    queues = state["queues"].clone()
    queues[layer][:, pos] = keys.t()
    ptrs = state["ptrs"].clone()
    ptrs[layer] = (ptr + n) % queue_size
    return {"queues": queues, "ptrs": ptrs}
