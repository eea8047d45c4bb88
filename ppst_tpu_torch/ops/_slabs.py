"""The slab plan and ticket counters of the two-pass instance-norm kernels
(K7 ``ops/styled_epilogue_cuda.py``, K8 ``ops/norm_act_cuda.py``; their
shared device code is ``csrc/instance_norm.cuh``): blocks of C / 8 threads a
pixel row over a grid of (slabs, B)."""

from __future__ import annotations

import torch

THREADS = 256  # threads a block, at most: C / 8 channel groups x pixel rows
MAX_C = 2048
MAX_BATCH = 65535  # the grid's second dimension


def threads(c: int) -> tuple:
    """(threads a block, pixel rows a block step) for C channels: C / 8
    threads a pixel row, as many rows as fit in ``THREADS``."""
    cols = c // 8
    rows = max(1, THREADS // cols)
    return cols * rows, rows


def plan(batch: int, n: int, c: int, sms: int, resident: int) -> int:
    """Slabs an image for B images of n pixels and C channels on a card of
    ``sms`` SMs that holds ``resident`` blocks an SM: as many as fit in one
    wave of blocks over the card (a block more would wait for a second
    wave), as far as the pixels allow (a slab holds at least one pixel row
    for each thread of its block)."""
    _, rows = threads(c)
    want = max(1, resident) * sms // batch
    return max(1, min(want, n // rows))


# Per (device, stream): the kernels' ticket counters, zeroed once here; each
# launch leaves them at 0 again for the next on the same stream.
_COUNTERS: dict = {}


def counters(device: torch.device, stream: int, count: int) -> torch.Tensor:
    key = (device.index, stream)
    buf = _COUNTERS.get(key)
    if buf is None or buf.numel() < count:
        buf = _COUNTERS[key] = torch.zeros((count,), dtype=torch.int32, device=device)
    return buf
