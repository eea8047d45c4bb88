"""The traffic's inputs, drawn from a seed on the card and handed over on
the host, as a loader hands them: the benchmark's own copy of the shapes of
``ppst_tpu_torch/data/synthetic_dataset.py`` (smooth images of 8 x 8
blocks, blocky 3-region one-hot masks of 16 x 16 blocks), NHWC float32 in
[-1, 1]."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def images(gen: torch.Generator, n: int, crop: int) -> torch.Tensor:
    low = torch.randn((n, crop // 8, crop // 8, 3), generator=gen, device=gen.device)
    return (low.repeat_interleave(8, 1).repeat_interleave(8, 2) * 0.5).clamp(-1, 1)


def masks(gen: torch.Generator, n: int, crop: int) -> torch.Tensor:
    region = torch.randint(0, 3, (n, crop // 16, crop // 16), generator=gen, device=gen.device)
    region = region.repeat_interleave(16, 1).repeat_interleave(16, 2)
    return F.one_hot(region, 3).float()


CHUNK = 8  # rows drawn on the card at a time


def host_images(seed: int, n: int, crop: int, device) -> torch.Tensor:
    """(n, crop, crop, 3) on the host."""
    gen = torch.Generator(device=device).manual_seed(seed)
    return torch.cat([images(gen, min(CHUNK, n - i), crop).cpu() for i in range(0, n, CHUNK)])


def host_batches(seed: int, n: int, batch: int, crop: int, device) -> list:
    """``n`` training batches {"real_A", "mask_A"} on the host, every row
    its own draw."""
    gen = torch.Generator(device=device).manual_seed(seed)
    rows = [(images(gen, batch, crop).cpu(), masks(gen, batch, crop).cpu()) for _ in range(n)]
    return [{"real_A": real, "mask_A": mask} for real, mask in rows]
