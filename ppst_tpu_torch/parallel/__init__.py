"""Data-parallel training over processes (counterpart of
``ppst_tpu/parallel/mesh.py``; reference models/__init__.py:75-91): one
process per GPU, ``torch.distributed`` on NCCL for CUDA and on gloo for the
CPU.

Each rank holds the whole model and its own slice of every global batch.
After each backward the ranks average their gradients (``average_grads``),
which makes the update the global batch's, since every rank's local batch
is the same size; parameters, buffers and the RSCL queues are broadcast from
rank 0 after a build or a load (``broadcast_module``, ``broadcast``), and the
RSCL keys of every rank are gathered in rank order (``all_gather_cat``).

``init`` reads the launcher's environment: ``torchrun``'s ``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR`` and ``MASTER_PORT``, or the
JAX package's ``PPST_NUM_PROCESSES``, ``PPST_PROCESS_ID`` and
``PPST_COORDINATOR`` (host:port), so that a JAX launch recipe carries over.
Without either it leaves the process alone, a world of one. The process
group is destroyed at exit. While a profiler runs, the collectives of
``average_grads`` and ``average`` (world > 1 only) are the span
``ppst.step:grad_sync``.
"""

from __future__ import annotations

import atexit
import os
from typing import Iterable, List, Optional

import torch
import torch.distributed as dist

from ppst_tpu_torch.util.spans import span

# gradients are averaged in float32 buckets of about this many bytes
BUCKET_BYTES = 32 << 20


def launch_env() -> Optional[dict]:
    """``{"rank", "world", "local_rank", "init_method"}`` from the launcher's
    environment, or None outside a multi-process launch."""
    env = os.environ
    if "WORLD_SIZE" in env and "RANK" in env:
        return {"rank": int(env["RANK"]), "world": int(env["WORLD_SIZE"]),
                "local_rank": int(env.get("LOCAL_RANK", env["RANK"])), "init_method": "env://"}
    if env.get("PPST_NUM_PROCESSES"):
        rank = int(env["PPST_PROCESS_ID"])
        return {"rank": rank, "world": int(env["PPST_NUM_PROCESSES"]),
                "local_rank": int(env.get("LOCAL_RANK", rank)),
                "init_method": f"tcp://{env['PPST_COORDINATOR']}"}
    return None


def init(device) -> torch.device:
    """Join the launcher's process group, on NCCL for a CUDA ``device`` (after
    ``torch.cuda.set_device(LOCAL_RANK)``) and on gloo for the CPU, and
    return the device this rank runs on: ``cuda:<LOCAL_RANK>`` for CUDA under
    a launch, else ``device``. Outside a launch nothing is initialized."""
    device = torch.device(device)
    env = launch_env()
    if env is None:
        return device
    cuda = device.type == "cuda"
    if cuda:
        device = torch.device("cuda", env["local_rank"])
        torch.cuda.set_device(device)
    if not dist.is_initialized():
        backend = "nccl" if cuda else "gloo"
        dist.init_process_group(backend, init_method=env["init_method"], rank=env["rank"],
                                world_size=env["world"], device_id=device if cuda else None)
        atexit.register(shutdown)
        print(f"[parallel] rank {env['rank']} of {env['world']} on {backend}, {device}",
              flush=True)
    return device


def shutdown():
    if dist.is_initialized():
        dist.destroy_process_group()


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def is_primary() -> bool:
    """Rank 0 writes the files (checkpoints, logs, options)."""
    return rank() == 0


def broadcast(tensors: Iterable[torch.Tensor]):
    """Overwrite each tensor in place with rank 0's value."""
    if world_size() > 1:
        for t in tensors:
            dist.broadcast(t.data, src=0)


def broadcast_module(module: torch.nn.Module):
    """Rank 0's parameters and buffers on every rank (the counterpart of
    ``replicate_tree``)."""
    broadcast(list(module.parameters()) + list(module.buffers()))


def _buckets(tensors: List[torch.Tensor]):
    bucket, size = [], 0
    for t in tensors:
        bucket.append(t)
        size += t.numel() * 4
        if size >= BUCKET_BYTES:
            yield bucket
            bucket, size = [], 0
    if bucket:
        yield bucket


def average_grads(params: Iterable[torch.nn.Parameter]):
    """Every parameter's ``.grad`` replaced by its mean over the ranks: the
    gradients are flattened into float32 buckets, summed with one
    ``all_reduce`` each, divided by the world size and copied back. A no-op
    in a world of one."""
    world = world_size()
    if world == 1:
        return
    grads = [p.grad for p in params]
    with span("step:grad_sync"):
        for bucket in _buckets(grads):
            flat = torch.cat([g.reshape(-1).float() for g in bucket])
            dist.all_reduce(flat)
            flat /= world
            offset = 0
            for g in bucket:
                n = g.numel()
                g.copy_(flat[offset : offset + n].view_as(g))
                offset += n


def average(x: torch.Tensor) -> torch.Tensor:
    """The mean of ``x`` over the ranks (a new tensor; ``x`` itself in a
    world of one)."""
    world = world_size()
    if world == 1:
        return x
    with span("step:grad_sync"):
        x = x.clone()
        dist.all_reduce(x)
        return x / world


def all_gather_cat(x: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """Every rank's ``x`` concatenated along ``dim`` in rank order (the
    reference's ``concat_all_gather``); ``x`` itself in a world of one."""
    world = world_size()
    if world == 1:
        return x
    parts = [torch.empty_like(x) for _ in range(world)]
    dist.all_gather(parts, x.contiguous())
    return torch.cat(parts, dim=dim)
