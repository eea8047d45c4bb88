"""The program's side of a run: its configuration from the cell's file, and
the benchmark's weights, LPIPS network and RSCL queues loaded into its
model. Everything of ``ppst_tpu_torch`` the drivers use goes through here."""

from __future__ import annotations

import dataclasses

import torch

from reference.config import PPSTConfig as ReferenceConfig


def configs(cell_config: dict):
    """(the program's PPSTConfig, the reference's) from the configuration
    file: every key that names a field of the configuration."""
    from ppst_tpu_torch.models.config import PPSTConfig

    def make(cls):
        names = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in cell_config.items() if k in names})

    return make(PPSTConfig), make(ReferenceConfig)


def load(model, w: dict):
    """The benchmark's weights, LPIPS network and RSCL queues into the
    program's ``PPSTModel`` (the tensors are copied)."""
    model.load_state_dict(w["model"], strict=True)
    model.lpips.load_state_dict(w["lpips"], strict=True)
    model.set_rscl_state({k: v.clone() for k, v in w["rscl"].items()})


def launches() -> dict:
    """The program's own launch counters of its kernels (read, never reset;
    each run notes what the window launched)."""
    from ppst_tpu_torch.ops import corr_warp_cuda, styled_conv_cuda, tap_cuda

    return {"tap_fwd": tap_cuda.fused_tap_1x1.launches,
            "tap_bwd": tap_cuda.fused_tap_1x1_bwd.launches,
            "corr_warp": corr_warp_cuda.corr_warp_blockwise.launches,
            "styled_conv": styled_conv_cuda.styled_conv3x3.launches,
            "styled_conv_bwd": styled_conv_cuda.styled_conv3x3_bwd.launches}


def free(dev):
    import gc

    gc.unfreeze()  # what ``settle_host`` froze may be garbage now
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()


def sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def reset_peak(dev):
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)


def peak(dev) -> int:
    """The card's allocation peak since ``reset_peak``; 0 off the card."""
    return torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0


def settle_host():
    """Before a window: collect the set-up's garbage and move what survives
    out of the collector's reach (``gc.freeze``), so that the window's
    collections scan only what the window makes. The collector stays on."""
    import gc

    gc.collect()
    gc.freeze()
