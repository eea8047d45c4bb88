"""The PPST model's inference API (counterpart of the inference half of
``ppst_tpu/models/ppst.py``; reference models/ppst_model.py:264-315).

``PPSTModel`` holds E1, E2 and G under the reference's ``state_dict``
prefixes (``E1.``, ``E2.``, ``G.``), so a reference checkpoint loads into it.
Images are NHWC in [-1, 1]; the compute dtype follows the images' dtype, as
in the JAX package. Noise is drawn from the ``torch.Generator`` passed in.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn

from ppst_tpu_torch.models.config import PPSTConfig
from ppst_tpu_torch.models.encoder_col import ColorEncoder
from ppst_tpu_torch.models.encoder_con import ContentEncoder
from ppst_tpu_torch.models.generator import Generator
from ppst_tpu_torch.nn.layers import init_weights
from ppst_tpu_torch.ops.corr import corrm, rselfcorr
from ppst_tpu_torch.ops.guided_filter import guided_filter


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller names
    another. Raises when CUDA is asked for and there is none."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "(--device cpu) to run on the CPU")
    return device


class PPSTModel(nn.Module):
    def __init__(self, cfg: PPSTConfig, device=None, seed: int = 0):
        """E1, E2 and G with weights drawn from ``seed``, on ``device``
        (CUDA by default)."""
        super().__init__()
        device = resolve_device(device)
        self.cfg = cfg
        self.E1 = ContentEncoder(cfg)
        self.E2 = ColorEncoder(cfg)
        self.G = Generator(cfg)
        init_weights(self, torch.Generator().manual_seed(seed))
        self.to(device)
        self.eval()

    @property
    def device(self) -> torch.device:
        return next(self.parameters()).device

    def load_reference_checkpoint(self, path: str):
        """Load E1/E2/G from a reference ``.pth`` (the whole PPSTModel's
        state_dict; D, the RSCL queues and dead members are ignored)."""
        sd = torch.load(path, map_location="cpu", weights_only=True)
        if "state_dict" in sd:
            sd = sd["state_dict"]
        own = self.state_dict()
        missing = [k for k in own if k not in sd]
        if missing:
            raise KeyError(f"checkpoint lacks {len(missing)} keys, e.g. {missing[:3]}")
        # the reference stores some biases as (1, C, 1, 1)
        self.load_state_dict({k: sd[k].reshape(own[k].shape) for k in own})

    # -- network applications -------------------------------------------

    @torch.inference_mode()
    def encode(self, image):
        return self.E1(image), self.E2(image).vectors

    @torch.inference_mode()
    def encode2(self, image, corrmatrix, corr_out_hw=None):
        out = self.E2(image, corrmatrix=corrmatrix, corr_out_hw=corr_out_hw)
        return out.vectors, out.vectors_w

    @torch.inference_mode()
    def extract_feat_from_image(self, image, generator: Optional[torch.Generator] = None):
        sp = self.E1(image)
        _, fea, fea1 = self.G(sp, self.E2(image).vectors, extract_features=True,
                              generator=generator)
        return fea, fea1

    def corrm(self, fea, fea0):
        """Dense correspondence with the mean-centered head sized to the
        generator feature branch (cfg.g_fuse_ch)."""
        return corrm(fea, fea0, split=self.cfg.g_fuse_ch)

    @torch.inference_mode()
    def decode(self, sp, gl, generator: Optional[torch.Generator] = None, target=None,
               noises=None):
        """G forward; with ``target`` the guided filter runs on the result
        with ``target`` as its guide. ``noises`` pins the noise injection."""
        out = self.G(sp, list(gl), noises=noises, generator=generator)
        if target is None:
            return out
        out255 = (out.clamp(-1.0, 1.0) + 1.0) * 127.5
        guide255 = (target.clamp(-1.0, 1.0) + 1.0) * 127.5
        smoothed = guided_filter(guide255, out255, radius=30, eps=(0.02 * 255.0) ** 2)
        return smoothed / 127.5 - 1.0

    @torch.inference_mode()
    def stylize(self, content, style, generator: Optional[torch.Generator] = None,
                alpha: float = 1.0, smooth_target: bool = False):
        """The simple_swapping pipeline, computing each encoder pass once.

        Content and style of one shape are extracted in one batched pass;
        the warp stage reuses that pass's E2 trunk. With ``smooth_target``
        the guided filter runs on the output with the content as its guide."""

        def image_desc(img):
            sp = self.E1(img)
            vec, trunk = self.E2(img, return_trunk=True)
            _, fea, fea1 = self.G(sp, vec.vectors, extract_features=True,
                                  generator=generator)
            return sp, vec.vectors, torch.cat([fea, rselfcorr(fea1)], dim=-1), trunk

        if content.shape == style.shape:
            b = content.shape[0]
            sp_b, vec_b, desc_b, trunk_b = image_desc(torch.cat([content, style], dim=0))
            sp_c, vec_c = sp_b[:b], [v[:b] for v in vec_b]
            desc_c, desc_s = desc_b[:b], desc_b[b:]
            trunk_s = tuple(t[b:] for t in trunk_b)
        else:
            sp_c, vec_c, desc_c, _ = image_desc(content)
            _, _, desc_s, trunk_s = image_desc(style)
        corr = self.corrm(desc_s, desc_c)
        gl_w = self.E2(None, corrmatrix=corr, corr_out_hw=(desc_c.shape[1], desc_c.shape[2]),
                       trunk=trunk_s, warped_only=True).vectors_w
        if alpha != 1.0:
            gl_w = [a * (1 - alpha) + w * alpha for a, w in zip(vec_c, gl_w)]
        return self.decode(sp_c, gl_w, generator,
                           target=content if smooth_target else None)
