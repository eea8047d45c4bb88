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
from ppst_tpu_torch.ops.corr_warp_cuda import normalize_desc
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

    def _warp_vectors(self, desc_c, desc_s, trunk_s, blockwise: bool):
        """E2's warped style vectors of the style trunk ``trunk_s`` through the
        content x style correspondence: the dense ``corrm`` matrix, or with
        ``blockwise`` the blockwise kernel (K3), which never holds it. As in
        the JAX package, the blockwise descriptors are normalized with
        ``normalize_desc``'s fixed split of 256 channels (equal to
        ``cfg.g_fuse_ch`` at full width)."""
        b, gh, gw, c = desc_c.shape
        if blockwise:
            q = normalize_desc(desc_c.reshape(b, gh * gw, c))
            k = normalize_desc(desc_s.reshape(b, -1, c))
            out = self.E2(None, corr_qk=(q, k), corr_out_hw=(gh, gw), trunk=trunk_s,
                          warped_only=True)
        else:
            out = self.E2(None, corrmatrix=self.corrm(desc_s, desc_c), corr_out_hw=(gh, gw),
                          trunk=trunk_s, warped_only=True)
        return list(out.vectors_w)

    def _extract_pair(self, content, style, generator):
        """The banks of ``grid_extract`` for ``content`` and ``style``: one
        batched pass over [content; style] when their shapes agree."""
        if content.shape != style.shape:
            return (self.grid_extract(content, generator),
                    self.grid_extract(style, generator))
        bank = self.grid_extract(torch.cat([content, style], dim=0), generator)
        b = content.shape[0]
        return ({k: take_rows(v, slice(None, b)) for k, v in bank.items()},
                {k: take_rows(v, slice(b, None)) for k, v in bank.items()})

    @torch.inference_mode()
    def stylize(self, content, style, generator: Optional[torch.Generator] = None,
                alpha: float = 1.0, smooth_target: bool = False):
        """The simple_swapping pipeline, computing each encoder pass once.

        Content and style of one shape are extracted in one batched pass;
        the warp stage reuses that pass's E2 trunk. With ``smooth_target``
        the guided filter runs on the output with the content as its guide."""
        cb, sb = self._extract_pair(content, style, generator)
        gl_w = self._warp_vectors(cb["desc"], sb["desc"], sb["trunk"], blockwise=False)
        if alpha != 1.0:
            gl_w = [a * (1 - alpha) + w * alpha for a, w in zip(cb["vectors"], gl_w)]
        return self.decode(cb["sp"], gl_w, generator,
                           target=content if smooth_target else None)

    @torch.inference_mode()
    def stylize_fused(self, content, style, generator: Optional[torch.Generator] = None,
                      smooth_target: bool = False):
        """``stylize`` with the correspondence through the blockwise kernel
        (K3), which never holds the L x L matrix: the 1024px path, where the
        dense matrix is 1 GiB a pair in float32."""
        cb, sb = self._extract_pair(content, style, generator)
        gl_w = self._warp_vectors(cb["desc"], sb["desc"], sb["trunk"], blockwise=True)
        return self.decode(cb["sp"], gl_w, generator,
                           target=content if smooth_target else None)

    # -- grid serving: extraction once per image, then batches of pairs ---

    @torch.inference_mode()
    def grid_extract(self, images, generator: Optional[torch.Generator] = None,
                     noises=None):
        """Extraction stage of grid serving: per image, everything a pair
        involving it needs: the structure code ``sp``, the correspondence
        descriptor ``desc`` (feature branch + Rselfcorr), the E2 conv
        ``trunk`` and the style ``vectors``."""
        sp = self.E1(images)
        vec, trunk = self.E2(images, return_trunk=True)
        _, fea, fea1 = self.G(sp, vec.vectors, extract_features=True, noises=noises,
                              generator=generator)
        return {"sp": sp, "desc": torch.cat([fea, rselfcorr(fea1)], dim=-1),
                "trunk": trunk, "vectors": vec.vectors}

    @torch.inference_mode()
    def grid_pairs(self, content_bank, style_bank, ci, si,
                   generator: Optional[torch.Generator] = None, alpha: float = 1.0,
                   smooth_target=None, noises=None, blockwise: bool = False):
        """Pair stage of grid serving: stylize the pairs (content ci[k],
        style si[k]) from the ``grid_extract`` banks, running only the
        correspondence, E2's warp of the style trunk and the decode.
        ``smooth_target``: the content images (N_c, H, W, 3), gathered per
        pair as the guided filter's guide. ``blockwise``: the
        correspondence through the blockwise kernel (the 1024px grid)."""
        ci = torch.as_tensor(ci, dtype=torch.long, device=self.device)
        si = torch.as_tensor(si, dtype=torch.long, device=self.device)
        gl_w = self._warp_vectors(content_bank["desc"].index_select(0, ci),
                                  style_bank["desc"].index_select(0, si),
                                  take_rows(style_bank["trunk"], si), blockwise)
        if alpha != 1.0:
            vec_c = take_rows(content_bank["vectors"], ci)
            gl_w = [a * (1 - alpha) + w * alpha for a, w in zip(vec_c, gl_w)]
        target = smooth_target.index_select(0, ci) if smooth_target is not None else None
        return self.decode(content_bank["sp"].index_select(0, ci), gl_w, generator,
                           target=target, noises=noises)

    @staticmethod
    def to_uint8(images):
        """[-1, 1] float -> uint8 on the images' device (``tensor2im``'s math),
        so a serving row crosses to the host as a quarter of the bytes."""
        return ((images.float() + 1.0) * 127.5).clamp(0, 255).to(torch.uint8)


def take_rows(x, idx):
    """``x[idx]`` along the batch axis of a tensor or of each tensor in a
    list or tuple; ``idx`` is a slice or a LongTensor of rows."""
    if isinstance(x, (list, tuple)):
        return type(x)(take_rows(t, idx) for t in x)
    return x[idx] if isinstance(idx, slice) else x.index_select(0, idx)


def cat_banks(parts):
    """Concatenate ``grid_extract`` banks along the batch axis."""
    def cat(xs):
        if isinstance(xs[0], (list, tuple)):
            return type(xs[0])(cat([x[i] for x in xs]) for i in range(len(xs[0])))
        return torch.cat(xs, dim=0)

    return {k: cat([p[k] for p in parts]) for k in parts[0]}
