"""The PPST model (counterpart of ``ppst_tpu/models/ppst.py``; reference
models/ppst_model.py): the inference API (:264-315) and the training losses
(:105-235).

``PPSTModel`` holds E1, E2, G and D under the reference's ``state_dict``
prefixes (``E1.``, ``E2.``, ``G.``, ``D.``), so a reference checkpoint loads
into it. Beside them it keeps the RSCL queues and the D-step count (the
training state), and the LPIPS network, which is a fixed part of the loss
and not in the ``state_dict``. Images are NHWC in [-1, 1]; the compute dtype
follows the images' dtype, as in the JAX package. Noise is drawn from the
``torch.Generator`` passed in.

The serving methods run under ``torch.inference_mode``; the loss methods
run with grad, for ``train.steps``. While a profiler runs, ``stylize`` and
``stylize_fused`` mark their stages as the spans ``ppst.stylize:extract``,
``:warp``, ``:decode`` and ``:filter`` (``util.spans``; the last two are
``decode``'s own).
"""

from __future__ import annotations

import functools
from typing import Optional

import torch
import torch.nn as nn
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from ppst_tpu_torch import parallel
from ppst_tpu_torch.models.config import PPSTConfig
from ppst_tpu_torch.models.discriminator import Discriminator
from ppst_tpu_torch.models.encoder_col import ColorEncoder, batch_swap
from ppst_tpu_torch.models.encoder_con import ContentEncoder
from ppst_tpu_torch.models.generator import Generator, make_fixed_noise
from ppst_tpu_torch.models.losses import (
    gan_loss,
    init_rscl_state,
    l1_loss,
    rscl_enqueue,
    rscl_loss_sharded,
)
from ppst_tpu_torch.nn.layers import init_weights, preparing_kernel
from ppst_tpu_torch.ops import corr_blockwise
from ppst_tpu_torch.ops.corr import corrm, resize_bilinear, rselfcorr, warp
from ppst_tpu_torch.ops.corr_warp_cuda import normalize_desc
from ppst_tpu_torch.ops.guided_filter import guided_filter
from ppst_tpu_torch.ops.lpips import LPIPS
from ppst_tpu_torch.util.from_flax import from_flax
from ppst_tpu_torch.util.msgpack_ckpt import read_checkpoint
from ppst_tpu_torch.util.spans import span
from ppst_tpu_torch.util.util import visualize_spatial_code


def save_kernels_policy(ctx, op, *args, **kwargs):
    """``remat_save_kernels``' selective-checkpoint policy (the JAX package's
    ``save_only_these_names("ppst_kernel")``): keep the outputs of the
    operations that prepare a kernel (``nn.layers.saveable_kernel``), views
    aside, and recompute everything else. The recompute then takes the
    kept kernels instead of running those operations again."""
    if _prepares_kernel(op):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _prepares_kernel(op) -> bool:
    """``op`` runs inside ``saveable_kernel()`` and is not a view."""
    return preparing_kernel() and not any(r.alias_info is not None for r in op._schema.returns)


class KernelRecomputeCounter(TorchDispatchMode):
    """While active, counts the operations that a backward runs to prepare a
    kernel again (those ``save_kernels_policy`` would keep): none under
    ``remat_save_kernels``, some without it wherever ``remat`` recomputes a
    pass. Operations outside a backward are not counted."""

    def __init__(self):
        super().__init__()
        self.count = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if torch._C._current_graph_task_id() != -1 and _prepares_kernel(func):
            self.count += 1
        return func(*args, **(kwargs or {}))


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
        """E1, E2, G, D and the RSCL queues drawn from ``seed``, in that
        order, on ``device`` (CUDA by default)."""
        super().__init__()
        device = resolve_device(device)
        self.cfg = cfg
        self.E1 = ContentEncoder(cfg)
        self.E2 = ColorEncoder(cfg)
        self.G = Generator(cfg)
        # registered after G, so that E1, E2 and G draw the weights they drew
        # before D was ported
        self.D = Discriminator(cfg)
        gen = torch.Generator().manual_seed(seed)
        init_weights(self, gen)
        rscl = init_rscl_state(gen, code_dim=cfg.style_dim)
        self.register_buffer("rscl_queues", rscl["queues"], persistent=False)
        self.register_buffer("rscl_ptrs", rscl["ptrs"], persistent=False)
        self.num_d_iters = 0
        self.to(device)
        # a fixed network of the loss: outside the parameters and the state_dict
        object.__setattr__(self, "lpips", LPIPS().to(device))
        self.eval()

    @property
    def device(self) -> torch.device:
        return next(self.parameters()).device

    def load_reference_checkpoint(self, path: str):
        """Load E1/E2/G, and D when the file has it, from a reference
        ``.pth`` (the whole PPSTModel's state_dict, or a ``train.bundle``
        checkpoint; the RSCL queues and dead members are ignored) or from
        a JAX package checkpoint (``.msgpack``, through the weight bridge)."""
        if str(path).endswith(".msgpack"):
            sd = from_flax(read_checkpoint(path)["params"])
        else:
            sd = torch.load(path, map_location="cpu", weights_only=True)
        if "state_dict" in sd:
            sd = sd["state_dict"]
        own = self.state_dict()
        keys = [k for k in own if not k.startswith("D.") or any(j.startswith("D.") for j in sd)]
        missing = [k for k in keys if k not in sd]
        if missing:
            raise KeyError(f"checkpoint lacks {len(missing)} keys, e.g. {missing[:3]}")
        # the reference stores some biases as (1, C, 1, 1)
        self.load_state_dict({k: sd[k].reshape(own[k].shape) for k in keys}, strict=False)

    # -- training state ---------------------------------------------------

    def rscl_state(self) -> dict:
        return {"queues": self.rscl_queues, "ptrs": self.rscl_ptrs}

    def set_rscl_state(self, state: dict):
        self.rscl_queues, self.rscl_ptrs = state["queues"], state["ptrs"]

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
        with span("stylize:decode"):
            out = self.G(sp, list(gl), noises=noises, generator=generator)
        if target is None:
            return out
        with span("stylize:filter"):
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
        with span("stylize:extract"):
            cb, sb = self._extract_pair(content, style, generator)
        with span("stylize:warp"):
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
        with span("stylize:extract"):
            cb, sb = self._extract_pair(content, style, generator)
        with span("stylize:warp"):
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

    @torch.inference_mode()
    def snapshot_core(self, real, generator: Optional[torch.Generator] = None):
        """Structure code, reconstruction and batch-swapped style mix of
        ``real``: the training snapshot's core."""
        sp = self.E1(real)
        gl = self.E2(real).vectors
        rec = self.G(sp, list(gl), generator=generator)
        mix = self.G(sp, [self.swap(g) for g in gl], generator=generator)
        return sp, rec, mix

    def get_visuals_for_snapshot(self, real, generator: Optional[torch.Generator] = None):
        """Training snapshot visuals {real, layout, rec, mix} of ``real``
        (reference ppst_model.py:237-248, working): ``layout`` is the
        host-side PCA of the structure code, resized bilinearly to the
        image size."""
        sp, rec, mix = self.snapshot_core(real, generator)
        layout = torch.from_numpy(visualize_spatial_code(sp)).to(real.device, real.dtype)
        return {"real": real, "layout": resize_bilinear(layout, real.shape[1:3]), "rec": rec,
                "mix": mix}

    # -- training losses (reference ppst_model.py:105-235) -----------------
    # The batch helpers keep the JAX package's names. Each rank runs them on
    # its local batch, so they are the per-shard forms of JAX's (``n_dev``
    # shards): ``swap`` pairs, ``half_batch`` halves and ``shard_concat``
    # concatenates within the rank's batch, as the reference does per GPU.
    # D_rec, G_L1_cyc and L1_dist therefore compare only at equal world size.

    # swaps each consecutive pair of the rank's local batch (per shard in JAX)
    swap = staticmethod(batch_swap)

    @staticmethod
    def half_batch(x):
        """The first half of the rank's local batch (reference
        ppst_model.py:129-132, per GPU; JAX's ``half_batch(x, n_dev)`` per
        shard)."""
        return x[: x.shape[0] // 2]

    @staticmethod
    def shard_concat(parts):
        """The parts concatenated along the rank's local batch (JAX's
        ``shard_concat(parts, n_dev)`` within each shard)."""
        return torch.cat(parts, dim=0)

    @staticmethod
    def shard_split(x, sizes):
        return list(torch.split(x, sizes, dim=0))

    def _r(self, fn, kind: str):
        """``fn``, recomputed in the backward instead of keeping its
        activations (cfg.remat) when cfg.remat_nets names ``kind``: "all",
        or a comma list matched by prefix ("g" every g_* call site, "g_mix"
        only the rec + mix pass). With cfg.remat_save_kernels the prepared
        kernels are kept across the region (``save_kernels_policy``)."""
        nets = self.cfg.remat_nets
        if not self.cfg.remat or (nets != "all" and not any(
                kind == n or kind.startswith(n + "_") for n in nets.split(","))):
            return fn
        if self.cfg.remat_save_kernels:
            context_fn = functools.partial(create_selective_checkpoint_contexts,
                                           save_kernels_policy)
            return lambda *args: checkpoint(fn, *args, use_reentrant=False,
                                            context_fn=context_fn)
        return lambda *args: checkpoint(fn, *args, use_reentrant=False)

    def _g_pass(self, kind: str, extract_features: bool = False):
        """A G pass for the losses, rematerialized per ``_r``. Its noise is
        drawn from the generator BEFORE the checkpointed region: the
        recompute restores the default RNGs, not an explicit generator."""
        fn = self._r(lambda sp, gl, noises: self.G(
            sp, list(gl), extract_features=extract_features, noises=noises), kind)
        n_up = self.cfg.netE_num_downsampling_sp

        def run(sp, gl, generator):
            noises = make_fixed_noise(self.cfg, generator, sp.shape[0], sp.shape[1] * 2**n_up,
                                      dtype=sp.dtype)
            return fn(sp, tuple(gl), noises)

        return run

    # A correspondence handle of the losses is the dense (B, L, L) matrix or,
    # with cfg.corr_blockwise, a (q, k) pair of normalized descriptors that
    # is never multiplied out (ops.corr_blockwise): the 1024px training mode.

    def _training_corrs(self, sps):
        """(corr_sw, corr_self): corrm(sps, swap(sps)) and corrm(sps, sps).
        Blockwise, with n the normalized descriptors (split at
        cfg.g_fuse_ch, as the dense corrm): (swap(n), n) and (n, n)."""
        if not self.cfg.corr_blockwise:
            return self.corrm(sps, self.swap(sps)), self.corrm(sps, sps)
        n = corr_blockwise.normalize_desc(sps, split=self.cfg.g_fuse_ch)
        return (self.swap(n), n), (n, n)

    def _swap_corr(self, corr):
        """The batch-pair swap of a handle: both descriptors in qk form."""
        if isinstance(corr, tuple):
            return self.swap(corr[0]), self.swap(corr[1])
        return self.swap(corr)

    def _warp_any(self, x, corr):
        if isinstance(corr, tuple):
            return corr_blockwise.warp_qk(x, corr[0], corr[1], block=self.cfg.corr_block)
        return warp(x, corr)

    @staticmethod
    def _corr_kw(corr):
        """E2's keyword for a handle."""
        return {"corr_qk": corr} if isinstance(corr, tuple) else {"corrmatrix": corr}

    def discriminator_losses(self, real, mask, generator: torch.Generator):
        """D's losses (reference ppst_model.py:105-138). The generator-side
        passes carry no gradient; real, rec and mix are scored in one D
        pass. ``mask`` is unused, as in the reference.

        ``cfg.unbatch_passes`` (the 1024px mode): mix and rec in separate G
        passes, each part scored by its own D pass, D's forward recomputed in
        the backward (``_r(..., "d")``)."""
        cfg = self.cfg
        del mask
        self.num_d_iters += 1
        b = real.shape[0]
        assert b % 2 == 0, f"batch {b} must be even"
        g_fwd, g_ext = self._g_pass("g_mix"), self._g_pass("g_ext", extract_features=True)
        d_fwd = self._r(self.D, "d") if cfg.unbatch_passes else self.D
        with torch.no_grad():
            sp = self.E1(real)
            gl = list(self.E2(real).vectors)
            gl_w = None
            if cfg.training_stage == 2:
                _, feas, feas1 = g_ext(sp, gl, generator)
                corr_sw, corr_self = self._training_corrs(
                    torch.cat([feas, rselfcorr(feas1)], dim=-1))
                if cfg.lambda_StyleCon > 0.0:
                    gl_w = list(self.E2(real, **self._corr_kw(corr_sw)).vectors_w)
                # reconstruction styles are the self-corr-warped vectors
                gl = list(self.E2(real, **self._corr_kw(corr_self)).vectors_w)
            gl_half = [self.half_batch(g) for g in gl]
            mix = None
            if gl_w is not None and cfg.unbatch_passes:
                mix = g_fwd(self.swap(sp), gl_w, generator)
                rec = g_fwd(self.half_batch(sp), gl_half, generator)
            elif gl_w is not None:
                # one batched G pass for mix (B) and rec (B/2)
                g_out = g_fwd(self.shard_concat([self.swap(sp), self.half_batch(sp)]),
                              [self.shard_concat([w, h]) for w, h in zip(gl_w, gl_half)],
                              generator)
                mix, rec = self.shard_split(g_out, [b, b // 2])
            else:
                rec = g_fwd(self.half_batch(sp), gl_half, generator)

        losses = {}
        if cfg.lambda_GAN > 0.0:
            parts = [real, rec] + ([mix] if mix is not None else [])
            if cfg.unbatch_passes:
                scores = [d_fwd(p) for p in parts]
            else:
                scores = self.shard_split(d_fwd(self.shard_concat(parts)),
                                          [p.shape[0] for p in parts])
            losses["D_real"] = gan_loss(scores[0], True) * cfg.lambda_GAN
            losses["D_rec"] = gan_loss(scores[1], False) * 0.5 * cfg.lambda_GAN
            if len(scores) > 2:
                losses["D_mix"] = gan_loss(scores[2], False) * 0.5 * cfg.lambda_GAN
        return losses

    def r1_loss(self, real):
        """Lazy R1 gradient penalty (reference ppst_model.py:140-159): a
        double backward through D."""
        if self.cfg.lambda_R1 <= 0.0:
            return {"D_R1": torch.zeros((), device=real.device)}
        x = real.detach().requires_grad_(True)
        (grad,) = torch.autograd.grad(self.D(x).sum(), x, create_graph=True)
        penalty = (grad.float() ** 2).sum((1, 2, 3)) * (self.cfg.lambda_R1 * 0.5)
        return {"D_R1": penalty.mean()}

    def generator_losses(self, real, mask, generator: torch.Generator):
        """G's, E1's and E2's losses (reference ppst_model.py:161-235).
        Returns (losses, metrics, new RSCL state); the caller installs the
        state after the update."""
        cfg = self.cfg
        losses, metrics = {}, {}
        b = real.shape[0]
        assert b % 2 == 0, f"batch {b} must be even"
        e1 = self._r(self.E1, "e1")
        e2_plain = self._r(lambda x: tuple(self.E2(x).vectors), "e2")
        e2_w = self._r(lambda x, c: tuple(self.E2(x, **self._corr_kw(c)).vectors_w), "e2")
        e2_full = self._r(lambda x, c, m: self.E2(x, mask=m, **self._corr_kw(c)), "e2")
        e2_mask = self._r(lambda x, m: tuple(self.E2(x, mask=m).projections_m), "e2")
        g_mix, g_cyc = self._g_pass("g_mix"), self._g_pass("g_cyc")
        g_ext = self._g_pass("g_ext", extract_features=True)
        d_fwd = self._r(self.D, "d")
        lpips_fn = self._r(self.lpips, "lpips")
        new_rscl = self.rscl_state()

        sp = e1(real)
        gl = list(e2_plain(real))
        gl_w = pro_ms = pro_mw = None
        if cfg.training_stage == 2:
            _, feas, feas1 = g_ext(sp, gl, generator)
            corr_sw, corr_self = self._training_corrs(torch.cat([feas, rselfcorr(feas1)], dim=-1))
            gl = list(e2_w(real, corr_self))
            if cfg.lambda_StyleCon > 0.0:
                out = e2_full(real, corr_sw, mask)
                pro_ms, gl_w, pro_mw = out.projections_m, out.vectors_w, out.projections_mw
            if cfg.lambda_Cycwarp > 0.0:
                image_rec = self._warp_any(self._warp_any(real, corr_sw),
                                           self._swap_corr(corr_sw))
                losses["image_warp_reg"] = lpips_fn(image_rec, real).mean() * cfg.lambda_Cycwarp
            if cfg.lambda_Maskwarp > 0.0:
                losses["Mask_warp"] = (l1_loss(self._warp_any(mask, corr_sw), self.swap(mask))
                                       * cfg.lambda_Maskwarp)

        mix = None
        if cfg.training_stage == 2 and cfg.lambda_StyleCon > 0.0:
            # one batched G pass for rec (B) and mix (B); unbatch_passes
            # leaves it batched, as in the JAX package (ppst.py:431-440)
            g_out = g_mix(self.shard_concat([sp, self.swap(sp)]),
                          [self.shard_concat([a, w]) for a, w in zip(gl, gl_w)], generator)
            rec, mix = self.shard_split(g_out, [b, b])
        else:
            rec = g_mix(sp, gl, generator)
        if cfg.lambda_L1 > 0.0:
            losses["G_L1"] = l1_loss(rec, real) * cfg.lambda_L1

        if mix is not None:
            # one batched E2 mask-projection pass over both outputs
            pro_batched = e2_mask(self.shard_concat([mix, rec]),
                                  self.shard_concat([self.swap(mask), mask]))
            pro_3m, pro_2m = zip(*(self.shard_split(p, [b, b]) for p in pro_batched))
            sp_3 = e1(mix)
            cyc = g_cyc(self.half_batch(self.swap(sp_3)), [self.half_batch(g) for g in gl],
                        generator)
            metrics["L1_dist"] = l1_loss(cyc, self.half_batch(real))
            losses["G_L1_cyc"] = metrics["L1_dist"] * 3.0

            styleloss = styleloss2 = 0.0
            keys = []
            for scale in range(4):
                sl = slice(3 * scale, 3 * scale + 3)
                # region-major (3, B, style_dim) stacks
                key0 = torch.stack(pro_ms[sl]).detach()
                keyw = torch.stack(pro_mw[sl]).detach()
                queue = self.rscl_queues[scale].detach()
                styleloss = styleloss + rscl_loss_sharded(
                    torch.stack(pro_3m[sl]), keyw, key0, queue, cfg.nce_T)
                styleloss2 = styleloss2 + rscl_loss_sharded(
                    torch.stack(pro_2m[sl]), key0, keyw, queue, cfg.nce_T)
                keys += [key0, keyw]
            # every rank's keys in rank order, in one collective: (8, 3,
            # B_global, C), the same on every rank, so the queues stay equal
            world = parallel.world_size()
            keys = parallel.all_gather_cat(torch.stack(keys).float(), dim=2)
            for scale in range(4):
                new_rscl = rscl_enqueue(new_rscl, scale, keys[2 * scale], keys[2 * scale + 1],
                                        world)
            losses["G_styleContmix"] = styleloss * cfg.lambda_StyleCon
            losses["G_styleContrec"] = styleloss2 * cfg.lambda_StyleCon

        if cfg.lambda_GAN > 0.0:
            if mix is not None:
                s_rec, s_mix = self.shard_split(d_fwd(self.shard_concat([rec, mix])), [b, b])
                losses["G_GAN_rec"] = gan_loss(s_rec, True) * cfg.lambda_GAN * 0.5
                losses["G_GAN_mix"] = gan_loss(s_mix, True) * cfg.lambda_GAN
            else:
                losses["G_GAN_rec"] = gan_loss(d_fwd(rec), True) * cfg.lambda_GAN * 0.5
        return losses, metrics, new_rscl


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
