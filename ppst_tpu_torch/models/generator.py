"""G: StyleGAN2-resnet generator with multi-scale style routing and the
correspondence feature branch (counterpart of
``ppst_tpu/models/generator.py``; reference
models/networks/generator.py:104-281).

* SpatialCodeModulation -> ``netG_num_base_resnet_layers`` styled resblocks
  at structure-code resolution -> one upsampling styled resblock per
  encoder downsampling -> ToRGB. Head blocks use global_codes[-1],
  upsampling block j uses global_codes[-2-j], ToRGB global_codes[0]; all
  codes are normalized on entry.
* ``cfg.fused_styled_conv``: in bfloat16 the non-upsampled 3x3 StyledConvs
  (both of each head block, conv2 of each upsampling block) run the fused
  chain of ``ops.styled_conv_cuda``.
* ``extract_features``: taps of the detached trunk at each resolution
  through small conv stacks, fused by ``layert`` (-> ``feat`` at structure
  resolution) and ``layert1`` (-> ``feat1`` at 4x that), feeding
  corrm/Rselfcorr.
* ``cfg.remat_blocks`` / ``cfg.remat_taps`` (under grad only): each head and
  upsampling block, or each feature tap and fuse block, is recomputed in the
  backward (``torch.utils.checkpoint``) instead of keeping its activations,
  as ``nn.remat`` does in the JAX package. Parameters and ``state_dict`` keys
  do not change. Noise must come in through ``noises`` (or the global RNG,
  which the checkpoint restores): an explicit ``generator`` would draw anew
  in the recompute.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
from torch.utils.checkpoint import checkpoint

from ppst_tpu_torch.models.config import PPSTConfig
from ppst_tpu_torch.nn.layers import (
    ConvLayer,
    EqualLinear,
    PReLU,
    StyledConv,
    ToRGB,
    TorchConv2d,
    instance_norm,
    pad_hw,
)
from ppst_tpu_torch.ops.corr import adaptive_avg_pool, resize_bilinear
from ppst_tpu_torch.ops.tap_cuda import fused_tap_1x1


def _pad_replicate(x, p: int):
    return pad_hw(x, (p, p), mode="replicate")


def _style_normalize(v):
    """v * rsqrt(sum(v^2) + 1e-8) (reference util/util.py:18-22), in float32."""
    v32 = v.float()
    return (v32 * torch.rsqrt((v32 * v32).sum(-1, keepdim=True) + 1e-8)).to(v.dtype)


class GeneratorModulation(nn.Module):
    """x * scale(style) + bias(style) (reference generator.py:80-91)."""

    def __init__(self, style_dim, channels):
        super().__init__()
        self.scale = EqualLinear(style_dim, channels)
        self.bias = EqualLinear(style_dim, channels)

    def forward(self, x, style):
        return x * self.scale(style)[:, None, None, :] + self.bias(style)[:, None, None, :]


class ResolutionPreservingResnetBlock(nn.Module):
    """(skip + styledconv x2) / sqrt(2) (reference generator.py:47-60)."""

    def __init__(self, in_ch, out_ch, style_dim, fused=False):
        super().__init__()
        self.conv1 = StyledConv(in_ch, out_ch, 3, style_dim, fused=fused)
        self.conv2 = StyledConv(out_ch, out_ch, 3, style_dim, fused=fused)
        self.skip = (ConvLayer(in_ch, out_ch, 1, activate=False, bias=False)
                     if in_ch != out_ch else None)

    def forward(self, x, style, noises=(None, None), generator=None):
        res = self.conv1(x, style, noises[0], generator)
        res = self.conv2(res, style, noises[1], generator)
        skip = self.skip(x) if self.skip is not None else x
        return (skip + res) / math.sqrt(2.0)


class UpsamplingResnetBlock(nn.Module):
    """Upsampling styled resblock with a bilinear skip
    (reference generator.py:63-77). ``fused`` reaches conv2 only: the
    upsampling conv1 always runs the composite, as in the JAX package."""

    def __init__(self, in_ch, out_ch, style_dim, use_noise=False, fused=False):
        super().__init__()
        self.conv1 = StyledConv(in_ch, out_ch, 3, style_dim, upsample=True,
                                use_noise=use_noise)
        self.conv2 = StyledConv(out_ch, out_ch, 3, style_dim, use_noise=use_noise,
                                fused=fused)
        self.skip = (ConvLayer(in_ch, out_ch, 1, activate=True, bias=True)
                     if in_ch != out_ch else None)

    def forward(self, x, style, noises=(None, None), generator=None):
        res = self.conv1(x, style, noises[0], generator)
        res = self.conv2(res, style, noises[1], generator)
        skip = self.skip(x) if self.skip is not None else x
        skip = resize_bilinear(skip, (skip.shape[1] * 2, skip.shape[2] * 2))
        return (skip + res) / math.sqrt(2.0)


class _ResidualBlock(nn.Module):
    """Plain residual block with one PReLU shared after both convs
    (reference generator.py:10-32)."""

    def __init__(self, channels):
        super().__init__()
        self.conv1 = TorchConv2d(channels, channels, 3)
        self.conv2 = TorchConv2d(channels, channels, 3)
        self.prelu = PReLU()

    def forward(self, x):
        y = self.prelu(instance_norm(self.conv1(_pad_replicate(x, 1))))
        y = instance_norm(self.conv2(_pad_replicate(y, 1)))
        return self.prelu(y + x)


class _FeatureTap(nn.Module):
    """Per-resolution feature tap (reference generator.py:174-224: layer32/
    64/128 = padded 3x3 stack, layer256 = 1x1 stack). Children carry the
    reference Sequential's indices: 2 and 6 are the convs, 4 and 8 the
    PReLUs. The leading instance norm runs on the padded input.

    ``fused``: the 1x1 stack in bfloat16 runs as one fused chain
    (``ops.tap_cuda.fused_tap_1x1``): the kernel on the card, its plain
    version on the CPU."""

    def __init__(self, in_ch, conv1x1=False, feature_ch=256, fused=False):
        super().__init__()
        mid, out = feature_ch // 2, feature_ch // 4
        self.conv1x1, self.fused = conv1x1, fused
        k, c1 = (1, out) if conv1x1 else (3, mid)
        self.add_module("2", TorchConv2d(in_ch, c1, k))
        self.add_module("4", PReLU())
        self.add_module("6", TorchConv2d(c1, out, k))
        self.add_module("8", PReLU())

    def forward(self, x):
        conv1, prelu1, conv2, prelu2 = (self._modules[k] for k in ("2", "4", "6", "8"))
        if self.conv1x1:
            if self.fused and x.dtype == torch.bfloat16:
                return fused_tap_1x1(x.contiguous(), conv1.weight[:, :, 0, 0], conv1.bias,
                                     prelu1.weight,
                                     conv2.weight[:, :, 0, 0], conv2.bias, prelu2.weight)
            y = prelu1(instance_norm(conv1(instance_norm(x))))
            return prelu2(instance_norm(conv2(y)))
        y = prelu1(instance_norm(conv1(instance_norm(_pad_replicate(x, 1)))))
        return prelu2(instance_norm(conv2(_pad_replicate(y, 1))))


class Generator(nn.Module):
    def __init__(self, cfg: PPSTConfig):
        super().__init__()
        self.cfg = cfg
        fused = cfg.fused_styled_conv
        sd, n_up = cfg.style_dim, cfg.netE_num_downsampling_sp
        self.SpatialCodeModulation = GeneratorModulation(sd, cfg.spatial_code_ch)
        ch = cfg.spatial_code_ch
        for i in range(cfg.netG_num_base_resnet_layers):
            out_ch = max(cfg.spatial_code_ch,
                         round((i + 1) / cfg.netG_num_base_resnet_layers * cfg.nf_g(0)))
            self.add_module(f"HeadResnetBlock{i}",
                            ResolutionPreservingResnetBlock(ch, out_ch, sd, fused=fused))
            ch = out_ch
        fc = cfg.netG_resnet_ch  # reference feature_channel (generator.py:226)
        self.add_module("layer32", _FeatureTap(ch, feature_ch=fc))
        for j in range(n_up):
            self.add_module(f"UpsamplingResBlock{2 ** (4 + j)}", UpsamplingResnetBlock(
                ch, cfg.nf_g(j + 1), sd, use_noise=cfg.netG_use_noise, fused=fused))
            ch = cfg.nf_g(j + 1)
            self.add_module(f"layer{2 ** (6 + j)}", _FeatureTap(
                ch, conv1x1=(j == n_up - 1), feature_ch=fc, fused=cfg.fused_tap))
        self.ToRGB = ToRGB(ch, sd)
        fuse_ch = cfg.g_fuse_ch  # concat of the n_up+1 taps
        self.layert = nn.Sequential(*[_ResidualBlock(fuse_ch) for _ in range(3)])
        self.layert1 = nn.Sequential(_ResidualBlock(fuse_ch), TorchConv2d(fuse_ch, fc // 4, 1))

    def _run(self, remat: bool, fn, *args):
        """``fn(*args)``, checkpointed when ``remat`` and grad is enabled."""
        if remat and torch.is_grad_enabled():
            return checkpoint(fn, *args, use_reentrant=False)
        return fn(*args)

    def forward(self, spatial_code, global_codes, extract_features: bool = False,
                noises=None, generator=None):
        """``noises``: optional flat list of fixed per-StyledConv noise tensors
        in call order (2 per head block, then 2 per upsampling block), as
        ``make_fixed_noise`` builds it. Otherwise noise is drawn from
        ``generator``. Returns rgb, or (rgb, feat, feat1) with
        ``extract_features``."""
        cfg = self.cfg
        n_up = cfg.netE_num_downsampling_sp
        codes = [_style_normalize(c) for c in global_codes]
        noise_it = iter(noises) if noises is not None else None
        blocks, taps = cfg.remat_blocks, cfg.remat_taps
        if blocks and noises is None and generator is not None and torch.is_grad_enabled():
            raise ValueError("Generator: remat_blocks under grad needs the noise passed in "
                             "(noises=...), not drawn from a generator")

        def take2():
            return (None, None) if noise_it is None else (next(noise_it), next(noise_it))

        x = self.SpatialCodeModulation(spatial_code, codes[-1])
        for i in range(cfg.netG_num_base_resnet_layers):
            x = self._run(blocks, getattr(self, f"HeadResnetBlock{i}"), x, codes[-1], take2(),
                          generator)
        # the taps read a detached trunk: their losses train only the feature
        # branch, never the trunk above it
        feas = [self._run(taps, self.layer32, x.detach())] if extract_features else []
        h0, w0 = x.shape[1], x.shape[2]
        for j in range(n_up):
            x = self._run(blocks, getattr(self, f"UpsamplingResBlock{2 ** (4 + j)}"),
                          x, codes[-2 - j], take2(), generator)
            if extract_features:
                feas.append(self._run(taps, getattr(self, f"layer{2 ** (6 + j)}"), x.detach()))

        rgb = self.ToRGB(x, codes[0])
        if not extract_features:
            return rgb
        feat = torch.cat(
            [feas[0]] + [adaptive_avg_pool(f, (h0, w0)) for f in feas[1:]], dim=-1)
        # 4*grid (== 256 at 512px) generalizes the reference's fixed 256x256
        feat1 = torch.cat([resize_bilinear(f, (4 * h0, 4 * w0)) for f in feas], dim=-1)
        for block in self.layert:
            feat = self._run(taps, block, feat)
        feat1 = self.layert1[1](self._run(taps, self.layert1[0], feat1))
        return rgb, feat, feat1


def make_fixed_noise(cfg: PPSTConfig, generator: torch.Generator, batch: int, crop: int,
                     dtype=torch.float32):
    """A fixed noise list: one (B, H, W, 1) tensor per StyledConv in call
    order, for ``Generator.forward(noises=...)``, on the generator's device.
    Float32 noise promotes a bf16 generator to float32 (ROADMAP W6); pass
    the compute ``dtype`` to keep it in bf16."""
    grid = crop // (2 ** cfg.netE_num_downsampling_sp)
    shapes = [grid] * (2 * cfg.netG_num_base_resnet_layers)
    h = grid
    for _ in range(cfg.netE_num_downsampling_sp):
        h *= 2
        shapes += [h, h]
    return [torch.randn((batch, s, s, 1), generator=generator, device=generator.device).to(dtype)
            for s in shapes]
