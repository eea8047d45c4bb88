"""StyleGAN2 building blocks as ``nn.Module``s on NHWC tensors.

Counterpart of ``ppst_tpu/nn/layers.py`` (reference
models/networks/stylegan2_layers.py). Parameters keep PyTorch's layouts
((out, in, kh, kw) convolutions, (out, in) linears) and the reference's
names, so a reference ``state_dict`` loads as it is. Activations are NHWC;
convolutions run on permuted views, which PyTorch treats as channels-last.

Weights are float32 and are cast to the activation's dtype where they are
used, as in the JAX package. ``reset_parameters(generator)`` draws each
layer's initial weights from the same distributions the JAX package uses.

The conv and linear layers prepare their kernels (the equalized-lr scale,
the folded blur, the upscaling kernel) inside ``saveable_kernel()``, the
counterpart of the JAX package's ``saveable_kernel`` tag: under
``remat_save_kernels`` the checkpointed training passes save what is
computed there instead of deriving it again in the backward's recompute
(``models.ppst.save_kernels_policy``). Elsewhere the tag does nothing.
"""

from __future__ import annotations

import contextlib
import math
import threading
from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ppst_tpu_torch.ops.fused_act import fused_leaky_relu, scaled_leaky_relu
from ppst_tpu_torch.ops.norm_act_cuda import norm_act
from ppst_tpu_torch.ops.styled_conv_cuda import styled_conv3x3
from ppst_tpu_torch.ops.styled_epilogue_cuda import styled_epilogue
from ppst_tpu_torch.ops.upfirdn2d import blur as blur_op
from ppst_tpu_torch.ops.upfirdn2d import reflect_pad


# ---------------------------------------------------------------------------
# Functional pieces
# ---------------------------------------------------------------------------

_preparing = threading.local()


@contextlib.contextmanager
def saveable_kernel():
    """Marks the operations run inside as the preparation of a kernel (on
    this thread, which is the one a checkpoint's recompute runs them on)."""
    depth = getattr(_preparing, "depth", 0)
    _preparing.depth = depth + 1
    try:
        yield
    finally:
        _preparing.depth = depth


def preparing_kernel() -> bool:
    """Whether this thread is inside ``saveable_kernel()``."""
    return getattr(_preparing, "depth", 0) > 0



def instance_norm(x, eps: float = 1e-5):
    """Per-sample per-channel normalization over H, W of NHWC ``x`` (torch
    InstanceNorm2d defaults), with float32 statistics. bfloat16 inputs use
    the one-pass E[x^2]-E[x]^2 variance, float32 inputs the two-pass one,
    as in the JAX package."""
    x32 = x.float()
    mean = x32.mean((1, 2), keepdim=True)
    if x.dtype == torch.bfloat16:
        var = ((x32 * x32).mean((1, 2), keepdim=True) - mean * mean).clamp_min(0.0)
    else:
        var = x32.var((1, 2), keepdim=True, unbiased=False)
    return ((x32 - mean) * torch.rsqrt(var + eps)).to(x.dtype)


def prelu(x, weight):
    """Single-parameter PReLU: x where x >= 0, else weight * x."""
    return x.clamp_min(0) + weight.to(x.dtype) * x.clamp_max(0)


def norm_act_chain(y, pre_bias=None, residual=None, act_bias=None, slope=None):
    """An instance norm and what follows it, as PyTorch composes it: ``y`` (a
    convolution's output) plus ``pre_bias`` (the conv's bias), the instance
    norm, plus ``residual``, then leaky ReLU x sqrt(2) with ``act_bias`` or
    PReLU with ``slope`` (each argument None: that step left out). The plain
    version of ``ops.norm_act_cuda.norm_act`` (the CPU tests' and the grad
    and float32 paths' arithmetic)."""
    if pre_bias is not None:
        y = y + pre_bias.to(y.dtype)
    y = instance_norm(y)
    if residual is not None:
        y = y + residual
    if act_bias is not None:
        return fused_leaky_relu(y, act_bias)
    return y if slope is None else prelu(y, slope)


def instance_norm_act(y, pre_bias=None, residual=None, act_bias=None, slope=None):
    """``norm_act_chain`` at an instance-norm site: in bfloat16 without grad,
    with a residual of y's dtype and a multiple of 8 channels, one op
    (``ops.norm_act_cuda.norm_act``, called as ``norm_act`` here: the kernels
    on the card, the composite on the CPU); else the composite."""
    if (y.dtype == torch.bfloat16 and not torch.is_grad_enabled() and y.shape[-1] % 8 == 0
            and (residual is None or residual.dtype == y.dtype)):
        return norm_act(y.contiguous(), pre_bias,
                        None if residual is None else residual.contiguous(), act_bias, slope)
    return norm_act_chain(y, pre_bias, residual, act_bias, slope)


def pad_hw(x, pad, mode: str = "constant"):
    """Pad the two spatial axes of NHWC ``x`` by (p0, p1) each."""
    y = F.pad(x.permute(0, 3, 1, 2), (pad[0], pad[1], pad[0], pad[1]), mode=mode)
    return y.permute(0, 2, 3, 1)


def conv2d(x, w, stride: int = 1, padding=0):
    """Convolution of NHWC ``x`` with an (out, in, kh, kw) kernel. ``padding``
    is an int or a (p0, p1) pair applied to both spatial axes."""
    if not isinstance(padding, int):
        if padding[0] == padding[1]:
            padding = padding[0]
        else:
            x, padding = pad_hw(x, padding), 0
    y = F.conv2d(x.permute(0, 3, 1, 2), w, stride=stride, padding=padding)
    return y.permute(0, 2, 3, 1)


def nearest_upsample2x(x):
    return x.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)


def _uniform_(t, bound, gen):
    t.uniform_(-bound, bound, generator=gen)


def init_weights(module: nn.Module, generator: torch.Generator):
    """Draw every layer's initial weights from ``generator``, in module order."""
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, _Init):
                m.reset_parameters(generator)


class _Init(nn.Module):
    """A layer that owns parameters and knows their initial distribution."""

    def reset_parameters(self, generator):  # pragma: no cover - abstract
        raise NotImplementedError


# ---------------------------------------------------------------------------
# Equalized-learning-rate layers (runtime weight scaling)
# ---------------------------------------------------------------------------


class EqualConv2d(_Init):
    """Conv with N(0,1) weights scaled at run time by 1/sqrt(fan_in)
    (reference stylegan2_layers.py:167-202).

    ``pre_blur``: taps of an antialiasing blur folded INTO the kernel (blur
    then correlate equals correlate with the blur/weight cross-correlation).
    ``padding`` is an int or a (p0, p1) pair."""

    def __init__(self, in_ch, out_ch, kernel_size, stride=1, padding=0, bias=True,
                 pre_blur: Optional[Sequence[float]] = None):
        super().__init__()
        self.stride, self.padding = stride, padding
        self.scale = 1.0 / math.sqrt(in_ch * kernel_size * kernel_size)
        self.weight = nn.Parameter(torch.empty(out_ch, in_ch, kernel_size, kernel_size))
        self.bias = nn.Parameter(torch.zeros(out_ch)) if bias else None
        # the folded blur is a buffer, so it moves with the module and no
        # call copies it from the host
        blur2d = None
        if pre_blur is not None:
            taps = np.asarray(pre_blur, np.float32)
            blur2d = torch.from_numpy(np.outer(taps, taps) / np.outer(taps, taps).sum())
        self.register_buffer("blur2d", blur2d, persistent=False)

    def reset_parameters(self, generator):
        self.weight.normal_(0.0, 1.0, generator=generator)
        if self.bias is not None:
            self.bias.zero_()

    def forward(self, x):
        y = self.convolve(x)
        if self.bias is not None:
            y = y + self.bias.to(y.dtype)
        return y

    def convolve(self, x):
        """The convolution without its bias."""
        with saveable_kernel():
            w = self.weight.to(x.dtype) * self.scale
            if self.blur2d is not None:
                o, i, k, _ = w.shape
                t = self.blur2d.shape[0]
                comp = F.conv2d(w.reshape(o * i, 1, k, k), self.blur2d.to(w.dtype)[None, None],
                                padding=t - 1)
                w = comp.reshape(o, i, k + t - 1, k + t - 1)
        return conv2d(x, w, self.stride, self.padding)


class EqualLinear(_Init):
    """Linear with run-time 1/sqrt(fan_in) scaling and an optional fused
    bias + leaky ReLU activation (reference stylegan2_layers.py:205-247)."""

    def __init__(self, in_dim, out_dim, activation: Optional[str] = None):
        super().__init__()
        assert activation in (None, "fused_lrelu"), activation
        self.scale = 1.0 / math.sqrt(in_dim)
        self.activation = activation
        self.weight = nn.Parameter(torch.empty(out_dim, in_dim))
        self.bias = nn.Parameter(torch.zeros(out_dim))

    def reset_parameters(self, generator):
        self.weight.normal_(0.0, 1.0, generator=generator)
        self.bias.zero_()

    def forward(self, x):
        with saveable_kernel():
            w = self.weight.to(x.dtype) * self.scale
        y = F.linear(x, w)
        if self.activation == "fused_lrelu":
            return fused_leaky_relu(y, self.bias)
        return y + self.bias.to(y.dtype)


class FusedLeakyReLU(_Init):
    """Learned bias + leaky ReLU + sqrt(2) gain (reference fused_act.py)."""

    def __init__(self, channels):
        super().__init__()
        self.bias = nn.Parameter(torch.zeros(channels))

    def reset_parameters(self, generator):
        self.bias.zero_()

    def forward(self, x):
        return fused_leaky_relu(x, self.bias)


# ---------------------------------------------------------------------------
# TF-StyleGAN-style equalized layers (He std baked into init)
# ---------------------------------------------------------------------------


class EqualizedLinear(_Init):
    """TF-StyleGAN linear with use_wscale and gain 1, as StyleMod builds it
    (reference stylegan2_layers.py:249-273): N(0,1) weights times
    1/sqrt(fan_in)."""

    def __init__(self, in_dim, out_dim):
        super().__init__()
        self.w_mul = 1.0 / math.sqrt(in_dim)
        self.weight = nn.Parameter(torch.empty(out_dim, in_dim))
        self.bias = nn.Parameter(torch.zeros(out_dim))

    def reset_parameters(self, generator):
        self.weight.normal_(0.0, 1.0, generator=generator)
        self.bias.zero_()

    def forward(self, x):
        with saveable_kernel():
            w = self.weight.to(x.dtype) * self.w_mul
        return F.linear(x, w) + self.bias.to(x.dtype)


class EqualizedConv2d(_Init):
    """Conv with He-std init (gain sqrt(2)) and optional 2x upscaling
    (reference stylegan2_layers.py:275-348). The reference fuses the upscale
    into a transposed convolution for outputs of 128 and more, and runs
    nearest upsampling plus a conv below that."""

    def __init__(self, in_ch, out_ch, kernel_size, upscale=False):
        super().__init__()
        self.upscale = upscale
        self.std = math.sqrt(2.0) / math.sqrt(in_ch * kernel_size * kernel_size)
        self.weight = nn.Parameter(torch.empty(out_ch, in_ch, kernel_size, kernel_size))
        self.bias = nn.Parameter(torch.zeros(out_ch))

    def reset_parameters(self, generator):
        self.weight.normal_(0.0, self.std, generator=generator)
        self.bias.zero_()

    def forward(self, x):
        y = self.convolve(x)
        return y + self.bias.to(y.dtype)

    def convolve(self, x):
        """The convolution without its bias."""
        with saveable_kernel():
            w = self.weight.to(x.dtype)
        k = w.shape[-1]
        if self.upscale and min(x.shape[1], x.shape[2]) * 2 >= 128:
            # pad the kernel by one, sum its four shifted copies, and run a
            # stride-2 transposed conv
            with saveable_kernel():
                wp = F.pad(w, (1, 1, 1, 1))
                w4 = (wp[:, :, 1:, 1:] + wp[:, :, :-1, 1:] + wp[:, :, 1:, :-1]
                      + wp[:, :, :-1, :-1])
            y = F.conv_transpose2d(x.permute(0, 3, 1, 2), w4.transpose(0, 1), stride=2,
                                   padding=k // 2)
            y = y.permute(0, 2, 3, 1)
        elif self.upscale:
            y = conv2d(nearest_upsample2x(x), w, padding=k // 2)
        else:
            y = conv2d(x, w, padding=k // 2)
        return y


# ---------------------------------------------------------------------------
# Style modulation / noise
# ---------------------------------------------------------------------------


class StyleMod(nn.Module):
    """x * (scale + 1) + shift with (scale, shift) from the style vector
    (reference stylegan2_layers.py:361-374)."""

    def __init__(self, channels, style_dim):
        super().__init__()
        self.channels = channels
        self.lin = EqualizedLinear(style_dim, channels * 2)

    def forward(self, x, latent):
        return modulate(x, self.lin(latent))


def modulate(x, style):
    """x * (scale + 1) + shift, with ``style`` (B, 2C) = [scale, shift] for
    x's C channels."""
    c = x.shape[-1]
    return x * (style[:, None, None, :c] + 1.0) + style[:, None, None, c:]


class LayerEpilogue(nn.Module):
    """InstanceNorm then StyleMod (reference stylegan2_layers.py:414-437)."""

    def __init__(self, channels, style_dim):
        super().__init__()
        self.style_mod = StyleMod(channels, style_dim)

    def forward(self, x, latent):
        return self.style_mod(instance_norm(x), latent)


class NoiseInjection(_Init):
    """The learned scalar gain of additive single-channel noise (reference
    stylegan2_layers.py:376-399); StyledConv adds ``gain * noise`` in its
    epilogue (``styled_conv_epilogue``)."""

    def __init__(self):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(1))

    def reset_parameters(self, generator):
        self.weight.zero_()

    @staticmethod
    def draw(b, h, w, like, generator=None):
        """Noise (B, H, W, 1) in ``like``'s dtype and on its device, from
        ``generator``."""
        return torch.randn((b, h, w, 1), generator=generator, device=like.device, dtype=like.dtype)


def styled_conv_epilogue(y, conv_bias, gain, noise, bias, act_bias, style):
    """StyledConv's chain after its convolution, as PyTorch composes it: the
    conv's bias, ``gain * noise`` (with ``noise`` None, none), StyledConv's
    bias, leaky ReLU with the activation's bias and gain, the instance norm
    and the modulation by ``style`` (B, 2C), the StyleMod linear's output.
    ``y`` is the convolution's output before its bias. The plain version of
    ``ops.styled_epilogue_cuda.styled_epilogue`` (the CPU tests' and the
    grad and float32 paths' arithmetic)."""
    y = y + conv_bias.to(y.dtype)
    if noise is not None:
        y = y + gain.to(y.dtype) * noise
    y = fused_leaky_relu(y + bias.to(y.dtype), act_bias)
    return modulate(instance_norm(y), style)


class StyledConv(nn.Module):
    """EqualizedConv2d -> noise -> bias -> fused lrelu -> epilogue (reference
    stylegan2_layers.py:439-475): activation-space modulation with two
    learned biases, StyledConv's own and the activation's.

    ``fused``: a non-upsampled 3x3 StyledConv in bfloat16 runs the whole chain
    as one fused op (``ops.styled_conv_cuda.styled_conv3x3``): the kernels on
    the card, their plain versions on the CPU. Same parameters; pinned noise
    is cast to bfloat16 there, so float32 noise does not promote the fused
    chain. Otherwise the convolution runs alone and its epilogue
    (``styled_conv_epilogue``, the composite of the JAX package) follows; in
    bfloat16 without grad, with noise drawn or pinned in bfloat16 and a
    multiple of 8 channels, the epilogue is one op
    (``ops.styled_epilogue_cuda.styled_epilogue``: the kernels on the card,
    the composite on the CPU). Pinned float32 noise promotes the composite to
    float32 (ROADMAP W6) and keeps it."""

    def __init__(self, in_ch, out_ch, kernel_size, style_dim, upsample=False,
                 use_noise=True, fused=False):
        super().__init__()
        self.fused = fused and not upsample and kernel_size == 3
        self.conv = EqualizedConv2d(in_ch, out_ch, kernel_size, upscale=upsample)
        self.noise = NoiseInjection() if use_noise else None
        self.bias = nn.Parameter(torch.zeros(1, out_ch, 1, 1))
        self.activate = FusedLeakyReLU(out_ch)
        self.epi1 = LayerEpilogue(out_ch, style_dim)

    def _fused(self, x, style, noise, generator):
        b, h, w, _ = x.shape
        if self.noise is not None:
            gain = self.noise.weight
            if noise is None:
                noise = NoiseInjection.draw(b, h, w, x, generator)
        else:
            gain = torch.zeros(1, device=x.device)
            noise = torch.zeros((b, h, w, 1), device=x.device, dtype=x.dtype)
        s = self.epi1.style_mod.lin(style)
        c = self.epi1.style_mod.channels
        b_total = self.conv.bias + self.bias.reshape(-1) + self.activate.bias
        return styled_conv3x3(x, self.conv.weight, noise, gain, b_total, s[:, :c], s[:, c:])

    def forward(self, x, style, noise=None, generator=None):
        if self.fused and x.dtype == torch.bfloat16:
            return self._fused(x, style, noise, generator)
        gain = None
        if self.noise is None:
            noise = None
        else:
            gain = self.noise.weight
            if noise is None:
                # the conv's output shape; the conv draws nothing, so the
                # generator gives what it gave when noise followed the conv
                b, h, w, _ = x.shape
                f = 2 if self.conv.upscale else 1
                noise = NoiseInjection.draw(b, f * h, f * w, x, generator)
        s = self.epi1.style_mod.lin(style)
        if (x.dtype == torch.bfloat16 and not torch.is_grad_enabled()
                and self.conv.weight.shape[0] % 8 == 0 and (noise is None or noise.dtype == x.dtype)):
            return styled_epilogue(self.conv.convolve(x).contiguous(), self.conv.bias, gain,
                                   None if noise is None else noise.contiguous(),
                                   self.bias.reshape(-1), self.activate.bias, s)
        # passed by position and held by no name here, the conv's output is the
        # epilogue's alone: its first add frees it, as when the conv added its bias
        return styled_conv_epilogue(self.conv.convolve(x), self.conv.bias, gain, noise,
                                    self.bias.reshape(-1), self.activate.bias, s)


class ToRGB(nn.Module):
    """1x1 conv to RGB + bias + epilogue (reference stylegan2_layers.py:477-495)."""

    def __init__(self, in_ch, style_dim):
        super().__init__()
        self.conv = EqualConv2d(in_ch, 3, 1)
        self.bias = nn.Parameter(torch.zeros(1, 3, 1, 1))
        self.epi1 = LayerEpilogue(3, style_dim)

    def forward(self, x, style):
        y = self.conv(x)
        y = y + self.bias.reshape(-1).to(y.dtype)
        return self.epi1(y, style)


# ---------------------------------------------------------------------------
# Conv layer / residual blocks
# ---------------------------------------------------------------------------


class ConvLayer(nn.Module):
    """[Blur if downsample] -> EqualConv2d -> [InstanceNorm] -> activation
    (reference stylegan2_layers.py:497-555). A downsampling conv folds its
    antialias blur into the kernel; a one-tap blur (no antialiasing) runs
    as its own pass. With the instance norm, the conv's bias, the norm and
    the fused leaky ReLU are one site (``instance_norm_act``)."""

    def __init__(self, in_ch, out_ch, kernel_size, downsample=False,
                 blur_kernel: Sequence[int] = (1, 3, 3, 1), bias=True, activate=True,
                 norm="none", reflection_pad=False):
        super().__init__()
        k = kernel_size
        self.norm, self.reflection_pad = norm, reflection_pad
        self.blur = None  # (taps, (pad0, pad1)) of a separate blur pass
        self.pre_pad = None  # reflection pad applied before the conv
        pre_blur = None
        if downsample:
            p = (len(blur_kernel) - 2) + (k - 1)
            pad0, pad1 = (p + 1) // 2, p // 2
            stride = 2
            if len(blur_kernel) > 1:
                pre_blur = tuple(blur_kernel)
                if reflection_pad:
                    self.pre_pad, conv_pad = (pad0, pad1), 0
                else:
                    conv_pad = (pad0, pad1)
            else:
                self.blur = (np.asarray(blur_kernel, np.float32), (pad0, pad1))
                conv_pad = 0
        else:
            stride = 1
            conv_pad = k // 2
            if reflection_pad and conv_pad > 0:
                self.pre_pad, conv_pad = (conv_pad, conv_pad), 0
        self.Conv = EqualConv2d(in_ch, out_ch, k, stride=stride, padding=conv_pad,
                                bias=bias and not activate, pre_blur=pre_blur)
        self.activate = activate
        self.Act = FusedLeakyReLU(out_ch) if activate and bias else None

    def forward(self, x):
        if self.blur is not None:
            x = blur_op(x, self.blur[0], self.blur[1], reflection_pad=self.reflection_pad)
        elif self.pre_pad is not None:
            x = reflect_pad(x, *self.pre_pad)
        if self.norm == "in":
            # the conv's bias, the norm and the activation's bias as one site
            y = instance_norm_act(self.Conv.convolve(x), pre_bias=self.Conv.bias,
                                  act_bias=None if self.Act is None else self.Act.bias)
            return scaled_leaky_relu(y) if self.activate and self.Act is None else y
        y = self.Conv(x)
        if self.activate:
            y = self.Act(y) if self.Act is not None else scaled_leaky_relu(y)
        return y


class ResBlock(nn.Module):
    """(conv3 + conv3-down + 1x1-skip-down) / sqrt(2) (reference
    stylegan2_layers.py:559-579); the encoders reflection-pad the 3x3
    convs, the discriminator zero-pads them."""

    def __init__(self, in_ch, out_ch, blur_kernel=(1, 3, 3, 1), norm="none",
                 reflection_pad=True):
        super().__init__()
        self.conv1 = ConvLayer(in_ch, in_ch, 3, reflection_pad=reflection_pad, norm=norm)
        self.conv2 = ConvLayer(in_ch, out_ch, 3, downsample=True, blur_kernel=blur_kernel,
                               reflection_pad=reflection_pad, norm=norm)
        self.skip = ConvLayer(in_ch, out_ch, 1, downsample=True, blur_kernel=blur_kernel,
                              activate=False, bias=False, norm=norm)

    def forward(self, x):
        return (self.conv2(self.conv1(x)) + self.skip(x)) / math.sqrt(2.0)


# ---------------------------------------------------------------------------
# Plain torch-style layers (feature branch / projection heads)
# ---------------------------------------------------------------------------


class PReLU(_Init):
    """Single-parameter PReLU, init 0.25 (torch default)."""

    def __init__(self):
        super().__init__()
        self.weight = nn.Parameter(torch.full((1,), 0.25))

    def reset_parameters(self, generator):
        self.weight.fill_(0.25)

    def forward(self, x):
        return prelu(x, self.weight)


class TorchConv2d(_Init):
    """nn.Conv2d (no padding) with torch's default init, on NHWC tensors."""

    def __init__(self, in_ch, out_ch, kernel_size):
        super().__init__()
        self.fan_in = in_ch * kernel_size * kernel_size
        self.weight = nn.Parameter(torch.empty(out_ch, in_ch, kernel_size, kernel_size))
        self.bias = nn.Parameter(torch.empty(out_ch))

    def reset_parameters(self, generator):
        bound = 1.0 / math.sqrt(self.fan_in)
        _uniform_(self.weight, bound, generator)
        _uniform_(self.bias, bound, generator)

    def forward(self, x):
        return self.convolve(x) + self.bias.to(x.dtype)

    def convolve(self, x):
        """The convolution without its bias."""
        return conv2d(x, self.weight.to(x.dtype))


class TorchLinear(_Init):
    """nn.Linear with normal(0, std) weights and zero biases (the reference's
    init_net'd projector MLPs)."""

    def __init__(self, in_dim, out_dim, std: float):
        super().__init__()
        self.std = std
        self.weight = nn.Parameter(torch.empty(out_dim, in_dim))
        self.bias = nn.Parameter(torch.empty(out_dim))

    def reset_parameters(self, generator):
        self.weight.normal_(0.0, self.std, generator=generator)
        self.bias.zero_()

    def forward(self, x):
        return F.linear(x, self.weight.to(x.dtype)) + self.bias.to(x.dtype)
