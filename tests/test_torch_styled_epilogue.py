"""The StyledConv epilogue op (``ops/styled_epilogue_cuda.py``) on the CPU:
its plain version, the factored composite ``nn.layers.styled_conv_epilogue``,
against a copy of StyledConv's chain as it was composed before the factoring
(bit for bit, in float32 and bf16, with and without grad); which passes take
the op; the noise draws around it; the wrapper's checks; and the slab plan of
every generator shape. The kernels themselves run only on the card
(``chip_smoke.py``'s ``styled_epilogue`` phase)."""

import ctypes
import math
import re

import pytest
import torch

from ppst_tpu_torch.models.config import PPSTConfig
from ppst_tpu_torch.models.generator import Generator, make_fixed_noise
from ppst_tpu_torch.nn import layers
from ppst_tpu_torch.nn.layers import StyledConv, init_weights
from ppst_tpu_torch.ops import _slabs
from ppst_tpu_torch.ops import styled_epilogue_cuda as se

NARROW = dict(crop_size=64, netE_scale_capacity=0.25, netE2_scale_capacity=0.25,
              global_code_ch=64, spatial_code_ch=16, netG_resnet_ch=32,
              netG_scale_capacity=0.125)
STYLE_DIM = 12


def _old_instance_norm(x, eps=1e-5):
    x32 = x.float()
    mean = x32.mean((1, 2), keepdim=True)
    if x.dtype == torch.bfloat16:
        var = ((x32 * x32).mean((1, 2), keepdim=True) - mean * mean).clamp_min(0.0)
    else:
        var = x32.var((1, 2), keepdim=True, unbiased=False)
    return ((x32 - mean) * torch.rsqrt(var + eps)).to(x.dtype)


def old_styled_conv(sc, x, latent, noise=None, generator=None):
    """StyledConv's composite chain as it stood before the epilogue was
    factored out: EqualizedConv2d (with its bias) -> NoiseInjection -> bias
    -> fused leaky ReLU -> InstanceNorm -> StyleMod."""
    y = sc.conv(x)
    if sc.noise is not None:
        if noise is None:
            b, h, w, _ = y.shape
            noise = torch.randn((b, h, w, 1), generator=generator, device=y.device,
                                dtype=y.dtype)
        y = y + sc.noise.weight.to(y.dtype) * noise
    y = y + sc.bias.reshape(-1).to(y.dtype)
    y = y + sc.activate.bias.to(y.dtype)
    y = torch.where(y >= 0, y, y * 0.2) * math.sqrt(2.0)
    y = _old_instance_norm(y)
    style = sc.epi1.style_mod.lin(latent)
    c = sc.epi1.style_mod.channels
    return y * (style[:, None, None, :c] + 1.0) + style[:, None, None, c:]


def _nonzero(module, seed=3):
    """Weights from the seed, and nonzero biases and noise gains (zero at init)."""
    g = torch.Generator().manual_seed(seed)
    init_weights(module, g)
    with torch.no_grad():
        for name, p in module.named_parameters():
            if "bias" in name or "noise" in name:
                p.copy_(torch.empty(p.shape).uniform_(-0.3, 0.3, generator=g))
    return module


# (StyledConv keyword arguments, input (B, H, W, Cin)): a head conv, an
# upsampling conv below 128px (nearest + conv) and at 128px (the transposed
# conv), a conv without noise
KINDS = {
    "head": (dict(upsample=False), (2, 8, 8, 16)),
    "up_nearest": (dict(upsample=True), (2, 8, 8, 16)),
    "up_transposed": (dict(upsample=True), (1, 64, 64, 16)),
    "no_noise": (dict(upsample=False, use_noise=False), (2, 8, 8, 16)),
}


@pytest.mark.parametrize("grad", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kind", list(KINDS))
def test_twin_equals_the_composite_chain(kind, dtype, grad):
    kw, shape = KINDS[kind]
    sc = _nonzero(StyledConv(shape[-1], 24, 3, STYLE_DIM, **kw))
    g = torch.Generator().manual_seed(11)
    x = torch.randn(shape, generator=g).to(dtype)
    latent = torch.randn((shape[0], STYLE_DIM), generator=g).to(dtype)
    out_hw = shape[1] * (2 if kw["upsample"] else 1)
    pinned = torch.randn((shape[0], out_hw, out_hw, 1), generator=g).to(dtype)
    x.requires_grad_(grad)

    def run(fn, **noise):
        sc.zero_grad()
        with torch.set_grad_enabled(grad):
            out = fn(sc, x, latent, **noise)
        if not grad:
            return out, []
        (out.float() * torch.linspace(-1, 1, out.numel()).reshape(out.shape)).sum().backward()
        grads = [p.grad.clone() for p in sc.parameters()] + [x.grad.clone()]
        x.grad = None
        return out, grads

    def noise(how):
        return (dict(noise=pinned) if how == "pinned"
                else dict(generator=torch.Generator().manual_seed(5)))

    for how in ("pinned", "drawn"):
        want, want_g = run(old_styled_conv, **noise(how))
        got, got_g = run(lambda m, *a, **k: m(*a, **k), **noise(how))
        assert got.dtype == want.dtype == dtype
        assert torch.equal(got, want)
        assert len(got_g) == len(want_g)
        assert all(torch.equal(a, b) for a, b in zip(got_g, want_g))


class Count:
    """Wraps ``nn.layers.styled_epilogue`` (the name StyledConv calls the op
    by) and counts its calls."""

    def __init__(self, monkeypatch):
        self.calls, self._fn = 0, layers.styled_epilogue
        monkeypatch.setattr(layers, "styled_epilogue", self)

    def __call__(self, *args):
        self.calls += 1
        return self._fn(*args)


def _generator(**cfg):
    g = Generator(PPSTConfig(**NARROW, **cfg))
    return _nonzero(g, seed=1)


def _codes(dtype, batch=2, seed=2):
    g = torch.Generator().manual_seed(seed)
    sp = torch.randn((batch, 8, 8, 16), generator=g).to(dtype)
    gl = [torch.randn((batch, 64), generator=g).to(dtype) for _ in range(4)]
    return sp, gl


# (generator config, dtype, grad mode, noise, extract_features, calls a G pass)
ROUTES = {
    "inference_drawn": ({}, torch.bfloat16, "inference", "drawn", False, 14),
    "no_grad_pinned_bf16": ({}, torch.bfloat16, "no_grad", "bfloat16", False, 14),
    "no_grad_features": ({}, torch.bfloat16, "no_grad", "drawn", True, 14),
    "fused_styled_conv": (dict(fused_styled_conv=True), torch.bfloat16, "inference", "drawn",
                          False, 3),
    "grad": ({}, torch.bfloat16, "grad", "bfloat16", False, 0),
    "float32": ({}, torch.float32, "no_grad", "drawn", False, 0),
    "pinned_float32_noise": ({}, torch.bfloat16, "no_grad", "float32", False, 0),
}


@pytest.mark.parametrize("case", list(ROUTES))
def test_route(case, monkeypatch):
    cfg, dtype, mode, noise, features, calls = ROUTES[case]
    g = _generator(**cfg)
    sp, gl = _codes(dtype)
    kw = dict(extract_features=features)
    if noise == "drawn":
        kw["generator"] = torch.Generator().manual_seed(4)
    else:
        kw["noises"] = make_fixed_noise(g.cfg, torch.Generator().manual_seed(4), 2, 64,
                                        dtype=getattr(torch, noise))
    count = Count(monkeypatch)
    ctx = {"inference": torch.inference_mode(), "no_grad": torch.no_grad(),
           "grad": torch.enable_grad()}[mode]
    with ctx:
        out = g(sp, gl, **kw)
    rgb = out[0] if features else out
    assert rgb.shape == (2, 64, 64, 3) and torch.isfinite(rgb.float()).all()
    assert count.calls == calls


def test_route_draws_the_same_noise():
    """A G pass through the op and one through the composite (under grad)
    draw the same noise from the generator: the same state after the pass
    and, the op's CPU version being the composite, the same output."""
    g = _generator()
    sp, gl = _codes(torch.bfloat16)
    outs, states = [], []
    for ctx in (torch.inference_mode(), torch.enable_grad()):
        gen = torch.Generator().manual_seed(9)
        with ctx:
            outs.append(g(sp, gl, generator=gen).detach().clone())
        states.append(gen.get_state())
    assert torch.equal(states[0], states[1])
    assert not torch.equal(states[0], torch.Generator().manual_seed(9).get_state())
    assert torch.equal(outs[0], outs[1])


def test_remat_blocks_gradients_unchanged(monkeypatch):
    """Under ``remat_blocks`` with grad, the forward and the checkpoints'
    recompute both run the composite: the op is never called and every
    gradient equals that of the chain before the factoring."""
    g = _generator(remat_blocks=True)
    sp, gl = _codes(torch.bfloat16)
    noises = make_fixed_noise(g.cfg, torch.Generator().manual_seed(4), 2, 64,
                              dtype=torch.bfloat16)

    def grads():
        g.zero_grad()
        out = g(sp, gl, noises=noises)
        (out.float() * torch.linspace(-1, 1, out.numel()).reshape(out.shape)).sum().backward()
        return {k: p.grad.clone() for k, p in g.named_parameters() if p.grad is not None}

    count = Count(monkeypatch)
    got = grads()
    assert count.calls == 0
    monkeypatch.setattr(StyledConv, "forward", old_styled_conv)
    want = grads()
    assert got.keys() == want.keys() and len(got) > 0
    assert all(torch.equal(got[k], want[k]) for k in got)


def _args(b=2, h=4, w=6, c=16, dtype=torch.bfloat16):
    g = torch.Generator().manual_seed(0)
    return dict(y=torch.randn((b, h, w, c), generator=g).to(dtype),
                conv_bias=torch.randn(c, generator=g), gain=torch.full((1,), 0.1),
                noise=torch.randn((b, h, w, 1), generator=g).to(dtype),
                bias=torch.randn(c, generator=g), act_bias=torch.randn(c, generator=g),
                style=torch.randn((b, 2 * c), generator=g).to(dtype))


def _bad(**over):
    a = _args()
    a.update(over)
    return a


BAD = {
    "y_float32": _bad(y=_args()["y"].float()),
    "y_not_contiguous": _bad(y=_args()["y"].transpose(1, 2)),
    "y_3d": _bad(y=_args()["y"][0]),
    "c_not_multiple_of_8": _args(c=12),
    "bias_shape": _bad(bias=torch.zeros(8)),
    "bias_bf16": _bad(act_bias=torch.zeros(16, dtype=torch.bfloat16)),
    "bias_not_contiguous": _bad(conv_bias=torch.zeros(32)[::2]),
    "noise_float32": _bad(noise=_args()["noise"].float()),
    "noise_shape": _bad(noise=torch.zeros((2, 4, 6, 2), dtype=torch.bfloat16)),
    "noise_without_gain": _bad(gain=None),
    "gain_two": _bad(gain=torch.zeros(2)),
    "style_shape": _bad(style=torch.zeros((2, 16), dtype=torch.bfloat16)),
    "style_float32": _bad(style=torch.zeros((2, 32))),
    "style_channel_stride": _bad(style=torch.zeros((2, 64), dtype=torch.bfloat16)[:, ::2]),
}


@pytest.mark.parametrize("case", list(BAD))
def test_checks_raise_before_any_launch(case, monkeypatch):
    def no_build():
        raise AssertionError("the kernels were loaded before the checks")

    monkeypatch.setattr(se, "_lib", no_build)
    launches = se.styled_epilogue.launches
    with pytest.raises(ValueError):
        se.check_inputs(**BAD[case])
    with pytest.raises(ValueError):
        se._launch(**BAD[case])
    assert se.styled_epilogue.launches == launches


def test_wrapper_takes_the_composite_on_the_cpu_and_refuses_other_devices():
    a = _args()
    assert torch.equal(se.styled_epilogue(**a), layers.styled_conv_epilogue(**a))
    a = _args()
    a["noise"] = a["gain"] = None
    assert torch.equal(se.styled_epilogue(**a), layers.styled_conv_epilogue(**a))
    meta = {k: v.to("meta") for k, v in _args().items()}
    with pytest.raises(ValueError):
        se.styled_epilogue(**meta)


def _g_shapes(crop, batch):
    """(B, H, W, C) of the 14 StyledConv outputs of the published generator."""
    cfg = PPSTConfig(crop_size=crop)
    grid = crop // 2 ** cfg.netE_num_downsampling_sp
    chans, ch = [], cfg.spatial_code_ch
    for i in range(cfg.netG_num_base_resnet_layers):
        ch = max(cfg.spatial_code_ch,
                 round((i + 1) / cfg.netG_num_base_resnet_layers * cfg.nf_g(0)))
        chans += [(grid, ch)] * 2
    for j in range(cfg.netE_num_downsampling_sp):
        chans += [(grid * 2 ** (j + 1), cfg.nf_g(j + 1))] * 2
    return [(batch, s, s, c) for s, c in chans]


@pytest.mark.parametrize("crop, batch", [(512, 1), (512, 2), (512, 8), (512, 16), (1024, 1),
                                         (1024, 2)])
@pytest.mark.parametrize("resident", [2, 4, 8])
def test_every_generator_shape_fills_two_waves(crop, batch, resident):
    """On 132 SMs holding ``resident`` blocks each, every G shape fills one
    wave of blocks to within a slab an image, as far as its pixels allow, and
    never spills into a second wave; it gets two blocks an SM on all but
    fewer than B SMs; every slab holds a pixel row for each thread of its
    block."""
    shapes = _g_shapes(crop, batch)
    assert len(shapes) == 14
    for b, h, w, c in shapes:
        n = h * w
        slabs = se.plan(b, n, c, 132, resident)
        threads, rows = se.threads(c)
        assert threads <= 256 and c % 8 == 0
        assert min(resident * 132, b * (n // rows)) - b < b * slabs <= resident * 132
        assert b * slabs > 2 * 132 - b, (b, h, w, c, slabs)
        assert n // slabs >= rows


def test_c_entry_takes_what_the_wrapper_passes():
    """ppst_styled_epilogue in csrc/styled_epilogue.cu takes the wrapper's
    ctypes argument types in order, and the kernels' block and channel limits
    are the wrapper's."""
    src = (se._nvcc.PKG / "csrc" / "styled_epilogue.cu").read_text()
    sig = re.search(r"int ppst_styled_epilogue\(([^)]*)\)", src).group(1)
    ctype = {"const void*": ctypes.c_void_p, "void*": ctypes.c_void_p,
             "long long": ctypes.c_longlong, "int": ctypes.c_int}
    assert [ctype[a.rsplit(" ", 1)[0].strip()] for a in sig.split(",")] == se.ENTRY_ARGTYPES
    consts = dict(re.findall(r"constexpr int (k\w+) = (\d+);", src))
    assert (int(consts["kThreads"]), int(consts["kMaxC"])) == (_slabs.THREADS, _slabs.MAX_C)
