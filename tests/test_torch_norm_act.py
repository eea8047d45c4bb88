"""K8, the instance norm and what follows it (``ops/norm_act_cuda.py``), on
the CPU: its plain version, the composite ``nn.layers.norm_act_chain``, at
each kind of site against a copy of the chain as it was composed before
the site was factored (bit for bit, in float32 and bf16, with and without
grad, gradients included); which passes take the op, and how often a
stylize call, a D step and a G step call it; the wrapper's checks; the C
entry's signature; and the slab plan of every extraction shape. The kernels
themselves run only on the card (``chip_smoke.py``'s ``norm_act`` phase)."""

import ctypes
import re

import pytest
import torch

from ppst_tpu_torch.models.config import PPSTConfig
from ppst_tpu_torch.models.generator import _FeatureTap, _ResidualBlock
from ppst_tpu_torch.models.ppst import PPSTModel
from ppst_tpu_torch.nn import layers
from ppst_tpu_torch.nn.layers import ConvLayer, init_weights
from ppst_tpu_torch.ops import _slabs
from ppst_tpu_torch.ops import norm_act_cuda as na
from ppst_tpu_torch.ops.fused_act import fused_leaky_relu, scaled_leaky_relu
from ppst_tpu_torch.train.steps import TrainSteps

NARROW = dict(crop_size=64, netE_scale_capacity=0.25, netE2_scale_capacity=0.25,
              global_code_ch=64, spatial_code_ch=16, netG_resnet_ch=32,
              netG_scale_capacity=0.125, netD_scale_capacity=0.125)


def _old_instance_norm(x, eps=1e-5):
    x32 = x.float()
    mean = x32.mean((1, 2), keepdim=True)
    if x.dtype == torch.bfloat16:
        var = ((x32 * x32).mean((1, 2), keepdim=True) - mean * mean).clamp_min(0.0)
    else:
        var = x32.var((1, 2), keepdim=True, unbiased=False)
    return ((x32 - mean) * torch.rsqrt(var + eps)).to(x.dtype)


def _old_prelu(m, x):
    return x.clamp_min(0) + m.weight.to(x.dtype) * x.clamp_max(0)


def _old_torch_conv(m, x):
    return layers.conv2d(x, m.weight.to(x.dtype)) + m.bias.to(x.dtype)


def _pad(x):
    return layers.pad_hw(x, (1, 1), mode="replicate")


def old_conv_layer(m, x):
    """ConvLayer's forward as it stood before the site: EqualConv2d (with
    its bias) -> InstanceNorm -> activation."""
    if m.blur is not None:
        x = layers.blur_op(x, m.blur[0], m.blur[1], reflection_pad=m.reflection_pad)
    elif m.pre_pad is not None:
        x = layers.reflect_pad(x, *m.pre_pad)
    y = m.Conv(x)
    if m.norm == "in":
        y = _old_instance_norm(y)
    if m.activate:
        y = fused_leaky_relu(y, m.Act.bias) if m.Act is not None else scaled_leaky_relu(y)
    return y


def old_tap(m, x):
    conv1, prelu1, conv2, prelu2 = (m._modules[k] for k in ("2", "4", "6", "8"))
    if m.conv1x1:
        y = _old_prelu(prelu1, _old_instance_norm(_old_torch_conv(conv1, _old_instance_norm(x))))
        return _old_prelu(prelu2, _old_instance_norm(_old_torch_conv(conv2, y)))
    y = _old_prelu(prelu1, _old_instance_norm(_old_torch_conv(conv1,
                                                              _old_instance_norm(_pad(x)))))
    return _old_prelu(prelu2, _old_instance_norm(_old_torch_conv(conv2, _pad(y))))


def old_residual_block(m, x):
    y = _old_prelu(m.prelu, _old_instance_norm(_old_torch_conv(m.conv1, _pad(x))))
    y = _old_instance_norm(_old_torch_conv(m.conv2, _pad(y)))
    return _old_prelu(m.prelu, y + x)


# (module, input (B, H, W, Cin), the old forward, sites a forward calls):
# E1's activated convs (plain and downsampling), its skip, ToSpatialCode's
# two 1x1 convs (leaky ReLU; the conv's bias and no activation), the 3x3 and
# 1x1 feature taps (the padded input's norm, then norm + PReLU twice), a
# fuse block (norm + PReLU, norm + residual + PReLU)
KINDS = {
    "e1_conv": (lambda: ConvLayer(16, 16, 3, reflection_pad=True, norm="in"), (2, 8, 8, 16),
                old_conv_layer, 1),
    "e1_down": (lambda: ConvLayer(16, 24, 3, downsample=True, reflection_pad=True, norm="in"),
                (2, 8, 8, 16), old_conv_layer, 1),
    "e1_skip": (lambda: ConvLayer(16, 24, 1, downsample=True, activate=False, bias=False,
                                  norm="in"), (2, 8, 8, 16), old_conv_layer, 1),
    "to_spatial_code0": (lambda: ConvLayer(16, 16, 1, activate=True, bias=True, norm="in"),
                         (2, 4, 4, 16), old_conv_layer, 1),
    "to_spatial_code1": (lambda: ConvLayer(16, 8, 1, activate=False, bias=True, norm="in"),
                         (2, 4, 4, 16), old_conv_layer, 1),
    "tap3x3": (lambda: _FeatureTap(16, feature_ch=32), (2, 8, 8, 16), old_tap, 3),
    "tap1x1": (lambda: _FeatureTap(16, conv1x1=True, feature_ch=32), (2, 8, 8, 16), old_tap, 3),
    "residual_block": (lambda: _ResidualBlock(16), (2, 8, 8, 16), old_residual_block, 2),
}


def _nonzero(module, seed=3):
    """Weights from the seed, and nonzero biases and slopes (zero or 0.25 at init)."""
    g = torch.Generator().manual_seed(seed)
    init_weights(module, g)
    with torch.no_grad():
        for name, p in module.named_parameters():
            if "bias" in name or name.endswith(("4.weight", "8.weight", "prelu.weight")):
                p.copy_(torch.empty(p.shape).uniform_(-0.3, 0.3, generator=g))
    return module


class Count:
    """Wraps ``nn.layers.norm_act`` (the name the sites call the op by) and
    counts its calls."""

    def __init__(self, monkeypatch):
        self.calls, self._fn = 0, layers.norm_act
        monkeypatch.setattr(layers, "norm_act", self)

    def __call__(self, *args):
        self.calls += 1
        return self._fn(*args)


@pytest.mark.parametrize("grad", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kind", list(KINDS))
def test_twin_equals_the_composite_chain(kind, dtype, grad, monkeypatch):
    make, shape, old, sites = KINDS[kind]
    m = _nonzero(make())
    x = torch.randn(shape, generator=torch.Generator().manual_seed(11)).to(dtype)
    x.requires_grad_(grad)

    def run(fn):
        m.zero_grad()
        with torch.set_grad_enabled(grad):
            out = fn(m, x)
        if not grad:
            return out, []
        (out.float() * torch.linspace(-1, 1, out.numel()).reshape(out.shape)).sum().backward()
        grads = [p.grad.clone() for p in m.parameters()] + [x.grad.clone()]
        x.grad = None
        return out, grads

    want, want_g = run(old)
    count = Count(monkeypatch)
    got, got_g = run(lambda mod, t: mod(t))
    assert got.dtype == want.dtype == dtype
    assert torch.equal(got, want)
    assert len(got_g) == len(want_g)
    assert all(torch.equal(a, b) for a, b in zip(got_g, want_g))
    # the op in bf16 without grad, once a site; the composite elsewhere
    assert count.calls == (sites if dtype == torch.bfloat16 and not grad else 0)


def _site_args(c=16, dtype=torch.bfloat16, seed=0):
    g = torch.Generator().manual_seed(seed)
    return dict(y=torch.randn((2, 4, 6, c), generator=g).to(dtype),
                pre_bias=torch.randn(c, generator=g),
                residual=torch.randn((2, 4, 6, c), generator=g).to(dtype),
                act_bias=torch.randn(c, generator=g), slope=torch.full((1,), 0.3))


# the variants the kernels take: (pre-bias, residual, activation)
VARIANTS = [(pre, res, act) for pre in (False, True) for res in (False, True)
            for act in (None, "act_bias", "slope")]


@pytest.mark.parametrize("variant", VARIANTS)
def test_op_on_the_cpu_is_the_composite(variant):
    pre, res, act = variant
    a = _site_args()
    kw = dict(pre_bias=a["pre_bias"] if pre else None, residual=a["residual"] if res else None)
    if act:
        kw[act] = a[act]
    want = layers.norm_act_chain(a["y"], **kw)
    assert torch.equal(na.norm_act(a["y"], **kw), want)
    with torch.no_grad():
        assert torch.equal(layers.instance_norm_act(a["y"], **kw), want)


# (grad mode, dtype, channels): what keeps the composite
COMPOSITE_ROUTES = {
    "grad": ("grad", torch.bfloat16, 16),
    "float32": ("no_grad", torch.float32, 16),
    "c3": ("no_grad", torch.bfloat16, 3),
    "c12": ("inference", torch.bfloat16, 12),
}


@pytest.mark.parametrize("case", ["no_grad", "inference", *COMPOSITE_ROUTES])
def test_route(case, monkeypatch):
    mode, dtype, c = COMPOSITE_ROUTES.get(case, (case, torch.bfloat16, 16))
    a = _site_args(c=c, dtype=dtype)
    count = Count(monkeypatch)
    ctx = {"inference": torch.inference_mode(), "no_grad": torch.no_grad(),
           "grad": torch.enable_grad()}[mode]
    with ctx:
        got = layers.instance_norm_act(a["y"], a["pre_bias"] if c == 16 else None,
                                       a["residual"], slope=a["slope"])
    assert torch.equal(got, layers.norm_act_chain(
        a["y"], a["pre_bias"] if c == 16 else None, a["residual"], slope=a["slope"]))
    assert count.calls == (1 if case in ("no_grad", "inference") else 0)


def test_a_float32_residual_keeps_the_composite(monkeypatch):
    a = _site_args()
    count = Count(monkeypatch)
    with torch.no_grad():
        got = layers.instance_norm_act(a["y"], residual=a["residual"].float())
    assert got.dtype == torch.float32 and count.calls == 0


def _images(b=2, seed=0):
    """bf16 images, as the bf16 model's callers pass them (float32 images
    run its encoders in float32)."""
    g = torch.Generator().manual_seed(seed)
    return (torch.rand((b, 64, 64, 3), generator=g) * 2 - 1).bfloat16()


# E1's 11 (three ResBlocks of three, ToSpatialCode's two), the 3x3 taps' 9,
# the fuse blocks' 8
SITES_A_PASS = 28


@pytest.mark.parametrize("published", [False, True])
def test_stylize_calls_each_site_once(published, monkeypatch):
    """One extraction over [content; style] a stylize call: each instance-norm
    site once, the same 28 in the narrow model and at published widths; the
    decode's G pass has none."""
    cfg = dict(crop_size=64) if published else NARROW
    model = PPSTModel(PPSTConfig(**cfg, dtype="bfloat16", fused_tap=True), device="cpu",
                      seed=0)
    x = _images(1)
    count = Count(monkeypatch)
    out = model.stylize(x, x.flip(1), torch.Generator().manual_seed(1))
    assert out.shape == (1, 64, 64, 3) and torch.isfinite(out.float()).all()
    assert count.calls == SITES_A_PASS


def test_d_step_calls_each_site_once_and_a_g_step_none(monkeypatch):
    """A D step's E1 and feature pass run without grad: each site once. A G
    step runs them under grad, through the composite."""
    steps = TrainSteps(PPSTModel(PPSTConfig(**NARROW, dtype="bfloat16", fused_tap=True),
                                 device="cpu", seed=0))
    real = _images()
    mask = torch.zeros((2, 64, 64, 3))
    mask[..., 0] = 1
    count = Count(monkeypatch)
    steps.d_step(real, mask, torch.Generator().manual_seed(2))
    assert count.calls == SITES_A_PASS
    steps.g_step(real, mask, torch.Generator().manual_seed(3))
    assert count.calls == SITES_A_PASS


def _bad(**over):
    """The arguments of a PReLU site with a pre-bias and a residual, but for ``over``."""
    a = dict(_site_args(), act_bias=None)
    a.update(over)
    return a


BAD = {
    "y_float32": _bad(y=_site_args()["y"].float()),
    "y_not_contiguous": _bad(y=_site_args()["y"].transpose(1, 2)),
    "y_3d": _bad(y=_site_args()["y"][0], residual=None),
    "c_not_multiple_of_8": dict(_site_args(c=12), act_bias=None),
    "pre_bias_shape": _bad(pre_bias=torch.zeros(8)),
    "pre_bias_bf16": _bad(pre_bias=torch.zeros(16, dtype=torch.bfloat16)),
    "act_bias_not_contiguous": _bad(act_bias=torch.zeros(32)[::2], slope=None),
    "slope_two": _bad(slope=torch.zeros(2)),
    "slope_bf16": _bad(slope=torch.zeros(1, dtype=torch.bfloat16)),
    "two_activations": _bad(act_bias=torch.zeros(16)),
    "residual_float32": _bad(residual=_site_args()["residual"].float()),
    "residual_shape": _bad(residual=torch.zeros((2, 4, 6, 8), dtype=torch.bfloat16)),
    "residual_not_contiguous": _bad(
        residual=torch.zeros((2, 6, 4, 16), dtype=torch.bfloat16).transpose(1, 2)),
}


@pytest.mark.parametrize("case", list(BAD))
def test_checks_raise_before_any_launch(case, monkeypatch):
    def no_build():
        raise AssertionError("the kernels were loaded before the checks")

    monkeypatch.setattr(na, "_lib", no_build)
    launches = na.norm_act.launches
    with pytest.raises(ValueError):
        na.check_inputs(**BAD[case])
    with pytest.raises(ValueError):
        na._launch(**BAD[case])
    assert na.norm_act.launches == launches


def test_wrapper_refuses_other_devices():
    meta = {k: v.to("meta") for k, v in _site_args().items()}
    meta["act_bias"] = None
    with pytest.raises(ValueError):
        na.norm_act(**meta)


def _extraction_shapes(crop, batch):
    """(B, H, W, C) of the 28 sites of one extraction over ``batch`` images
    at published widths, as the narrow run lists them scaled: E1's, the 3x3
    taps' (each norm of a padded input 2 pixels wider) and the fuse blocks'."""
    cfg = PPSTConfig(crop_size=crop)
    n, shapes = cfg.netE_num_downsampling_sp, []
    for i in range(n):
        s = crop >> i
        shapes += [(s, cfg.nc_e1(i)), (s // 2, cfg.nc_e1(i + 1)), (s // 2, cfg.nc_e1(i + 1))]
    grid = crop >> n
    shapes += [(grid, cfg.nc_e1(n)), (grid, cfg.spatial_code_ch)]
    fc = cfg.netG_resnet_ch
    trunk = [max(cfg.spatial_code_ch, cfg.nf_g(0))] + [cfg.nf_g(j + 1) for j in range(n - 1)]
    for j, ch in enumerate(trunk):
        s = grid << j
        shapes += [(s + 2, ch), (s, fc // 2), (s, fc // 4)]
    shapes += [(grid, cfg.g_fuse_ch)] * 6 + [(4 * grid, cfg.g_fuse_ch)] * 2
    return [(batch, s, s, c) for s, c in shapes]


def test_extraction_shapes_are_the_sites(monkeypatch):
    """The shapes ``_extraction_shapes`` lists are those one extraction calls
    the op with, at published widths (crop 64)."""
    model = PPSTModel(PPSTConfig(crop_size=64, dtype="bfloat16", fused_tap=True), device="cpu",
                      seed=0)
    seen = []
    raw = layers.norm_act
    monkeypatch.setattr(layers, "norm_act", lambda y, *a: seen.append(tuple(y.shape)) or raw(y, *a))
    x = _images(1)
    model.stylize(x, x.flip(1), torch.Generator().manual_seed(1))
    assert sorted(seen) == sorted(_extraction_shapes(64, 2))


@pytest.mark.parametrize("crop, batch", [(512, 2), (512, 16), (1024, 2)])
@pytest.mark.parametrize("resident", [2, 3, 4, 8])
def test_every_extraction_shape_fills_one_wave(crop, batch, resident):
    """On 132 SMs holding ``resident`` blocks each, every site's shape fills
    one wave of blocks to within a slab an image, as far as its pixels allow,
    and never spills into a second; every slab holds a pixel row for each
    thread of its block."""
    shapes = _extraction_shapes(crop, batch)
    assert len(shapes) == SITES_A_PASS
    for b, h, w, c in shapes:
        n = h * w
        slabs = na.plan(b, n, c, 132, resident)
        threads, rows = na.threads(c)
        assert threads <= 256 and c % 8 == 0
        assert min(resident * 132, b * (n // rows)) - b < b * slabs <= resident * 132
        assert n // slabs >= rows


def test_c_entry_takes_what_the_wrapper_passes():
    """ppst_norm_act in csrc/norm_act.cu takes the wrapper's ctypes argument
    types in order, and the kernels' block and channel limits are the
    wrapper's."""
    src = (na._nvcc.PKG / "csrc" / "norm_act.cu").read_text()
    sig = re.search(r"int ppst_norm_act\(([^)]*)\)", src).group(1)
    ctype = {"const void*": ctypes.c_void_p, "void*": ctypes.c_void_p,
             "long long": ctypes.c_longlong, "int": ctypes.c_int}
    assert [ctype[a.rsplit(" ", 1)[0].strip()] for a in sig.split(",")] == na.ENTRY_ARGTYPES
    consts = dict(re.findall(r"constexpr int (k\w+) = (\d+);", src))
    assert (int(consts["kThreads"]), int(consts["kMaxC"])) == (_slabs.THREADS, na.MAX_C)
