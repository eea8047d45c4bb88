"""The port's layers and upfirdn2d against ppst_tpu's, in float32 on the CPU.

Weights are drawn by the port (``init_weights``) and carried to the flax
modules by ``ppst_tpu.util.convert_torch``; inputs come from numpy. Sums run
in other orders in XLA and in PyTorch, so outputs of size ~1 agree to ~1e-5;
the stated tolerance is 1e-4.
"""

import importlib
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ppst_tpu.nn import layers as jl
from ppst_tpu.util.convert_torch import _SD, _conv_layer, _cw, _res_block, _styled_conv
from ppst_tpu_torch.nn import layers as tl
from ppst_tpu_torch.ops import upfirdn2d as tup

# ppst_tpu.ops re-exports a function named upfirdn2d over the module
jup = importlib.import_module("ppst_tpu.ops.upfirdn2d")
TOL = dict(rtol=1e-4, atol=1e-4)


def _init(module, seed=0):
    tl.init_weights(module, torch.Generator().manual_seed(seed))
    return module


def _sd(module):
    return _SD({k: v.detach().numpy() for k, v in module.state_dict().items()})


def _run(tmod, x):
    with torch.no_grad():
        return tmod(torch.from_numpy(x)).numpy()


def _rand(rng, shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_instance_norm(rng, dtype):
    x = _rand(rng, (2, 8, 6, 5), 3.0) + 1.0
    xj = jnp.asarray(x).astype(dtype)
    want = np.asarray(jl.instance_norm(xj).astype(jnp.float32))
    got = tl.instance_norm(torch.from_numpy(x).to(getattr(torch, dtype))).float().numpy()
    # bf16: both round the same float32 result once; a sum-order difference
    # can flip one bf16 step (2^-7 relative)
    tol = TOL if dtype == "float32" else dict(rtol=8e-3, atol=8e-3)
    np.testing.assert_allclose(got, want, **tol)


# (in, out, k, ConvLayer keyword arguments) — every branch of ConvLayer
CONV_LAYERS = {
    "e_down_reflect_in": (6, 8, 3, dict(downsample=True, blur_kernel=(1, 2, 1),
                                        reflection_pad=True, norm="in")),
    "down_zero_pad": (6, 8, 3, dict(downsample=True, blur_kernel=(1, 3, 3, 1))),
    "skip_1x1_down": (6, 8, 1, dict(downsample=True, blur_kernel=(1, 2, 1),
                                    activate=False, bias=False)),
    "down_no_antialias": (6, 8, 3, dict(downsample=True, blur_kernel=(1,))),
    "down_no_antialias_reflect": (6, 8, 3, dict(downsample=True, blur_kernel=(1,),
                                                reflection_pad=True, norm="in")),
    "plain_reflect": (6, 8, 3, dict(reflection_pad=True, norm="in")),
    "plain_bias_no_act": (6, 8, 1, dict(activate=False)),
    "scaled_lrelu": (6, 8, 3, dict(bias=False)),
}


@pytest.mark.parametrize("name", sorted(CONV_LAYERS))
def test_conv_layer(rng, name):
    cin, cout, k, kw = CONV_LAYERS[name]
    tmod = _init(tl.ConvLayer(cin, cout, k, **kw))
    jkw = {("use_bias" if a == "bias" else a): v for a, v in kw.items()}
    jmod = jl.ConvLayer(cout, k, **jkw)
    x = _rand(rng, (2, 12, 10, cin))
    want = jmod.apply({"params": _conv_layer(_sd(tmod))}, jnp.asarray(x))
    np.testing.assert_allclose(_run(tmod, x), np.asarray(want), **TOL)


def test_res_block(rng):
    tmod = _init(tl.ResBlock(6, 8, blur_kernel=(1, 2, 1), norm="in"))
    jmod = jl.ResBlock(8, blur_kernel=(1, 2, 1), reflection_pad=True, norm="in")
    x = _rand(rng, (2, 8, 8, 6))
    want = jmod.apply({"params": _res_block(_sd(tmod))}, jnp.asarray(x))
    np.testing.assert_allclose(_run(tmod, x), np.asarray(want), **TOL)


@pytest.mark.parametrize("upsample,hw", [(False, 8), (True, 8), (True, 64)])
def test_styled_conv_pinned_noise(rng, upsample, hw):
    """hw=64 upsamples through the fused transposed conv (output >= 128),
    hw=8 through nearest upsampling plus a conv."""
    tmod = _init(tl.StyledConv(4, 6, 3, style_dim=10, upsample=upsample))
    with torch.no_grad():
        tmod.noise.weight.fill_(0.3)
        tmod.bias.uniform_(-0.5, 0.5)
        tmod.activate.bias.uniform_(-0.5, 0.5)
    jmod = jl.StyledConv(6, 3, upsample=upsample)
    x = _rand(rng, (2, hw, hw, 4))
    style = _rand(rng, (2, 10))
    out_hw = 2 * hw if upsample else hw
    noise = _rand(rng, (2, out_hw, out_hw, 1))
    want = jmod.apply({"params": _styled_conv(_sd(tmod))}, jnp.asarray(x),
                      jnp.asarray(style), jnp.asarray(noise))
    with torch.no_grad():
        got = tmod(torch.from_numpy(x), torch.from_numpy(style), torch.from_numpy(noise))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_to_rgb(rng):
    tmod = _init(tl.ToRGB(6, style_dim=10))
    with torch.no_grad():
        tmod.bias.uniform_(-0.5, 0.5)
    sd = _sd(tmod)
    params = {
        "conv": {"weight": _cw(sd("conv.weight")), "bias": sd("conv.bias")},
        "bias": sd("bias").reshape(-1),
        "epi1": {"style_mod": {"lin": {"weight": sd("epi1.style_mod.lin.weight").T,
                                       "bias": sd("epi1.style_mod.lin.bias")}}},
    }
    x, style = _rand(rng, (2, 8, 8, 6)), _rand(rng, (2, 10))
    want = jl.ToRGB().apply({"params": params}, jnp.asarray(x), jnp.asarray(style))
    with torch.no_grad():
        got = tmod(torch.from_numpy(x), torch.from_numpy(style))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("k", [1, 3])
def test_torch_conv2d(rng, k):
    tmod = _init(tl.TorchConv2d(5, 7, k))
    sd = _sd(tmod)
    params = {"weight": _cw(sd("weight")), "bias": sd("bias")}
    x = _rand(rng, (2, 9, 7, 5))
    want = jl.TorchConv2d(7, k).apply({"params": params}, jnp.asarray(x))
    np.testing.assert_allclose(_run(tmod, x), np.asarray(want), **TOL)


def test_torch_linear(rng):
    tmod = _init(tl.TorchLinear(6, 9, std=0.02))
    with torch.no_grad():
        tmod.bias.uniform_(-0.5, 0.5)
    sd = _sd(tmod)
    params = {"weight": sd("weight").T, "bias": sd("bias")}
    x = _rand(rng, (3, 6))
    want = jl.TorchLinear(9, normal_std=0.02).apply({"params": params}, jnp.asarray(x))
    np.testing.assert_allclose(_run(tmod, x), np.asarray(want), **TOL)


def test_init_distributions():
    """The port draws the JAX package's initial distributions: equalized
    layers N(0,1), He-std convs N(0, gain/sqrt(fan_in)), torch defaults
    U(+-1/sqrt(fan_in)), PReLU 0.25, noise gains and biases 0."""
    sc = _init(tl.StyledConv(64, 64, 3, style_dim=256))
    assert abs(sc.epi1.style_mod.lin.weight.std().item() - 1.0) < 0.02
    assert abs(sc.conv.weight.std().item() - math.sqrt(2.0) / math.sqrt(64 * 9)) < 1e-3
    assert sc.noise.weight.item() == 0.0 and sc.bias.abs().max().item() == 0.0
    conv = _init(tl.TorchConv2d(64, 64, 3))
    bound = 1.0 / math.sqrt(64 * 9)
    assert conv.weight.abs().max().item() <= bound
    assert conv.weight.abs().max().item() > 0.99 * bound
    assert tl.PReLU().weight.item() == 0.25


def test_make_kernel():
    for taps in ([1, 3, 3, 1], [1, 2, 1]):
        np.testing.assert_array_equal(tup.make_kernel(taps, gain=4.0),
                                      jup.make_kernel(taps, gain=4.0))


UPFIRDN = {
    "sep_down2": (dict(kernel=[1, 3, 3, 1], down=2, pad=(1, 1))),
    "sep_up2": (dict(kernel=[1, 3, 3, 1], up=2, pad=(2, 1))),
    "sep_crop_asym": (dict(kernel=[1, 2, 4], pad=(-1, 2))),
    "full_2d": (dict(kernel=np.outer([1, 2, 1], [1, 2, 3]), up=2, down=2, pad=(1, 0))),
}


@pytest.mark.parametrize("name", sorted(UPFIRDN))
def test_upfirdn2d(rng, name):
    kw = dict(UPFIRDN[name])
    k = np.asarray(kw.pop("kernel"), np.float32)
    k = k / k.sum()
    x = _rand(rng, (2, 10, 8, 3))
    want = jup.upfirdn2d(jnp.asarray(x), k, **kw)
    got = tup.upfirdn2d(torch.from_numpy(x), k, **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("op", ["upsample2d", "downsample2d", "downsample2d_reflect",
                                "blur", "blur_reflect"])
def test_resampling_helpers(rng, op):
    x = _rand(rng, (2, 8, 8, 3))
    taps = [1, 3, 3, 1]
    calls = {
        "upsample2d": lambda m, v: m.upsample2d(v, taps),
        "downsample2d": lambda m, v: m.downsample2d(v, taps),
        "downsample2d_reflect": lambda m, v: m.downsample2d(v, taps, reflection_pad=True),
        "blur": lambda m, v: m.blur(v, taps, (2, 1)),
        "blur_reflect": lambda m, v: m.blur(v, taps, (2, 1), upsample_factor=2,
                                            reflection_pad=True),
    }
    want = calls[op](jup, jnp.asarray(x))
    got = calls[op](tup, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
