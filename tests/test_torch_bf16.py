"""bfloat16 rounding of the port against the JAX package's (ROADMAP fault F1),
module by module and for the whole generator.

For each module three distances are taken on the same inputs and weights,
relative to the RMS of the float32 output: port bf16 vs port float32, JAX
bf16 vs JAX float32, and port bf16 vs JAX bf16. The JAX side runs under
``jax.jit`` with its parameters as JAX arrays, as the JAX package runs. (With
numpy parameters ``numpy_bf16_weight * python_float`` promotes to float32,
and JAX's "bf16" modules then run in float32 from the first equalized
linear or conv on.)

A module whose port bf16 error exceeds JAX's by more than 1.5x would place a
cast where XLA's fusion does not. Measured: at most 1.10x (the 3x3 feature
tap), every other module 0.88-1.08x.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_train_common import NARROW_G, rel_err

from ppst_tpu.models import generator as jg
from ppst_tpu.models.config import PPSTConfig as JaxConfig
from ppst_tpu.nn import layers as jl
from ppst_tpu.util.convert_torch import (
    _SD,
    _conv_layer,
    _cw,
    _equal_linear,
    _feature_tap,
    _res_block,
    _residual_block,
    _styled_conv,
    convert_reference_state_dict,
)
from ppst_tpu_torch.models import generator as tg
from ppst_tpu_torch.models.config import PPSTConfig
from ppst_tpu_torch.models.ppst import PPSTModel
from ppst_tpu_torch.nn import layers as tl

NARROW = dict(NARROW_G, fused_tap=True)
RATIO = 1.5  # port bf16 error / JAX bf16 error that marks a misplaced cast


def _init(m, seed=0):
    tl.init_weights(m, torch.Generator().manual_seed(seed))
    return m


def _jparams(tree):
    return {"params": jax.tree.map(jnp.asarray, tree)}


def _sd(m):
    return _SD({k: v.detach().numpy() for k, v in m.state_dict().items()})


def _distances(port_fn, jax_fn, args):
    """(port bf16 vs f32, JAX bf16 vs f32, port bf16 vs JAX bf16), each as
    (mean, max) relative to the RMS of JAX's float32 output."""
    ta = [torch.from_numpy(a) for a in args]
    jf = jax.jit(jax_fn)
    with torch.no_grad():
        t32 = port_fn(ta).float().numpy()
        out16 = port_fn([a.bfloat16() for a in ta])
    j32 = np.asarray(jf([jnp.asarray(a) for a in args]).astype(jnp.float32))
    j16 = jf([jnp.asarray(a).astype(jnp.bfloat16) for a in args])
    assert out16.dtype == torch.bfloat16 and j16.dtype == jnp.bfloat16
    t16, j16 = out16.float().numpy(), np.asarray(j16.astype(jnp.float32))
    rms = np.sqrt(np.mean(j32 ** 2))
    np.testing.assert_allclose(t32, j32, rtol=0, atol=1e-3 * rms)  # the float32 paths agree
    return rel_err(t16, t32, rms), rel_err(j16, j32, rms), rel_err(t16, j16, rms)


def _styled_conv_case(rng, up, hw):
    m = _init(tl.StyledConv(32, 32, 3, style_dim=64, upsample=up))
    with torch.no_grad():
        m.bias.uniform_(-0.5, 0.5)
        m.activate.bias.uniform_(-0.5, 0.5)
        m.noise.weight.fill_(0.1)
    jm = jl.StyledConv(32, 3, upsample=up)
    p = _jparams(_styled_conv(_sd(m)))
    ho = hw * (2 if up else 1)
    x = rng.standard_normal((2, hw, hw, 32)).astype(np.float32)
    st = (rng.standard_normal((2, 64)) * 0.3).astype(np.float32)
    noise = rng.standard_normal((2, ho, ho, 1)).astype(np.float32)
    return (lambda a: m(a[0], a[1], a[2]), lambda a: jm.apply(p, a[0], a[1], a[2]),
            [x, st, noise])


def _module_case(name, rng):
    x = rng.standard_normal((2, 16, 16, 32)).astype(np.float32)
    st = (rng.standard_normal((2, 64)) * 0.3).astype(np.float32)
    if name == "instance_norm":
        x = x * 2 + 0.5
        return lambda a: tl.instance_norm(a[0]), lambda a: jl.instance_norm(a[0]), [x]
    if name.startswith("StyledConv"):
        up, hw = {"StyledConv": (False, 16), "StyledConv up": (True, 8),
                  "StyledConv up 64": (True, 64)}[name]
        return _styled_conv_case(rng, up, hw)
    if name == "EqualizedConv2d up 64":
        m = _init(tl.EqualizedConv2d(32, 32, 3, upscale=True))
        p = _jparams({"weight": _cw(m.weight.detach().numpy()), "bias": m.bias.detach().numpy()})
        jm = jl.EqualizedConv2d(32, 3, upscale=True)
        x64 = rng.standard_normal((2, 64, 64, 32)).astype(np.float32)
        return lambda a: m(a[0]), lambda a: jm.apply(p, a[0]), [x64]
    if name == "_ResidualBlock":
        m = _init(tg._ResidualBlock(32))
        jm, p = jg._ResidualBlock(32), _jparams(_residual_block(_sd(m)))
        return lambda a: m(a[0]), lambda a: jm.apply(p, a[0]), [x]
    if name == "ConvLayer down":
        kw = dict(downsample=True, blur_kernel=(1, 2, 1), reflection_pad=True)
        m = _init(tl.ConvLayer(32, 32, 3, **kw))
        jm, p = jl.ConvLayer(32, 3, **kw), _jparams(_conv_layer(_sd(m)))
        return lambda a: m(a[0]), lambda a: jm.apply(p, a[0]), [x]
    if name == "ResBlock":
        m = _init(tl.ResBlock(32, 64, blur_kernel=(1, 2, 1)))
        jm = jl.ResBlock(64, blur_kernel=(1, 2, 1), reflection_pad=True)
        p = _jparams(_res_block(_sd(m)))
        return lambda a: m(a[0]), lambda a: jm.apply(p, a[0]), [x]
    if name == "ToRGB":
        m = _init(tl.ToRGB(32, style_dim=64))
        with torch.no_grad():
            m.bias.uniform_(-0.5, 0.5)
        s = _sd(m)
        p = _jparams({"conv": {"weight": _cw(s("conv.weight")), "bias": s("conv.bias")},
                      "bias": s("bias").reshape(-1),
                      "epi1": {"style_mod": {"lin": {
                          "weight": s("epi1.style_mod.lin.weight").T,
                          "bias": s("epi1.style_mod.lin.bias")}}}})
        return lambda a: m(a[0], a[1]), lambda a: jl.ToRGB().apply(p, a[0], a[1]), [x, st]
    if name == "GeneratorModulation":
        m = _init(tg.GeneratorModulation(64, 32))
        s = _sd(m)
        p = _jparams({"scale": _equal_linear(s.sub("scale.")),
                      "bias": _equal_linear(s.sub("bias."))})
        jm = jg.GeneratorModulation(32)
        return lambda a: m(a[0], a[1]), lambda a: jm.apply(p, a[0], a[1]), [x, st]
    if name == "_FeatureTap 3x3":
        m = _init(tg._FeatureTap(32, feature_ch=32))
        jm, p = jg._FeatureTap(feature_ch=32), _jparams(_feature_tap(_sd(m)))
        return lambda a: m(a[0]), lambda a: jm.apply(p, a[0]), [x]
    # the 1x1 tap: bf16 runs the port's plain K1 and JAX's Pallas K1 (interpret
    # mode), float32 runs both composites
    m = _init(tg._FeatureTap(128, conv1x1=True, feature_ch=256, fused=True))
    jm = jg._FeatureTap(conv1x1=True, feature_ch=256, fused=True)
    p = _jparams(_feature_tap(_sd(m)))
    xt = rng.standard_normal((2, 16, 16, 128)).astype(np.float32)
    return lambda a: m(a[0]), lambda a: jm.apply(p, a[0]), [xt]


MODULES = ["instance_norm", "StyledConv", "StyledConv up", "StyledConv up 64",
           "EqualizedConv2d up 64", "_ResidualBlock", "ConvLayer down", "ResBlock", "ToRGB",
           "GeneratorModulation", "_FeatureTap 3x3", "_FeatureTap 1x1 fused"]


@pytest.mark.parametrize("name", MODULES)
def test_module_bf16_error_matches_jax(rng, name):
    port, jax_err, cross = _distances(*_module_case(name, rng))
    msg = (f"{name}: port bf16-f32 {port}, JAX bf16-f32 {jax_err}, port-JAX bf16 {cross} "
           "(mean, max of the RMS)")
    assert port[0] <= RATIO * jax_err[0], msg
    # the two bf16 results are no further apart than each is from float32
    assert cross[0] <= max(port[0], jax_err[0]), msg


def _generator_outputs(numpy_params=False):
    """G's (rgb, feat, feat1), narrow, fused tap: port f32/bf16 and JAX
    f32/bf16 under jit, and JAX bf16 eager; with ``numpy_params`` also JAX
    bf16 eager with numpy parameters (how an earlier version of the bf16 test
    in test_torch_stylize.py ran JAX)."""
    rng = np.random.default_rng(0)
    model = PPSTModel(PPSTConfig(**NARROW), device="cpu")
    params = convert_reference_state_dict({k: v.numpy() for k, v in model.state_dict().items()},
                                          crop_size=64)
    cfg = JaxConfig(**NARROW)
    sp = rng.standard_normal((2, 8, 8, cfg.spatial_code_ch)).astype(np.float32)
    gl = [rng.standard_normal((2, cfg.style_dim)).astype(np.float32) for _ in range(4)]
    gp = jax.tree.map(jnp.asarray, params["G"])

    def jax_g(p, s, g):
        return jg.Generator(cfg).apply({"params": p}, s, g, extract_features=True,
                                       rngs={"noise": jax.random.PRNGKey(0)})

    def run_jax(fn, dt):
        out = fn(gp, jnp.asarray(sp).astype(dt), [jnp.asarray(g).astype(dt) for g in gl])
        return [np.asarray(o.astype(jnp.float32)) for o in out]

    def run_port(dt):
        with torch.no_grad():
            out = model.G(torch.from_numpy(sp).to(dt), [torch.from_numpy(g).to(dt) for g in gl],
                          extract_features=True)
        return [o.float().numpy() for o in out]

    outs = {"port32": run_port(torch.float32), "port16": run_port(torch.bfloat16),
            "jax32": run_jax(jax.jit(jax_g), jnp.float32),
            "jax16": run_jax(jax.jit(jax_g), jnp.bfloat16),
            "jax16_eager": run_jax(jax_g, jnp.bfloat16)}
    if numpy_params:
        gp = params["G"]
        outs["jax16_numpy_params"] = run_jax(jax_g, jnp.bfloat16)
    return outs


@pytest.fixture(scope="module")
def generator_outputs():
    return _generator_outputs()


def _g_rel(outs, a, b):
    return [rel_err(outs[a][i], outs[b][i], np.sqrt(np.mean(outs["jax32"][i] ** 2)))[0]
            for i in range(3)]


def test_generator_bf16_error_matches_jax(generator_outputs):
    """The port's bf16 G is as far from float32 as JAX's (measured 2.59%,
    2.20%, 2.16% against JAX's 2.61%, 2.11%, 2.10% for rgb, feat, feat1)."""
    port = _g_rel(generator_outputs, "port16", "port32")
    jax_err = _g_rel(generator_outputs, "jax16", "jax32")
    assert all(p <= 1.25 * j for p, j in zip(port, jax_err)), (port, jax_err)


def test_generator_bf16_port_to_jax_is_jax_to_itself(generator_outputs):
    """The port's bf16 G is as close to JAX's (jit) as JAX's eager run is
    (measured 2.30%, 1.94%, 1.94% against 2.26%, 1.96%, 1.94%): what remains
    between the two is bf16 rounding at this depth, not a cast of the port."""
    cross = _g_rel(generator_outputs, "port16", "jax16")
    floor = _g_rel(generator_outputs, "jax16_eager", "jax16")
    assert all(c <= 1.25 * f for c, f in zip(cross, floor)), (cross, floor)


if __name__ == "__main__":
    # The readings quoted above, PERF.md and ROADMAP F1: one row per module,
    # then the generator's distances, in % of the float32 output's RMS.
    print("| module | port bf16 vs f32 | JAX bf16 vs f32 | port vs JAX bf16 | ratio |")
    for name in MODULES:
        port, jax_err, cross = _distances(*_module_case(name, np.random.default_rng(0)))
        print(f"| {name} | " + " | ".join(f"{100 * m:.3f} / {100 * x:.2f}"
                                         for m, x in (port, jax_err, cross))
              + f" | {port[0] / jax_err[0]:.2f} |")
    outs = _generator_outputs(numpy_params=True)
    for a, b in [("port16", "port32"), ("jax16", "jax32"), ("jax16_eager", "jax32"),
                 ("jax16_numpy_params", "jax32"), ("port16", "jax16"),
                 ("jax16_eager", "jax16"), ("port16", "jax16_numpy_params")]:
        print(f"G {a} vs {b} (rgb, feat, feat1): "
              + ", ".join(f"{100 * v:.2f}%" for v in _g_rel(outs, a, b)))
