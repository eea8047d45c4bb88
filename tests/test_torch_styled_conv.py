"""The fused StyledConv (K6's plain versions) against ppst_tpu's Pallas
kernel, function and module, and its wiring in the port.

On the CPU the port's ``styled_conv3x3`` runs ``styled_conv3x3_reference``
and ``styled_conv3x3_bwd_reference``; the JAX side runs
``styled_conv_pallas.styled_conv3x3`` in interpret mode, as
tests/test_pallas_kernels.py does. The CUDA kernels are compared with the
plain versions on the card by ``chip_smoke.py``. Noise gains and biases are
set to seeded nonzero values and noise is pinned, so that their errors show.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_pallas_kernels import _styled_conv_twin
from test_torch_train_common import NARROW_G as NARROW

from ppst_tpu.models.config import PPSTConfig as JaxConfig
from ppst_tpu.models.generator import Generator as JaxG
from ppst_tpu.nn import layers as jl
from ppst_tpu.ops.styled_conv_pallas import styled_conv3x3 as jax_styled_conv3x3
from ppst_tpu.util.convert_torch import _SD, _styled_conv, convert_g
from ppst_tpu.util.fast_init import random_params_like
from ppst_tpu_torch.models.config import PPSTConfig
from ppst_tpu_torch.models.ppst import PPSTModel
from ppst_tpu_torch.nn import layers as tl
from ppst_tpu_torch.ops import styled_conv_cuda as sc
from ppst_tpu_torch.util.from_flax import _Out, from_g

NAMES = ["dx", "dw", "dgain", "db", "dscale", "dshift"]
# port (plain) against JAX (interpret), the same float32 arithmetic with bf16
# at the same points; the sums run in other orders. Measured: the output to
# one bf16 step (3.9e-3 at a max of 6.2; a mean of 2.4e-7); dx to 1.1e-4 of
# its max; dW to 0.32% (JAX rounds its dW to bf16, W1); the other gradients
# to 7e-6. The bounds, at most test_pallas_kernels.py's 0.05 and 0.04 each:
FWD_MAX, FWD_MEAN = 2.0**-8, 1e-5  # x max(1, max|ref|); mean absolute
GRAD_TOL = {"dx": 2.0**-8, "dw": 1e-2, "dgain": 1e-4, "db": 1e-4, "dscale": 1e-4,
            "dshift": 1e-4}  # x max(max|ref|, 0.01 largest gradient)


def _inputs(rng, b, h, w, cin, cout):
    """The arguments of test_styled_conv_pallas_fwd_bwd at this shape, w in
    JAX's (3, 3, Cin, Cout) layout, and an output cotangent."""
    x = rng.standard_normal((b, h, w, cin)).astype(np.float32)
    wt = (rng.standard_normal((3, 3, cin, cout)) * 0.05).astype(np.float32)
    noise = rng.standard_normal((b, h, w, 1)).astype(np.float32)
    bt = (rng.standard_normal((cout,)) * 0.1).astype(np.float32)
    sc_ = (rng.standard_normal((b, cout)) * 0.3).astype(np.float32)
    sh = (rng.standard_normal((b, cout)) * 0.3).astype(np.float32)
    cot = rng.standard_normal((b, h, w, cout)).astype(np.float32)
    return (x, wt, noise, np.float32(0.7), bt, sc_, sh), cot


def _jax_args(x, wt, noise, gain, bt, sc_, sh):
    return (jnp.asarray(x).astype(jnp.bfloat16), jnp.asarray(wt), jnp.asarray(noise),
            jnp.float32(gain), jnp.asarray(bt), jnp.asarray(sc_), jnp.asarray(sh))


def _port(x, wt, noise, gain, bt, sc_, sh, cot):
    """The port's output and its six gradients (dw in JAX's layout)."""
    t = torch.from_numpy
    args = [t(x).bfloat16().requires_grad_(), t(wt.transpose(3, 2, 0, 1).copy()).requires_grad_(),
            t(noise), torch.tensor([gain], requires_grad=True), t(bt).requires_grad_(),
            t(sc_).requires_grad_(), t(sh).requires_grad_()]
    out = sc.styled_conv3x3(*args)
    out.backward(t(cot).bfloat16())
    grads = [args[0].grad, args[1].grad.permute(2, 3, 1, 0), args[3].grad.reshape(()),
             args[4].grad, args[5].grad, args[6].grad]
    return out, grads


@pytest.fixture(scope="module", params=[(2, 8, 8, 128, 128), (1, 6, 10, 48, 80)],
                ids=["2x8x8x128", "1x6x10x48to80"])
def runs(request):
    """Both frameworks' forward and gradients on the same inputs (JAX's
    Pallas kernel in interpret mode, about 4 s a shape)."""
    rng = np.random.default_rng(0)
    args, cot = _inputs(rng, *request.param)
    jargs = _jax_args(*args)
    out, vjp = jax.vjp(jax_styled_conv3x3, *jargs)
    jgrads = vjp(jnp.asarray(cot).astype(out.dtype))
    jgrads = [jgrads[i] for i in (0, 1, 3, 4, 5, 6)]
    pout, pgrads = _port(*args, cot)
    return dict(args=args, jargs=jargs, cot=cot, out=out, grads=jgrads, pout=pout,
                pgrads=pgrads)


def test_forward_matches_jax_kernel(runs):
    got, want = runs["pout"], runs["out"]
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    got, want = got.detach().float().numpy(), np.asarray(want.astype(jnp.float32))
    err = np.abs(got - want)
    assert got.shape == want.shape
    assert err.max() <= FWD_MAX * max(1.0, np.abs(want).max()), err.max()
    assert err.mean() <= FWD_MEAN, err.mean()


def test_grads_match_jax_kernel(runs):
    """All six gradients: dx, dW, dgain, db_total, dstyle_scale, dstyle_shift."""
    want = [np.asarray(v, np.float64) for v in runs["grads"]]
    overall = max(np.abs(v).max() for v in want)
    for name, a, b in zip(NAMES, runs["pgrads"], want):
        a = a.detach().double().numpy()
        assert a.shape == b.shape, (name, a.shape, b.shape)
        scale = max(np.abs(b).max(), 0.01 * overall)
        assert np.abs(a - b).max() <= GRAD_TOL[name] * scale, (name, np.abs(a - b).max(), scale)


def test_dw_is_float32_and_tracks_the_f32_twin(runs):
    """ROADMAP W1: the port's dW keeps float32 digits (the weight's dtype),
    where JAX's kernel returns it rounded to bf16: JAX's dW is the port's,
    rounded (to one bf16 step at dW's largest magnitude, the sums running in
    other orders), while nearly every element of the port's lies between bf16
    values. At JAX's own shape it is within test_styled_conv_pallas_fwd_bwd's
    bound of the float32 twin (measured 1.9% of the max)."""
    jargs, cot = runs["jargs"], runs["cot"]
    pdw = runs["pgrads"][1]
    assert pdw.dtype == torch.float32 and runs["grads"][1].dtype == jnp.bfloat16
    port = pdw.detach().double().numpy()
    jdw = np.asarray(runs["grads"][1], np.float64)
    rounded = pdw.detach().bfloat16().double().numpy()
    assert np.abs(rounded - jdw).max() <= 2.0**-7 * np.abs(jdw).max()
    assert (rounded != port).mean() > 0.9
    if jargs[0].shape == (2, 8, 8, 128):
        twin = jax.grad(lambda *a: jnp.sum(_styled_conv_twin(*a).astype(jnp.float32)
                                           * jnp.asarray(cot)), argnums=1)(*jargs)
        twin = np.asarray(twin, np.float64)
        assert np.abs(port - twin).max() <= 0.04 * np.abs(twin).max()


def test_grad_skips_dx(monkeypatch):
    """With an input that needs no gradient the backward is asked for no dx."""
    rng = np.random.default_rng(1)
    (x, wt, noise, gain, bt, sc_, sh), cot = _inputs(rng, 1, 4, 4, 16, 16)
    seen = []
    real = sc.styled_conv3x3_bwd_reference

    def spy(*args, **kw):
        seen.append(kw.get("need_dx", args[8] if len(args) > 8 else True))
        return real(*args, **kw)

    monkeypatch.setattr(sc, "styled_conv3x3_bwd_reference", spy)
    t = torch.from_numpy
    w = t(wt.transpose(3, 2, 0, 1).copy()).requires_grad_()
    out = sc.styled_conv3x3(t(x).bfloat16(), w, t(noise), torch.tensor([gain]), t(bt), t(sc_),
                            t(sh))
    out.backward(t(cot).bfloat16())
    assert seen == [False] and w.grad is not None and w.grad.dtype == torch.float32


def test_inference_keeps_no_graph():
    """Without grad the forward runs alone: no autograd node, the same bits."""
    rng = np.random.default_rng(2)
    (x, wt, noise, gain, bt, sc_, sh), _ = _inputs(rng, 1, 4, 4, 16, 32)
    t = torch.from_numpy
    args = (t(x).bfloat16(), t(wt.transpose(3, 2, 0, 1).copy()).requires_grad_(), t(noise),
            torch.tensor([gain]), t(bt), t(sc_), t(sh))
    with torch.inference_mode():
        plain = sc.styled_conv3x3(*args)
    assert plain.grad_fn is None
    assert torch.equal(plain, sc.styled_conv3x3(*args).detach())


def test_rejects_non_cuda_devices():
    e = lambda *s, dt=torch.float32: torch.empty(s, dtype=dt, device="meta")  # noqa: E731
    x = e(1, 4, 4, 16, dt=torch.bfloat16)
    with pytest.raises(ValueError, match="unsupported device"):
        sc.styled_conv3x3(x, e(16, 16, 3, 3), e(1, 4, 4, 1), e(1), e(16), e(1, 16), e(1, 16))
    with pytest.raises(ValueError, match="unsupported device"):
        sc.styled_conv3x3_bwd(x, e(16, 16, 3, 3), e(1, 4, 4, 1), x, e(1, 16), e(1, 16),
                              e(1, 16), x)


@pytest.mark.parametrize("need_dx", [True, False])
def test_a_wrapper_around_the_backward_launches_keeps_the_counter(monkeypatch, need_dx):
    """A tracer that wraps ``_bwd_cuda`` by its name (a span around the
    backward's launches) leaves ``styled_conv3x3_bwd.launches`` on the op,
    readable and counting (ROADMAP F8). The launches are stubbed: meta tensors
    take the CUDA branch here."""
    e = lambda *s, dt=torch.float32: torch.empty(s, dtype=dt, device="meta")  # noqa: E731
    x = e(1, 4, 4, 16, dt=torch.bfloat16)
    parts = []
    outs = (e(1, 4, 4, 16) if need_dx else None, e(16, 16, 3, 3), e(1), e(16), e(1, 4, 16))
    monkeypatch.setattr(sc, "_bwd_parts", lambda *args: (parts.append, outs))
    raw, wrapped = sc._bwd_cuda, []

    def tracer(*args, **kw):
        wrapped.append(args[8])
        return raw(*args, **kw)

    monkeypatch.setattr(sc, "_bwd_cuda", tracer)
    before = sc.styled_conv3x3_bwd.launches
    got = sc.styled_conv3x3_bwd(x, e(16, 16, 3, 3), e(1, 4, 4, 1), x, e(1, 16), e(1, 16),
                                e(1, 16), x, need_dx=need_dx)
    assert sc.styled_conv3x3_bwd.launches == before + 1 and wrapped == [need_dx]
    assert parts == ["dpre", "dw", "dx"][:3 if need_dx else 2]
    assert (got[0] is None) == (not need_dx) and got[4].shape == got[5].shape == (1, 16)


def _module_pair(rng, cin, cout, use_noise=True):
    """The port's StyledConv(fused=True) with seeded nonzero biases and noise
    gain, and JAX's StyledConv(fused=True) with the same weights (JAX arrays,
    ROADMAP F1)."""
    m = tl.StyledConv(cin, cout, 3, style_dim=64, use_noise=use_noise, fused=True)
    tl.init_weights(m, torch.Generator().manual_seed(0))
    with torch.no_grad():
        m.conv.bias.uniform_(-0.5, 0.5, generator=torch.Generator().manual_seed(1))
        m.bias.uniform_(-0.5, 0.5, generator=torch.Generator().manual_seed(2))
        m.activate.bias.uniform_(-0.5, 0.5, generator=torch.Generator().manual_seed(3))
        if use_noise:
            m.noise.weight.fill_(0.3)
    sd = {k: v.detach().numpy() for k, v in m.state_dict().items()}
    if not use_noise:
        sd["noise.weight"] = np.zeros(1, np.float32)
    tree = _styled_conv(_SD(sd))
    if not use_noise:
        del tree["noise"]
    params = {"params": jax.tree.map(jnp.asarray, tree)}
    return m, jl.StyledConv(cout, 3, use_noise=use_noise, fused=True), params


def _module_inputs(rng, cin, cout):
    x = rng.standard_normal((2, 8, 8, cin)).astype(np.float32)
    style = (rng.standard_normal((2, 64)) * 0.5).astype(np.float32)
    noise = rng.standard_normal((2, 8, 8, 1)).astype(np.float32)
    cot = rng.standard_normal((2, 8, 8, cout)).astype(np.float32)
    return x, style, noise, cot


def test_module_matches_jax_module(rng):
    """StyledConv(fused=True), Cin != Cout, bf16 activations and style: the
    output and every parameter's gradient against JAX's module under
    ``jax.grad``. Measured: the outputs agree to 6e-8 (a mean of 1e-11); the
    gradients of the biases and the noise gain to 1.2e-6 of their max, the
    conv weight's to 0.24% (JAX's bf16 rounding of dW, W1) and the style
    linear's bias to 0.32% (dstyle_scale rounded to bf16 on both sides and
    summed in other orders). Bounds: 2^-8 of the output's max, 1% of each
    gradient's max."""
    m, jm, params = _module_pair(rng, 32, 48)
    x, style, noise, cot = _module_inputs(rng, 32, 48)
    t = torch.from_numpy
    out = m(t(x).bfloat16(), t(style).bfloat16(), t(noise))
    (out.float() * t(cot)).sum().backward()

    jx, js = jnp.asarray(x).astype(jnp.bfloat16), jnp.asarray(style).astype(jnp.bfloat16)

    def loss(p):
        o = jm.apply(p, jx, js, jnp.asarray(noise))
        return jnp.sum(o.astype(jnp.float32) * jnp.asarray(cot)), o

    (_, jout), jgrad = jax.value_and_grad(loss, has_aux=True)(params)
    assert out.dtype == torch.bfloat16 and jout.dtype == jnp.bfloat16
    a, b = out.detach().float().numpy(), np.asarray(jout.astype(jnp.float32))
    assert np.abs(a - b).max() <= 2.0**-8 * max(1.0, np.abs(b).max()), np.abs(a - b).max()

    pgrad = _styled_conv(_SD({k: p.grad.numpy() for k, p in m.named_parameters()}))
    flat_j = jax.tree_util.tree_flatten_with_path(jgrad["params"])[0]
    flat_p = dict(jax.tree_util.tree_flatten_with_path(pgrad)[0])
    assert set(flat_p) == {k for k, _ in flat_j}
    for path, w in flat_j:
        g, w = np.asarray(flat_p[path], np.float64), np.asarray(w, np.float64)
        assert np.isfinite(g).all() and g.shape == w.shape, path
        assert np.abs(g - w).max() <= 0.01 * np.abs(w).max(), (
            jax.tree_util.keystr(path), np.abs(g - w).max(), np.abs(w).max())


def test_module_without_noise_matches_jax(rng):
    """use_noise=False: gain 0 and zero noise inside the fused chain, and no
    noise parameter, as JAX's _fused (layers.py:458-460). Measured 2.4e-7 at
    a max of 9.1; the bound is the module test's."""
    m, jm, params = _module_pair(rng, 32, 32, use_noise=False)
    assert m.noise is None and "noise" not in params["params"]
    x, style, _, _ = _module_inputs(rng, 32, 32)
    with torch.no_grad():
        got = m(torch.from_numpy(x).bfloat16(), torch.from_numpy(style).bfloat16())
    want = jm.apply(params, jnp.asarray(x).astype(jnp.bfloat16),
                    jnp.asarray(style).astype(jnp.bfloat16))
    a, b = got.float().numpy(), np.asarray(want.astype(jnp.float32))
    assert np.abs(a - b).max() <= 2.0**-8 * max(1.0, np.abs(b).max()), np.abs(a - b).max()


def test_float32_noise_keeps_fused_output_bf16(rng):
    """Pinned float32 noise is cast to bf16 inside the fused chain (JAX's
    styled_conv_pallas.py:179), so it does not promote the chain to float32
    as it does the composite (ROADMAP W6)."""
    m, _, _ = _module_pair(rng, 16, 16)
    x, style, noise, _ = _module_inputs(rng, 16, 16)
    xb, sb, n32 = torch.from_numpy(x).bfloat16(), torch.from_numpy(style).bfloat16(), \
        torch.from_numpy(noise)
    with torch.no_grad():
        fused = m(xb, sb, n32)
        assert fused.dtype == torch.bfloat16
        assert torch.equal(fused, m(xb, sb, n32.bfloat16()))
        m.fused = False
        assert m(xb, sb, n32).dtype == torch.float32


def test_fused_flag_reaches_only_non_upsampled_3x3_convs(monkeypatch):
    """The JAX gate (layers.py:430-432, generator.py:74-103): both convs of
    each head block and conv2 of each upsampling block; never an upsampling
    conv1; float32 runs the composite."""
    model = PPSTModel(PPSTConfig(**NARROW, fused_styled_conv=True), device="cpu")
    fused = sorted(n for n, mod in model.G.named_modules()
                   if isinstance(mod, tl.StyledConv) and mod.fused)
    assert len(fused) == 2 * 4 + 3
    assert not any(n.startswith("UpsamplingResBlock") and n.endswith("conv1") for n in fused)
    calls = []
    real = sc._forward_reference

    def spy(*args):
        calls.append(args[0].dtype)
        return real(*args)

    monkeypatch.setattr(sc, "_forward_reference", spy)
    sp = torch.randn(1, 8, 8, 16)
    gl = [torch.randn(1, 64) for _ in range(4)]
    with torch.no_grad():
        model.G(sp, gl)
        assert calls == []
        model.G(sp.bfloat16(), [g.bfloat16() for g in gl])
    assert calls == [torch.bfloat16] * 11


def test_from_flax_round_trip_fused_generator():
    """A JAX generator built with fused_styled_conv=True (bf16 inputs, so its
    fused StyledConvs create their parameter twins) has the composite's
    parameter tree; it loads into the port's fused generator and converts back
    unchanged."""
    cfg = JaxConfig(**NARROW, fused_styled_conv=True)
    k = jax.random.PRNGKey(0)
    sp = jnp.zeros((2, 8, 8, cfg.spatial_code_ch), jnp.bfloat16)
    gl = [jnp.zeros((2, cfg.style_dim), jnp.bfloat16)] * 4

    def init(c, s, g):
        return lambda: JaxG(c).init({"params": k, "noise": k}, s, g,
                                    extract_features=True)["params"]

    tree = random_params_like(init(cfg, sp, gl), scale=1.0, seed=0)
    plain = jax.eval_shape(init(JaxConfig(**NARROW), sp.astype(jnp.float32),
                                [g.astype(jnp.float32) for g in gl]))
    assert jax.tree_util.tree_structure(tree) == jax.tree_util.tree_structure(plain)
    model = PPSTModel(PPSTConfig(**NARROW, fused_styled_conv=True), device="cpu")
    sd = {}
    from_g(_Out(sd), tree)
    model.G.load_state_dict(sd)  # strict: the same keys and shapes
    back = convert_g(_SD({k: v.numpy() for k, v in model.G.state_dict().items()}))
    got = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        np.testing.assert_array_equal(np.asarray(got[path]), np.asarray(leaf), err_msg=str(path))
