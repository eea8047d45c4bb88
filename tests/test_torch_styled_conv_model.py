"""The fused StyledConv (``fused_styled_conv``) in the port's generator,
serving path, training step and CLIs, against ppst_tpu's on the CPU.

The port runs K6's plain versions; JAX runs its Pallas kernel in interpret
mode under ``jax.jit``, with its parameters as JAX arrays (ROADMAP F1). The
noise gains and the StyledConvs' biases are set to seeded nonzero values and
the noise is pinned (in bf16 for the bf16 runs, so that it does not promote
the upsampling convs' composite to float32, W6), except in ``stylize``,
whose API draws its own noise: there the gains stay at zero.

In float32 the option runs the composite, as in JAX (the fused chain is a
bf16 path); the float32 runs are the yardstick of the bf16 distances.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image
from test_torch_train_common import NARROW as NARROW_D
from test_torch_train_common import batch, grad_tree, jax_params, seed_checkpoint

from ppst_tpu.models.config import PPSTConfig as JaxConfig
from ppst_tpu.models.generator import Generator as JaxG
from ppst_tpu.models.ppst import PPSTModel as JaxModel
from ppst_tpu_torch import test as test_cli
from ppst_tpu_torch.models.config import PPSTConfig
from ppst_tpu_torch.models.ppst import PPSTModel
from ppst_tpu_torch.nn.layers import StyledConv
from ppst_tpu_torch.ops import styled_conv_cuda as sc
from ppst_tpu_torch.train import cli as train_cli

NARROW = {k: v for k, v in NARROW_D.items() if k != "netD_scale_capacity"}
KW = dict(NARROW, fused_tap=True, fused_styled_conv=True)
# one (B, H, W, 1) noise per StyledConv at crop 64: 4 head blocks at 8x8, then
# the up-blocks at 16, 32 and 64
NOISE_HW = [8] * 8 + [16, 16, 32, 32, 64, 64]
RATIO = 1.25  # port bf16 error / JAX bf16 error, as tests/test_torch_bf16.py's generator
# G's bf16 gradients, port against JAX: per tensor a cosine of at least
# GRAD_COS (measured min 0.936, up32's conv2 biases; JAX's own bf16 gradient
# has a cosine of 0.891 with its float32 one at worst)
GRAD_COS = 0.9
# one bf16 G step, fused against unfused on the same weights, batch and
# noise. bf16 moves this step's gradients far from float32 at these widths
# whichever path runs (relative L2 distance per network 0.41-0.66 fused,
# 0.47-0.53 unfused; cosines 0.84-0.92 and 0.85-0.89), so the yardstick is the
# unfused step. Measured: losses within 1.4% of the unfused step's (the
# unfused within 1.0% of float32's); per network a cosine of 0.889 (E2) to
# 0.930 (G) with the unfused step, and the fused step's cosine with the
# float32 step at most 0.016 below the unfused step's (E2).
LOSS_RTOL, STEP_COS, STEP_COS_DROP = 0.03, 0.85, 0.05


def _model(kw=KW, gains=True, seed=0):
    """The port's model with seeded nonzero StyledConv biases (and noise
    gains)."""
    model = PPSTModel(PPSTConfig(**kw), device="cpu", seed=seed)
    g = torch.Generator().manual_seed(7)
    with torch.no_grad():
        for m in model.G.modules():
            if isinstance(m, StyledConv):
                for p in (m.conv.bias, m.bias, m.activate.bias):
                    p.uniform_(-0.2, 0.2, generator=g)
                if gains and m.noise is not None:
                    m.noise.weight.uniform_(0.05, 0.2, generator=g)
    return model


def _rel(a, b, rms):
    d = np.abs(a - b)
    return d.mean() / rms, d.max() / rms


def _generator_runs():
    """G's (rgb, feat, feat1) from both frameworks in float32 and bf16, and
    the gradient of a loss on them for G's parameters in bf16."""
    model = _model()
    params = jax_params(model)["G"]
    cfg = JaxConfig(**KW)
    rng = np.random.default_rng(0)
    sp = rng.standard_normal((2, 8, 8, cfg.spatial_code_ch)).astype(np.float32)
    gl = [rng.standard_normal((2, cfg.style_dim)).astype(np.float32) for _ in range(4)]
    noises = [rng.standard_normal((2, s, s, 1)).astype(np.float32) for s in NOISE_HW]
    cots = [rng.standard_normal(s).astype(np.float32)
            for s in ((2, 64, 64, 3), (2, 8, 8, cfg.g_fuse_ch), (2, 32, 32, 8))]

    def jax_g(p, s, g, n):
        return JaxG(cfg).apply({"params": p}, s, g, extract_features=True, noises=n)

    def jax_loss(p, s, g, n):
        return sum(jnp.sum(o.astype(jnp.float32) * c) for o, c in zip(jax_g(p, s, g, n), cots))

    def jax_in(dt):
        return (jnp.asarray(sp).astype(dt), [jnp.asarray(v).astype(dt) for v in gl],
                [jnp.asarray(v).astype(dt) for v in noises])

    def port_in(dt):
        t = torch.from_numpy
        return t(sp).to(dt), [t(v).to(dt) for v in gl], [t(v).to(dt) for v in noises]

    jf = jax.jit(jax_g)
    out = {}
    for name, dt, tdt in (("32", jnp.float32, torch.float32), ("16", jnp.bfloat16, torch.bfloat16)):
        out["jax" + name] = [np.asarray(o.astype(jnp.float32)) for o in jf(params, *jax_in(dt))]
        s, g, n = port_in(tdt)
        with torch.no_grad():
            out["port" + name] = [o.float().numpy()
                                  for o in model.G(s, g, extract_features=True, noises=n)]
    grad = jax.jit(jax.grad(jax_loss))
    out["jax_grad"] = grad(params, *jax_in(jnp.bfloat16))
    out["jax_grad32"] = grad(params, *jax_in(jnp.float32))
    s, g, n = port_in(torch.bfloat16)
    model.zero_grad(set_to_none=True)
    outs = model.G(s, g, extract_features=True, noises=n)
    sum((o.float() * torch.from_numpy(c)).sum() for o, c in zip(outs, cots)).backward()
    out["port_grad"] = grad_tree(model, ("G",))["G"]
    return out


@pytest.fixture(scope="module")
def generator_runs():
    return _generator_runs()


def _g_rel(runs, a, b):
    return [_rel(runs[a][i], runs[b][i], np.sqrt(np.mean(runs["jax32"][i] ** 2)))
            for i in range(3)]


def test_generator_f32_paths_agree(generator_runs):
    """In float32 both run the composite: agreement to 1e-3 of the RMS."""
    for a, b in zip(generator_runs["port32"], generator_runs["jax32"]):
        assert np.abs(a - b).max() <= 1e-3 * np.sqrt(np.mean(b * b))


def test_generator_bf16_fused_matches_jax(generator_runs):
    """The narrow generator in bf16 with the fused StyledConv: the port's
    distance from float32 within 1.25x JAX's (rgb, feat, feat1), and the two
    bf16 runs about as far apart as each is from float32. Measured, mean of
    the RMS: port 2.10%, 1.47%, 1.80%; JAX 2.02%, 1.50%, 1.77%; port against
    JAX 2.08%, 1.63%, 1.81%."""
    port = _g_rel(generator_runs, "port16", "port32")
    jax_err = _g_rel(generator_runs, "jax16", "jax32")
    cross = _g_rel(generator_runs, "port16", "jax16")
    for p, j, c in zip(port, jax_err, cross):
        assert p[0] <= RATIO * j[0], (port, jax_err)
        assert c[0] <= RATIO * max(p[0], j[0]), (cross, port, jax_err)


def _flat(tree):
    return {jax.tree_util.keystr(k): np.asarray(v, np.float64)
            for k, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def test_generator_bf16_fused_grads_match_jax(generator_runs):
    """The gradient of a loss on G's three outputs for every G parameter, bf16
    and fused on both sides, against JAX's float32 gradient (the composite):
    the port's relative distance from it within 1.25x JAX's bf16 one
    (measured 0.205 and 0.210), and per tensor a cosine of at least GRAD_COS
    with JAX's bf16 gradient. Noise gains (whose gradient is the noise's) and
    the gradients that are a mathematical zero (biases before an instance
    norm: below 1e-3 of the largest) are left out, as in the training tests."""
    port, jax16, jax32 = (_flat(generator_runs[k]) for k in ("port_grad", "jax_grad",
                                                             "jax_grad32"))
    assert set(port) == set(jax32)
    scale = max(np.abs(v).max() for v in jax32.values())
    keep = [k for k, v in jax32.items() if "noise" not in k and np.abs(v).max() > 1e-3 * scale]
    assert len(keep) > 100

    def rel(a):
        u = np.concatenate([a[k].ravel() for k in keep])
        v = np.concatenate([jax32[k].ravel() for k in keep])
        return np.linalg.norm(u - v) / np.linalg.norm(v)

    assert rel(port) <= RATIO * rel(jax16), (rel(port), rel(jax16))
    for k in keep:
        g, w = port[k].ravel(), jax16[k].ravel()
        assert np.isfinite(g).all(), k
        if g.size > 1:
            assert g @ w / (np.linalg.norm(g) * np.linalg.norm(w)) >= GRAD_COS, k


def _stylize_runs():
    model = _model(gains=False)
    params = jax_params(model)
    jmodel = JaxModel(JaxConfig(**KW), lpips_variables={})
    rng = np.random.default_rng(1)
    content = rng.uniform(-1, 1, (2, 64, 64, 3)).astype(np.float32)
    style = rng.uniform(-1, 1, (2, 64, 64, 3)).astype(np.float32)
    out = {}
    for name, dt, tdt in (("32", jnp.float32, torch.float32), ("16", jnp.bfloat16, torch.bfloat16)):
        out["jax" + name] = np.asarray(jmodel.stylize(
            params, jnp.asarray(content).astype(dt), jnp.asarray(style).astype(dt),
            jax.random.PRNGKey(0), smooth_target=True).astype(jnp.float32))
        out["port" + name] = model.stylize(
            torch.from_numpy(content).to(tdt), torch.from_numpy(style).to(tdt),
            torch.Generator().manual_seed(0), smooth_target=True).float().numpy()
    return out


def test_stylize_bf16_fused_matches_jax():
    """``PPSTModel.stylize`` in bf16 with the fused tap and the fused
    StyledConv, guided filter on, against JAX's: the port's bf16 distance from
    float32 within 1.25x JAX's, and the two bf16 runs no further apart than
    each is from float32. Measured, mean / max of the RMS: port 3.91% /
    19.2%, JAX 4.26% / 19.9%, port against JAX 4.08% / 24.7%; float32 port
    against JAX (both composite) below 1e-5."""
    runs = _stylize_runs()
    rms = np.sqrt(np.mean(runs["jax32"] ** 2))
    assert np.abs(runs["port32"] - runs["jax32"]).max() <= 1e-3
    port = _rel(runs["port16"], runs["port32"], rms)
    jax_err = _rel(runs["jax16"], runs["jax32"], rms)
    cross = _rel(runs["port16"], runs["jax16"], rms)
    assert port[0] <= RATIO * jax_err[0], (port, jax_err)
    assert cross[0] <= max(port[0], jax_err[0]), (cross, port, jax_err)


def _count_calls(monkeypatch):
    counts = {"fwd": 0, "bwd": 0}
    fwd, bwd = sc._forward_reference, sc.styled_conv3x3_bwd_reference

    def spy_fwd(*a):
        counts["fwd"] += 1
        return fwd(*a)

    def spy_bwd(*a, **k):
        counts["bwd"] += 1
        return bwd(*a, **k)

    monkeypatch.setattr(sc, "_forward_reference", spy_fwd)
    monkeypatch.setattr(sc, "styled_conv3x3_bwd_reference", spy_bwd)
    return counts


def _g_step_grads(dtype, fused, counts=None):
    """One G step's losses and its G, E1 and E2 gradients (flattened)."""
    kw = dict(NARROW_D, dtype=dtype, fused_tap=fused, fused_styled_conv=fused)
    model = _model(kw)
    dt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    real, mask = (torch.from_numpy(v).to(dt) for v in batch())
    if counts is not None:
        with torch.no_grad():
            model.discriminator_losses(real, mask, torch.Generator().manual_seed(0))
        counts["d_fwd"], counts["d_bwd"] = counts.pop("fwd"), counts.pop("bwd")
        counts.update(fwd=0, bwd=0)
    losses, _, _ = model.generator_losses(real, mask, torch.Generator().manual_seed(0))
    params = [p for n in ("G", "E1", "E2") for p in getattr(model, n).parameters()]
    sum(losses.values()).backward(inputs=params)
    return ({k: v.item() for k, v in losses.items()},
            {k: p.grad.double().ravel() for k, p in model.named_parameters()
             if p.grad is not None and k.split(".")[0] in ("G", "E1", "E2")})


@pytest.fixture(scope="module")
def g_steps():
    """The fused bf16 step (with its K6 calls counted), the unfused bf16 step
    and the float32 step, from the same weights, batch and noise."""
    mp = pytest.MonkeyPatch()
    counts = _count_calls(mp)
    try:
        fused = _g_step_grads("bfloat16", True, counts)
    finally:
        mp.undo()
    return fused, _g_step_grads("bfloat16", False), _g_step_grads("float32", False), counts


def _cos(a, b):
    return (a @ b).item() / (a.norm() * b.norm()).item()


def test_g_step_fused_tracks_unfused(g_steps):
    """One bf16 G step at crop 64 with the option on: every loss finite and
    within LOSS_RTOL of the unfused bf16 step's, every gradient finite, and per
    network (G, E1, E2) the gradient's cosine with the unfused step's at least
    STEP_COS and its cosine with the float32 step no more than STEP_COS_DROP
    below the unfused step's. Noise gains and gradients that are a
    mathematical zero (below 1e-3 of the network's largest) are left out."""
    (lf, gf), (lu, gu), (_, g32), _ = g_steps
    assert set(lf) == set(lu)
    for k, v in lf.items():
        assert np.isfinite(v) and abs(v - lu[k]) <= LOSS_RTOL * max(abs(lu[k]), 1e-2), (k, v, lu[k])
    assert all(torch.isfinite(v).all() for v in gf.values())
    for net in ("G", "E1", "E2"):
        scale = max(v.abs().max().item() for k, v in g32.items() if k.startswith(net + "."))
        keep = [k for k, v in g32.items() if k.startswith(net + ".") and "noise" not in k
                and v.abs().max().item() > 1e-3 * scale]
        f, u, r = (torch.cat([g[k] for k in keep]) for g in (gf, gu, g32))
        assert _cos(f, u) >= STEP_COS, (net, _cos(f, u))
        assert _cos(f, r) >= _cos(u, r) - STEP_COS_DROP, (net, _cos(f, r), _cos(u, r))


def test_g_step_kernel_counts(g_steps):
    """The launches chip_smoke.py expects on the card, counted here on the
    plain versions: a D step's two generator passes run K6 forward 11 times
    each without grad; a G step's three passes (g_ext, g_mix, g_cyc) 11 times
    each and again in their rematerialized recompute, and the backward 11
    times for each pass whose output carries gradient to G's trunk (g_mix and
    g_cyc: the taps read a detached trunk)."""
    counts = g_steps[3]
    assert (counts["d_fwd"], counts["d_bwd"]) == (22, 0)
    assert (counts["fwd"], counts["bwd"]) == (66, 22)


def _cli_args(tmp_path, rng):
    paths = []
    for name in ("content", "style"):
        p = tmp_path / f"{name}.png"
        Image.fromarray((rng.random((72, 80, 3)) * 255).astype(np.uint8)).save(p)
        paths.append(str(p))
    return ["--name", "ppst", "--evaluation_metrics", "simple_swapping",
            "--input_structure_image", paths[0], "--input_texture_image", paths[1],
            "--preprocess", "resize", "--load_size", "64", "--crop_size", "64", "--result_dir",
            str(tmp_path / "results"),
            "--checkpoint", seed_checkpoint(tmp_path / "seed.pth", crop_size=64)]


def test_cli_fused_styled_conv_writes_png(tmp_path, rng):
    """``python -m ppst_tpu_torch.test --fused_styled_conv true``: full width
    at crop 64, bf16, the fused chains' plain versions on the CPU."""
    (ev,) = test_cli.main(_cli_args(tmp_path, rng) + [
        "--device", "cpu", "--dtype", "bfloat16", "--fused_tap", "true",
        "--fused_styled_conv", "true"]).evaluators
    out = ev.paths
    assert [p.rsplit("/", 1)[1] for p in out] == ["content_style_1.00.png"]
    assert np.asarray(Image.open(out[0])).shape == (64, 64, 3)


def test_train_cli_fused_styled_conv(tmp_path):
    """``python -m ppst_tpu_torch.train --fused_styled_conv true --dtype
    bfloat16`` trains at the narrow widths (4 steps) and records the flag."""
    widths = [f"--{k}={v}" for k, v in NARROW_D.items() if k != "crop_size"]
    args = ["--device", "cpu", "--name", "run", "--checkpoints_dir", str(tmp_path),
            "--dataset_mode", "synthetic", "--synthetic_size", "6", "--crop_size", "64",
            "--load_size", "64", "--batch_size", "2", "--total_nimgs", "8", "--print_freq", "4",
            "--R1_once_every", "2", "--nThreads", "2", "--dtype", "bfloat16", "--fused_tap",
            "true", "--fused_styled_conv", "true", *widths]
    bundle = train_cli.main(args)
    assert bundle.model.cfg.fused_styled_conv and bundle.model.G.HeadResnetBlock0.conv1.fused
    opt = (tmp_path / "run" / "opt.txt").read_text()
    assert "fused_styled_conv: True" in opt
    assert (tmp_path / "run" / "latest_checkpoint.pth").exists()
    log = (tmp_path / "run" / "loss_log.txt").read_text().splitlines()[-1]
    values = [float(tok) for tok in log.split(") ", 1)[1].split()[1::2]]
    assert values and np.isfinite(values).all()


if __name__ == "__main__":
    # The readings the bounds above quote, in % of the float32 output's RMS.
    runs = _generator_runs()
    for a, b in [("port16", "port32"), ("jax16", "jax32"), ("port16", "jax16")]:
        print(f"G {a} vs {b} (rgb, feat, feat1), mean / max: "
              + ", ".join(f"{100 * m:.3f} / {100 * x:.2f}" for m, x in _g_rel(runs, a, b)))
    s = _stylize_runs()
    rms = np.sqrt(np.mean(s["jax32"] ** 2))
    for a, b in [("port16", "port32"), ("jax16", "jax32"), ("port16", "jax16")]:
        m, x = _rel(s[a], s[b], rms)
        print(f"stylize {a} vs {b}: {100 * m:.3f} / {100 * x:.2f}")
