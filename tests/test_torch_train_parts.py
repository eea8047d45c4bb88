"""Pieces of the port's training slice against ppst_tpu: the repaired faults
F2 (detached feature taps) and F3 (detached deeper-scale correspondence),
E2's masked projections, the Adam update against optax's, and the port's
own invariants (remat on and off, bf16 steps). Float32 at NARROW on the
CPU unless bf16 is named.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from test_torch_train_common import NARROW, batch, grad_tree, jax_params

from ppst_tpu.models.config import PPSTConfig as JaxConfig
from ppst_tpu.models.encoder_col import ColorEncoder as JaxE2
from ppst_tpu.models.generator import Generator as JaxG
from ppst_tpu_torch.models.config import PPSTConfig
from ppst_tpu_torch.models.ppst import PPSTModel
from ppst_tpu_torch.train.steps import TrainSteps, make_optimizers


@pytest.fixture(scope="module")
def pair():
    model = PPSTModel(PPSTConfig(**NARROW), device="cpu")
    return model, jax_params(model)


def _close(a, b, rtol=1e-3, what="", atol=0.0):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape, (what, a.shape, b.shape)
    assert np.abs(a - b).max() <= rtol * max(np.abs(b).max(), 1e-12) + atol, (
        what, np.abs(a - b).max(), np.abs(b).max())


def test_feature_taps_train_only_the_feature_branch(pair, rng):
    """F2. A loss that reads only G's feat/feat1 gives exactly zero gradient
    to the trunk (JAX stops the gradient at every tap, generator.py:268,
    :284), and the taps' and fuse blocks' gradients match JAX's."""
    model, params = pair
    cfg = model.cfg
    sp = rng.standard_normal((2, 8, 8, cfg.spatial_code_ch)).astype(np.float32)
    gl = [rng.standard_normal((2, cfg.style_dim)).astype(np.float32) for _ in range(4)]
    c1 = rng.standard_normal((2, 8, 8, cfg.g_fuse_ch)).astype(np.float32)
    c2 = rng.standard_normal((2, 32, 32, cfg.netG_resnet_ch // 4)).astype(np.float32)

    def jloss(p):
        _, feat, feat1 = JaxG(JaxConfig(**NARROW)).apply(
            {"params": p}, jnp.asarray(sp), [jnp.asarray(g) for g in gl],
            extract_features=True, rngs={"noise": jax.random.PRNGKey(0)})
        return jnp.sum(feat * c1) + jnp.sum(feat1 * c2)

    want = jax.jit(jax.grad(jloss))(params["G"])
    model.zero_grad(set_to_none=True)
    _, feat, feat1 = model.G(torch.from_numpy(sp), [torch.from_numpy(g) for g in gl],
                             extract_features=True, generator=torch.Generator().manual_seed(0))
    ((feat * torch.from_numpy(c1)).sum() + (feat1 * torch.from_numpy(c2)).sum()).backward()
    trunk = ("SpatialCodeModulation", "HeadResnetBlock", "UpsamplingResBlock", "ToRGB")
    for k, p in model.G.named_parameters():
        if k.startswith(trunk):
            assert p.grad is None or not p.grad.any(), k
    got = grad_tree(model, ("G",))["G"]
    # 1e-3 of each tensor's max, plus 1e-4 of the branch's largest gradient
    # for the conv biases before an instance norm (a mathematical zero)
    scale = max(np.abs(np.asarray(v)).max() for k in want if k.startswith(("tap", "fuse"))
                for v in jax.tree.leaves(want[k]))
    for key in want:
        leaves = jax.tree_util.tree_flatten_with_path(want[key])[0]
        got_leaves = dict(jax.tree_util.tree_flatten_with_path(got[key])[0])
        for path, w in leaves:
            if key.startswith(("tap", "fuse")):
                _close(got_leaves[path], w, what=(key, path), atol=1e-4 * scale)
            else:
                assert not np.asarray(w).any(), (key, path)


def _softmax_corr(rng, b=2, length=64):
    logits = rng.standard_normal((b, length, length)).astype(np.float32) * 3
    e = np.exp(logits - logits.max(-1, keepdims=True))
    return (e / e.sum(-1, keepdims=True)).astype(np.float32)


def test_e2_deeper_scales_warp_through_detached_corr(pair, rng):
    """F3. The gradient of a loss on vectors_w with respect to the
    correspondence flows through scale 0 only, as JAX's (encoder_col.py:230,
    :235-236): the same gradient on both sides."""
    model, params = pair
    x = rng.uniform(-1, 1, (2, 64, 64, 3)).astype(np.float32)
    corr = _softmax_corr(rng)
    cots = [rng.standard_normal((2, model.cfg.style_dim)).astype(np.float32) for _ in range(4)]

    def jloss(c):
        out = JaxE2(JaxConfig(**NARROW)).apply({"params": params["E2"]}, jnp.asarray(x),
                                               corrmatrix=c)
        return sum(jnp.sum(v * w) for v, w in zip(out.vectors_w, cots))

    want = jax.jit(jax.grad(jloss))(jnp.asarray(corr))
    ct = torch.from_numpy(corr).requires_grad_(True)
    out = model.E2(torch.from_numpy(x), corrmatrix=ct)
    sum((v * torch.from_numpy(w)).sum() for v, w in zip(out.vectors_w, cots)).backward()
    _close(ct.grad.numpy(), want, what="d loss / d corrmatrix")


def test_e2_masked_projections_match_jax(pair, rng):
    """projections_m (3 regions per scale, mask max-pooled 2x per scale)
    and projections_mw (the warped features under the batch-swapped mask)."""
    model, params = pair
    x = rng.uniform(-1, 1, (2, 64, 64, 3)).astype(np.float32)
    _, mask = batch(seed=3)
    corr = _softmax_corr(rng)
    want = JaxE2(JaxConfig(**NARROW)).apply({"params": params["E2"]}, jnp.asarray(x),
                                            corrmatrix=jnp.asarray(corr),
                                            mask=jnp.asarray(mask))
    with torch.no_grad():
        got = model.E2(torch.from_numpy(x), corrmatrix=torch.from_numpy(corr),
                       mask=torch.from_numpy(mask))
    for field in ("vectors", "vectors_w", "projections_m", "projections_mw"):
        a, b = getattr(got, field), getattr(want, field)
        assert len(a) == len(b) == (12 if field.startswith("proj") else 4), field
        for i, (u, v) in enumerate(zip(a, b)):
            _close(u.numpy(), v, rtol=1e-4, what=(field, i))


def test_adam_update_matches_optax(pair, rng):
    """The four optimizers on identical gradients: G/E1/E2's Adam(lr,
    (beta1, beta2)) and D's lazy-R1-compensated Adam(lr c, betas ** c)
    move a parameter as optax.adam does over three steps."""
    model, _ = pair
    cfg = model.cfg
    c = cfg.R1_once_every / (1 + cfg.R1_once_every)
    opts = make_optimizers(model)
    for key, (lr, b1, b2) in (("G", (cfg.lr, cfg.beta1, cfg.beta2)),
                              ("D", (cfg.lr * c, cfg.beta1**c, cfg.beta2**c))):
        hp = opts[key].param_groups[0]
        assert (hp["lr"], hp["betas"], hp["eps"]) == (lr, (b1, b2), 1e-8), key
        w0 = rng.standard_normal((16, 8)).astype(np.float32)
        grads = [rng.standard_normal((16, 8)).astype(np.float32) for _ in range(3)]
        p = torch.nn.Parameter(torch.from_numpy(w0.copy()))
        opt = torch.optim.Adam([p], lr=hp["lr"], betas=hp["betas"], eps=hp["eps"])
        tx = optax.adam(lr, b1=b1, b2=b2, eps=1e-8)
        wj, st = jnp.asarray(w0), tx.init(jnp.asarray(w0))
        for g in grads:
            p.grad = torch.from_numpy(g)
            opt.step()
            upd, st = tx.update(jnp.asarray(g), st, wj)
            wj = optax.apply_updates(wj, upd)
        # float32 parameters: the updates agree to the parameters' rounding
        _close(p.detach().numpy() - w0, np.asarray(wj) - w0, rtol=1e-4, what=key)


def _step_grads(cfg_kw, real, mask):
    """One D, D+R1 and G step's losses and the gradients of the last."""
    model = PPSTModel(PPSTConfig(**cfg_kw), device="cpu")
    steps = TrainSteps(model)
    out = {}
    for name, step in (("d", steps.d_step), ("r1", steps.d_step_r1), ("g", steps.g_step)):
        out[name] = step(real, mask, torch.Generator().manual_seed(0))
    grads = {k: p.grad.clone() for k, p in model.named_parameters() if p.grad is not None}
    return out, grads


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_remat_keeps_losses_and_gradients(dtype):
    """cfg.remat (torch.utils.checkpoint at the G call sites, and at every
    site with "all") recomputes the same values: identical losses and
    gradients, in bf16 with the fused tap too."""
    real, mask = (torch.from_numpy(v) for v in batch())
    kw = dict(NARROW, dtype=dtype, fused_tap=dtype == "bfloat16")
    base = _step_grads(dict(kw, remat=False), real, mask)
    for nets in ("g", "all"):
        losses, grads = _step_grads(dict(kw, remat=True, remat_nets=nets), real, mask)
        for step in base[0]:
            for k, v in base[0][step].items():
                assert torch.equal(losses[step][k], v), (nets, step, k)
        assert set(grads) == set(base[1])
        for k, g in base[1].items():
            assert torch.equal(grads[k], g), (nets, k)


def test_bf16_steps_keep_float32_state():
    """bf16 compute with the fused tap: finite losses; parameters, Adam's
    state and the RSCL queues stay float32; every network's parameters
    move; the RSCL pointers advance by 6 per scale (mirrors
    tests/test_train_steps.py::test_bf16_steps)."""
    model = PPSTModel(PPSTConfig(**NARROW, dtype="bfloat16", fused_tap=True), device="cpu")
    before = {k: v.clone() for k, v in model.state_dict().items()}
    steps = TrainSteps(model)
    real, mask = (torch.from_numpy(v) for v in batch())
    gen = torch.Generator().manual_seed(0)
    keys = set()
    for step in (steps.d_step, steps.d_step_r1, steps.g_step):
        losses = step(real, mask, gen)
        assert all(torch.isfinite(v).all() for v in losses.values()), losses
        keys |= set(losses)
    assert {"D_real", "D_R1", "G_L1", "G_styleContmix", "image_warp_reg", "L1_dist"} <= keys
    for k, v in model.state_dict().items():
        assert v.dtype == torch.float32, k
    for opt in steps.opts.values():
        for st in opt.state.values():
            assert st["exp_avg"].dtype == st["exp_avg_sq"].dtype == torch.float32
    assert model.rscl_queues.dtype == torch.float32
    assert model.rscl_ptrs.tolist() == [6, 6, 6, 6]
    for net in ("E1", "E2", "G", "D"):
        assert any(not torch.equal(v, before[k]) for k, v in model.state_dict().items()
                   if k.startswith(net + ".")), net


def test_snapshot_core_matches_jax(pair, rng):
    """The training snapshot's structure code, reconstruction and style mix
    (noise gains are zero at init, so the draws do not enter)."""
    from ppst_tpu.models.ppst import PPSTModel as JaxModel

    model, params = pair
    real = rng.uniform(-1, 1, (2, 64, 64, 3)).astype(np.float32)
    jmodel = JaxModel(JaxConfig(**NARROW), lpips_variables={})
    want = jax.jit(lambda p, x: jmodel.snapshot_core(p, x, jax.random.PRNGKey(0)))(
        params, jnp.asarray(real))
    got = model.snapshot_core(torch.from_numpy(real), torch.Generator().manual_seed(0))
    for name, a, b in zip(("sp", "rec", "mix"), got, want):
        _close(a.numpy(), b, rtol=1e-4, what=name)
