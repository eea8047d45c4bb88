"""Shared set-up of the port's training tests: the NARROW configuration with
a narrow D, the port's weights carried to ppst_tpu's trees, the inputs, one
step's losses and gradients on both sides and the bounds they are held to.
The other training test files import these helpers; the tests here check
the helpers themselves.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from ppst_tpu.models.config import PPSTConfig as JaxConfig
from ppst_tpu.models.ppst import PPSTModel as JaxModel
from ppst_tpu.util.convert_torch import convert_reference_state_dict
from ppst_tpu_torch.models.config import PPSTConfig
from ppst_tpu_torch.models.ppst import PPSTModel
from ppst_tpu_torch.train.steps import GE_KEYS

NARROW = dict(crop_size=64, netE_scale_capacity=0.25, netE2_scale_capacity=0.25,
              global_code_ch=64, spatial_code_ch=16, netG_resnet_ch=32,
              netG_scale_capacity=0.125, netD_scale_capacity=0.125)
NARROW_G = {k: v for k, v in NARROW.items() if k != "netD_scale_capacity"}  # D at its default


def seed_checkpoint(path, seed=0, **cfg):
    """A checkpoint of the weights ``PPSTModel(PPSTConfig(**cfg))`` draws from
    ``seed``, for ``python -m ppst_tpu_torch.test --checkpoint``, which
    serves no weights it does not load."""
    torch.save(PPSTModel(PPSTConfig(**cfg), device="cpu", seed=seed).state_dict(), path)
    return str(path)


def jax_params(model):
    """The port's E1/E2/G/D as ppst_tpu param trees (JAX arrays)."""
    sd = {k: v.detach().cpu().numpy() for k, v in model.state_dict().items()}
    tree = convert_reference_state_dict(sd, crop_size=model.cfg.crop_size)
    return jax.tree.map(jnp.asarray, tree)


def jax_lpips(module):
    """The port's LPIPS weights in ppst_tpu.ops.lpips's layout."""
    params = {"net": {}}
    for i in range(5):
        conv = module._conv(i)
        params["net"][f"conv{i}"] = {
            "kernel": jnp.asarray(conv.weight.detach().cpu().numpy().transpose(2, 3, 1, 0)),
            "bias": jnp.asarray(conv.bias.detach().cpu().numpy())}
        params[f"lin{i}"] = jnp.asarray(module._lin(i).detach().cpu().numpy().reshape(-1))
    return {"params": params}


def jax_state(model):
    return {"rscl": {"queues": jnp.asarray(model.rscl_queues.cpu().numpy()),
                     "ptrs": jnp.asarray(model.rscl_ptrs.cpu().numpy().astype(np.int32))},
            "num_d_iters": jnp.zeros((), jnp.int32)}


def batch(seed=0, b=2, crop=64):
    """Random images in [-1, 1] and blocky one-hot 3-region masks."""
    rng = np.random.default_rng(seed)
    real = rng.uniform(-1, 1, (b, crop, crop, 3)).astype(np.float32)
    region = np.kron(rng.integers(0, 3, (b, crop // 16, crop // 16)),
                     np.ones((1, 16, 16), np.int64))
    mask = np.stack([(region == i) for i in range(3)], -1).astype(np.float32)
    return real, mask


def grad_tree(model, nets):
    """The ``.grad`` of the port's parameters of ``nets`` as ppst_tpu trees
    (zeros where a parameter got none), through the same key conversion."""
    sd = {k: (p.grad if p.grad is not None else torch.zeros_like(p)).detach().cpu().numpy()
          for k, p in model.named_parameters()}
    tree = convert_reference_state_dict(sd, crop_size=model.cfg.crop_size)
    return {k: tree[k] for k in nets}


# losses: relative 1e-3 (measured up to ~1e-5; float32 sums in other orders
# through ~60 layers and the T = 0.01 correspondence softmax)
LOSS_RTOL = 1e-3
# gradients, per parameter tensor: max |port - JAX| <= GRAD_RTOL * max|JAX|
# + GRAD_ATOL * (the largest gradient of the network), and the cosine of the
# two >= GRAD_COS where the tensor's gradient is not a mathematical zero.
# The D and R1 gradients meet 1e-2 / 1e-4. The G step's do not: its losses
# route gradients through max-pools (the projection heads' GMP) and kinks
# (PReLU, leaky ReLU) whose choices flip between frameworks where two values
# nearly tie, so a few elements differ while the direction agrees. Measured:
# every tensor's cosine >= 0.9977, max gaps up to 4.3% of the tensor's max
# in E1/E2 and 22% in head2's biases, whose gradient is 0.8% of G's largest
# (0.19% of it in absolute terms).
GRAD_RTOL, GRAD_ATOL, GRAD_COS = 5e-2, 5e-3, 0.995


@functools.cache
def jax_steps(knobs):
    """ppst_tpu's D step, R1 penalty and G step at ``JaxConfig(**NARROW,
    **dict(knobs))`` as jitted ``value_and_grad`` functions of (trained params,
    params, state, LPIPS variables, real, mask), once per knob set a process."""
    cfg = JaxConfig(**dict(NARROW, **dict(knobs)))

    def d_loss(d, p, state, lpips, r, m):
        losses, _ = JaxModel(cfg, lpips).discriminator_losses(
            dict(p, D=d), state, r, m, jax.random.PRNGKey(0))
        return sum(losses.values()), losses

    def r1_loss(d, p, state, lpips, r, m):
        losses = JaxModel(cfg, lpips).r1_loss(dict(p, D=d), r)
        return sum(losses.values()), losses

    def g_loss(ge, p, state, lpips, r, m):
        losses, metrics, new_state = JaxModel(cfg, lpips).generator_losses(
            dict(ge, D=p["D"]), state, r, m, jax.random.PRNGKey(0))
        return sum(losses.values()), (losses, metrics, new_state)

    return {k: jax.jit(jax.value_and_grad(f, has_aux=True))
            for k, f in (("d", d_loss), ("r1", r1_loss), ("g", g_loss))}


def jax_references(model, batches, kinds=("d", "r1", "g"), **cfg):
    """ppst_tpu's losses and gradients of the steps of ``kinds`` from the
    port's weights, queues and LPIPS, with ``cfg`` over NARROW, for each
    (real, mask) of ``batches``: {"d": (losses, {"D": grads}), "r1": ...,
    "g": (losses and metrics, grads of G/E1/E2), "g_state": the G step's new
    state}."""
    fns = jax_steps(tuple(sorted(cfg.items())))
    params, state, lpips = jax_params(model), jax_state(model), jax_lpips(model.lpips)
    ge = {k: params[k] for k in GE_KEYS}
    out = []
    for real, mask in batches:
        args = (params, state, lpips, jnp.asarray(real), jnp.asarray(mask))
        ref = {}
        for kind in kinds:
            (_, aux), grads = fns[kind](ge if kind == "g" else params["D"], *args)
            if kind == "g":
                ref["g"], ref["g_state"] = (dict(aux[0], **aux[1]), grads), aux[2]
            else:
                ref[kind] = (aux, {"D": grads})
        out.append(ref)
    return out


def rel_err(a, b, rms):
    """(mean, max) of |a - b| relative to ``rms``."""
    d = np.abs(a - b)
    return d.mean() / rms, d.max() / rms


def count_calls(monkeypatch, module, **names):
    """Calls of ``module``'s functions, counted under the keys of ``names``
    (key=function name) by spies that ``monkeypatch`` puts in their place."""
    counts = dict.fromkeys(names, 0)
    for key, name in names.items():
        def spy(*a, _key=key, _fn=getattr(module, name), **k):
            counts[_key] += 1
            return _fn(*a, **k)
        monkeypatch.setattr(module, name, spy)
    return counts


def port_step(model, kind, real, mask):
    """One step's losses (and new RSCL state) and gradients from the port,
    without an optimizer update."""
    model.zero_grad(set_to_none=True)
    r, m = torch.from_numpy(real), torch.from_numpy(mask)
    gen = torch.Generator().manual_seed(0)
    state = None
    if kind == "d":
        losses = model.discriminator_losses(r, m, gen)
        nets = ("D",)
    elif kind == "r1":
        losses = model.r1_loss(r)
        nets = ("D",)
    else:
        losses, metrics, state = model.generator_losses(r, m, gen)
        nets = GE_KEYS
    params = [p for n in nets for p in getattr(model, n).parameters()]
    sum(losses.values()).backward(inputs=params)
    if kind == "g":
        losses = dict(losses, **metrics)
    return {k: v.item() for k, v in losses.items()}, grad_tree(model, nets), state


def assert_losses(got, want, rtol=LOSS_RTOL):
    assert set(got) == set(want), (sorted(got), sorted(want))
    for k in want:
        w = float(want[k])
        assert abs(got[k] - w) <= rtol * max(abs(w), 1e-3), (k, got[k], w)


def assert_grads(got, want, l2_prefixes=(), l2_bound=5e-2):
    """Every parameter tensor's gradient within GRAD_RTOL / GRAD_ATOL and
    GRAD_COS (see above); the noise gains' (the noise's own) finite only.
    A tensor whose name (``keystr`` of its path) starts with one of
    ``l2_prefixes`` may instead be within ``l2_bound`` of the JAX gradient
    in normalized L2 distance, still at GRAD_COS."""
    flat_w = dict(jax.tree_util.tree_flatten_with_path(want)[0])
    flat_g = dict(jax.tree_util.tree_flatten_with_path(got)[0])
    assert set(flat_g) == set(flat_w)
    for net in want:
        scale = max(float(np.abs(np.asarray(v)).max()) for v in jax.tree.leaves(want[net]))
        for path, w in jax.tree_util.tree_flatten_with_path(want[net])[0]:
            path = (jax.tree_util.DictKey(net),) + path
            g, w = np.asarray(flat_g[path], np.float64), np.asarray(w, np.float64)
            name = jax.tree_util.keystr(path)
            assert np.isfinite(g).all(), name
            if "noise" in name:  # NoiseInjection gains: their gradient is the noise's
                continue
            err = np.abs(g - w).max()
            l2 = np.linalg.norm(g - w) / max(np.linalg.norm(w), 1e-30)
            assert err <= GRAD_RTOL * np.abs(w).max() + GRAD_ATOL * scale or (
                name.startswith(tuple(l2_prefixes)) and l2 <= l2_bound), (
                name, err, np.abs(w).max(), scale, l2)
            if np.abs(w).max() > 1e-3 * scale:
                cos = g.ravel() @ w.ravel() / (np.linalg.norm(g) * np.linalg.norm(w))
                assert cos >= GRAD_COS, (name, cos)


def test_batch_masks_are_one_hot():
    real, mask = batch()
    assert real.shape == (2, 64, 64, 3) and np.abs(real).max() <= 1
    assert mask.shape == (2, 64, 64, 3) and np.array_equal(mask.sum(-1), np.ones((2, 64, 64)))
    assert all(mask[..., i].any() for i in range(3))


def test_grad_tree_fills_missing_grads_with_zeros():
    from ppst_tpu_torch.models.config import PPSTConfig
    from ppst_tpu_torch.models.ppst import PPSTModel

    model = PPSTModel(PPSTConfig(**NARROW), device="cpu")
    model.D.stylegan2_D.final_linear[1].bias.grad = torch.ones(1)
    tree = grad_tree(model, ("D", "G"))
    assert float(tree["D"]["core"]["fc1"]["bias"][0]) == 1.0
    assert not np.any(tree["G"]["to_rgb"]["conv"]["weight"])
