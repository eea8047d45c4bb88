"""The port's training losses and gradients against ppst_tpu's, at NARROW in
float32 on the CPU.

Weights are drawn by the port and carried to JAX by ``convert_torch``; the
RSCL queues and the LPIPS weights are carried the same way. The noise gains
are zero at init, so neither side's noise draws enter the losses (their own
gradients do, and are checked for finiteness only). The JAX side is jitted
once per step kind (module-scoped fixture) with ``remat=False``: the same
math without the recompute.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_train_common import NARROW, batch, grad_tree, jax_lpips, jax_params, jax_state

from ppst_tpu.models.config import PPSTConfig as JaxConfig
from ppst_tpu.models.ppst import PPSTModel as JaxModel
from ppst_tpu_torch.models.config import PPSTConfig
from ppst_tpu_torch.models.ppst import PPSTModel
from ppst_tpu_torch.train.steps import GE_KEYS

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


@pytest.fixture(scope="module")
def setup():
    model = PPSTModel(PPSTConfig(**NARROW), device="cpu")
    jmodel = JaxModel(JaxConfig(**NARROW, remat=False), lpips_variables=jax_lpips(model.lpips))
    params, state = jax_params(model), jax_state(model)
    real, mask = batch()

    def d_loss(d, p, r, m):
        losses, _ = jmodel.discriminator_losses(dict(p, D=d), state, r, m, jax.random.PRNGKey(0))
        return sum(losses.values()), losses

    def r1_loss(d, p, r):
        losses = jmodel.r1_loss(dict(p, D=d), r)
        return sum(losses.values()), losses

    def g_loss(ge, p, r, m):
        losses, metrics, new_state = jmodel.generator_losses(
            dict(ge, D=p["D"]), state, r, m, jax.random.PRNGKey(0))
        return sum(losses.values()), (losses, metrics, new_state)

    jr, jm = jnp.asarray(real), jnp.asarray(mask)
    (_, d_l), d_g = jax.jit(jax.value_and_grad(d_loss, has_aux=True))(params["D"], params, jr, jm)
    (_, r1_l), r1_g = jax.jit(jax.value_and_grad(r1_loss, has_aux=True))(params["D"], params, jr)
    ge = {k: params[k] for k in GE_KEYS}
    (_, (g_l, g_m, g_state)), g_g = jax.jit(jax.value_and_grad(g_loss, has_aux=True))(
        ge, params, jr, jm)
    want = {"d": (d_l, {"D": d_g}), "r1": (r1_l, {"D": r1_g}),
            "g": (dict(g_l, **g_m), g_g), "g_state": g_state}
    return model, real, mask, want


def _port(model, kind, real, mask):
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


def _assert_losses(got, want):
    assert set(got) == set(want), (sorted(got), sorted(want))
    for k in want:
        w = float(want[k])
        assert abs(got[k] - w) <= LOSS_RTOL * max(abs(w), 1e-3), (k, got[k], w)


def _assert_grads(got, want):
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
            assert err <= GRAD_RTOL * np.abs(w).max() + GRAD_ATOL * scale, (
                name, err, np.abs(w).max(), scale)
            if np.abs(w).max() > 1e-3 * scale:
                cos = g.ravel() @ w.ravel() / (np.linalg.norm(g) * np.linalg.norm(w))
                assert cos >= GRAD_COS, (name, cos)


@pytest.mark.parametrize("kind", ["d", "r1", "g"])
def test_step_losses_and_grads_match_jax(setup, kind):
    """Every loss key (and L1_dist) of the D step, the R1 penalty (the
    second half of a D+R1 step) and the G step, and the gradient of their
    sums for every parameter tensor the step updates."""
    model, real, mask, want = setup
    losses, grads, _ = _port(model, kind, real, mask)
    _assert_losses(losses, want[kind][0])
    _assert_grads(grads, want[kind][1])


def test_g_step_rscl_enqueue_matches_jax(setup):
    """The G step's new RSCL state: six keys per scale written at the ring
    pointers, which advance by 6."""
    model, real, mask, want = setup
    _, _, state = _port(model, "g", real, mask)
    jstate = want["g_state"]["rscl"]
    np.testing.assert_array_equal(state["ptrs"].numpy(), np.asarray(jstate["ptrs"]))
    np.testing.assert_array_equal(state["ptrs"].numpy(), (model.rscl_ptrs + 6).numpy())
    np.testing.assert_allclose(state["queues"].numpy(), np.asarray(jstate["queues"]),
                               rtol=1e-4, atol=1e-5)
