"""The port's discriminator and its R1 penalty against ppst_tpu's, float32 on
the CPU, with the port's weights carried over by ``convert_torch``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_train_common import NARROW

from ppst_tpu.models.config import PPSTConfig as JaxConfig
from ppst_tpu.models.discriminator import Discriminator as JaxD
from ppst_tpu.util.convert_torch import _SD, convert_d
from ppst_tpu_torch.models.config import PPSTConfig
from ppst_tpu_torch.models.discriminator import Discriminator
from ppst_tpu_torch.nn.layers import init_weights


def _pair(crop, capacity):
    kw = dict(NARROW, crop_size=crop, netD_scale_capacity=capacity)
    d = Discriminator(PPSTConfig(**kw))
    init_weights(d, torch.Generator().manual_seed(0))
    sd = {k: v.numpy() for k, v in d.state_dict().items()}
    params = jax.tree.map(jnp.asarray, convert_d(_SD(sd), crop))
    return d, JaxD(JaxConfig(**kw)), params


@pytest.mark.parametrize("crop,capacity", [(64, 0.125), (32, 0.25)])
def test_discriminator_matches_jax(rng, crop, capacity):
    """Scores of the pyramid (the blur folded into the downsampling convs,
    the fused-lrelu head) within 1e-4 of their scale."""
    d, jd, params = _pair(crop, capacity)
    x = rng.uniform(-1, 1, (3, crop, crop, 3)).astype(np.float32)
    want = np.asarray(jd.apply({"params": params}, jnp.asarray(x)))
    with torch.no_grad():
        got = d(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (3, 1)
    assert np.abs(got - want).max() <= 1e-4 * max(1.0, np.abs(want).max())


def test_r1_input_gradient_matches_jax(rng):
    """The R1 penalty's inner gradient, d sum(D(x)) / dx, and the penalty
    lambda_R1 / 2 * mean_b sum |grad|^2 (the first backward of R1's double
    backward; the second is held by test_torch_train). The scores agree to
    1e-4, the input gradient less well: a leaky-ReLU slope is 1 or 0.2 by
    the sign of its input, and an input near 0 can take either sign in the
    two frameworks. Measured: max gap 0.38% of max |grad|, 0.11% in L2."""
    d, jd, params = _pair(64, 0.125)
    x = rng.uniform(-1, 1, (2, 64, 64, 3)).astype(np.float32)
    want = np.asarray(jax.grad(lambda v: jnp.sum(jd.apply({"params": params}, v)))(
        jnp.asarray(x)))
    xt = torch.from_numpy(x).requires_grad_(True)
    (got,) = torch.autograd.grad(d(xt).sum(), xt, create_graph=True)
    err = got.detach().numpy() - want
    assert np.abs(err).max() <= 1e-2 * np.abs(want).max()
    assert np.linalg.norm(err) <= 5e-3 * np.linalg.norm(want)
    pen_t = ((got**2).sum((1, 2, 3)) * 5.0).mean()
    pen_j = float(np.mean(np.sum(want**2, axis=(1, 2, 3)) * 5.0))
    assert abs(pen_t.item() - pen_j) <= 1e-2 * pen_j, (pen_t.item(), pen_j)
    pen_t.backward()  # the double backward runs through every D op
    # dD/dx is piecewise linear in the biases (leaky ReLUs follow them), so
    # R1 does not depend on them: exactly the biases get no gradient
    no_grad = [k for k, p in d.named_parameters() if p.grad is None]
    assert no_grad and all(k.endswith(".bias") for k in no_grad), no_grad
    assert all(torch.isfinite(p.grad).all() for p in d.parameters() if p.grad is not None)
