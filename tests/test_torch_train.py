"""The port's training losses and gradients against ppst_tpu's, at NARROW in
float32 on the CPU.

Weights are drawn by the port and carried to JAX by ``convert_torch``; the
RSCL queues and the LPIPS weights are carried the same way. The noise gains
are zero at init, so neither side's noise draws enter the losses (their own
gradients do, and are checked for finiteness only). The JAX side is jitted
once per step kind (module-scoped fixture) with ``remat=False``: the same
math without the recompute. The helpers and bounds are in
``test_torch_train_common.py``.
"""

import numpy as np
import pytest
from test_torch_train_common import (NARROW, assert_grads, assert_losses, batch, jax_references,
                                     port_step)

from ppst_tpu_torch.models.config import PPSTConfig
from ppst_tpu_torch.models.ppst import PPSTModel


@pytest.fixture(scope="module")
def setup():
    model = PPSTModel(PPSTConfig(**NARROW), device="cpu")
    real, mask = batch()
    return model, real, mask, jax_references(model, [(real, mask)], remat=False)[0]


@pytest.mark.parametrize("kind", ["d", "r1", "g"])
def test_step_losses_and_grads_match_jax(setup, kind):
    """Every loss key (and L1_dist) of the D step, the R1 penalty (the
    second half of a D+R1 step) and the G step, and the gradient of their
    sums for every parameter tensor the step updates."""
    model, real, mask, want = setup
    losses, grads, _ = port_step(model, kind, real, mask)
    assert_losses(losses, want[kind][0])
    assert_grads(grads, want[kind][1])


def test_g_step_rscl_enqueue_matches_jax(setup):
    """The G step's new RSCL state: six keys per scale written at the ring
    pointers, which advance by 6."""
    model, real, mask, want = setup
    _, _, state = port_step(model, "g", real, mask)
    jstate = want["g_state"]["rscl"]
    np.testing.assert_array_equal(state["ptrs"].numpy(), np.asarray(jstate["ptrs"]))
    np.testing.assert_array_equal(state["ptrs"].numpy(), (model.rscl_ptrs + 6).numpy())
    np.testing.assert_allclose(state["queues"].numpy(), np.asarray(jstate["queues"]),
                               rtol=1e-4, atol=1e-5)
