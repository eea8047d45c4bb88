"""The port's loss primitives and LPIPS against ppst_tpu's, float32 on the
CPU, on inputs made with numpy."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_train_common import jax_lpips

from ppst_tpu.models import losses as jl
from ppst_tpu.ops.lpips import LPIPS as JaxLPIPS
from ppst_tpu_torch.models import losses as tl
from ppst_tpu_torch.ops.lpips import LPIPS, load_torch_lpips


def _t(a):
    return torch.from_numpy(np.asarray(a))


@pytest.mark.parametrize("real", [True, False])
def test_gan_and_l1_losses(rng, real):
    pred = rng.standard_normal((4, 1)).astype(np.float32)
    a, b = rng.standard_normal((2, 2, 8, 8, 3)).astype(np.float32)
    assert abs(tl.gan_loss(_t(pred), real).item() - float(jl.gan_loss(jnp.asarray(pred), real))) \
        <= 1e-6
    assert abs(tl.l1_loss(_t(a), _t(b)).item() - float(jl.l1_loss(jnp.asarray(a),
                                                                    jnp.asarray(b)))) <= 1e-6
    # bf16 inputs are reduced in float32
    assert tl.gan_loss(_t(pred).bfloat16(), real).dtype == torch.float32


def _unit(x, axis):
    return x / np.linalg.norm(x, axis=axis, keepdims=True)


def test_rscl_loss_matches_jax(rng):
    """InfoNCE over (3, B, C) region stacks with the queue and the in-batch
    keys as negatives, the constant -10 block included."""
    q, k, k0 = (_unit(rng.standard_normal((3, 4, 32)), -1).astype(np.float32) for _ in range(3))
    queue = _unit(rng.standard_normal((32, 128)), 0).astype(np.float32)
    want = float(jl.rscl_loss_sharded(*(jnp.asarray(v) for v in (q, k, k0, queue)), 0.07, 1))
    got = tl.rscl_loss_sharded(*(_t(v) for v in (q, k, k0, queue)), 0.07).item()
    assert abs(got - want) <= 1e-5 * abs(want)


@pytest.mark.parametrize("batch", [2, 4])
def test_enqueue_schedule_matches_jax(batch):
    for a, b in zip(tl.enqueue_schedule(batch, 1), jl.enqueue_schedule(batch, 1)):
        np.testing.assert_array_equal(a, b)


def test_rscl_enqueue_matches_jax_with_wrap(rng):
    """Six keys per call at the ring pointer, which wraps at the queue size."""
    queues = _unit(rng.standard_normal((4, 32, 128)), 1).astype(np.float32)
    ptrs = np.array([0, 125, 60, 122], np.int64)
    state_t = {"queues": _t(queues), "ptrs": _t(ptrs)}
    state_j = {"queues": jnp.asarray(queues), "ptrs": jnp.asarray(ptrs.astype(np.int32))}
    for layer in range(4):
        key0, keyw = rng.standard_normal((2, 3, 2, 32)).astype(np.float32)
        state_t = tl.rscl_enqueue(state_t, layer, _t(key0).bfloat16(), _t(keyw).bfloat16())
        state_j = jl.rscl_enqueue(state_j, layer, jnp.asarray(key0).astype(jnp.bfloat16),
                                  jnp.asarray(keyw).astype(jnp.bfloat16), 1)
    assert state_t["queues"].dtype == torch.float32
    np.testing.assert_array_equal(state_t["ptrs"].numpy(), np.asarray(state_j["ptrs"]))
    np.testing.assert_array_equal(state_t["ptrs"].numpy(), (ptrs + 6) % 128)
    np.testing.assert_array_equal(state_t["queues"].numpy(), np.asarray(state_j["queues"]))


def test_init_rscl_state_unit_columns():
    state = tl.init_rscl_state(torch.Generator().manual_seed(0), code_dim=64)
    assert state["queues"].shape == (4, 64, 128) and state["ptrs"].tolist() == [0, 0, 0, 0]
    np.testing.assert_allclose(torch.linalg.vector_norm(state["queues"], dim=1).numpy(), 1.0,
                               rtol=1e-5)


def test_lpips_matches_jax(rng):
    """The port's LPIPS (seeded random AlexNet) against ppst_tpu's with the
    same weights carried across, bf16 inputs included (both run float32)."""
    model = LPIPS()
    a, b = rng.uniform(-1, 1, (2, 2, 64, 64, 3)).astype(np.float32)
    want = np.asarray(JaxLPIPS().apply(jax_lpips(model), jnp.asarray(a), jnp.asarray(b)))
    with torch.no_grad():
        got = model(_t(a), _t(b)).numpy()
        got16 = model(_t(a).bfloat16(), _t(b).bfloat16())
    assert got.shape == (2,)
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
    assert got16.dtype == torch.float32
    assert np.abs(got16.numpy() - got).max() <= 1e-2 * np.abs(got).max()


def test_load_torch_lpips(tmp_path):
    """An lpips-package state dict (its key names) loads as it is."""
    src = LPIPS(seed=7)
    torch.save(src.state_dict(), tmp_path / "alex.pth")
    dst = load_torch_lpips(LPIPS(), str(tmp_path / "alex.pth"))
    for k, v in src.state_dict().items():
        assert torch.equal(dst.state_dict()[k], v), k
