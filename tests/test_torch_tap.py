"""The port's fused 1x1 feature tap (K1) against ppst_tpu's Pallas kernel.

On the CPU the port's wrapper runs its plain PyTorch version; the JAX side
runs ``tap_pallas.fused_tap_1x1`` in interpret mode, as its own tests do.
The CUDA kernel itself is compared with the plain version on the card by
``chip_smoke.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ppst_tpu.models.generator import _FeatureTap as JaxFeatureTap
from ppst_tpu.ops.tap_pallas import fused_tap_1x1 as jax_fused_tap
from ppst_tpu.util.convert_torch import _SD, _feature_tap
from ppst_tpu_torch.models.generator import _FeatureTap
from ppst_tpu_torch.nn.layers import init_weights
from ppst_tpu_torch.ops.tap_cuda import fused_tap_1x1


def _bf16_input(rng, shape):
    x32 = rng.standard_normal(shape).astype(np.float32)
    return torch.from_numpy(x32).bfloat16(), jnp.asarray(x32).astype(jnp.bfloat16)


def _to_np(t):
    return np.asarray(t.float() if isinstance(t, torch.Tensor) else t.astype(jnp.float32),
                      np.float32)


def _assert_tap_close(got, want):
    # Both sides compute the same float32 statistics and bf16 roundings; only
    # the order of the float32 sums differs. That flips about 0.1% of the
    # outputs by one bf16 step (0.0625 for |v| < 8; measured max 0.016).
    assert got.shape == want.shape
    err = np.abs(got - want)
    assert err.max() <= 0.0625, err.max()
    assert err.mean() <= 1e-4, err.mean()


def test_fused_tap_plain_matches_pallas(rng):
    b, h, w, cin, c = 2, 32, 32, 128, 64
    xt, xj = _bf16_input(rng, (b, h, w, cin))
    w1 = (rng.standard_normal((cin, c)) * 0.1).astype(np.float32)
    b1 = (rng.standard_normal((c,)) * 0.1).astype(np.float32)
    w2 = (rng.standard_normal((c, c)) * 0.1).astype(np.float32)
    b2 = (rng.standard_normal((c,)) * 0.1).astype(np.float32)
    a1, a2 = np.float32(0.25), np.float32(-0.1)

    want = jax_fused_tap(xj, jnp.asarray(w1), jnp.asarray(b1), a1, jnp.asarray(w2),
                         jnp.asarray(b2), a2)
    t = torch.from_numpy
    got = fused_tap_1x1(xt, t(w1.T.copy()), t(b1), torch.tensor([a1]), t(w2.T.copy()),
                        t(b2), torch.tensor([a2]))
    assert got.dtype == torch.bfloat16
    _assert_tap_close(_to_np(got), _to_np(want))


def test_feature_tap_module_fused_matches_jax(rng):
    """_FeatureTap(conv1x1=True, fused=True) in bf16, same weights on both
    sides (drawn by the port, carried over by convert_torch)."""
    tap = _FeatureTap(128, conv1x1=True, feature_ch=256, fused=True)
    init_weights(tap, torch.Generator().manual_seed(0))
    with torch.no_grad():  # non-default slopes, so a swapped a1/a2 shows
        tap._modules["4"].weight.fill_(0.1)
        tap._modules["8"].weight.fill_(0.3)
    sd = {k: v.numpy() for k, v in tap.state_dict().items()}
    params = {"params": _feature_tap(_SD(sd))}
    xt, xj = _bf16_input(rng, (2, 32, 32, 128))

    want = JaxFeatureTap(conv1x1=True, feature_ch=256, fused=True).apply(params, xj)
    with torch.no_grad():
        got = tap(xt)
    _assert_tap_close(_to_np(got), _to_np(want))


def test_fused_tap_rejects_non_cuda_devices():
    x = torch.empty((1, 4, 4, 128), dtype=torch.bfloat16, device="meta")
    w1, w2 = torch.empty((64, 128), device="meta"), torch.empty((64, 64), device="meta")
    b, a = torch.empty((64,), device="meta"), torch.empty((1,), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        fused_tap_1x1(x, w1, b, a, w2, b, a)
