"""K4 (upfirdn2d) and K5 (bias + leaky ReLU + gain) in the port against the
JAX package's Pallas kernels, which run in interpret mode on the CPU, and
the wrappers' rules: CPU tensors take the plain version, unsupported
arguments raise. The kernels themselves run only on the card
(``chip_smoke.py`` holds them against these plain versions there).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ppst_tpu.ops.fused_act_pallas import fused_leaky_relu_pallas
from ppst_tpu.ops.upfirdn2d_pallas import upfirdn2d_pallas
from ppst_tpu_torch.ops import fused_act_cuda, upfirdn2d_cuda
from ppst_tpu_torch.ops.upfirdn2d import upfirdn2d

# the cases of tests/test_pallas_kernels.py::test_upfirdn_pallas_matches_xla,
# then asymmetric taps (tap i reads offset T-1-i: a filter that does not flip
# them fails here) with unequal pads
FIR_CASES = [([1, 3, 3, 1], 1, (2, 1)), ([1, 2, 1], 1, (1, 1)), ([1, 3, 3, 1], 2, (2, 2)),
             ([1, 2, 1], 2, (2, 1)), ([1, 2, 3], 1, (2, 0)), ([1, 2, 3], 2, (0, 3))]
BF16_STEP = 2.0**-7  # one bf16 step, relative to the value (at most)


def _taps(taps):
    k = np.asarray(taps, np.float32)
    return k / k.sum()


@pytest.mark.parametrize("taps,down,pad", FIR_CASES)
def test_upfirdn2d_plain_matches_pallas(rng, taps, down, pad):
    """float32: the plain K4 against upfirdn2d_pallas at
    test_upfirdn_pallas_matches_xla's 1e-5, and against the port's composite
    upfirdn2d (the depthwise convolutions)."""
    x = rng.standard_normal((2, 16, 12, 8)).astype(np.float32)
    k = _taps(taps)
    want = np.asarray(upfirdn2d_pallas(jnp.asarray(x), k, down=down, pad=pad, channel_block=8))
    got = upfirdn2d_cuda.upfirdn2d_cuda_reference(torch.from_numpy(x), k, down=down, pad=pad)
    assert got.shape == want.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    composite = upfirdn2d(torch.from_numpy(x), k, down=down, pad=pad)
    np.testing.assert_allclose(got.numpy(), composite.numpy(), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("taps,down,pad", [FIR_CASES[0], FIR_CASES[5]])
def test_upfirdn2d_plain_bf16_within_two_steps_of_pallas(rng, taps, down, pad):
    """bf16: the port sums in float32 and rounds once; the Pallas kernel
    rounds at its own points (its bf16 sums cancel to 0 where the exact
    value is 5.6e-4), so it is a loose oracle: within two bf16 steps of the
    output's largest value. The port's own contract is tight: within one
    bf16 step of each element of the float32 result."""
    x32 = rng.standard_normal((2, 16, 12, 24)).astype(np.float32)
    xb = torch.from_numpy(x32).bfloat16()
    k = _taps(taps)
    want = np.asarray(upfirdn2d_pallas(jnp.asarray(xb.float().numpy()).astype(jnp.bfloat16), k,
                                       down=down, pad=pad), np.float32)
    got = upfirdn2d_cuda.upfirdn2d_cuda_reference(xb, k, down=down, pad=pad)
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    exact = upfirdn2d_cuda.upfirdn2d_cuda_reference(xb.float(), k, down=down, pad=pad).numpy()
    g = got.float().numpy()
    assert np.abs(g - want).max() <= 2 * BF16_STEP * np.abs(want).max()
    assert np.all(np.abs(g - exact) <= BF16_STEP * np.abs(exact) + 1e-6)


def test_upfirdn2d_wrapper_cpu_and_refusals(rng):
    """A CPU tensor takes the plain version and launches nothing; up != 1,
    negative pads, down outside {1, 2}, more than 8 taps, an image smaller
    than the taps and a device that is neither CPU nor CUDA raise."""
    x = torch.from_numpy(rng.standard_normal((1, 9, 7, 5)).astype(np.float32))
    k = _taps([1, 3, 3, 1])
    before = upfirdn2d_cuda.upfirdn2d_cuda.launches
    assert torch.equal(upfirdn2d_cuda.upfirdn2d_cuda(x, k, down=2, pad=(2, 1)),
                       upfirdn2d_cuda.upfirdn2d_cuda_reference(x, k, down=2, pad=(2, 1)))
    assert upfirdn2d_cuda.upfirdn2d_cuda.launches == before
    for kwargs, match in ((dict(up=2), "up must be 1"), (dict(pad=(-1, 0)), "non-negative"),
                          (dict(down=3), "down must be"), (dict(taps=np.ones(9) / 9), "taps"),
                          (dict(taps=np.ones(12) / 12, pad=(1, 1)), "taps")):
        args = dict(dict(taps=k), **kwargs)
        with pytest.raises(ValueError, match=match):
            upfirdn2d_cuda.upfirdn2d_cuda(x, args.pop("taps"), **args)
    with pytest.raises(ValueError, match="unsupported device"):
        upfirdn2d_cuda.upfirdn2d_cuda(torch.empty((1, 9, 7, 5), device="meta"), k)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_leaky_relu_plain_matches_pallas(rng, dtype):
    """The plain K5 against fused_leaky_relu_pallas: float32 at
    test_fused_act_pallas_matches_xla's 1e-6; bf16 (the port rounds the add,
    the slope and the gain products; the interpreted Pallas kernel fuses
    them) within two bf16 steps of each element (measured: 1.0%)."""
    x = rng.standard_normal((2, 8, 8, 16)).astype(np.float32)
    b = rng.standard_normal((16,)).astype(np.float32)
    tx, tb = torch.from_numpy(x), torch.from_numpy(b)
    jx = jnp.asarray(x)
    if dtype == "bfloat16":
        tx = tx.bfloat16()
        jx = jnp.asarray(tx.float().numpy()).astype(jnp.bfloat16)
    want = np.asarray(fused_leaky_relu_pallas(jx, jnp.asarray(b)), np.float32)
    got = fused_act_cuda.fused_leaky_relu_cuda_reference(tx, tb)
    assert got.dtype == tx.dtype and got.shape == want.shape
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    else:
        assert np.all(np.abs(got.float().numpy() - want) <= 2 * BF16_STEP * np.abs(want))


def test_fused_leaky_relu_wrapper_cpu_and_refusals(rng):
    """A CPU tensor takes the plain version (bitwise) and launches nothing; a
    bias that is not (C,) and a device that is neither CPU nor CUDA raise."""
    x = torch.from_numpy(rng.standard_normal((2, 3, 4, 6)).astype(np.float32)).bfloat16()
    b = torch.from_numpy(rng.standard_normal((6,)).astype(np.float32))
    before = fused_act_cuda.fused_leaky_relu_cuda.launches
    assert torch.equal(fused_act_cuda.fused_leaky_relu_cuda(x, b),
                       fused_act_cuda.fused_leaky_relu_cuda_reference(x, b))
    assert fused_act_cuda.fused_leaky_relu_cuda.launches == before
    with pytest.raises(ValueError, match="bias must be"):
        fused_act_cuda.fused_leaky_relu_cuda(x, b[:5])
    with pytest.raises(ValueError, match="unsupported device"):
        fused_act_cuda.fused_leaky_relu_cuda(torch.empty((2, 6), device="meta"),
                                             torch.empty((6,), device="meta"))
