"""The smoothing filter (``ppst_tpu_torch.ops.smooth_filter`` and the PIL
wrapper ``ppst_tpu_torch.smooth_filter``) against ppst_tpu's on the CPU in
float32, and ppst_tpu's own cases (tests/test_smooth_filter.py) on the
port."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

import smooth_filter as jax_wrapper
from ppst_tpu.ops.smooth_filter import smooth_local_affine as jax_smooth
from ppst_tpu_torch.ops.smooth_filter import _local_affine, smooth_local_affine
from ppst_tpu_torch.smooth_filter import smooth_filter


@pytest.mark.parametrize("f_radius", [3, 15])
def test_smooth_local_affine_matches_jax(rng, f_radius):
    """1 x 32 x 40 x 3 images, f_edge 0.1: within 1e-4."""
    stylized, content = (rng.random((1, 32, 40, 3)).astype(np.float32) for _ in range(2))
    want = np.asarray(jax_smooth(jnp.asarray(stylized), jnp.asarray(content), f_radius=f_radius))
    got = smooth_local_affine(torch.from_numpy(stylized), torch.from_numpy(content),
                              f_radius=f_radius).numpy()
    assert got.shape == want.shape == (1, 32, 40, 3)
    assert np.abs(got - want).max() <= 1e-4


def test_pil_wrapper_matches_jax(rng, tmp_path):
    """Paths in, a PIL image out, the content resized to the output's size:
    within one uint8 step of the JAX package's wrapper."""
    out_path, content_path = tmp_path / "out.png", tmp_path / "content.png"
    Image.fromarray((rng.random((30, 36, 3)) * 255).astype(np.uint8)).save(out_path)
    Image.fromarray((rng.random((40, 50, 3)) * 255).astype(np.uint8)).save(content_path)
    want = np.asarray(jax_wrapper.smooth_filter(str(out_path), str(content_path), f_radius=5))
    got = np.asarray(smooth_filter(str(out_path), str(content_path), f_radius=5, device="cpu"))
    assert got.shape == want.shape == (30, 36, 3) and got.dtype == np.uint8
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the refusal without CUDA")
def test_pil_wrapper_runs_on_cuda_by_default():
    """Like every entry point of the port, the wrapper runs on CUDA unless
    given another device, and raises where there is none."""
    img = Image.new("RGB", (8, 8))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        smooth_filter(img, img, f_radius=2)


def test_identity_affine_recovered(rng):
    """When stylized == content the best local affine is the identity and
    the output reproduces the input."""
    img = torch.from_numpy(rng.random((1, 24, 24, 3)).astype(np.float32))
    out = smooth_local_affine(img, img, f_radius=4)
    np.testing.assert_allclose(out.numpy(), img.numpy(), atol=5e-2)


def test_affine_relation_recovered(rng):
    """stylized = 0.5 * content + 0.2 is an affine map, recovered as such."""
    content = torch.from_numpy(rng.random((1, 20, 20, 3)).astype(np.float32))
    stylized = 0.5 * content + 0.2
    out = smooth_local_affine(stylized, content, f_radius=3)
    np.testing.assert_allclose(out.numpy(), stylized.numpy(), atol=5e-2)


def test_local_affine_shapes(rng):
    content, stylized = (torch.from_numpy(rng.random((2, 16, 16, 3)).astype(np.float32))
                         for _ in range(2))
    a = _local_affine(content, stylized)
    assert a.shape == (2, 16, 16, 3, 4) and torch.isfinite(a).all()
