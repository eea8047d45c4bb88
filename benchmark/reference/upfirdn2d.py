"""upfirdn2d: upsample -> FIR filter -> downsample on NHWC tensors.

Counterpart of ``ppst_tpu/ops/upfirdn2d.py`` (reference
models/networks/stylegan2_op/upfirdn2d.py:162-222, ``upfirdn2d_native``).
Insert ``up-1`` zeros after every input sample, pad by (pad0, pad1) on each
axis (negative pads crop), convolve with the FIR kernel, keep every
``down``-th sample. Output size per axis: ``(in*up + pad0 + pad1 - k) //
down + 1``.

The filter is a depthwise ``F.conv2d``: cuDNN does this work on the card as
XLA did on the TPU, so there is no hand-written kernel here.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def make_kernel(k, gain: float = 1.0) -> np.ndarray:
    """Normalized FIR kernel from a 1-D or 2-D tap list (a 1-D list becomes
    its outer product), scaled by ``gain``."""
    k = np.asarray(k, dtype=np.float32)
    if k.ndim == 1:
        k = np.outer(k, k)
    k = k / k.sum()
    return k * gain


def _depthwise(x_nchw, k2d, stride):
    """Correlate every channel of NCHW ``x`` with the 2-D ``k2d``."""
    c = x_nchw.shape[1]
    w = k2d.to(x_nchw.dtype)[None, None].expand(c, 1, *k2d.shape)
    return F.conv2d(x_nchw, w, stride=stride, groups=c)


def upfirdn2d(x, kernel, up: int = 1, down: int = 1, pad=(0, 0)):
    """Apply upfirdn to NHWC ``x`` with a 1-D (separable) or 2-D kernel."""
    kernel = torch.as_tensor(np.asarray(kernel, np.float32), device=x.device)
    pad0, pad1 = int(pad[0]), int(pad[1])
    y = x.permute(0, 3, 1, 2)
    if up > 1:
        b, c, h, w = y.shape
        z = y.new_zeros(b, c, h * up, w * up)
        z[:, :, ::up, ::up] = y
        y = z
    y = F.pad(y, (pad0, pad1, pad0, pad1))
    # the reference convolves; conv2d correlates, so flip the taps
    kernel = torch.flip(kernel, tuple(range(kernel.ndim)))
    if kernel.ndim == 1:
        y = _depthwise(y, kernel[:, None], (down, 1))
        y = _depthwise(y, kernel[None, :], (1, down))
    else:
        y = _depthwise(y, kernel, (down, down))
    return y.permute(0, 2, 3, 1)


def reflect_pad(x, pad0: int, pad1: int):
    """Reflection-pad the two spatial axes of NHWC ``x``."""
    y = F.pad(x.permute(0, 3, 1, 2), (pad0, pad1, pad0, pad1), mode="reflect")
    return y.permute(0, 2, 3, 1)


def upsample2d(x, kernel, factor: int = 2):
    """Upsample, reference stylegan2_layers.py:39-57."""
    k = np.asarray(kernel, dtype=np.float32)
    assert k.ndim == 1
    p = k.shape[0] - factor
    k1 = k / k.sum() * factor  # sqrt of the reference's factor**2 gain per axis
    return upfirdn2d(x, k1, up=factor, down=1,
                     pad=((p + 1) // 2 + factor - 1, p // 2))


def downsample2d(x, kernel, factor: int = 2, pad=None, reflection_pad: bool = False):
    """Downsample, reference stylegan2_layers.py:60-88."""
    k = np.asarray(kernel, dtype=np.float32)
    assert k.ndim == 1
    p = (k.shape[0] - factor) if pad is None else pad
    pad0, pad1 = (p + 1) // 2, p // 2
    k1 = k / k.sum()
    if reflection_pad:
        return upfirdn2d(reflect_pad(x, pad0, pad1), k1, down=factor)
    return upfirdn2d(x, k1, down=factor, pad=(pad0, pad1))


def blur(x, kernel, pad, upsample_factor: int = 1, reflection_pad: bool = False):
    """Blur, reference stylegan2_layers.py:142-164. ``pad`` is (pad0, pad1)."""
    k = np.asarray(kernel, dtype=np.float32)
    assert k.ndim == 1
    k1 = k / k.sum()
    if upsample_factor > 1:
        k1 = k1 * upsample_factor
    if reflection_pad:
        return upfirdn2d(reflect_pad(x, pad[0], pad[1]), k1)
    return upfirdn2d(x, k1, pad=pad)
