"""LPIPS perceptual distance with the AlexNet backbone (counterpart of
``ppst_tpu/ops/lpips.py``; the reference uses ``lpips.LPIPS(net='alex')``,
models/ppst_model.py:48, to regularize the cycle warp).

Input scaled by the LPIPS shift/scale constants -> AlexNet feature stack (5
ReLU taps) -> unit-normalize each tap over channels -> non-negative 1x1
linear head per tap -> spatial mean -> sum over taps. It runs in float32
whatever the images' dtype, as the JAX package's does.

Parameters carry the ``lpips`` package's key names (``net.slice<k>.<i>.weight``,
``lin<k>.model.1.weight``), so that package's state dict loads as it is
(``load_torch_lpips``). Without one the backbone is drawn from a seeded
``torch.Generator``: a random-feature perceptual loss, NOT numerically
LPIPS, as in the JAX package, which has no pretrained weights either.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

# (kernel, stride, pad, out_channels) of the AlexNet feature stack, and the
# torchvision index of each conv inside its lpips slice
_ALEX = [(11, 4, 2, 64), (5, 1, 2, 192), (3, 1, 1, 384), (3, 1, 1, 256), (3, 1, 1, 256)]
_TV_INDEX = [0, 3, 6, 8, 10]
_POOL_AFTER = {0, 1}  # 3x3 / 2 max-pools between the first three taps
_SHIFT = (-0.030, -0.088, -0.188)
_SCALE = (0.458, 0.448, 0.450)


class LPIPS(nn.Module):
    def __init__(self, seed: int = 1234):
        super().__init__()
        self.net = nn.Module()
        in_ch = 3
        for i, (k, s, p, c) in enumerate(_ALEX):
            conv = nn.Conv2d(in_ch, c, k, stride=s, padding=p)
            self.net.add_module(f"slice{i + 1}", nn.Sequential())
            getattr(self.net, f"slice{i + 1}").add_module(str(_TV_INDEX[i]), conv)
            # index 0 is the package's dropout; the JAX package runs none
            self.add_module(f"lin{i}", nn.Module())
            getattr(self, f"lin{i}").model = nn.Sequential(
                nn.Identity(), nn.Conv2d(c, 1, 1, bias=False))
            in_ch = c
        self.register_buffer("shift", torch.tensor(_SHIFT), persistent=False)
        self.register_buffer("scale", torch.tensor(_SCALE), persistent=False)
        gen = torch.Generator().manual_seed(seed)
        with torch.no_grad():
            for i, (k, _, _, c) in enumerate(_ALEX):
                conv = self._conv(i)
                fan_in = conv.in_channels * k * k
                conv.weight.normal_(0.0, 1.0 / math.sqrt(fan_in), generator=gen)
                conv.bias.zero_()
                self._lin(i).fill_(1.0 / c)
        self.requires_grad_(False)

    def _conv(self, i):
        return getattr(getattr(self.net, f"slice{i + 1}"), str(_TV_INDEX[i]))

    def _lin(self, i):
        return getattr(self, f"lin{i}").model[1].weight

    def _features(self, x):
        y = ((x.float() - self.shift) / self.scale).permute(0, 3, 1, 2)
        taps = []
        for i in range(len(_ALEX)):
            y = F.relu(self._conv(i)(y))
            taps.append(y)
            if i in _POOL_AFTER:
                y = F.max_pool2d(y, 3, stride=2)
        return taps

    def forward(self, a, b):
        """NHWC images in [-1, 1] -> (B,) distances."""
        total = 0.0
        for i, (xa, xb) in enumerate(zip(self._features(a), self._features(b))):
            na = xa / torch.sqrt((xa * xa).sum(1, keepdim=True) + 1e-10)
            nb = xb / torch.sqrt((xb * xb).sum(1, keepdim=True) + 1e-10)
            w = F.relu(self._lin(i).reshape(1, -1, 1, 1))
            total = total + ((na - nb) ** 2 * w).sum(1).mean((1, 2))
        return total


def load_torch_lpips(module: LPIPS, path: str):
    """Load an ``lpips`` package state dict (``torch.save(lpips.LPIPS(
    net='alex').state_dict(), path)``): its backbone and linear heads."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    own = module.state_dict()
    missing = [k for k in own if k not in sd]
    if missing:
        raise KeyError(f"{path} lacks {len(missing)} LPIPS keys, e.g. {missing[:3]}")
    module.load_state_dict({k: sd[k] for k in own})
    return module
