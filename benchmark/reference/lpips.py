"""LPIPS perceptual distance with the AlexNet backbone (a frozen copy of the
port's ``ppst_tpu_torch/ops/lpips.py`` at commit afeb803, whose weights the
benchmark draws and loads, as ``init_rules`` says; the reference uses
``lpips.LPIPS(net='alex')``, models/ppst_model.py:48, to regularize the cycle
warp).

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
    def __init__(self):
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
        self.requires_grad_(False)

    def init_rules(self) -> dict:
        """{parameter name: rule} of the port's seeded draw: each conv
        N(0, 1/fan_in), zero biases, the heads 1/channels."""
        rules = {}
        for i, (k, _, _, c) in enumerate(_ALEX):
            conv = f"net.slice{i + 1}.{_TV_INDEX[i]}"
            fan_in = self._conv(i).in_channels * k * k
            rules[f"{conv}.weight"] = ("normal", 0.0, 1.0 / math.sqrt(fan_in))
            rules[f"{conv}.bias"] = ("const", 0.0)
            rules[f"lin{i}.model.1.weight"] = ("const", 1.0 / c)
        return rules

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
