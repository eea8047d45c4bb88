"""The benchmark's own tests, on the CPU: ``python -m pytest benchmark/tests -q``.

Tests marked ``card`` need a CUDA device; they skip here and run on the
card with ``python -m pytest benchmark/tests -q -m card``.
"""

import os
import sys

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
for path in (ROOT, BENCH):
    if path not in sys.path:
        sys.path.insert(0, path)

# the narrow model of the port's CPU tests, D narrowed too
NARROW = dict(crop_size=64, netE_scale_capacity=0.25, netE2_scale_capacity=0.25,
              global_code_ch=64, spatial_code_ch=16, netG_resnet_ch=32, netG_scale_capacity=0.125,
              netD_scale_capacity=0.125)


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA device (skips without one)")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.fixture
def small_cell():
    """A cell of BENCHMARK.json with the narrow model at crop 64 and a small
    traffic pool, for runs on the CPU."""
    from harness import spec

    def make(name, **config):
        cell = spec.cell(name)
        cell.config = dict(cell.config, **NARROW, **config)
        cell.traffic = dict(cell.traffic, pool_batches=4, pool_images=16, warmup_steps=0,
                            warmup_requests=1)
        return cell

    return make
