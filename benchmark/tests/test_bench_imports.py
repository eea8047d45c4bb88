"""Nothing the benchmark loads is JAX, its libraries or the JAX package,
compared by whole top-level names; the reference loads nothing of the
program either."""

import json
import subprocess
import sys

import pytest

from harness import imports, spec

LOAD_ALL = f"""
import json, sys
sys.path[:0] = [{str(spec.BENCH)!r}, {str(spec.ROOT)!r}]
import harness.main, harness.program, harness.sites, harness.readers, harness.control
from harness import spec
for p in sorted((spec.BENCH / "metrics").glob("*.py")):
    spec.metric_reader(p.stem)
for p in sorted((spec.BENCH / "roofline").glob("*.py")):
    spec.roofline(p.stem)
for p in sorted((spec.BENCH / "drivers").glob("*.py")):
    spec.driver(p.stem)
import count_flops, calibrate
# what the drivers import of the program
import ppst_tpu_torch.models.ppst, ppst_tpu_torch.train.bundle
import ppst_tpu_torch.optimizers.ppst_optimizer, ppst_tpu_torch.ops.tap_cuda
import ppst_tpu_torch.ops.corr_warp_cuda, ppst_tpu_torch.ops.styled_conv_cuda
from harness import sites
for k in ("tap_fwd", "tap_bwd", "corr_warp"):
    sites.remove(sites.install([k]))
print(json.dumps(sorted(sys.modules)))
"""

LOAD_REFERENCE = f"""
import json, sys
sys.path[:0] = [{str(spec.BENCH)!r}]
import pkgutil, importlib, reference
for m in pkgutil.iter_modules(reference.__path__):
    importlib.import_module("reference." + m.name)
print(json.dumps(sorted(sys.modules)))
"""


def _modules(code):
    p = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300,
                       cwd=spec.ROOT)
    assert p.returncode == 0, p.stderr[-3000:]
    return json.loads(p.stdout.strip().splitlines()[-1])


def test_benchmark_and_program_load_no_jax():
    mods = _modules(LOAD_ALL)
    assert "ppst_tpu_torch" in mods
    assert imports.forbidden_loaded(mods) == []


def test_reference_loads_nothing_of_the_program():
    mods = _modules(LOAD_REFERENCE)
    assert not [m for m in mods if m.split(".")[0] in ("ppst_tpu_torch", "ppst_tpu", "jax",
                                                       "jaxlib", "flax", "optax")]


@pytest.mark.parametrize("name, bad", [
    ("jax", True), ("jax.numpy", True), ("jaxlib.xla_client", True), ("flax.linen", True),
    ("optax", True), ("ppst_tpu", True), ("ppst_tpu.models.ppst", True),
    ("ppst_tpu_torch", False), ("ppst_tpu_torch.models.ppst", False), ("jaxtyping", False),
    ("flaxen", False), ("torch", False)])
def test_forbidden_names_are_whole_top_level_names(name, bad):
    assert (imports.forbidden_loaded([name]) == [name]) is bad
