"""The weight bridge between the two packages (E1, E2, G, D, LPIPS and the
RSCL state), the reference-checkpoint loader, and the rule that the port
imports nothing of JAX."""

import ast
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import torch
from test_torch_train_common import NARROW, jax_lpips, jax_state

from ppst_tpu.models.config import PPSTConfig as JaxConfig
from ppst_tpu.models.discriminator import Discriminator as JaxD
from ppst_tpu.models.encoder_col import ColorEncoder as JaxE2
from ppst_tpu.models.encoder_con import ContentEncoder as JaxE1
from ppst_tpu.models.generator import Generator as JaxG
from ppst_tpu.util.convert_torch import convert_reference_state_dict
from ppst_tpu.util.fast_init import random_params_like
from ppst_tpu_torch.models.config import PPSTConfig
from ppst_tpu_torch.models.ppst import PPSTModel
from ppst_tpu_torch.util.from_flax import from_flax, lpips_from_flax, rscl_from_flax

ROOT = pathlib.Path(__file__).resolve().parent.parent


def _flax_tree():
    """E1/E2/G/D param trees of the structure ``PPSTModel.init`` builds (the
    same module inits with the same arguments), filled with seeded values
    without compiling the init graphs."""
    cfg = JaxConfig(**NARROW)
    k = jax.random.PRNGKey(0)
    x = jnp.zeros((2, 64, 64, 3))
    sp = jnp.zeros((2, 8, 8, cfg.spatial_code_ch))
    gl = [jnp.zeros((2, cfg.style_dim))] * 4

    def init():
        return {
            "E1": JaxE1(cfg).init(k, x)["params"],
            "E2": JaxE2(cfg).init(k, x)["params"],
            "G": JaxG(cfg).init({"params": k, "noise": k}, sp, gl,
                                extract_features=True)["params"],
            "D": JaxD(cfg).init(k, x)["params"],
        }

    return random_params_like(init, scale=1.0, seed=0)


def test_from_flax_round_trip():
    """flax tree -> from_flax -> the port's state_dict -> convert_torch gives
    back every leaf of E1, E2, G and D unchanged."""
    tree = _flax_tree()
    model = PPSTModel(PPSTConfig(**NARROW), device="cpu")
    model.load_state_dict(from_flax(tree))  # strict: same keys, same shapes
    back = convert_reference_state_dict(
        {k: v.numpy() for k, v in model.state_dict().items()}, crop_size=64)
    for net in ("E1", "E2", "G", "D"):
        want = jax.tree_util.tree_flatten_with_path(tree[net])[0]
        got = dict(jax.tree_util.tree_flatten_with_path(back[net])[0])
        assert set(got) == {p for p, _ in want}, net
        for path, leaf in want:
            np.testing.assert_array_equal(np.asarray(got[path]), np.asarray(leaf),
                                          err_msg=f"{net} {path}")


def test_load_reference_checkpoint(tmp_path):
    """A reference .pth with extra members (dead modules, the RSCL queues)
    and biases stored flat loads into the port, D included."""
    src = PPSTModel(PPSTConfig(**NARROW), device="cpu", seed=1)
    sd = {k: (v.reshape(-1) if v.dim() == 4 and v.shape[0] == 1 else v)
          for k, v in src.state_dict().items()}
    sd["E1.mlp_01.weight"] = torch.zeros(1)
    sd["rscl.queue0"] = torch.zeros(1)
    path = tmp_path / "ref.pth"
    torch.save({"state_dict": sd}, path)

    dst = PPSTModel(PPSTConfig(**NARROW), device="cpu", seed=2)
    dst.load_reference_checkpoint(str(path))
    for k, v in src.state_dict().items():
        assert torch.equal(dst.state_dict()[k], v), k


def test_load_reference_checkpoint_without_d(tmp_path):
    """An inference-only file (E1/E2/G) loads and leaves D as drawn."""
    src = PPSTModel(PPSTConfig(**NARROW), device="cpu", seed=1)
    path = tmp_path / "ref.pth"
    torch.save({k: v for k, v in src.state_dict().items() if not k.startswith("D.")}, path)
    dst = PPSTModel(PPSTConfig(**NARROW), device="cpu", seed=2)
    d_before = {k: v.clone() for k, v in dst.D.state_dict().items()}
    dst.load_reference_checkpoint(str(path))
    assert torch.equal(dst.G.ToRGB.conv.weight, src.G.ToRGB.conv.weight)
    for k, v in dst.D.state_dict().items():
        assert torch.equal(v, d_before[k]), k


def test_lpips_and_rscl_bridge():
    """The LPIPS weights and the RSCL state carry from ppst_tpu's layouts to
    the port's unchanged (the inverse of the tests' own carry to JAX)."""
    model = PPSTModel(PPSTConfig(**NARROW), device="cpu")
    sd = lpips_from_flax(jax_lpips(model.lpips))
    assert set(sd) == set(model.lpips.state_dict())
    for k, v in model.lpips.state_dict().items():
        assert torch.equal(sd[k], v), k
    rscl = rscl_from_flax(jax_state(model))
    assert torch.equal(rscl["queues"], model.rscl_queues)
    assert torch.equal(rscl["ptrs"], model.rscl_ptrs)


def _imported_roots(path):
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


def test_port_imports_no_jax():
    files = sorted((ROOT / "ppst_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 10
    scanned = {f.relative_to(ROOT).as_posix() for f in files}
    for sub in ("options", "experiments"):
        assert any(f.startswith(f"ppst_tpu_torch/{sub}/") for f in scanned), sub
    assert {"ppst_tpu_torch/ops/smooth_filter.py", "ppst_tpu_torch/smooth_filter.py"} <= scanned
    assert {f"ppst_tpu_torch/tools/{t}.py" for t in (
        "stream", "bf16_validation", "lpips_ablation", "loss_curve_parity",
        "multiproc_cli_smoke")} <= scanned
    for f in files:
        bad = _imported_roots(f) & {"jax", "jaxlib", "flax", "optax", "msgpack", "ml_dtypes",
                                     "ppst_tpu"}
        assert not bad, f"{f.relative_to(ROOT)} imports {sorted(bad)}"
