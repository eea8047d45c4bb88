"""Shared set-up of the port's training tests: the NARROW configuration with
a narrow D, the port's weights carried to ppst_tpu's trees, and the inputs.
The other training test files import these helpers; the tests here check
the helpers themselves.
"""

import jax.numpy as jnp
import numpy as np
import torch

from ppst_tpu.util.convert_torch import convert_reference_state_dict

NARROW = dict(crop_size=64, netE_scale_capacity=0.25, netE2_scale_capacity=0.25,
              global_code_ch=64, spatial_code_ch=16, netG_resnet_ch=32,
              netG_scale_capacity=0.125, netD_scale_capacity=0.125)


def jax_params(model):
    """The port's E1/E2/G/D as ppst_tpu param trees (JAX arrays)."""
    sd = {k: v.detach().cpu().numpy() for k, v in model.state_dict().items()}
    tree = convert_reference_state_dict(sd, crop_size=model.cfg.crop_size)
    return _to_jax(tree)


def _to_jax(tree):
    if isinstance(tree, dict):
        return {k: _to_jax(v) for k, v in tree.items()}
    return jnp.asarray(tree)


def jax_lpips(module):
    """The port's LPIPS weights in ppst_tpu.ops.lpips's layout."""
    params = {"net": {}}
    for i in range(5):
        conv = module._conv(i)
        params["net"][f"conv{i}"] = {
            "kernel": jnp.asarray(conv.weight.detach().cpu().numpy().transpose(2, 3, 1, 0)),
            "bias": jnp.asarray(conv.bias.detach().cpu().numpy())}
        params[f"lin{i}"] = jnp.asarray(module._lin(i).detach().cpu().numpy().reshape(-1))
    return {"params": params}


def jax_state(model):
    return {"rscl": {"queues": jnp.asarray(model.rscl_queues.cpu().numpy()),
                     "ptrs": jnp.asarray(model.rscl_ptrs.cpu().numpy().astype(np.int32))},
            "num_d_iters": jnp.zeros((), jnp.int32)}


def batch(seed=0, b=2, crop=64):
    """Random images in [-1, 1] and blocky one-hot 3-region masks."""
    rng = np.random.default_rng(seed)
    real = rng.uniform(-1, 1, (b, crop, crop, 3)).astype(np.float32)
    region = np.kron(rng.integers(0, 3, (b, crop // 16, crop // 16)),
                     np.ones((1, 16, 16), np.int64))
    mask = np.stack([(region == i) for i in range(3)], -1).astype(np.float32)
    return real, mask


def grad_tree(model, nets):
    """The ``.grad`` of the port's parameters of ``nets`` as ppst_tpu trees
    (zeros where a parameter got none), through the same key conversion."""
    sd = {k: (p.grad if p.grad is not None else torch.zeros_like(p)).detach().cpu().numpy()
          for k, p in model.named_parameters()}
    tree = convert_reference_state_dict(sd, crop_size=model.cfg.crop_size)
    return {k: tree[k] for k in nets}


def test_batch_masks_are_one_hot():
    real, mask = batch()
    assert real.shape == (2, 64, 64, 3) and np.abs(real).max() <= 1
    assert mask.shape == (2, 64, 64, 3) and np.array_equal(mask.sum(-1), np.ones((2, 64, 64)))
    assert all(mask[..., i].any() for i in range(3))


def test_grad_tree_fills_missing_grads_with_zeros():
    from ppst_tpu_torch.models.config import PPSTConfig
    from ppst_tpu_torch.models.ppst import PPSTModel

    model = PPSTModel(PPSTConfig(**NARROW), device="cpu")
    model.D.stylegan2_D.final_linear[1].bias.grad = torch.ones(1)
    tree = grad_tree(model, ("D", "G"))
    assert float(tree["D"]["core"]["fc1"]["bias"][0]) == 1.0
    assert not np.any(tree["G"]["to_rgb"]["conv"]["weight"])
