"""The 1024px training mode (``corr_blockwise``, ``unbatch_passes``,
``remat_nets="all"``, ``remat_taps``, ``remat_blocks``) at NARROW, crop 64,
float32 on the CPU: the D step's, the R1 penalty's and the G step's losses
and gradients against ppst_tpu with the same knobs, the knobs' own
invariants in the port, and the kernel launches the card's 1024px training
phase asserts (counted here on the plain versions).

ppst_tpu runs with the same knobs and one row block (``corr_block`` = L =
64, the 8 x 8 grid of crop 64), jitted once, without ``remat``: the same math
without the recompute, as in tests/test_torch_train.py. The port runs one
row block and four (``corr_block=16``), on the batches of seeds 0, 1 and 2.
Every gradient tensor is held to tests/test_torch_train.py's element-wise
bounds, the single block's losses to its 1e-3 and the four blocks' to the
JAX package's multi-block calibration, 2e-4 relative
(tests/test_corr_blockwise.py::test_training_losses_blockwise_match_dense).
The four blocks meet the element-wise bounds too (measured: their worst
normalized L2 distance is 0.068, in G's head2 biases at seed 0, a gradient
at 2e-5 of the norm; elsewhere 0.016 or less), so they are not given that
calibration's looser per-tensor L2 of 5e-2.

The tensors of TIE_REACH may instead be within that normalized L2 of 5e-2:
D's res8 conv2 and every layer before it. Seed 0's batch puts one of that
conv's leaky-ReLU pre-activations within float32 noise of zero; under
``unbatch_passes`` the port's rec images differ from JAX's by 2e-5
(convolutions at batch 1 instead of 3), which flips its slope. The backward
carries the flip to that conv's weights and bias (its bias gradient, a sum
over the layer, 7.6% of its largest element apart, L2 1.4%, cosine 0.9999)
and to every layer before it (about 1% in L2); the layers after it and the
block's skip stay within 1e-5. Every other tensor at every seed is held
to the element-wise bounds.
"""

import jax
import numpy as np
import pytest
import torch
from test_torch_train_common import (NARROW, assert_grads, assert_losses, batch, jax_references,
                                     port_step)

from ppst_tpu_torch.models.config import PPSTConfig
from ppst_tpu_torch.models.generator import make_fixed_noise
from ppst_tpu_torch.models.ppst import KernelRecomputeCounter, PPSTModel
from ppst_tpu_torch.ops import tap_cuda
from ppst_tpu_torch.train.steps import TrainSteps, make_optimizers

KNOBS = dict(corr_blockwise=True, unbatch_passes=True, remat=True, remat_nets="all",
             remat_taps=True, remat_blocks=True)
MULTI_LOSS_RTOL, TIE_L2 = 2e-4, 5e-2
SEEDS = (0, 1, 2)
# the D tensors the backward of seed 0's leaky-ReLU tie reaches (see above)
TIE_REACH = tuple(f"['D']['core']['{k}']" for k in (
    "from_rgb", "res64", "res32", "res16", "res8']['conv1", "res8']['conv2"))


@pytest.fixture(scope="module")
def setup():
    models = {block: PPSTModel(PPSTConfig(**NARROW, **KNOBS, corr_block=block), device="cpu")
              for block in (64, 16)}
    batches = {seed: batch(seed) for seed in SEEDS}
    jax_kw = dict(KNOBS, corr_block=64, remat=False)
    want = jax_references(models[64], list(batches.values()), **jax_kw)
    return models, batches, dict(zip(SEEDS, want))


@pytest.mark.parametrize("block", [64, 16], ids=["single_block", "multi_block"])
@pytest.mark.parametrize("kind", ["d", "r1", "g"])
@pytest.mark.parametrize("seed", SEEDS)
def test_step_losses_and_grads_match_jax(setup, seed, kind, block):
    """Every loss key of the D step (unbatched passes, D checkpointed), the R1
    penalty and the G step (blockwise correspondences, nested remat), and
    the gradients of their sums for every parameter tensor."""
    models, batches, want = setup
    losses, grads, _ = port_step(models[block], kind, *batches[seed])
    assert_losses(losses, want[seed][kind][0], **({} if block == 64 else
                                                   {"rtol": MULTI_LOSS_RTOL}))
    assert_grads(grads, want[seed][kind][1], l2_prefixes=TIE_REACH, l2_bound=TIE_L2)


@pytest.mark.parametrize("seed", SEEDS)
def test_memory_knobs_keep_losses_and_gradients(seed):
    """remat_taps, remat_blocks, remat_nets="all" and unbatch_passes only
    recompute or split, on one set of weights with corr_blockwise on: the G
    step's losses and gradients are bitwise those without them; the D
    step's agree to rounding: its rec and mix come from G passes at other
    batch sizes, 2e-5 apart, which moves D's gradients by up to 1.5e-4 of a
    tensor's largest element (measured; bound 1e-3), or, in TIE_REACH, by
    a normalized L2 of TIE_L2 (seed 0's tie flips: 0.9-1.6% measured)."""
    real, mask = batch(seed)
    base_kw = dict(NARROW, corr_blockwise=True, corr_block=16)
    runs = []
    for kw in (base_kw, dict(base_kw, **KNOBS)):
        model = PPSTModel(PPSTConfig(**kw), device="cpu")
        runs.append({kind: port_step(model, kind, real, mask)[:2] for kind in ("d", "g")})
    (base, knobs) = runs
    assert base["g"][0] == knobs["g"][0]
    flat = [dict(jax.tree_util.tree_flatten_with_path(r["g"][1])[0]) for r in runs]
    assert all(np.array_equal(flat[0][k], flat[1][k]) for k in flat[0])
    for k, v in base["d"][0].items():
        assert abs(knobs["d"][0][k] - v) <= 1e-5 * abs(v), k
    for (path, a), b in zip(jax.tree_util.tree_flatten_with_path(base["d"][1])[0],
                            jax.tree.leaves(knobs["d"][1])):
        name = jax.tree_util.keystr(path)
        l2 = np.linalg.norm(a - b) / np.linalg.norm(a)
        assert np.abs(a - b).max() <= 1e-3 * np.abs(a).max() or (
            name.startswith(TIE_REACH) and l2 <= TIE_L2), (name, l2)


def test_remat_blocks_refuses_generator_drawn_noise():
    """Under grad a checkpointed block would draw its noise again from an
    explicit torch.Generator in the recompute: the generator refuses, and
    takes pinned noise (as the training passes give it) or no grad."""
    cfg = PPSTConfig(**NARROW, remat_blocks=True)
    model = PPSTModel(cfg, device="cpu")
    sp = torch.randn((2, 8, 8, cfg.spatial_code_ch))
    gl = [torch.randn((2, cfg.style_dim)) for _ in range(4)]
    with pytest.raises(ValueError, match="noise"):
        model.G(sp, gl, generator=torch.Generator().manual_seed(0))
    noises = make_fixed_noise(cfg, torch.Generator().manual_seed(0), 2, 64)
    model.G(sp, gl, noises=noises).sum().backward()
    with torch.no_grad():
        model.G(sp, gl, generator=torch.Generator().manual_seed(0))


SAVE_KERNELS = dict(remat=True, remat_nets="all", unbatch_passes=True, remat_save_kernels=True)


@pytest.mark.parametrize("kind", ["d", "g"])
def test_remat_save_kernels_is_bit_exact(kind):
    """remat_save_kernels keeps the prepared kernels across the checkpointed
    passes (every pass, D's too: remat_nets="all", unbatch_passes) instead of
    preparing them again in the recompute: a D or G step through
    ``TrainSteps`` gives the losses and post-step parameters of the same step
    with the knob off, bit for bit."""
    real, mask = batch(1)
    runs = []
    for knob in (False, True):
        model = PPSTModel(PPSTConfig(**NARROW, **dict(SAVE_KERNELS, remat_save_kernels=knob)),
                          device="cpu")
        steps = TrainSteps(model, make_optimizers(model))
        step = steps.d_step if kind == "d" else steps.g_step
        losses = step(torch.from_numpy(real), torch.from_numpy(mask),
                      torch.Generator().manual_seed(0))
        runs.append(({k: v.item() for k, v in losses.items()},
                     {k: v.clone() for k, v in model.state_dict().items()}))
    (off_losses, off_params), (on_losses, on_params) = runs
    assert on_losses == off_losses and len(on_losses) > 3
    for k, v in off_params.items():
        assert torch.equal(on_params[k], v), k
    init = PPSTModel(PPSTConfig(**NARROW), device="cpu").state_dict()
    assert any(not torch.equal(v, init[k]) for k, v in on_params.items())  # the step moved


@pytest.mark.parametrize("kind", ["d", "g"])
def test_remat_save_kernels_keeps_the_prepared_kernels(kind):
    """With the knob on, the backward's recompute prepares no kernel again
    (it takes the kept ones); with it off, it prepares them again: the
    operations of ``saveable_kernel()`` that a D or G step's backward runs,
    counted by ``KernelRecomputeCounter``."""
    real, mask = batch(1)
    counts = {}
    for knob in (False, True):
        model = PPSTModel(PPSTConfig(**NARROW, **dict(SAVE_KERNELS, remat_save_kernels=knob)),
                          device="cpu")
        steps = TrainSteps(model, make_optimizers(model))
        step = steps.d_step if kind == "d" else steps.g_step
        with KernelRecomputeCounter() as counter:
            step(torch.from_numpy(real), torch.from_numpy(mask), torch.Generator().manual_seed(0))
        counts[knob] = counter.count
    assert counts[True] == 0 and counts[False] > 0, counts


@pytest.fixture(scope="module")
def save_kernels_setup():
    model = PPSTModel(PPSTConfig(**NARROW, **SAVE_KERNELS), device="cpu")
    real, mask = batch(1)
    (want,) = jax_references(model, [(real, mask)], kinds=("d", "g"), **SAVE_KERNELS)
    return model, real, mask, want


@pytest.mark.parametrize("kind", ["d", "g"])
def test_remat_save_kernels_matches_jax(save_kernels_setup, kind):
    """The D and G steps' losses and gradients with remat_save_kernels on
    against ppst_tpu's with the same knobs (its save_only_these_names
    policy), within tests/test_torch_train.py's bounds."""
    model, real, mask, want = save_kernels_setup
    losses, grads, _ = port_step(model, kind, real, mask)
    assert_losses(losses, want[kind][0])
    assert_grads(grads, want[kind][1], l2_prefixes=TIE_REACH, l2_bound=TIE_L2)


@pytest.mark.parametrize("knobs,k1_per_g", [(KNOBS, 3), (dict(corr_blockwise=True), 2)],
                         ids=["1024px_mode", "blockwise_alone"])
def test_fused_tap_launch_counts(monkeypatch, knobs, k1_per_g):
    """The fused tap's forward (K1) and backward (K2) calls of a D, D+R1 and
    G step in bf16, counted on their plain versions: the counts chip_smoke.py
    asserts in its 1024px training phase. K1 once in a D step (the feature
    pass, without grad), and in a G step once in g_ext's forward, once in its
    remat recompute and, with remat_taps, once more in the tap's own
    recompute inside that; K2 once a G step."""
    counts = {"k1": 0, "k2": 0}
    fwd, bwd = tap_cuda._forward_reference, tap_cuda.fused_tap_1x1_bwd_reference

    def spy_fwd(*a):
        counts["k1"] += 1
        return fwd(*a)

    def spy_bwd(*a, **k):
        counts["k2"] += 1
        return bwd(*a, **k)

    monkeypatch.setattr(tap_cuda, "_forward_reference", spy_fwd)
    monkeypatch.setattr(tap_cuda, "fused_tap_1x1_bwd_reference", spy_bwd)
    model = PPSTModel(PPSTConfig(**NARROW, dtype="bfloat16", fused_tap=True, **knobs),
                      device="cpu")
    steps = TrainSteps(model)
    real, mask = (torch.from_numpy(v) for v in batch(0))
    got = {}
    for name, step in (("d", steps.d_step), ("r1", steps.d_step_r1), ("g", steps.g_step)):
        counts.update(k1=0, k2=0)
        losses = step(real, mask, torch.Generator().manual_seed(0))
        assert all(torch.isfinite(v).all() for v in losses.values()), (name, losses)
        got[name] = (counts["k1"], counts["k2"])
    assert got == {"d": (1, 0), "r1": (1, 0), "g": (k1_per_g, 1)}
