"""The port's training trajectory against ppst_tpu's over many steps, at
NARROW in float32 on the CPU.

Both sides start from the same weights (the port's seed-0 draw carried to
JAX, the LPIPS weights and the RSCL state with them) and take the same
batches (``tools.stream.make_batch``, the JAX tools' draws) for STEPS
alternating D/G steps: the port through its training loop's
``PPSTOptimizer`` (``tools.stream.drive``, schedule "alternate"), ppst_tpu
through ``build_train_steps`` in the loop of ``tools/loss_curve_parity.py``
(D on even steps, the lazy R1 penalty at every ``R1_once_every``-th D step).
Stage 2, with RSCL, the mask warp and the seeded LPIPS cycle warp;
``netG_use_noise`` off, as in JAX's tool (noise streams cannot match across
frameworks; the head blocks keep their noise in both packages, and their
gains leave 0 after the first G step). ``R1_once_every`` is 2, so 2 of the 4
D steps take R1, and the RSCL queues are cut to QUEUE keys, which both
packages read from the state they are given, so the ring pointers (6 keys a
G step) wrap 3 times.

The free runs agree at the first D and G steps and then drift apart as far
as the port drifts from itself when its weights are scaled by 1 + 1e-6 N(0,
1) (``python tests/test_torch_trajectory.py --perturb 1e-6``): Adam with
beta1 = 0 moves every weight by about lr a step whatever its gradient's
size, and the correspondence softmax at T = 0.01 turns small differences
into other matches. So the free runs are held to drift bounds, and to what
the drift leaves alone: the R1 steps, the ring pointers, and how far each
network moved. Then both packages take one more D step and one G step from
the port's state at the end of its run (weights, the four Adams' moments
and counts, the RSCL queues), which holds each update to JAX's closely:
D's Adam at ``lr * c`` and ``betas ** c`` with their bias corrections at
that count, and Adam's moments after several steps. The noise gains are set
to 0 for those two steps on both sides, and their own updates left out.

``python tests/test_torch_trajectory.py [SEED ...] [--perturb X]`` prints
the readings the bounds below were set from.
"""

import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from test_torch_train_common import LOSS_RTOL, NARROW, assert_losses, jax_lpips, jax_state

from ppst_tpu.models.config import PPSTConfig as JaxConfig
from ppst_tpu.models.ppst import PPSTModel as JaxModel
from ppst_tpu.train.steps import build_train_steps
from ppst_tpu.util.convert_torch import convert_reference_state_dict
from ppst_tpu_torch.models.config import PPSTConfig
from ppst_tpu_torch.models.ppst import PPSTModel
from ppst_tpu_torch.tools import loss_curve_parity
from ppst_tpu_torch.tools.stream import drive, make_batch
from ppst_tpu_torch.train.steps import TrainSteps

STEPS = 8
BATCH = 2
QUEUE = 7
CFG = dict(NARROW, R1_once_every=2, netG_use_noise=False, remat=False)
NETS = ("E1", "E2", "G", "D")
CROP = NARROW["crop_size"]


def new_model():
    model = PPSTModel(PPSTConfig(**CFG), device="cpu", seed=0)
    model.set_rscl_state({"queues": model.rscl_queues[..., :QUEUE].clone(),
                          "ptrs": model.rscl_ptrs.clone()})
    return model


# Bounds, each >= 3x the largest reading over stream seeds 0, 1 and 2 (in
# brackets; the port against itself scaled by 1 + 1e-6 N(0, 1), seed 0, in
# braces). The first D and G steps (steps 0 and 1) at LOSS_RTOL [1.2e-4]
# {2.6e-5}. Every later step's loss: |port - JAX| <= STEP_DRIFT * max(|JAX|,
# STEP_FLOOR) [0.083] {0.066}.
STEP_DRIFT, STEP_FLOOR = 0.25, 0.1
# Each network's last weights: ||port - JAX|| / ||JAX|| over all its tensors
# [E1 8.4e-4, E2 7.8e-4, G 2.3e-3, D 2.1e-4] {8.5e-4, 6.7e-4, 2.2e-3, 2.3e-4}.
WEIGHT_L2 = {"E1": 2.6e-3, "E2": 2.4e-3, "G": 7e-3, "D": 7e-4}
# How far each network moved, ||last - first||, the port's over JAX's: within
# 1 +- MOVE_RATIO [E1 0.022, E2 0.041, G 0.016, D 0.0069] {0.019, 0.021,
# 0.014, 0.0040}.
MOVE_RATIO = {"E1": 0.07, "E2": 0.125, "G": 0.05, "D": 0.021}
# The last RSCL queues: ||port - JAX|| / ||JAX|| [0.31] {0.22}: the keys of
# networks that drifted.
QUEUE_L2 = 1.0
# The step from the port's last state: each network's update ||port - JAX|| /
# ||JAX|| [D 7.3e-3 (1.8e-5 at seeds 0 and 2), G 0.051, E1 0.018, E2 3.5e-3]
# (the G step's gradients route through max-pools and kinks whose choices
# flip between the frameworks, as in test_torch_train_common's GRAD_*), and
# its Adam's second moments [2.5e-4].
UPDATE_L2 = {"D": 0.022, "G": 0.155, "E1": 0.053, "E2": 0.0105}
MOMENT_L2 = 7.5e-4


class _NoNoise(dict):
    """The port's state dict without the upsampling blocks' noise gains
    (``netG_use_noise`` off): ``convert_torch``, written for the reference's
    checkpoints, reads NaN for each, and ``tree`` drops them again."""

    def __missing__(self, key):
        if key.endswith("noise.weight"):
            return np.full(1, np.nan, np.float32)
        raise KeyError(key)


def _drop_missing_noise(tree):
    if isinstance(tree, dict):
        return {k: _drop_missing_noise(v) for k, v in tree.items()
                if not (k == "noise" and np.isnan(v["weight"]).all())}
    return tree


def tree(model, values=None):
    """A copy of the port's E1/E2/G/D as ppst_tpu param trees (numpy); with
    ``values`` (parameter -> tensor), those tensors in the parameters' places."""
    sd = {k: v.detach().cpu().numpy().copy() for k, v in model.state_dict().items()}
    if values is not None:
        sd.update({k: values[p].detach().cpu().numpy().copy()
                   for k, p in model.named_parameters()})
    return _drop_missing_noise(convert_reference_state_dict(_NoNoise(sd), crop_size=CROP))


def jax_opt_states(model, opts):
    """The port's four Adams' states as ppst_tpu's optax states."""
    moments = {which: tree(model, {p: opts[net].state[p][which] for net in NETS
                                   for p in getattr(model, net).parameters()})
               for which in ("exp_avg", "exp_avg_sq")}
    out = {}
    for net in NETS:
        counts = {int(opts[net].state[p]["step"]) for p in getattr(model, net).parameters()}
        assert len(counts) == 1, (net, counts)
        out[net] = (optax.ScaleByAdamState(
            count=jnp.asarray(counts.pop(), jnp.int32),
            mu=jax.tree.map(jnp.asarray, moments["exp_avg"][net]),
            nu=jax.tree.map(jnp.asarray, moments["exp_avg_sq"][net])), optax.EmptyState())
    return out


def jax_steps(lpips):
    jmodel = JaxModel(JaxConfig(**CFG), lpips_variables=lpips)
    return build_train_steps(jmodel, donate=False)


def jax_trajectory(fns, params, state, seed):
    """ppst_tpu's rows, last params and last state over STEPS alternating
    steps from ``params`` and ``state`` (ppst_tpu's trees)."""
    init_opt, d_step, d_step_r1, g_step = fns
    params = jax.tree.map(jnp.asarray, params)
    opt_states = init_opt(params)
    rng = np.random.default_rng(seed)
    rows, n_d = [], 0
    for step in range(STEPS):
        real, mask = (jnp.asarray(v) for v in make_batch(rng, BATCH, CROP))
        if step % 2 == 0:
            n_d += 1
            fn = d_step_r1 if n_d % CFG["R1_once_every"] == 0 else d_step
        else:
            fn = g_step
        params, state, opt_states, losses = fn(params, state, opt_states, real, mask,
                                               jax.random.PRNGKey(100 + step))
        rows.append(dict(step=step, **{k: float(v) for k, v in losses.items()}))
    return rows, params, state


def _without_noise(tree):
    if isinstance(tree, dict):
        return {k: _without_noise(v) for k, v in tree.items() if k != "noise"}
    return tree


def forced_steps(model, steps, fns, seed):
    """A D step, then a G step, of both packages from the port's state:
    each step's losses (port, JAX), its update of the networks it trains,
    the port's and JAX's new Adam states, and (G) the new RSCL states."""
    _, d_step, _, g_step = fns
    rng = np.random.default_rng(1000 + seed)
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():  # the head blocks' noise out of both steps
        for name, p in model.named_parameters():
            if name.endswith("noise.weight"):
                p.zero_()
    out = {}
    for kind, nets, port_fn, jax_fn in (("d", ("D",), steps.d_step, d_step),
                                         ("g", ("G", "E1", "E2"), steps.g_step, g_step)):
        real, mask = make_batch(rng, BATCH, CROP)
        before = tree(model)
        params, state, opt_states, losses = jax_fn(
            jax.tree.map(jnp.asarray, before), jax_state(model), jax_opt_states(model, steps.opts),
            jnp.asarray(real), jnp.asarray(mask), jax.random.PRNGKey(0))
        got = port_fn(torch.from_numpy(real), torch.from_numpy(mask), gen)
        after, opts = tree(model), jax_opt_states(model, steps.opts)
        out[kind] = {
            "losses": ({k: v.item() for k, v in got.items()},
                       {k: float(v) for k, v in losses.items()}),
            # the noise gains' own updates follow the draws, which differ
            "update": {n: (_without_noise(jax.tree.map(np.subtract, after[n], before[n])),
                           _without_noise(jax.tree.map(np.subtract, params[n], before[n])))
                       for n in nets},
            "opt": {n: (_without_noise(opts[n][0].nu), _without_noise(opt_states[n][0].nu),
                        int(opts[n][0].count), int(opt_states[n][0].count)) for n in nets},
            "rscl": (model.rscl_state(), state["rscl"])}
    return out


def trajectories(seed, perturb=0.0):
    """Both sides' rows, weights (ppst_tpu trees: the first, the port's last
    and JAX's last), RSCL states and the forced steps. ``perturb``: the
    port's weights scaled by 1 + perturb * N(0, 1) after JAX took them."""
    model = new_model()
    init, lpips, state = tree(model), jax_lpips(model.lpips), jax_state(model)
    if perturb:
        g = torch.Generator().manual_seed(1)
        with torch.no_grad():
            for p in model.parameters():
                p.mul_(1 + perturb * torch.randn(p.shape, generator=g))
    steps = TrainSteps(model)
    got = drive(steps, STEPS, BATCH, CROP, seed, "alternate", log_every=0)
    fns = jax_steps(lpips)
    want_rows, want_params, want_state = jax_trajectory(fns, init, state, seed)
    out = {"rows": (got.rows, want_rows), "params": (tree(model), want_params), "init": init,
           "rscl": (model.rscl_state(), want_state["rscl"])}
    out["forced"] = forced_steps(model, steps, fns, seed)
    return out


def rel_l2(got, want):
    """||got - want|| / ||want|| over every leaf of two trees of one structure."""
    g = [np.asarray(x, np.float64).ravel() for x in jax.tree.leaves(got)]
    w = [np.asarray(x, np.float64).ravel() for x in jax.tree.leaves(want)]
    assert [x.shape for x in g] == [x.shape for x in w]
    g, w = np.concatenate(g), np.concatenate(w)
    return float(np.linalg.norm(g - w) / np.linalg.norm(w))


def step_gap(got, want):
    """max over the row's losses of |got - want| / max(|want|, STEP_FLOOR)."""
    assert set(got) == set(want), (sorted(got), sorted(want))
    return max(abs(got[k] - want[k]) / max(abs(want[k]), STEP_FLOOR) for k in want if k != "step")


def readings(run):
    """Every quantity the bounds hold, by name."""
    got, want = run["rows"]
    out = {"first_steps": max(step_gap(g, w) for g, w in zip(got[:2], want[:2])),
           "later_steps": max(step_gap(g, w) for g, w in zip(got[2:], want[2:])),
           "queues": rel_l2(run["rscl"][0]["queues"].numpy(), run["rscl"][1]["queues"])}
    for net in NETS:
        last, want_last, first = run["params"][0][net], run["params"][1][net], run["init"][net]
        out[f"weights {net}"] = rel_l2(last, want_last)
        out[f"moved {net}"] = rel_l2(last, first) / rel_l2(want_last, first) - 1
    for kind, forced in run["forced"].items():
        for net, (u_got, u_want) in forced["update"].items():
            out[f"update {kind} {net}"] = rel_l2(u_got, u_want)
        for net, (nu_got, nu_want, _, _) in forced["opt"].items():
            out[f"nu {kind} {net}"] = rel_l2(nu_got, nu_want)
        out[f"losses {kind}"] = step_gap(*forced["losses"])
    return out


@pytest.fixture(scope="module")
def run():
    return trajectories(seed=0)


def test_schedule_takes_lazy_r1_and_wraps_the_ring(run):
    """The same steps on both sides: D on even steps, R1 in the 2nd and 4th
    D steps; the ring pointers wrapped (4 G steps x 6 keys > 3 x QUEUE)
    and equal."""
    got, want = run["rows"]
    r1 = [r["step"] for r in want if "D_R1" in r]
    assert r1 == [2, 6]
    assert [r["step"] for r in got if "D_R1" in r] == r1
    assert all(("G_L1" in r) == (r["step"] % 2 == 1) for r in got)
    ptrs, want_ptrs = run["rscl"][0]["ptrs"].numpy(), np.asarray(run["rscl"][1]["ptrs"])
    np.testing.assert_array_equal(ptrs, want_ptrs)
    np.testing.assert_array_equal(ptrs, np.full(4, (STEPS // 2) * 6 % QUEUE))
    assert (STEPS // 2) * 6 > 3 * QUEUE


@pytest.mark.parametrize("step", [0, 1])
def test_first_steps_match(run, step):
    got, want = (rows[step] for rows in run["rows"])
    assert_losses({k: v for k, v in got.items() if k != "step"},
                  {k: v for k, v in want.items() if k != "step"}, rtol=LOSS_RTOL)


def test_later_steps_within_drift(run):
    got, want = run["rows"]
    gaps = [step_gap(g, w) for g, w in zip(got[2:], want[2:])]
    assert max(gaps) <= STEP_DRIFT, [round(x, 4) for x in gaps]


@pytest.mark.parametrize("net", NETS)
def test_last_weights_within_drift(run, net):
    assert rel_l2(run["params"][0][net], run["params"][1][net]) <= WEIGHT_L2[net]


@pytest.mark.parametrize("net", NETS)
def test_networks_moved_as_far(run, net):
    """Adam moves each weight by about lr a step, whichever way: the
    distance each network travelled agrees where the path does not."""
    last, want_last, first = run["params"][0][net], run["params"][1][net], run["init"][net]
    assert abs(rel_l2(last, first) / rel_l2(want_last, first) - 1) <= MOVE_RATIO[net]


def test_last_rscl_queues_within_drift(run):
    got, want = run["rscl"]
    assert rel_l2(got["queues"].numpy(), want["queues"]) <= QUEUE_L2


def test_ema_summary_of_the_two_sides(run):
    """loss_curve_parity's summary of the two trajectories: the same first
    EMA values of the losses of steps 0 and 1, and every EMA gap within the
    drift bound's scale."""
    got, want = run["rows"]
    summary = loss_curve_parity.compare(want, got)
    assert set(summary) == set(loss_curve_parity.KEYS)
    for k, v in summary.items():
        if k in got[0] or k in got[1]:  # from the steps before the drift
            assert v["port_first"] == pytest.approx(v["ref_first"], rel=LOSS_RTOL), k
        assert v["max_abs_ema_gap"] <= STEP_DRIFT * max(abs(v["ref_last"]), STEP_FLOOR), (k, v)


@pytest.mark.parametrize("kind", ["d", "g"])
def test_step_from_the_ports_state_matches(run, kind):
    """One more step from the port's last state on both sides: the losses
    at LOSS_RTOL; each trained network's update and its Adam's second
    moments close to JAX's; the Adam counts equal (D: 4 steps and 2 R1
    updates, then this one); after the G step the RSCL state."""
    forced = run["forced"][kind]
    assert_losses(*forced["losses"])
    for net, (got, want) in forced["update"].items():
        assert rel_l2(got, want) <= UPDATE_L2[net], net
    for net, (nu_got, nu_want, count, want_count) in forced["opt"].items():
        assert count == want_count == (7 if net == "D" else 5), net
        assert rel_l2(nu_got, nu_want) <= MOMENT_L2, net
    if kind == "g":
        got, want = forced["rscl"]
        np.testing.assert_array_equal(got["ptrs"].numpy(), np.asarray(want["ptrs"]))
        assert rel_l2(got["queues"].numpy(), want["queues"]) <= 1e-4


if __name__ == "__main__":
    args = sys.argv[1:]
    import conftest  # noqa: F401  (JAX on the CPU, the compile cache)

    perturb = 0.0
    if "--perturb" in args:
        i = args.index("--perturb")
        perturb = float(args[i + 1])
        del args[i:i + 2]
    for s in [int(a) for a in args] or [0, 1, 2]:
        print(f"seed {s} perturb {perturb}:",
              {k: float(f"{v:.3e}") for k, v in readings(trajectories(s, perturb)).items()},
              flush=True)
