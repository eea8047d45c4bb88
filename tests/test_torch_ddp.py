"""Multi-process training (``ppst_tpu_torch.parallel``) on the CPU: two gloo
ranks take a D step, a D+R1 step and a G step on their halves of a global
batch of 4, at NARROW in float32, and are held to the JAX package's
single-device ``n_dev = 2`` oracle (the ``sim`` run of
``tests/test_mesh_equivalence.py``); a world of one is held to today's
single process, bit for bit.

Each rank is a process of its own, started from this file
(``python tests/test_torch_ddp.py RANK WORLD PORT DIR``), which imports
nothing of JAX when run so; the global batch comes from ``DIR/batch.npz``
and each rank writes ``DIR/rank<r>.pt`` (a world of one also ``alone.pt``,
the same process's steps before it joins a group). The noise gains start at zero, so
neither side's noise draws enter the losses; after the G step the gains'
own updates follow the draws, which differ between the frameworks, so they
are held to the ranks' bitwise agreement and to one Adam step only.
"""

import os
import socket
import subprocess
import sys

import numpy as np
import torch

from ppst_tpu_torch import parallel
from ppst_tpu_torch.models.config import PPSTConfig
from ppst_tpu_torch.models.ppst import PPSTModel
from ppst_tpu_torch.train.bundle import noise_seed
from ppst_tpu_torch.train.steps import TrainSteps

HERE = os.path.dirname(os.path.abspath(__file__))
KINDS = ("d", "r1", "g")
# the width of test_torch_train_common.NARROW (which imports JAX)
NARROW = dict(crop_size=64, netE_scale_capacity=0.25, netE2_scale_capacity=0.25,
              global_code_ch=64, spatial_code_ch=16, netG_resnet_ch=32,
              netG_scale_capacity=0.125, netD_scale_capacity=0.125)


def run_steps(real, mask, rank=0):
    """The D, D+R1 and G steps on this rank's batch from the seed-0 NARROW
    model: each step's losses as the optimizer logs them (averaged over the
    ranks), the state dict after it, and the RSCL state after the last."""
    model = PPSTModel(PPSTConfig(**NARROW), device="cpu")
    parallel.broadcast_module(model)
    steps = TrainSteps(model)
    gen = torch.Generator().manual_seed(noise_seed(0, rank))
    out = {}
    for kind, step in zip(KINDS, (steps.d_step, steps.d_step_r1, steps.g_step)):
        losses = step(torch.from_numpy(real), torch.from_numpy(mask), gen)
        keys = sorted(losses)
        values = parallel.average(torch.stack([losses[k].float() for k in keys]))
        out[kind] = {"losses": dict(zip(keys, values.tolist())),
                     "params": {k: v.clone() for k, v in model.state_dict().items()}}
    out["rscl"] = {k: v.clone() for k, v in model.rscl_state().items()}
    return out


def _worker(rank, world, port, folder):
    """Rank ``rank`` of ``world`` on its slice of ``DIR/batch.npz``; in a world
    of one, first the same steps without a process group (``alone.pt``)."""
    torch.set_num_threads(2)
    data = np.load(os.path.join(folder, "batch.npz"))
    if world == 1:
        torch.save(run_steps(data["real"], data["mask"]), os.path.join(folder, "alone.pt"))
    os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), RANK=str(rank),
                      WORLD_SIZE=str(world), LOCAL_RANK=str(rank))
    assert parallel.init("cpu") == torch.device("cpu")
    assert (parallel.world_size(), parallel.rank()) == (world, rank)
    per = data["real"].shape[0] // world
    rows = slice(rank * per, (rank + 1) * per)
    torch.save(run_steps(data["real"][rows], data["mask"][rows], rank),
               os.path.join(folder, f"rank{rank}.pt"))


def _start(folder, world, real, mask):
    """Start ``world`` rank processes on ``real``/``mask``."""
    np.savez(os.path.join(folder, "batch.npz"), real=real, mask=mask)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = {k: v for k, v in os.environ.items() if k not in ("RANK", "WORLD_SIZE")}
    env["PYTHONPATH"] = os.pathsep.join([os.path.dirname(HERE)] + (
        [env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    return [subprocess.Popen([sys.executable, os.path.abspath(__file__), str(r), str(world),
                              str(port), folder], env=env) for r in range(world)]


def _results(folder, procs, names):
    """Wait for the rank processes; the files ``names`` they wrote."""
    try:
        codes = [p.wait(timeout=300) for p in procs]
    finally:
        for p in procs:
            p.kill()
    assert codes == [0] * len(procs), codes
    return [torch.load(os.path.join(folder, n), weights_only=True) for n in names]


if __name__ == "__main__":
    _worker(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
    sys.exit(0)

import jax  # noqa: E402
import pytest  # noqa: E402
from test_torch_train_common import LOSS_RTOL, assert_losses, batch, jax_lpips, jax_params, jax_state  # noqa: E402,E501

from ppst_tpu.models.config import PPSTConfig as JaxConfig  # noqa: E402
from ppst_tpu.models.ppst import PPSTModel as JaxModel  # noqa: E402
from ppst_tpu.train.steps import build_train_steps  # noqa: E402
from ppst_tpu.util.convert_torch import convert_reference_state_dict  # noqa: E402

LR = 1e-3  # the optimizers' default learning rate (D's is lr * 16/17)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The two ranks' outputs, ppst_tpu's D, D+R1 and G steps with
    ``n_dev=2`` on one device from the port's initial weights (each step's
    losses and parameters), and a world of one with the same process alone.
    The rank processes start first and run while JAX compiles."""
    real, mask = batch(seed=5, b=4)
    folder = str(tmp_path_factory.mktemp("ddp"))
    one_folder = str(tmp_path_factory.mktemp("world1"))
    procs = _start(folder, 2, real, mask)
    one_procs = _start(one_folder, 1, *batch(seed=6, b=2))
    try:
        model = PPSTModel(PPSTConfig(**NARROW), device="cpu")
        jmodel = JaxModel(JaxConfig(**dict(NARROW, remat=False)),
                          lpips_variables=jax_lpips(model.lpips))
        params, state = jax_params(model), jax_state(model)
        init_opt, *fns = build_train_steps(jmodel, n_dev=2, mesh=None, donate=False)
        opt_states = init_opt(params)
        oracle = {}
        for kind, fn, seed in zip(KINDS, fns, (10, 11, 12)):
            params, state, opt_states, losses = fn(params, state, opt_states, real, mask,
                                                   jax.random.PRNGKey(seed))
            oracle[kind] = {"losses": losses, "params": jax.device_get(params)}
        oracle["rscl"] = jax.device_get(state["rscl"])
    finally:
        ranks = _results(folder, procs, ["rank0.pt", "rank1.pt"])
        world1 = _results(one_folder, one_procs, ["rank0.pt", "alone.pt"])
    return ranks, oracle, world1


@pytest.mark.parametrize("kind", KINDS)
def test_ranks_match_the_jax_n_dev_2_oracle(runs, kind):
    """After each step, on both ranks: the logged losses within the training
    tolerance (relative 1e-3), and every parameter tensor as in the oracle
    (``_assert_params_close``)."""
    outs, oracle, _ = runs
    for out in outs:
        want = {k: float(v) for k, v in oracle[kind]["losses"].items()}
        got = out[kind]["losses"]
        assert set(want) <= set(got), (sorted(want), sorted(got))
        assert_losses({k: got[k] for k in want}, want, LOSS_RTOL)
        _assert_params_close(out[kind]["params"], oracle[kind]["params"])


def _assert_params_close(state_dict, want):
    """Each tensor of ``want`` (ppst_tpu's tree) within the element-wise bound
    of ``tests/test_mesh_equivalence.py`` (5e-3 relative, 1e-4 absolute),
    except for Adam's sign flips: beta1 = 0 makes each first update exactly
    ±lr, so a gradient element within float noise of zero, whose sign the two
    frameworks' sums set differently, moves its parameter by up to 2 lr
    (three updates here: 4 lr). Such flips stay below 1e-3 of each network's
    parameters, as there. The noise gains (their update is the sign of the
    noise's gradient, drawn apart) are held to one update."""
    tree = convert_reference_state_dict({k: v.numpy() for k, v in state_dict.items()},
                                        crop_size=NARROW["crop_size"])
    for net in ("E1", "E2", "G", "D"):
        flat_w = jax.tree_util.tree_flatten_with_path(want[net])[0]
        flat_g = dict(jax.tree_util.tree_flatten_with_path(tree[net])[0])
        flips = total = 0
        for path, w in flat_w:
            name = net + jax.tree_util.keystr(path)
            g, w = np.asarray(flat_g[path], np.float64), np.asarray(w, np.float64)
            diff = np.abs(g - w)
            if "noise" in name:
                assert diff.max() <= 2 * LR + 1e-6, name
                continue
            bad = diff > 1e-4 + 5e-3 * np.abs(w)
            assert diff[bad].max(initial=0.0) <= 4 * LR + 1e-6, (name, diff.max())
            flips += int(bad.sum())
            total += w.size
        assert flips <= 1e-3 * total, (net, flips, total)


def test_ranks_agree_bitwise(runs):
    """Both ranks hold the same parameters after every step and the same
    RSCL queues and pointers: the averaged gradients and the gathered keys
    are the same on each."""
    (a, b), _, _ = runs
    for kind in KINDS:
        assert a[kind]["losses"] == b[kind]["losses"], kind
        for k, v in a[kind]["params"].items():
            assert torch.equal(v, b[kind]["params"][k]), (kind, k)
    for k in ("queues", "ptrs"):
        assert torch.equal(a["rscl"][k], b["rscl"][k]), k


def test_rscl_queues_match_the_oracle(runs):
    """The G step enqueues 6 keys per rank and scale (12), gathered in rank
    order as the reference's ``concat_all_gather``: the queues and pointers
    of ppst_tpu's ``n_dev=2`` step."""
    outs, oracle, _ = runs
    for out in outs:
        np.testing.assert_array_equal(out["rscl"]["ptrs"].numpy(), oracle["rscl"]["ptrs"])
        assert (out["rscl"]["ptrs"] == 12).all()
        np.testing.assert_allclose(out["rscl"]["queues"].numpy(), oracle["rscl"]["queues"],
                                   rtol=1e-4, atol=1e-5)


def test_world_of_one_is_the_single_process_run(runs):
    """One rank in a gloo group takes the steps of the same process without a
    group, bit for bit: losses, parameters and queues."""
    _, _, (one, alone) = runs
    for kind in KINDS:
        assert one[kind]["losses"] == alone[kind]["losses"], kind
        for k, v in alone[kind]["params"].items():
            assert torch.equal(v, one[kind]["params"][k]), (kind, k)
    for k in ("queues", "ptrs"):
        assert torch.equal(one["rscl"][k], alone["rscl"][k]), k
