"""The JAX package's ``.msgpack`` checkpoints in the port: the port's own
decoder (``util.msgpack_ckpt``) against flax's ``msgpack_restore``, and a
checkpoint written by ppst_tpu's ``ModelBundle.save`` served and resumed by
the port with its weights, RSCL state, D-step count and Adam state, at
NARROW in float32 on the CPU.

The checkpoint holds the port's seed-1 weights carried to JAX, and after
one optax update of each network with seeded gradients its Adam states.
The noise gains are zero, so neither side's noise draws enter.
"""

import os
import shutil
from types import SimpleNamespace

import flax.serialization as flax_ser
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image
from test_torch_train_common import NARROW, assert_losses, batch, jax_params, jax_state

from ppst_tpu.models.config import PPSTConfig as JaxConfig
from ppst_tpu.models.ppst import PPSTModel as JaxModel
from ppst_tpu.train.bundle import ModelBundle as JaxBundle
from ppst_tpu.train.steps import make_optimizers as jax_optimizers
from ppst_tpu.util.convert_torch import convert_reference_state_dict
from ppst_tpu_torch import test as test_cli
from ppst_tpu_torch.models.config import PPSTConfig
from ppst_tpu_torch.models.ppst import PPSTModel
from ppst_tpu_torch.train import cli
from ppst_tpu_torch.train.bundle import create_model
from ppst_tpu_torch.train.steps import TrainSteps
from ppst_tpu_torch.util import msgpack_ckpt
from ppst_tpu_torch.util.from_flax import from_flax, net_from_flax

WIDTH_FLAGS = [f"--{k}={v}" for k, v in NARROW.items() if k != "crop_size"]
# flax splits leaves above this many bytes into __msgpack_chunked_array__ maps
CHUNK = 4096


def _leaves_equal(got, want, path=""):
    """``got`` (the port's decoder) holds ``want`` (flax's): the same maps,
    lists and scalars, and arrays of the same dtype, shape and values."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), path
        for k in want:
            _leaves_equal(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _leaves_equal(g, w, f"{path}[{i}]")
    elif hasattr(want, "dtype"):
        if want.dtype == jnp.bfloat16:
            assert isinstance(got, torch.Tensor) and got.dtype == torch.bfloat16, path
            got, want = got.float().numpy(), np.asarray(want, np.float32)
        assert got.dtype == want.dtype and got.shape == want.shape, path
        np.testing.assert_array_equal(got, want, err_msg=path)
    elif isinstance(want, bytes):
        assert bytes(got) == want, path
    else:
        assert type(got) is type(want) and got == want, path


def test_decoder_matches_flax_on_every_type(monkeypatch):
    """Maps (an empty one too), lists, str, bin, ints of every width, floats,
    nil, bool, complex, numpy scalars, 0-d and empty arrays of several
    dtypes, bfloat16, and chunked leaves (float32 and bfloat16)."""
    monkeypatch.setattr(flax_ser, "MAX_CHUNK_SIZE", 16)
    tree = {
        "a": np.arange(6, dtype=np.float32).reshape(2, 3), "count": np.zeros((), np.int32),
        "empty_map": {}, "list": [0, 127, 128, -1, -32, -33, 2**16, -(2**31), 2**40, -(2**40),
                                  2.5, None, True, False, "x" * 40, b"yy"],
        "bf16": jnp.arange(5, dtype=jnp.bfloat16), "scalar": np.float32(3.5),
        "c": 1 + 2j, "empty": np.zeros((0, 3), np.float32), "i8": np.arange(-3, 3, dtype=np.int8),
        "u64": np.array([2**63], np.uint64), "f16": np.ones((2, 2), np.float16),
        "long": np.arange(300, dtype=np.float64), "chunked": np.arange(10, dtype=np.float32),
        "chunked_bf16": jnp.arange(10, dtype=jnp.bfloat16), "k" * 300: 1,
    }
    encoded = flax_ser.msgpack_serialize(tree)
    got = msgpack_ckpt.msgpack_restore(bytearray(encoded))
    assert isinstance(got["chunked"], np.ndarray) and got["chunked"].shape == (10,)
    _leaves_equal(got, flax_ser.msgpack_restore(encoded))
    with pytest.raises(ValueError, match="truncated"):
        msgpack_ckpt.msgpack_restore(encoded[:-3])


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """ppst_tpu's ModelBundle.save at 2000 images (leaves above CHUNK bytes
    chunked): the run directory and the tree it wrote."""
    src = PPSTModel(PPSTConfig(**NARROW), device="cpu", seed=1)
    params, state = jax_params(src), jax_state(src)
    state["num_d_iters"] = jnp.asarray(3, jnp.int32)
    state["rscl"]["ptrs"] = state["rscl"]["ptrs"] + 6
    rng = np.random.default_rng(7)
    opt_states = {}
    for k, opt in jax_optimizers(JaxConfig(**NARROW)).items():
        grads = jax.tree.map(lambda p: rng.standard_normal(p.shape, np.float32) * 1e-2,
                             params[k])
        _, opt_states[k] = jax.jit(opt.update)(grads, jax.jit(opt.init)(params[k]), params[k])
    bundle = JaxBundle.__new__(JaxBundle)
    bundle.opt = SimpleNamespace(checkpoints_dir=str(tmp_path_factory.mktemp("ck")), name="run")
    bundle.params, bundle.state, bundle.opt_states = params, state, opt_states
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(flax_ser, "MAX_CHUNK_SIZE", CHUNK)
        bundle.save(2000)
    run = os.path.join(bundle.opt.checkpoints_dir, "run")
    return run, {"params": params, "state": state, "opt_states": opt_states}


def _argv(run, *extra):
    return ["--device", "cpu", "--name", os.path.basename(run), "--checkpoints_dir",
            os.path.dirname(run), "--continue_train", "true", "--crop_size", "64",
            "--load_size", "64", "--dataset_mode", "synthetic", *WIDTH_FLAGS, *extra]


def _opt(run, *extra):
    return cli.parse(_argv(run, *extra))


def test_decoder_reads_the_jax_checkpoint_as_flax_does(jax_run):
    run, _ = jax_run
    path = os.path.join(run, "latest_checkpoint.msgpack")
    assert os.readlink(path) == "2k_checkpoint.msgpack"
    with open(path, "rb") as f:
        raw = f.read()
    assert b"__msgpack_chunked_array__" in raw
    want = flax_ser.msgpack_restore(raw)
    assert want["opt_states"]["G"]["1"] == {}
    _leaves_equal(msgpack_ckpt.read_checkpoint(path), want)


def _adam_trees(model, optimizers, key):
    """The port's Adam ``key`` of every parameter as ppst_tpu trees, through
    ppst_tpu's own converter."""
    sd = {k: v.detach().numpy() for k, v in model.state_dict().items()}
    for net, opt in optimizers.items():
        for name, p in getattr(model, net).named_parameters():
            sd[f"{net}.{name}"] = opt.state[p][key].numpy()
    return convert_reference_state_dict(sd, crop_size=64)


def test_resume_restores_weights_state_and_adam(jax_run, capsys):
    """--continue_train from latest_checkpoint.msgpack: the state dict equals
    from_flax(params) exactly; the RSCL state and D-step count are the
    checkpoint's; every Adam step equals optax's count and every exp_avg /
    exp_avg_sq, carried back by ppst_tpu's converter, equals mu / nu."""
    run, tree = jax_run
    bundle = create_model(_opt(run))
    out = capsys.readouterr().out
    assert f"Loaded checkpoint from {run}/latest_checkpoint.msgpack" in out
    assert "[load] optimizer state restored" in out
    want = from_flax(jax.tree.map(np.asarray, tree["params"]))
    got = bundle.model.state_dict()
    assert set(got) == set(want)
    for k in want:
        assert torch.equal(got[k], want[k].reshape(got[k].shape)), k
    rscl = tree["state"]["rscl"]
    np.testing.assert_array_equal(bundle.model.rscl_queues.numpy(), np.asarray(rscl["queues"]))
    np.testing.assert_array_equal(bundle.model.rscl_ptrs.numpy(), np.asarray(rscl["ptrs"]))
    assert bundle.model.num_d_iters == 3
    for key, field in (("exp_avg", "mu"), ("exp_avg_sq", "nu")):
        back = _adam_trees(bundle.model, bundle.optimizers, key)
        for net in bundle.optimizers:
            jax.tree.map(np.testing.assert_array_equal, back[net],
                         jax.tree.map(np.asarray, getattr(tree["opt_states"][net][0], field)))
    for net, opt in bundle.optimizers.items():
        assert {float(st["step"]) for st in opt.state.values()} == {1.0}
        assert len(opt.state) == len(list(getattr(bundle.model, net).parameters()))


def test_pth_is_preferred_and_drift_restarts_moments(jax_run, tmp_path, capsys):
    """Where a .pth and a .msgpack of one name exist the .pth is read; an
    Adam tree that lost a parameter restarts the moments with ppst_tpu's
    message and keeps the weights."""
    run, tree = jax_run
    bundle = create_model(_opt(run))
    bundle.opt.checkpoints_dir, bundle.opt.name = str(tmp_path), "both"
    bundle.save(2000)
    drift = jax.tree.map(np.asarray, tree)
    del drift["opt_states"]["G"][0].mu["to_rgb"]
    with open(tmp_path / "both" / "2k_checkpoint.msgpack", "wb") as f:
        f.write(flax_ser.to_bytes(drift))
    capsys.readouterr()
    create_model(_opt(str(tmp_path / "both"), "--resume_iter", "2k"))
    assert f"Loaded checkpoint from {tmp_path}/both/2k_checkpoint.pth" in capsys.readouterr().out
    os.remove(tmp_path / "both" / "2k_checkpoint.pth")
    fresh = create_model(_opt(str(tmp_path / "both"), "--resume_iter", "2k"))
    out = capsys.readouterr().out
    assert "could not restore optimizer state" in out and "restarting moments" in out
    assert all(not o.state for o in fresh.optimizers.values())
    for k, v in bundle.model.state_dict().items():
        assert torch.equal(fresh.model.state_dict()[k], v), k


def test_a_missing_or_reshaped_leaf_keeps_the_rest_of_its_network(jax_run, tmp_path, capsys):
    """A G leaf missing from the checkpoint and another of a wrong shape keep
    their initialization with ppst_tpu's messages; every other leaf of G is
    the checkpoint's, and the Adam state (whose tree is intact) is restored.
    Serving, which needs every weight, refuses the file."""
    run, tree = jax_run
    cut = jax.tree.map(np.asarray, tree)
    del cut["params"]["G"]["to_rgb"]["conv"]["weight"]
    cut["params"]["G"]["to_rgb"]["bias"] = np.zeros(5, np.float32)
    os.makedirs(tmp_path / "cut")
    with open(tmp_path / "cut" / "latest_checkpoint.msgpack", "wb") as f:
        f.write(flax_ser.to_bytes(cut))
    init = create_model(_opt(str(tmp_path / "cut"), "--continue_train", "false")).model
    init = init.state_dict()
    capsys.readouterr()
    got = create_model(_opt(str(tmp_path / "cut"))).model.state_dict()
    out = capsys.readouterr().out
    assert "[load] missing G.ToRGB.conv.weight, keeping initialization" in out
    assert "[load] shape mismatch at G.ToRGB.bias" in out
    assert "[load] optimizer state restored" in out
    want = from_flax(jax.tree.map(np.asarray, tree["params"]))
    for k in want:
        kept = k in ("G.ToRGB.conv.weight", "G.ToRGB.bias")
        assert torch.equal(got[k], (init[k] if kept else want[k].reshape(got[k].shape))), k
    model = PPSTModel(PPSTConfig(**NARROW), device="cpu", seed=0)
    with pytest.raises(KeyError, match="lacks 1 keys"):
        model.load_reference_checkpoint(str(tmp_path / "cut" / "latest_checkpoint.msgpack"))


def test_stylize_from_the_checkpoint_matches_jax(jax_run, rng, tmp_path):
    """``test.py --checkpoint <.msgpack>``'s model (D skipped) stylizes as
    ppst_tpu does with the checkpoint's params, within 1e-3; the CLI
    serves it."""
    run, tree = jax_run
    path = os.path.join(run, "2k_checkpoint.msgpack")
    model = PPSTModel(PPSTConfig(**NARROW), device="cpu", seed=5)
    model.load_reference_checkpoint(path)
    content = rng.uniform(-1, 1, (1, 64, 64, 3)).astype(np.float32)
    style = rng.uniform(-1, 1, (1, 64, 64, 3)).astype(np.float32)
    jmodel = JaxModel(JaxConfig(**NARROW), lpips_variables={})
    want = jax.jit(jmodel.stylize)(tree["params"], jnp.asarray(content), jnp.asarray(style),
                                  jax.random.PRNGKey(0))
    got = model.stylize(torch.from_numpy(content), torch.from_numpy(style))
    assert np.abs(got.numpy() - np.asarray(want)).max() <= 1e-3

    imgs = []
    for name, arr in (("content", content), ("style", style)):
        imgs.append(str(tmp_path / f"{name}.png"))
        Image.fromarray(((arr[0] + 1) * 127.5).astype(np.uint8)).save(imgs[-1])
    (ev,) = test_cli.main(["--device", "cpu", "--name", "ppst", "--checkpoint", path,
                           "--evaluation_metrics", "simple_swapping", "--input_structure_image",
                           imgs[0], "--input_texture_image", imgs[1], "--preprocess", "resize",
                           "--load_size", "64", "--crop_size", "64", "--result_dir",
                           str(tmp_path / "res"), *WIDTH_FLAGS]).evaluators
    assert np.asarray(Image.open(ev.paths[0])).shape == (64, 64, 3)


def test_resumed_d_step_matches_jax(jax_run):
    """One D step after the resume: its losses within 1e-3 relative of
    ppst_tpu's on the checkpoint's params; and torch's Adam, given JAX's
    gradient, moves D as optax does from the restored state (bias
    corrections at step 2), within 1e-6 of the weights' scale."""
    run, tree = jax_run
    bundle = create_model(_opt(run))
    real, mask = batch(seed=4)
    jmodel = JaxModel(JaxConfig(**NARROW), lpips_variables={})
    params, state = tree["params"], tree["state"]

    def d_loss(d, r, m):
        losses, _ = jmodel.discriminator_losses(dict(params, D=d), state, r, m,
                                                jax.random.PRNGKey(0))
        return sum(losses.values()), losses

    (_, want), grads = jax.jit(jax.value_and_grad(d_loss, has_aux=True))(
        params["D"], jnp.asarray(real), jnp.asarray(mask))
    steps = TrainSteps(bundle.model, bundle.optimizers)
    got = steps.d_step(torch.from_numpy(real), torch.from_numpy(mask),
                       torch.Generator().manual_seed(0))
    got.pop("D_total")
    assert_losses({k: v.item() for k, v in got.items()}, want)

    fresh = create_model(_opt(run))
    d_params = dict(fresh.model.D.named_parameters())
    for k, g in net_from_flax("D", grads).items():
        p = d_params[k[2:]]
        p.grad = g.reshape(p.shape)
    fresh.optimizers["D"].step()
    opt = jax_optimizers(JaxConfig(**NARROW))["D"]
    updates, _ = opt.update(grads, tree["opt_states"]["D"], params["D"])
    want_d = net_from_flax("D", jax.tree.map(lambda p, u: p + u, params["D"], updates))
    for k, w in want_d.items():
        p = d_params[k[2:]].detach()
        np.testing.assert_allclose(p.numpy(), w.reshape(p.shape).numpy(), rtol=0,
                                   atol=1e-6 * max(1.0, float(w.abs().max())), err_msg=k)
    assert {float(s["step"]) for s in fresh.optimizers["D"].state.values()} == {2.0}


def test_train_cli_resumes_the_jax_checkpoint(jax_run, tmp_path):
    """``python -m ppst_tpu_torch.train --continue_train true --resume_iter
    2k`` trains on from the JAX checkpoint's 2000 images (D step 4, then a
    G step) and saves a .pth."""
    run = str(tmp_path / "run")
    shutil.copytree(jax_run[0], run, symlinks=True)
    bundle = cli.main(_argv(run, "--resume_iter", "2k", "--total_nimgs", "2004",
                            "--synthetic_size", "4", "--nThreads", "2", "--save_freq", "100000"))
    raw = torch.load(os.path.join(run, "2k_checkpoint.pth"), weights_only=True)
    assert raw["steps"] == 2004 and raw["num_d_iters"] == bundle.model.num_d_iters == 4
