"""The JAX command line on the port's entry points: the same command lines
parsed by ``ppst_tpu.options`` and ``ppst_tpu_torch.options`` give the same
options (every key of ppst_tpu's namespace, equal; the port adds only
``device`` and, at test time, ``checkpoint``), the same printed table and
the same ``opt.txt``; ``opt.pkl`` unpickles without ppst_tpu. Then the test
CLI: its defaults are ppst_tpu's (F7, served end to end against ppst_tpu's
simple_swapping evaluator), it loads ``<checkpoints_dir>/<name>/
<resume_iter>`` and raises where that is missing, and ``--use_antialias
false`` reaches the model (``stylize`` against ppst_tpu's). No model is
built for the parse tests; the serving tests run NARROW at crop 64 in
float32, with the port's seed weights carried to ppst_tpu (their noise gains
are zero, so neither side's noise enters)."""

import contextlib
import io
import os
import pickle
import re
import shlex
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image
from test_torch_train_common import NARROW, jax_params, seed_checkpoint

import ppst_tpu.evaluation.simple_swapping_evaluator as jax_swapping
from ppst_tpu.evaluation import GroupEvaluator as JaxGroupEvaluator
from ppst_tpu.experiments.CelebA_launcher import Launcher as JaxLauncher
from ppst_tpu.models.config import PPSTConfig as JaxConfig
from ppst_tpu.models.ppst import PPSTModel as JaxModel
from ppst_tpu.options import TestOptions as JaxTestOptions
from ppst_tpu.options import TrainOptions as JaxTrainOptions
from ppst_tpu.train.bundle import ModelBundle as JaxBundle
import ppst_tpu_torch.evaluation.simple_swapping_evaluator as port_swapping
from ppst_tpu_torch import test as test_cli
from ppst_tpu_torch.models.config import PPSTConfig
from ppst_tpu_torch.models.ppst import PPSTModel
from ppst_tpu_torch.options import TestOptions as PortTestOptions
from ppst_tpu_torch.options import TrainOptions, module_command
from ppst_tpu_torch.train.bundle import ModelBundle, create_model

ROOT = Path(__file__).resolve().parent.parent
PORT_ONLY = {"device", "checkpoint"}
WIDTH_FLAGS = [f"--{k}={v}" for k, v in NARROW.items() if k != "crop_size"]


def _readme_line(program):
    """README's ``python <program> ...`` command, its continuation lines
    joined."""
    text = (ROOT / "README.md").read_text().replace("\\\n", " ")
    return next(" ".join(line.split()) for line in text.splitlines()
                if line.startswith(f"python {program} "))


UNREAD = ("--lambda_triplet 0.5 --lambda_hist 2 --num_patches 64 "
          "--nce_includes_all_negatives_from_minibatch false --netE_num_downsampling_gl 3 "
          "--netE2_num_downsampling_gl2 1 --easy_label lbl --no_html 0")
TRAIN_LINES = {
    "readme": lambda: _readme_line("train.py"),
    # tests/test_options_data.py's lines
    "options_data_defaults": lambda: "python train.py --name t --dataset_mode synthetic",
    "options_data_celebamask": lambda: (
        "python train.py --name t --dataset_mode celebamask --dataroot img --dataroot2 msk "
        "--preprocess resize --load_size 64 --crop_size 64 --batch_size 2"),
    "options_data_synthetic": lambda: ("python train.py --name t --dataset_mode synthetic "
                                       "--crop_size 64 --batch_size 4 --nThreads 3"),
    "launcher": lambda: JaxLauncher().commands()[0],
    "unread_flags": lambda: f"python train.py --name t --dataset_mode synthetic {UNREAD}",
    "swap_visualization": lambda: (
        "python train.py --name t --evaluation_metrics trainswap_visualization "
        "--swap_num_columns 2 --evaluation_freq 8 --continue_train --remat_taps"),
    "grid": lambda: ("python train.py --name t --evaluation_metrics "
                     "content_style_1t1_generation --dataset_mode CelebAMask"),
}
TEST_LINES = {
    "readme": lambda: _readme_line("test.py"),
    "unread_flags": lambda: (f"python test.py --name t {UNREAD} --evaluation_metrics "
                             "swap_visualization --dataroot ~/imgs"),
    "grid": lambda: ("python test.py --name t --evaluation_metrics "
                     "content_style_1t1_generation --dataset_mode CelebAMask "
                     "--preprocess scale_width --batch_size 1 --dataname test1"),
}


def _parse(options, command):
    """``options.parse(command=...)``'s namespace and printed table."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        opt = options.parse(command=command)
    return vars(opt), out.getvalue()


def _without(text, keys):
    return [line for line in text.splitlines()
            if line.split(":", 1)[0].strip() not in keys]


@pytest.mark.parametrize("name", TRAIN_LINES)
def test_train_command_lines_parse_alike(name, tmp_path):
    """Each line parses in both packages to the same options; ``opt.txt``
    agrees line for line apart from ``device``; ``opt.pkl`` unpickles, with
    no ppst_tpu module, to the port's options as written."""
    command = f"{TRAIN_LINES[name]()} --checkpoints_dir {tmp_path}"
    run = tmp_path / command.split("--name ", 1)[1].split()[0]
    want, want_table = _parse(JaxTrainOptions(), command)
    want_txt = (run / "opt.txt").read_text()
    for f in ("opt.txt", "opt.pkl"):
        (run / f).unlink()
    got, got_table = _parse(TrainOptions(), command)
    assert {k: got.get(k, "missing") for k in want} == want
    assert set(got) - set(want) == {"device"}
    assert _without(got_table, PORT_ONLY) == _without(want_table, PORT_ONLY)
    assert _without((run / "opt.txt").read_text(), PORT_ONLY) == _without(want_txt, PORT_ONLY)
    assert re.search(r"^ +device: cuda +$", (run / "opt.txt").read_text(), re.M)
    code = ("import pickle, sys; opt = pickle.load(open(sys.argv[1], 'rb')); "
            "assert not [m for m in sys.modules if m.startswith('ppst_tpu')]; print(vars(opt))")
    out = subprocess.run([sys.executable, "-c", code, str(run / "opt.pkl")], cwd=tmp_path,
                         capture_output=True, text=True, check=True).stdout
    saved = pickle.loads((run / "opt.pkl").read_bytes())
    assert out.strip() == str(vars(saved))
    assert dict(vars(saved), dataroot=os.path.expanduser(saved.dataroot)) == got


@pytest.mark.parametrize("name", TEST_LINES)
def test_test_command_lines_parse_alike(name):
    """The same at test time, where neither package writes ``opt.txt``: the
    namespaces and the printed tables."""
    want, want_table = _parse(JaxTestOptions(), TEST_LINES[name]())
    got, got_table = _parse(PortTestOptions(), TEST_LINES[name]())
    assert {k: got.get(k, "missing") for k in want} == want
    assert set(got) - set(want) == PORT_ONLY
    assert _without(got_table, PORT_ONLY) == _without(want_table, PORT_ONLY)


def _images(tmp_path, rng):
    paths = []
    for name in ("content", "style"):
        p = tmp_path / f"{name}.png"
        Image.fromarray((rng.random((80, 72, 3)) * 255).astype(np.uint8)).save(p)
        paths.append(str(p))
    return paths


def _jax_bundle(weights, **cfg):
    """ppst_tpu's serving bundle on the port's weights."""
    model = PPSTModel(PPSTConfig(**cfg), device="cpu")
    model.load_reference_checkpoint(weights)
    bundle = JaxBundle.__new__(JaxBundle)
    bundle.model = JaxModel(JaxConfig(**cfg), lpips_variables={})
    bundle.params, bundle.rng = jax_params(model), jax.random.PRNGKey(0)
    return bundle


def _recorder(module, monkeypatch):
    """The float images ``module``'s evaluator hands to ``tensor2im``."""
    seen, to_im = [], module.tensor2im

    def record(x):
        seen.append(np.asarray(x.float().numpy() if isinstance(x, torch.Tensor) else x))
        return to_im(x)

    monkeypatch.setattr(module, "tensor2im", record)
    return seen


def test_f7_test_cli_takes_jax_defaults(tmp_path, rng, monkeypatch):
    """F7: a JAX test line without ``--preprocess`` (nor ``--dataset_mode``)
    parses to ppst_tpu's ``scale_width_and_crop`` and, under simple_swapping,
    ``imagefolder`` at the content's folder; the port's test CLI then
    stylizes the same crop as ppst_tpu's evaluator, within 1e-3."""
    content, style = _images(tmp_path, rng)
    args = ["--name", "run", "--evaluation_metrics", "simple_swapping",
            "--input_structure_image", content, "--input_texture_image", style, "--load_size",
            "64", "--crop_size", "64", "--result_dir", str(tmp_path / "res"), *WIDTH_FLAGS]
    jax_opt, _ = _parse(JaxTestOptions(), "python test.py " + shlex.join(args))
    opt, _ = _parse(PortTestOptions(), "python -m ppst_tpu_torch.test " + shlex.join(args))
    for k in ("preprocess", "dataset_mode", "dataroot"):
        assert opt[k] == jax_opt[k], k
    assert opt["preprocess"] == "scale_width_and_crop" and opt["dataroot"] == str(tmp_path)
    assert opt["dataset_mode"] == "imagefolder"

    weights = seed_checkpoint(tmp_path / "seed.pth", **NARROW)
    want = _recorder(jax_swapping, monkeypatch)
    jax_opt = JaxTestOptions().parse(command="python test.py " + shlex.join(args))
    JaxGroupEvaluator(jax_opt).evaluate(_jax_bundle(weights, **NARROW), None, "latest")
    got = _recorder(port_swapping, monkeypatch)
    (ev,) = test_cli.main(args + ["--device", "cpu", "--checkpoint", weights]).evaluators
    assert len(got) == len(want) == 1 and got[0].shape == want[0].shape == (1, 64, 64, 3)
    assert np.abs(got[0] - want[0]).max() <= 1e-3
    assert os.path.basename(ev.paths[0]) == "content_style_1.00.png"


def test_checkpoint_lookup(tmp_path):
    """Without ``--checkpoint`` the test CLI loads ``<checkpoints_dir>/<name>/
    <resume_iter>``: a missing ``latest_checkpoint`` raises
    FileNotFoundError; ``--resume_iter 50k`` finds ``50k_checkpoint.pth``."""
    base = ["--device", "cpu", "--name", "run", "--checkpoints_dir", str(tmp_path),
            "--evaluation_metrics", "none", "--crop_size", "64", *WIDTH_FLAGS]
    with pytest.raises(FileNotFoundError, match="latest_checkpoint"):
        test_cli.main(base)
    (tmp_path / "run").mkdir()
    weights = seed_checkpoint(tmp_path / "run" / "50k_checkpoint.pth", seed=7, **NARROW)
    with contextlib.redirect_stdout(io.StringIO()):
        bundle = create_model(PortTestOptions().parse(
            command=module_command("ppst_tpu_torch.test", base + ["--resume_iter", "50k"])))
    saved = torch.load(weights, weights_only=True)
    for k, v in bundle.model.state_dict().items():
        if not k.startswith("D."):  # serving skips D, as ppst_tpu does
            assert torch.equal(v, saved[k]), k
    with pytest.raises(FileNotFoundError, match="2k_checkpoint"):
        test_cli.main(base + ["--resume_iter", "2k"])


def test_use_antialias_false_reaches_the_model(rng):
    """``--use_antialias false`` reaches the model the test CLI builds
    (``ModelBundle``), and ``stylize`` with it off matches ppst_tpu's within
    1e-3."""
    with contextlib.redirect_stdout(io.StringIO()):
        opt = PortTestOptions().parse(command=module_command(
            "ppst_tpu_torch.test", ["--name", "x", "--device", "cpu", "--use_antialias", "false",
                                    "--crop_size", "64", *WIDTH_FLAGS]))
        model = ModelBundle(opt).model
    assert model.cfg.use_antialias is False and model.cfg.gd_blur_kernel == (1,)
    content, style = (rng.uniform(-1, 1, (1, 64, 64, 3)).astype(np.float32) for _ in range(2))
    jmodel = JaxModel(JaxConfig(**NARROW, use_antialias=False), lpips_variables={})
    want = jax.jit(jmodel.stylize)(jax_params(model), jnp.asarray(content), jnp.asarray(style),
                                  jax.random.PRNGKey(0))
    with torch.no_grad():
        got = model.stylize(torch.from_numpy(content), torch.from_numpy(style))
    assert np.abs(got.numpy() - np.asarray(want)).max() <= 1e-3
