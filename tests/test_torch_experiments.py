"""``python -m ppst_tpu_torch.experiments CelebA ...``: every command line
it prints parses under the port's CLIs; the train line is ppst_tpu's after
the program name; the test line parses in the port and, with its
``--dataroot "your test data"`` placeholder, not in ppst_tpu (W13: the JAX
package's ``Options.__str__`` does not quote; asserted so that a change of
ppst_tpu's shows)."""

import contextlib
import io

import pytest

from ppst_tpu.experiments.CelebA_launcher import Launcher as JaxLauncher
from ppst_tpu.options import TestOptions as JaxTestOptions
from ppst_tpu_torch.experiments import find_launcher_using_name
from ppst_tpu_torch.experiments.__main__ import main
from ppst_tpu_torch.experiments.tmux_launcher import Options
from ppst_tpu_torch.options import TestOptions as PortTestOptions
from ppst_tpu_torch.options import TrainOptions, program_args


def _printed(argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        main(argv)
    return out.getvalue().splitlines()


def _parse(options, command):
    with contextlib.redirect_stdout(io.StringIO()):
        return options.parse(command=command)


@pytest.mark.parametrize("cmd", ["dry", "dryrun", "train", "test"])
def test_printed_lines_parse(cmd, monkeypatch, tmp_path):
    """``dry`` and ``dryrun`` print the train lines; ``train`` and ``test``
    (run here with their commands captured) emit ``python -m
    ppst_tpu_torch.train`` / ``.test`` lines; each parses (a train line
    writes its ``opt.txt`` under ``./checkpoints``, here a scratch folder)."""
    monkeypatch.chdir(tmp_path)
    if cmd.startswith("dry"):
        lines = _printed(["CelebA", cmd])
    else:
        lines = []
        monkeypatch.setattr(find_launcher_using_name("CelebA"), "run_command",
                            lambda self, command, expid=0, dry=False: lines.append(command))
        main(["CelebA", cmd])
    assert lines
    for line in lines:
        program = "train" if cmd != "test" else "test"
        assert line.startswith(f"python -m ppst_tpu_torch.{program} ")
        options = TrainOptions() if program == "train" else PortTestOptions()
        opt = _parse(options, line)
        assert opt.name == "CelebAMaskHQ_default" and opt.dataset_mode == "CelebAMask"


def test_names_and_train_line_match_jax():
    """``print_names`` and ``print_test_names`` print the recipes' names; the
    train line is ppst_tpu's after the program name."""
    assert _printed(["CelebA", "print_names"]) == ["CelebAMaskHQ_default"]
    assert _printed(["CelebA", "print_test_names"]) == ["CelebAMaskHQ_default"]
    (port,) = find_launcher_using_name("CelebA")().commands()
    (jax,) = JaxLauncher().commands()
    assert port.split(" ", 3)[:3] == ["python", "-m", "ppst_tpu_torch.train"]
    assert port.split(" ", 3)[3] == jax.split(" ", 2)[2]
    assert program_args(port) == program_args(jax)


def test_test_line_parses_in_the_port_not_in_jax():
    """W13: the port quotes the placeholder, so its test line parses to the
    recipe's options; ppst_tpu's test line does not parse."""
    (port,) = find_launcher_using_name("CelebA")().test_commands()
    assert "--dataroot 'your test data'" in port
    opt = _parse(PortTestOptions(), port)
    assert opt.dataroot == "your test data" and opt.preprocess == "scale_width"
    assert opt.evaluation_metrics == "content_style_1t1_generation" and opt.batch_size == 1
    (jax,) = JaxLauncher().test_commands()
    with pytest.raises(SystemExit), contextlib.redirect_stderr(io.StringIO()):
        _parse(JaxTestOptions(), jax)


def test_options_text_quotes_only_what_shlex_splits():
    opt = Options(a="~/x/", b=True, c=[1, "two words"], d="it's", e=0.5)
    assert str(opt) == "--a ~/x/ --b True --c 1 'two words' --d 'it'\"'\"'s' --e 0.5"


def test_plot_loss_without_matplotlib(monkeypatch):
    """plot_loss imports matplotlib only when called, and says so where it is
    missing."""
    import builtins

    real_import = builtins.__import__

    def no_matplotlib(name, *args, **kwargs):
        if name.startswith("matplotlib"):
            raise ImportError(name)
        return real_import(name, *args, **kwargs)

    monkeypatch.setattr(builtins, "__import__", no_matplotlib)
    with pytest.raises(ImportError, match="plot_loss needs matplotlib"):
        main(["CelebA", "plot_loss"])
