"""Experiment launcher infrastructure (counterpart of
``ppst_tpu/experiments/tmux_launcher.py``; reference
experiments/tmux_launcher.py): an ``Options`` key-value bag that renders to
a command line, and a launcher that runs each recipe in a tmux window, or in
the foreground where there is no tmux.

The commands are ``python -m ppst_tpu_torch.train ...`` and ``python -m
ppst_tpu_torch.test ...`` (one process per GPU: ``--num_gpus`` is the
world size of a ``torchrun`` launch). ``Options.__str__`` renders the JAX
package's options text, except that it shell-quotes a value that ``shlex``
would split (the JAX package's does not, so its CelebA test line, with
``--dataroot your test data``, does not parse)."""

from __future__ import annotations

import os
import re
import shlex
import shutil
import subprocess
from typing import List, Union

from ppst_tpu_torch.util.html import HTML


def _arg(v) -> str:
    """``v`` as one shell word: quoted where ``shlex`` would split it."""
    s = str(v)
    try:
        one_word = shlex.split(s) == [s]
    except ValueError:  # an unclosed quote
        one_word = False
    return s if one_word else shlex.quote(s)


class Options:
    def __init__(self, *args, **kwargs):
        self.kvs = {}
        self.tag_str = None
        for arg in args:
            if isinstance(arg, Options):
                self.kvs.update(arg.kvs)
        self.set(**kwargs)

    def set(self, *args, **kwargs):
        for arg in args:
            if isinstance(arg, Options):
                self.kvs.update(arg.kvs)
        self.kvs.update(kwargs)
        return self

    def remove(self, *args):
        for k in args:
            self.kvs.pop(k, None)
        return self

    def update(self, other: "Options"):
        self.kvs.update(other.kvs)
        return self

    def clone(self) -> "Options":
        opt = Options()
        opt.kvs = dict(self.kvs)
        opt.tag_str = self.tag_str
        return opt

    def specify(self, **kwargs):
        return self.clone().set(**kwargs)

    def tag(self, tag: str):
        self.tag_str = tag
        return self

    def __str__(self):
        parts = []
        for k, v in self.kvs.items():
            if isinstance(v, (list, tuple)):
                parts.append(f"--{k} " + " ".join(_arg(x) for x in v))
            else:
                parts.append(f"--{k} {_arg(v)}")
        return " ".join(parts)


class TmuxLauncher:
    def __init__(self):
        self.tmux_prefix = "experiments_" + type(self).__name__.replace("Launcher", "")

    # Subclasses override:
    def options(self) -> List[Options]:
        return []

    def train_options(self) -> List[Options]:
        return self.options()

    def test_options(self) -> List[Options]:
        return self.options()

    # ------------------------------------------------------------------

    def commands(self) -> List[str]:
        return [f"python -m ppst_tpu_torch.train {opt}" for opt in self.train_options()]

    def test_commands(self) -> List[str]:
        return [f"python -m ppst_tpu_torch.test {opt}" for opt in self.test_options()]

    def find_tag(self, options: List[Options], tag: str) -> int:
        for i, opt in enumerate(options):
            if opt.tag_str == tag:
                return i
        raise ValueError(f"tag {tag} not found in options")

    def resolve_expid(self, expid: Union[int, str], options: List[Options]) -> int:
        if isinstance(expid, str) and not expid.isdigit():
            return self.find_tag(options, expid)
        return int(expid)

    def _have_tmux(self) -> bool:
        if shutil.which("tmux") is None:
            return False
        return (subprocess.run(["tmux", "has-session"], capture_output=True).returncode == 0
                or subprocess.run(["tmux", "new-session", "-d", "-s", self.tmux_prefix],
                                  capture_output=True).returncode == 0)

    def run_command(self, command: str, expid: int = 0, dry: bool = False):
        print(command)
        if dry:
            return
        if self._have_tmux():
            window = f"{self.tmux_prefix}:{expid}"
            subprocess.run(["tmux", "new-window", "-t", self.tmux_prefix, "-n", str(expid)],
                           capture_output=True)
            subprocess.run(["tmux", "send-keys", "-t", window, command, "Enter"],
                           capture_output=True)
        else:
            subprocess.run(command, shell=True, check=False)

    # -- CLI verbs ------------------------------------------------------

    def train(self, expid: Union[int, str], dry: bool = False):
        idx = self.resolve_expid(expid, self.train_options())
        self.run_command(self.commands()[idx], idx, dry)

    def test(self, expid: Union[int, str], dry: bool = False):
        idx = self.resolve_expid(expid, self.test_options())
        self.run_command(self.test_commands()[idx], idx, dry)

    def launch(self, dry: bool = False):
        for i, cmd in enumerate(self.commands()):
            self.run_command(cmd, i, dry)

    def dry(self):
        self.launch(dry=True)

    def stop(self):
        if shutil.which("tmux"):
            subprocess.run(["tmux", "kill-session", "-t", self.tmux_prefix], capture_output=True)

    # -- analysis verbs ---------------------------------------------------

    def plot_loss(self, expids, mode=None, name=None):
        """Parse each experiment's loss_log.txt and write loss_curves.png into
        its checkpoint directory (needs matplotlib)."""
        try:
            import matplotlib
        except ImportError:
            raise ImportError("plot_loss needs matplotlib, which is not installed") from None
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        for opt in self.train_options():
            exp_name = opt.kvs.get("name")
            ckpt = os.path.expanduser(str(opt.kvs.get("checkpoints_dir", "./checkpoints/")))
            log = os.path.join(ckpt, exp_name, "loss_log.txt")
            if not os.path.exists(log):
                print(f"no loss log at {log}")
                continue
            series, iters = {}, []
            with open(log) as f:
                for line in f:
                    m_it = re.search(r"iters: (\d+)", line)
                    if not m_it:
                        continue
                    iters.append(int(m_it.group(1)))
                    for key, val in re.findall(r"(\w+): (-?\d+\.?\d*)\s", line):
                        series.setdefault(key, []).append(float(val))
            if not iters:
                continue
            fig, ax = plt.subplots(figsize=(10, 6))
            for key, vals in sorted(series.items()):
                if len(vals) == len(iters):
                    ax.plot(iters, vals, label=key, linewidth=1)
            ax.set_xlabel("images seen")
            ax.set_ylabel("loss (EMA)")
            ax.legend(fontsize=7, ncol=3)
            out = os.path.join(ckpt, exp_name, "loss_curves.png")
            fig.savefig(out, dpi=120, bbox_inches="tight")
            plt.close(fig)
            print(f"wrote {out}")

    def create_comparison_html(self, name, expids, subdir="", title="", phase="test"):
        """Side-by-side HTML of the result images of every test recipe."""
        rows = {}
        for opt in self.test_options():
            exp_name = opt.kvs.get("name")
            result_dir = os.path.join("results", exp_name, subdir)
            if not os.path.isdir(result_dir):
                continue
            for root, _, files in os.walk(result_dir):
                for f in sorted(files):
                    if f.lower().endswith((".png", ".jpg")):
                        rows.setdefault(f, []).append(
                            (exp_name, os.path.abspath(os.path.join(root, f))))
        page = HTML(os.path.join("results", f"comparison_{name}"), title or f"comparison {name}")
        for fname, entries in sorted(rows.items()):
            page.add_header(fname)
            page.add_images([p for _, p in entries], [n for n, _ in entries], width=256)
        print(f"wrote {page.save()}")
