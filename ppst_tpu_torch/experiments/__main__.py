"""Experiment CLI: ``python -m ppst_tpu_torch.experiments <name> <cmd>
<ids...>`` (counterpart of ``ppst_tpu/experiments/__main__.py``; reference
experiments/__main__.py). ``<cmd>``: train, test, launch, relaunch, dry,
dryrun, stop, close, plot_loss, create_comparison_html, print_names or
print_test_names; ``test all`` runs every test recipe."""

import argparse

from ppst_tpu_torch.experiments import find_launcher_using_name


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("name")
    parser.add_argument("cmd")
    parser.add_argument("id", nargs="*", type=str, default=["0"])
    parser.add_argument("--mode", default=None)
    parser.add_argument("--resume_iter", default=None)
    parser.add_argument("--continue_train", action="store_true")
    parser.add_argument("--subdir", default="")
    parser.add_argument("--title", default="")
    parser.add_argument("--phase", default="test")
    opt = parser.parse_args(argv)

    launcher = find_launcher_using_name(opt.name)()
    ids = opt.id or ["0"]
    cmd = opt.cmd
    extra_train = " --continue_train True" if opt.continue_train else ""
    extra_test = f" --resume_iter {opt.resume_iter}" if opt.resume_iter else ""

    if cmd == "train":
        for expid in ids:
            idx = launcher.resolve_expid(expid, launcher.train_options())
            launcher.run_command(launcher.commands()[idx] + extra_train, idx)
    elif cmd == "test":
        test_cmds = launcher.test_commands()
        if ids == ["all"]:
            ids = [str(i) for i in range(len(test_cmds))]
        for expid in ids:
            idx = launcher.resolve_expid(expid, launcher.test_options())
            launcher.run_command(test_cmds[idx] + extra_test, idx)
    elif cmd == "launch":
        launcher.launch()
    elif cmd == "relaunch":
        launcher.stop()
        launcher.launch()
    elif cmd in ("dry", "dryrun"):
        launcher.dry()
    elif cmd in ("stop", "close"):
        launcher.stop()
    elif cmd == "plot_loss":
        launcher.plot_loss(ids, opt.mode, opt.name)
    elif cmd == "create_comparison_html":
        launcher.create_comparison_html(opt.name, ids, opt.subdir, opt.title, opt.phase)
    elif cmd == "print_names":
        for o in launcher.train_options():
            print(o.kvs.get("name"))
    elif cmd == "print_test_names":
        for o in launcher.test_options():
            print(o.kvs.get("name"))
    else:
        raise ValueError(f"Command {cmd!r} not recognized")


if __name__ == "__main__":
    main()
