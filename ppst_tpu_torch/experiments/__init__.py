"""Experiment launchers (counterpart of ``ppst_tpu/experiments``; reference
experiments/): ``python -m ppst_tpu_torch.experiments <name> <cmd> <ids...>``
runs ``<name>_launcher.Launcher``'s recipes as ``python -m
ppst_tpu_torch.train`` and ``python -m ppst_tpu_torch.test`` command lines."""

import importlib


def find_launcher_using_name(name: str):
    module = importlib.import_module(f"ppst_tpu_torch.experiments.{name}_launcher")
    cls = getattr(module, "Launcher", None)
    if cls is None:
        raise ValueError(f"{name}_launcher has no Launcher class")
    return cls
