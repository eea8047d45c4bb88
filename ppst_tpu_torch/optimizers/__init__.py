"""Optimizer registry (counterpart of ``ppst_tpu/optimizers/__init__.py``):
``--optimizer foo`` -> module ``foo_optimizer`` -> class ``FooOptimizer``."""

import importlib


def find_optimizer_using_name(name: str):
    module = importlib.import_module(f"ppst_tpu_torch.optimizers.{name}_optimizer")
    target = name.replace("_", "") + "optimizer"
    for attr, cls in vars(module).items():
        if attr.lower() == target.lower():
            return cls
    raise NotImplementedError(f"no optimizer class matching {name!r} in "
                              "ppst_tpu_torch.optimizers")


def get_option_setter(name: str):
    return find_optimizer_using_name(name).modify_commandline_options


def create_optimizer(opt, bundle):
    return find_optimizer_using_name(opt.optimizer)(opt, bundle)
