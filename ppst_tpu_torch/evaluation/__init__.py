"""Evaluator registry and ``GroupEvaluator`` (counterpart of
``ppst_tpu/evaluation/__init__.py``; reference evaluation/group_evaluator.py).

``--evaluation_metrics`` is a comma-separated list; each metric may carry a
``train`` or ``test`` prefix naming the loader phase it evaluates (``test``
by default) and resolves to the class of ``<metric>_evaluator``.
``content_style_1t1_generation`` is an alias of the grid evaluator (the
reference launcher's metric name). Every evaluator is a ``BaseEvaluator``,
adds its flags through ``modify_commandline_options`` and runs on the
loader, at train time and in ``python -m ppst_tpu_torch.test``.
"""

from __future__ import annotations

from ppst_tpu_torch.evaluation.base_evaluator import BaseEvaluator
from ppst_tpu_torch.util.util import find_class_in_module

ALIASES = {"content_style_1t1_generation": "content_style_grid_generation"}


def find_evaluator_using_name(metric: str):
    name = f"{ALIASES.get(metric, metric)}_evaluator"
    module = f"ppst_tpu_torch.evaluation.{name}"
    try:
        cls = find_class_in_module(name, module)
    except ModuleNotFoundError as e:
        if e.name != module:
            raise
        raise ValueError(f"no evaluator named {metric!r}") from None
    return cls


def find_evaluator_classes(opt):
    """The evaluator classes of ``opt.evaluation_metrics`` and the phase of
    each."""
    if len(opt.evaluation_metrics) == 0:
        return [], []
    classes, phases = [], []
    for metric in opt.evaluation_metrics.split(","):
        if metric.startswith("train"):
            phases.append("train")
            metric = metric[len("train"):]
        elif metric.startswith("test"):
            phases.append("test")
            metric = metric[len("test"):]
        else:
            phases.append("test")
        classes.append(find_evaluator_using_name(metric))
    return classes, phases


def get_option_setter():
    return GroupEvaluator.modify_commandline_options


class GroupEvaluator(BaseEvaluator):
    @staticmethod
    def modify_commandline_options(parser, is_train):
        """Adds ``--evaluation_metrics`` and each selected evaluator's flags
        (``parser`` is an ``options.AugmentedArgumentParser``)."""
        parser.add_argument("--evaluation_metrics", default="none")
        opt, _ = parser.parse_known_args()
        classes, _ = find_evaluator_classes(opt)
        for cls in classes:
            parser = cls.modify_commandline_options(parser, is_train)
        return parser

    def __init__(self, opt, target_phase=None):
        super().__init__(opt, target_phase=None)
        classes, phases = find_evaluator_classes(opt)
        self.evaluators = [cls(opt, target_phase=ph) for cls, ph in zip(classes, phases)]

    def evaluate(self, model, dataset, nsteps=None, generator=None):
        """Runs every evaluator on ``dataset`` switched to its phase, then
        switches it back; returns their metrics merged."""
        original_phase = getattr(dataset, "phase", None)
        metrics = {}
        for ev in self.evaluators:
            print(f"Entering evaluation using {type(ev).__name__} on {ev.target_phase} images")
            if dataset is not None and hasattr(dataset, "set_phase"):
                dataset.set_phase(ev.target_phase)
            metrics.update(ev.evaluate(model, dataset, nsteps, generator) or {})
            print(f"Finished evaluation of {type(ev).__name__}")
        if dataset is not None and original_phase and hasattr(dataset, "set_phase"):
            dataset.set_phase(original_phase)
        return metrics
