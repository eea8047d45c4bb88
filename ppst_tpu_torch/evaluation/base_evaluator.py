"""Evaluator base (counterpart of ``ppst_tpu/evaluation/base_evaluator.py``;
reference evaluation/base_evaluator.py)."""

import os


class BaseEvaluator:
    @staticmethod
    def modify_commandline_options(parser, is_train):
        return parser

    def __init__(self, opt, target_phase="test"):
        self.opt = opt
        self.target_phase = target_phase

    def output_dir(self):
        """``<checkpoints_dir>/<name>/snapshots`` at train time, else
        ``<result_dir>/<name>/<dataname>/<evaluator>``."""
        evaluator_name = type(self).__name__.lower().replace("evaluator", "")
        if getattr(self.opt, "isTrain", True):
            return os.path.join(self.opt.checkpoints_dir, self.opt.name, "snapshots")
        return os.path.join(self.opt.result_dir, self.opt.name, self.opt.dataname,
                            evaluator_name)

    def evaluate(self, model, dataset, nsteps=None, generator=None):
        return {}
