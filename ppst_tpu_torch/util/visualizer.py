"""Console and ``loss_log.txt`` reporting (counterpart of
``ppst_tpu/util/visualizer.py``; the live part of reference
util/visualizer.py:272-291). Under ``torch.distributed`` only rank 0 writes
the log and prints."""

from __future__ import annotations

import os
import time

import numpy as np

from ppst_tpu_torch import parallel


class Visualizer:
    @staticmethod
    def modify_commandline_options(parser, is_train):
        # accepted and recorded, as in the JAX package; nothing reads it
        parser.add_argument("--no_html", type=bool, default=True)
        return parser

    def __init__(self, opt):
        self.primary = parallel.is_primary()
        self.log_name = os.path.join(opt.checkpoints_dir, opt.name, "loss_log.txt")
        if not self.primary:
            return
        os.makedirs(os.path.dirname(self.log_name), exist_ok=True)
        with open(self.log_name, "a") as f:
            f.write(f"================ Training Loss ({time.strftime('%c')}) ================\n")

    def print_current_losses(self, steps, times, losses):
        if not self.primary:
            return
        message = f"(iters: {steps}"
        for name, t in times.items():
            message += f", {name}: {t * 1000:.1f}ms/img"
        message += ") "
        for k, v in losses.items():
            message += f"{k}: {float(np.mean(np.asarray(v))):.3f} "
        print(message, flush=True)
        with open(self.log_name, "a") as f:
            f.write(message + "\n")
