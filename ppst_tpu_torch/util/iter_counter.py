"""Image-count-based iteration counter (counterpart of
``ppst_tpu/util/iter_counter.py``; reference util/iter_counter.py): counts
images, not steps; ``iter.txt`` for resume; EMA-smoothed per-section wall
times per image. Under ``torch.distributed`` only rank 0 writes ``iter.txt``.

A section's first sample (the cold first batch, the first step's warm-up)
is left out of its EMA, which its second sample seeds: until then the
section has no time. While a profiler runs, each section is the span
``ppst.loop:<section>``."""

from __future__ import annotations

import os
import time

from ppst_tpu_torch import parallel
from ppst_tpu_torch.util.spans import span


class IterationCounter:
    @staticmethod
    def modify_commandline_options(parser, is_train):
        parser.add_argument("--total_nimgs", default=7000000, type=int)
        parser.add_argument("--save_freq", default=50000, type=int)
        parser.add_argument("--evaluation_freq", default=50000, type=int)
        parser.add_argument("--print_freq", default=480, type=int)
        parser.add_argument("--display_freq", default=1600, type=int)
        return parser

    def __init__(self, opt):
        self.opt = opt
        self.iter_record_path = os.path.join(opt.checkpoints_dir, opt.name, "iter.txt")
        self.steps_so_far = 0
        self.batch_size = opt.batch_size
        self.time_measurements = {}
        self._sampled = set()  # the sections whose first, cold sample has passed
        resume_iter = getattr(opt, "resume_iter", "latest")
        if getattr(opt, "continue_train", False):
            if resume_iter == "latest":
                try:
                    with open(self.iter_record_path) as f:
                        self.steps_so_far = int(f.read().strip())
                    print(f"Resuming from iteration {self.steps_so_far}")
                except (OSError, ValueError):
                    print(f"Could not load iteration record at {self.iter_record_path}. "
                          "Starting from beginning.")
            elif resume_iter.replace("k", "").isnumeric():
                steps = int(resume_iter.replace("k", ""))
                self.steps_so_far = steps * 1000 if "k" in resume_iter else steps

    def record_one_iteration(self):
        if self.needs_saving() and parallel.is_primary():
            os.makedirs(os.path.dirname(self.iter_record_path), exist_ok=True)
            with open(self.iter_record_path, "w") as f:
                f.write(f"{self.steps_so_far}\n")
        self.steps_so_far += self.batch_size

    def needs_saving(self):
        return (self.steps_so_far % self.opt.save_freq) < self.batch_size

    def needs_evaluation(self):
        return (self.steps_so_far >= self.opt.evaluation_freq
                and (self.steps_so_far % self.opt.evaluation_freq) < self.batch_size)

    def needs_printing(self):
        return (self.steps_so_far % self.opt.print_freq) < self.batch_size

    def needs_displaying(self):
        return (self.steps_so_far % self.opt.display_freq) < self.batch_size

    def completed_training(self):
        return self.steps_so_far >= self.opt.total_nimgs

    def time_measurement(self, name):
        return _TimeMeasurement(name, self)


class _TimeMeasurement:
    def __init__(self, name, parent):
        self.name, self.parent = name, parent

    def __enter__(self):
        self.span = span("loop:" + self.name)
        self.span.__enter__()
        self.start_time = time.time()

    def __exit__(self, *exc):
        elapsed = (time.time() - self.start_time) / self.parent.batch_size
        self.span.__exit__(*exc)
        parent = self.parent
        if self.name not in parent._sampled:
            parent._sampled.add(self.name)
            return
        prev = parent.time_measurements.get(self.name)
        parent.time_measurements[self.name] = (
            elapsed if prev is None else prev * 0.98 + elapsed * 0.02)
