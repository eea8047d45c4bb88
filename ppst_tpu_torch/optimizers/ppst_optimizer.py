"""PPSTOptimizer: the host loop's view of one training step (counterpart of
``ppst_tpu/optimizers/ppst_optimizer.py``; reference
optimizers/ppst_optimizer.py).

* strict 1:1 D/G alternation starting with a D step (:60-70);
* R1 every ``R1_once_every``-th D step, as a second D update (:116-126);
* no D step at all when ``lambda_GAN`` is 0;
* ``train_one_step(data_i, steps)`` returns the step's losses as floats,
  fetched from the device in one transfer; under ``torch.distributed`` they
  are averaged over the ranks first (one small collective), which makes
  them the global batch's means that the JAX package logs. While a
  profiler runs, the spans ``ppst.step:inputs`` and ``ppst.step:fetch``
  mark the batch's copy to the device and the losses' way back;
* ``get_visuals_for_snapshot(data_i, generator)``: the training snapshot.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ppst_tpu_torch import parallel
from ppst_tpu_torch.train.steps import TrainSteps
from ppst_tpu_torch.util.spans import span


class PPSTOptimizer:
    @staticmethod
    def modify_commandline_options(parser, is_train):
        parser.add_argument("--lr", default=0.001, type=float)
        parser.add_argument("--beta1", default=0.0, type=float)
        parser.add_argument("--beta2", default=0.99, type=float)
        parser.add_argument("--R1_once_every", default=16, type=int,
                            help="lazy R1 regularization: computed once every N D-steps")
        return parser

    def __init__(self, opt, bundle):
        self.opt = opt
        self.bundle = bundle
        self.cfg = bundle.cfg
        self.train_mode_counter = 0
        self.discriminator_iter_counter = 0
        self.steps = TrainSteps(bundle.model, bundle.optimizers)

    def prepare_images(self, data_i):
        """The batch's images and masks on the device; a training step needs
        both, so a dataset without masks (``--dataset_mode lmdb``, as in the
        JAX package) is refused here."""
        if "mask_A" not in data_i:
            raise ValueError("the training step needs the batch's masks (mask_A), which this "
                             "dataset does not give: train on --dataset_mode celebamask or "
                             "synthetic; lmdb serves the test-time loader only")
        dev = self.bundle.device
        return (torch.as_tensor(data_i["real_A"]).to(dev, non_blocking=True),
                torch.as_tensor(data_i["mask_A"]).to(dev, non_blocking=True))

    def toggle_training_mode(self) -> str:
        mode = ("discriminator", "generator")[self.train_mode_counter]
        self.train_mode_counter = (self.train_mode_counter + 1) % 2
        return mode

    def train_one_step(self, data_i, total_steps_so_far) -> Dict[str, float]:
        with span("step:inputs"):
            images, mask = self.prepare_images(data_i)
        if self.toggle_training_mode() == "discriminator":
            losses = self.train_discriminator_one_step(images, mask)
        else:
            losses = self.train_generator_one_step(images, mask)
        if not losses:  # --lambda_GAN 0 skips the D step entirely
            return {}
        keys = list(losses)
        with span("step:fetch"):
            values = parallel.average(
                torch.stack([losses[k].float() for k in keys])).cpu().numpy()
        out = dict(zip(keys, values))
        if getattr(self.opt, "debug_nan", False):
            bad = [k for k, v in out.items() if not np.isfinite(v).all()]
            if bad:
                raise FloatingPointError(f"non-finite losses at step {total_steps_so_far}: {bad}")
        return out

    def train_discriminator_one_step(self, images, mask):
        if self.cfg.lambda_GAN == 0.0:
            return {}
        self.discriminator_iter_counter += 1
        needs_r1 = (self.cfg.lambda_R1 > 0.0
                    and self.discriminator_iter_counter % self.cfg.R1_once_every == 0)
        step = self.steps.d_step_r1 if needs_r1 else self.steps.d_step
        return step(images, mask, self.bundle.generator)

    def train_generator_one_step(self, images, mask):
        return self.steps.g_step(images, mask, self.bundle.generator)

    def get_visuals_for_snapshot(self, data_i, generator: torch.Generator):
        """The snapshot visuals of the batch's first 4 images (reference
        ppst_model.py:238-240), in the training dtype, with noise from
        ``generator``."""
        images = torch.as_tensor(data_i["real_A"]).to(self.bundle.device, non_blocking=True)
        return self.bundle.model.get_visuals_for_snapshot(images[:4].to(self.steps.dtype),
                                                          generator)

    def save(self, total_steps_so_far, blocking: bool = True):
        self.bundle.save(total_steps_so_far, blocking=blocking)
