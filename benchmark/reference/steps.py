"""Training steps: the reference's D/G alternation (counterpart of
``ppst_tpu/train/steps.py``; reference optimizers/ppst_optimizer.py:65-130).

``TrainSteps`` holds the model and its four Adam optimizers and runs the D
step, the D step with lazy R1 and the G step. Each casts the batch to the
compute dtype (cfg.dtype); parameters, optimizer state and the RSCL queues
stay float32. Gradients are taken only for the networks the step updates
(``backward(inputs=...)``), as the JAX package differentiates only the
updated subtree.

A frozen copy of the port's ``ppst_tpu_torch/train/steps.py`` (at commit
afeb803) for one process: no gradient averaging over ranks.
"""

from __future__ import annotations

from typing import Dict

import torch


GE_KEYS = ("G", "E1", "E2")
_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def make_optimizers(model) -> Dict[str, torch.optim.Adam]:
    """Four Adams (eps 1e-8); D's with the lazy-R1 compensation
    c = R1_once_every / (1 + R1_once_every): lr * c, betas ** c (reference
    ppst_optimizer.py:36-49)."""
    cfg = model.cfg
    c = cfg.R1_once_every / (1 + cfg.R1_once_every)
    opts = {k: torch.optim.Adam(getattr(model, k).parameters(), lr=cfg.lr,
                                betas=(cfg.beta1, cfg.beta2), eps=1e-8) for k in GE_KEYS}
    opts["D"] = torch.optim.Adam(model.D.parameters(), lr=cfg.lr * c,
                                 betas=(cfg.beta1**c, cfg.beta2**c), eps=1e-8)
    return opts


def _backward(loss, params):
    """Gradients of ``loss`` for ``params``; a parameter the loss does not
    reach (R1's biases) gets a zero gradient, so that Adam counts the step
    for it too, as optax does."""
    for p in params:
        p.grad = None
    loss.backward(inputs=params)
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)


def _apply(opt, loss, params):
    _backward(loss, params)
    opt.step()


class TrainSteps:
    def __init__(self, model, optimizers=None):
        self.model = model
        self.cfg = model.cfg
        self.opts = optimizers if optimizers is not None else make_optimizers(model)
        self.dtype = _DTYPES[self.cfg.dtype]

    def _cast(self, real, mask):
        return real.to(self.dtype), mask.to(self.dtype)

    def _d_update(self, real, mask, generator):
        losses = self.model.discriminator_losses(real, mask, generator)
        _apply(self.opts["D"], sum(losses.values()), list(self.model.D.parameters()))
        return losses

    @staticmethod
    def _detached(losses):
        return {k: v.detach() for k, v in losses.items()}

    def d_step(self, real, mask, generator: torch.Generator):
        losses = self._d_update(*self._cast(real, mask), generator)
        losses["D_total"] = sum(losses.values())
        return self._detached(losses)

    def d_step_r1(self, real, mask, generator: torch.Generator):
        """A D update, then a second update by the lazy R1 penalty (times
        R1_once_every) on the fresh D: two optimizer steps, as the
        reference's ppst_optimizer.py:113-126."""
        real, mask = self._cast(real, mask)
        losses = self._d_update(real, mask, generator)
        r1 = self.model.r1_loss(real)
        _apply(self.opts["D"], sum(r1.values()) * self.cfg.R1_once_every,
               list(self.model.D.parameters()))
        losses.update(r1)
        losses["D_total"] = sum(losses.values())
        return self._detached(losses)

    def g_step(self, real, mask, generator: torch.Generator):
        real, mask = self._cast(real, mask)
        losses, metrics, rscl = self.model.generator_losses(real, mask, generator)
        params = [p for k in GE_KEYS for p in getattr(self.model, k).parameters()]
        _backward(sum(losses.values()), params)
        for k in GE_KEYS:
            self.opts[k].step()
        self.model.set_rscl_state(rscl)
        return self._detached(dict(losses, **metrics))
