"""Faults planted under the program's timed path, to show that the
comparison catches them (``calibrate.py --fault``, on the card at a cell's
own size; ``tests/test_bench_faults.py``, on the CPU). Each takes the
``setattr`` to plant with (pytest's ``monkeypatch.setattr`` undoes it)."""

from __future__ import annotations

import torch


def state_unchanged(put=setattr):
    """The optimizers take their steps without changing a parameter or
    their own state."""
    import ppst_tpu_torch.train.bundle as bundle
    from ppst_tpu_torch.train import steps

    def frozen(model):
        opts = steps.make_optimizers(model)
        for opt in opts.values():
            opt.step = lambda *a, **k: None
        return opts

    put(bundle, "make_optimizers", frozen)


def half_batch(put=setattr):
    """The second half of every batch replaced by the first: the mean is
    taken over half of the batch."""
    from ppst_tpu_torch.models.ppst import PPSTModel
    from ppst_tpu_torch.optimizers.ppst_optimizer import PPSTOptimizer

    prepare = PPSTOptimizer.prepare_images

    def halved(self, data_i):
        images, mask = prepare(self, data_i)
        h = images.shape[0] // 2
        return torch.cat([images[:h]] * 2), torch.cat([mask[:h]] * 2)

    put(PPSTOptimizer, "prepare_images", halved)
    for name in ("stylize", "stylize_fused"):
        entry = getattr(PPSTModel, name)

        def wrapped(self, content, style, *a, _entry=entry, **k):
            h = content.shape[0] // 2
            return _entry(self, torch.cat([content[:h]] * 2), torch.cat([style[:h]] * 2), *a, **k)

        put(PPSTModel, name, wrapped)


def r1_dropped(put=setattr):
    """The D+R1 step leaves its lazy R1 penalty out (its loss and its
    update): a plain D step in its place."""
    from ppst_tpu_torch.train.steps import TrainSteps

    put(TrainSteps, "d_step_r1", TrainSteps.d_step)


def answer_altered(put=setattr):
    """The first image of every answer has its top eighth set to black."""
    from ppst_tpu_torch.models.ppst import PPSTModel

    for name in ("stylize", "stylize_fused"):
        entry = getattr(PPSTModel, name)

        def wrapped(self, *a, _entry=entry, **k):
            out = _entry(self, *a, **k).clone()
            out[0, : out.shape[1] // 8] = -1.0
            return out

        put(PPSTModel, name, wrapped)


FAULTS = {f.__name__: f for f in (state_unchanged, half_batch, r1_dropped, answer_altered)}
