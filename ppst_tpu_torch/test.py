"""Inference entry point: ``python -m ppst_tpu_torch.test`` (counterpart of
the JAX package's ``test.py``; reference test.py).

The JAX package's command lines run unchanged (``options.TestOptions``):
``--evaluation_metrics`` names the evaluators that a ``GroupEvaluator`` runs
on a loader over ``--dataroot`` in ``--dataset_mode``. ``simple_swapping``
stylizes ``--input_structure_image`` with ``--input_texture_image``;
``content_style_grid_generation`` (alias ``content_style_1t1_generation``)
stylizes every content image of the loader (those under a ``content/``
folder) with every other image and writes the grid as an HTML page;
``swap_visualization`` and ``none`` as at train time.

The weights are those of ``<checkpoints_dir>/<name>/<resume_iter>``
(``latest_checkpoint`` or ``<N>k_checkpoint``; ``.pth``, else the JAX
package's ``.msgpack``), loaded with the network-shape flags they were
trained with; a missing file raises ``FileNotFoundError``. ``--checkpoint
FILE`` serves that file instead (a reference or port ``.pth``, or a JAX
package ``.msgpack``).

Runs on CUDA unless ``--device cpu`` is given, and refuses to start when
CUDA is asked for and absent.
"""

from __future__ import annotations

from ppst_tpu_torch.data import create_dataset
from ppst_tpu_torch.evaluation import GroupEvaluator
from ppst_tpu_torch.options import TestOptions, module_command
from ppst_tpu_torch.train.bundle import create_model


def main(argv=None):
    """Runs the evaluators and returns the ``GroupEvaluator`` (each
    evaluator keeps what it wrote: ``paths``, ``page``)."""
    opt = TestOptions().parse(command=module_command("ppst_tpu_torch.test", argv))
    bundle = create_model(opt)
    dataset = create_dataset(opt)
    evaluators = GroupEvaluator(opt)
    try:
        evaluators.evaluate(bundle.model, dataset, opt.resume_iter, bundle.generator)
    finally:
        dataset.close()
    return evaluators


if __name__ == "__main__":
    main()
