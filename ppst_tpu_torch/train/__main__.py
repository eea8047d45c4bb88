"""``python -m ppst_tpu_torch.train``: the training CLI (``train.cli``)."""

from ppst_tpu_torch.train.cli import main

main()
