"""Training: the steps (``steps``), checkpoints (``bundle``) and the CLI
(``cli``, run as ``python -m ppst_tpu_torch.train``)."""
