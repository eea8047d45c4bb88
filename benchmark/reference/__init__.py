"""The benchmark's plain reference of PPST: float32 PyTorch, no kernels.

A frozen copy of the port's plain modules at commit afeb803
(``ppst_tpu_torch/models``, ``nn``, the plain ``ops`` and
``train/steps.py``), cut to one process and to the paths the cells run,
with the hand-written kernels' plain versions in their place. It imports
nothing of ``ppst_tpu_torch``, ``ppst_tpu`` or JAX, and draws nothing from a
seed: the benchmark hands it the weights, the inputs and the RSCL queues it
hands the program, and it draws the program's noise again from the same
generator seed (``model.draw_noise``).
"""
