"""PyTorch/CUDA port of ppst_tpu: the simple_swapping inference path.

Imports torch, numpy and PIL only; nothing of JAX or of ppst_tpu.
"""
