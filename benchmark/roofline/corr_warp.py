"""K3, the blockwise correspondence warp ``softmax(q k^T / T) v``
(``ops/corr_warp_cuda.py``, ``csrc/corr_warp.cu``), at (B, Lq, Lk, C, Cv)
with elements of ``itemsize`` bytes.

Least traffic: q, k and v read once, the output written once. Operations:
both products, at the dense bf16 rate. The arithmetic of the port's
``chip_smoke.py`` ``corr_warp_phase``."""

# the name E2 calls the wrapper by
SITE = "ppst_tpu_torch.models.encoder_col:corr_warp_blockwise"
KERNELS = r"(?<![A-Za-z0-9_])corr_warp_(bf16|f32)_kernel(?![A-Za-z0-9_])"


def shape(args, kwargs):
    q, k, v = args[:3]
    return (q.shape[0], q.shape[1], k.shape[1], q.shape[2], v.shape[2], v.element_size())


def ops(s):
    b, lq, lk, c, cv, _ = s
    return 2 * b * lq * lk * (c + cv)


def bytes_moved(s):
    b, lq, lk, c, cv, item = s
    return (b * lq * c + b * lk * c + b * lk * cv + b * lq * cv) * item
