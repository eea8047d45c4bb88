"""K1, the fused 1x1 feature tap's forward (``ops/tap_cuda.py``,
``csrc/tap.cu``): IN -> 1x1 conv 128->64 -> IN -> PReLU -> 1x1 conv 64->64
-> IN -> PReLU on bf16 NHWC, at (B, H, W, 128).

Least traffic: x read once, the output written once, the weights and biases
read once. Operations: both products. The arithmetic of the port's
``chip_smoke.py`` ``kernel_phase``."""

# the name the generator calls the wrapper by
SITE = "ppst_tpu_torch.models.generator:fused_tap_1x1"
# its device kernels (stats, two conv passes, apply)
KERNELS = r"(?<![A-Za-z0-9_])(stats_kernel|conv_kernel|apply_kernel)(?![A-Za-z0-9_])"
C1 = C2 = 64


def shape(args, kwargs):
    return tuple(args[0].shape)  # (B, H, W, Cin)


def ops(s):
    b, h, w, cin = s
    return 2 * b * h * w * (cin * C1 + C1 * C2)


def bytes_moved(s):
    b, h, w, cin = s
    return b * h * w * (cin + C2) * 2 + (cin * C1 + C1 * C2) * 2 + 4 * 130
