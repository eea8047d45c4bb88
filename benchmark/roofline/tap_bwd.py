"""K2, the fused 1x1 feature tap's backward (``ops/tap_cuda.py``,
``csrc/tap_bwd.cu``), at (B, H, W, 128), with or without dx.

Least traffic: x, t, u and the output's cotangent read once (640 bytes a
pixel), dx written where asked. Operations: dW2, dp2 and dW1, and dn1 for
dx. The arithmetic of the port's ``chip_smoke.py`` ``tap_bwd_phase``."""

# the autograd Function's backward, which calls the kernel's wrapper
SITE = "ppst_tpu_torch.ops.tap_cuda:_FusedTap.backward"
KERNELS = r"(?<![A-Za-z0-9_])(pass_a_kernel|pass_b_kernel|pass_cd_kernel)(?![A-Za-z0-9_])"
C = 64
CIN = 128  # the only input width the kernel takes


def shape(args, kwargs):
    # (ctx, output cotangent): the saved tensors are not read here, since
    # under a checkpoint they unpack once
    ctx, g = args[:2]
    return tuple(g.shape[:3]) + (CIN, int(bool(ctx.needs_input_grad[0])))  # (B, H, W, Cin, dx)


def ops(s):
    b, h, w, cin, dx = s
    return 2 * b * h * w * (2 * C * C + C * cin * (2 if dx else 1))


def bytes_moved(s):
    b, h, w, cin, dx = s
    pixels = b * h * w
    return pixels * (cin + 3 * C) * 2 + (pixels * cin * 2 if dx else 0)
