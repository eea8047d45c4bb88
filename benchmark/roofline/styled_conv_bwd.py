"""K6-bwd, the fused StyledConv's backward (``ops/styled_conv_cuda.py``,
``csrc/styled_conv_bwd.cu``; dx through ``csrc/styled_conv.cu``'s conv), at
(B, H, W, Cin, Cout), with or without dx.

Least traffic: x, the stored activation a, the output's cotangent and the
noise read once, dx written where asked, dW written in float32. Operations:
the products of dW, and of dx where asked. The arithmetic of the port's
``chip_smoke.py`` ``styled_conv_bound`` (which times it with dx)."""

# the function that launches the backward's kernels, called by
# ``styled_conv3x3_bwd`` with the saved tensors already unpacked, so that the
# recompute of a checkpointed region never runs inside its span
SITE = "ppst_tpu_torch.ops.styled_conv_cuda:_bwd_cuda"
# the statistics and dpre passes with their group sums, dW and its reduce,
# and dx (the forward's conv kernel); K1's ``stats_kernel`` shares a name
KERNELS = (r"(?<![A-Za-z0-9_])(stats_kernel|group_sum_kernel|dpre_kernel|dw_kernel"
           r"|dw_reduce_kernel|conv3x3_kernel)(?![A-Za-z0-9_])")


def shape(args, kwargs):
    x, w, *_, need_dx = args  # (x, w, noise, a, mean, rstd, s1, g, need_dx)
    return tuple(x.shape) + (w.shape[0], int(bool(need_dx)))  # (B, H, W, Cin, Cout, dx)


def ops(s):
    b, h, w, cin, cout, dx = s
    return 2 * b * h * w * 9 * cin * cout * (2 if dx else 1)


def bytes_moved(s):
    b, h, w, cin, cout, dx = s
    return b * h * w * ((2 if dx else 1) * cin + 2 * cout + 1) * 2 + 9 * cin * cout * 4
