"""K6, the fused StyledConv's forward (``ops/styled_conv_cuda.py``,
``csrc/styled_conv.cu``): the 3x3 conv, noise, the biases, leaky ReLU x
sqrt(2), the instance norm and the style modulation on bf16 NHWC, at (B, H,
W, Cin, Cout).

Least traffic: x and the noise read once, the output written once, the
weights (bf16) read once, the bias, gain and style rows. Operations: the
conv's products. The arithmetic of the port's ``chip_smoke.py``
``styled_conv_bound``; the operations lead at every shape of G."""

# the name the generator's StyledConv calls the op by
SITE = "ppst_tpu_torch.nn.layers:styled_conv3x3"
# its device kernels (the conv with the statistics' partials, the moments,
# the apply); K1's ``apply_kernel`` shares a name, told apart by the span
KERNELS = r"(?<![A-Za-z0-9_])(conv3x3_kernel|moments_kernel|apply_kernel)(?![A-Za-z0-9_])"


def shape(args, kwargs):
    x, w = args[:2]
    return tuple(x.shape) + (w.shape[0],)  # (B, H, W, Cin, Cout)


def ops(s):
    b, h, w, cin, cout = s
    return 2 * b * h * w * 9 * cin * cout


def bytes_moved(s):
    b, h, w, cin, cout = s
    return b * h * w * (cin + cout + 1) * 2 + 9 * cin * cout * 2 + 4 * cout * (1 + 2 * b)
