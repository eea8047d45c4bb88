"""K8, an instance norm and what follows it (``ops/norm_act_cuda.py``,
``csrc/norm_act.cu``): a conv's bias, the norm, a residual, leaky ReLU x
sqrt(2) or PReLU, on bf16 NHWC at (B, H, W, C, R, P): R is 1 with a
residual, P the float32 parameter values the call reads (C for the
pre-bias, C for the leaky ReLU's bias, 1 for the PReLU's slope).

Least traffic: y read once, the residual read once, the output written once
(2 bytes an element each), and the parameters. Operations: the elementwise
count of the longest variant, 14 an element (the pre-bias add, t^2 and the
two sums, the normalization's subtract and product, the residual add, the
leaky ReLU's bias add, products and select); the byte bound leads by far."""

# the name every extraction site calls the op by (``nn.layers.instance_norm_act``)
SITE = "ppst_tpu_torch.nn.layers:norm_act"
# its device kernels (the statistics pass, the apply pass of each variant)
KERNELS = r"(?<![A-Za-z0-9_])norm_act_(stats|apply)(?![A-Za-z0-9_])"


def shape(args, kwargs):
    a = dict(zip(("y", "pre_bias", "residual", "act_bias", "slope"), args), **kwargs)
    given = {k for k, v in a.items() if v is not None}
    b, h, w, c = a["y"].shape
    params = c * ("pre_bias" in given) + c * ("act_bias" in given) + ("slope" in given)
    return (b, h, w, c, int("residual" in given), params)  # (B, H, W, C, R, P)


def ops(s):
    b, h, w, c, r, p = s
    return 14 * b * h * w * c


def bytes_moved(s):
    b, h, w, c, r, p = s
    return b * h * w * c * 2 * (2 + r) + 4 * p
