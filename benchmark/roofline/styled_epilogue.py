"""The StyledConv epilogue (``ops/styled_epilogue_cuda.py``,
``csrc/styled_epilogue.cu``): after G's convolution, its bias, gain x noise,
StyledConv's and the activation's biases, leaky ReLU x sqrt(2), the instance
norm and the style modulation, on bf16 NHWC at (B, H, W, C).

Least traffic: y read once, the output written once (2 bytes an element
each), the noise (2 bytes a pixel), the three float32 biases and the bf16
style row (B, 2C). Operations: the elementwise count, 13 an element (four
bias adds, the leaky ReLU's and the gain's products, a^2 and the two sums,
the normalization's subtract and product, the modulation's product and
add) and the noise product a pixel; the byte bound leads by far."""

# the name the generator's StyledConv calls the wrapper by
SITE = "ppst_tpu_torch.nn.layers:styled_epilogue"
# its device kernels (the statistics pass, the apply pass)
KERNELS = r"(?<![A-Za-z0-9_])styled_epi_(stats|apply)(?![A-Za-z0-9_])"


def shape(args, kwargs):
    return tuple(args[0].shape)  # (B, H, W, C)


def ops(s):
    b, h, w, c = s
    return 13 * b * h * w * c + b * h * w


def bytes_moved(s):
    b, h, w, c = s
    return b * h * w * c * 4 + b * h * w * 2 + 12 * c + 4 * b * c
