"""The control of the comparison: the plain reference computed in float8
(e4m3) in place of the program.

The configuration states bfloat16, which the program computes in: its
activations are bfloat16 tensors and its products take bfloat16 operands.
The precision below it is 8 bits, so under ``Float8`` every floating
tensor that an operation returns (the activations, the noise, the
correspondence's logits and weights) is rounded to float8 e4m3, and every
operand of a convolution, a linear layer or a matrix product too, each at a
per-tensor scale (its largest magnitude to the format's, as fp8 GEMMs
scale); a product accumulates in float32, as an fp8 GEMM does. Scalars (a
loss, a norm reduced to one number) stay float32, as fp8 recipes keep their
reductions, and so do the optimizer's step and its state (``exempt``), as
the program keeps parameters and Adam in float32. In a training step the
gradient that reaches each product's output is rounded to e5m2 the same way
before the backward's products use it (the usual fp8 recipe: e4m3 forward,
e5m2 gradients); the rounding of the forward passes gradients straight
through.
"""

from __future__ import annotations

import contextlib
import functools

import torch
import torch.utils.checkpoint
import torch.nn.functional as F
from torch.overrides import TorchFunctionMode

E4M3_MAX, E5M2_MAX = 448.0, 57344.0
_PRODUCTS = {F.conv2d, F.conv_transpose2d, F.linear, torch.matmul, torch.einsum, torch.bmm,
             torch.Tensor.__matmul__, torch.Tensor.matmul}
_WIDE = (torch.float32, torch.bfloat16, torch.float16, torch.float64)


def _round(x: torch.Tensor, dtype, largest: float) -> torch.Tensor:
    # the rounding's own operations are not rounded again (a gradient's
    # rounding runs in the backward, where the mode may still be active)
    with torch._C.DisableTorchFunction():
        scale = x.abs().amax().clamp_min(1e-30) / largest
        return (x / scale).to(dtype).to(x.dtype) * scale


def to_float8(x):
    """``x`` rounded to e4m3 at a per-tensor scale, in ``x``'s dtype, with
    the gradient passed straight through; anything else as it is."""
    if not (torch.is_tensor(x) and x.dtype in _WIDE and x.numel() > 1):
        return x
    q = _round(x.detach(), torch.float8_e4m3fn, E4M3_MAX)
    if not x.requires_grad:
        return q
    with torch._C.DisableTorchFunction():
        return x + (q - x).detach()


class _GradFloat8(torch.autograd.Function):
    """Identity forward; the backward rounds the incoming gradient to e5m2."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _round(g, torch.float8_e5m2, E5M2_MAX)


def _outputs(out):
    if torch.is_tensor(out):
        return to_float8(out)
    if type(out) in (tuple, list):
        return type(out)(_outputs(o) for o in out)
    return out


class Float8(TorchFunctionMode):
    def __init__(self):
        super().__init__()
        self.paused = 0

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if self.paused:
            return func(*args, **kwargs)
        if func in _PRODUCTS:
            out = func(*(to_float8(a) for a in args),
                       **{k: to_float8(v) for k, v in kwargs.items()})
            if torch.is_tensor(out) and out.requires_grad:
                out = _GradFloat8.apply(out)
        else:
            out = func(*args, **kwargs)
        name = getattr(func, "__name__", "")
        if name.endswith("_") and not name.endswith("__"):
            return out  # in place: the caller keeps the tensor it wrote
        return _outputs(out)

    def exempt(self, fn):
        """``fn`` run with nothing rounded (an optimizer's step)."""

        @functools.wraps(fn)
        def wrapped(*args, **kwargs):
            self.paused += 1
            try:
                return fn(*args, **kwargs)
            finally:
                self.paused -= 1

        return wrapped


@contextlib.contextmanager
def for_training(optimizers: dict):
    """``Float8`` over the reference's training steps: the optimizers' steps
    exempt, and every pass that the reference's checkpoints recompute in
    the backward recomputed under the mode too, so that the backward reads
    the activations the forward rounded."""
    import reference.generator
    import reference.model

    mode = Float8()
    steps = {k: opt.step for k, opt in optimizers.items()}
    for k, opt in optimizers.items():
        opt.step = mode.exempt(opt.step)
    modules = (reference.model, reference.generator)
    plain = [m.checkpoint for m in modules]
    for m in modules:
        m.checkpoint = functools.partial(
            torch.utils.checkpoint.checkpoint,
            context_fn=lambda: (contextlib.nullcontext(), _recompute(mode)))
    try:
        with mode:
            yield mode
    finally:
        for m, fn in zip(modules, plain):
            m.checkpoint = fn
        for k, opt in optimizers.items():
            opt.step = steps[k]


@contextlib.contextmanager
def _recompute(mode: Float8):
    paused, mode.paused = mode.paused, 0
    try:
        with mode:
            yield
    finally:
        mode.paused = paused
