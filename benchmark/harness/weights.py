"""The weights, the LPIPS network and the RSCL queues of a run, drawn from
the seed on the card.

Every parameter follows its layer's published initial distribution
(``init_rules`` of the reference's layers, which are the port's). Those the
published init sets to 0 (biases, noise gains) are drawn from
N(0, ``ZERO_INIT_STD``) instead: a trained model's are not 0, and a check
with them at 0 could not see a bias or a noise term dropped. Everything is
drawn in float32, the type the parameters are served in, in two calls (one
``randn`` and one ``rand`` over all parameters), then cut and scaled.
"""

from __future__ import annotations

import torch

from reference.config import PPSTConfig
from reference.model import PPSTModel

ZERO_INIT_STD = 0.05
RSCL_QUEUES, RSCL_QUEUE_SIZE = 4, 128


def rules(module: torch.nn.Module) -> dict:
    """{state_dict key: rule} of ``module``: each layer's ``init_rules``;
    a parameter of no such layer (StyledConv's and ToRGB's own biases) is
    a zero-initialised bias."""
    out = {}
    for prefix, m in module.named_modules():
        if hasattr(m, "init_rules"):
            for k, rule in m.init_rules().items():
                out[f"{prefix}.{k}" if prefix else k] = rule
    for k, _ in module.named_parameters():
        out.setdefault(k, ("const", 0.0))
    return out


def draw(shapes: dict, rule_of: dict, generator: torch.Generator) -> dict:
    """{key: float32 tensor on the generator's device}, each drawn by its
    rule; rules of a constant 0 become N(0, ZERO_INIT_STD)."""
    dev = generator.device
    total = sum(torch.Size(s).numel() for s in shapes.values())
    normal = torch.randn(total, generator=generator, device=dev)
    uniform = torch.rand(total, generator=generator, device=dev)
    out, at = {}, 0
    for key, shape in shapes.items():
        n = torch.Size(shape).numel()
        kind, *a = rule_of[key]
        if kind == "const" and a[0] == 0.0:
            kind, a = "normal", [0.0, ZERO_INIT_STD]
        if kind == "normal":
            t = normal[at:at + n] * a[1] + a[0]
        elif kind == "uniform":
            t = uniform[at:at + n] * (a[1] - a[0]) + a[0]
        elif kind == "const":
            t = torch.full((n,), float(a[0]), device=dev)
        else:
            raise ValueError(f"unknown initial distribution {kind!r} for {key}")
        out[key] = t.reshape(shape)
        at += n
    return out


def make(cfg: PPSTConfig, seed: int, device) -> dict:
    """{"model": state_dict, "lpips": state_dict, "rscl": {"queues", "ptrs"}}
    for ``cfg``, from ``seed``, on ``device``."""
    with torch.device("meta"):
        shell = PPSTModel(cfg)
    gen = torch.Generator(device=device).manual_seed(seed)
    model = {k: v.shape for k, v in shell.state_dict().items()}
    lpips = {k: v.shape for k, v in shell.lpips.state_dict().items()}
    weights = draw(model, rules(shell), gen)
    lpips_weights = draw(lpips, shell.lpips.init_rules(), gen)
    q = torch.randn((RSCL_QUEUES, cfg.style_dim, RSCL_QUEUE_SIZE), generator=gen, device=device)
    rscl = {"queues": q / torch.linalg.vector_norm(q, dim=1, keepdim=True),
            "ptrs": torch.zeros((RSCL_QUEUES,), dtype=torch.int64, device=device)}
    return {"model": weights, "lpips": lpips_weights, "rscl": rscl}
