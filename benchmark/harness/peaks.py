"""Published peaks of the cards the benchmark runs on (NVIDIA's data
sheets, dense rates without sparsity), copied from the port's
``chip_smoke.py`` ``CARDS``: (substring of the card's name, memory
bytes/s, dense bf16 operations/s)."""

CARDS = [("H100 80GB HBM3", 3.35e12, 989e12),  # H100 SXM
         ("H100 NVL", 3.9e12, 835e12), ("H100 PCIe", 2.0e12, 756e12),
         ("H200", 4.8e12, 989e12)]


def of(name: str) -> tuple:
    """(bytes/s, bf16 operations/s) of the card called ``name``."""
    for key, bw, flops in CARDS:
        if key in name:
            return bw, flops
    raise RuntimeError(f"no published peaks for {name!r} in benchmark/harness/peaks.py")
