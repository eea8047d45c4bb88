"""What the benchmark's process may not hold: JAX, its libraries and the
JAX package. Names are compared whole, by the part before the first dot:
``ppst_tpu_torch`` is the program, ``ppst_tpu`` is not."""

import sys

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "optax", "ppst_tpu"})


def forbidden_loaded(modules=None) -> list:
    names = sys.modules if modules is None else modules
    return sorted(m for m in names if m.split(".")[0] in FORBIDDEN)
