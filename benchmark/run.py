"""The benchmark of ppst_tpu_torch (PPST's PyTorch and CUDA port) on the card.

    python benchmark/run.py --workload CELL --seed N --seconds S --trace 0|1

from the root of a checkout. Every cache the program builds stays inside the
checkout (the kernels' nvcc builds in ``ppst_tpu_torch/_build/``; the
variables below for anything that builds through torch or Triton).
"""

import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# the harness and the reference (benchmark/), and the program (the root)
sys.path[:0] = [HERE, ROOT]
os.environ["USE_FLAX"] = "0"
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(ROOT, ".bench_cache", "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = os.path.join(ROOT, ".bench_cache", "triton")

from harness.main import main, process_start  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(started=process_start()))
