"""Run one cell of the benchmark of the PyTorch port on this machine's
card(s) and print its result as the last line of standard output.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The cells are ``workloads`` in
``BENCHMARK.json``; ``--trace 1`` reports the cell's per-layer metrics
from a profiled run instead of its end-to-end ones.
"""

import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
# Kernel caches at fixed paths inside the checkout, set before anything
# loads torch: only a checkout's first run builds.
os.environ["TRITON_CACHE_DIR"] = os.path.join(HERE, ".cache", "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(HERE, ".cache", "torch_extensions")
sys.path.insert(1, os.path.dirname(HERE))

import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main())
