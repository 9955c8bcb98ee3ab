"""The readings a cell's limits are set from, many seeds in one process:
for each seed, a run of the cell (set-up, a short window, the check) and
the same check with the reference put in the program's place, computed
one precision below the configuration's (``control``: float8 e4m3
products for bfloat16 compute), with half of each batch left out
(``half_batch``) and with every step leaving the state as it was
(``unchanged``).

    python3 benchmark/calibrate.py --workload <cell> --seeds 1 2 3 [--sides 3] [--seconds 2]

prints one JSON line a seed (the first ``--sides`` seeds with the control
and the faults).
"""

import argparse
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
os.environ["TRITON_CACHE_DIR"] = os.path.join(HERE, ".cache", "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(HERE, ".cache", "torch_extensions")
sys.path.insert(1, os.path.dirname(HERE))

import harness  # noqa: E402

SIDES = {"control": {"matmul_format": "fp8"}, "half_batch": {"fraction": 0.5},
         "unchanged": {"frozen": True}}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", type=int, nargs="+", required=True)
    parser.add_argument("--sides", type=int, default=3,
                        help="seeds (the first ones) that also read the control and the fault")
    parser.add_argument("--seconds", type=float, default=2.0)
    args = parser.parse_args()
    cell = harness.load_cell(args.workload)
    for i, seed in enumerate(args.seeds):
        sides = tuple(SIDES.values()) if i < args.sides else ()
        result = harness.run_cell(cell, seed, args.seconds, False, "cuda", sides=sides)
        line = {"seed": seed, "program": {n: v for n, v, _ in result["numbers"]},
                "metrics": {k: m["value"] for k, m in result["metrics"].items()},
                "memory_peak_bytes": result["device"]["memory_peak_bytes"],
                "leaves": result["detail"]}
        for name, numbers in zip(SIDES, result["sides"]):
            line[name] = {n: v for n, v, _ in numbers}
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
