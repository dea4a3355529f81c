#!/usr/bin/env python3
"""The benchmark of mla_tpu_torch on one NVIDIA card. From the root of a
checkout:

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Runs one cell of BENCHMARK.json: builds its weights and inputs from the
seed on the card, warms up, measures for the given seconds, checks what the
timed path produced against the plain reference, and prints one JSON result
line last on standard output (``--trace 0``: the cell's end-to-end metrics;
``--trace 1``: its per-layer metrics, under torch.profiler). Exits non-zero,
printing no result, without the card the cell needs.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path[0] = str(ROOT)  # the checkout, not this folder: modules import as benchmark.*


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args()
    from benchmark import core

    return core.main(args, T_START)


if __name__ == "__main__":
    sys.exit(main())
