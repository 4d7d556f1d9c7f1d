"""Run one cell of the benchmark once:

    python3 -m gpubench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

Exits 2 without a result where the cell's CUDA devices are missing.
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="python3 -m gpubench.run")
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    from gpubench import harness

    return harness.main(parser.parse_args(argv))


if __name__ == "__main__":
    sys.exit(main())
