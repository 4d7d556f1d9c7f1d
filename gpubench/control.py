"""The control of ``correct``: the reference computed in float32, put in the
port's place, must come out not correct.

For each seed it makes the cell's input, works out the float64 reference and
the float32 one, writes the float32 calls as the port would (the CSV and, for
a fit, its diagnostic lines) and compares them with the float64 reference by
the numbers that decide ``correct``. It needs no card:

    python3 -m gpubench.control --workload local.chrom17M --seeds 1 2 3
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

from gpubench import harness
from gpubench.reference import check
from gpubench.traffic import generate


def readings(cell: dict, seed: int) -> dict:
    """The numbers the float32 control reads on the cell's input for
    ``seed``."""
    data = generate.make_pileup(cell["traffic"], seed)
    options = cell["config"]["options"]
    parsed = check.parse(options, data)
    exp = check.expected(options, *parsed)
    if check.needs_reads(options):  # the reads' terms and their sums in float32 too
        parsed = check.parse(options, data, np.float32)
    ctl = check.expected(options, *parsed, dtype=np.float32)
    csv = check.HEADER + b"\n" + check.render(ctl, check.class_text(ctl.classes, ctl.conf_type))
    return check.compare(csv, check.fit_lines(ctl), exp)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="python3 -m gpubench.control")
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", type=int, nargs="+", required=True)
    args = parser.parse_args(argv)
    cell = harness.find_cell(harness.load_spec(), args.workload)
    limits = cell["config"]["limits"]
    for seed in args.seeds:
        t = time.time()
        numbers = readings(cell, seed)
        correct = all(numbers[k] <= limits[k] for k in limits)
        print(json.dumps({"workload": args.workload, "seed": seed, "control_correct": correct,
                          "numbers": numbers, "limits": limits, "seconds": time.time() - t}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
