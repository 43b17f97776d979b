#!/usr/bin/env python3
"""The readings that a cell's output limits are set from, in one process:

    python3 perfbench/calibrate.py --workload <name> --seeds 12 \\
        --first <seed> [--seconds 2] [--control 3]

For each of ``--seeds`` seeds from ``--first`` on, one run of the cell with
a short window (``--seconds``); then for ``--control`` seeds the same run
with the precision control (the plain reference with TF32 operands) in the
program's place, and for a training cell with half of the batch left out
and with the float64 reference in the program's place (``float64``: how far
rounding alone carries a chunk; a witness, not a fault), for a tracing
cell with a recorded position moved, a trace cut short and a NaN planted:
the list ``FAULTS`` of the cell's driver. Each is judged by
the harness's own comparison and printed as one JSON object a line with
its ``correct``, the numbers it compared and, for training, every reading.
It runs on the card the cell asks for; the benchmark's own runs never run
it.
"""

import argparse
import importlib
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--first", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--control", type=int, default=3)
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch

    from perfbench import harness
    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 2
    cell = harness.find_cell(harness.load_bench(), args.workload)
    driver = importlib.import_module("perfbench.drivers." + harness.
                                     load_traffic(cell["traffic"])["driver"])
    runs = [(None, args.first + k) for k in range(args.seeds)]
    runs += [(f, args.first + k) for f in driver.FAULTS
             for k in range(args.control)]
    for fault, seed in runs:
        t0 = time.perf_counter()
        r = harness.run_cell(args.workload, seed, args.seconds, 0,
                             fault=fault)
        print(json.dumps({"what": fault or "program", "seed": seed,
                          "correct": r["correct"], "checks": r["checks"],
                          "readings": r.get("readings"),
                          "metrics": r["metrics"],
                          "seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
