#!/usr/bin/env python3
"""The benchmark of ``elektronn2_tpu_torch`` on NVIDIA H100s: one cell of
``BENCHMARK.json`` a run.

    python3 perfbench/run.py --workload <name> --seed <n> --seconds <s> \\
        --trace <0|1>

From the root of a checkout. Sets up the cell (weights and inputs made on
the card from ``--seed``, every shape warmed up), measures for ``--seconds``
seconds, checks the timed path's outputs against the plain reference, and
prints one JSON object as its last line: ``correct``, ``attempted``,
``failed``, ``metrics`` (the cell's end-to-end metrics, or with ``--trace
1`` its per-layer metrics from a profiled window), ``device`` and, traced,
``breakdown``; last the numbers compared with their limits (``checks``),
which also end standard error. Exits non-zero with no result without the
cards the cell asks for, or when JAX or the JAX package got loaded.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: kernel caches of the program and of PyTorch, at fixed paths inside the
#: checkout, so that only a cell's first run there builds
CACHE = os.path.join(ROOT, ".perfbench_cache")


def card_line():
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable: {e}"


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(CACHE, "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                          os.path.join(CACHE, "torch_extensions"))
    sys.path.insert(0, ROOT)
    import torch

    from perfbench import harness

    try:
        cell = harness.find_cell(harness.load_bench(), args.workload)
    except KeyError as e:
        print(f"perfbench: {e}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell["chips"]:
        print(f"perfbench: {args.workload} needs {cell['chips']} CUDA "
              f"device(s); found {torch.cuda.device_count()}",
              file=sys.stderr)
        return 2
    print(f"perfbench: card {card_line()}", file=sys.stderr)
    result = harness.run_cell(args.workload, args.seed, args.seconds,
                              args.trace, device="cuda", t0=T0)
    bad = harness.forbidden_modules()
    if bad:
        print(f"perfbench: the run loaded {', '.join(bad)}; refusing to "
              "report", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
