"""Probe: which kernels ``torch.profiler`` drops at the start of its window,
as the process ages.

A fixed workload (``LAYERS`` float32 matmuls of ``N``², each followed by a
ReLU: ~100 ms of device work in 2 x ``LAYERS`` launches) is profiled once
fresh, then, after every ``--gap`` seconds of idle, once with no idle margin
inside the window and once with ``--margin`` seconds of idle at each end.
For every profile the script reports the launches whose kernel the device
did not record (a host launch call with no device record under its
correlation id) and where the first recorded kernel starts, in ms after a
host marker at the workload's start (both on the profiler's clock). On
the card the dropped kernels are a prefix of the workload that grows with
the process's age; ``chip_smoke.py::profile_margin`` sizes its margins
from this.

Usage, on the card: ``python -m elektronn2_tpu_torch.scripts.exp_profiler_window
[--rounds 6] [--gap 30] [--margin 0.3]`` (one JSON line per profile, then a
summary line); :func:`main` returns the rows.
"""

from __future__ import annotations

import argparse
import json
import time

import torch

N = 4096
LAYERS = 40
#: the host calls that launch one kernel, which the device records under
#: the same correlation id
LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                "cuLaunchKernelEx")
MARK = "exp_profiler_window.start"


def workload(a, b):
    for _ in range(LAYERS):
        a = torch.relu(a @ b)
    return a


def profiled(fn, margin):
    """One profile of ``fn`` with ``margin`` idle seconds at each end of
    the window: (launches, launches with no device record, ms from the
    start marker to the first recorded kernel)."""
    from torch.profiler import ProfilerActivity, profile, record_function
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        time.sleep(margin)
        with record_function(MARK):
            pass
        fn()
        torch.cuda.synchronize()
        time.sleep(margin)
    events = list(prof.profiler.kineto_results.events())
    mark = next(e.start_ns() for e in events if e.name() == MARK)
    device = {e.correlation_id(): e.start_ns() for e in events
              if str(e.device_type()).endswith("CUDA")}
    launches = [e for e in events if e.name() in LAUNCH_CALLS]
    lost = sum(1 for e in launches if e.correlation_id() not in device)
    first = min((t for t in device.values() if t >= mark), default=None)
    return (len(launches), lost,
            None if first is None else (first - mark) / 1e6)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rounds", type=int, default=6)
    ap.add_argument("--gap", type=float, default=30.0)
    ap.add_argument("--margin", type=float, default=0.3)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("exp_profiler_window: needs a CUDA device")
    t_start = time.monotonic()
    g = torch.Generator(device="cuda").manual_seed(0)
    a = torch.rand((N, N), device="cuda", generator=g)
    b = torch.randn((N, N), device="cuda", generator=g) * (2.0 / N) ** 0.5
    run = lambda: workload(a, b)                            # noqa: E731
    run()
    torch.cuda.synchronize()
    rows = []

    def record(tag, margin):
        n, lost, first_ms = profiled(run, margin)
        row = dict(probe="profiler_window", tag=tag, margin_s=margin,
                   age_s=time.monotonic() - t_start, launches=n,
                   launches_unrecorded=lost,
                   first_recorded_kernel_after_start_ms=first_ms,
                   device=torch.cuda.get_device_name(0))
        print(json.dumps(row), flush=True)
        rows.append(row)
    record("fresh", 0.0)
    for r in range(args.rounds):
        time.sleep(args.gap)
        record(f"round{r}", 0.0)
        record(f"round{r}", args.margin)
    summary = {m: sum(1 for row in rows if row["margin_s"] == m
                      and row["launches_unrecorded"]) for m in
               (0.0, args.margin)}
    print(json.dumps(dict(probe="profiler_window", profiles_with_drops={
        str(m): n for m, n in summary.items()})), flush=True)
    return rows


if __name__ == "__main__":
    main()
