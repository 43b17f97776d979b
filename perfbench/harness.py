"""The harness: a cell of ``BENCHMARK.json`` run from its data.

A cell names a configuration (``configs/<config>.json``) and a traffic mix
(``traffic/<traffic>.json``). The mix names its ``driver``
(``drivers/<driver>.py``, one for each entry point), which builds the program from the configuration,
sets it up, runs the measured window and checks the outputs against the
plain reference; it returns a record of the window. Every metric the cell
reports is read from that record by ``metrics/<metric name>.py``. So a new
configuration, mix or metric is a new file and a new entry in
``BENCHMARK.json``, found by its name.
"""

import importlib
import importlib.util
import json
import os
import sys
from types import SimpleNamespace

from . import netspec

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
#: top-level modules that no run may load: JAX and the JAX package
FORBIDDEN = ("jax", "jaxlib", "flax", "elektronn2_tpu", "elektronn2")


def load_bench(path=None):
    with open(path or os.path.join(ROOT, "BENCHMARK.json")) as fh:
        return json.load(fh)


def find_cell(bench, workload):
    for c in bench["workloads"]:
        if c["name"] == workload:
            return c
    raise KeyError(f"no workload {workload!r} in BENCHMARK.json")


def load_module(kind, name):
    """``<kind>/<name>.py`` of the harness as a module (names may hold
    dots, so by path)."""
    path = os.path.join(HERE, kind, f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        f"perfbench_{kind}_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_traffic(name):
    with open(os.path.join(HERE, "traffic", f"{name}.json")) as fh:
        return json.load(fh)


def cell_metrics(bench, workload):
    """(end-to-end, per-layer) metric entries this cell reports."""
    e2e = [m for m in bench["end_to_end"]
           if "workloads" not in m or workload in m["workloads"]]
    names = {m["name"] for m in e2e}
    per = [m for m in bench["per_layer"]
           if (workload in m["workloads"] if "workloads" in m
               else m["moves"] in names)]
    return e2e, per


def forbidden_modules():
    return sorted({k.split(".")[0] for k in list(sys.modules)}
                  & set(FORBIDDEN))


def _merge(base, over):
    out = dict(base)
    for k, v in (over or {}).items():
        out[k] = (_merge(out[k], v) if isinstance(v, dict)
                  and isinstance(out.get(k), dict) else v)
    return out


def run_cell(workload, seed, seconds, trace, device="cuda", t0=None,
             overrides=None, fault=None, bench=None):
    """Run one cell and return its result dict (the last line's object).
    ``overrides`` merges into the traffic mix (the CPU tests shrink it);
    ``fault`` plants a fault in the timed path, or puts the precision
    control in the program's place (``"control"``), for the checks' own
    tests and ``calibrate.py``; each driver names the faults it takes."""
    import time
    t0 = time.perf_counter() if t0 is None else t0
    bench = bench or load_bench()
    c = find_cell(bench, workload)
    cfg = netspec.load_config(c["config"])
    traffic = _merge(load_traffic(c["traffic"]), overrides)
    ctx = SimpleNamespace(net=netspec.Net(cfg), cfg=cfg, traffic=traffic,
                          seed=int(seed), seconds=float(seconds),
                          trace=bool(trace), device=device, t0=t0,
                          fault=fault)
    w = importlib.import_module(
        f"perfbench.drivers.{traffic['driver']}").run(ctx)
    e2e, per = cell_metrics(bench, workload)
    metrics = {}
    for m in (per if trace else e2e):
        v = load_module("metrics", m["name"]).read(w)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    dev = {"platform": "gpu" if device.startswith("cuda") else "cpu",
           "kind": w.device_kind, "count": 1,
           "memory_peak_bytes": w.peak_bytes}
    result = {"correct": bool(w.checks) and w.failed == 0
              and all(v <= lim for _, v, lim in w.checks),
              "attempted": w.attempted, "failed": w.failed,
              "metrics": metrics, "device": dev}
    if trace and w.trace is not None:
        dev["busy_s"] = w.trace.busy_s()
        dev["window_s"] = w.trace.window_s
        result["breakdown"] = {"device_ops": w.trace.top_ops(),
                               "idle_gaps": w.trace.idle_gaps()}
    if getattr(w, "readings", None):
        result["readings"] = w.readings
    result["checks"] = {n: {"value": v, "limit": lim}
                        for n, v, lim in w.checks}
    return result
