"""Nothing the benchmark runs loads JAX or the JAX package, and the plain
reference loads nothing of the program; top-level names compared whole
(the port's name begins with the JAX package's)."""

import json
import os
import subprocess
import sys

from perfbench.harness import FORBIDDEN, ROOT


def loaded_after(code):
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys, json\nprint(json.dumps("
         "sorted({k.split('.')[0] for k in sys.modules})))"],
        cwd=ROOT, capture_output=True, text=True, timeout=600,
        env=dict(os.environ, PYTHONPATH=ROOT))
    assert out.returncode == 0, out.stderr[-2000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_run_and_reference_import_no_jax():
    mods = loaded_after("import perfbench.run, perfbench.harness, "
                        "perfbench.calibrate, perfbench.reference.nets, "
                        "perfbench.reference.train, "
                        "perfbench.reference.tracer, "
                        "perfbench.drivers.tracer")
    assert not mods & set(FORBIDDEN)


def test_reference_imports_nothing_of_the_program():
    mods = loaded_after("import perfbench.reference.nets, "
                        "perfbench.reference.train, "
                        "perfbench.reference.augment, "
                        "perfbench.reference.tracer")
    assert "elektronn2_tpu_torch" not in mods
    assert not mods & set(FORBIDDEN)


def test_a_whole_cpu_run_loads_no_jax():
    mods = loaded_after(
        "from perfbench import harness\n"
        "from perfbench.tests.tiny import TINY, SEED\n"
        "r = harness.run_cell('neuro3d.train_fused', SEED, 0.3, 0, "
        "device='cpu', overrides=TINY['neuro3d.train_fused'])\n"
        "assert r['correct'], r")
    assert "elektronn2_tpu_torch" in mods
    assert not mods & set(FORBIDDEN)


def test_run_refuses_without_a_card():
    out = subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload",
         "neuro3d.dense_request", "--seed", "1", "--seconds", "1"],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    import torch
    if torch.cuda.is_available():
        return
    assert out.returncode != 0 and out.stdout.strip() == ""
