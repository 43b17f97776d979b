"""The PyTorch port imports without jax.

``tests/conftest.py`` imports jax into every test process, so the check runs
in a fresh interpreter.
"""

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

MODULES = [
    "elektronn2_tpu_torch",
    "elektronn2_tpu_torch.log",
    "elektronn2_tpu_torch.utils",
    "elektronn2_tpu_torch.utils.cnncalculator",
    "elektronn2_tpu_torch.utils.cuda_build",
    "elektronn2_tpu_torch.utils.convert",
    "elektronn2_tpu_torch.ops",
    "elektronn2_tpu_torch.ops.activations",
    "elektronn2_tpu_torch.ops.conv",
    "elektronn2_tpu_torch.ops.mfp",
    "elektronn2_tpu_torch.ops.tailconv",
    "elektronn2_tpu_torch.neuromancer",
    "elektronn2_tpu_torch.neuromancer.graphutils",
    "elektronn2_tpu_torch.neuromancer.graphmanager",
    "elektronn2_tpu_torch.neuromancer.variables",
    "elektronn2_tpu_torch.neuromancer.node_basic",
    "elektronn2_tpu_torch.neuromancer.neural",
    "elektronn2_tpu_torch.neuromancer.loss",
    "elektronn2_tpu_torch.neuromancer.model",
    "elektronn2_tpu_torch.neuromancer.inference",
]


def _run(code):
    env = dict(os.environ, PYTHONPATH=REPO)
    return subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)


def test_every_module_imports_without_jax():
    code = ("import importlib, sys\n"
            f"for m in {MODULES!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = sorted(k for k in sys.modules\n"
            "             if k == 'jax' or k.startswith('jax.')\n"
            "             or k == 'elektronn2_tpu'\n"
            "             or k.startswith('elektronn2_tpu.'))\n"
            "assert not bad, bad\n"
            "print('ok')\n")
    res = _run(code)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"


def test_flagship_builds_and_runs_without_jax():
    # the whole slice (graph, dense path, kernel wrapper on CPU) stays
    # jax-free when it runs, not only when it is imported
    code = ("import sys, torch\n"
            "torch.set_num_threads(1)\n"
            "from elektronn2_tpu_torch.utils.convert import flagship_model\n"
            "m = flagship_model(mfp=True, patch=[9, 41, 41])\n"
            "m.set_dilated_impl('direct', zfold=True, pallas_tail=True)\n"
            "y = m.predict_dense_device(torch.rand(1, 7, 30, 30), pad_raw=True)\n"
            "assert tuple(y.shape) == (2, 7, 30, 30), y.shape\n"
            "assert 'jax' not in sys.modules\n"
            "print('ok')\n")
    res = _run(code)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"


def test_package_source_names_no_jax():
    # no module of the port imports jax or the JAX package
    root = os.path.join(REPO, "elektronn2_tpu_torch")
    offenders = []
    for dirpath, _, files in os.walk(root):
        for f in files:
            if not f.endswith(".py"):
                continue
            p = os.path.join(dirpath, f)
            with open(p) as fh:
                for i, line in enumerate(fh, 1):
                    s = line.strip()
                    if (s.startswith(("import jax", "from jax"))
                            or s.startswith("import elektronn2_tpu ")
                            or s.startswith("import elektronn2_tpu.")
                            or s.startswith("from elektronn2_tpu ")
                            or s.startswith("from elektronn2_tpu.")):
                        offenders.append(f"{p}:{i}: {s}")
    assert not offenders, offenders
