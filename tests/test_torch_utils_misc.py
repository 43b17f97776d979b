"""The port's copies of the JAX package's jax-free utils, its profile CLI
and its profiling and device helpers, after tests/test_utils_misc.py:12-131,
on the CPU."""

import os
import pickle
import threading
import time

import numpy as np
import pytest
import torch

from elektronn2_tpu_torch import neuromancer as tnm
from elektronn2_tpu_torch.neuromancer import graphmanager

torch.set_num_threads(2)


def small_model(gm_name="misc"):
    gm = graphmanager.GraphManager(gm_name)
    graphmanager.push_manager(gm)
    try:
        inp = tnm.Input([1, 1, 9, 9], "b,f,x,y", name="raw")
        c1 = tnm.Conv(inp, 4, 3, 1, name="c1")
        probs = tnm.Softmax(c1)
        m = gm.getmodel()
        m.designate_nodes(input_node=inp, prediction_node=probs)
    finally:
        graphmanager.pop_manager()
    return m


def test_file_lock(tmp_path):
    from elektronn2_tpu_torch.utils.locking import FileLock, FileLockException
    target = str(tmp_path / "file.bin")
    with FileLock(target, timeout=1):
        assert os.path.exists(target + ".lock")
        with pytest.raises(FileLockException):
            FileLock(target, timeout=0.2).acquire()
    assert not os.path.exists(target + ".lock")


def test_file_lock_concurrent(tmp_path):
    from elektronn2_tpu_torch.utils.locking import FileLock
    target = str(tmp_path / "c.bin")
    order = []

    def worker(i):
        with FileLock(target, timeout=5):
            order.append(("in", i))
            time.sleep(0.05)
            order.append(("out", i))

    ts = [threading.Thread(target=worker, args=(i,)) for i in range(3)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    for k in range(0, 6, 2):            # critical sections never interleave
        assert order[k][0] == "in" and order[k + 1][0] == "out"
        assert order[k][1] == order[k + 1][1]


def test_legacy_param_import(tmp_path):
    from elektronn2_tpu_torch.utils.legacy import (import_params,
                                                   load_legacy_params)
    m = small_model()
    legacy_w = np.random.RandomState(0).randn(4, 1, 3, 3).astype(np.float32)
    with open(tmp_path / "old.pkl", "wb") as f:
        pickle.dump({"c1": {"w": legacy_w, "b": np.zeros(4, np.float32)}}, f)
    import_params(m, load_legacy_params(str(tmp_path / "old.pkl")))
    np.testing.assert_array_equal(m.params["c1"]["w"].numpy(), legacy_w)
    assert m.params["c1"]["w"].dtype == torch.float32


def test_d3viz(tmp_path):
    from elektronn2_tpu_torch.utils.d3viz import visualise_model
    path = visualise_model(small_model(), str(tmp_path / "graph.html"))
    html = open(path).read()
    assert "raw" in html and "Softmax" in html and "prediction" in html


def test_console_completer():
    from elektronn2_tpu_torch.utils.ptk_completions import ConsoleCompleter
    c = ConsoleCompleter()
    assert c.complete("p", 0) in ("pause", "preview")
    assert c.complete("lr", 0) == "lr"
    assert c.complete("zz", 0) is None


def test_profile_cli_matches_jax_columns(tmp_path):
    """``elektronn2-torch-profile`` on a JAX-saved model: the JAX CLI's
    columns and one row a size, the port's sizes snapped alike."""
    import csv
    import elektronn2_tpu.neuromancer as jnm
    from elektronn2_tpu.scripts.profile import main as jax_main
    from elektronn2_tpu_torch.scripts.profile import main
    gmod = __import__("elektronn2_tpu.neuromancer.graphmanager",
                      fromlist=["x"])
    gm = gmod.GraphManager()
    gmod.push_manager(gm)
    try:
        inp = jnm.Input([1, 1, 16, 16], "b,f,x,y", name="raw")
        c1 = jnm.Conv(inp, 4, 3, 1, name="c1")
        probs = jnm.Softmax(jnm.Conv(c1, 2, 1, 1, activation_func="lin"))
        m = gm.getmodel()
        m.designate_nodes(input_node=inp, prediction_node=probs)
    finally:
        gmod.pop_manager()
    mdl = str(tmp_path / "m.mdl")
    m.save(mdl)
    a, b = str(tmp_path / "jax.csv"), str(tmp_path / "port.csv")
    jax_main([mdl, "--sizes", "16,24", "--out", a, "--cpu"])
    assert main([mdl, "--sizes", "16,24", "--out", b, "--cpu"]) == 0
    want, got = [list(csv.DictReader(open(f))) for f in (a, b)]
    assert len(got) == len(want) == 2
    assert list(got[0]) == list(want[0])
    assert [r["size"] for r in got] == [r["size"] for r in want]
    assert all(float(r["predict_s"]) > 0 and float(r["pred_Mvox_s"]) > 0
               for r in got)


def test_profile_cli_times_trainingstep(tmp_path):
    """A model with a loss and a target gets a ``trainingstep_s`` column;
    a size below the net's smallest patch snaps up to it."""
    from elektronn2_tpu_torch.neuromancer.model import simple_cnn
    from elektronn2_tpu_torch.scripts.profile import main
    m = simple_cnn(1, 1, 2, [16, 16], [3, 3], [1, 1], [4, 4], ndim=2)
    mdl = str(tmp_path / "t.mdl")
    m.save(mdl)
    out = str(tmp_path / "t.csv")
    assert main([mdl, "--sizes", "12", "--out", out, "--cpu"]) == 0
    lines = open(out).read().strip().splitlines()
    assert lines[0] == "size,predict_s,pred_Mvox_s,trainingstep_s"
    assert main([mdl, "--sizes", "2", "--out", out, "--cpu"]) == 0
    assert open(out).read().splitlines()[1].startswith("2,")


def test_reexport_modules_are_the_same_objects():
    import importlib
    from elektronn2_tpu_torch.neuromancer import computations
    conv = importlib.import_module("elektronn2_tpu_torch.ops.conv")
    mfp = importlib.import_module("elektronn2_tpu_torch.ops.mfp")
    from elektronn2_tpu_torch.training.trainutils import pretty_string_time
    from elektronn2_tpu_torch.utils import basic, utils_basic
    for name in computations.__all__:
        src = mfp if hasattr(mfp, name) and name.startswith(
            ("fragment", "mfp")) else conv
        assert getattr(computations, name) is getattr(src, name), name
    assert computations.upsampling is conv.unpooling
    for name in utils_basic.__all__:
        want = (pretty_string_time if name == "pretty_string_time"
                else getattr(basic, name))
        assert getattr(utils_basic, name) is want, name


def test_gpu_helpers_on_the_cpu():
    from elektronn2_tpu_torch.utils import gpu
    assert gpu.initgpu("cpu") == torch.device("cpu")
    assert gpu.initgpu("none") == torch.device("cpu")
    if not torch.cuda.is_available():
        assert gpu.get_free_gpu() == -1
        with pytest.raises(RuntimeError, match="no CUDA device"):
            gpu.initgpu("auto")


def test_profiling_helpers(tmp_path, monkeypatch):
    from elektronn2_tpu_torch.utils import cuda_build, native_build, profiling
    x, w = torch.rand(1, 3, 10, 10), torch.rand(4, 3, 3, 3)
    conv = torch.nn.functional.conv2d
    cost = profiling.cost_analysis(conv, x, w)
    assert cost["flops"] == 2 * 4 * 3 * 9 * 8 * 8      # 2 x the MACs
    dt = profiling.benchmark(conv, x, w, n_warmup=1, n_runs=2)
    rate, dt2 = profiling.flops_per_second(conv, cost["flops"], x, w,
                                           n_warmup=1, n_runs=2)
    assert dt > 0 and dt2 > 0 and rate == pytest.approx(cost["flops"] / dt2)
    with profiling.trace(str(tmp_path / "tr")) as prof:
        conv(x, w)
    assert prof is not None and os.listdir(tmp_path / "tr")
    monkeypatch.setattr(cuda_build, "BUILD_DIR", cuda_build.BUILD_DIR)
    monkeypatch.setattr(native_build, "BUILD_DIR", native_build.BUILD_DIR)
    d = profiling.enable_compile_cache(str(tmp_path / "kcache"))
    assert d == cuda_build.BUILD_DIR == native_build.BUILD_DIR
    assert os.path.isdir(d)
