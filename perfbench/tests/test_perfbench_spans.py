"""The readers of the program's spans: ``pool_ms.dense``,
``glue_ms.dense``, ``stage_wait_ms.sweep`` and ``write_wait_ms.sweep``, on
hand-built traces (nested spans, a kernel under no node span, spans past
the window, a program without the spans) and in traced CPU runs of the
cells that report them."""

from types import SimpleNamespace

import pytest

from perfbench import harness
from perfbench.tests.tiny import SEED, TINY
from perfbench.trace import WINDOW_SPAN, Trace

MAIN, OTHER = 1, 2


def read(name, w):
    return harness.load_module("metrics", name).read(w)


def dense_trace(spans=True):
    """One request (ns): the entry 0-1000 with a pad kernel of its own;
    node ``c0`` 100-400 holding a pool (its kernel 30 ns) beside the conv
    (50 ns); node ``c2`` 400-900 with K1 (300 ns) under its launch op."""
    host = [(WINDOW_SPAN, 0, 2000, MAIN, 1),
            ("perfbench.request", 0, 1000, MAIN, 2),
            ("aten::reflection_pad3d", 10, 20, MAIN, 4),
            ("aten::conv2d", 110, 150, MAIN, 6),
            ("aten::max_pool2d", 210, 250, MAIN, 8),
            ("tailconv.launch", 500, 520, MAIN, 10),
            ("cudaLaunchKernel", 505, 515, MAIN, 99)]
    if spans:
        host += [("predict_dense_device", 5, 990, MAIN, 3),
                 ("dense/c0", 100, 400, MAIN, 5),
                 ("dense.pool", 200, 300, MAIN, 7),
                 ("dense/c2", 400, 900, MAIN, 9)]
    device = [("pad_kernel", 1000, 1020, "kernel", 4),
              ("conv_kernel", 1020, 1070, "kernel", 6),
              ("max_pool_kernel", 1070, 1100, "kernel", 8),
              ("tailconv_tc_kernel<8, 0>", 1100, 1400, "kernel", 10),
              ("Memcpy DtoD", 1400, 1410, "memcpy", 0)]
    return SimpleNamespace(trace=Trace(device, host, (0, 2000)), requests=1)


def test_pool_reads_the_kernels_under_the_pool_spans():
    assert read("pool_ms.dense", dense_trace()) == pytest.approx(30e-6)


def test_glue_reads_the_kernels_under_no_node_span():
    w = dense_trace()
    assert read("glue_ms.dense", w) == pytest.approx(20e-6)
    # the node spans and the glue close on the window's kernel time
    nodes = w.trace.under_host_op(lambda n: n.startswith("dense/"))
    assert {e[0] for e in nodes} == {"conv_kernel", "max_pool_kernel",
                                     "tailconv_tc_kernel<8, 0>"}
    assert sum(e[2] - e[1] for e in nodes) + 20 == \
        sum(e[2] - e[1] for e in w.trace.kernels())


def test_dense_readers_read_nothing_without_the_spans():
    w = dense_trace(spans=False)
    assert read("pool_ms.dense", w) is None
    assert read("glue_ms.dense", w) is None
    w.trace = None
    assert read("pool_ms.dense", w) is None


def sweep_trace(spans=True):
    """Two passes (ms) in a window 10-110: the first pass's wait_stage
    starts before the window; the drain of the second ends past it; a
    worker thread's span and another thread's wait are not the main
    thread's. The card is busy 0-25 (into the first wait_stage), 42-52
    (across a wait_write and a drain), 61-62 and 105-120."""
    ms = 1_000_000
    host = [(WINDOW_SPAN, 10 * ms, 110 * ms, MAIN, 1)]
    if spans:
        host += [("sweep_knossos.wait_stage", 0, 30 * ms, MAIN, 2),
                 ("sweep_knossos.wait_stage", 60 * ms, 64 * ms, MAIN, 3),
                 ("sweep_knossos.wait_write", 40 * ms, 45 * ms, MAIN, 4),
                 ("sweep_knossos.drain", 50 * ms, 58 * ms, MAIN, 5),
                 ("sweep_knossos.drain", 100 * ms, 130 * ms, MAIN, 6),
                 ("sweep_knossos.stage", 20 * ms, 90 * ms, OTHER, 7),
                 ("sweep_knossos.wait_stage", 20 * ms, 90 * ms, OTHER, 8)]
    device = [("k", 0, 25 * ms, "kernel", 0),
              ("k", 42 * ms, 50 * ms, "kernel", 0),
              ("Memcpy DtoH", 48 * ms, 52 * ms, "memcpy", 0),
              ("k", 61 * ms, 62 * ms, "kernel", 0),
              ("k", 105 * ms, 120 * ms, "kernel", 0)]
    return SimpleNamespace(trace=Trace(device, host, (10 * ms, 110 * ms)),
                           attempted=2)


def test_sweep_waits_read_the_device_idle_inside_the_main_threads_spans():
    w = sweep_trace()
    # wait_stage: 10-30 less 10-25 busy, 60-64 less 61-62
    assert read("stage_wait_ms.sweep", w) == pytest.approx((5 + 3) / 2)
    # wait_write 40-45 less 42-45; drains 50-58 less 50-52, 100-110 less
    # 105-110
    assert read("write_wait_ms.sweep", w) == pytest.approx((2 + 6 + 5) / 2)
    # an idle card: the spans' whole length inside the window
    w.trace.device = []
    assert read("stage_wait_ms.sweep", w) == pytest.approx((20 + 4) / 2)
    assert read("write_wait_ms.sweep", w) == pytest.approx((5 + 8 + 10) / 2)


def test_sweep_readers_read_nothing_without_the_spans():
    w = sweep_trace(spans=False)
    assert read("stage_wait_ms.sweep", w) is None
    assert read("write_wait_ms.sweep", w) is None


@pytest.mark.parametrize("workload,names", [
    ("neuro3d.dense_request", ("pool_ms.dense", "glue_ms.dense")),
    ("unet3d_wide.dense_slab", ("pool_ms.dense", "glue_ms.dense")),
    ("neuro3d.sweep", ("stage_wait_ms.sweep", "write_wait_ms.sweep"))])
def test_a_traced_cpu_run_reports_the_span_metrics(workload, names):
    r = harness.run_cell(workload, SEED, 0.3, 1, device="cpu",
                         overrides=TINY[workload])
    assert r["correct"], r["checks"]
    for n in names:
        assert r["metrics"][n]["value"] is not None, n
