"""The port's host spans (``utils/profiling.py``): one ``dense/<node>``
span a node of the dense paths inside ``predict_dense_device``, with
``dense.pool`` inside the pooled nodes; the sweep's spans on its main
thread and, under ``profiling.trace``, on its worker threads, one a
chunk; ``timings`` as before; nothing while no profiler runs."""

import json
import os
import threading

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from elektronn2_tpu_torch import neuromancer as nm
from elektronn2_tpu_torch.data.knossos_array import KnossosArray, save_knossos
from elektronn2_tpu_torch.neuromancer import inference
from elektronn2_tpu_torch.utils import profiling

torch.set_num_threads(2)


def dilated_model():
    """An MFP graph of the dilated path: a pooled Conv, a standalone Pool,
    a (3,3,3) ReLU conv (K1's) and the classifier."""
    nm.model_manager.reset(seed=0)
    inp = nm.Input([1, 1, 9, 25, 25], "b,f,z,x,y", name="raw")
    c0 = nm.Conv(inp, 3, (1, 3, 3), (1, 2, 2), mfp=True, name="c0")
    p1 = nm.Pool(c0, (1, 2, 2), mfp=True, name="p1")
    c2 = nm.Conv(p1, 4, (3, 3, 3), (1, 1, 1), mfp=True, name="c2")
    cls = nm.Conv(c2, 2, (1, 1, 1), (1, 1, 1), activation_func="lin",
                  name="cls")
    probs = nm.Softmax(cls, name="probs")
    m = nm.model_manager.getmodel("dilated")
    m.designate_nodes(input_node=inp, prediction_node=probs)
    m.set_dilated_impl("direct", zfold=True, pallas_tail=True)
    return m, {"c0", "p1"}


def decoder_model():
    """A FaithlessMerge 3D U-Net of the conv-dense path, ``enc1`` pooled."""
    nm.model_manager.reset(seed=0)
    inp = nm.Input([1, 1, 8, 16, 16], "b,f,z,x,y", name="raw")
    enc0 = nm.Conv(inp, 4, (1, 3, 3), (1, 1, 1), name="enc0")
    enc1 = nm.Conv(enc0, 8, (3, 3, 3), (1, 2, 2), name="enc1")
    enc2 = nm.Conv(enc1, 8, (3, 3, 3), (1, 1, 1), name="enc2")
    up = nm.UpConv(enc2, 4, (1, 2, 2), activation_func="relu", name="up")
    merged = nm.FaithlessMerge(up, enc0, name="merge")
    dec = nm.Conv(merged, 8, (1, 3, 3), (1, 1, 1), name="dec")
    probs = nm.Softmax(nm.Conv(dec, 2, 1, 1, activation_func="lin",
                               name="cls"), name="probs")
    m = nm.model_manager.getmodel("decoder")
    m.designate_nodes(input_node=inp, prediction_node=probs)
    m.set_convdense_impl(zfold=True, skipsum=True, ptail=True)
    return m, {"enc1"}


def host_spans(fn):
    """Run ``fn`` under ``torch.profiler``: its result and the host events
    ``[(name, start, end, thread)]`` in start order."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    ev = sorted(((e.name(), e.start_ns(), e.start_ns() + e.duration_ns(),
                  e.start_thread_id())
                 for e in prof.profiler.kineto_results.events()),
                key=lambda e: e[1])
    return out, ev


def inside(inner, outer):
    return outer[1] <= inner[1] and inner[2] <= outer[2]


def evaluated_nodes(model):
    """The nodes each path evaluates, in graph order: all of them, but a
    merge that every consumer fuses (``skipsum``)."""
    order = model.prediction_node.all_parents()
    if inference._dilated_unsupported(model.prediction_node,
                                      model.state) is None:
        return [n.name for n in order]
    ctx = inference._convdense_ctx(model, {})
    fused = {n.parents[0].name for n in order
             if isinstance(n, nm.Conv) and n._fuses_merge(ctx)}
    return [n.name for n in order if n.name not in fused]


@pytest.mark.parametrize("build", [dilated_model, decoder_model],
                         ids=["dilated", "decoder"])
def test_dense_paths_open_a_span_a_node(build):
    model, pooled = build()
    vol = torch.rand(1, 12, 40, 40)
    want = model.predict_dense_device(vol, pad_raw=True)
    got, ev = host_spans(lambda: model.predict_dense_device(vol,
                                                            pad_raw=True))
    assert torch.equal(got, want)
    entry = [e for e in ev if e[0] == "predict_dense_device"]
    assert len(entry) == 1
    nodes = [e for e in ev if e[0].startswith(profiling.NODE_SPAN)]
    names = [e[0][len(profiling.NODE_SPAN):] for e in nodes]
    assert names == evaluated_nodes(model)
    assert all(inside(n, entry[0]) for n in nodes)
    pools = [e for e in ev if e[0] == profiling.POOL_SPAN]
    assert pools
    holders = set()
    for p in pools:
        holder = [n for n in nodes if inside(p, n)]
        assert len(holder) == 1, p
        holders.add(holder[0][0][len(profiling.NODE_SPAN):])
    assert holders == pooled


def knossos_sweep(tmp_path, timings, step=(4, 12, 12)):
    model, _ = dilated_model()
    rng = np.random.RandomState(0)
    vol = rng.randint(0, 256, (8, 24, 24)).astype(np.uint8)
    path = str(tmp_path / "ds")
    if not os.path.isdir(path):
        save_knossos(vol, path, exp_name="raw", cube_edge=16)
    return lambda: model.sweep_knossos(KnossosArray(path), step=list(step),
                                       timings=timings)


def test_sweep_spans_on_the_main_thread(tmp_path):
    plain = {}
    want = knossos_sweep(tmp_path, plain)()
    timings = {}
    got, ev = host_spans(knossos_sweep(tmp_path, timings))
    np.testing.assert_array_equal(got, want)
    # timings as before: one entry a chunk, the same chunks
    n_chunks = len(plain["slabs"])
    assert n_chunks == 8
    assert {k: len(v) for k, v in timings.items()} == \
        {k: len(v) for k, v in plain.items()} == \
        {"stage_s": n_chunks, "write_s": n_chunks, "slabs": n_chunks}
    assert timings["slabs"] == plain["slabs"]
    call = [e for e in ev if e[0] == "sweep_knossos"]
    assert len(call) == 1
    main = call[0][3]
    mine = [e for e in ev if e[0].startswith("sweep_knossos.")]
    count = {}
    for e in mine:
        assert e[3] == main and inside(e, call[0])
        count[e[0]] = count.get(e[0], 0) + 1
    # the default profiler records the main thread alone
    assert count == {"sweep_knossos.wait_stage": n_chunks,
                     "sweep_knossos.enqueue": n_chunks,
                     "sweep_knossos.wait_write": n_chunks - 2,
                     "sweep_knossos.drain": 1}
    assert inference.WRITE_DEPTH == 2
    enq = [e for e in ev if e[0] == "sweep_knossos.enqueue"]
    for e in enq:      # each chunk's forward inside its enqueue span
        assert any(inside(p, e) for p in ev
                   if p[0] == "predict_dense_device")


def test_trace_records_the_worker_threads_one_span_a_chunk(tmp_path):
    run = knossos_sweep(tmp_path, {})
    with profiling.trace(str(tmp_path / "tr")):
        run()
    (f,) = os.listdir(tmp_path / "tr")
    with open(tmp_path / "tr" / f) as fh:
        ev = sorted((e for e in json.load(fh)["traceEvents"]
                     if str(e.get("name", "")).startswith("sweep_knossos")
                     and e.get("ph") == "X"), key=lambda e: e["ts"])

    def spans(name):
        return [e for e in ev if e["name"] == name]

    main = {e["tid"] for e in spans("sweep_knossos")}
    enq = spans("sweep_knossos.enqueue")
    assert len(enq) == 8 and {e["tid"] for e in enq} == main
    stage, write = spans("sweep_knossos.stage"), spans("sweep_knossos.write")
    for got in (stage, write):
        tids = {e["tid"] for e in got}
        assert len(got) == 8 and len(tids) == 1 and not tids & main
    # chunk n: staged before it is enqueued, written after
    for s, q, w in zip(stage, enq, write):
        assert s["ts"] + s["dur"] <= q["ts"] <= q["ts"] + q["dur"] <= w["ts"]


def test_trace_alone_records_another_threads_span(tmp_path):
    """The default profiler leaves a span opened on another thread out;
    ``profiling.trace`` records it."""
    def work():
        with profiling.span("worker.span"):
            torch.ones(64).sum()

    def in_thread():
        t = threading.Thread(target=work)
        t.start()
        t.join()

    _, ev = host_spans(in_thread)
    assert "worker.span" not in {e[0] for e in ev}
    with profiling.trace(str(tmp_path / "tr")):
        with profiling.span("main.span"):
            in_thread()
    (f,) = os.listdir(tmp_path / "tr")
    with open(tmp_path / "tr" / f) as fh:
        tid = {e["name"]: e["tid"] for e in json.load(fh)["traceEvents"]
               if e.get("name") in ("worker.span", "main.span")}
    assert set(tid) == {"worker.span", "main.span"}
    assert tid["worker.span"] != tid["main.span"]


def test_no_profiler_no_span():
    assert not torch.autograd.profiler._is_profiler_enabled
    assert profiling.span("dense/x") is profiling._OFF
    assert profiling.span("sweep_knossos.stage") is profiling._OFF
    assert profiling.launch_op("tailconv.launch") is profiling._OFF
    with profile(activities=[ProfilerActivity.CPU]):
        assert profiling.span("dense/x") is not profiling._OFF
        assert profiling.launch_op("x") is not profiling._OFF


@pytest.mark.cuda
def test_k1_kernels_fall_under_their_node_span():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: K1 has no CPU kernel")
    model, _ = dilated_model()
    model.to(torch.device("cuda"))
    vol = torch.rand(1, 12, 40, 40, device="cuda")
    model.predict_dense_device(vol, pad_raw=True)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        model.predict_dense_device(vol, pad_raw=True)
        torch.cuda.synchronize()
    ops, k1 = {}, []
    for e in prof.profiler.kineto_results.events():
        if str(e.device_type()).endswith("CUDA"):
            if "tailconv_tc_kernel" in e.name():
                k1.append(e.linked_correlation_id())
        elif not e.name().startswith("cu"):
            ops[e.correlation_id()] = (e.name(), e.start_ns(),
                                       e.start_ns() + e.duration_ns())
    node = [v for v in ops.values() if v[0] == "dense/c2"]
    assert len(k1) == 1 and len(node) == 1
    launch = ops[k1[0]]
    assert launch[0] == "tailconv.launch" and inside(launch, node[0])

