"""The serving autotune of the port (``tune_sweep``, ``Model.tune_serving``)
on the CPU: tests/test_inference_device.py:725-880 and :992 ported, the
port's grid, which failures become a row and which reach the caller, and
the rows' largest-map field.

On the CPU the timings mean nothing; the tests hold the protocol: the grid,
the restore, the applied winner, the values after applying it (1e-5 for a
float32 winner, the bf16 bound 5e-2 otherwise, as the JAX test does).
"""

import contextlib
import importlib
import math

import numpy as np
import pytest
import torch

from elektronn2_tpu_torch import neuromancer as tnm
from elektronn2_tpu_torch.neuromancer import inference as tinf
from elektronn2_tpu_torch.neuromancer import neural
from elektronn2_tpu_torch.neuromancer.inference import (
    DEFAULT_TUNE_STEPS_3D, INT32_ELEMENTS, _largest_map, tune_sweep)
from elektronn2_tpu_torch.ops import tailconv
from elektronn2_tpu_torch.utils.cnncalculator import cnncalculator
from elektronn2_tpu_torch.utils.convert import flagship_model, wide_unet_model

torch.set_num_threads(2)


@contextlib.contextmanager
def graph():
    gmod = importlib.import_module(
        "elektronn2_tpu_torch.neuromancer.graphmanager")
    gm = gmod.GraphManager()
    gmod.push_manager(gm)
    try:
        yield gm
    finally:
        gmod.pop_manager()


def designated(gm, inp, pred):
    m = gm.getmodel()
    m.designate_nodes(input_node=inp, prediction_node=pred)
    return m


def mfp_model():
    """tests/test_inference_device.py::mfp_model."""
    n = cnncalculator([3, 3], [2, 2], desired_patch_size=21, mfp=True,
                      ndim=1).input
    with graph() as gm:
        inp = tnm.Input([1, 1, n, n], "b,f,x,y", name="raw")
        c1 = tnm.Conv(inp, 4, 3, 2, mfp=True, name="c1")
        c2 = tnm.Conv(c1, 2, 3, 2, mfp=True, name="c2")
        return designated(gm, inp, tnm.Softmax(c2))


def crop_concat_unet():
    """tests/test_inference_device.py::crop_concat_unet."""
    with graph() as gm:
        inp = tnm.Input([1, 1, 16, 16], "b,f,x,y", name="raw")
        c0 = tnm.Conv(inp, 4, 3, 1, name="c0")
        c1 = tnm.Conv(c0, 8, 3, 2, name="c1")
        c2 = tnm.Conv(c1, 8, 3, 1, name="c2")
        up = tnm.UpConv(c2, 4, 2, name="up")
        skip = tnm.Crop(c0, [(3, 3), (3, 3)], name="skip")
        dec = tnm.Conv(tnm.Concat([up, skip], name="cat"), 8, 3, 1,
                       name="dec")
        return designated(gm, inp, tnm.Softmax(tnm.Conv(
            dec, 2, 1, 1, activation_func="lin", name="cls")))


def probe3d():
    with graph() as gm:
        inp = tnm.Input([1, 1, 11, 21, 21], "b,f,z,x,y", name="raw")
        c1 = tnm.Conv(inp, 6, (1, 3, 3), (1, 2, 2), mfp=True, name="c1")
        c2 = tnm.Conv(c1, 8, 3, 2, mfp=True, name="c2")
        return designated(gm, inp, tnm.Softmax(
            tnm.Conv(c2, 2, 1, 1, activation_func="lin")))


def ok_rows(res):
    return [r for r in res["table"] if "mvox_s" in r]


def test_tune_sweep_measures_grid_and_restores():
    """:725 on the port: the grid x slab batches, the fastest row, the
    settings restored without ``apply``, the winner applied with it."""
    m = mfp_model()
    m.set_dilated_impl("direct")
    res = tune_sweep(m, steps=[(8, 8)], slab_batches=(1, 2), K=2,
                     verbose=False)
    ok = ok_rows(res)
    assert len(ok) == 12                   # 6 contenders x 2 slab batches
    assert res["best"]["mvox_s"] == max(r["mvox_s"] for r in ok) > 0
    assert (m._dilated_impl, m._dilated_zfold, m._dilated_ptail,
            m._compute_dtype) == ("direct", False, False, None)
    b = tune_sweep(m, steps=[(8, 8)], slab_batches=(1,), K=1, apply=True,
                   verbose=False)["best"]
    assert (m._dilated_impl, m._dilated_zfold, m._dilated_ptail,
            m._compute_dtype, m._compute_act) == (
        b["impl"], b["zfold"], b["ptail"], b["dtype"], b["act"])


def test_tune_sweep_rejects_wrong_rank_step():
    with pytest.raises(ValueError, match="spatial dims"):
        tune_sweep(mfp_model(), steps=[(8, 8, 8)], verbose=False)


def test_tune_sweep_routes_decoder_graphs_to_convdense_leg():
    """:759 on the port: a decoder graph tunes the conv-dense grid (six
    contenders), restores without ``apply``, applies with it, and takes
    (upconv, zfold, dtype) lowerings."""
    m = crop_concat_unet()
    res = tune_sweep(m, steps=[(8, 8)], slab_batches=(1, 2), K=2,
                     verbose=False)
    best = res["best"]
    assert best["path"] == "convdense" and best["mvox_s"] > 0
    assert len(ok_rows(res)) == 12
    assert (m._convdense_upconv, m._convdense_zfold, m._compute_dtype) == (
        "dilate", False, None)
    b2 = tune_sweep(m, steps=[(8, 8)], slab_batches=(1,), K=1, apply=True,
                    verbose=False)["best"]
    assert (m._convdense_upconv, m._convdense_zfold, m._compute_dtype) == (
        b2["upconv"], b2["zfold"], b2["dtype"])
    m.set_convdense_impl()
    m.set_compute_dtype(None)
    res3 = tune_sweep(m, steps=[(8, 8)], slab_batches=(1,), K=1,
                      lowerings=[("d2s", True, None)], verbose=False)
    assert any(r["upconv"] == "d2s" and r["zfold"] and "mvox_s" in r
               for r in res3["table"])
    assert len(res3["table"]) <= 2          # requested + the incumbent


def test_tune_sweep_tiled_only_graph_returns_none():
    """:792 on the port: a graph only the tiled fallback serves has nothing
    to tune."""
    with graph() as gm:
        inp = tnm.Input([1, 1, 16, 16], "b,f,x,y", name="raw")
        g = tnm.GaussianRV(tnm.Conv(inp, 4, 3, 2, name="c1"),
                           tnm.Conv(inp, 4, 3, 2, name="c1b"), name="grv")
        m = designated(gm, inp, tnm.Softmax(tnm.Conv(
            g, 2, 1, 1, activation_func="lin")))
    with pytest.raises(ValueError):
        tinf.check_conv_dense_supported(m.prediction_node)
    res = tune_sweep(m, steps=[(8, 8)], slab_batches=(1,), K=1,
                     verbose=False)
    assert res["best"] is None


def test_tuned_config_preserves_dense_values():
    """:816 on the port: the applied winner changes speed, not voxels
    (1e-5 for a float32 winner, 5e-2 for a lossy one)."""
    m = mfp_model()
    vol = torch.from_numpy(
        np.random.RandomState(0).rand(1, 24, 24).astype(np.float32))
    ref = m.predict_dense_device(vol, pad_raw=True)
    res = tune_sweep(m, steps=[(8, 8)], slab_batches=(1,), K=1, apply=True,
                     verbose=False)
    got = m.predict_dense_device(vol, pad_raw=True)
    tol = 1e-5 if res["best"]["dtype"] is None else 0.05
    assert float((got - ref).abs().max()) < tol


def test_tune_sweep_incumbent_competes_and_wins_restore():
    """:837 on the port: the model's own full knob set (here bf16 with
    narrow storage) is a measured contender, restored whole without
    ``apply``; ``apply`` leaves the winner's whole set."""
    m = probe3d()
    m.set_dilated_impl("direct", zfold=True)
    m.set_compute_dtype("bfloat16", activations=True)
    res = tune_sweep(m, steps=[(6, 10, 10)], slab_batches=(1,), K=1,
                     verbose=False)
    assert any(r["dtype"] == "bfloat16" and r["act"] and r["zfold"]
               for r in ok_rows(res))
    assert (m._dilated_zfold, m._compute_dtype, m._compute_act) == (
        True, "bfloat16", True)
    b = tune_sweep(m, steps=[(6, 10, 10)], slab_batches=(1,), K=1,
                   apply=True, verbose=False)["best"]
    assert (m._dilated_impl, m._dilated_zfold, m._compute_dtype,
            m._compute_act, m._dilated_ptail) == (
        b["impl"], b["zfold"], b["dtype"], b["act"], b["ptail"])


def test_tune_sweep_includes_int8_contender():
    """:992 on the port, and the calibration kept across a tune."""
    m = probe3d()
    res = tune_sweep(m, steps=[(6, 10, 10)], slab_batches=(1,), K=1,
                     verbose=False)
    assert any(r["dtype"] == "int8" and r["act"] for r in ok_rows(res))
    res2 = tune_sweep(m, steps=[(6, 10, 10)], slab_batches=(1,), K=1,
                      include_int8=False, include_bf16=False, verbose=False)
    assert all(r["dtype"] is None for r in res2["table"])
    m.set_compute_dtype("int8")
    scales = m.calibrate_int8(torch.rand(1, 12, 24, 24))
    tune_sweep(m, steps=[(6, 10, 10)], slab_batches=(1,), K=1,
               verbose=False)
    assert m._compute_dtype == "int8" and m._quant_scales == scales


def test_port_grid_mapping():
    """The dilated grid is the JAX package's whole: six contenders in its
    order, none a failed row; a ``lowerings`` list is run as given, its
    s2bg and ztap contenders included, and the incumbent is restored."""
    m = probe3d()
    res = tune_sweep(m, steps=[(6, 10, 10)], slab_batches=(1,), K=1,
                     verbose=False)
    got = [(r["impl"], r["zfold"], r["dtype"], r["act"], r["ptail"])
           for r in res["table"]]
    assert got == [("direct", False, None, False, False),
                   ("s2bg", False, None, False, False),
                   ("direct", True, None, False, True),
                   ("s2bg", False, "bfloat16", False, False),
                   ("s2bg", True, "bfloat16", False, False),
                   ("s2bg", True, "int8", True, False)]
    assert not [r for r in res["table"] if "failed" in r]
    res = tune_sweep(m, steps=[(6, 10, 10)], slab_batches=(1,), K=1,
                     lowerings=[("s2bg", True, "bfloat16"),
                                ("direct", False, None, "native")],
                     verbose=False)
    assert [(r["impl"], r["ztap"]) for r in res["table"]] == [
        ("direct", False), ("s2bg", False), ("direct", "native")]
    assert all("mvox_s" in r for r in res["table"])
    assert m._dilated_impl == "direct"          # the incumbent, restored
    assert res["best"] is not None


def test_k1_error_in_a_contender_reaches_the_caller(monkeypatch):
    """A contender whose K1 call raises is not a row: the error reaches the
    caller (a broken K1 would otherwise quietly hand its place to cuDNN),
    and the settings are restored."""
    def broken(*a, **kw):
        raise RuntimeError("tail conv kernel launch failed: CUDA error 719")
    monkeypatch.setattr(tailconv, "conv3x3_dilated", broken)
    monkeypatch.setattr(neural, "conv3x3_dilated", broken)
    m = flagship_model(mfp=True, patch=[9, 41, 41], device="cpu")
    with pytest.raises(RuntimeError, match="launch failed"):
        tune_sweep(m, steps=[(6, 16, 16)], slab_batches=(1,), K=1,
                   verbose=False)
    assert not m._dilated_ptail and m._compute_dtype is None
    u = wide_unet_model(widths=(4, 8, 16), device="cpu")
    with pytest.raises(RuntimeError, match="launch failed"):
        tune_sweep(u, steps=[(8, 16, 16)], slab_batches=(1,), K=1,
                   verbose=False)
    assert not u._convdense_ptail


@pytest.mark.parametrize("what", ["out_of_memory", "non_finite_lossy",
                                  "non_finite_float32", "other_error"])
def test_which_failures_become_rows(monkeypatch, what):
    """Out of memory, and a non-finite checksum from a bf16 or int8
    contender, become failed rows; a non-finite float32 result, or any
    other error, reaches the caller."""
    m = probe3d()
    real = tinf._sweep_forward

    def forward(model, batched):
        f = real(model, batched)

        def g(x):
            lossy = model._compute_dtype is not None
            if what == "out_of_memory" and lossy:
                raise torch.cuda.OutOfMemoryError("simulated")
            if what == "other_error" and lossy:
                raise ValueError("a shape error")
            y = f(x)
            if what.startswith("non_finite") and (
                    lossy == (what == "non_finite_lossy")):
                y = y * float("nan")
            return y
        return g
    monkeypatch.setattr(tinf, "_sweep_forward", forward)
    kw = dict(steps=[(6, 10, 10)], slab_batches=(1,), K=1, verbose=False)
    if what == "other_error":
        with pytest.raises(ValueError, match="shape error"):
            tune_sweep(m, **kw)
    elif what == "non_finite_float32":
        with pytest.raises(FloatingPointError, match="float32 contender"):
            tune_sweep(m, **kw)
    else:
        res = tune_sweep(m, **kw)
        failed = [r for r in res["table"] if "failed" in r]
        assert [r["dtype"] for r in failed] == ["bfloat16", "bfloat16",
                                                 "int8"]
        assert res["best"]["dtype"] is None
    assert m._compute_dtype is None


def test_rows_record_the_largest_map():
    """Every row carries its largest activation map in elements and
    whether it passes 2^31: for the MFP probe the larger of its two
    pre-pool conv maps, counted by hand; at full width the wide U-Net's
    (128, 512, 512) slab passes 2^31 (PERF.md §5's cliff) and its
    (128, 448, 448) slab, with skipsum, does not; slab_batch multiplies."""
    m = probe3d()
    res = tune_sweep(m, steps=[(6, 10, 10)], slab_batches=(1, 2), K=1,
                     include_bf16=False, include_int8=False, verbose=False)
    fov = m.prediction_node.shape.fov
    M = tinf._valid_period(m.prediction_node, 3)
    halo = [-(-((f - 1) // 2) // a) * a + f - 1 - (f - 1) // 2
            for f, a in zip(fov, M)]          # the sweep's staging halo
    Z, X, Y = [s + h for s, h in zip(res["table"][0]["step"], halo)]
    want = max(6 * Z * (X - 2) * (Y - 2), 8 * (Z - 2) * (X - 7) * (Y - 7))
    for r in res["table"]:
        assert r["largest_map"] == r["slab_batch"] * want
        assert r["past_2_31"] is False
    u = wide_unet_model(device="cpu")
    u.set_convdense_impl(zfold=True, skipsum=True, ptail=True)
    assert _largest_map(u, "convdense", (136, 543, 543), 1) > INT32_ELEMENTS
    assert _largest_map(u, "convdense", (136, 479, 479), 1) <= INT32_ELEMENTS
    assert _largest_map(u, "convdense", (136, 479, 479), 2) == \
        2 * _largest_map(u, "convdense", (136, 479, 479), 1)
    assert len(DEFAULT_TUNE_STEPS_3D) == 4
    assert math.prod(DEFAULT_TUNE_STEPS_3D[-1]) == 128 * 512 * 512


def test_model_tune_serving_applies():
    m = probe3d()
    res = m.tune_serving(steps=[(6, 10, 10)], slab_batches=(1,), K=1,
                         include_bf16=False, include_int8=False,
                         verbose=False)
    b = res["best"]
    assert b["dtype"] is None and m._dilated_ptail == b["ptail"]
