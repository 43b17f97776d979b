"""Reduced-precision dense serving of the port against the JAX package, on
the CPU: ``ops.conv.quantized_conv``, ``Model.set_compute_dtype`` (bf16,
float16, int8, ``activations=True``), ``Model.calibrate_int8`` and the int8
sweep's calibration.

Tolerances, port against JAX on the same inputs and weights:
- ``quantized_conv``: bit for bit against the jitted JAX function (the
  same int8 values, exact integer sums, one float32 multiply in both, the
  scales as XLA compiles them).
- int8 dense maps: 5e-2 max-abs on probabilities (the JAX package's own
  int8-vs-float32 bound, tests/test_inference_device.py:396) and argmax
  agreement > 0.99. The float32 activations of the two packages differ by
  one rounding (XLA fuses the dequantising multiply and the bias add into
  one FMA, the port rounds twice), so now and then a value on a rounding
  boundary quantises one step (1/127 of the layer's max-abs) apart, and
  that step reaches the probabilities; with ``activations=True`` the bf16
  store absorbs those differences (1e-5).
- bf16 dense maps: 5e-2 max-abs and argmax agreement > 0.98. The port's
  bf16 conv rounds its output to bf16 (cuDNN's bf16 convs do), where XLA
  keeps the float32 sums, so the two differ by about 2^-9 relative a layer
  (measured 1.6e-2 on the flagship's five convs); the JAX package's
  bf16-vs-float32 bound is 6e-2 (:590).
- float16 dense maps: 3e-3 (10 mantissa bits: 2^-11 relative a layer;
  measured 6.5e-4).
- calibrated scales: rtol 1e-5 (a max over activations that differ by
  float32 sums in another order).
"""

import contextlib
import importlib
import os
import sys

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
import elektronn2_tpu.neuromancer as jnm  # noqa: E402
from __graft_entry__ import _flagship_model  # noqa: E402
from test_data import write_knossos  # noqa: E402
from elektronn2_tpu.ops.conv import quantized_conv as jax_qconv  # noqa: E402
from elektronn2_tpu.ops.conv import upconv as jax_upconv  # noqa: E402
from elektronn2_tpu_torch import neuromancer as tnm  # noqa: E402
from elektronn2_tpu_torch.data.knossos_array import KnossosArray  # noqa: E402
from elektronn2_tpu_torch.neuromancer.model import (  # noqa: E402
    modelload, rebuild_model)
from elektronn2_tpu_torch.ops import tailconv  # noqa: E402
from elektronn2_tpu_torch.ops.conv import (  # noqa: E402
    EXACT_INT8_TERMS, quantized_conv, upconv)
from elektronn2_tpu_torch.utils.convert import (  # noqa: E402
    flagship_model, params_from_jax)

torch.set_num_threads(2)
INT8_ATOL, INT8_ACT_ATOL, BF16_ATOL, F16_ATOL = 5e-2, 1e-5, 5e-2, 3e-3
MODE_TOL = {("int8", False): INT8_ATOL, ("int8", True): INT8_ACT_ATOL,
            ("bfloat16", False): BF16_ATOL, ("bfloat16", True): BF16_ATOL,
            ("float16", False): F16_ATOL}


@contextlib.contextmanager
def graph(package):
    """Build nodes of ``package`` on a fresh GraphManager."""
    gmod = importlib.import_module(f"{package}.neuromancer.graphmanager")
    gm = gmod.GraphManager()
    gmod.push_manager(gm)
    try:
        yield gm
    finally:
        gmod.pop_manager()


def saved_pair(tmp_path, builder, name="m"):
    """(JAX model, the port's model loaded from the JAX model's file)."""
    with graph("elektronn2_tpu") as gm:
        inp, pred = builder(jnm)
        jm = gm.getmodel()
        jm.designate_nodes(input_node=inp, prediction_node=pred)
    fname = str(tmp_path / f"{name}.mdl")
    jm.save(fname)
    return jm, modelload(fname, device="cpu")


def int8_probe(nm):
    """tests/test_inference_device.py::_int8_probe_model."""
    inp = nm.Input([1, 1, 11, 21, 21], "b,f,z,x,y", name="raw")
    c1 = nm.Conv(inp, 6, (1, 3, 3), (1, 2, 2), mfp=True, name="c1")
    c2 = nm.Conv(c1, 8, 3, 2, mfp=True, name="c2")
    return inp, nm.Softmax(nm.Conv(c2, 2, 1, 1, activation_func="lin"))


def faithless_unet3d(nm):
    """tests/test_inference_device.py::faithless_unet3d."""
    inp = nm.Input([1, 1, 8, 16, 16], "b,f,z,x,y", name="raw")
    enc0 = nm.Conv(inp, 4, (1, 3, 3), (1, 1, 1), name="enc0")
    enc1 = nm.Conv(enc0, 8, (3, 3, 3), (1, 2, 2), name="enc1")
    enc2 = nm.Conv(enc1, 8, (3, 3, 3), (1, 1, 1), name="enc2")
    up = nm.UpConv(enc2, 4, (1, 2, 2), activation_func="relu", name="up")
    merged = nm.FaithlessMerge(up, enc0, name="merge")
    dec = nm.Conv(merged, 8, (1, 3, 3), (1, 1, 1), name="dec")
    return inp, nm.Softmax(nm.Conv(dec, 2, 1, 1, activation_func="lin",
                                   name="cls"))


def crop_concat_unet3d(nm):
    """The exact-fov Crop + Concat 3-D U-Net of
    tests/test_inference_device.py:1178."""
    inp = nm.Input([1, 1, 4, 16, 16], "b,f,z,x,y", name="raw")
    c0 = nm.Conv(inp, 4, (1, 3, 3), 1, name="c0")
    c1 = nm.Conv(c0, 8, (1, 3, 3), (1, 2, 2), name="c1")
    c2 = nm.Conv(c1, 8, (1, 3, 3), 1, name="c2")
    up = nm.UpConv(c2, 4, (1, 2, 2), name="up")
    skip = nm.Crop(c0, [(0, 0), (3, 3), (3, 3)], name="skip")
    dec = nm.Conv(nm.Concat([up, skip], name="cat"), 8, (1, 3, 3), 1,
                  name="dec")
    return inp, nm.Softmax(nm.Conv(dec, 2, 1, 1, activation_func="lin",
                                   name="cls"))


@pytest.fixture
def flagship_pair():
    jm = _flagship_model(mfp=True, patch=[11, 27, 27])
    tm = flagship_model(mfp=True, patch=[11, 27, 27], device="cpu")
    tm.set_params(params_from_jax(jm.params, tm))
    return jm, tm


def dense_pair(jm, tm, vol, pad_raw=False):
    """(JAX map, port map) of ``predict_dense_device`` on ``vol``."""
    return (np.asarray(jm.predict_dense_device(jnp.asarray(vol),
                                               pad_raw=pad_raw)),
            tm.predict_dense_device(torch.from_numpy(vol),
                                    pad_raw=pad_raw).numpy())


def agree(a, b):
    return float(np.mean(a.argmax(0) == b.argmax(0)))


@contextlib.contextmanager
def port_log(caplog):
    """Route the port's logger (which does not propagate) into ``caplog``."""
    from elektronn2_tpu_torch.log import logger
    logger.addHandler(caplog.handler)
    try:
        yield
    finally:
        logger.removeHandler(caplog.handler)


# ---------------------------------------------------------- quantized_conv

def _qconv_pair(x, w, jkw=None, tkw=None, bf16=False):
    jx, tx = jnp.asarray(x), torch.from_numpy(x)
    if bf16:
        jx, tx = jx.astype(jnp.bfloat16), tx.to(torch.bfloat16)
    got = quantized_conv(tx, torch.from_numpy(w), **(tkw or {})).numpy()
    # jitted, as the JAX package's dense paths run it: XLA's scale
    # arithmetic (``* float32(1/127)``, one folded ``1/127**2``) is the
    # reference's
    want = np.asarray(jax.jit(lambda a, b: jax_qconv(a, b, **(jkw or {})))(
        jx, jnp.asarray(w)))
    return got, want


@pytest.mark.parametrize("case", ["3d", "2d", "dilated", "upconv",
                                  "x_absmax", "two_groups", "three_groups",
                                  "bf16_input"])
def test_quantized_conv_bit_exact_vs_jax(case):
    rng = np.random.RandomState(len(case))
    kw = {}
    if case == "upconv":
        x = rng.randn(1, 6, 4, 5, 6).astype(np.float32)
        w = rng.randn(3, 6, 1, 2, 2).astype(np.float32)
        got, want = _qconv_pair(
            x, w, dict(conv_fn=jax_upconv, pool_shape=(1, 2, 2)),
            dict(conv_fn=upconv, pool_shape=(1, 2, 2)))
    else:
        cin = {"two_groups": 45, "three_groups": 80}.get(case, 3)
        sp = (9, 10) if case == "2d" else (7, 9, 10)
        k = (3, 3) if case == "2d" else (3, 3, 3)
        x = rng.randn(2, cin, *sp).astype(np.float32)
        w = rng.randn(5, cin, *k).astype(np.float32)
        if case == "dilated":
            kw = dict(dilation=(1, 2, 2))
        if case == "x_absmax":               # a calibrated scale that clips
            kw = dict(x_absmax=float(np.float32(0.6 * np.abs(x).max())))
        if case in ("two_groups", "three_groups"):
            groups = -(-cin * 27 // (EXACT_INT8_TERMS // 27 * 27))
            assert groups == {"two_groups": 2, "three_groups": 3}[case]
        got, want = _qconv_pair(x, w, kw, kw, bf16=case == "bf16_input")
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def test_quantized_conv_matches_manual():
    """tests/test_inference_device.py:927 on the port: the manual int8
    quantisation with the scales as XLA compiles the reference's (each
    ``/ 127`` a multiply by float32(1/127), ``s_x * s_w`` one multiply by
    float32(1/127**2)), an exact (float64) integer conv and one float32
    multiply; and it tracks the float32 conv within quantisation error."""
    rng = np.random.RandomState(11)
    x = rng.randn(2, 3, 8, 9).astype(np.float32)
    w = rng.randn(5, 3, 3, 3).astype(np.float32)
    got = quantized_conv(torch.from_numpy(x), torch.from_numpy(w)).numpy()
    m_x = np.float32(np.abs(x).max())
    m_w = np.abs(w).max(axis=(1, 2, 3))
    s_x = m_x * np.float32(1 / 127)
    s_w = m_w * np.float32(1 / 127)
    xq = np.clip(np.round(x / s_x), -127, 127)
    wq = np.clip(np.round(w / s_w[:, None, None, None]), -127, 127)
    yq = torch.nn.functional.conv2d(torch.from_numpy(xq).double(),
                                    torch.from_numpy(wq).double()).numpy()
    want = yq.astype(np.float32) * (m_w * (m_x * np.float32(1 / 127 ** 2))
                                    )[None, :, None, None]
    np.testing.assert_array_equal(got, want)
    ref = torch.nn.functional.conv2d(torch.from_numpy(x),
                                     torch.from_numpy(w)).numpy()
    assert np.abs(got - ref).max() < 0.05 * np.abs(ref).max() + 0.05


def test_quantized_conv_worst_case_is_exact():
    """Every operand +-127 with aligned signs: 80 x 27 products of 127^2
    sum to 34 836 640, past 2^24, so the groups must add in int32; the
    result equals the JAX package's and the exact integer sum bit for
    bit."""
    x = np.ones((1, 80, 5, 6, 7), np.float32)
    x[:, ::2] = -1.0
    w = np.ones((4, 80, 3, 3, 3), np.float32)
    w[:, ::2] = -1.0
    got, want = _qconv_pair(x, w)
    np.testing.assert_array_equal(got, want)
    exact = np.float32(80 * 27 * 127 * 127) * (
        np.float32(1.0) / np.float32(127.0)) ** 2
    assert 80 * 27 * 127 * 127 > 2 ** 24
    np.testing.assert_array_equal(got, np.full_like(got, exact))


def test_quantized_conv_sharded_scale_not_ported():
    # the sharded scale (ported): on a mesh of one, the all_reduce(MAX) of
    # the dynamic scale over one axis or a tuple of axes leaves the result
    # bit for bit the unsharded one, a masked scale given as a tensor is
    # reduced too, and a number (a calibrated scale) is taken as it is; an
    # axis name without its mesh, or one the mesh lacks, raises
    from torch_dp_workers import mesh_of_one
    r = np.random.RandomState(2)
    x = torch.from_numpy(r.randn(1, 3, 6, 7, 8).astype(np.float32))
    w = torch.from_numpy(r.randn(4, 3, 3, 3, 3).astype(np.float32))
    want = quantized_conv(x, w)
    with mesh_of_one({"data": 1, "space": 1}) as mesh:
        for axes in ("space", ("data", "space")):
            assert torch.equal(quantized_conv(x, w, axis_name=axes,
                                              mesh=mesh), want)
        s = torch.tensor(0.5)
        assert torch.equal(
            quantized_conv(x, w, x_absmax=s, axis_name="space", mesh=mesh),
            quantized_conv(x, w, x_absmax=0.5))
        with pytest.raises(ValueError, match="no axis 'model'"):
            quantized_conv(x, w, axis_name="model", mesh=mesh)
    with pytest.raises(ValueError, match="needs the mesh"):
        quantized_conv(x, w, axis_name="space")


# ------------------------------------------------------ the dense modes

@pytest.mark.parametrize("mode, act", sorted(MODE_TOL))
def test_dilated_modes_match_jax(flagship_pair, mode, act):
    jm, tm = flagship_pair
    raw = np.random.RandomState(0).randn(1, 15, 34, 37).astype(np.float32)
    jm.set_compute_dtype(mode, activations=act)
    tm.set_compute_dtype(mode, activations=act)
    want, got = dense_pair(jm, tm, raw)
    assert got.dtype == np.float32 and got.shape == want.shape
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=MODE_TOL[mode, act], rtol=0)
    assert agree(got, want) > (0.98 if mode == "bfloat16" else 0.99)


@pytest.mark.parametrize("mode, act", [("int8", False), ("int8", True),
                                       ("bfloat16", False)])
def test_convdense_modes_match_jax(tmp_path, mode, act):
    jm, tm = saved_pair(tmp_path, faithless_unet3d)
    vol = np.random.RandomState(4).rand(1, 10, 20, 20).astype(np.float32)
    jm.set_compute_dtype(mode, activations=act)
    tm.set_compute_dtype(mode, activations=act)
    want, got = dense_pair(jm, tm, vol, pad_raw=True)
    # the conv-dense path stores no narrow activations: act changes nothing
    np.testing.assert_allclose(got, want, rtol=0, atol=(
        BF16_ATOL if mode == "bfloat16" else INT8_ATOL))
    assert agree(got, want) > 0.98


@pytest.mark.parametrize("builder, vol_shape", [
    (int8_probe, (1, 16, 28, 28)), (faithless_unet3d, (1, 10, 20, 20))])
def test_calibrated_scales_and_maps_match_jax(tmp_path, builder, vol_shape):
    """The dilated leg (the MFP probe) and the conv-dense leg (the U-Net,
    UpConv included) of calibrate_int8: the scales equal JAX's (rtol
    1e-5), and the calibrated maps equal JAX's calibrated maps."""
    jm, tm = saved_pair(tmp_path, builder)
    vol = np.random.RandomState(8).rand(*vol_shape).astype(np.float32)
    jm.set_compute_dtype("int8")
    tm.set_compute_dtype("int8")
    want = jm.calibrate_int8(jnp.asarray(vol))
    got = tm.calibrate_int8(torch.from_numpy(vol))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5)
    a, b = dense_pair(jm, tm, vol, pad_raw=True)
    np.testing.assert_allclose(b, a, atol=INT8_ATOL, rtol=0)
    assert agree(a, b) > 0.99
    with pytest.raises(ValueError, match="rank"):
        tm.calibrate_int8(torch.rand(1, 1, 1, 4, 4, 4))
    tm.set_compute_dtype(None)
    assert tm._quant_scales is None
    with pytest.raises(ValueError, match="set_compute_dtype"):
        tm.calibrate_int8(torch.from_numpy(vol))


# ----------------------------------- the JAX package's bounds, on the port

def test_bf16_serving_mode_deviation_bound(flagship_pair):
    """tests/test_inference_device.py:590 on the port: bf16 serving within
    6e-2 of the float32 route, argmax > 0.95, bf16 storage within 5e-3 of
    plain bf16."""
    _, m = flagship_pair
    raw = torch.from_numpy(
        np.random.RandomState(1).randn(1, 15, 34, 37).astype(np.float32))
    f32 = m.predict_dense_device(raw).numpy()
    m.set_compute_dtype("bfloat16")
    bf16 = m.predict_dense_device(raw).numpy()
    assert bf16.shape == f32.shape
    assert float(np.max(np.abs(bf16 - f32))) < 0.06
    assert agree(bf16, f32) > 0.95
    m.set_compute_dtype("bfloat16", activations=True)
    e2e = m.predict_dense_device(raw).numpy()
    assert float(np.max(np.abs(e2e - bf16))) < 5e-3


def test_int8_serving_deviation_bound(tmp_path):
    """:880 on the port (its one lowering, 'direct'): int8 within 5e-2 of
    float32, argmax > 0.97."""
    _, m = saved_pair(tmp_path, int8_probe)
    vol = torch.from_numpy(
        np.random.RandomState(2).rand(1, 16, 28, 28).astype(np.float32))
    ref = m.predict_dense_device(vol, pad_raw=True).numpy()
    m.set_compute_dtype("int8")
    q = m.predict_dense_device(vol, pad_raw=True).numpy()
    assert float(np.abs(q - ref).max()) < 0.05
    assert agree(q, ref) > 0.97


def test_int8_bf16_store_deviation_bound(tmp_path):
    """:901 on the port: int8 with bf16 storage within 5e-2 of float32,
    argmax > 0.97, float32 maps, within 2e-2 of plain int8."""
    _, m = saved_pair(tmp_path, int8_probe)
    vol = torch.from_numpy(
        np.random.RandomState(3).rand(1, 16, 28, 28).astype(np.float32))
    ref = m.predict_dense_device(vol, pad_raw=True).numpy()
    m.set_compute_dtype("int8")
    plain = m.predict_dense_device(vol, pad_raw=True).numpy()
    m.set_compute_dtype("int8", activations=True)
    q = m.predict_dense_device(vol, pad_raw=True).numpy()
    assert q.dtype == np.float32
    assert float(np.abs(q - ref).max()) < 0.05
    assert agree(q, ref) > 0.97
    assert float(np.abs(q - plain).max()) < 0.02


def test_int8_mode_guards(tmp_path):
    """:949 on the port: an unknown dtype names the known ones; int8 and
    the ztap/zmajor lowerings refuse each other both ways, with the JAX
    package's ValueErrors; int8 takes 'direct' and 's2bg' with zfold."""
    jm, m = saved_pair(tmp_path, int8_probe)
    with pytest.raises(ValueError, match="expected None"):
        m.set_compute_dtype("float8")
    for model in (jm, m):
        model.set_dilated_impl("direct", ztap="native")
        with pytest.raises(ValueError, match="disable ztap/zmajor first"):
            model.set_compute_dtype("int8")
        model.set_dilated_impl("direct", zmajor=True)
        with pytest.raises(ValueError, match="disable ztap/zmajor first"):
            model.set_compute_dtype("int8")
        model.set_dilated_impl("direct")
        model.set_compute_dtype("int8")
        for kw in (dict(ztap="native"), dict(zmajor=True)):
            with pytest.raises(ValueError, match="not available in int8"):
                model.set_dilated_impl("s2bg", **kw)
        for impl in ("direct", "s2bg"):
            model.set_dilated_impl(impl, zfold=True)
            assert model._compute_dtype == "int8"
            assert model._dilated_impl == impl
    vol = torch.from_numpy(
        np.random.RandomState(3).rand(1, 16, 28, 28).astype(np.float32))
    got = m.predict_dense_device(vol, pad_raw=True).numpy()
    want = np.asarray(jm.predict_dense_device(jnp.asarray(vol.numpy()),
                                              pad_raw=True))
    assert float(np.abs(got - want).max()) < INT8_ATOL


def test_k1_steps_aside_off_float32(monkeypatch):
    """Under bf16, float16, int8 and int8 calibration K1's wrapper is never
    called, on the dilated and the conv-dense path; at float32 it is."""
    from elektronn2_tpu_torch.neuromancer import neural
    from elektronn2_tpu_torch.utils.convert import wide_unet_model
    calls = []
    orig = tailconv.conv3x3_dilated

    def counting(*a, **kw):
        calls.append(1)
        return orig(*a, **kw)
    monkeypatch.setattr(tailconv, "conv3x3_dilated", counting)
    monkeypatch.setattr(neural, "conv3x3_dilated", counting)
    fm = flagship_model(mfp=True, patch=[9, 41, 41], device="cpu")
    fm.set_dilated_impl("direct", zfold=True, pallas_tail=True)
    um = wide_unet_model(widths=(4, 8, 16), device="cpu")
    um.set_convdense_impl(zfold=True, skipsum=True, ptail=True)
    for m, vol in ((fm, torch.rand(1, 12, 40, 40)),
                   (um, torch.rand(1, 18, 70, 74))):
        for mode in ("bfloat16", "float16", "int8"):
            m.set_compute_dtype(mode, activations=mode == "int8")
            m.predict_dense_device(vol, pad_raw=True)
        m.calibrate_int8(vol)
        assert not calls
        m.set_compute_dtype(None)
        m.predict_dense_device(vol, pad_raw=True)
        assert calls
        calls.clear()


def test_int8_training_stays_f32():
    """:962 on the port: int8 is a dense-serving mode; training runs the
    float32 trace (losses equal the float32 run's exactly) and the
    parameters stay float32."""
    def build():
        with graph("elektronn2_tpu_torch") as gm:
            inp = tnm.Input([2, 1, 16, 16], "b,f,x,y", name="raw")
            c1 = tnm.Conv(inp, 8, 3, 2, name="c1")
            probs = tnm.Softmax(tnm.Conv(c1, 2, 1, 1, activation_func="lin"))
            tgt = tnm.Input([2, *probs.shape.spatial_shape], "b,x,y",
                            dtype="int32", name="target")
            loss = tnm.AggregateLoss(tnm.MultinoulliNLL(
                probs, tgt, target_is_sparse=True))
            m = gm.getmodel()
            m.designate_nodes(input_node=inp, target_node=tgt,
                              loss_node=loss, prediction_node=probs)
        m.set_opt("SGD", lr=1e-2)
        return m
    rng = np.random.RandomState(5)
    x = torch.from_numpy(rng.randn(2, 1, 16, 16).astype(np.float32))
    m1 = build()
    osz = m1.prediction_node.shape.spatial_shape[0]
    y = (x[:, 0, :osz, :osz] > 0).to(torch.int32)
    m2 = build()
    m2.set_params({n: {k: v.clone() for k, v in d.items()}
                   for n, d in m1.params.items()})
    m2.set_compute_dtype("int8")
    ref = [float(m1.trainingstep(x, y)[0]) for _ in range(3)]
    got = [float(m2.trainingstep(x, y)[0]) for _ in range(3)]
    assert got == ref
    assert m2.params["c1"]["w"].dtype == torch.float32


def test_int8_unet_conv_dense_bound(tmp_path):
    """:1005 on the port: int8 on the conv-dense path within 1e-1 of
    float32, argmax > 0.95; patch prediction stays float32-exact."""
    _, m = saved_pair(tmp_path, faithless_unet3d)
    rng = np.random.RandomState(6)
    vol = torch.from_numpy(rng.rand(1, 10, 20, 20).astype(np.float32))
    ref = m.predict_dense_device(vol, pad_raw=True).numpy()
    m.set_compute_dtype("int8")
    q = m.predict_dense_device(vol, pad_raw=True).numpy()
    assert q.shape == ref.shape
    assert float(np.abs(q - ref).max()) < 0.1
    assert agree(q, ref) > 0.95
    m.set_compute_dtype(None)
    x = torch.from_numpy(rng.rand(1, 1, 8, 16, 16).astype(np.float32))
    p_ref = m.predict(x)
    m.set_compute_dtype("int8")
    assert torch.equal(m.predict(x), p_ref)


# ------------------------------------------------------------- int8 sweeps

@pytest.mark.parametrize("builder, shape, steps", [
    (int8_probe, (24, 32, 32), ([12, 16, 16], [24, 32, 16])),
    (crop_concat_unet3d, (8, 24, 24), ([4, 12, 12], [8, 24, 12]))])
def test_int8_calibrated_sweep_is_seam_free(tmp_path, builder, shape, steps):
    """:1141 (the dilated path) and :1178 (the conv-dense path, UpConv
    calibrated) on the port: the sweep calibrates on its first slab, and
    then equals the whole-volume int8 map exactly, for any slab grid."""
    _, m = saved_pair(tmp_path, builder)
    m.set_compute_dtype("int8")
    vol = (np.random.RandomState(7).rand(*shape) * 255).astype(np.uint8)
    ka = KnossosArray(write_knossos(tmp_path, vol, cube_edge=8))
    out = m.sweep_knossos(ka, step=steps[0])
    assert m._quant_scales
    if builder is crop_concat_unet3d:
        assert "up" in m._quant_scales
    volf = torch.from_numpy(vol[None].astype(np.float32) / 255.0)
    np.testing.assert_array_equal(
        out, m.predict_dense_device(volf, pad_raw=True).numpy())
    np.testing.assert_array_equal(m.sweep_knossos(ka, step=steps[1]), out)


def test_int8_sweep_calibration_catches_only_oom(tmp_path, monkeypatch,
                                                 caplog):
    """The sweep's calibration goes on with per-dispatch scales only when
    the device runs out of memory; any other error reaches the caller."""
    _, m = saved_pair(tmp_path, int8_probe)
    m.set_compute_dtype("int8")
    vol = (np.random.RandomState(9).rand(12, 24, 24) * 255).astype(np.uint8)
    ka = KnossosArray(write_knossos(tmp_path, vol, cube_edge=8))

    def oom(_):
        raise torch.cuda.OutOfMemoryError("simulated")
    monkeypatch.setattr(m, "calibrate_int8", oom)
    with port_log(caplog):
        out = m.sweep_knossos(ka, step=[12, 24, 24])
    assert "ran out of device memory" in caplog.text
    assert not m._quant_scales and np.isfinite(out).all()

    def broken(_):
        raise RuntimeError("a kernel failed")
    monkeypatch.setattr(m, "calibrate_int8", broken)
    with pytest.raises(RuntimeError, match="a kernel failed"):
        m.sweep_knossos(ka, step=[12, 24, 24])


def test_int8_tiled_fallback_warns(caplog):
    """:1162 on the port: int8 on a graph only the tiled fallback serves
    (batch norm without running statistics) runs float32 there, warns
    once, and the map is finite; calibrating such a graph names why not."""
    with graph("elektronn2_tpu_torch") as gm:
        inp = tnm.Input([1, 1, 21, 21], "b,f,x,y", name="raw")
        c1 = tnm.Conv(inp, 4, 3, 2, mfp=True, name="c1")
        probs = tnm.Softmax(tnm.Conv(tnm.BatchNorm(c1), 2, 1, 1,
                                     activation_func="lin"))
        m = gm.getmodel()
        m.designate_nodes(input_node=inp, prediction_node=probs)
    m.set_compute_dtype("int8")
    raw = torch.from_numpy(
        np.random.RandomState(10).randn(1, 27, 27).astype(np.float32))
    with port_log(caplog):
        out = m.predict_dense_device(raw)
    assert torch.isfinite(out).all()
    assert getattr(m, "_warned_int8_tiled", False)
    assert "overlap-tiled fallback" in caplog.text
    with pytest.raises(ValueError, match="neither whole-volume"):
        m.calibrate_int8(raw)


def test_rebuild_carries_the_serving_precision(tmp_path):
    """rebuild_model carries the compute dtype, the activation storage and
    the int8 calibration, as the JAX package's does."""
    _, m = saved_pair(tmp_path, int8_probe)
    m.set_compute_dtype("int8", activations=True)
    m.calibrate_int8(torch.rand(1, 16, 28, 28))
    new = rebuild_model(m, imposed_patch_size=[15, 29, 29])
    assert new._compute_dtype == "int8" and new._compute_act
    assert new._quant_scales == m._quant_scales


def test_reduced_precision_guards_training_nodes():
    """bf16/float16 reach the Perceptron's matmul too (its operands and
    product in that type, the result float32, within the type's rounding of
    float32); int8 leaves every node trace float32."""
    with graph("elektronn2_tpu_torch") as gm:
        inp = tnm.Input([2, 6], "b,f", name="raw")
        d = tnm.Perceptron(inp, 4, name="dot")
        m = gm.getmodel()
        m.designate_nodes(input_node=inp, prediction_node=d)
    x = torch.rand(2, 6)
    f32 = m.predict(x)
    for dt in ("bfloat16", "float16"):
        m.set_compute_dtype(dt)
        y = m.predict(x)
        assert y.dtype == torch.float32 and not torch.equal(y, f32)
        torch.testing.assert_close(y, f32, rtol=2e-2, atol=2e-2)
    m.set_compute_dtype("int8")
    x = torch.rand(2, 6)
    y = m.predict(x)
    m.set_compute_dtype(None)
    assert torch.equal(y, m.predict(x))
