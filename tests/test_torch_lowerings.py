"""The dilated path's lowerings in the port against the JAX package, on the
CPU: ``Model.set_dilated_impl``'s ``impl`` ('direct', 's2b', 's2bg'),
``zfold``, ``ztap`` (five modes), ``zmajor`` and ``poolslice``; the ops
behind them (``ops.conv``'s space-to-batch split and merge, ``conv_s2b``,
``pool_s2b``, ``conv_ztap``); bf16 and int8 under s2bg; a sharded request
with s2bg set; the JAX guards and errors; the tuner's six-contender grid.

Models: a narrow flagship (the flagship's four convs and pools at widths
4/6/8/8, then the 1x1 barrier to 2 and the softmax) and the 2-D MFP probe
of tests/test_inference_device.py, built in the JAX package and loaded by
the port through ``Model.save``. Inputs from numpy seeds.

Tolerances:
- float32 lowerings: 1e-5 on probabilities against the JAX package's same
  lowering and against the port's own 'direct' (float32 sums in another
  order; the JAX test holds each lowering to 'direct' at 2e-5).
- ops: 1e-5 (float32 sums in another order); the splits, the merge and
  the pools are moves and maxima, held bit for bit.
- bf16 under s2bg: the port's bf16 mode bound of test_torch_quant.py,
  5e-2 and argmax agreement > 0.98 (the port's bf16 conv rounds its output
  to bf16, XLA keeps the float32 sums).
- int8 under s2bg: the logits bit for bit the port's own direct int8
  logits (the same integer sums in another layout; the softmax of the CPU
  rounds a last bit by the tensor's shape); JAX's s2bg int8 map is JAX's
  direct int8 map bit for bit, and the port's is held to it at 1e-5, with
  and without ``activations=True`` (1.2e-7 measured), its bf16-stored
  logits (``activations=True``) bit for bit. The scales are XLA's
  arithmetic in both (``ops.conv.quantized_conv``); what is left is one
  rounding: XLA fuses the dequantising multiply and the bias add into one
  FMA, the port rounds twice (float32 logits 1.9e-6 apart here).
"""

import contextlib
import importlib
import os
import sys

import numpy as np
import pytest
import torch
import jax.numpy as jnp

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "tests"))
import elektronn2_tpu.neuromancer as jnm  # noqa: E402
from elektronn2_tpu.utils.cnncalculator import cnncalculator  # noqa: E402
from elektronn2_tpu_torch import neuromancer as tnm  # noqa: E402
from elektronn2_tpu_torch.neuromancer import computations  # noqa: E402
from elektronn2_tpu_torch.neuromancer import inference as tinf  # noqa: E402
from elektronn2_tpu_torch.neuromancer.inference import (  # noqa: E402
    UnsupportedGraphError, tune_sweep)
from elektronn2_tpu_torch.neuromancer.model import modelload  # noqa: E402
from elektronn2_tpu_torch.ops import tailconv  # noqa: E402

# the ops modules (their packages export the function ``conv`` by that name)
jconv = importlib.import_module("elektronn2_tpu.ops.conv")
tconv = importlib.import_module("elektronn2_tpu_torch.ops.conv")
torch.set_num_threads(2)
ATOL = 1e-5
BF16_ATOL = 5e-2

#: tests/test_inference_device.py:560-575, each against 'direct'
COMBOS = [("s2bg", {}), ("direct", {"zfold": True}),
          ("s2bg", {"zfold": True}),
          ("s2bg", {"zfold": True, "ztap": True}),
          ("direct", {"ztap": "f32"}),
          ("s2bg", {"ztap": "concat"}),
          ("s2bg", {"zmajor": True}),
          ("direct", {"zmajor": True}),
          ("s2bg", {"zmajor": True, "ztap": "concat"}),
          ("s2bg", {"zmajor": True, "ztap": "conv3d"}),
          ("direct", {"zmajor": True, "ztap": "conv3d"}),
          ("s2bg", {"zmajor": True, "ztap": "fatn"}),
          ("direct", {"zmajor": True, "ztap": "fatn"}),
          ("direct", {"poolslice": True}),
          ("s2bg", {"zfold": True, "poolslice": True}),
          ("s2bg", {"zmajor": True, "poolslice": True}),
          # beside the JAX test's list: per-op space-to-batch, and the
          # remaining ztap modes on 'direct'
          ("s2b", {}), ("s2b", {"poolslice": True}),
          ("direct", {"ztap": "native"}), ("direct", {"ztap": "concat"}),
          ("direct", {"zfold": True, "pallas_tail": True}),
          ("s2bg", {"zfold": True, "ztap": "f32", "pallas_tail": True})]
SHAPES = ((15, 34, 37), (16, 36, 36))


@contextlib.contextmanager
def graph(package):
    gmod = importlib.import_module(f"{package}.neuromancer.graphmanager")
    gm = gmod.GraphManager()
    gmod.push_manager(gm)
    try:
        yield gm
    finally:
        gmod.pop_manager()


def narrow_flagship(nm, widths=(4, 6, 8, 8), patch=(11, 27, 27)):
    """``__graft_entry__._flagship_model``'s graph at narrow widths."""
    filters = [(1, 3, 3), (1, 3, 3), (3, 3, 3), (3, 3, 3)]
    pools = [(1, 2, 2), (1, 2, 2), (1, 1, 1), (1, 1, 1)]
    z, x, y = cnncalculator(filters, pools, desired_patch_size=list(patch),
                            mfp=True, ndim=3).input
    inp = nm.Input([1, 1, z, x, y], "b,f,z,x,y", name="raw")
    h = inp
    for i, (f, p, nf) in enumerate(zip(filters, pools, widths)):
        h = nm.Conv(h, nf, f, p, mfp=True, name=f"conv{i}")
    out = nm.Conv(h, 2, 1, 1, activation_func="lin", name="barrier")
    return inp, nm.Softmax(out, name="probs")


def mfp_probe(nm):
    """tests/test_inference_device.py::mfp_model (2-D, MFP)."""
    n = cnncalculator([3, 3], [2, 2], desired_patch_size=21, mfp=True,
                      ndim=1).input
    inp = nm.Input([1, 1, n, n], "b,f,x,y", name="raw")
    c1 = nm.Conv(inp, 4, 3, 2, mfp=True, name="c1")
    c2 = nm.Conv(c1, 2, 3, 2, mfp=True, name="c2")
    return inp, nm.Softmax(c2)


def saved_pair(path, builder):
    """(JAX model, the port's model loaded from the JAX model's file)."""
    with graph("elektronn2_tpu") as gm:
        inp, pred = builder(jnm)
        jm = gm.getmodel()
        jm.designate_nodes(input_node=inp, prediction_node=pred)
    fname = str(path)
    jm.save(fname)
    return jm, modelload(fname, device="cpu")


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    return saved_pair(tmp_path_factory.mktemp("lw") / "narrow.mdl",
                      narrow_flagship)


@pytest.fixture(scope="module")
def raws():
    r = np.random.RandomState(0)
    return [r.randn(1, *s).astype(np.float32) for s in SHAPES]


@pytest.fixture(scope="module")
def port_direct(pair, raws):
    _, tm = pair
    tm.set_dilated_impl("direct")
    return [tm.predict_dense_device(torch.from_numpy(r)).numpy()
            for r in raws]


def jax_dense(jm, raw, impl, kw, dtype=None, act=False):
    jm.set_compute_dtype(None)
    jm.set_dilated_impl(impl, **kw)
    jm.set_compute_dtype(dtype, activations=act)
    return np.asarray(jm.predict_dense_device(jnp.asarray(raw)))


def port_dense(tm, raw, impl, kw, dtype=None, act=False):
    tm.set_compute_dtype(None)
    tm.set_dilated_impl(impl, **kw)
    tm.set_compute_dtype(dtype, activations=act)
    try:
        return tm.predict_dense_device(torch.from_numpy(raw)).numpy()
    finally:
        tm.set_compute_dtype(None)
        tm.set_dilated_impl("direct")


@pytest.mark.parametrize("impl, kw", COMBOS,
                         ids=[f"{i}-{'-'.join(f'{k}={v}' for k, v in kw.items())}"
                              for i, kw in COMBOS])
def test_lowering_matches_jax_and_direct(pair, raws, port_direct, impl, kw):
    jm, tm = pair
    for raw, direct in zip(raws, port_direct):
        got = port_dense(tm, raw, impl, kw)
        assert got.shape == direct.shape and got.dtype == np.float32
        np.testing.assert_allclose(got, direct, atol=ATOL,
                                   err_msg=f"{impl} {kw} vs direct")
        want = jax_dense(jm, raw, impl,
                         {k: v for k, v in kw.items() if k != "pallas_tail"})
        np.testing.assert_allclose(got, want, atol=ATOL,
                                   err_msg=f"{impl} {kw} vs JAX")


@pytest.mark.parametrize("impl", ["s2b", "s2bg", "direct"])
def test_2d_mfp_probe_lowerings(tmp_path, impl):
    """:541 on the port: the 2-D MFP net's s2b and s2bg maps equal
    'direct', and the JAX package's."""
    jm, tm = saved_pair(tmp_path / "probe.mdl", mfp_probe)
    raw = np.random.RandomState(1).randn(1, 33, 33).astype(np.float32)
    direct = tm.predict_dense_device(torch.from_numpy(raw)).numpy()
    tm.set_dilated_impl(impl, poolslice=impl == "direct")
    got = tm.predict_dense_device(torch.from_numpy(raw)).numpy()
    np.testing.assert_allclose(got, direct, atol=ATOL)
    np.testing.assert_allclose(
        got, jax_dense(jm, raw, impl, {"poolslice": impl == "direct"}),
        atol=ATOL)


def test_zfold_folds_kz1_convs(pair, raws, monkeypatch):
    """``zfold`` changes the computation as in the JAX package: every kz=1,
    pz=1 conv (conv0, conv1, the barrier) runs as a 2-D conv, and no 3-D
    conv takes them; without it they are 3-D convs."""
    _, tm = pair
    seen = []
    real = tconv.conv

    def spy(x, w, *a, **kw):
        seen.append((x.ndim, tuple(w.shape[2:])))
        return real(x, w, *a, **kw)
    monkeypatch.setattr(tconv, "conv", spy)
    raw = torch.from_numpy(raws[0])
    for zfold, want in ((False, [(5, (1, 3, 3)), (5, (1, 3, 3)),
                                 (5, (3, 3, 3)), (5, (3, 3, 3)),
                                 (5, (1, 1, 1))]),
                        (True, [(4, (3, 3)), (4, (3, 3)), (5, (3, 3, 3)),
                                (5, (3, 3, 3)), (4, (1, 1))])):
        seen.clear()
        tm.set_dilated_impl("s2bg", zfold=zfold)
        tm.predict_dense_device(raw)
        assert seen == want, (zfold, seen)
    tm.set_dilated_impl("direct")


# --------------------------------------------------------------- the ops

OP_DILS = [(2, 2, 2), (1, 4, 4), (3, 1, 2)]


@pytest.mark.parametrize("d", OP_DILS)
def test_s2b_split_merge_match_jax(d):
    r = np.random.RandomState(3)
    x = r.randn(2, 3, 9, 10, 13).astype(np.float32)
    for pad in (0.0, -np.inf):
        got = tconv._s2b_split(torch.from_numpy(x), d, pad_val=pad)
        want = np.asarray(jconv._s2b_split(jnp.asarray(x), d, pad_val=pad))
        np.testing.assert_array_equal(got.numpy(), want)
    xz = x.transpose(0, 2, 1, 3, 4).copy()        # (B, Z, C, X, Y)
    got = tconv._s2b_split_zmajor(torch.from_numpy(xz), d)
    want = np.asarray(jconv._s2b_split_zmajor(jnp.asarray(xz), d))
    np.testing.assert_array_equal(got.numpy(), want)
    # the merge inverts both splits (the z-major one after a transpose)
    valid = (7, 8, 11)
    for split in (tconv._s2b_split(torch.from_numpy(x), d),
                  tconv._s2b_split_zmajor(torch.from_numpy(xz), d)
                  .transpose(1, 2)):
        back = tconv._s2b_merge(split, d, 2, valid)
        np.testing.assert_array_equal(back.numpy(), x[:, :, :7, :8, :11])
        np.testing.assert_array_equal(
            back.numpy(), np.asarray(jconv._s2b_merge(
                jnp.asarray(split.contiguous().numpy()), d, 2, valid)))


@pytest.mark.parametrize("d", OP_DILS)
def test_conv_s2b_and_pool_s2b_match_jax(d):
    r = np.random.RandomState(4)
    x = r.randn(2, 3, 11, 13, 12).astype(np.float32)
    w = r.randn(4, 3, 2, 3, 3).astype(np.float32)
    got = tconv.conv_s2b(torch.from_numpy(x), torch.from_numpy(w), d)
    np.testing.assert_allclose(
        got.numpy(), tconv.conv(torch.from_numpy(x), torch.from_numpy(w),
                                dilation=d).numpy(), atol=ATOL)
    np.testing.assert_allclose(
        got.numpy(), np.asarray(jconv.conv_s2b(jnp.asarray(x),
                                               jnp.asarray(w), d)),
        atol=ATOL)
    assert computations.conv_s2b is tconv.conv_s2b
    for mode in ("max", "avg"):
        got = tconv.pool_s2b(torch.from_numpy(x), (2, 2, 2), d, mode=mode)
        want = np.asarray(jconv.pool_s2b(jnp.asarray(x), (2, 2, 2), d,
                                         mode=mode))
        np.testing.assert_allclose(got.numpy(), want, atol=1e-6)
        np.testing.assert_array_equal(
            got.numpy(), tinf.dilated_pool(torch.from_numpy(x), (2, 2, 2), d,
                                           mode=mode).numpy())


@pytest.mark.parametrize("kz, d", [(3, (1, 1, 1)), (3, (2, 4, 4)),
                                   (2, (3, 1, 2)), (1, (1, 2, 2))])
def test_conv_ztap_matches_jax(kz, d):
    """:527 on the port: every accum mode against the 3-D conv and JAX's
    conv_ztap."""
    r = np.random.RandomState(5)
    x = r.randn(2, 5, 15, 17, 16).astype(np.float32)
    w = r.randn(4, 5, kz, 3, 3).astype(np.float32)
    ref = tconv.conv(torch.from_numpy(x), torch.from_numpy(w),
                     dilation=d).numpy()
    for accum in ("native", "f32", "concat"):
        got = tconv.conv_ztap(torch.from_numpy(x), torch.from_numpy(w),
                              dilation=d, accum=accum).numpy()
        assert got.shape == ref.shape, accum
        np.testing.assert_allclose(got, ref, atol=2e-5, err_msg=accum)
        np.testing.assert_allclose(
            got, np.asarray(jconv.conv_ztap(jnp.asarray(x), jnp.asarray(w),
                                            dilation=d, accum=accum)),
            atol=2e-5, err_msg=accum)


def test_quantized_conv_through_conv_s2b_matches_jax():
    """``quantized_conv(conv_fn=conv_s2b)`` bit for bit against JAX's, and
    equal to the direct dilated int8 conv."""
    r = np.random.RandomState(6)
    x = r.randn(2, 3, 9, 14, 13).astype(np.float32)
    w = r.randn(4, 3, 3, 3, 3).astype(np.float32)
    got = tconv.quantized_conv(torch.from_numpy(x), torch.from_numpy(w),
                               conv_fn=tconv.conv_s2b, dilation=(1, 2, 2))
    want = jconv.quantized_conv(jnp.asarray(x), jnp.asarray(w),
                                conv_fn=jconv.conv_s2b, dilation=(1, 2, 2))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(
        got.numpy(), tconv.quantized_conv(torch.from_numpy(x),
                                          torch.from_numpy(w),
                                          dilation=(1, 2, 2)).numpy())


@pytest.mark.parametrize("mode", ["concat", "native", "fatn"])
def test_folded_convs_split_past_the_int32_limit(monkeypatch, mode):
    """With the element limit lowered to three output rows' worth, ``conv_
    ztap`` and the z-major fold run the output z rows in chunks (fatn with
    its halo rows) and give the same map as one call; every 2-D conv call
    stays within the limit."""
    assert tconv.z_chunks(9, 10) == [(0, 9)]
    assert tconv.z_chunks(9, 2**29) == [(0, 3), (3, 6), (6, 9)]
    r = np.random.RandomState(7)
    x = torch.from_numpy(r.randn(2, 3, 13, 11, 12).astype(np.float32))
    w = torch.from_numpy(r.randn(4, 3, 3, 3, 3).astype(np.float32))
    d = (2, 1, 2)

    def run():
        if mode == "fatn":
            return tinf._zmajor_conv(x.transpose(1, 2).contiguous(), w, d,
                                     mode).transpose(1, 2)
        return tconv.conv_ztap(x, w, d, accum=mode)
    whole = run()
    # elements a call holds per output row: batch x (input, or output)
    row = {"concat": 2 * 3 * 3 * 11 * 12, "native": 2 * 3 * 11 * 12,
           "fatn": 2 * 3 * 4 * 9 * 8}[mode]
    limit = row * (3 + (4 if mode == "fatn" else 0))
    monkeypatch.setattr(tconv, "INT32_ELEMENTS", limit)
    sizes = []
    real = tconv.F.conv2d

    def spy(a, b, *args, **kw):
        y = real(a, b, *args, **kw)
        sizes.append(max(a.numel(), y.numel()))
        return y
    monkeypatch.setitem(tconv._CONV, 2, spy)
    got = run()
    assert len(sizes) == (9 if mode == "native" else 3)
    assert max(sizes) <= limit
    np.testing.assert_allclose(got.numpy(), whole.numpy(), atol=1e-6)


def bn_apply_concat(nm):
    """An MFP graph with a batch-normed conv, a channel-mixing (spatially
    pointwise) ApplyFunc, a standalone BatchNorm and a Concat."""
    import jax
    fun = ((lambda x: jax.nn.softmax(x, 1)) if nm is jnm
           else (lambda x: torch.softmax(x, 1)))
    inp = nm.Input([1, 1, 11, 21, 21], "b,f,z,x,y", name="raw")
    c1 = nm.Conv(inp, 4, (1, 3, 3), (1, 2, 2), mfp=True,
                 batch_normalisation=True, name="c1")
    af = nm.ApplyFunc(c1, fun, name="af")
    c2 = nm.Conv(af, 4, 3, 2, mfp=True, name="c2")
    bn = nm.BatchNorm(c2, name="bn")
    cat = nm.Concat([bn, c2], name="cat")
    return inp, nm.Softmax(nm.Conv(cat, 2, 1, 1, activation_func="lin",
                                   mfp=True, name="cls"))


@pytest.mark.parametrize("impl, kw", [
    ("s2bg", {"zfold": True}), ("s2bg", {"zmajor": True, "ztap": "fatn"}),
    ("direct", {"zmajor": True, "poolslice": True}), ("s2b", {}),
    ("s2bg", {"ztap": "concat", "poolslice": True})])
def test_bn_apply_func_concat_under_each_lowering(impl, kw):
    """Batch norm's running statistics (a per-channel affine on the channel
    axis, axis 2 under zmajor), an ApplyFunc taken in the (B, C, *sp)
    layout under zmajor, and a Concat in phase space: each lowering equals
    'direct' and the JAX package's same lowering (1e-5)."""
    # an ApplyFunc's functor is code, which Model.save does not store: the
    # two graphs are built alike and the port takes the JAX weights
    from elektronn2_tpu_torch.utils.convert import params_from_jax
    models = []
    for pkg, nm in (("elektronn2_tpu", jnm), ("elektronn2_tpu_torch", tnm)):
        with graph(pkg) as gm:
            inp, pred = bn_apply_concat(nm)
            m = gm.getmodel()
            m.designate_nodes(input_node=inp, prediction_node=pred)
        models.append(m)
    jm, tm = models
    tm.set_params(params_from_jax(jm.params, tm))
    r = np.random.RandomState(8)
    state = {n: {"mean": r.randn(4).astype(np.float32) * 0.1,
                 "var": r.rand(4).astype(np.float32) + 0.5}
             for n in ("c1", "bn")}
    jm.state = {n: {k: jnp.asarray(v) for k, v in d.items()}
                for n, d in state.items()}
    tm.state = {n: {k: torch.from_numpy(v) for k, v in d.items()}
                for n, d in state.items()}
    raw = r.rand(1, 14, 33, 31).astype(np.float32)
    direct = port_dense(tm, raw, "direct", {})
    got = port_dense(tm, raw, impl, kw)
    np.testing.assert_allclose(got, direct, atol=ATOL)
    np.testing.assert_allclose(got, jax_dense(jm, raw, impl, kw), atol=ATOL)


# ----------------------------------------------------- precisions, mesh

def test_bf16_under_s2bg_matches_jax(pair, raws):
    jm, tm = pair
    raw = raws[0]
    f32 = port_dense(tm, raw, "direct", {})
    for kw in ({}, {"zfold": True}, {"zfold": True, "ztap": "native"}):
        # ztap native sums its taps in bf16 in both packages, on top of the
        # port's bf16 rounding of each conv's output
        got = port_dense(tm, raw, "s2bg", kw, "bfloat16")
        want = jax_dense(jm, raw, "s2bg", kw, "bfloat16")
        assert got.dtype == np.float32
        assert float(np.abs(got - want).max()) < BF16_ATOL
        assert float(np.abs(got - f32).max()) < BF16_ATOL
        assert (got.argmax(0) == want.argmax(0)).mean() > 0.98


def narrow_flagship_logits(nm):
    """The narrow flagship without its softmax: the barrier's logits."""
    inp, probs = narrow_flagship(nm)
    return inp, probs.parents[0]


@pytest.mark.parametrize("act", [False, True])
def test_int8_under_s2bg(tmp_path, pair, raws, act):
    """s2bg (and s2b) int8 logits are the direct int8 logits bit for bit
    (the same integer sums, the same scales: the split's zero pad changes
    no max-abs); s2bg's probabilities are JAX's s2bg int8 map's to 1e-5,
    and with ``activations=True`` its bf16-stored logits are JAX's bit for
    bit."""
    jl, lm = saved_pair(tmp_path / "logits.mdl", narrow_flagship_logits)
    raw = raws[1]
    direct = port_dense(lm, raw, "direct", {}, "int8", act)
    jm, tm = pair
    np.testing.assert_array_equal(port_dense(lm, raw, "s2b", {}, "int8", act),
                                  direct)
    for kw in ({}, {"zfold": True}):
        logits = port_dense(lm, raw, "s2bg", kw, "int8", act)
        np.testing.assert_array_equal(logits, direct)
        if act:
            np.testing.assert_array_equal(
                logits, jax_dense(jl, raw, "s2bg", kw, "int8", act))
        got = port_dense(tm, raw, "s2bg", kw, "int8", act)
        want = jax_dense(jm, raw, "s2bg", kw, "int8", act)
        np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def test_sharded_request_with_s2bg_equals_direct(pair, raws):
    """Under a mesh every lowering falls back to 'direct', as in the JAX
    package: a sharded request with s2bg + zmajor + ztap set equals the
    unsharded direct map."""
    from torch_dp_workers import mesh_of_one
    _, tm = pair
    raw = torch.from_numpy(raws[0])
    direct = tm.predict_dense_device(raw, pad_raw=True)
    tm.set_dilated_impl("s2bg", zfold=True, zmajor=True, ztap="fatn",
                        poolslice=True)
    try:
        with mesh_of_one({"space": 1}) as mesh:
            got = tinf.predict_dense_sharded(tm, raw, mesh, pad_raw=True)
        np.testing.assert_allclose(got.numpy(), direct.numpy(), atol=ATOL)
    finally:
        tm.set_dilated_impl("direct")


def test_k1_only_where_jax_takes_it(pair, raws, monkeypatch):
    """``pallas_tail`` reaches K1 on 'direct' at float32 only: in phase
    space (s2bg's tail), under s2b or zmajor and in bf16 or int8 every conv
    stays on cuDNN, as the JAX package ignores its kernel there; a dict of
    TPU knobs turns K1 on and is kept as given."""
    from elektronn2_tpu_torch.neuromancer import neural  # noqa: F401
    _, tm = pair
    calls = []
    real = tailconv.conv3x3_dilated

    def counted(*a, **kw):
        calls.append(1)
        return real(*a, **kw)
    monkeypatch.setattr(tailconv, "conv3x3_dilated", counted)
    raw = torch.from_numpy(raws[0])
    knobs = {"variant": "mstack", "z_block": 4}
    for impl, kw, dtype, want in (
            ("direct", {"zfold": True}, None, 2),
            ("direct", {"ztap": "concat"}, None, 2),
            ("s2bg", {"zfold": True}, None, 0),
            ("s2b", {}, None, 0),
            ("direct", {"zmajor": True}, None, 0),
            ("direct", {"zfold": True}, "bfloat16", 0),
            ("direct", {"zfold": True}, "int8", 0)):
        calls.clear()
        tm.set_compute_dtype(None)
        tm.set_dilated_impl(impl, pallas_tail=knobs, **kw)
        assert tm._dilated_ptail == knobs and tm._dilated_ptail is not knobs
        tm.set_compute_dtype(dtype)
        tm.predict_dense_device(raw)
        assert len(calls) == want, (impl, kw, dtype)
    tm.set_compute_dtype(None)
    tm.set_dilated_impl("direct")
    tm.set_convdense_impl(ptail={"variant": "tap9"})
    assert tm._convdense_ptail == {"variant": "tap9"}
    tm.set_convdense_impl()


# ----------------------------------------------------- guards and errors

def test_guards_match_jax(pair):
    """The JAX package's ValueErrors, with its messages, in both
    packages."""
    jm, tm = pair
    for m in (jm, tm):
        m.set_compute_dtype(None)
        with pytest.raises(ValueError, match="expected 'direct', 's2b'"):
            m.set_dilated_impl("bogus")
        with pytest.raises(ValueError, match="expected bool, 'native'"):
            m.set_dilated_impl("direct", ztap="tap9")
        for mode in ("conv3d", "fatn"):
            with pytest.raises(ValueError, match="requires zmajor=True"):
                m.set_dilated_impl("s2bg", ztap=mode)
        m.set_compute_dtype("int8")
        for kw in ({"ztap": True}, {"zmajor": True}):
            with pytest.raises(ValueError, match="not available in int8"):
                m.set_dilated_impl("s2bg", **kw)
        m.set_dilated_impl("s2bg", zfold=True)     # int8 takes these
        m.set_compute_dtype(None)
        m.set_dilated_impl("direct", ztap="f32")
        with pytest.raises(ValueError, match="disable ztap/zmajor first"):
            m.set_compute_dtype("int8")
        m.set_dilated_impl("direct", zmajor=True)
        with pytest.raises(ValueError, match="disable ztap/zmajor first"):
            m.set_compute_dtype("int8", activations=True)
        m.set_dilated_impl("direct")
    with pytest.raises(ValueError, match="expected 'direct', 's2b'"):
        tm.set_dilated_impl("s2x")
    assert tm._dilated_impl == "direct"
    tm._dilated_zmajor = True
    tm._compute_dtype = "int8"
    try:
        with pytest.raises(ValueError, match="ztap/zmajor unsupported"):
            tinf.dilated_dense_forward(tm, torch.zeros(1, 15, 34, 37))
    finally:
        tm._dilated_zmajor = False
        tm._compute_dtype = None


def pool_past_plateau(nm):
    """A trivial (1,1,1) Pool after the last pooled conv: under s2bg the
    value it takes is already in phase space."""
    inp = nm.Input([1, 1, 5, 21, 21], "b,f,z,x,y", name="raw")
    c1 = nm.Conv(inp, 3, (1, 3, 3), (1, 2, 2), mfp=True, name="c1")
    c2 = nm.Conv(c1, 3, (1, 3, 3), 1, mfp=True, name="c2")
    p = nm.Pool(c2, (1, 1, 1), mfp=True, name="p")
    return inp, nm.Softmax(nm.Conv(p, 2, 1, 1, activation_func="lin",
                                   mfp=True, name="cls"))


def test_s2bg_pool_past_plateau(tmp_path):
    """The JAX package's UnsupportedGraphError for a pool past the dilation
    plateau, with its message, in both packages; ``predict_dense_device``
    then serves the graph through the tiled path (as the JAX package does),
    equal to 'direct'; the tuner stops with best None (the JAX package's
    structural stop); a batched sweep chunk would fall back per slab."""
    jm, tm = saved_pair(tmp_path / "p.mdl", pool_past_plateau)
    raw = np.random.RandomState(2).rand(1, 7, 30, 30).astype(np.float32)
    jm.set_dilated_impl("s2bg")
    tm.set_dilated_impl("s2bg")
    msg = "pooling past the dilation plateau"
    from elektronn2_tpu.neuromancer.inference import (
        UnsupportedGraphError as JaxUnsupported, dilated_dense_forward)
    with pytest.raises(JaxUnsupported, match=msg):
        dilated_dense_forward(jm, jnp.asarray(raw))
    with pytest.raises(UnsupportedGraphError, match=msg):
        tinf.dilated_dense_forward(tm, torch.from_numpy(raw))
    assert issubclass(UnsupportedGraphError, ValueError)
    got = tm.predict_dense_device(torch.from_numpy(raw)).numpy()
    np.testing.assert_allclose(
        got, np.asarray(jm.predict_dense_device(jnp.asarray(raw))),
        atol=ATOL)
    tm.set_dilated_impl("direct")
    np.testing.assert_allclose(
        got, tm.predict_dense_device(torch.from_numpy(raw)).numpy(),
        atol=ATOL)
    res = tune_sweep(tm, steps=[(4, 8, 8)], slab_batches=(1,), K=1,
                     include_bf16=False, include_int8=False, verbose=False)
    assert res["best"] is None
    assert [r["impl"] for r in res["table"]] == ["direct"]
    assert tm._dilated_impl == "direct"


def test_s2bg_concat_in_mixed_phase_states(tmp_path):
    """A Concat of a branch already in phase space (a 1x1x1 conv of c1)
    and one not yet split (c1 itself; both at the plateau): the unsplit
    parent is split before the concat, as in the JAX package
    (:884-898)."""
    def builder(nm):
        inp = nm.Input([1, 1, 5, 21, 21], "b,f,z,x,y", name="raw")
        c1 = nm.Conv(inp, 3, (1, 3, 3), (1, 2, 2), mfp=True, name="c1")
        a = nm.Conv(c1, 3, 1, 1, mfp=True, name="a")
        cat = nm.Concat([a, c1], name="cat")
        return inp, nm.Softmax(nm.Conv(cat, 2, (1, 3, 3), 1,
                                       activation_func="lin", mfp=True,
                                       name="cls"))
    jm, tm = saved_pair(tmp_path / "c.mdl", builder)
    raw = np.random.RandomState(3).rand(1, 7, 30, 30).astype(np.float32)
    direct = port_dense(tm, raw, "direct", {})
    for kw in ({}, {"zfold": True}, {"zmajor": True}):
        got = port_dense(tm, raw, "s2bg", kw)
        np.testing.assert_allclose(got, direct, atol=ATOL)
        np.testing.assert_allclose(got, jax_dense(jm, raw, "s2bg", kw),
                                   atol=ATOL)


def test_no_lowering_argument_is_refused(pair):
    """Every argument the JAX package's setters accept, the port's
    accept."""
    _, tm = pair
    for impl in ("direct", "s2b", "s2bg"):
        for ztap in (False, True, "native", "f32", "concat", "conv3d",
                     "fatn"):
            for zmajor in (False, True):
                if ztap in ("conv3d", "fatn") and not zmajor:
                    continue
                tm.set_dilated_impl(impl, zfold=True, ztap=ztap,
                                    zmajor=zmajor, poolslice=True,
                                    pallas_tail={"variant": "kfuse"})
                assert (tm._dilated_impl, tm._dilated_ztap,
                        tm._dilated_zmajor) == (impl, ztap, zmajor)
    tm.set_dilated_impl("direct")


def test_rebuild_model_keeps_the_lowering(pair):
    from elektronn2_tpu_torch.neuromancer.model import rebuild_model
    _, tm = pair
    tm.set_dilated_impl("s2bg", zfold=True, ztap="concat", zmajor=True,
                        poolslice=True, pallas_tail={"z_block": 2})
    try:
        new = rebuild_model(tm)
        assert (new._dilated_impl, new._dilated_zfold, new._dilated_ztap,
                new._dilated_zmajor, new._dilated_poolslice,
                new._dilated_ptail) == ("s2bg", True, "concat", True, True,
                                        {"z_block": 2})
    finally:
        tm.set_dilated_impl("direct")


# ----------------------------------------------------------- the tuner

def test_tuner_grid_is_jax_six(pair):
    """:725-750 on the port: the JAX package's six contenders in its order,
    each with the whole knob set, none a failed row."""
    _, tm = pair
    tm.set_dilated_impl("direct")
    res = tune_sweep(tm, steps=[(6, 10, 10)], slab_batches=(1,), K=1,
                     verbose=False)
    got = [(r["impl"], r["zfold"], r["dtype"], r["act"], r["ptail"],
            r["ztap"], r["zmajor"], r["poolslice"]) for r in res["table"]]
    assert got == [("direct", False, None, False, False, False, False, False),
                   ("s2bg", False, None, False, False, False, False, False),
                   ("direct", True, None, False, True, False, False, False),
                   ("s2bg", False, "bfloat16", False, False, False, False,
                    False),
                   ("s2bg", True, "bfloat16", False, False, False, False,
                    False),
                   ("s2bg", True, "int8", True, False, False, False, False)]
    assert all("mvox_s" in r for r in res["table"])
    assert (tm._dilated_impl, tm._compute_dtype) == ("direct", None)


def test_tuner_incumbent_keeps_its_knobs(pair):
    """:837-870 on the port: a hand-set incumbent (s2bg + ztap + zmajor +
    poolslice) competes with its whole knob set, its row tagged so, and is
    restored after the tune; applying it restores every knob."""
    _, tm = pair
    tm.set_dilated_impl("s2bg", zfold=True, ztap="fatn", zmajor=True,
                        poolslice=True)
    try:
        res = tune_sweep(tm, steps=[(6, 10, 10)], slab_batches=(1,), K=1,
                         include_bf16=False, include_int8=False,
                         verbose=False)
        first = res["table"][0]
        assert (first["impl"], first["zfold"], first["ztap"],
                first["zmajor"], first["poolslice"]) == (
            "s2bg", True, "fatn", True, True)
        assert len(res["table"]) == 4 and "mvox_s" in first
        assert (tm._dilated_impl, tm._dilated_zfold, tm._dilated_ztap,
                tm._dilated_zmajor, tm._dilated_poolslice) == (
            "s2bg", True, "fatn", True, True)
        res = tune_sweep(tm, steps=[(6, 10, 10)], slab_batches=(1,), K=1,
                         lowerings=[("s2bg", True, None, "fatn", True, True)],
                         apply=True, verbose=False)
        assert res["best"]["ztap"] == "fatn" and tm._dilated_zmajor
    finally:
        tm.set_dilated_impl("direct")
