"""The port's ``predict`` CLI against the JAX package's, on the CPU.

One model file, saved by the JAX ``Model.save``, goes through both CLIs:
``elektronn2_tpu.scripts.predict.main`` with its default XLA route and
``elektronn2_tpu_torch.scripts.predict.main(["--cpu", ...])`` with the
port's kernel routes (``--ptail``: K1's plain version on the CPU;
``--convdense ptail``). Tolerances: HDF5 probabilities within atol 1e-5
(float32 sums in another order, as tests/test_pallas_tailconv.py:156);
KNOSSOS uint8 maps equal to the port's own HDF5 output clipped, byte for
byte, and within 1 of the JAX package's (a truncation of values that agree
within 1e-5); traced coordinates within 1e-4 (tests/test_torch_tracing.py).
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
import elektronn2_tpu.neuromancer as jnm  # noqa: E402
from __graft_entry__ import _flagship_model  # noqa: E402
from elektronn2_tpu.data.knossos_array import (  # noqa: E402
    save_knossos as jax_save_knossos)
from elektronn2_tpu.scripts.predict import main as jax_main  # noqa: E402
from elektronn2_tpu.utils.basic import h5save as jax_h5save  # noqa: E402
from elektronn2_tpu_torch.data.knossos_array import KnossosArray  # noqa: E402
from elektronn2_tpu_torch.data.skeleton import read_nml_file  # noqa: E402
from elektronn2_tpu_torch.scripts.predict import main  # noqa: E402
from elektronn2_tpu_torch.utils.basic import h5load  # noqa: E402

pytest.importorskip("h5py")
torch.set_num_threads(2)
ATOL = 1e-5


@contextlib.contextmanager
def jax_graph():
    gmod = importlib.import_module("elektronn2_tpu.neuromancer.graphmanager")
    gm = gmod.GraphManager()
    gmod.push_manager(gm)
    try:
        yield gm
    finally:
        gmod.pop_manager()


def save_jax(tmp_path, builder, name="m"):
    with jax_graph() as gm:
        inp, pred = builder(jnm)
        m = gm.getmodel()
        m.designate_nodes(input_node=inp, prediction_node=pred)
    fname = str(tmp_path / f"{name}.mdl")
    m.save(fname)
    return fname, m


def ptail_graph(nm):
    """The graph of tests/test_pallas_tailconv.py::test_predict_cli_ptail:
    its (3,3,3) ReLU conv is K1's."""
    inp = nm.Input([1, 1, 7, 15, 15], "b,f,z,x,y", name="raw")
    c1 = nm.Conv(inp, 4, (3, 3, 3), (1, 2, 2), mfp=True, name="c1")
    return inp, nm.Softmax(nm.Conv(c1, 2, 1, 1, activation_func="lin"))


def plain_graph(nm):
    """No MFP: ``--mfp --patch`` rebuild it for dense inference."""
    inp = nm.Input([1, 1, 5, 20, 20], "b,f,z,x,y", name="raw")
    c0 = nm.Conv(inp, 4, (1, 3, 3), (1, 2, 2), name="c0")
    c1 = nm.Conv(c0, 4, (3, 3, 3), 1, name="c1")
    return inp, nm.Softmax(nm.Conv(c1, 2, 1, 1, activation_func="lin"))


def decoder_graph(nm):
    inp = nm.Input([1, 1, 8, 16, 16], "b,f,z,x,y", name="raw")
    enc0 = nm.Conv(inp, 4, (1, 3, 3), (1, 1, 1), name="enc0")
    enc1 = nm.Conv(enc0, 8, (3, 3, 3), (1, 2, 2), name="enc1")
    enc2 = nm.Conv(enc1, 8, (3, 3, 3), (1, 1, 1), name="enc2")
    up = nm.UpConv(enc2, 4, (1, 2, 2), activation_func="relu", name="up")
    merged = nm.FaithlessMerge(up, enc0, name="merge")
    dec = nm.Conv(merged, 8, (1, 3, 3), (1, 1, 1), name="dec")
    return inp, nm.Softmax(nm.Conv(dec, 2, 1, 1, activation_func="lin",
                                   name="cls"))


def _h5_input(tmp_path, vol):
    path = str(tmp_path / "in.h5")
    jax_h5save({"raw": vol}, path)
    return path + ":raw"


@pytest.mark.parametrize("extra", [[], ["--no-pad"], ["--uint8"]])
def test_h5_input_matches_jax(tmp_path, extra):
    mdl, _ = save_jax(tmp_path, ptail_graph)
    vol = np.random.RandomState(0).rand(1, 10, 24, 24).astype(np.float32)
    src = _h5_input(tmp_path, vol)
    a, b = str(tmp_path / "a.h5"), str(tmp_path / "b.h5")
    assert jax_main([mdl, src, "-o", a, "--cpu"] + extra) == 0
    assert main([mdl, src, "-o", b, "--cpu", "--ptail"] + extra) == 0
    want, got = h5load(a, "prediction"), h5load(b, "prediction")
    assert got.shape == want.shape and got.dtype == want.dtype
    if "--uint8" in extra:
        assert np.abs(got.astype(int) - want.astype(int)).max() <= 1
    else:
        np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def test_mfp_patch_rebuild_matches_jax(tmp_path):
    mdl, _ = save_jax(tmp_path, plain_graph)
    vol = np.random.RandomState(1).rand(1, 9, 30, 30).astype(np.float32)
    src = _h5_input(tmp_path, vol)
    a, b = str(tmp_path / "a.h5"), str(tmp_path / "b.h5")
    args = ["--mfp", "--patch", "5,21,21"]
    assert jax_main([mdl, src, "-o", a, "--cpu"] + args) == 0
    assert main([mdl, src, "-o", b, "--cpu", "--ptail"] + args) == 0
    np.testing.assert_allclose(h5load(b, "prediction"),
                               h5load(a, "prediction"), atol=ATOL, rtol=0)
    with pytest.raises(SystemExit):
        main([mdl, src, "-o", b, "--cpu", "--patch", "5,21"])


def _cubes(root, n):
    return [KnossosArray(os.path.join(root, f"c{c}"))[:, :, :]
            for c in range(n)]


@pytest.mark.parametrize("model, flags", [
    ("flagship", ["--ptail", "--slab-batch", "2"]),
    ("flagship", ["--ptail"]),
    ("decoder", ["--convdense", "zfold,ptail", "--slab-batch", "2"]),
])
def test_knossos_input_matches_jax(tmp_path, model, flags):
    """A KNOSSOS dataset through both CLIs with ``--knossos-out``: the
    sweep's HDF5 output and the uint8 maps written as KNOSSOS cubes."""
    if model == "flagship":
        jm = _flagship_model(mfp=True, patch=[9, 41, 41])
        mdl = str(tmp_path / "flagship.mdl")
        jm.save(mdl)
        shape, step = (12, 48, 52), "6,24,24"
    else:
        mdl, _ = save_jax(tmp_path, decoder_graph)
        shape, step = (10, 36, 34), "5,17,16"
    raw = (np.random.RandomState(2).rand(*shape) * 255).astype(np.uint8)
    kdir = str(tmp_path / "raw")
    jax_save_knossos(raw, kdir, exp_name="raw", cube_edge=16)
    a, b = str(tmp_path / "a.h5"), str(tmp_path / "b.h5")
    ka, kb = str(tmp_path / "ka"), str(tmp_path / "kb")
    assert jax_main([mdl, kdir, "-o", a, "--cpu", "--step", step,
                     "--knossos-out", ka]) == 0
    assert main([mdl, kdir, "-o", b, "--cpu", "--step", step,
                 "--knossos-out", kb] + flags) == 0
    want, got = h5load(a, "prediction"), h5load(b, "prediction")
    assert got.shape == want.shape == (2,) + shape
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    u8 = np.clip(got * 255.0, 0, 255).astype(np.uint8)
    for c, (g, w) in enumerate(zip(_cubes(kb, 2), _cubes(ka, 2))):
        assert g.shape == shape
        assert np.array_equal(g, u8[c])
        assert np.abs(g.astype(int) - w.astype(int)).max() <= 1


def tracer_graph(nm):
    """A feedforward step predictor: a 5^3 patch -> a 3-vector."""
    inp = nm.Input([1, 1, 5, 5, 5], "b,f,z,x,y", name="x")
    return inp, nm.Perceptron(inp, 3, activation_func="lin", flatten=True,
                              name="step")


def test_trace_knossos_matches_jax(tmp_path):
    """``--trace`` over a KNOSSOS directory: the same coordinates in the
    ``.k.zip`` of both CLIs."""
    with jax_graph() as gm:
        inp, step = tracer_graph(jnm)
        jm = gm.getmodel()
        jm.designate_nodes(input_node=inp, prediction_node=step)
    rng = np.random.RandomState(3)
    jm.params["step"]["w"] = jnp.asarray(
        (rng.randn(125, 3) * 0.05).astype(np.float32))
    jm.params["step"]["b"] = jnp.asarray(np.asarray([0.8, 0.5, -0.4],
                                                    np.float32))
    mdl = str(tmp_path / "tracer.mdl")
    jm.save(mdl)
    raw = (rng.rand(24, 24, 24) * 255).astype(np.uint8)
    kdir = str(tmp_path / "raw")
    jax_save_knossos(raw, kdir, exp_name="raw", cube_edge=16)
    seeds = "10,11,12;12.5,9,11"
    a, b = str(tmp_path / "a.k.zip"), str(tmp_path / "b.h5")
    assert jax_main([mdl, kdir, "-o", a, "--cpu", "--trace", seeds,
                     "--trace-steps", "6"]) == 0
    assert main([mdl, kdir, "-o", b, "--cpu", "--trace", seeds,
                 "--trace-steps", "6"]) == 0
    want, got = [read_nml_file(f)[0] for f in (a, str(tmp_path / "b.k.zip"))]
    assert sorted(got) == sorted(want) and len(got) > 2
    want, got = [np.asarray([n[k] for k in sorted(n)], np.float64)
                 for n in (want, got)]
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


@pytest.mark.parametrize("flag, item", [
    (["--bf16"], "item 7"), (["--int8"], "item 7"), (["--tune"], "item 5"),
    (["--mesh", "data=2"], "item 8")])
def test_unported_flags_raise(tmp_path, flag, item):
    with pytest.raises(NotImplementedError, match=item):
        main([str(tmp_path / "none.mdl"), str(tmp_path), "--cpu"] + flag)
