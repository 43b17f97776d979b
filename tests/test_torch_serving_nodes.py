"""The node types the JAX package's conv-dense walk takes that came last to
the port, ``FromTensor``, ``MultMerge``, ``ApplyFunc`` and ``LRN``, against
the JAX package on the CPU: forward, LRN's gradient, both dense paths (the
dilated path takes a spatially pointwise ApplyFunc), the functor probe, and
saving/loading.

Tolerances: forwards 1e-6 (the same float32 elementwise ops; LRN's window
sum in another order); LRN's gradient 1e-5; dense maps 1e-5 (float32 conv
sums in another order, tests/test_torch_dense.py).
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
from elektronn2_tpu.neuromancer.inference import (  # noqa: E402
    _functor_spatially_elementwise as jax_probe)
from elektronn2_tpu_torch import neuromancer as tnm  # noqa: E402
from elektronn2_tpu_torch.neuromancer import inference as tinf  # noqa: E402
from elektronn2_tpu_torch.neuromancer.model import modelload  # noqa: E402
from elektronn2_tpu_torch.utils.convert import params_from_jax  # noqa: E402

torch.set_num_threads(2)
ATOL = 1e-5


@contextlib.contextmanager
def graph(package):
    gmod = importlib.import_module(f"{package}.neuromancer.graphmanager")
    gm = gmod.GraphManager()
    gmod.push_manager(gm)
    try:
        yield gm
    finally:
        gmod.pop_manager()


def pair(builder, jfun=None, tfun=None):
    """(JAX model, port model with the JAX weights) of ``builder(nm, fun)``,
    ``fun`` the package's functor where the graph holds an ApplyFunc."""
    out = []
    for pkg, nm, fun in (("elektronn2_tpu", jnm, jfun),
                         ("elektronn2_tpu_torch", tnm, tfun)):
        with graph(pkg) as gm:
            inp, pred = builder(nm, fun)
            m = gm.getmodel()
            m.designate_nodes(input_node=inp, prediction_node=pred)
        out.append(m)
    jm, m = out
    m.set_params(params_from_jax(jm.params, m))
    return jm, m


def gate_unet(nm, fun=None):
    """A 3-D U-Net gated by a constant mask (FromTensor x MultMerge), with
    LRN on the skip and a pointwise ApplyFunc before the softmax."""
    inp = nm.Input([1, 1, 8, 16, 16], "b,f,z,x,y", name="raw")
    e0 = nm.Conv(inp, 6, (1, 3, 3), 1, name="e0")
    lrn = nm.LRN(e0, size=3, alpha=0.05, beta=0.75, k=1.5, name="lrn")
    mask = nm.FromTensor(np.linspace(0.5, 1.5, 6, dtype=np.float32)
                         .reshape(1, 6, 1, 1, 1), "b,f,z,x,y", name="mask")
    gated = nm.MultMerge(lrn, mask, name="gated")
    e1 = nm.Conv(gated, 8, (3, 3, 3), (1, 2, 2), name="e1")
    up = nm.UpConv(e1, 4, (1, 2, 2), activation_func="relu", name="up")
    mg = nm.FaithlessMerge(up, gated, name="mg")
    out = nm.Conv(mg, 2, 1, 1, activation_func="lin", name="cls")
    if fun is not None:
        out = nm.ApplyFunc(out, fun, name="af")
    return inp, nm.Softmax(out, name="probs")


def mfp_apply(nm, fun):
    """An MFP graph with an ApplyFunc between its convs."""
    inp = nm.Input([1, 1, 11, 21, 21], "b,f,z,x,y", name="raw")
    c1 = nm.Conv(inp, 6, (1, 3, 3), (1, 2, 2), mfp=True, name="c1")
    af = nm.ApplyFunc(c1, fun, name="af")
    c2 = nm.Conv(af, 8, 3, 2, mfp=True, name="c2")
    return inp, nm.Softmax(nm.Conv(c2, 2, 1, 1, activation_func="lin",
                                   name="cls"))


# --------------------------------------------------------------- forwards

def test_from_tensor_and_multmerge_forward():
    v = np.random.RandomState(0).rand(1, 3, 1, 1).astype(np.float32)

    def build(nm, fun):
        inp = nm.Input([2, 3, 5, 6], "b,f,x,y", name="raw")
        c = nm.FromTensor(v, "b,f,x,y", name="c")
        mm = nm.MultMerge(inp, c, name="mm")
        assert tuple(mm.shape) == (2, 3, 5, 6)
        return inp, mm
    jm, m = pair(build)
    assert not m.nodes["c"].param_flags["value"]["trainable"]
    x = np.random.RandomState(1).rand(2, 3, 5, 6).astype(np.float32)
    np.testing.assert_allclose(m.predict(torch.from_numpy(x)).numpy(),
                               np.asarray(jm.predict(x)), atol=1e-6)


def test_apply_func_forward_and_new_shape():
    def build(nm, fun):
        inp = nm.Input([2, 4, 5, 6], "b,f,x,y", name="raw")
        return inp, nm.ApplyFunc(inp, fun, new_shape=(2, 1, 5, 6),
                                 args=(1,), kwargs={"keepdims": True},
                                 name="af")
    jm, m = pair(build, lambda x, ax, keepdims: jnp.sum(x, ax, keepdims=
                                                          keepdims),
                 lambda x, ax, keepdims: torch.sum(x, ax, keepdim=keepdims))
    assert tuple(m.nodes["af"].shape) == (2, 1, 5, 6)
    x = np.random.RandomState(2).rand(2, 4, 5, 6).astype(np.float32)
    np.testing.assert_allclose(m.predict(torch.from_numpy(x)).numpy(),
                               np.asarray(jm.predict(x)), atol=1e-6)


@pytest.mark.parametrize("size", [3, 5])
def test_lrn_forward_and_gradient(size):
    def build(nm, fun):
        inp = nm.Input([2, 7, 4, 5], "b,f,x,y", name="raw")
        return inp, nm.LRN(inp, size=size, alpha=0.2, beta=0.6, k=1.0,
                           name="lrn")
    jm, m = pair(build)
    x = np.random.RandomState(size).randn(2, 7, 4, 5).astype(np.float32)
    np.testing.assert_allclose(m.predict(torch.from_numpy(x)).numpy(),
                               np.asarray(jm.predict(x)), atol=1e-6)
    node = jm.nodes["lrn"]
    gx = jax.grad(lambda a: jnp.sum(jnp.sin(node._compute(None, a))))(
        jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    torch.sin(m.nodes["lrn"]._compute(None, xt)).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx), atol=ATOL)


# ------------------------------------------------------------- dense paths

def test_nodes_through_the_conv_dense_path():
    """FromTensor, MultMerge, LRN and ApplyFunc in a U-Net: the conv-dense
    path takes the graph, and its map equals the JAX package's."""
    jm, m = pair(gate_unet, jnp.tanh, torch.tanh)
    assert tinf._conv_dense_rejection(m.prediction_node) is None
    vol = np.random.RandomState(3).rand(1, 12, 24, 26).astype(np.float32)
    got = tinf.convolutional_dense_forward(m, torch.from_numpy(vol),
                                           pad_raw=True)
    want = np.asarray(jm.predict_dense_device(jnp.asarray(vol),
                                              pad_raw=True))
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)
    np.testing.assert_allclose(
        m.predict_dense_device(torch.from_numpy(vol), pad_raw=True).numpy(),
        want, atol=ATOL)


def test_pointwise_apply_func_takes_the_dilated_path():
    """A spatially pointwise ApplyFunc keeps an MFP graph on the dilated
    path (equal to JAX's); a spatial one (a roll) sends it to the tiled
    fallback, equal to JAX's too."""
    vol = np.random.RandomState(4).rand(1, 16, 28, 28).astype(np.float32)
    jm, m = pair(mfp_apply, jax.nn.relu, torch.relu)
    assert tinf._dilated_unsupported(m.prediction_node, m.state) is None
    got = tinf.dilated_dense_forward(m, torch.from_numpy(vol))
    np.testing.assert_allclose(
        got.numpy(), np.asarray(jm.predict_dense_device(jnp.asarray(vol))),
        atol=ATOL)
    jm, m = pair(mfp_apply, lambda x: jnp.roll(x, 1, -1),
                 lambda x: torch.roll(x, 1, -1))
    assert type(tinf._dilated_unsupported(
        m.prediction_node, m.state)).__name__ == "ApplyFunc"
    np.testing.assert_allclose(
        m.predict_dense_device(torch.from_numpy(vol)).numpy(),
        np.asarray(jm.predict_dense_device(jnp.asarray(vol))), atol=ATOL)


@pytest.mark.parametrize("name", ["relu", "channel_softmax", "flip", "roll",
                                  "shrink", "raises"])
def test_functor_probe_agrees_with_jax(name):
    funs = {
        "relu": (jax.nn.relu, torch.relu),
        "channel_softmax": (lambda x: jax.nn.softmax(x, 1),
                            lambda x: torch.softmax(x, 1)),
        "flip": (lambda x: jnp.flip(x, -2), lambda x: torch.flip(x, (-2,))),
        "roll": (lambda x: jnp.roll(x, 1, 2), lambda x: torch.roll(x, 1, 2)),
        "shrink": (lambda x: x[..., 1:], lambda x: x[..., 1:]),
        "raises": (lambda x: x.nope, lambda x: x.nope)}
    jf, tf = funs[name]
    jm, m = pair(mfp_apply, jf, tf)
    want = jax_probe(jm.nodes["af"], 6)
    assert tinf._functor_spatially_elementwise(m.nodes["af"], 6) == want
    assert want == (name in ("relu", "channel_softmax"))


def test_saved_nodes_load_and_apply_func_does_not_save(tmp_path):
    """A JAX-saved graph with FromTensor, MultMerge and LRN loads in the
    port and serves as JAX's does; a graph with an ApplyFunc cannot be
    saved, in either package."""
    with graph("elektronn2_tpu") as gm:
        inp, pred = gate_unet(jnm)
        jm = gm.getmodel()
        jm.designate_nodes(input_node=inp, prediction_node=pred)
    fname = str(tmp_path / "gate.mdl")
    jm.save(fname)
    m = modelload(fname, device="cpu")
    np.testing.assert_array_equal(m.params["mask"]["value"].numpy(),
                                  np.asarray(jm.params["mask"]["value"]))
    vol = np.random.RandomState(5).rand(1, 10, 20, 22).astype(np.float32)
    np.testing.assert_allclose(
        m.predict_dense_device(torch.from_numpy(vol), pad_raw=True).numpy(),
        np.asarray(jm.predict_dense_device(jnp.asarray(vol), pad_raw=True)),
        atol=ATOL)
    jm2, m2 = pair(gate_unet, jnp.tanh, torch.tanh)
    for model in (jm2, m2):
        with pytest.raises(TypeError, match="cannot be serialised"):
            model.save(str(tmp_path / "af.mdl"))
