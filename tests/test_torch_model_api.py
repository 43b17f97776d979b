"""The Model API the port gained last against the JAX package's, on the
CPU: ``get_activations``, ``predict_ext``, ``kernel_lists`` (the property
and the module-level function), ``measure_exectimes``, ``summary`` and
``params_from_model_file``. Values within 1e-5 (float32 sums in another
order); ``summary`` text equal.
"""

import contextlib
import importlib
import os
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
import elektronn2_tpu.neuromancer as jnm  # noqa: E402
from elektronn2_tpu.neuromancer.model import (  # noqa: E402
    kernel_lists as jax_kernel_lists,
    params_from_model_file as jax_params_from_file)
from elektronn2_tpu_torch import neuromancer as tnm  # noqa: E402
from elektronn2_tpu_torch.neuromancer.model import (  # noqa: E402
    kernel_lists, modelload, params_from_model_file)

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


def build(nm):
    """A small trained-shape net with a loss, a target and an extended
    prediction node."""
    inp = nm.Input([2, 1, 12, 12], "b,f,x,y", name="raw")
    c1 = nm.Conv(inp, 4, 3, 2, name="c1")
    c2 = nm.Conv(c1, 5, 3, 1, name="c2")
    cls = nm.Conv(c2, 2, 1, 1, activation_func="lin", name="cls")
    probs = nm.Softmax(cls, name="probs")
    tgt = nm.Input([2, *probs.shape.spatial_shape], "b,x,y", dtype="int32",
                   name="target")
    loss = nm.AggregateLoss(nm.MultinoulliNLL(probs, tgt,
                                              target_is_sparse=True),
                            name="loss")
    return inp, tgt, loss, probs, cls


@pytest.fixture
def pair(tmp_path):
    with graph("elektronn2_tpu") as gm:
        inp, tgt, loss, probs, cls = build(jnm)
        jm = gm.getmodel()
        jm.designate_nodes(input_node=inp, target_node=tgt, loss_node=loss,
                           prediction_node=probs, prediction_ext_node=cls)
    fname = str(tmp_path / "api.mdl")
    jm.save(fname)
    return jm, modelload(fname, device="cpu"), fname


def feeds():
    rng = np.random.RandomState(0)
    x = rng.rand(2, 1, 12, 12).astype(np.float32)
    y = (rng.rand(2, 3, 3) > 0.5).astype(np.int32)
    return x, y


def test_get_activations(pair):
    jm, m, _ = pair
    x, y = feeds()
    want = jm.get_activations(x, ["c1", jm.nodes["probs"], "loss"],
                              target=y)
    got = m.get_activations(torch.from_numpy(x),
                            ["c1", m.nodes["probs"], "loss"],
                            target=torch.from_numpy(y))
    assert set(got) == set(want) == {"c1", "probs", "loss"}
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   atol=ATOL)
    assert not got["c1"].requires_grad


def test_predict_ext(pair):
    jm, m, _ = pair
    x, _ = feeds()
    np.testing.assert_allclose(m.predict_ext(torch.from_numpy(x)).numpy(),
                               np.asarray(jm.predict_ext(x)), atol=ATOL)
    assert m.predict_ext(torch.from_numpy(x)).shape[1] == 2
    m.prediction_ext_node = None                 # falls back to predict
    np.testing.assert_array_equal(m.predict_ext(torch.from_numpy(x)).numpy(),
                                  m.predict(torch.from_numpy(x)).numpy())


@pytest.mark.parametrize("which", ["small", "flagship"])
def test_kernel_lists(pair, which):
    jm, m, _ = pair
    if which == "flagship":
        from __graft_entry__ import _flagship_model
        from elektronn2_tpu_torch.utils.convert import flagship_model
        jm = _flagship_model(mfp=True, patch=[11, 27, 27])
        m = flagship_model(mfp=True, patch=[11, 27, 27], device="cpu")
    assert m.kernel_lists == jm.kernel_lists
    assert kernel_lists(m) == jax_kernel_lists(jm)


def test_measure_exectimes(pair):
    jm, m, _ = pair
    x, y = feeds()
    want = jm.measure_exectimes(x, y, n_warmup=1, n_runs=1)
    got = m.measure_exectimes(torch.from_numpy(x), torch.from_numpy(y),
                              n_warmup=1, n_runs=1)
    assert list(got) == list(want)
    assert all(t > 0 for t in got.values())
    # without a target the loss's ancestors that need it are skipped
    got = m.measure_exectimes(torch.from_numpy(x), n_warmup=1, n_runs=1)
    assert "c2" in got and "loss" not in got


def test_summary_equals_jax(pair):
    jm, m, _ = pair
    assert m.summary() == jm.summary()
    assert "<- prediction_node" in m.summary()


def test_params_from_model_file(pair, tmp_path):
    jm, m, fname = pair
    want = jax_params_from_file(fname)
    got = params_from_model_file(fname)
    assert set(got) == set(want)
    for n in want:
        assert set(got[n]) == set(want[n])
        for k in want[n]:
            np.testing.assert_array_equal(got[n][k], want[n][k])
    with pytest.raises(NotImplementedError, match="orbax"):
        params_from_model_file(str(tmp_path))
    assert tnm.params_from_model_file is params_from_model_file
