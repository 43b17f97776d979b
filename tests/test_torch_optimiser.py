"""The port's optimisers against the JAX package's ``Optimiser.update``.

The same numpy parameters, gradients and state go through both for three
steps; every parameter and slot, and the step counter, must agree (rtol
1e-6, atol 1e-7: the same float32 arithmetic in the same order, up to an
ulp or two where XLA and PyTorch round a power or a reduction differently).
Cases cover weight decay, the global-norm clip active and inactive,
lr_mult / wd_mult other than 1, Nesterov momentum and a ``setlr`` between
steps.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from elektronn2_tpu.neuromancer import optimiser as jopt
from elektronn2_tpu_torch.neuromancer import optimiser as topt

torch.set_num_threads(1)
TOL = dict(rtol=1e-6, atol=1e-7)

SHAPES = {"c1": {"w": (3, 2, 1, 3, 3), "b": (3,)},
          "cls": {"w": (2, 3, 1, 1, 1), "b": (2,)}}
MULTS = ({"c1": {"w": 0.5, "b": 2.0}, "cls": {"w": 1.0, "b": 0.0}},
         {"c1": {"w": 2.0, "b": 0.0}, "cls": {"w": 0.5, "b": 1.0}})

CASES = [
    ("SGD", {"lr": 1e-2, "mom": 0.9}, False),
    ("SGD", {"lr": 1e-2, "mom": 0.8, "nesterov": True, "wd": 1e-2}, True),
    ("SGD", {"lr": 5e-2, "mom": 0.9, "clip": 0.5}, False),
    ("Adam", {"lr": 1e-3}, False),
    ("Adam", {"lr": 1e-3, "wd": 5e-2, "clip": 0.3}, True),
    ("Adam", {"lr": 2e-3, "beta1": 0.8, "clip": 100.0}, False),
    ("AdaGrad", {"lr": 1e-2, "wd": 1e-2}, True),
    ("AdaGrad", {"lr": 1e-2, "clip": 0.4}, False),
    ("AdaDelta", {}, False),
    ("AdaDelta", {"lr": 0.5, "rho": 0.9, "wd": 1e-2, "clip": 0.2}, True),
]


def _tree(rng, scale=1.0):
    return {n: {p: (rng.standard_normal(s) * scale).astype(np.float32)
                for p, s in d.items()} for n, d in SHAPES.items()}


def _as_torch(tree):
    return {n: {p: torch.from_numpy(v.copy()) for p, v in d.items()}
            for n, d in tree.items()}


@pytest.mark.parametrize("name, hyper, mults", CASES)
def test_update_matches_jax(name, hyper, mults):
    rng = np.random.RandomState(3)
    params = _tree(rng)
    jo = jopt.get_optimiser(name)(**hyper)
    to = topt.get_optimiser(name)(**hyper)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    js = jo.init_state(jp)
    tp = _as_torch(params)
    ts = to.init_state(tp)
    lm, wm = MULTS if mults else (None, None)
    for step in range(3):
        grads = _tree(rng, scale=0.7)
        if step == 2:                 # a live change between steps
            jo.setlr(jo.hyperparams["lr"] * 0.5)
            to.setlr(to.hyperparams["lr"] * 0.5)
            if "mom" in jo.hyperparams:
                jo.setmom(0.5)
                to.setmom(0.5)
        jp, js = jo.update(jp, jax.tree_util.tree_map(jnp.asarray, grads),
                           js, jo.current_hyper(), lm, wm)
        to.update(tp, _as_torch(grads), ts, to.current_hyper(), lm, wm)
    assert int(ts["step"]) == int(js["step"]) == 3
    for n, d in params.items():
        for p in d:
            np.testing.assert_allclose(tp[n][p].numpy(), np.asarray(jp[n][p]),
                                       err_msg=f"{name} {n}/{p}", **TOL)
    assert len(ts["slots"]) == len(js["slots"])
    for k, (a, b) in enumerate(zip(ts["slots"], js["slots"])):
        for n, d in params.items():
            for p in d:
                np.testing.assert_allclose(
                    a[n][p].numpy(), np.asarray(b[n][p]),
                    err_msg=f"{name} slot {k} {n}/{p}", **TOL)


def test_opt_leaves_follow_jax_tree_order():
    """The leaves of the state, as ``Model.save`` writes them, in
    ``jax.tree_util.tree_leaves``' order (slots before step, sorted node
    and parameter names)."""
    rng = np.random.RandomState(5)
    params = _tree(rng)
    js = jopt.Adam().init_state(jax.tree_util.tree_map(jnp.asarray, params))
    ts = topt.Adam().init_state(_as_torch(params))
    ts["slots"][1]["cls"]["b"].fill_(3.0)
    js["slots"][1]["cls"]["b"] = jnp.full((2,), 3.0)
    js["step"] = jnp.int32(7)
    ts["step"].fill_(7)
    jl = jax.tree_util.tree_leaves(js)
    tl = topt.opt_leaves(ts)
    assert len(jl) == len(tl)
    for a, b in zip(tl, jl):
        assert tuple(a.shape) == tuple(np.shape(b))
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_current_hyper_is_one_set_of_device_scalars():
    """``current_hyper`` returns the same tensors on every call, with the
    live values written into them: what a captured graph reads."""
    opt = topt.SGD(lr=0.1)
    h1 = opt.current_hyper()
    opt.setlr(0.25)
    opt.setwd(0.5)
    h2 = opt.current_hyper()
    assert all(h1[k] is h2[k] for k in h1)
    assert float(h1["lr"]) == 0.25 and float(h1["wd"]) == 0.5
    assert h1["lr"].dtype == torch.float32 and h1["lr"].ndim == 0
    with pytest.raises(ValueError):
        topt.Adam().setmom(0.5)
    with pytest.raises(ValueError):
        topt.Adam(momentum=0.5)
    with pytest.raises(ValueError):
        topt.get_optimiser("RMSprop")
