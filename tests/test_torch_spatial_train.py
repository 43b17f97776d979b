"""Z-sharded DP x SP training of the port (``parallel/spatial_train.py``,
the differentiable halo exchange of ``parallel/halo.py``) on eight spawned
CPU ranks, against the port's unsharded step and the JAX package's.

Mirrors ``tests/test_parallel.py`` :153, :209, :226, :642, :793, :857 and
:1007. One spawn of eight ``gloo`` ranks (``torch_scaleout_workers.
spatial_cases``, jax-free) runs every sharded case: ``{data: 2, space: 4}``
and the three-axis ``{data: 2, space: 2, model: 2}``. Every rank is given
the global batch, so the ranks must agree bit for bit.

Tolerances:
- against the port's unsharded ``trainingstep`` on the same weights and
  batches: the loss rtol 1e-6, the parameters atol 1e-6 (the sharded convs
  sum over other extents);
- against the JAX package's unsharded ``trainingstep``: the JAX tests' own
  rtol 1e-5 on the loss (2e-5 over a fused chunk, as :793 states it), rtol
  1e-4 / atol 1e-6 on the parameters;
- the halo exchange's gradient against ``torch.autograd.grad`` of the
  unsharded composition: 1e-6.
The JAX package folds the data and space indices into its dropout key; the
port draws at the unsharded shape (``TraceCtx.draw``), so dropout is held
to the port's unsharded step only.
"""

import os
import sys

import numpy as np
import pytest
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))
sys.path.insert(0, HERE)
import elektronn2_tpu.neuromancer as jnm  # noqa: E402
import elektronn2_tpu_torch.neuromancer as tnm  # noqa: E402
import torch_dp_workers as W  # noqa: E402
import torch_scaleout_workers as S  # noqa: E402
from elektronn2_tpu_torch.parallel import (  # noqa: E402
    make_fused_spatial_trainstep, make_spatial_dp_trainstep,
    pad_target_for_spatial)
from elektronn2_tpu_torch.utils.convert import params_from_jax  # noqa: E402

torch.set_num_threads(1)
LOSS_RTOL, W_ATOL = 1e-6, 1e-6
JAX_LOSS_RTOL, JAX_CHUNK_RTOL, JAX_W_RTOL, JAX_W_ATOL = 1e-5, 2e-5, 1e-4, 1e-6
HALO_ATOL = 1e-6
Z = 8
_cache = {}


def once(key, fn):
    if key not in _cache:
        _cache[key] = fn()
    return _cache[key]


@pytest.fixture(scope="module")
def spawn_dir(tmp_path_factory):
    return tmp_path_factory.mktemp("spatial")


def pair(**kw):
    """(JAX net, the port's net with its weights, the weights)."""
    jm = S.spatial_net(jnm, **kw)
    tm = S.spatial_net(tnm, **kw)
    tm.set_params(params_from_jax(jm.params, tm))
    return jm, tm, W.params_np(tm)


def batch(m, seed):
    """(data, target, z-padded target) of ``m``'s shapes."""
    r = np.random.RandomState(seed)
    d = r.rand(2, 1, Z, 14, 14).astype(np.float32)
    zo, xo, yo = m.prediction_node.shape.spatial_shape
    t = (r.rand(2, zo, xo, yo) > 0.5).astype(np.int32)
    return d, t, pad_target_for_spatial(t, Z)


def unsharded(jm, tm, batches):
    """K trainingsteps of the JAX net and of the port's: (JAX losses,
    JAX params, port losses, port params)."""
    jl = [float(jm.trainingstep(d, t)[0]) for d, t, _ in batches]
    tl = [float(tm.trainingstep(torch.from_numpy(d),
                                torch.from_numpy(t))[0])
          for d, t, _ in batches]
    jp = {n: {p: np.asarray(v) for p, v in d.items()}
          for n, d in jm.params.items()}
    return jl, jp, tl, W.params_np(tm)


def assert_params(got, want, rtol, atol, what=""):
    for n in want:
        for p in want[n]:
            np.testing.assert_allclose(got[n][p], want[n][p], rtol=rtol,
                                       atol=atol, err_msg=f"{what} {n}/{p}")


def halo_inputs():
    r = np.random.RandomState(9)
    x = r.rand(1, 2, Z, 3, 3).astype(np.float32)
    return x, {h: r.rand(1, 2, Z + h, 3, 3).astype(np.float32)
               for h in (1, 2, 3)}


def _jax_dims(jm):
    """The JAX package's ``spatial_tp_shardings`` on the conftest's virtual
    {data: 2, space: 2, model: 2} mesh, as the dim each leaf is split on
    (None: replicated)."""
    from elektronn2_tpu.parallel import make_mesh as jax_mesh
    from elektronn2_tpu.parallel import spatial_tp_shardings as jax_rule
    jp, jo = jax_rule(jm, jax_mesh({"data": 2, "space": 2, "model": 2}),
                      "model")

    def dims(tree):
        return {n: {p: (tuple(s.spec).index("model")
                        if "model" in tuple(s.spec) else None)
                    for p, s in d.items()} for n, d in tree.items()}

    slots = jo["slots"] if isinstance(jo, dict) else jo[1]
    return dims(jp), [dims(sl) for sl in slots]


def _runs(spawn_dir):
    def run():
        # each pair's unsharded references right after it is built (the
        # next build resets the graph)
        ref = {}
        j2, t2, w2 = pair()
        one = batch(t2, 0)
        ref["jax_dims"] = _jax_dims(j2)
        ref["one"] = unsharded(j2, t2, [one])
        j1, t1, w1 = pair(two_convs=False)
        chunk = [batch(t1, s) for s in (1, 2, 3)]
        chunk3 = [batch(t1, s) for s in (4, 5)]
        ref["chunk"] = unsharded(j1, t1, chunk)
        j1, t1, _ = pair(two_convs=False)
        ref["chunk3"] = unsharded(j1, t1, chunk3)
        _, td, wd = pair(dropout=0.3)
        td.seed(5)
        ref["dropout"] = (float(td.trainingstep(
            torch.from_numpy(one[0]), torch.from_numpy(one[1]))[0]),
            W.params_np(td))
        ranks = W.run_ranks(
            spawn_dir / "spatial", "torch_scaleout_workers:spatial_cases",
            world=8, w2=w2, w1=w1, wd=wd, batch=(one[0], one[2]),
            batches=([b[0] for b in chunk], [b[2] for b in chunk]),
            batches3=([b[0] for b in chunk3], [b[2] for b in chunk3]),
            halo_in=halo_inputs())
        return ranks, ref
    return once("spatial", run)


def test_ranks_agree_bit_for_bit(spawn_dir):
    ranks, _ = _runs(spawn_dir)
    for r in ranks[1:]:
        for key in ("dpsp", "three", "per_step", "fused", "per_step3",
                    "fused3", "dropout"):
            assert r[key][0] == ranks[0][key][0], key
            for n, d in r[key][1].items():
                for p, v in d.items():
                    assert np.array_equal(v, ranks[0][key][1][n][p]), \
                        (key, n, p)


@pytest.mark.parametrize("mesh", ["dpsp", "three"])
def test_spatial_step_matches_unsharded(spawn_dir, mesh):
    # test_parallel.py:153 ({data: 2, space: 4}) and :642 (the three-axis
    # {data: 2, space: 2, model: 2}): one step equals the unsharded step,
    # the gradients through every halo row included (c1's reach c2's
    # halo), within the stated tolerances of both packages
    ranks, ref = _runs(spawn_dir)
    jl, jp, tl, tp = ref["one"]
    np.testing.assert_allclose(tl, jl, rtol=JAX_LOSS_RTOL)
    for r in ranks:
        losses, params, _ = r[mesh]
        np.testing.assert_allclose(losses, tl, rtol=LOSS_RTOL)
        np.testing.assert_allclose(losses, jl, rtol=JAX_LOSS_RTOL)
        assert_params(params, tp, 0, W_ATOL, "vs port")
        assert_params(params, jp, JAX_W_RTOL, JAX_W_ATOL, "vs JAX")


def test_three_axis_keeps_channel_shards(spawn_dir):
    # the model axis really splits the channels: each rank updated its
    # shards (half of each conv's output features)
    ranks, _ = _runs(spawn_dir)
    for r in ranks:
        shapes = r["three"][2]
        assert shapes["c1"]["w"] == (2, 1, 3, 3, 3)
        assert shapes["c1"]["b"] == (2,)
        assert shapes["c2"]["w"] == (2, 4, 3, 3, 3)


def test_spatial_tp_shardings_match_jax(spawn_dir):
    # the rule's dims against the JAX package's spatial_tp_shardings on
    # the conftest's virtual mesh of the same shape
    ranks, ref = _runs(spawn_dir)
    jdims, jslots = ref["jax_dims"]
    for r in ranks:
        pdims, odims = r["three_dims"]
        assert pdims == jdims
        assert odims["step"] is None
        assert list(odims["slots"]) == jslots
    assert jdims["c1"] == {"w": 0, "b": 0}


@pytest.mark.parametrize("mesh", ["", "3"])
def test_fused_spatial_matches_per_step(spawn_dir, mesh):
    # test_parallel.py:793 (K = 3 on {data: 2, space: 4}) and :857 (K = 2
    # on the three-axis mesh): the fused chunk equals the per-step calls,
    # and both the unsharded steps of either package
    ranks, ref = _runs(spawn_dir)
    jl, jp, tl, tp = ref[f"chunk{mesh}"]
    for r in ranks:
        per, fused = r[f"per_step{mesh}"], r[f"fused{mesh}"]
        np.testing.assert_allclose(fused[0], per[0], rtol=LOSS_RTOL)
        assert_params(fused[1], per[1], 0, W_ATOL, "fused vs per step")
        np.testing.assert_allclose(fused[0], tl, rtol=LOSS_RTOL)
        np.testing.assert_allclose(fused[0], jl, rtol=JAX_CHUNK_RTOL)
        assert_params(fused[1], tp, 0, W_ATOL, "vs port")
        assert_params(fused[1], jp, JAX_W_RTOL, JAX_W_ATOL, "vs JAX")


@pytest.mark.parametrize("halo", [1, 2, 3])
def test_halo_gradient_matches_unsharded_autograd(spawn_dir, halo):
    # halo_gather_grad on four space ranks (z_local 2): a one-row, a
    # whole-shard and a two-hop halo; every halo row's gradient lands on
    # the rank that owns the row, as autograd.grad of the unsharded
    # composition puts it (zero rows past the end get none)
    ranks, _ = _runs(spawn_dir)
    x, wext = halo_inputs()
    X = torch.from_numpy(x).requires_grad_()
    Xz = torch.cat([X, torch.zeros(1, 2, halo, 3, 3)], dim=2)
    w = torch.from_numpy(wext[halo])
    total = sum(torch.sum(Xz[:, :, q * 2:q * 2 + 2 + halo]
                          * w[:, :, q * 2:q * 2 + 2 + halo])
                for q in range(4))
    want = torch.autograd.grad(total, X)[0].numpy()
    for d in (0, 4):                 # ranks of each data index, space 0-3
        got = np.concatenate([ranks[d + q]["halo"][halo] for q in range(4)],
                             axis=2)
        np.testing.assert_allclose(got, want, rtol=0, atol=HALO_ATOL)


def test_dropout_draws_are_the_unsharded_steps(spawn_dir):
    # dropout's masks drawn at the unsharded (B, f, Z_node, x, y) shape and
    # each rank's (batch, z) block kept: the same step as one process with
    # the same generator seed
    ranks, ref = _runs(spawn_dir)
    loss, params = ref["dropout"]
    for r in ranks:
        np.testing.assert_allclose(r["dropout"][0], [loss], rtol=LOSS_RTOL)
        assert_params(r["dropout"][1], params, 0, W_ATOL)


# ------------------------------------------------ the graph's checks

def _rejected(build_port, match):
    with W.mesh_of_one({"data": 1, "space": 1}) as mesh:
        m = build_port(tnm)
        m.set_opt("SGD", lr=0.01)
        with pytest.raises(ValueError, match=match):
            make_spatial_dp_trainstep(m, mesh)
        with pytest.raises(ValueError, match=match):
            make_fused_spatial_trainstep(m, mesh, 2)


def test_rejects_z_pool_and_mfp():
    # test_parallel.py:209, and MFP (the JAX check's second clause)
    def zpool(nm):
        nm.model_manager.reset(seed=11)
        inp = nm.Input([2, 1, 8, 9, 9], "b,f,z,x,y", name="raw")
        c1 = nm.Conv(inp, 2, (3, 3, 3), (2, 1, 1), name="c1")
        return _head(nm, inp, c1)

    def mfp(nm):
        nm.model_manager.reset(seed=11)
        inp = nm.Input([1, 1, 8, 9, 9], "b,f,z,x,y", name="raw")
        c1 = nm.Conv(inp, 2, (1, 3, 3), (1, 2, 2), mfp=True, name="c1")
        return _head(nm, inp, c1)

    _rejected(zpool, "z-pooling")
    _rejected(mfp, "MFP training")


def _head(nm, inp, h):
    probs = nm.Softmax(nm.Conv(h, 2, 1, 1, activation_func="lin"))
    tgt = nm.Input([probs.shape["b"], *probs.shape.spatial_shape],
                   "b,z,x,y", dtype="int32", name="target")
    loss = nm.AggregateLoss(nm.MultinoulliNLL(probs, tgt,
                                              target_is_sparse=True))
    m = nm.model_manager.getmodel()
    m.designate_nodes(input_node=inp, target_node=tgt, loss_node=loss,
                      prediction_node=probs)
    return m


def test_rejects_z_cropping_merge_and_z_crop():
    # test_parallel.py:226: a FaithlessMerge whose parents differ in z,
    # and an explicit z Crop
    def merge(nm):
        nm.model_manager.reset(seed=11)
        inp = nm.Input([2, 1, 8, 16, 16], "b,f,z,x,y", name="raw")
        e0 = nm.Conv(inp, 4, (1, 3, 3), (1, 1, 1), name="e0")
        e1 = nm.Conv(e0, 6, (3, 3, 3), (1, 2, 2), name="e1")
        up = nm.UpConv(e1, 4, (1, 2, 2), activation_func="relu", name="up")
        return _head(nm, inp, nm.FaithlessMerge(up, e0, name="mg"))

    def crop(nm):
        nm.model_manager.reset(seed=11)
        inp = nm.Input([2, 1, 8, 9, 9], "b,f,z,x,y", name="raw")
        c = nm.Conv(inp, 2, (1, 3, 3), (1, 1, 1), name="c")
        return _head(nm, inp, nm.Crop(c, [(1, 1), (0, 0), (0, 0)],
                                      name="cr"))

    _rejected(merge, "misaligned skip rows")
    _rejected(crop, "z crop")


def test_rejects_batchnorm():
    # test_parallel.py:1007
    def bn(nm):
        nm.model_manager.reset(seed=1)
        inp = nm.Input([2, 1, 8, 12, 12], "b,f,z,x,y", name="raw")
        c1 = nm.Conv(inp, 4, 3, 1, batch_normalisation=True, name="c1")
        return _head(nm, inp, c1)

    _rejected(bn, "BatchNorm")


def test_rejects_other_loss_graphs_and_bad_chunks():
    def two_maps(nm):
        m = S.spatial_net(nm)
        m.loss_node = nm.AggregateLoss([m.nodes["nll"], m.nodes["nll"]])
        return m

    _rejected(two_maps, "AggregateLoss over one")
    with W.mesh_of_one({"data": 1, "space": 1}) as mesh:
        with pytest.raises(ValueError, match="n_inner"):
            make_fused_spatial_trainstep(S.spatial_net(tnm), mesh, 0)


def test_pad_target_for_spatial_matches_jax():
    from elektronn2_tpu.parallel import pad_target_for_spatial as jpad
    t = np.random.RandomState(0).randint(0, 2, (2, 4, 5, 5)).astype(np.int32)
    want = np.asarray(jpad(t, 8))
    np.testing.assert_array_equal(pad_target_for_spatial(t, 8), want)
    np.testing.assert_array_equal(
        pad_target_for_spatial(torch.from_numpy(t), 8).numpy(), want)
    assert pad_target_for_spatial(t, 4) is t


def test_mesh_of_one_step_equals_unsharded_and_conv_supports_halo():
    # in-process: a {data: 1, space: 1} step (the halo of the last rank is
    # zeros only) equals trainingstep; conv_supports_halo reads the context
    from elektronn2_tpu_torch.neuromancer.node_basic import TraceCtx
    from elektronn2_tpu_torch.parallel.spatial_train import conv_supports_halo
    _, tm, w = pair()
    d, t, tpad = batch(tm, 3)
    ref = float(tm.trainingstep(torch.from_numpy(d), torch.from_numpy(t))[0])
    with W.mesh_of_one({"data": 1, "space": 1}) as mesh:
        m = S.port(S.spatial_net, w)
        step = make_spatial_dp_trainstep(m, mesh)
        loss, p, _, _ = step(m.params, m.opt_state, m.state,
                             torch.from_numpy(d), torch.from_numpy(tpad),
                             m.optimiser.current_hyper("cpu"), None)
        assert p is m.params                      # updated in place
        with pytest.raises(ValueError, match="no axis 'model'"):
            make_spatial_dp_trainstep(m, mesh, model_axis="model")
    np.testing.assert_allclose(float(loss), ref, rtol=LOSS_RTOL)
    assert_params(W.params_np(m), W.params_np(tm), 0, W_ATOL)
    ctx = TraceCtx({}, {})
    assert not conv_supports_halo(ctx)
    ctx.halo_axis = object()
    assert conv_supports_halo(ctx)
