"""The port's MALIS (``elektronn2_tpu_torch/malis``, ``MalisNLL``,
``data/image.py::make_affinities``) against the JAX package's, on the CPU.

The first thirteen tests are the counterparts of tests/test_malis.py, run
against the port. The rest feed both packages the same seed-made numpy
inputs: the pair weights must be equal bit for bit (the same C++ core, the
same numpy fallback, the same float32 normalisation); the weighted NLL's
map and its gradient in ``pred`` within 1e-6 (absolute) of the JAX
package's, whose gradient goes through ``jax.pure_callback``; the losses of
a MalisNLL model loaded from the other package's ``.mdl`` within rtol 1e-5
(float32 convs summed in another order).
"""

import filecmp
import os

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp
from scipy import ndimage

import elektronn2_tpu.malis as jmalis
import elektronn2_tpu.neuromancer as jnm
from elektronn2_tpu.data.image import make_affinities as jax_make_affinities
from elektronn2_tpu.neuromancer.model import modelload as jax_modelload
import elektronn2_tpu_torch.malis as tmalis
import elektronn2_tpu_torch.neuromancer as tnm
from elektronn2_tpu_torch.malis import (
    mknhood3d, mknhood2d, seg_to_affgraph, malis_weights,
    malis_weighted_nll, default_nhood,
)
from elektronn2_tpu_torch.neuromancer.model import Model, modelload
from elektronn2_tpu_torch.scripts import train as train_cli

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NLL_ATOL = 1e-6
LOSS_RTOL = 1e-5


# --------------------------------------- counterparts of tests/test_malis.py

def test_mknhood3d():
    nh = mknhood3d(1)
    assert nh.shape == (3, 3)
    assert set(map(tuple, nh)) == {(-1, 0, 0), (0, -1, 0), (0, 0, -1)}
    assert np.array_equal(default_nhood(3), nh)


def test_seg_to_affgraph_1d_line():
    seg = np.array([[[1, 1, 0, 2, 2]]], np.int32)  # (1,1,5)
    nh = np.array([[0, 0, -1]], np.int32)
    aff = np.asarray(seg_to_affgraph(seg, nh))
    # aff[0, z, x, y] = 1 iff seg[y]==seg[y-1]!=0
    np.testing.assert_array_equal(aff[0, 0, 0], [0, 1, 0, 0, 1])


def test_seg_to_affgraph_torch_matches_numpy(rng):
    seg = rng.randint(0, 3, (4, 5, 6)).astype(np.int32)
    nh = np.concatenate([mknhood3d(1), [[0, 0, 9]]])    # one edge past Y
    a_np = seg_to_affgraph(seg, nh)
    a_t = seg_to_affgraph(torch.from_numpy(seg), nh)
    assert isinstance(a_t, torch.Tensor) and a_t.dtype == torch.float32
    np.testing.assert_array_equal(a_np, a_t.numpy())
    np.testing.assert_array_equal(
        a_np, np.asarray(jmalis.seg_to_affgraph(seg, nh)))


def test_malis_weights_simple_line():
    """1D line, 2 objects: the weakest edge inside each object gets the
    positive pairs; the max-affinity edge between objects gets the
    negative pairs."""
    seg = np.array([[[1, 1, 1, 2, 2]]], np.int32)
    nh = np.array([[0, 0, -1]], np.int32)
    aff = np.zeros((1, 1, 1, 5), np.float32)
    aff[0, 0, 0] = [0, 0.9, 0.4, 0.3, 0.8]
    pos, neg = malis_weights(aff, seg, nh)
    assert pos[0, 0, 0, 1] == 1 and pos[0, 0, 0, 2] == 2
    assert pos[0, 0, 0, 4] == 1
    assert neg[0, 0, 0, 3] == 6
    assert neg.sum() == 6 and pos.sum() == 4


def test_malis_weights_2d_grid(rng):
    """Totals on a small grid: positive pairs = sum over objects of nC2;
    negative = the cross pairs between labelled voxels."""
    seg3 = np.zeros((1, 3, 3), np.int32)
    seg3[0, :, 0] = 1
    seg3[0, :, 2] = 2
    nh = np.array([[0, -1, 0], [0, 0, -1]], np.int32)
    aff = rng.rand(2, 1, 3, 3).astype(np.float32)
    pos, neg = malis_weights(aff, seg3, nh)
    assert pos.sum() == 3 + 3
    assert neg.sum() == 9
    assert (pos >= 0).all() and (neg >= 0).all()


def test_malis_nll_gradient_direction():
    """The MALIS NLL pushes the bridge edge's affinity down and the
    intra-object affinities up."""
    seg = torch.tensor([[[[1, 1, 2, 2]]]], dtype=torch.int32)
    nh = np.array([[0, 0, -1]], np.int32)
    pred = torch.zeros((1, 1, 1, 1, 4))
    pred[0, 0, 0, 0] = torch.tensor([0.5, 0.9, 0.5, 0.9])
    pred.requires_grad_(True)
    torch.sum(malis_weighted_nll(pred, None, seg, nh)).backward()
    g = pred.grad[0, 0, 0, 0]
    assert g[1] < 0      # intra-object edge (0-1): increase affinity
    assert g[2] > 0      # bridge edge (1-2): decrease affinity
    assert g[3] < 0      # intra-object edge (2-3)


def malis_net(nm, seed=4):
    """tests/test_malis.py::test_malis_nll_node's graph: two 1x1 convs to
    three sigmoid affinities, MalisNLL against a segmentation input."""
    nm.model_manager.reset(seed=seed)
    inp = nm.Input([1, 1, 3, 8, 8], "b,f,z,x,y", name="raw")
    c = nm.Conv(inp, 4, 1, 1, name="c1")
    aff = nm.Conv(c, 3, 1, 1, activation_func="sig", name="aff")
    seg = nm.Input([1, 3, 8, 8], "b,z,x,y", dtype="int32", name="seg")
    mal = nm.MalisNLL(aff, None, seg, name="malis")
    loss = nm.AggregateLoss(mal)
    m = nm.model_manager.getmodel()
    m.designate_nodes(input_node=inp, target_node=seg, loss_node=loss,
                      prediction_node=aff)
    return m


def malis_feed(seed=42):
    x = np.random.RandomState(seed).rand(1, 1, 3, 8, 8).astype(np.float32)
    segv = np.ones((1, 3, 8, 8), np.int32)
    segv[:, :, :, 4:] = 2
    return x, segv


def test_malis_nll_node():
    """MalisNLL trains end to end in a graph."""
    m = malis_net(tnm)
    m.to("cpu")
    m.set_opt("Adam", lr=5e-3)
    x, segv = map(torch.from_numpy, malis_feed())
    losses = [float(m.trainingstep(x, segv)[0]) for _ in range(10)]
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0]


def test_mknhood2d_radius2():
    nh = mknhood2d(2)
    assert len(set(map(tuple, nh))) == len(nh)
    for o in map(tuple, nh):
        assert o != (0, 0)
        assert o[0] ** 2 + o[1] ** 2 <= 4
        assert tuple(-np.array(o)) not in set(map(tuple, nh))
    np.testing.assert_array_equal(nh, jmalis.mknhood2d(2))


def test_mknhood3d_aniso():
    from elektronn2_tpu_torch.malis import mknhood3d_aniso
    nh = mknhood3d_aniso(1, 1.8)
    rows = set(map(tuple, nh))
    assert {(0, -1, 0), (0, 0, -1), (-1, 0, 0)} <= rows
    assert (-1, -1, 0) in rows and (-1, 1, 0) in rows
    assert (-1, 0, -1) in rows and (-1, 0, 1) in rows
    for o in rows:
        if o[0] == -1:
            assert o[1] ** 2 + o[2] ** 2 <= 1.8 ** 2
    assert len(rows) == len(nh)
    np.testing.assert_array_equal(nh, jmalis.mknhood3d_aniso(1, 1.8))
    np.testing.assert_array_equal(mknhood3d(1.5), jmalis.mknhood3d(1.5))


def test_affgraph_to_edgelist_roundtrip():
    from elektronn2_tpu_torch.malis import affgraph_to_edgelist
    rng = np.random.RandomState(0)
    seg = rng.randint(0, 3, size=(3, 4, 5)).astype(np.int32)
    nhood = mknhood3d(1)
    aff = np.asarray(seg_to_affgraph(seg, nhood))
    n1, n2, w = affgraph_to_edgelist(aff, nhood)
    expect = 2 * 4 * 5 + 3 * 3 * 5 + 3 * 4 * 4
    assert len(n1) == len(n2) == len(w) == expect
    flat = seg.reshape(-1)
    for v, u, weight in zip(n1[:50], n2[:50], w[:50]):
        assert weight == float((flat[v] == flat[u]) and flat[v] != 0)
    for got, want in zip((n1, n2, w),
                         jmalis.affgraph_to_edgelist(aff, nhood)):
        np.testing.assert_array_equal(got, want)


def test_connected_components_matches_labels():
    from elektronn2_tpu_torch.malis import connected_components
    seg = np.zeros((4, 6, 6), np.int32)
    seg[:, :2, :2] = 5
    seg[:, 4:, 4:] = 9
    nhood = mknhood3d(1)
    aff = np.asarray(seg_to_affgraph(seg, nhood))
    cc, sizes = connected_components(aff, nhood, threshold=0.5)
    ids_a = np.unique(cc[:, :2, :2])
    ids_b = np.unique(cc[:, 4:, 4:])
    assert len(ids_a) == 1 and len(ids_b) == 1 and ids_a[0] != ids_b[0]
    assert sizes[ids_a[0] - 1] == 4 * 2 * 2
    assert sizes[ids_b[0] - 1] == 4 * 2 * 2
    assert cc.min() >= 1
    assert sizes.sum() == seg.size


def test_compute_v_rand_n2():
    from elektronn2_tpu_torch.malis import compute_V_rand_N2
    gt = np.zeros((4, 4, 4), np.int32)
    gt[:2] = 1
    gt[2:] = 2
    v, vs, vm = compute_V_rand_N2(gt, gt * 7)
    assert v == pytest.approx(1.0) and vs == pytest.approx(1.0) \
        and vm == pytest.approx(1.0)
    merged = np.ones_like(gt)
    v2, vs2, vm2 = compute_V_rand_N2(gt, merged)
    assert vs2 == pytest.approx(1.0)
    assert vm2 == pytest.approx(0.5)
    assert v2 == pytest.approx(2 / 3)
    gt0 = gt.copy()
    gt0[:, :, 0] = 0
    pred = gt * 7
    pred[:, :, 0] = 12345
    v3, _, _ = compute_V_rand_N2(gt0, pred)
    assert v3 == pytest.approx(1.0)


def test_make_affinities_and_downsample_xy():
    from elektronn2_tpu_torch.data.image import downsample_xy, make_affinities
    seg = np.zeros((3, 6, 6), np.int32)
    seg[:, :2, :2] = 1
    seg[:, 4:, 4:] = 1          # same id, spatially disconnected
    seg[:, 4, 0] = 2            # 3-voxel bar
    aff, cc = make_affinities(seg, size_thresh=4)
    assert aff.shape == (3, 3, 6, 6)
    a = np.unique(cc[:, :2, :2])
    b = np.unique(cc[:, 4:, 4:])
    assert len(a) == 1 and len(b) == 1 and a[0] != b[0] and a[0] != 0
    assert (cc[:, 4, 0] == 0).all()
    assert (cc[seg == 0] == 0).all()
    affb, ccb = make_affinities(seg[None], size_thresh=4)
    np.testing.assert_array_equal(ccb[0], cc)
    np.testing.assert_array_equal(affb[0], aff)

    d = np.arange(2 * 3 * 6 * 7, dtype=np.float32).reshape(2, 3, 6, 7)
    lab = np.arange(3 * 6 * 7, dtype=np.int32).reshape(3, 6, 7)
    d2, l2 = downsample_xy(d, lab, factor=2)
    assert d2.shape == (2, 3, 3, 3) and l2.shape == (3, 3, 3)
    assert d2[0, 0, 0, 0] == pytest.approx(d[0, 0, :2, :2].mean())
    assert (l2 == lab[:, :6:2, :6:2]).all()
    d3, l3 = downsample_xy(d, None, factor=3)
    assert d3.shape == (2, 3, 2, 2) and l3 is None


# ------------------------------------------------- parity with the JAX package

def segments(shape, seed, sigma=(0.7, 1, 1), thresh=0.5):
    """Seed-made labels as ``examples/malis3d.py::_synth_data`` makes them
    (``ndimage.label`` of a thresholded smooth field), at ``shape``; the
    field's troughs are labelled too, so a small cube holds several
    objects."""
    field = ndimage.gaussian_filter(
        np.random.RandomState(seed).randn(*shape), sigma[-len(shape):])
    field /= field.std()
    hi, n_hi = ndimage.label(field > thresh)
    lo, n_lo = ndimage.label(field < -thresh)
    assert n_hi + n_lo >= 3      # several objects: negative pairs exist
    return np.where(lo > 0, lo + n_hi, hi).astype(np.int32)


def weight_case(ndim, seed):
    rng = np.random.RandomState(seed)
    shape = (5, 9, 9) if ndim == 3 else (12, 12)
    seg = segments(shape, seed)
    nh = mknhood3d(1) if ndim == 3 else mknhood2d(1)
    aff = rng.rand(len(nh), *shape).astype(np.float32)
    return aff, seg, nh


@pytest.mark.parametrize("ndim", [3, 2])
@pytest.mark.parametrize("unrestrict_neg", [True, False])
@pytest.mark.parametrize("with_aff_gt", [False, True])
def test_malis_weights_equal_jax(ndim, unrestrict_neg, with_aff_gt):
    """The 3D case runs the native core, the 2D one the numpy fallback, in
    both packages; ``aff_gt`` given masks a block of edges to 0.5."""
    aff, seg, nh = weight_case(ndim, seed=3 + ndim)
    aff_gt = None
    if with_aff_gt:
        aff_gt = np.asarray(jmalis.seg_to_affgraph(seg, nh), np.float32)
        aff_gt[(slice(None),) + (slice(0, 3),) * ndim] = 0.5
    got = malis_weights(aff, seg, nh, unrestrict_neg, aff_gt=aff_gt)
    want = jmalis.malis_weights(aff, seg, nh, unrestrict_neg, aff_gt=aff_gt)
    for g, w in zip(got, want):
        assert g.dtype == np.float32
        np.testing.assert_array_equal(g, w)
    assert got[0].sum() > 0 and got[1].sum() > 0


def test_native_core_equals_numpy_fallback():
    assert tmalis.HAVE_NATIVE
    aff, seg, nh = weight_case(3, seed=11)
    nh = np.concatenate([nh, [[-1, -1, 0], [0, -2, 1]]]).astype(np.int32)
    aff = np.random.RandomState(12).rand(len(nh), *seg.shape).astype(
        np.float32)
    aff[:, 1, :3] = 0.5              # ties: the sorts must both be stable
    for count_pos in (True, False):
        np.testing.assert_array_equal(
            tmalis._malis_cpp.malis_pass(aff, seg, nh, count_pos),
            tmalis._malis_pass_np(aff, seg, nh, count_pos))


def test_malis_core_source_is_the_jax_packages():
    assert filecmp.cmp(
        os.path.join(REPO, "elektronn2_tpu_torch", "malis", "malis_core.cpp"),
        os.path.join(REPO, "elektronn2_tpu", "malis", "malis_core.cpp"),
        shallow=False)


def test_native_core_builds_into_the_build_dir():
    from elektronn2_tpu_torch.utils.native_build import BUILD_DIR, shared_path
    so = shared_path(tmalis._malis_cpp._SRC)
    assert os.path.dirname(so) == BUILD_DIR and os.path.exists(so)
    assert not [f for f in os.listdir(os.path.dirname(tmalis.__file__))
                if f.endswith(".so")]


def nll_case(with_aff_gt, seed=21):
    rng = np.random.RandomState(seed)
    shape = (4, 8, 8)
    seg = np.stack([segments(shape, seed + i) for i in range(2)])
    nh = mknhood3d(1)
    pred = rng.rand(2, 3, *shape).astype(np.float32)
    # saturated sigmoids: exactly 0 and 1, and one at eps itself
    pred[0, 0, 0, :2] = 0.0
    pred[0, 1, 1, :2] = 1.0
    pred[1, 2, 2, :2] = 0.0
    pred[1, 0, 3, :2] = 1.0
    pred[1, 1, 0, 0, 0] = np.float32(1e-10)
    aff_gt = None
    if with_aff_gt:
        aff_gt = np.stack([np.asarray(jmalis.seg_to_affgraph(s, nh))
                           for s in seg]).astype(np.float32)
        aff_gt[:, :, :, :2] = 0.5
    return pred, seg, nh, aff_gt


@pytest.mark.parametrize("unrestrict_neg", [True, False])
@pytest.mark.parametrize("with_aff_gt", [False, True])
def test_malis_weighted_nll_and_gradient_match_jax(unrestrict_neg,
                                                   with_aff_gt):
    pred, seg, nh, aff_gt = nll_case(with_aff_gt)
    j_aff = None if aff_gt is None else jnp.asarray(aff_gt)

    def jtotal(p):
        return jnp.sum(jmalis.malis_weighted_nll(
            p, j_aff, jnp.asarray(seg), nh, unrestrict_neg))
    jmap = np.asarray(jmalis.malis_weighted_nll(
        jnp.asarray(pred), j_aff, jnp.asarray(seg), nh, unrestrict_neg))
    jgrad = np.asarray(jax.grad(jtotal)(jnp.asarray(pred)))

    tp = torch.tensor(pred, requires_grad=True)
    tmap = malis_weighted_nll(
        tp, None if aff_gt is None else torch.from_numpy(aff_gt),
        torch.from_numpy(seg), nh, unrestrict_neg)
    tmap.sum().backward()
    assert tmap.shape == (2, 4, 8, 8)
    np.testing.assert_allclose(tmap.detach().numpy(), jmap, rtol=0,
                               atol=NLL_ATOL)
    np.testing.assert_allclose(tp.grad.numpy(), jgrad, rtol=0,
                               atol=NLL_ATOL)
    # the saturated predictions: no gradient below eps, half at it
    assert np.isfinite(tp.grad.numpy()).all()
    assert (tp.grad.numpy()[0, 0, 0, :2] == jgrad[0, 0, 0, :2]).all()
    assert tp.grad[1, 1, 0, 0, 0] == jgrad[1, 1, 0, 0, 0]


def test_malis_nll_saturated_predictions_match_jax():
    """A saturated sigmoid on edges that carry weight: 0.0 on an object's
    only inner path (positive weight: that log's argument clips at eps and
    gives no gradient), 1.0 on the bridge (negative weight: the same on the
    other log, so no gradient at all) and eps itself on another inner edge
    (``jnp.maximum`` splits the gradient at the tie: half of it). The map
    and the gradient equal the JAX package's (rtol 1e-6: the values reach
    1e10)."""
    seg = np.array([[[[1, 1, 1, 2, 2, 2]]]], np.int32)
    nh = np.array([[0, 0, -1]], np.int32)
    pred = np.zeros((1, 1, 1, 1, 6), np.float32)
    pred[0, 0, 0, 0] = [0.5, 0.0, np.float32(1e-10), 1.0, 0.7, 0.6]

    def jtotal(p):
        return jnp.sum(jmalis.malis_weighted_nll(p, None, jnp.asarray(seg),
                                                 nh))
    jmap = np.asarray(jmalis.malis_weighted_nll(jnp.asarray(pred), None,
                                                jnp.asarray(seg), nh))
    jgrad = np.asarray(jax.grad(jtotal)(jnp.asarray(pred)))
    tp = torch.tensor(pred, requires_grad=True)
    tmap = malis_weighted_nll(tp, None, torch.from_numpy(seg), nh)
    tmap.sum().backward()
    g = tp.grad.numpy()[0, 0, 0, 0]
    assert g[3] == 0 and g[2] < -1e8
    np.testing.assert_allclose(tmap.detach().numpy(), jmap, rtol=1e-6,
                               atol=NLL_ATOL)
    np.testing.assert_allclose(tp.grad.numpy(), jgrad, rtol=1e-6,
                               atol=NLL_ATOL)


def test_malis_nll_round_trips_both_ways(tmp_path):
    """A JAX-saved MalisNLL model loads into the port with the same loss;
    after a port step, the port's file loads back into the JAX package with
    the port's loss."""
    jm = malis_net(jnm)
    x, segv = malis_feed(seed=5)
    f1 = str(tmp_path / "jax.mdl")
    jm.save(f1)
    tm = modelload(f1, device="cpu")
    node = tm.nodes["malis"]
    assert type(node).__name__ == "MalisNLL" and node.host_sync
    np.testing.assert_array_equal(node.nhood, jm.nodes["malis"].nhood)
    tx, tseg = torch.from_numpy(x), torch.from_numpy(segv)
    np.testing.assert_allclose(float(tm.loss(tx, tseg)),
                               float(jm.loss(x, segv)), rtol=LOSS_RTOL)
    tm.set_opt("Adam", lr=1e-2)
    tm.trainingstep(tx, tseg)
    f2 = str(tmp_path / "port.mdl")
    tm.save(f2)
    back = jax_modelload(f2)
    np.testing.assert_allclose(float(back.loss(x, segv)),
                               float(tm.loss(tx, tseg)), rtol=LOSS_RTOL)


def test_malis_nll_with_aff_gt_and_options_match_jax():
    """``aff_gt`` as a third input, a neighbourhood of its own and
    ``unrestrict_neg=False``: the node's loss map equals the JAX node's."""
    losses = []
    for nm in (jnm, tnm):
        nm.model_manager.reset(seed=7)
        inp = nm.Input([1, 1, 3, 8, 8], "b,f,z,x,y", name="raw")
        aff = nm.Conv(inp, 4, 1, 1, activation_func="sig", name="aff")
        agt = nm.Input([1, 4, 3, 8, 8], "b,f,z,x,y", name="agt")
        seg = nm.Input([1, 3, 8, 8], "b,z,x,y", dtype="int32", name="seg")
        nh = np.concatenate([mknhood3d(1), [[0, -1, -1]]]).astype(np.int32)
        mal = nm.MalisNLL(aff, agt, seg, nhood=nh, unrestrict_neg=False,
                          name="malis")
        m = nm.model_manager.getmodel()
        m.designate_nodes(input_node=inp, target_node=seg,
                          loss_node=nm.AggregateLoss(mal),
                          prediction_node=aff, extra_inputs=[agt])
        losses.append(m)
    jm, tm = losses
    tm.to("cpu")
    from elektronn2_tpu_torch.utils.convert import params_from_jax
    tm.set_params(params_from_jax(jm.params, tm))
    x = np.random.RandomState(8).rand(1, 1, 3, 8, 8).astype(np.float32)
    seg = segments((3, 8, 8), 9)[None]
    agt = np.stack([np.asarray(jmalis.seg_to_affgraph(seg[0], jm.nodes[
        "malis"].nhood))]).astype(np.float32)
    agt[:, :, 0] = 0.5
    jl = float(jm.loss(x, seg, extra=[agt]))
    tl = float(tm.loss(torch.from_numpy(x), torch.from_numpy(seg),
                       extra=[torch.from_numpy(agt)]))
    assert tl > 0
    np.testing.assert_allclose(tl, jl, rtol=LOSS_RTOL)


def test_make_affinities_cc_and_v_rand_equal_jax():
    from elektronn2_tpu_torch.data.image import make_affinities
    from elektronn2_tpu_torch.malis import (compute_V_rand_N2,
                                            connected_components)
    labs = np.stack([segments((5, 10, 10), s) for s in (31, 32)])
    labs[0, 2, 3:5] = labs[0, 0, 0] + 50           # small, touching pieces
    for size_thresh in (1, 6):
        for got, want in zip(make_affinities(labs, size_thresh=size_thresh),
                             jax_make_affinities(labs,
                                                 size_thresh=size_thresh)):
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got, want)
    rng = np.random.RandomState(33)
    aff = rng.rand(3, 5, 10, 10).astype(np.float32)
    nh = mknhood3d(1)
    for thr in (0.3, 0.7):
        for got, want in zip(connected_components(aff, nh, thr),
                             jmalis.connected_components(aff, nh, thr)):
            np.testing.assert_array_equal(got, want)
    pred_seg, _ = connected_components(aff, nh, 0.7)
    assert compute_V_rand_N2(labs[0], pred_seg) == \
        jmalis.compute_V_rand_N2(labs[0], pred_seg)


# ----------------------------------------------------------- training paths

def test_fused_loops_refuse_malis_before_any_capture():
    """MALIS counts its pairs on the host in every step: both fused loops
    refuse to capture a MalisNLL model, naming it and per-step training."""
    from elektronn2_tpu_torch.ops.warp import DeviceBatchAugmenter
    from elektronn2_tpu_torch.training.fused_loop import (FusedTrainLoop,
                                                          HostFedFusedLoop)
    m = malis_net(tnm)
    m.to("cpu")
    m.set_opt("Adam")
    rng = np.random.RandomState(0)
    aug = DeviceBatchAugmenter(
        [rng.rand(1, 6, 12, 12).astype(np.float32)],
        [np.ones((6, 12, 12), np.int16)], patch_size=(3, 8, 8),
        target_size=(3, 8, 8), warp_amount=0.0, device="cpu")
    hyper = m.optimiser.current_hyper(m.device)
    for loop in (FusedTrainLoop(m, aug, batch_size=1, n_inner=2),
                 HostFedFusedLoop(m, None, 1, 2, prefetch=False)):
        with pytest.raises(NotImplementedError,
                           match=r"MalisNLL node 'malis'.*train per step"):
            loop._capture(hyper)
        assert loop._graph is None


def test_malis3d_example_through_the_train_cli(tmp_path, monkeypatch):
    """``examples/malis3d.py`` unchanged through the port's train CLI on
    the CPU: every loss finite and falling, a ``.mdl`` written."""
    losses = []
    step = Model.trainingstep

    def recorded(self, *a, **kw):
        out = step(self, *a, **kw)
        losses.append(float(out[0]))
        return out
    monkeypatch.setattr(Model, "trainingstep", recorded)
    monkeypatch.setenv("HOME", str(tmp_path))
    out = tmp_path / "run"
    train_cli.main(["--cpu", os.path.join(REPO, "examples", "malis3d.py"),
                    "--n-steps", "60", "--save-path", str(out)])
    assert len(losses) == 60 and np.isfinite(losses).all()
    assert np.mean(losses[-10:]) < np.mean(losses[:10])
    assert os.path.exists(out / "malis3d-LAST.mdl")
