"""Shape bookkeeping of the port against the JAX package.

The flagship net's TaggedShapes (shape, strides, fov, mfp_offsets) must be
equal node by node in both packages, as must the cnncalculator geometry and
TaggedShape's own helpers. Pure integer arithmetic: exact equality.
"""

import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from __graft_entry__ import _flagship_model  # noqa: E402
from elektronn2_tpu.neuromancer.graphutils import TaggedShape as JaxTS  # noqa: E402
from elektronn2_tpu.utils.cnncalculator import cnncalculator as jax_calc  # noqa: E402
from elektronn2_tpu_torch.neuromancer.graphutils import TaggedShape  # noqa: E402
from elektronn2_tpu_torch.utils.cnncalculator import cnncalculator  # noqa: E402
from elektronn2_tpu_torch.utils.convert import flagship_model  # noqa: E402

torch.set_num_threads(1)


def _same_shape(a, b):
    assert tuple(a.shape) == tuple(b.shape)
    assert tuple(a.tags) == tuple(b.tags)
    assert tuple(a.strides) == tuple(b.strides)
    assert tuple(a.fov) == tuple(b.fov)
    np.testing.assert_array_equal(a.mfp_offsets, b.mfp_offsets)


@pytest.mark.parametrize("mfp, patch", [(True, [23, 103, 103]),
                                        (True, None),
                                        (False, [5, 15, 15]),
                                        (False, [23, 103, 103])])
def test_flagship_tagged_shapes_equal(mfp, patch):
    jm = _flagship_model(mfp=mfp, patch=patch)
    tm = flagship_model(mfp=mfp, patch=patch)
    assert list(jm.nodes) == list(tm.nodes)
    for name in jm.nodes:
        _same_shape(tm.nodes[name].shape, jm.nodes[name].shape)
        assert type(tm.nodes[name]).__name__ == type(jm.nodes[name]).__name__
    # the flagship's documented geometry
    assert tuple(tm.prediction_node.shape.fov) == (5, 26, 26)
    assert tm.prediction_node.shape.n_frag == (16 if mfp else 1)
    # parameter shapes match too
    for n, d in jm.params.items():
        for k, v in d.items():
            assert tuple(tm.params[n][k].shape) == tuple(v.shape)


@pytest.mark.parametrize("filters, pools, mfp, patch, ndim", [
    ([3, 3], [2, 2], True, 21, 1),
    ([3, 3, 3], [2, 1, 2], False, 40, 1),
    ([(1, 3, 3), (1, 3, 3), (3, 3, 3)], [(1, 2, 2), (1, 2, 2), (1, 1, 1)],
     True, [15, 55, 55], 3),
    ([(3, 3), (3, 3)], [(2, 2), (1, 1)], [True, False], [30, 30], 2),
])
def test_cnncalculator_equal(filters, pools, mfp, patch, ndim):
    a = cnncalculator(filters, pools, desired_patch_size=patch, mfp=mfp,
                      ndim=ndim)
    b = jax_calc(filters, pools, desired_patch_size=patch, mfp=mfp,
                 ndim=ndim)
    assert repr(a) == repr(b)
    assert a.input == b.input and a.output == b.output


def test_tagged_shape_helpers_equal():
    off = np.array([[0, 0, 0], [0, 1, 0], [0, 0, 1], [0, 1, 1]])
    args = ((2, 3, 5, 7, 9), "b,f,z,x,y", (1, 2, 2), (3, 5, 5), off)
    t, j = TaggedShape(*args), JaxTS(*args)
    _same_shape(t, j)
    assert t.to_dict() == j.to_dict()
    assert repr(t) == repr(j)
    assert t.fov_all_offsets == j.fov_all_offsets
    assert t.offsets == j.offsets
    _same_shape(t.updateshape("x", 4), j.updateshape("x", 4))
    _same_shape(t.delaxis("z"), j.delaxis("z"))
    _same_shape(t.delaxis("z").addaxis(2, 5, "z"),
                j.delaxis("z").addaxis(2, 5, "z"))
    _same_shape(TaggedShape.from_dict(j.to_dict()), j)
    with pytest.raises(ValueError, match="unknown tag"):
        TaggedShape((1, 2), "b,q")
