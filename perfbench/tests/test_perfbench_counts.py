"""The yardstick's work counts against a hand count at the cells' sizes."""

import math

import pytest

from perfbench import peaks
from perfbench.drivers.dense import k1_bound_s
from perfbench.harness import load_traffic
from perfbench.netspec import Net, load_config


def test_neuro3d_dense_macs_a_voxel():
    # conv0 20*1*9 + conv1 30*20*9 + conv2 40*30*27 + conv3 40*40*27
    # + cls 2*40, every layer dense at every output voxel
    hand = 180 + 5400 + 32400 + 43200 + 80
    assert hand == 81260
    assert Net(load_config("neuro3d")).dense_flops_per_voxel() == 2 * hand


def test_neuro3d_k1_bound_at_the_flagship_request():
    net, cfg = Net(load_config("neuro3d")), load_config("neuro3d")
    tr = load_traffic("dense_request")
    bound, n = k1_bound_s(net, cfg, tr["shape"], tr["serving"])
    # conv2: 2*40*30*27 FLOPs x 122*504*504 outputs at 495 TFLOP/s;
    # conv3: 2*40*40*27 x 120*496*496; both bound by operations
    c2 = 2 * 40 * 30 * 27 * 122 * 504 * 504 / 495e12
    c3 = 2 * 40 * 40 * 27 * 120 * 496 * 496 / 495e12
    assert n == 2
    assert bound == pytest.approx(c2 + c3, rel=1e-12)
    assert round(c2 * 1e3, 2) == 4.06 and round(c3 * 1e3, 2) == 5.15
    assert round(bound * 1e3, 2) == 9.21


def test_unet_counts():
    net, cfg = Net(load_config("unet3d_wide")), load_config("unet3d_wide")
    # per output voxel: e0a 64*9 and e0b 64*64*9 at full density; e1a
    # 128*64*27 and e1b 128*128*27 at 1/4; bott 256*128*27 at 1/16; u1
    # 128*256 at 1/4; d1 128*256*27 at 1/4; u0 64*128, d0 64*128*9 and cls
    # 2*64 at full density
    hand = (64 * 9 + 64 * 64 * 9 + (128 * 64 * 27 + 128 * 128 * 27) / 4
            + 256 * 128 * 27 / 16 + 128 * 256 / 4 + 128 * 256 * 27 / 4
            + 64 * 128 + 64 * 128 * 9 + 2 * 64)
    assert net.dense_flops_per_voxel() == pytest.approx(2 * hand)
    tr = load_traffic("dense_slab")
    bound, n = k1_bound_s(net, cfg, tr["shape"], tr["serving"])
    assert n == 4 and round(bound * 1e3, 1) == 49.5


def test_conv3x3_work_counts_each_byte_once():
    f, b = peaks.conv3x3_work(1, 30, 124, 512, 512, 40, 4, 4)
    out = 40 * 122 * 504 * 504
    assert f == 2 * 30 * 27 * out
    assert b == 4 * (30 * 124 * 512 * 512 + 40 * 30 * 27 + 40 + out)
    assert peaks.bound_s(f, b)[1] == "operations"
    assert peaks.bound_s(1.0, 1e12)[1] == "bytes"


def test_training_step_flops():
    net = Net(load_config("neuro3d"))
    sh = net.valid_shapes([15, 54, 54])
    assert sh["probs"] == [11, 8, 8]
    macs = (20 * 9 * math.prod(sh["conv0.pre"])
            + 30 * 20 * 9 * math.prod(sh["conv1.pre"])
            + 40 * 30 * 27 * math.prod(sh["conv2.pre"])
            + 40 * 40 * 27 * math.prod(sh["conv3.pre"])
            + 2 * 40 * math.prod(sh["cls.pre"]))
    assert net.forward_flops([15, 54, 54], 4) == 2 * macs * 4
