"""The plain reference agrees with the port at tiny sizes on the CPU, and
each cell passes its own checks there."""

import pytest
import torch

from perfbench import harness, weights
from perfbench.build import apply_serving, port_model
from perfbench.netspec import Net, load_config
from perfbench.reference.nets import Reference
from perfbench.tests.tiny import SEED, TINY


@pytest.mark.parametrize("config,traffic,shape", [
    ("neuro3d", "dense_request", (1, 7, 57, 61)),
    ("unet3d_wide", "dense_slab", (1, 11, 70, 66)),
])
def test_dense_reference_equals_the_port(config, traffic, shape):
    cfg = load_config(config)
    net = Net(cfg)
    model = port_model(net, 1, cfg["design_patch"], "cpu",
                       mfp=not net.has_upconv)
    params = weights.make_params(net, SEED, "cpu")
    model.set_params(params)
    apply_serving(model, harness.load_traffic(traffic)["serving"])
    v = weights.uniform_volume(SEED, "volume", 0, shape, "cpu")
    got = model.predict_dense_device(v, pad_raw=True)
    want = Reference(net, params).dense(v, cfg["design_patch"])
    assert got.shape == want.shape
    assert float((got - want).abs().max()) < 1e-5


@pytest.mark.parametrize("workload", sorted(TINY))
def test_each_cell_is_correct_on_the_cpu(workload):
    r = harness.run_cell(workload, SEED, 0.5, 0, device="cpu",
                         overrides=TINY[workload])
    assert r["correct"], r["checks"]
    assert r["attempted"] > 0 and r["failed"] == 0
    assert set(r["metrics"]) >= {"setup_s"}
