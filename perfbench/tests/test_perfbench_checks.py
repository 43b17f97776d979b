"""The output check fails what it must: the precision control (the
reference with TF32 operands in the program's place) and, with the timed
path broken underneath a run that skips the harness's look for a card,
each fault a cell can have."""

import math

import pytest
import torch

from perfbench import harness
from perfbench.drivers import common
from perfbench.reference.nets import tf32_round
from perfbench.tests.tiny import SEED, TINY

FAULTS = [("neuro3d.dense_request", "answer"),
          ("neuro3d.dense_request", "nan_pick"),
          ("unet3d_wide.dense_slab", "answer"),
          ("neuro3d.sweep", "answer"),
          ("neuro3d.sweep", "stale"),
          ("neuro3d.train_fused", "frozen"),
          ("neuro3d.train_fused", "half_batch"),
          ("tracer.rollout", "answer"),
          ("tracer.rollout", "nan_pick"),
          ("tracer.rollout", "truncated")]
CONTROLS = ["neuro3d.dense_request", "unet3d_wide.dense_slab",
            "neuro3d.sweep", "neuro3d.train_fused", "tracer.rollout"]


@pytest.mark.parametrize("workload,fault", FAULTS)
def test_a_broken_timed_path_is_not_correct(workload, fault):
    # ``nan_pick`` needs the window to reach both compared requests
    over = harness._merge(TINY[workload], {"check": {"count": 2,
                                                     "within": 2}}
                          if fault == "nan_pick" else None)
    r = harness.run_cell(workload, SEED, 0.3, 0, device="cpu",
                         overrides=over, fault=fault)
    assert r["correct"] is False, r["checks"]


@pytest.mark.parametrize("workload", CONTROLS)
def test_the_tf32_control_in_the_programs_place_is_not_correct(workload):
    r = harness.run_cell(workload, SEED, 0.3, 0, device="cpu",
                         overrides=TINY[workload], fault="control")
    assert r["correct"] is False, r["checks"]


def test_worst_is_nan_when_any_gap_is():
    assert common.worst([1e-6, 2e-6]) == 2e-6
    assert math.isnan(common.worst([1e-6, float("nan")]))
    assert math.isnan(common.worst([1e-6, float("inf"), 0.0]))
    assert math.isnan(common.worst([]))


def test_tf32_round_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0 + 2 ** -10, 1.0 + 2 ** -11 + 2 ** -20,
                      1.0 + 2 ** -12, -3.0])
    assert tf32_round(x).tolist() == [1.0 + 2 ** -10, 1.0 + 2 ** -10, 1.0,
                                      -3.0]


@pytest.mark.parametrize("workload", CONTROLS)
def test_each_driver_names_the_runs_calibrate_makes(workload):
    import importlib
    cell = harness.find_cell(harness.load_bench(), workload)
    driver = importlib.import_module("perfbench.drivers." + harness.
                                     load_traffic(cell["traffic"])["driver"])
    # the precision control first: every cell's upper reading starts there
    assert driver.FAULTS[0] == "control"
