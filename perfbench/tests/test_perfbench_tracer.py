"""The tracing cell's pieces on the CPU: the plain reference against the
port's eager rollout (its plain patch cut) at a tiny size, the decode of
the returned traces, and the counts of the yardstick (K2's bytes, the
model's FLOPs an agent-step) against a hand count."""

import numpy as np
import pytest
import torch

from perfbench import netspec
from perfbench.drivers.tracer import (agent_step_flops, decode,
                                      k2_launch_bound_s, make_params,
                                      request_seeds, widths)
from perfbench.extract_work import (trilinear_patches_work, window_bases,
                                    window_union)
from perfbench.harness import load_traffic
from perfbench.peaks import bound_s
from perfbench.reference.tracer import TracerReference, cut
from perfbench.tests.tiny import SEED

B, K, VOL = 8, 6, (1, 40, 40, 40)


def port_rollout(cfg, params, vol, seeds, steps):
    from elektronn2_tpu_torch.data.tracing_utils import DeviceTracer
    from elektronn2_tpu_torch.utils.convert import tracer_model
    patch, enc_w, gru_w = widths(cfg)
    model = tracer_model(patch, enc_w=enc_w, gru_w=gru_w, device="cpu")
    model.set_params(params)
    tracer = DeviceTracer(model, vol, step_scale=cfg["step_scale"],
                          max_steps=steps, min_step=cfg["min_step"],
                          use_pallas_extract=False)
    return [t.coords for t in tracer.trace_batch(seeds)]


@pytest.fixture(scope="module")
def tiny():
    cfg = netspec.load_config("tracer")
    params = make_params(cfg, SEED, "cpu")
    tr = dict(load_traffic("rollout"), volume=list(VOL), agents=B)
    vol = torch.rand(VOL, generator=torch.Generator().manual_seed(5))
    seeds = request_seeds(SEED, "seeds", 0, tr, cfg)
    return cfg, params, vol, seeds


def test_the_reference_follows_the_ports_rollout(tiny):
    cfg, params, vol, seeds = tiny
    pts = port_rollout(cfg, params, vol, seeds, K)
    traj, moved = decode(pts, K)
    assert moved.sum() > 0
    gap, mismatch = TracerReference(cfg, params).follow(
        vol, torch.from_numpy(seeds), torch.from_numpy(traj),
        torch.from_numpy(moved))
    assert gap < 1e-5 and mismatch == 0


def test_the_references_own_rollout_equals_the_ports(tiny):
    cfg, params, vol, seeds = tiny
    traj, moved = decode(port_rollout(cfg, params, vol, seeds, K), K)
    rt, rm = TracerReference(cfg, params).rollout(
        vol, torch.from_numpy(seeds), K)
    assert np.array_equal(rm.numpy(), moved)
    assert np.abs(rt.numpy() - traj).max() < 1e-5


def test_the_cut_takes_the_fraction_before_it_clips():
    vol = torch.rand((2, 20, 21, 22), generator=torch.Generator(
        ).manual_seed(1))
    pos = torch.tensor([[10.3, 9.7, 11.25], [-2.4, 0.3, 30.0],
                        [7.5, 7.5, 7.5]])
    got = cut(vol, pos, (5, 6, 7))
    for b in range(3):
        corner = pos[b].double() - (torch.tensor([5, 6, 7]) - 1) / 2
        base = torch.floor(corner)
        frac = corner - base
        lo = torch.minimum(base.clamp(min=0), torch.tensor([14.0, 14, 14]))
        for c in range(2):
            want = torch.zeros((5, 6, 7), dtype=torch.float64)
            for i in range(5):
                for j in range(6):
                    for k in range(7):
                        for dz in (0, 1):
                            for dx in (0, 1):
                                for dy in (0, 1):
                                    wgt = ((frac[0] if dz else 1 - frac[0])
                                           * (frac[1] if dx else 1 - frac[1])
                                           * (frac[2] if dy else 1 - frac[2]))
                                    v = vol[c, int(lo[0]) + i + dz,
                                            int(lo[1]) + j + dx,
                                            int(lo[2]) + k + dy]
                                    want[i, j, k] += wgt * v.double()
            assert float((got[b, c].double() - want).abs().max()) < 1e-6


def test_decode_keeps_a_stopped_agents_position():
    pts = [np.array([[1.0, 2, 3], [1.5, 2, 3], [2.0, 2, 3]]),
           np.array([[5.0, 5, 5]])]
    traj, moved = decode(pts, 3)
    assert moved.tolist() == [[True, False], [True, False], [False, False]]
    assert traj[:, 0, 0].tolist() == [1.5, 2.0, 2.0]
    assert traj[:, 1].tolist() == [[5.0, 5, 5]] * 3


def test_k2_work_at_the_cells_size():
    f, b = trilinear_patches_work(1024, 1, (16, 16, 16))
    windows, patches = 4 * 1024 * 17 ** 3, 4 * 1024 * 16 ** 3
    assert round(windows / 1e6, 1) == 20.1
    assert round(patches / 1e6, 1) == 16.8
    assert b == windows + patches + 4 * 3 * 1024
    assert f == 16 * 1024 * 16 ** 3
    t, by = bound_s(f, b)
    assert by == "bytes" and round(t * 1e6, 1) == 11.0


def test_k2_bytes_count_the_union_of_the_windows():
    dims, patch = (40, 41, 42), (4, 5, 6)
    one = 5 * 6 * 7
    pos = torch.tensor([[20.0, 20, 20], [20.0, 20, 20], [20.25, 20, 20]])
    # the same window twice, and one shifted by less than a voxel: once
    assert window_union(pos, patch, dims) == one
    # one voxel further in z: one more plane of 6 x 7
    assert window_union(pos + torch.tensor([[0.0, 0, 0], [0, 0, 0],
                                            [1, 0, 0]]), patch, dims) == (
        one + 6 * 7)
    # far apart, and one past the edge clipped inside the volume
    far = torch.tensor([[5.0, 5, 5], [30.0, 30, 30], [90.0, -9, 41.5]])
    assert window_union(far, patch, dims) == 3 * one
    assert window_bases(far, patch, dims)[2].tolist() == [35, 0, 35]
    # the cell's bound falls with the overlap, from the whole count down
    f, whole = trilinear_patches_work(3, 1, patch)
    assert whole == trilinear_patches_work(3, 1, patch, 3 * one)[1]
    assert k2_launch_bound_s(pos, 3, [1, *dims], patch) < k2_launch_bound_s(
        far, 3, [1, *dims], patch) == bound_s(f, whole)[0]


def test_request_seeds_are_fresh_for_every_request_and_fixed_by_the_seed():
    cfg = netspec.load_config("tracer")
    tr = load_traffic("rollout")
    a = request_seeds(SEED, "seeds", 0, tr, cfg)
    assert a.shape == (1024, 3) and a.dtype == np.float32
    assert np.array_equal(a, request_seeds(SEED, "seeds", 0, tr, cfg))
    assert not np.array_equal(a, request_seeds(SEED, "seeds", 1, tr, cfg))
    assert not np.array_equal(a, request_seeds(SEED + 1, "seeds", 0, tr,
                                               cfg))
    assert a.min() >= 10 and a.max() < 246


def test_the_tracing_models_flops_an_agent_step():
    cfg = netspec.load_config("tracer")
    # enc 4096 x 64, GRU gates (64 + 64) x 128 and candidate 128 x 64,
    # step head 64 x 3
    hand = 2 * (4096 * 64 + 128 * 128 + 128 * 64 + 64 * 3)
    assert hand == 573824 and agent_step_flops(cfg) == hand


def test_the_tracer_graph_builds_as_a_net():
    net = netspec.Net(netspec.load_config("tracer"))
    assert net.input["name"] == "x_t" and net.output["name"] == "step"
    assert not net.has_upconv and net.fov == [1, 1, 1]
