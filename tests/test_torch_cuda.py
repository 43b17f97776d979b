"""The port's CUDA kernels on the card (skipped without one).

This file imports neither jax nor the JAX package, so it runs on a machine
that has only PyTorch with CUDA: ``python -m pytest tests/test_torch_cuda.py
--noconftest -q`` (``--noconftest``: ``tests/conftest.py`` imports jax).
Each test holds a kernel against its plain PyTorch version on the same
inputs; tolerance 1e-4 for K1 and K4, both of K4's bodies (float32 sums of
up to 27*Cin and 9*Cin products in another order), 1e-5 on the flagship's probabilities, 1e-5 for K2 (values in
[0, 1), 8 products per output) and 1e-4 for K3 (coordinates near 256 carry
an ulp of 1.5e-5, which moves a sample by about that much); K3's ``ok``
flags must be equal. Both patch kernels avoid FMA contraction and are
expected to agree with their plain versions bit for bit. K5: 1e-4 (K1's
reason), its pad channels exactly 0. P2's ``full`` is K1's own body and
must equal K1 bit for bit (and its plain version within 1e-4); ``noepi``,
the bare conv summed in one float32 accumulator, within
``exp_ptail_ablate.noepi_tol`` (its error grows with the products summed).
P1: rtol=atol=1e-3 in float32 (sums of 360 products of unit normals in
another order), 1e-2 in bf16 (the tensor cores' float32 accumulation); its
float32 rows, like K1, within 2x the plain float32 version's error against
float64 + 1e-6; its dot-only instance for shape and finite values.
The KNOSSOS sweep (``sweep_knossos``) on the card equals the same sweep on
the CPU within 1e-5, two slabs at a time launch K1 at N = 2, and the chunk
loop makes no host sync (``torch.cuda.set_sync_debug_mode("error")``).
Training (``training/fused_loop.py``): a graphed chunk equals the eager
chunk from the same parameters, optimiser state and generator state bit for
bit under ``torch.backends.cudnn.deterministic``; K1 serving the trained
weights within 1e-5 of the cuDNN route (``SLICE_ATOL`` of chip_smoke.py).
"""

import os

import numpy as np
import pytest
import torch

from elektronn2_tpu_torch.data.tracing_utils import (DeviceTracer,
                                                     flight_frame)
from elektronn2_tpu_torch.ops import extract, extract_rot, tailconv
from elektronn2_tpu_torch.ops.experimental import dilated_conv
from elektronn2_tpu_torch.scripts import exp_ptail_ablate, exp_ptail_dot
from elektronn2_tpu_torch.utils.convert import (flagship_model,
                                                neuro3d_train_model,
                                                tracer_model,
                                                wide_unet_model)

TOL = dict(atol=1e-4, rtol=1e-4)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


def _inputs(seed, n, cin, cout, sp, device):
    rng = np.random.RandomState(seed)
    x = (rng.rand(n, cin, *sp) - 0.5).astype(np.float32)
    w = (rng.rand(cout, cin, 3, 3, 3) - 0.5).astype(np.float32)
    b = (rng.rand(cout) - 0.5).astype(np.float32)
    return tuple(torch.from_numpy(a).to(device) for a in (x, w, b))


@pytest.mark.cuda
@pytest.mark.parametrize("n, cin, cout, sp, dil", [
    (1, 30, 40, (6, 64, 300), (1, 4, 4)),     # conv2-like, ragged y
    (1, 40, 40, (5, 40, 520), (1, 4, 4)),     # conv3-like, y > one block
    (2, 3, 5, (5, 20, 30), (1, 2, 3)),        # batch, anisotropic dilation
    (1, 30, 45, (5, 40, 70), (1, 1, 1)),      # Cout padded to 48
    (2, 3, 5, (5, 21, 20), (1, 1, 1)),        # 8 rows of 18 outputs a block
])
def test_k1_matches_plain(cuda_device, n, cin, cout, sp, dil):
    x, w, b = _inputs(11, n, cin, cout, sp, cuda_device)
    before = tailconv.launches
    got = tailconv.conv3x3_dilated(x, w, b, dil)
    ref = tailconv.conv3x3_dilated_reference(x, w, b, dil)
    torch.cuda.synchronize()
    assert tailconv.launches == before + 1
    torch.testing.assert_close(got, ref, **TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("n, cin, cout, sp", [
    (1, 64, 128, (6, 40, 61)),    # e1a, scaled down
    (2, 256, 128, (5, 23, 30)),   # d1: Cin past the weight chunk, a batch
    (1, 128, 256, (5, 20, 117)),  # bott: two 128-channel groups, two rows
                                  # of 115 outputs per block
])
def test_k1_matches_plain_at_wide_unet_shapes(cuda_device, n, cin, cout, sp):
    x, w, b = _inputs(14, n, cin, cout, sp, cuda_device)
    w = w * (2.0 / (27 * cin)) ** 0.5
    got = tailconv.conv3x3_dilated(x, w, b)
    ref = tailconv.conv3x3_dilated_reference(x, w, b)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, ref, **TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("cout", [1, 16, 24, 32, 40, 56, 64, 200])
def test_k1_every_n_tile(cuda_device, cout):
    """Each of the kernel's N tiles (8, 16, ..., 64 and 128; Cout 200 runs
    as two 128-channel groups, the second ragged)."""
    x, w, b = _inputs(15, 1, 11, cout, (4, 9, 70), cuda_device)
    w = w * (2.0 / (27 * 11)) ** 0.5
    before = tailconv.launches
    got = tailconv.conv3x3_dilated(x, w, b)
    ref = tailconv.conv3x3_dilated_reference(x, w, b)
    torch.cuda.synchronize()
    assert tailconv.launches == before + 1
    torch.testing.assert_close(got, ref, **TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("n, cin, cout, sp, d, pool", [
    (1, 1, 20, (3, 40, 45), 1, 2),     # flagship conv0, ragged Y
    (1, 20, 30, (2, 37, 300), 2, 2),   # flagship conv1, two channel groups
    (2, 3, 5, (3, 20, 21), 3, 2),      # batch, d=3
    (1, 24, 16, (2, 33, 600), 1, 1),   # probe dec, Y past one block's run
    (1, 40, 7, (2, 12, 13), 2, 1),     # Cin past the weight chunk
])
def test_k4_matches_plain(cuda_device, n, cin, cout, sp, d, pool):
    rng = np.random.RandomState(15)
    x, w, b = (torch.from_numpy(a).to(cuda_device) for a in (
        (rng.rand(n, cin, *sp) - 0.5).astype(np.float32),
        (rng.rand(cout, cin, 1, 3, 3) - 0.5).astype(np.float32),
        (rng.rand(cout) - 0.5).astype(np.float32)))
    before = tailconv.head_launches
    got = tailconv.conv1x3x3_pool_dilated(x, w, b, (d, d), pool)
    ref = tailconv.conv1x3x3_pool_reference(x, w, b, (d, d), pool)
    torch.cuda.synchronize()
    assert tailconv.head_launches == before + 1
    torch.testing.assert_close(got, ref, **TOL)


def _head_inputs(seed, n, cin, cout, sp, device):
    rng = np.random.RandomState(seed)
    return tuple(torch.from_numpy(a).to(device) for a in (
        (rng.rand(n, cin, *sp) - 0.5).astype(np.float32),
        ((rng.rand(cout, cin, 1, 3, 3) - 0.5)
         * (2.0 / (9 * cin)) ** 0.5).astype(np.float32),
        (rng.rand(cout) - 0.5).astype(np.float32)))


@pytest.mark.cuda
@pytest.mark.parametrize("cout", [5, 16, 30, 64, 128])
@pytest.mark.parametrize("d, pool", [(1, 1), (3, 1), (1, 2), (2, 2), (3, 2)])
def test_k4_tc_every_n_tile(cuda_device, cout, d, pool):
    """K4's tensor-core body at each kind of N tile (8, 16, 32, 64; Cout
    128: one 128 tile with pool 1, two 64-channel groups with pool 2),
    pool 1 and 2, d 1 to 3, a ragged Y (two y-blocks, the second short)
    and a strip of 32 output rows plus a short one."""
    x, w, b = _head_inputs(16, 1, 11, cout, (2, 41, 141), cuda_device)
    before = (tailconv.head_launches, tailconv.head_tc_launches)
    got = tailconv.head_tc(x, w, b, (d, d), pool)
    ref = tailconv.conv1x3x3_pool_reference(x, w, b, (d, d), pool)
    torch.cuda.synchronize()
    assert (tailconv.head_launches, tailconv.head_tc_launches) == \
        (before[0] + 1, before[1] + 1)
    torch.testing.assert_close(got, ref, **TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("cout, pool", [(20, 2), (16, 1)])
@pytest.mark.parametrize("side", [-1, 0])
def test_k4_dispatch_both_sides_of_the_cin_threshold(cuda_device, side,
                                                      cout, pool):
    low = (tailconv.HEAD_TC_MIN_CIN_N16 if cout <= 16
           else tailconv.HEAD_TC_MIN_CIN)
    cin = low + side
    x, w, b = _head_inputs(17, 2, cin, cout, (3, 30, 75), cuda_device)
    before = (tailconv.head_launches, tailconv.head_tc_launches)
    got = tailconv.conv1x3x3_pool_dilated(x, w, b, (2, 2), pool)
    ref = tailconv.conv1x3x3_pool_reference(x, w, b, (2, 2), pool)
    torch.cuda.synchronize()
    assert tailconv.head_launches == before[0] + 1
    assert tailconv.head_tc_launches == before[1] + (side == 0)
    torch.testing.assert_close(got, ref, **TOL)


@pytest.mark.cuda
def test_wide_unet_k1_route_matches_cudnn_route(cuda_device):
    m = wide_unet_model(widths=(8, 16, 32), device=cuda_device)
    vol = torch.from_numpy(np.random.RandomState(16).rand(
        1, 20, 72, 76).astype(np.float32)).to(cuda_device)
    m.set_convdense_impl(zfold=True, skipsum=True, ptail=True)
    before = tailconv.launches
    a = m.predict_dense_device(vol, pad_raw=True)
    assert tailconv.launches == before + 4
    m.set_convdense_impl(zfold=True, skipsum=True)
    b = m.predict_dense_device(vol, pad_raw=True)
    torch.cuda.synchronize()
    assert tailconv.launches == before + 4
    assert tuple(a.shape) == (2, 20, 72, 76)
    torch.testing.assert_close(a, b, atol=1e-5, rtol=0)


@pytest.mark.cuda
def test_k1_rejects_host_tensors_mixed_with_card(cuda_device):
    x, w, b = _inputs(12, 1, 4, 4, (6, 10, 12), cuda_device)
    with pytest.raises(ValueError, match="is on"):
        tailconv.conv3x3_dilated(x, w.cpu(), b, (1, 1, 1))


@pytest.mark.cuda
def test_flagship_k1_route_matches_cudnn_route(cuda_device):
    m = flagship_model(mfp=True, patch=[9, 41, 41], device=cuda_device)
    vol = torch.from_numpy(np.random.RandomState(13).rand(
        1, 12, 80, 72).astype(np.float32)).to(cuda_device)
    m.set_dilated_impl("direct", zfold=True, pallas_tail=True)
    before = tailconv.launches
    a = m.predict_dense_device(vol, pad_raw=True)
    assert tailconv.launches == before + 2
    m.set_dilated_impl("direct", zfold=True, pallas_tail=False)
    b = m.predict_dense_device(vol, pad_raw=True)
    torch.cuda.synchronize()
    assert tuple(a.shape) == (2, 12, 80, 72)
    torch.testing.assert_close(a, b, atol=1e-5, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("f, shape, patch, B", [
    (1, (64, 64, 64), (16, 16, 16), 300),     # the tracer's patch
    (2, (20, 24, 28), (5, 7, 9), 3),          # ragged patch, two channels
    (1, (40, 40, 40), (36, 36, 36), 2),       # a window past 48 KB
    (1, (30, 41, 50), (8, 8, 8), 200),        # Y % 4 == 2: rows shift
])
def test_k2_matches_plain(cuda_device, f, shape, patch, B):
    rng = np.random.RandomState(21)
    vol = torch.from_numpy(rng.rand(f, *shape).astype(np.float32)).to(
        cuda_device)
    dims = np.asarray(shape, np.float32)
    pos = rng.uniform(-2.0, dims + 2.0, (B, 3)).astype(np.float32)
    pos = torch.from_numpy(pos).to(cuda_device)
    before = extract.launches
    got = extract.trilinear_patches(vol, pos, patch)
    ref = extract.trilinear_patches_reference(vol, pos, patch)
    torch.cuda.synchronize()
    assert extract.launches == before + 1
    torch.testing.assert_close(got, ref, atol=1e-5, rtol=0)
    assert torch.equal(got, ref)            # no FMA contraction: bit for bit


@pytest.mark.cuda
@pytest.mark.parametrize("f, shape, patch, B", [
    (1, (96, 96, 96), (16, 16, 16), 200),
    (2, (30, 34, 41), (4, 8, 6), 17),         # Y % 4 == 1: rows shift
])
def test_k3_matches_plain(cuda_device, f, shape, patch, B):
    rng = np.random.RandomState(22)
    vol = torch.from_numpy(rng.rand(f, *shape).astype(np.float32)).to(
        cuda_device)
    dims = np.asarray(shape, np.float32)
    pos = torch.from_numpy(rng.uniform(2.0, dims - 2.0, (B, 3)).astype(
        np.float32)).to(cuda_device)
    F = flight_frame(torch.from_numpy(rng.randn(B, 3).astype(
        np.float32)).to(cuda_device))
    before = extract_rot.launches
    got, ok = extract_rot.rotated_patches(vol, pos, F, patch)
    ref, ok_ref = extract_rot.rotated_patches_reference(vol, pos, F, patch)
    torch.cuda.synchronize()
    assert extract_rot.launches == before + 1
    assert torch.equal(ok, ok_ref) and bool(ok.any()) and not bool(ok.all())
    torch.testing.assert_close(got, ref, atol=1e-4, rtol=0)


def _staged_box(vol_shape, pos, frames, patch):
    """``(lo, hi)``, (B, 3) int64, inclusive: the box of the volume K3
    stages for each agent, by the kernel's rule (``load_agent`` in
    ``csrc/extract_rot.cu``): along axis d the samples span ``pos_d -+ t_d``
    with ``t_d = (|F0d| h0 + |F1d| h1) + |F2d| h2``, ``h = (p-1)/2``; with
    ``e = 2^-20 (|pos_d| + t_d)`` the box runs from ``floor(pos_d - t_d -
    e)`` to ``floor(pos_d + t_d + e) + 1``, clipped to the volume, at least
    two voxels wide."""
    h = [(p - 1) / 2.0 for p in patch]
    a = frames.abs()
    t = a[:, 0] * h[0] + a[:, 1] * h[1]
    t = t + a[:, 2] * h[2]
    e = (pos.abs() + t) * 2.0 ** -20
    dims = torch.tensor(vol_shape[1:], dtype=torch.float32,
                        device=pos.device)
    lo = torch.minimum(torch.clamp(torch.floor(pos - t - e), min=0.0),
                       dims - 2.0)
    hi = torch.minimum(torch.maximum(torch.floor(pos + t + e) + 1.0,
                                     lo + 1.0), dims - 1.0)
    return lo.long(), hi.long()


def _k3_headings(kind, B, rng):
    """Unit headings: random; along the axes (the smallest boxes); along
    the cube's diagonals (1, 1, 1)/sqrt(3) with every sign (the largest)."""
    if kind == "random":
        h = rng.randn(B, 3)
    elif kind == "axis":
        h = np.eye(3)[np.arange(B) % 3] * np.where(np.arange(B) % 2, -1, 1)[
            :, None]
    else:
        signs = np.asarray([[a, b, c] for a in (-1, 1) for b in (-1, 1)
                            for c in (-1, 1)])
        h = signs[np.arange(B) % 8] / np.sqrt(3.0)
    return h / np.linalg.norm(h, axis=1, keepdims=True)


@pytest.mark.cuda
@pytest.mark.parametrize("heading", ["random", "axis", "diagonal"])
def test_k3_staged_windows(cuda_device, heading):
    """K3 with two channels at random, axis-aligned and diagonal headings,
    half the agents with their lowest box corner at the ok bound (0 + a
    small delta), in a volume that is NaN everywhere outside the agents'
    staged boxes: the patches are finite and equal the plain version's,
    and so are the ok flags. The kernel stages every item, the boxes the
    window was sized for (``box_edge``), and its count of staged floats is
    the boxes' own."""
    rng = np.random.RandomState(24)
    B, patch, shape = 64, (16, 16, 16), (2, 60, 66, 72)
    h = torch.from_numpy(_k3_headings(heading, B, rng).astype(np.float32))
    F = flight_frame(h.to(cuda_device))
    dims = np.asarray(shape[1:], np.float64)
    pos = rng.uniform(15.0, dims - 15.0, (B, 3))
    half = (np.asarray(patch) - 1) / 2.0
    low = np.abs(F.double().cpu().numpy()).transpose(0, 2, 1) @ half
    deltas = (-1e-3, -1e-5, 0.0, 1e-5, 1e-3, 0.25)
    for i in range(0, B, 2):             # lowest corner along axis i % 3
        d = (i // 2) % 3
        pos[i, d] = low[i, d] + deltas[(i // 2) % len(deltas)]
    pos = torch.from_numpy(pos.astype(np.float32)).to(cuda_device)
    lo, hi = _staged_box(shape, pos, F, patch)
    edges = (hi - lo + 1).cpu()
    assert int(edges.max()) <= extract_rot.box_edge(patch)
    floats = shape[0] * int((edges[:, 0] * edges[:, 1] * (
        (edges[:, 2] + 6) // 4 * 4)).sum())
    keep = torch.zeros(shape[1:], dtype=torch.bool)
    for a, b in zip(lo.tolist(), hi.tolist()):
        keep[a[0]:b[0] + 1, a[1]:b[1] + 1, a[2]:b[2] + 1] = True
    vol = torch.from_numpy(rng.rand(*shape).astype(np.float32))
    vol[:, ~keep] = float("nan")
    vol = vol.to(cuda_device)
    stats = extract_rot.staging_stats(vol.device)
    stats.zero_()
    before = extract_rot.launches
    got, ok = extract_rot.rotated_patches(vol, pos, F, patch)
    ref, ok_ref = extract_rot.rotated_patches_reference(vol, pos, F, patch)
    torch.cuda.synchronize()
    assert extract_rot.launches == before + 1
    assert stats.tolist() == [0, floats]
    assert bool(torch.isfinite(got).all())
    assert torch.equal(got, ref)
    assert torch.equal(ok, ok_ref) and bool(ok.any()) and not bool(ok.all())


def _graph_tracer(device, rotate, K, seed=25, B=48):
    m = tracer_model((8, 8, 8), enc_w=16, gru_w=16, device=device)
    rng = np.random.RandomState(seed)
    vol = torch.from_numpy(rng.rand(1, 40, 40, 40).astype(np.float32)).to(
        device)
    seeds = rng.uniform(8, 32, (2, B, 3)).astype(np.float32)
    return m, DeviceTracer(m, vol, max_steps=K, min_step=0.0,
                           rotate_to_heading=rotate), seeds


def _eager(dt, m, seeds):
    s = torch.from_numpy(seeds).to(dt.volume.device)
    h = s.new_tensor([[0.0, 0.0, 1.0]]).expand(len(seeds), 3)
    return dt._rollout(m.params, dt.volume, s, h)


def _traces_of(traj, moved, seeds):
    traj = traj.cpu().numpy().transpose(1, 0, 2)
    moved = moved.cpu().numpy().T
    return [np.concatenate([seeds[b:b + 1].astype(np.float64),
                            traj[b][moved[b]]]) for b in range(len(seeds))]


@pytest.mark.cuda
@pytest.mark.parametrize("rotate", [False, True])
def test_graphed_trace_batch_equals_eager_rollout(cuda_device, rotate):
    """``trace_batch`` replays one captured graph per rollout: its traces
    are the eager kernel-route rollout's bit for bit, and a replay counts
    K kernel launches."""
    K = 8
    m, dt, seeds = _graph_tracer(cuda_device, rotate, K)
    counter = extract_rot if rotate else extract
    dt.trace_batch(seeds[0])                    # captures
    assert len(dt._graphs) == 1 and dt.capture_seconds > 0
    before = counter.launches
    got = dt.trace_batch(seeds[0])
    assert counter.launches == before + K
    traj, moved = _eager(dt, m, seeds[0])
    assert counter.launches == before + 2 * K
    for g, r in zip(got, _traces_of(traj, moved, seeds[0])):
        assert np.array_equal(g.coords, r)
    s = torch.from_numpy(seeds[0]).to(cuda_device)
    gt, gm = dt._rollout_graphed(m.params, s, s.new_tensor(
        [[0.0, 0.0, 1.0]]).expand(len(s), 3))
    assert torch.equal(gt, traj) and torch.equal(gm, moved)
    assert len(dt._graphs) == 1


@pytest.mark.cuda
def test_graph_recaptured_after_new_weights(cuda_device):
    """The stale-graph trap: after ``set_params`` and after an in-place
    update the rollout follows the new weights (a new capture each), and at
    most ``MAX_GRAPHS`` graphs are kept."""
    m, dt, seeds = _graph_tracer(cuda_device, False, 6)
    first = dt.trace_batch(seeds[0])
    rng = np.random.RandomState(26)
    m.set_params({n: {k: rng.standard_normal(tuple(v.shape)) * 0.3
                      for k, v in d.items()} for n, d in m.params.items()})
    second = dt.trace_batch(seeds[0])
    assert len(dt._graphs) == 2
    for g, r in zip(second, _traces_of(*_eager(dt, m, seeds[0]), seeds[0])):
        assert np.array_equal(g.coords, r)
    assert any(not np.array_equal(a.coords, b.coords)
               for a, b in zip(first, second))
    with torch.no_grad():
        m.params["step"]["b"].add_(0.5)
    third = dt.trace_batch(seeds[0])
    assert len(dt._graphs) == dt.MAX_GRAPHS == 2
    for g, r in zip(third, _traces_of(*_eager(dt, m, seeds[0]), seeds[0])):
        assert np.array_equal(g.coords, r)
    assert any(not np.array_equal(a.coords, b.coords)
               for a, b in zip(second, third))


@pytest.mark.cuda
def test_graphed_calls_do_not_alias(cuda_device):
    """A replay overwrites the graph's static outputs: what an earlier call
    returned (host traces, device clones) stays as it was."""
    m, dt, seeds = _graph_tracer(cuda_device, True, 6)
    a = dt.trace_batch(seeds[0])
    kept = [t.coords.copy() for t in a]
    b = dt.trace_batch(seeds[1])
    assert all(np.array_equal(t.coords, k) for t, k in zip(a, kept))
    assert any(not np.array_equal(t.coords, u.coords) for t, u in zip(a, b))
    s = torch.from_numpy(seeds).to(cuda_device)
    h = s.new_tensor([[0.0, 0.0, 1.0]]).expand(s.shape[1], 3)
    t0, _ = dt._rollout_graphed(m.params, s[0], h)
    t0_kept = t0.clone()
    t1, _ = dt._rollout_graphed(m.params, s[1], h)
    assert torch.equal(t0, t0_kept) and not torch.equal(t0, t1)


@pytest.mark.cuda
@pytest.mark.parametrize("rotate", [False, True])
def test_tracer_kernel_route_matches_plain_route(cuda_device, rotate):
    m = tracer_model((8, 8, 8), enc_w=16, gru_w=16, device=cuda_device)
    rng = np.random.RandomState(23)
    vol = torch.from_numpy(rng.rand(1, 48, 48, 48).astype(np.float32)).to(
        cuda_device)
    seeds = rng.uniform(8, 40, (64, 3)).astype(np.float32)
    kw = dict(max_steps=8, min_step=0.0, rotate_to_heading=rotate)
    counter = extract_rot if rotate else extract
    dt = DeviceTracer(m, vol, **kw)
    dt.trace_batch(seeds)         # capture (its one-step warm-up launches)
    before = counter.launches
    got = dt.trace_batch(seeds)
    assert counter.launches == before + 8
    ref = DeviceTracer(m, vol, use_pallas_extract=False, use_pallas_rot=False,
                       **kw).trace_batch(seeds)
    assert counter.launches == before + 8
    for g, r in zip(got, ref):
        assert len(g.coords) == len(r.coords)
        np.testing.assert_allclose(g.coords, r.coords, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("sp, cout, d, yo", [
    ((6, 9, 3, 50), 45, 1, 37),       # ragged: Cout_pad 48, Y over-padded
    ((8, 8, 5, 256), 7, 2, 128),      # the JAX test's case
    ((10, 12, 20, 300), 40, 3, 290),  # Cin past the weight chunk, Yo > 256
])
def test_k5_matches_plain(cuda_device, sp, cout, d, yo):
    rng = np.random.RandomState(31)
    x = torch.from_numpy((rng.rand(*sp) - 0.5).astype(np.float32)).to(
        cuda_device)
    w = torch.from_numpy((rng.rand(cout, sp[2], 3, 3, 3) - 0.5).astype(
        np.float32)).to(cuda_device)
    before = dilated_conv.launches
    got = dilated_conv.dilated_conv(x, w, d, yo)
    ref = dilated_conv.dilated_conv_reference(x, w, d, yo)
    torch.cuda.synchronize()
    assert dilated_conv.launches == before + 1
    assert tuple(got.shape) == (sp[0] - 2 * d, sp[1] - 2 * d,
                                dilated_conv.cout_pad(cout), yo)
    torch.testing.assert_close(got, ref, **TOL)
    assert bool((got[:, :, cout:] == 0).all())


@pytest.mark.cuda
@pytest.mark.parametrize("dt, M, K, N", exp_ptail_dot.configs() + [
    # K short of a whole stage (f32: 24, bf16: 64), zero-filled in shared
    # memory; M under the padded 128 rows
    ("float32", 100, 40, 256), ("bfloat16", 100, 48, 256)])
def test_p1_matches_plain(cuda_device, dt, M, K, N):
    zb = 8
    rng = np.random.RandomState(32)
    w = torch.from_numpy(rng.randn(M, K).astype(np.float32)).to(
        cuda_device).to(getattr(torch, dt))
    x = torch.from_numpy(rng.randn(zb * K, N).astype(np.float32)).to(
        cuda_device).to(getattr(torch, dt))
    before = exp_ptail_dot.launches
    got = exp_ptail_dot.dot_rows(w, x, zb, n_cells=4)
    ref = exp_ptail_dot.dot_rows_reference(w, x, zb)
    torch.cuda.synchronize()
    assert exp_ptail_dot.launches == before + 1
    torch.testing.assert_close(got, ref, **exp_ptail_dot.TOL[dt])


@pytest.mark.cuda
@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_p1_dot_only_instance_runs(cuda_device, dt):
    w = torch.rand(120, 432, device=cuda_device).to(getattr(torch, dt))
    x = torch.rand(2 * 432, 256, device=cuda_device).to(getattr(torch, dt))
    before = exp_ptail_dot.launches
    got = exp_ptail_dot.dot_rows(w, x, 2, n_cells=3, dot_only=True)
    torch.cuda.synchronize()
    assert exp_ptail_dot.launches == before + 1
    assert tuple(got.shape) == (2, 256) and bool(torch.isfinite(got).all())


@pytest.mark.cuda
@pytest.mark.parametrize("dt, M, K, N", [c for c in exp_ptail_dot.configs()
                                         if c[0] == "float32"])
def test_p1_f32_against_float64(cuda_device, dt, M, K, N):
    zb = 8
    rng = np.random.RandomState(34)
    w = torch.from_numpy(rng.randn(M, K).astype(np.float32)).to(cuda_device)
    x = torch.from_numpy(rng.randn(zb * K, N).astype(np.float32)).to(
        cuda_device)
    got = exp_ptail_dot.dot_rows(w, x, zb, n_cells=2).double()
    ref = exp_ptail_dot.dot_rows_reference(w, x, zb).double()
    ref64 = torch.stack([(w.double() @ x[zz * K:(zz + 1) * K].double())[0]
                         for zz in range(zb)])
    k64 = (got - ref64).abs().max().item()
    p64 = (ref - ref64).abs().max().item()
    assert k64 <= 2 * p64 + 1e-6, (k64, p64)


@pytest.mark.cuda
@pytest.mark.parametrize("probe", exp_ptail_ablate.PROBES)
@pytest.mark.parametrize("cin, cout, sp, dil", [
    (30, 45, (5, 40, 70), (1, 4, 4)),       # N tile 48, ragged y
    (64, 128, (5, 20, 90), (1, 1, 1)),      # N tile 128
])
def test_p2_probes(cuda_device, probe, cin, cout, sp, dil):
    x, w, b = _inputs(33, 1, cin, cout, sp, cuda_device)
    before = exp_ptail_ablate.launches
    got = exp_ptail_ablate.ablate(probe, x, w, b, dil)
    torch.cuda.synchronize()
    assert exp_ptail_ablate.launches == before + 1
    assert bool(torch.isfinite(got).all())
    out_shape = (1, cout, sp[0] - 2, sp[1] - 2 * dil[1], sp[2] - 2 * dil[2])
    if probe == "full":     # K1's own body: K1 bit for bit
        assert torch.equal(got, tailconv.conv3x3_dilated(x, w, b, dil))
        torch.testing.assert_close(
            got, tailconv.conv3x3_dilated_reference(x, w, b, dil), **TOL)
    elif probe == "noepi":
        ref = exp_ptail_ablate.probe_reference(probe, x, w, b, dil)
        torch.testing.assert_close(got, ref,
                                   **exp_ptail_ablate.noepi_tol(cin, ref))
    elif probe == "dmaonly":
        assert tuple(got.shape) == (256,)
    else:
        assert tuple(got.shape) == out_shape


# ------------------------------------------------------------- training


def _train_net(device, class_weights=None):
    """A small net of the training slice's nodes, optionally with class
    weights in its loss, and its augmenter on ``device``."""
    import elektronn2_tpu_torch.neuromancer as nm
    from elektronn2_tpu_torch.ops.warp import DeviceBatchAugmenter
    nm.model_manager.reset(seed=5)
    inp = nm.Input([2, 1, 7, 30, 30], "b,f,z,x,y", name="raw")
    h = nm.Conv(inp, 6, (1, 3, 3), (1, 2, 2), name="c0")
    h = nm.Conv(h, 8, (3, 3, 3), (1, 1, 1), name="c1")
    probs = nm.Softmax(nm.Conv(h, 2, 1, 1, activation_func="lin",
                               name="cls"), name="probs")
    tgt = nm.Input([2, *probs.shape.spatial_shape], "b,z,x,y",
                   dtype="int32", name="target")
    nll = nm.MultinoulliNLL(probs, tgt, target_is_sparse=True,
                            class_weights=class_weights, name="nll")
    m = nm.model_manager.getmodel("train_net")
    m.designate_nodes(input_node=inp, target_node=tgt,
                      loss_node=nm.AggregateLoss(nll), prediction_node=probs,
                      error_node=nm.Errors(probs, tgt, target_is_sparse=True))
    m.to(device)
    m.set_opt("Adam", lr=1e-3)
    rng = np.random.RandomState(6)
    raws = [rng.rand(1, 20, 70, 70).astype(np.float32) for _ in range(2)]
    aug = DeviceBatchAugmenter(
        raws, [(r[0] > 0.5).astype(np.int16) for r in raws],
        patch_size=inp.shape.spatial_shape, target_size=probs.shape
        .spatial_shape, target_strides=probs.shape.strides,
        grey_channels=[0], device=device)
    return m, aug


@pytest.fixture
def deterministic_cudnn():
    old = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    yield
    torch.backends.cudnn.deterministic = old


@pytest.mark.cuda
@pytest.mark.parametrize("class_weights", [None, [0.4, 1.6]])
def test_graphed_chunk_equals_eager_chunk(cuda_device, deterministic_cudnn,
                                          class_weights):
    """One replay of the chunk's CUDA graph = the eager chunk from the same
    parameters, optimiser state and generator state, bit for bit (the
    class-weighted loss included: its weights are made on the card once,
    so the capture copies nothing from the host)."""
    from elektronn2_tpu_torch.training.fused_loop import FusedTrainLoop
    m, aug = _train_net(cuda_device, class_weights)
    loop = FusedTrainLoop(m, aug, batch_size=2, n_inner=3, seed=7)
    loop.run_chunk()                 # one graphed chunk: a trained start
    m.snapshot_good()
    state = loop.generator.get_state()
    el, ee = loop._run_chunk_eager()
    eager = {n: {k: v.clone() for k, v in d.items()}
             for n, d in m.params.items()}
    m.repair_fuckup()
    loop.generator.set_state(state)
    gl, ge = loop.run_chunk()        # recaptured (repair wrote in place)
    np.testing.assert_array_equal(gl, el)
    np.testing.assert_array_equal(ge, ee)
    for n, d in eager.items():
        for k, v in d.items():
            assert torch.equal(m.params[n][k], v), (n, k)
    assert int(m.opt_state["step"]) == 6 and m._step_count == 9


@pytest.mark.cuda
def test_replays_draw_new_batches_and_setlr_needs_no_recapture(cuda_device):
    from elektronn2_tpu_torch.training.fused_loop import FusedTrainLoop
    m, aug = _train_net(cuda_device)
    loop = FusedTrainLoop(m, aug, batch_size=2, n_inner=2, seed=8)
    loop.run_chunk()
    graph = loop._graph
    m.optimiser.setlr(0.0)           # Adam with lr 0: weights stay
    w = m.params["c1"]["w"].clone()
    a, _ = loop.run_chunk()
    b, _ = loop.run_chunk()
    assert loop._graph is graph      # no recapture for a new lr
    assert torch.equal(m.params["c1"]["w"], w)
    assert not np.array_equal(a, b)  # the generator advanced: new batches
    m.optimiser.setlr(1e-3)
    loop.run_chunk()
    assert loop._graph is graph and not torch.equal(m.params["c1"]["w"], w)
    m.set_params({n: {k: v.clone() for k, v in d.items()}
                  for n, d in m.params.items()})
    loop.run_chunk()
    assert loop._graph is not graph  # new tensors: a new capture


@pytest.mark.cuda
def test_k1_serves_the_weights_a_replay_trained(cuda_device):
    """A replay updates the weights in place and bumps no version by
    itself; the loop bumps them, so K1's packed-weight cache repacks and
    the K1 route equals the cuDNN route on the trained weights."""
    from elektronn2_tpu_torch.ops.warp import DeviceBatchAugmenter
    from elektronn2_tpu_torch.training.fused_loop import FusedTrainLoop
    m = neuro3d_train_model(2, (7, 30, 30), widths=(4, 6, 8, 8),
                            device=cuda_device)
    m.optimiser.setlr(1e-2)
    ps = m.prediction_node.shape
    rng = np.random.RandomState(9)
    raws = [rng.rand(1, 20, 70, 70).astype(np.float32)]
    aug = DeviceBatchAugmenter(raws, [(raws[0][0] > 0.5).astype(np.int16)],
                               m.input_node.shape.spatial_shape,
                               ps.spatial_shape, ps.strides,
                               device=cuda_device)
    loop = FusedTrainLoop(m, aug, batch_size=2, n_inner=3, seed=9)
    vol = torch.from_numpy(rng.rand(1, 9, 60, 60).astype(np.float32)
                           ).to(cuda_device)
    m.set_dilated_impl("direct", zfold=True, pallas_tail=True)
    before = m.predict_dense_device(vol, pad_raw=True)   # packs the weights
    loop.run_chunk()
    n = tailconv.launches
    k1 = m.predict_dense_device(vol, pad_raw=True)
    assert tailconv.launches == n + 2
    m.set_dilated_impl("direct", zfold=True, pallas_tail=False)
    cudnn = m.predict_dense_device(vol, pad_raw=True)
    torch.testing.assert_close(k1, cudnn, atol=1e-5, rtol=0)
    assert (k1 - before).abs().max().item() > 1e-4


def _sweep_setup(tmp_path, device):
    """The flagship on ``device`` (weights from numpy seed 10, K1's route
    on) and a 16x64x60 uint8 KNOSSOS dataset in 16^3 cubes."""
    from elektronn2_tpu_torch.data.knossos_array import save_knossos
    rng = np.random.RandomState(10)
    m = flagship_model(mfp=True, patch=[9, 41, 41], device=device)
    m.set_params({n: {k: rng.standard_normal(tuple(v.shape)) * 0.1
                      for k, v in d.items()} for n, d in m.params.items()})
    m.set_dilated_impl("direct", zfold=True, pallas_tail=True)
    raw = (rng.rand(16, 64, 60) * 255).astype(np.uint8)
    path = str(tmp_path / "raw")
    if not os.path.exists(path):
        save_knossos(raw, path, cube_edge=16)
    return m, path


@pytest.mark.cuda
def test_sweep_on_card_equals_cpu(cuda_device, tmp_path):
    """``sweep_knossos`` on the card (K1, pinned staging, side-stream
    readback) equals the same sweep on the CPU (K1's plain version), per
    slab and two slabs at a time, within 1e-5 (the flagship's)."""
    from elektronn2_tpu_torch.data.knossos_array import KnossosArray
    mc, path = _sweep_setup(tmp_path, "cpu")
    mg, _ = _sweep_setup(tmp_path, cuda_device)
    for sb in (1, 2):
        want = mc.sweep_knossos(KnossosArray(path), step=[8, 32, 32],
                                slab_batch=sb)
        got = mg.sweep_knossos(KnossosArray(path), step=[8, 32, 32],
                               slab_batch=sb)
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


@pytest.mark.cuda
def test_sweep_slab_batch_launches_k1_at_n2(cuda_device, tmp_path,
                                            monkeypatch):
    from elektronn2_tpu_torch.data.knossos_array import KnossosArray
    m, path = _sweep_setup(tmp_path, cuda_device)
    one = m.sweep_knossos(KnossosArray(path), step=[8, 32, 32])
    batches = []
    orig = tailconv.conv3x3_dilated

    def spy(x, w, b, dil=(1, 1, 1), relu=True):
        batches.append(x.shape[0])
        return orig(x, w, b, dil, relu)

    monkeypatch.setattr(tailconv, "conv3x3_dilated", spy)
    n = tailconv.launches
    two = m.sweep_knossos(KnossosArray(path), step=[8, 32, 32],
                          slab_batch=2)
    assert batches == [2] * 8 and tailconv.launches == n + 8   # 4 chunks
    np.testing.assert_allclose(two, one, atol=1e-5, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("slab_batch", [1, 2])
def test_sweep_makes_no_host_sync(cuda_device, tmp_path, slab_batch):
    """The chunk loop copies every slab in and every result out without a
    host sync: only the readback events are waited on (the readback of
    chunk N after chunk N+1 is enqueued)."""
    from elektronn2_tpu_torch.data.knossos_array import KnossosArray
    m, path = _sweep_setup(tmp_path, cuda_device)
    want = m.sweep_knossos(KnossosArray(path), step=[8, 32, 32],
                           slab_batch=slab_batch)          # warm
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = m.sweep_knossos(KnossosArray(path), step=[8, 32, 32],
                              slab_batch=slab_batch)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
