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
The host-fed loop (``HostFedFusedLoop``) likewise, on batches staged through
its pinned slots; its replays over four chunks with the prefetch thread
equal eager ``trainingstep`` calls on the recorded batches within rtol
1e-5 (other buffer addresses may take other cuDNN algorithms). The
Trainer's forked workers deliver batches with CUDA up in the parent, and
its staged per-step path makes no host sync. K3's bf16 mode equals its
plain version bit for bit (also in a volume NaN outside every staged box,
with both row alignments); a pool wave replayed from its chunk graph equals
the eager wave bit for bit and makes no host sync; the pools' traces equal
``trace_batch``'s within 1e-5; ``tune_batch`` keeps the caller's graph; the
fused TBPTT carry graphed equals it eager bit for bit and the per-step
carry within 1e-5.
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


def _host_data(model, seed=4):
    """A host data source (``BatchCreatorImage``, numpy) for ``model``."""
    from elektronn2_tpu_torch.data.cnndata import BatchCreatorImage
    rng = np.random.RandomState(seed)
    raws = [rng.rand(1, 20, 70, 70).astype(np.float32) for _ in range(2)]
    bc = BatchCreatorImage(input_data=raws,
                           target_data=[(r[0] > 0.5).astype(np.int16)
                                        for r in raws])
    bc.link_model_geometry(model)
    bc.rng = np.random.RandomState(seed + 1)
    return bc


@pytest.mark.cuda
def test_host_fed_graphed_chunk_equals_eager_chunk(cuda_device,
                                                   deterministic_cudnn):
    """``HostFedFusedLoop``: one replay of the chunk's CUDA graph on K host
    batches staged through the pinned slots = the eager chunk on the same
    batches from the same state, bit for bit."""
    from elektronn2_tpu_torch.training.fused_loop import HostFedFusedLoop
    m, _ = _train_net(cuda_device)
    data = _host_data(m)
    loop = HostFedFusedLoop(m, data, 2, 3, batch_args={"warp": 0.5},
                            prefetch=False)
    loop.run_chunk()                 # one graphed chunk: a trained start
    m.snapshot_good()
    rng = data.rng.get_state()
    el, ee = loop._run_chunk_eager()
    eager = {n: {k: v.clone() for k, v in d.items()}
             for n, d in m.params.items()}
    m.repair_fuckup()
    data.rng.set_state(rng)          # the same K batches again
    gl, ge = loop.run_chunk()        # recaptured (repair wrote in place)
    np.testing.assert_array_equal(gl, el)
    np.testing.assert_array_equal(ge, ee)
    for n, d in eager.items():
        for k, v in d.items():
            assert torch.equal(m.params[n][k], v), (n, k)
    assert loop.capture_seconds is not None


@pytest.mark.cuda
def test_host_fed_chunks_draw_new_feeds_through_the_double_buffer(
        cuda_device):
    """With the prefetch thread filling one pinned slot while the graph
    reads what was copied from the other, every chunk trains on its own
    batches: the replayed losses equal eager ``trainingstep``s on the
    recorded batches in order (a slot overwritten mid-copy would show as
    a batch that was never drawn)."""
    from elektronn2_tpu_torch.training.fused_loop import HostFedFusedLoop
    m, _ = _train_net(cuda_device)
    data = _host_data(m, seed=8)
    drawn = []
    getbatch = data.getbatch

    def recording(*a, **kw):
        drawn.append(getbatch(*a, **kw))
        return drawn[-1]

    data.getbatch = recording
    m.snapshot_good()
    loop = HostFedFusedLoop(m, data, 2, 3, batch_args={"warp": 0.5})
    graph = []
    for _ in range(4):
        graph.append(loop.run_chunk()[0])
    loop.close()
    assert len({c.tobytes() for c in graph}) == 4
    m.repair_fuckup()
    eager = []
    for d, t in drawn[:12]:
        loss, _ = m.trainingstep(torch.from_numpy(d).to(cuda_device),
                                 torch.from_numpy(t).to(cuda_device))
        eager.append(float(loss))
    np.testing.assert_allclose(np.concatenate(graph), eager, rtol=1e-5,
                               atol=0)


@pytest.mark.cuda
def test_k1_serves_the_weights_a_host_fed_replay_trained(cuda_device):
    from elektronn2_tpu_torch.training.fused_loop import HostFedFusedLoop
    m = neuro3d_train_model(2, (7, 30, 30), widths=(4, 6, 8, 8),
                            device=cuda_device)
    m.optimiser.setlr(1e-2)
    loop = HostFedFusedLoop(m, _host_data(m, seed=12), 2, 3,
                            batch_args={"warp": 0.5})
    vol = torch.from_numpy(np.random.RandomState(13).rand(1, 9, 60, 60)
                           .astype(np.float32)).to(cuda_device)
    m.set_dilated_impl("direct", zfold=True, pallas_tail=True)
    before = m.predict_dense_device(vol, pad_raw=True)   # packs the weights
    loop.run_chunk()
    loop.close()
    n = tailconv.launches
    k1 = m.predict_dense_device(vol, pad_raw=True)
    assert tailconv.launches == n + 2
    m.set_dilated_impl("direct", zfold=True, pallas_tail=False)
    cudnn = m.predict_dense_device(vol, pad_raw=True)
    torch.testing.assert_close(k1, cudnn, atol=1e-5, rtol=0)
    assert (k1 - before).abs().max().item() > 1e-4


@pytest.mark.cuda
def test_workers_forked_after_cuda_init_deliver_batches(cuda_device):
    """The Trainer forks its ``BackgroundProc`` workers after its first
    step, with CUDA up in the parent; the numpy-only ``getbatch`` runs in
    them, batches arrive, and shutdown leaves no worker behind."""
    from elektronn2_tpu_torch.training.parallelisation import BackgroundProc
    m, _ = _train_net(cuda_device)
    data = _host_data(m)
    m.predict(torch.zeros(tuple(m.input_node.shape.shape),
                          device=cuda_device))   # cuDNN and CUDA are up
    torch.cuda.synchronize()
    bg = BackgroundProc(data.getbatch, n_proc=2, target_args=(2,),
                        target_kwargs={"warp": 0.5}, mode="process")
    try:
        got = [bg.get(timeout=60) for _ in range(6)]
    finally:
        bg.shutdown()
    assert all(d.shape == (2, 1, 7, 30, 30) for d, _ in got)
    assert len({d.tobytes() for d, _ in got}) == 6
    assert not any(w.is_alive() for w in bg._workers)


@pytest.mark.cuda
def test_staged_training_steps_make_no_host_sync(cuda_device, tmp_path):
    """The Trainer's per-step path (a host batch staged through the pinned
    slots, then ``trainingstep``) makes no host sync; the losses are read
    after (the loop's one-step lag reads each one step later)."""
    from elektronn2_tpu_torch.training.trainer import Trainer
    m, _ = _train_net(cuda_device)
    data = _host_data(m)
    tr = Trainer(model=m, data=data, batch_size=2, n_workers=0,
                 save_path=str(tmp_path), device=cuda_device)
    batches = [data.getbatch(2, warp=0.5) for _ in range(5)]
    tr._train_batch(batches[0])                 # warm: cuDNN, allocator
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        losses = [tr._train_batch(b)[0] for b in batches[1:]]
    finally:
        torch.cuda.set_sync_debug_mode("default")
    vals = [float(v) for v in losses]
    assert np.isfinite(vals).all() and m._step_count == 5


# --------------------------------------------------------- K3's bf16 mode

@pytest.mark.cuda
@pytest.mark.parametrize("f, shape, patch, B", [
    (1, (40, 40, 48), (8, 8, 8), 64),          # Y % 8 == 0: aligned rows
    (2, (30, 34, 42), (5, 7, 6), 40),          # Y % 8 != 0
    (1, (24, 26, 29), (4, 4, 4), 33),          # Y odd, agents near borders
])
def test_k3_bf16_matches_plain(cuda_device, f, shape, patch, B):
    """K3's bf16 mode equals its plain version (the same bf16 arithmetic in
    PyTorch) bit for bit, ``ok`` included, and counts its launch."""
    rng = np.random.RandomState(sum(shape) + B)
    vol = torch.from_numpy(rng.rand(f, *shape).astype(np.float32)).to(
        cuda_device).to(torch.bfloat16)
    pos = torch.from_numpy(rng.uniform(-1.0, np.asarray(shape) + 1.0,
                                       (B, 3)).astype(np.float32))
    F = flight_frame(torch.from_numpy(rng.randn(B, 3).astype(np.float32)))
    pos, F = pos.to(cuda_device), F.to(cuda_device)
    before = extract_rot.launches_bf16
    got, ok = extract_rot.rotated_patches_bf16(vol, pos, F, patch)
    ref, ok_ref = extract_rot.rotated_patches_bf16_reference(vol, pos, F,
                                                             patch)
    torch.cuda.synchronize()
    assert extract_rot.launches_bf16 == before + 1
    assert torch.equal(ok, ok_ref) and bool(ok.any())
    assert torch.equal(got[ok], ref[ok])
    torch.testing.assert_close(got, ref, atol=1e-4, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("Y", [72, 70])
@pytest.mark.parametrize("heading", ["random", "axis", "diagonal"])
def test_k3_bf16_staged_windows(cuda_device, heading, Y):
    """The NaN trap in the bf16 mode: a volume NaN everywhere outside the
    agents' staged boxes (bf16 rows of 8 values to a 16-byte piece, Y % 8
    == 0 and not), half the agents at the ok bound: finite patches equal to
    the plain version's, equal ok flags, every item staged, and the values
    staged the boxes' own count."""
    rng = np.random.RandomState(27)
    B, patch, shape = 64, (16, 16, 16), (2, 60, 66, Y)
    h = torch.from_numpy(_k3_headings(heading, B, rng).astype(np.float32))
    F = flight_frame(h.to(cuda_device))
    dims = np.asarray(shape[1:], np.float64)
    pos = rng.uniform(15.0, dims - 15.0, (B, 3))
    half = (np.asarray(patch) - 1) / 2.0
    low = np.abs(F.double().cpu().numpy()).transpose(0, 2, 1) @ half
    deltas = (-1e-3, -1e-5, 0.0, 1e-5, 1e-3, 0.25)
    for i in range(0, B, 2):
        d = (i // 2) % 3
        pos[i, d] = low[i, d] + deltas[(i // 2) % len(deltas)]
    pos = torch.from_numpy(pos.astype(np.float32)).to(cuda_device)
    lo, hi = _staged_box(shape, pos, F, patch)
    edges = (hi - lo + 1).cpu()
    assert int(edges.max()) <= extract_rot.box_edge(patch)
    values = shape[0] * int((edges[:, 0] * edges[:, 1] * (
        (edges[:, 2] + 14) // 8 * 8)).sum())
    keep = torch.zeros(shape[1:], dtype=torch.bool)
    for a, b in zip(lo.tolist(), hi.tolist()):
        keep[a[0]:b[0] + 1, a[1]:b[1] + 1, a[2]:b[2] + 1] = True
    vol = torch.from_numpy(rng.rand(*shape).astype(np.float32))
    vol[:, ~keep] = float("nan")
    vol = vol.to(cuda_device).to(torch.bfloat16)
    stats = extract_rot.staging_stats(vol.device, torch.bfloat16)
    stats.zero_()
    got, ok = extract_rot.rotated_patches_bf16(vol, pos, F, patch)
    ref, ok_ref = extract_rot.rotated_patches_bf16_reference(vol, pos, F,
                                                             patch)
    torch.cuda.synchronize()
    assert stats.tolist() == [0, values]
    assert bool(torch.isfinite(got).all())
    assert torch.equal(got, ref)
    assert torch.equal(ok, ok_ref) and bool(ok.any()) and not bool(ok.all())


@pytest.mark.cuda
def test_bf16_tracer_launches_the_bf16_kernel(cuda_device):
    """``DeviceTracer(rot_compute_dtype="bfloat16")`` on the card rolls out
    through K3's bf16 kernel (a graphed rollout), as its plain route does on
    the same card, within 1e-4 over a short horizon."""
    m = tracer_model((8, 8, 8), enc_w=16, gru_w=16, device=cuda_device)
    rng = np.random.RandomState(28)
    vol = torch.from_numpy(rng.rand(1, 48, 48, 48).astype(np.float32)).to(
        cuda_device)
    seeds = rng.uniform(12, 36, (32, 3)).astype(np.float32)
    kw = dict(max_steps=6, min_step=0.0, rotate_to_heading=True,
              rot_compute_dtype="bfloat16")
    dt = DeviceTracer(m, vol, **kw)
    assert dt._rot_kernel and dt._rot_bf16
    dt.trace_batch(seeds)
    before = (extract_rot.launches, extract_rot.launches_bf16)
    got = dt.trace_batch(seeds)
    assert (extract_rot.launches, extract_rot.launches_bf16) == (
        before[0], before[1] + 6)
    ref = DeviceTracer(m, vol, use_pallas_rot=False, **kw).trace_batch(seeds)
    for g, r in zip(got, ref):
        assert len(g.coords) == len(r.coords)
        np.testing.assert_allclose(g.coords, r.coords, atol=1e-4)


# ------------------------------------------------------------- the pools

def _pool_tracer(device, rotate=False, mode="float32", K=8):
    m = tracer_model((8, 8, 8), enc_w=16, gru_w=16, device=device)
    rng = np.random.RandomState(29)
    vol = torch.from_numpy(rng.rand(1, 40, 40, 40).astype(np.float32)).to(
        device)
    seeds = rng.uniform(8, 32, (40, 3)).astype(np.float32)
    return m, DeviceTracer(m, vol, max_steps=K, min_step=0.0,
                           rotate_to_heading=rotate,
                           rot_compute_dtype=mode), seeds


@pytest.mark.cuda
@pytest.mark.parametrize("rotate, mode", [(False, "float32"),
                                          (True, "float32"),
                                          (True, "bfloat16")])
def test_graphed_pool_wave_equals_eager(cuda_device, rotate, mode):
    """A pool wave replayed from the chunk graph (S = 5: the last replay
    runs past the wave's end) equals the same wave launched eagerly, bit
    for bit, outputs and final state; a replayed wave makes no host sync;
    the pool keeps its graphs apart from the rollout's."""
    m, dt, seeds = _pool_tracer(cuda_device, rotate, mode)
    dt.POOL_CHUNK = 5
    dt.trace_batch(seeds[:8])
    kept = list(dt._graphs.items())
    B, N, total = 8, len(seeds), 23
    out = []
    for graphed in (True, False):
        st = dt._pool_setup(B, N)
        traj = dt._pool_wave(m.params, st, seeds, N, total, total - 8, 0,
                             graphed=graphed)
        out.append(list(traj) + [x.clone() for x in st.tensors()])
    assert all(torch.equal(a, b) for a, b in zip(*out))
    assert len(dt._pool_graphs) == 1 and list(dt._graphs.items()) == kept
    st = dt._pool_setup(B, N)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        dt._pool_wave(m.params, st, seeds, N, total, total - 8, 0)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_pool_traces_equal_trace_batch_on_the_card(cuda_device):
    """The respawning and chained pools on the card give each seed's own
    rollout (``trace_batch``), within 1e-5, every consumed seed once."""
    m, dt, seeds = _pool_tracer(cuda_device, K=6)
    ref = dt.trace_batch(seeds)
    got, st = dt.trace_pool(seeds, batch_size=8)
    chain, cst = dt.trace_pool_chain(seeds, batch_size=8, wave_seeds=8,
                                     wave_steps=4)
    assert st["consumed"] == cst["consumed"] == len(seeds)
    assert cst["waves"] >= 3
    for traces in (got, chain):
        for g, r in zip(traces, ref):
            assert len(g.coords) == len(r.coords)
            np.testing.assert_allclose(g.coords, r.coords, atol=1e-5)


@pytest.mark.cuda
def test_tune_batch_restores_the_kept_graph(cuda_device):
    m, dt, seeds = _pool_tracer(cuda_device, K=10)
    dt.trace_batch(seeds[:8])
    kept = list(dt._graphs.items())
    res = dt.tune_batch(candidates=(8, 16, 32), steps=4)
    assert set(res["table"]) == {8, 16, 32} and dt.max_steps == 10
    assert list(dt._graphs.items()) == kept


# --------------------------------------------------- the fused TBPTT carry

@pytest.mark.cuda
def test_graphed_fused_carry_equals_eager_and_per_step(cuda_device):
    """``HostFedFusedLoop(carry_map=...)`` on the card: the carry is a static
    buffer the chunk graph reads first and writes last. Two graphed chunks
    equal two eager chunks from the same state bit for bit (losses, carry,
    weights), and the per-step TBPTT on the same batches within 1e-5."""
    from elektronn2_tpu_torch.training.fused_loop import HostFedFusedLoop
    T, B, K = 4, 8, 3
    rng = np.random.RandomState(30)
    feeds = [(rng.rand(T, B, 1, 8, 8, 8).astype(np.float32),
              rng.rand(T, B, 3).astype(np.float32)) for _ in range(2 * K)]

    class Stub:
        def __init__(self):
            self.items = list(feeds)

        def getbatch(self, bs, **kw):
            return self.items.pop(0)

    def model():
        m = tracer_model((8, 8, 8), enc_w=16, gru_w=16, batch=B, t=T,
                         device=cuda_device)
        m.set_params({n: {k: np.random.RandomState(31).standard_normal(
            tuple(v.shape)) * 0.2 for k, v in d.items()}
            for n, d in m.params.items()})
        m.set_opt("Adam", lr=1e-3)
        m.debug_outputs.append(m.nodes["scan"])
        return m

    runs = []
    for graphed in (True, False):
        m = model()
        loop = HostFedFusedLoop(m, Stub(), B, K, prefetch=False,
                                carry_map={"scan": "h0"})
        losses = np.concatenate([
            (loop.run_chunk() if graphed else loop._run_chunk_eager())[0]
            for _ in range(2)])
        runs.append((losses, loop.rnn_carry["h0"].clone(), m))
    (gl, gh, gm), (el, eh, em) = runs
    np.testing.assert_array_equal(gl, el)
    assert torch.equal(gh, eh)
    for n in gm.params:
        for k in gm.params[n]:
            assert torch.equal(gm.params[n][k], em.params[n][k]), (n, k)
    m = model()
    carry, ref = None, []
    for d, t in feeds:
        lv, aux = m.trainingstep(
            torch.from_numpy(d).to(cuda_device),
            torch.from_numpy(t).to(cuda_device),
            feed_overrides=None if carry is None else {"h0": carry})
        ref.append(float(lv))
        carry = aux["scan"][-1]
    np.testing.assert_allclose(gl, ref, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(gh, carry, atol=1e-5, rtol=0)


# ------------------------------------------- batch norm, dropout, remat

def _bn_loop(device, remat=False, seed=11):
    """The batch-normed, dropout neuro3d net at narrow widths on the card,
    its augmenter and a fused loop of three steps."""
    from elektronn2_tpu_torch.ops.warp import DeviceBatchAugmenter
    from elektronn2_tpu_torch.training.fused_loop import FusedTrainLoop
    from elektronn2_tpu_torch.utils.convert import neuro3d_bn_train_model
    m = neuro3d_bn_train_model(2, (7, 30, 30), widths=(4, 6, 8, 8),
                               device=device)
    m.set_remat(remat)
    ps = m.prediction_node.shape
    rng = np.random.RandomState(seed)
    raws = [rng.rand(1, 20, 70, 70).astype(np.float32) for _ in range(2)]
    aug = DeviceBatchAugmenter(
        raws, [(r[0] > 0.5).astype(np.int16) for r in raws],
        patch_size=m.input_node.shape.spatial_shape,
        target_size=ps.spatial_shape, target_strides=ps.strides,
        grey_channels=[0], device=device)
    return m, FusedTrainLoop(m, aug, batch_size=2, n_inner=3, seed=seed)


@pytest.mark.cuda
def test_bn_dropout_graphed_chunk_equals_eager_chunk(cuda_device,
                                                     deterministic_cudnn):
    """Batch norm's running statistics and dropout's masks inside the chunk
    graph: a replay equals the eager chunk bit for bit (losses, parameters,
    running statistics), and two replays equal two eager chunks."""
    m, loop = _bn_loop(cuda_device)
    loop.run_chunk()                            # captured: a trained start
    assert sorted(m.state) == ["conv0", "conv1", "conv2", "conv3"]
    m.snapshot_good()
    gen = loop.generator.get_state()
    eager = [loop._run_chunk_eager()[0] for _ in range(2)]
    want_p = {n: {k: v.clone() for k, v in d.items()}
              for n, d in m.params.items()}
    want_s = {n: {k: v.clone() for k, v in d.items()}
              for n, d in m.state.items()}
    m.repair_fuckup()
    loop.generator.set_state(gen)
    graphed = [loop.run_chunk()[0] for _ in range(2)]
    for g, e in zip(graphed, eager):
        np.testing.assert_array_equal(g, e)
    for tree, want in ((m.params, want_p), (m.state, want_s)):
        for n, d in want.items():
            for k, v in d.items():
                assert torch.equal(tree[n][k], v), (n, k)


@pytest.mark.cuda
def test_lowering_switch_on_a_live_loop_recaptures(cuda_device,
                                                   deterministic_cudnn):
    """``set_train_lowering``/``set_remat`` between two chunks of one loop:
    the next chunk is a new capture under the new trace, and it equals the
    eager chunk under that trace bit for bit."""
    m, loop = _bn_loop(cuda_device)
    loop.run_chunk()
    for switch in (lambda: m.set_train_lowering(zfold=True),
                   lambda: m.set_remat(True)):
        switch()
        old = loop._graph
        m.snapshot_good()
        gen = loop.generator.get_state()
        eager = loop._run_chunk_eager()[0]
        m.repair_fuckup()
        loop.generator.set_state(gen)
        graphed = loop.run_chunk()[0]
        assert loop._graph is not old
        np.testing.assert_array_equal(graphed, eager)


@pytest.mark.cuda
def test_remat_under_capture_same_losses(cuda_device, deterministic_cudnn):
    """Remat inside a CUDA graph (checkpoint without the CUDA generator's
    state, the masks drawn once): the same chunk losses as without."""
    losses = []
    for remat in (False, True):
        m, loop = _bn_loop(cuda_device, remat=remat)
        losses.append(np.concatenate([loop.run_chunk()[0]
                                      for _ in range(2)]))
    np.testing.assert_allclose(losses[1], losses[0], rtol=1e-5, atol=1e-6)


@pytest.mark.cuda
def test_skel_loss_capture_refused(cuda_device):
    """A fused loop over a SkelLoss head raises before any capture, naming
    SkelLossField; the same head trains per step on the card."""
    from elektronn2_tpu_torch import neuromancer as nm
    from elektronn2_tpu_torch.data import skeleton as sk
    from elektronn2_tpu_torch.training.fused_loop import HostFedFusedLoop
    sk.clear_skeleton_registry()
    line = sk.SkeletonMFK(np.stack([np.full(9, 5.0), np.full(9, 5.0),
                                    np.arange(9.0) + 2], 1),
                          [(i, i + 1) for i in range(8)])
    sid = sk.register_skeleton(line)
    nm.model_manager.reset()
    feat = nm.Input([2, 8], "b,f", name="feat")
    skel = nm.GenericInput(name="skel")
    pred = nm.Perceptron(feat, 3, activation_func="lin", name="step")
    m = nm.model_manager.getmodel()
    m.designate_nodes(input_node=feat, prediction_node=pred,
                      loss_node=nm.AggregateLoss(nm.SkelLoss(pred, skel)),
                      target_node=skel)
    m.to(cuda_device)
    m.set_opt("Adam", lr=1e-2)

    class Data:
        def getbatch(self, batch_size):
            return (np.ones((2, 8), np.float32),
                    np.array([[sid, 5, 5, 4], [sid, 5, 6, 6]], np.float32))

    loop = HostFedFusedLoop(m, Data(), 2, 2, prefetch=False)
    with pytest.raises(NotImplementedError, match="SkelLossField"):
        loop.run_chunk()
    assert loop._graph is None
    x, s = (torch.from_numpy(a).to(cuda_device) for a in Data().getbatch(2))
    assert np.isfinite(float(m.trainingstep(x, s)[0]))
    sk.clear_skeleton_registry()


@pytest.mark.cuda
def test_modelload_puts_bn_state_on_the_card(cuda_device, tmp_path):
    """``modelload`` of a batch-normed model puts its running statistics on
    the card with the parameters, and ``to`` moves them both ways."""
    from elektronn2_tpu_torch.neuromancer.model import modelload
    from elektronn2_tpu_torch.utils.convert import neuro3d_bn_train_model
    m = neuro3d_bn_train_model(2, (7, 30, 30), widths=(4, 6, 8, 8),
                               device="cpu")
    x = torch.rand(*m.input_node.shape)
    t = (torch.rand(*m.target_node.shape) > 0.5).int()
    m.trainingstep(x, t)
    path = str(tmp_path / "bn.mdl")
    m.save(path)
    card = modelload(path)
    devs = {v.device.type for d in card.state.values() for v in d.values()}
    assert devs == {"cuda"} and card.device.type == "cuda"
    for n, d in m.state.items():
        for k, v in d.items():
            assert torch.equal(card.state[n][k].cpu(), v)
    card.predict(x.to(cuda_device))         # no device mix in evaluation
    assert {v.device.type for d in card.to("cpu").state.values()
            for v in d.values()} == {"cpu"}
