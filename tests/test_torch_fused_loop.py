"""The port's fused training loop (``training/fused_loop.py``) on the CPU.

On the CPU a chunk runs eagerly (the card replays a CUDA graph of it;
tests/test_torch_cuda.py holds the replay to the eager chunk there). Here:
the chunk equals K sequential ``device_batch`` -> ``trainingstep`` calls
from the same generator state, exactly (the same ops in the same order);
the step counters advance by K; a hyperparameter changed between chunks
applies to the next one; and the graph key moves exactly when the
tensors a captured chunk reads are replaced or written from outside.
The counterpart of the JAX package's
tests/test_training.py::test_fused_loop_matches_sequential.
"""

import numpy as np
import pytest
import torch
from scipy import ndimage

from elektronn2_tpu_torch.ops.warp import DeviceBatchAugmenter
from elektronn2_tpu_torch.training.fused_loop import FusedTrainLoop
from elektronn2_tpu_torch.utils.convert import neuro3d_train_model

torch.set_num_threads(1)


def _setup(elastic=0.0):
    rng = np.random.RandomState(21)
    raws = [ndimage.gaussian_filter(rng.rand(24, 64, 64), 1
                                    ).astype(np.float32)[None]
            for _ in range(2)]
    labs = [(r[0] > r.mean()).astype(np.int16) for r in raws]
    m = neuro3d_train_model(batch=2, patch=(7, 30, 30), widths=(4, 5, 6, 6),
                            device="cpu")
    ps = m.prediction_node.shape
    aug = DeviceBatchAugmenter(raws, labs, patch_size=m.input_node.shape
                               .spatial_shape, target_size=ps.spatial_shape,
                               target_strides=ps.strides, grey_channels=[0],
                               warp_amount=0.5, elastic_sigma=elastic,
                               seed=5, device="cpu")
    return m, aug


@pytest.mark.parametrize("elastic", [0.0, 1.0])
def test_chunk_equals_sequential_steps(elastic):
    m, aug = _setup(elastic)
    K = 3
    loop = FusedTrainLoop(m, aug, batch_size=2, n_inner=K, warp=0.7, seed=42)
    m.snapshot_good()
    losses, errs = loop.run_chunk()
    assert errs is None and losses.shape == (K,) and losses.dtype == np.float32
    assert m._step_count == K and int(m.opt_state["step"]) == K
    after = {n: {p: v.clone() for p, v in d.items()}
             for n, d in m.params.items()}
    m.repair_fuckup()                      # back to the start, in place
    gen = torch.Generator().manual_seed(42)
    seq = []
    for _ in range(K):
        data, tgt = aug.device_batch(gen, 2, warp=0.7, grey=True, flip=True)
        seq.append(float(m.trainingstep(data, tgt)[0]))
    np.testing.assert_array_equal(losses, np.float32(seq))
    for n, d in after.items():
        for p, v in d.items():
            assert torch.equal(m.params[n][p], v), (n, p)


def test_hyper_change_between_chunks_applies():
    m, aug = _setup()
    loop = FusedTrainLoop(m, aug, batch_size=2, n_inner=2, seed=1)
    w = m.params["conv2"]["w"]
    w0 = w.clone()
    loop.run_chunk()
    assert not torch.equal(w, w0)
    m.optimiser.setlr(0.0)                 # Adam with lr 0 moves nothing
    w1 = w.clone()
    l2, _ = loop.run_chunk()
    assert torch.equal(w, w1)
    assert int(m.opt_state["step"]) == 4 and m._step_count == 4
    m.optimiser.setlr(1e-3)
    loop.run_chunk()
    assert not torch.equal(w, w1)
    assert np.isfinite(l2).all()


def test_error_node_fills_errors():
    import elektronn2_tpu_torch.neuromancer as nm
    m, aug = _setup()
    probs, tgt = m.prediction_node, m.target_node
    m.error_node = nm.Errors(probs, tgt, target_is_sparse=True)
    loop = FusedTrainLoop(m, aug, batch_size=2, n_inner=3, seed=2)
    losses, errs = loop.run_chunk()
    assert errs.shape == (3,) and ((errs >= 0) & (errs <= 1)).all()


def test_graph_key_moves_with_what_the_graph_reads():
    m, aug = _setup()
    loop = FusedTrainLoop(m, aug, batch_size=2, n_inner=2, seed=3)
    k0 = loop.graph_key()
    assert loop.graph_key() == k0
    loop.run_chunk()                       # eager on the CPU: bumps versions
    k1 = loop.graph_key()
    assert k1 != k0
    m.set_params({n: {p: v.clone() for p, v in d.items()}
                  for n, d in m.params.items()})
    k2 = loop.graph_key()
    assert k2 != k1                        # new tensors
    m.set_opt("SGD", lr=1e-2)
    k3 = loop.graph_key()
    assert k3 != k2                        # new slots
    with torch.no_grad():
        m.params["cls"]["b"].add_(1.0)     # an outside in-place write
    assert loop.graph_key() != k3
    old = torch.backends.cudnn.deterministic
    try:
        k4 = loop.graph_key()
        torch.backends.cudnn.deterministic = not old
        assert loop.graph_key() != k4
    finally:
        torch.backends.cudnn.deterministic = old


@pytest.mark.parametrize("switch", [
    lambda m: m.set_train_lowering(zfold=True),
    lambda m: m.set_train_lowering(skipsum=True),
    lambda m: m.set_remat(True),
    lambda m: m.set_compute_dtype("bfloat16")],
    ids=["zfold", "skipsum", "remat", "bf16"])
def test_graph_key_moves_with_the_trace_switches(switch):
    """A trace switch flipped on a live loop changes the key, so the card
    recaptures the chunk under the new trace instead of replaying the old
    one; switching back restores the key."""
    m, aug = _setup()
    loop = FusedTrainLoop(m, aug, batch_size=2, n_inner=2, seed=3)
    loop.run_chunk()
    k0 = loop.graph_key()
    switch(m)
    assert loop.graph_key() != k0
    m.set_train_lowering(zfold=False, skipsum=False)
    m.set_remat(False)
    m.set_compute_dtype(None)
    assert loop.graph_key() == k0


def test_loop_checks_its_arguments():
    m, aug = _setup()
    with pytest.raises(ValueError, match="n_inner"):
        FusedTrainLoop(m, aug, batch_size=2, n_inner=0)
    aug.device = torch.device("meta")
    with pytest.raises(ValueError, match="one device"):
        FusedTrainLoop(m, aug, batch_size=2, n_inner=1)
