"""The port's CUDA kernels on the card (skipped without one).

This file imports neither jax nor the JAX package, so it runs on a machine
that has only PyTorch with CUDA: ``python -m pytest tests/test_torch_cuda.py
--noconftest -q`` (``--noconftest``: ``tests/conftest.py`` imports jax).
Each test holds a kernel against its plain PyTorch version on the same
inputs; tolerance 1e-4 for K1 (float32 sums of up to 1080 products in
another order), 1e-5 on the flagship's probabilities.
"""

import numpy as np
import pytest
import torch

from elektronn2_tpu_torch.ops import tailconv
from elektronn2_tpu_torch.utils.convert import flagship_model

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
    (1, 30, 45, (5, 40, 70), (1, 1, 1)),      # two channel groups
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
def test_k1_rejects_host_tensors_mixed_with_card(cuda_device):
    x, w, b = _inputs(12, 1, 4, 4, (6, 10, 12), cuda_device)
    with pytest.raises(ValueError, match="is on"):
        tailconv.conv3x3_dilated(x, w.cpu(), b, (1, 1, 1))


@pytest.mark.cuda
def test_flagship_k1_route_matches_cudnn_route(cuda_device):
    m = flagship_model(mfp=True, patch=[9, 41, 41]).to(cuda_device)
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
