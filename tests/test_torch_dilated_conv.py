"""K5 (``elektronn2_tpu_torch.ops.experimental.dilated_conv``) against the
JAX package's ``dilated_conv_pallas``.

On the CPU the port's ``dilated_conv`` runs its plain PyTorch version; it
is held against the Pallas kernel run in interpret mode, as
``tests/test_pallas_experimental.py`` runs it, on the same numpy inputs.
The JAX side keeps its TPU tile rules (TY = Yo = 128, Y over-padded to
``_round_up(128 + 2d, 128)``), and the port gets the same over-padded
array, so this also holds the over-padded-Y contract. Tolerance 1e-4:
float32 sums of up to 27*8 products of values in [0, 1), in another order.
The CUDA kernel is held against the plain version on the card by
``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

import elektronn2_tpu.ops.experimental.pallas_dilated_conv as P
from elektronn2_tpu_torch.ops.experimental import dilated_conv as K5

torch.set_num_threads(1)
YO = 128


@pytest.fixture
def interpret(monkeypatch):
    from jax.experimental import pallas as pl
    orig = pl.pallas_call

    def interp_call(*args, **kwargs):
        kwargs["interpret"] = True
        return orig(*args, **kwargs)

    monkeypatch.setattr(pl, "pallas_call", interp_call)


def _inputs(seed, Z, X, cin, cout, d):
    rng = np.random.RandomState(seed)
    Y = P._round_up(YO + 2 * d, 128)
    xs = rng.rand(Z, X, cin, Y).astype(np.float32)
    ws = rng.rand(cout, cin, 3, 3, 3).astype(np.float32)
    return xs, ws


@pytest.mark.parametrize("Z, X, cin, cout, d", [
    (8, 8, 5, 7, 2),      # tests/test_pallas_experimental.py's case
    (12, 12, 5, 7, 4),    # the JAX module's __main__ correctness case
    (6, 6, 3, 5, 1),      # d 1
    (6, 6, 8, 8, 1),      # Cin 8, Cout 8: no pad rows
])
def test_matches_jax_kernel_interpret(interpret, Z, X, cin, cout, d):
    xs, ws = _inputs(Z * 10 + cin, Z, X, cin, cout, d)
    ref = np.asarray(P.dilated_conv_pallas(jnp.asarray(xs), jnp.asarray(ws),
                                           d, TY=128, Yo=YO))
    got = K5.dilated_conv(torch.from_numpy(xs), torch.from_numpy(ws), d,
                          Yo=YO).numpy()
    cp = K5.cout_pad(cout)
    assert got.shape == ref.shape == (Z - 2 * d, X - 2 * d, cp, YO)
    np.testing.assert_allclose(got, ref, atol=1e-4)
    assert (got[:, :, cout:] == 0).all() and (ref[:, :, cout:] == 0).all()


@pytest.mark.parametrize("cout, cp", [(1, 8), (7, 8), (8, 8), (45, 48)])
def test_output_pads_channels_to_eight(cout, cp):
    x = torch.rand(5, 6, 3, 9)
    y = K5.dilated_conv(x, torch.rand(cout, 3, 3, 3, 3), 1)
    assert tuple(y.shape) == (3, 4, cp, 7)        # Yo defaults to Y - 2d
    assert bool((y[:, :, cout:] == 0).all())


def test_over_padded_y_equals_exact_y():
    # the rows past Yo + 2d are never read
    x = torch.rand(6, 6, 2, 30)
    w = torch.rand(3, 2, 3, 3, 3)
    a = K5.dilated_conv(x, w, 2, Yo=10)
    b = K5.dilated_conv(x[..., :14].contiguous(), w, 2)
    assert torch.equal(a, b)


def test_cpu_runs_plain_version_without_launch():
    x, w = torch.rand(6, 6, 2, 12), torch.rand(3, 2, 3, 3, 3)
    before = K5.launches
    got = K5.dilated_conv(x, w, 1)
    assert K5.launches == before
    assert torch.equal(got, K5.dilated_conv_reference(x, w, 1))


@pytest.mark.parametrize("case, exc, match", [
    ("yo_long", ValueError, "Yo=11"),
    ("yo_zero", ValueError, "Yo=0"),
    ("too_small", ValueError, "too small"),
    ("dil", ValueError, "positive"),
    ("dtype", TypeError, "float32"),
    ("contiguous", ValueError, "contiguous"),
    ("xshape", ValueError, "x must be"),
    ("wshape", ValueError, "w must be"),
    ("device", ValueError, "is on"),
])
def test_invalid_args_raise(case, exc, match):
    x, w = torch.rand(6, 6, 2, 12), torch.rand(3, 2, 3, 3, 3)
    d, yo = 1, None
    if case == "yo_long":
        yo = 11                     # Y - 2d = 10
    elif case == "yo_zero":
        yo = 0
    elif case == "too_small":
        d = 3
    elif case == "dil":
        d = 0
    elif case == "dtype":
        x = x.double()
    elif case == "contiguous":
        x = x.transpose(0, 1)
    elif case == "xshape":
        x = x[None]
    elif case == "wshape":
        w = w[:, :1].contiguous()
    elif case == "device":
        w = w.to("meta")
    with pytest.raises(exc, match=match):
        K5.dilated_conv(x, w, d, yo)


def test_benchmark_raises_without_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="on the card only"):
        K5.main()
