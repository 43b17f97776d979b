"""Probe: the head-unit kernel K4 (``pool=1``) against the zfold cuDNN conv
+ bias + ReLU at the kz=1 layers of the conv-dense U-Net path.

Port of ``scripts/exp_convdense_headk.py``: its three cases (the decoder
layer ``dec`` 24->16 of ``examples/unet3d.py`` at 96 and 128 x 512 x 512,
its first layer ``enc0`` 1->12 at 96 x 512 x 512), plus the kz=1 layers of
``examples/unet3d_wide.py`` at the shapes of one 128x448x448 slab
(``pad_raw``): e0a 1->64 on the padded input and d0 128->64 on the skip
merge m0. K4 writes NCDHW, as the conv-dense path consumes it, so the
comparison needs no transpose. Each row gives both device times (CUDA
events, in turns: zfold, K4, K4, zfold), the K4 body the wrapper ran
(``tailconv.head_body``), K4's bound on an H100 (the larger of its bytes at
3.35 TB/s and three times its FLOPs at 495 TFLOP/s TF32, the float32-grade
rate of 3xTF32, whichever body runs) and the largest difference (tolerance
1e-4: sums of up to 9*Cin products in another order).

Usage, on the card: ``python -m elektronn2_tpu_torch.scripts.exp_convdense_headk``
(prints one JSON line per case); :func:`main` returns the rows.
"""

from __future__ import annotations

import json
import math

import torch

from ..ops.conv import conv_zfold2d, f32_convs
from ..ops.tailconv import conv1x3x3_pool_dilated, head_body
from ..utils.device_timing import TF32_FLOP_S, bound_ms, time_ms

TOL = 1e-4


def wide_slab_cases(slab=(128, 448, 448)):
    """The wide U-Net's kz=1 layers at one slab: (name, Cin, Cout, (Z, X,
    Y) of the layer's input) for e0a and d0."""
    from ..neuromancer.inference import conv_dense_extent, conv_dense_shapes
    from ..utils.convert import wide_unet_model
    m = wide_unet_model(device="cpu")
    N, _, _ = conv_dense_extent(m, list(slab), pad_raw=True)
    shapes = conv_dense_shapes(m.prediction_node, N)
    w0 = m.nodes["e0a"].n_f
    return [("wide-e0a 1->64", 1, w0, tuple(N)),
            ("wide-d0 128->64", m.nodes["m0"].shape["f"], w0,
             tuple(shapes["m0"]))]


def cases():
    """The JAX probe's three cases, then the wide U-Net's two."""
    return [("dec-96x512 24->16", 24, 16, (96, 512, 512)),
            ("dec-128x512 24->16", 24, 16, (128, 512, 512)),
            ("enc0-96x512 1->12", 1, 12, (96, 512, 512))] + wide_slab_cases()


def head_bound_ms(cin, cout, sp, d=1, pool=1):
    """(least ms on an H100, 'bytes' or 'operations (3xTF32)') for one
    head unit on (1, cin, *sp): the larger of its bytes (input read once,
    output written once) over the memory rate and three times its FLOPs
    (three TF32 products per multiply-add) over the TF32 tensor-core
    rate."""
    z, x, y = sp
    dp = d * (pool - 1)
    out = z * (x - 2 * d - dp) * (y - 2 * d - dp)
    conv_out = z * (x - 2 * d) * (y - 2 * d)
    flop = 2.0 * 9 * cin * cout * conv_out
    nbytes = 4.0 * (cin * math.prod(sp) + cout * out + cout * (9 * cin + 1))
    bound, by = bound_ms(nbytes, 3 * flop, TF32_FLOP_S)
    return bound, by if by == "bytes" else "operations (3xTF32)"


def main(case_list=None, k=3, seed=0):
    """Run the probe on the card; returns one dict per case. Without a
    CUDA device it raises: the probe measures the card only."""
    if not torch.cuda.is_available():
        raise RuntimeError("exp_convdense_headk runs on the card only "
                           "(torch.cuda.is_available() is false)")
    g = torch.Generator(device="cuda").manual_seed(seed)
    rows = []
    for name, ci, co, sp in case_list or cases():
        x = torch.randn((1, ci) + tuple(sp), device="cuda", generator=g)
        w = torch.randn(co, ci, 1, 3, 3, device="cuda", generator=g) * 0.1
        b = torch.randn(co, device="cuda", generator=g)

        def zfold():
            with f32_convs():
                return torch.relu(conv_zfold2d(x, w, b))

        def headk():
            return conv1x3x3_pool_dilated(x, w, b, (1, 1), pool=1)

        y0, y1 = zfold(), headk()
        torch.cuda.synchronize()
        err = (y0 - y1).abs().max().item()
        if not err <= TOL:
            raise AssertionError(f"{name}: K4 vs zfold differ by {err}")
        del y0, y1
        t = [time_ms(zfold, k), time_ms(headk, k), time_ms(headk, k),
             time_ms(zfold, k)]
        zms, hms = (t[0] + t[3]) / 2, (t[1] + t[2]) / 2
        bound, by = head_bound_ms(ci, co, sp)
        rows.append(dict(case=name, x=[1, ci, *sp], cout=co,
                         body=head_body(ci, co, 1), zfold_ms=zms, headk_ms=hms,
                         speedup=zms / hms, bound_ms=bound, bound_by=by,
                         max_abs_err=err))
        del x, w, b
        torch.cuda.empty_cache()
    return rows


if __name__ == "__main__":
    for row in main():
        print(json.dumps(row), flush=True)
