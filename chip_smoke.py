#!/usr/bin/env python3
"""On-card smoke run of the PyTorch port (``elektronn2_tpu_torch``).

Drives the port's main path once, dense MFP inference of the flagship
neuro3d-class net at full widths (20/30/40/40 channels) with the tail-conv
kernel K1 (``elektronn2_tpu_torch/csrc/tailconv.cu``), and checks it:

1. device: the card's name, capability, ``nvidia-smi`` name and power limit,
   and the float32 flags (cuDNN TF32 off, checked against float64);
2. build: K1 is compiled with ``nvcc`` from the checkout's sources;
3. kernel: K1 against its plain PyTorch version at the main path's conv2 and
   conv3 shapes and at ragged shapes (``assert_close`` rtol=atol=1e-4: float32
   sums of up to 1080 products, taken in another order), both timed with
   CUDA events;
4. slice: the MFP route (``predict`` + ``fragments2dense``) against
   ``predict_dense_device`` on a patch-sized volume (atol 1e-5), then three
   requests of distinct random 120x496x496 volumes through
   ``predict_dense_device(vol, pad_raw=True)``: shape, finite values, channel
   sums of 1 (within 1e-5), two K1 launches per request, and one request
   against the plain cuDNN route (``pallas_tail=False``, atol 1e-5).

Each phase prints one JSON line; then the kernels line, the ``nvidia-smi``
line, and last ``{"ok": true, "device": {...}}``. Any failure raises and the
exit code is not 0. Without a CUDA device it exits non-zero before any
result. Usage, from the repository root: ``python3 chip_smoke.py``.
"""

import json
import subprocess
import sys
import time

import numpy as np
import torch

from elektronn2_tpu_torch.ops import tailconv
from elektronn2_tpu_torch.ops.conv import f32_convs
from elektronn2_tpu_torch.ops.mfp import fragments2dense
from elektronn2_tpu_torch.utils.convert import flagship_model

SEED = 0
REQ_SHAPE = (1, 120, 496, 496)          # (f, Z, X, Y) of one request
N_REQUESTS = 3
KERNEL_TOL = dict(rtol=1e-4, atol=1e-4)
SLICE_ATOL = 1e-5


def emit(phase, **fields):
    print(json.dumps({"phase": phase, **fields}), flush=True)


def nvidia_smi_line():
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    return res.stdout.strip().splitlines()[0]


def time_ms(fn, n=3):
    """Mean device time of ``fn`` over ``n`` launches (CUDA events)."""
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(n):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / n


def phase_device():
    smi = nvidia_smi_line()
    x = torch.rand(1, 8, 6, 40, 40, device="cuda") - 0.5
    w = torch.rand(8, 8, 3, 3, 3, device="cuda") - 0.5
    with f32_convs():
        y = torch.nn.functional.conv3d(x, w, dilation=(1, 2, 2))
        flags = {"cudnn.allow_tf32": torch.backends.cudnn.allow_tf32,
                 "cudnn.conv.fp32_precision": getattr(
                     getattr(torch.backends.cudnn, "conv", None),
                     "fp32_precision", None)}
    y64 = torch.nn.functional.conv3d(x.double(), w.double(),
                                     dilation=(1, 2, 2))
    f32_err = (y.double() - y64).abs().max().item()
    emit("device", name=torch.cuda.get_device_name(0),
         capability=list(torch.cuda.get_device_capability(0)),
         count=torch.cuda.device_count(), nvidia_smi=smi,
         torch=torch.__version__, cuda=torch.version.cuda,
         f32_flags=flags, cudnn_vs_f64_max_abs=f32_err)
    # TF32 keeps ~3 decimal digits: its error here would be ~1e-3
    if f32_err > 1e-5:
        raise AssertionError(f"cuDNN conv is not full float32: {f32_err}")
    return smi


def phase_build():
    t0 = time.perf_counter()
    lib = tailconv.build()
    ptxas = [ln.strip() for ln in lib.build_log.splitlines()
             if "registers" in ln or "spill" in ln]
    emit("build", kernel="conv3x3_dilated", library=lib.path,
         nvcc_seconds=lib.build_seconds,
         seconds=time.perf_counter() - t0, ptxas=ptxas)


def phase_kernel():
    """K1 against its plain version; returns (max_abs_err, ms, plain_ms)
    with the times summed over the main path's conv2 + conv3 shapes."""
    g = torch.Generator(device="cuda").manual_seed(SEED)
    cases = [  # name, N, Cin, Cout, (Z, X, Y), dil
        ("conv2", 1, 30, 40, (124, 512, 512), (1, 4, 4)),
        ("conv3", 1, 40, 40, (122, 504, 504), (1, 4, 4)),
        ("ragged_d1", 2, 3, 5, (6, 14, 20), (1, 1, 1)),
        ("ragged_d23", 2, 3, 5, (5, 20, 30), (1, 2, 3)),
        ("ragged_cout45", 1, 30, 45, (5, 40, 300), (1, 4, 4)),
    ]
    max_err, ms_sum, plain_sum = 0.0, 0.0, 0.0
    for name, N, cin, cout, sp, dil in cases:
        x = torch.rand((N, cin) + sp, device="cuda", generator=g) - 0.5
        w = (torch.rand(cout, cin, 3, 3, 3, device="cuda", generator=g)
             - 0.5) * (2.0 / (27 * cin)) ** 0.5
        b = torch.rand(cout, device="cuda", generator=g) * 0.2 - 0.1
        got = tailconv.conv3x3_dilated(x, w, b, dil)
        ref = tailconv.conv3x3_dilated_reference(x, w, b, dil)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, ref, **KERNEL_TOL)
        err = (got - ref).abs().max().item()
        max_err = max(max_err, err)
        del got, ref
        rec = dict(case=name, x=[N, cin, *sp], cout=cout, dil=list(dil),
                   max_abs_err=err)
        if name in ("conv2", "conv3"):
            kern = lambda: tailconv.conv3x3_dilated(x, w, b, dil)  # noqa: E731
            plain = lambda: tailconv.conv3x3_dilated_reference(  # noqa: E731
                x, w, b, dil)
            # in turns: plain, kernel, kernel, plain
            t = [time_ms(plain), time_ms(kern), time_ms(kern), time_ms(plain)]
            ms, pms = (t[1] + t[2]) / 2, (t[0] + t[3]) / 2
            zo, xo, yo = sp[0] - 2, sp[1] - 2 * dil[1], sp[2] - 2 * dil[2]
            flop = 2.0 * N * cout * cin * 27 * zo * xo * yo
            rec.update(ms=ms, plain_ms=pms, kernel_tflop_s=flop / ms / 1e9,
                       plain_tflop_s=flop / pms / 1e9)
            ms_sum += ms
            plain_sum += pms
        emit("kernel", **rec)
        del x, w, b
    torch.cuda.empty_cache()
    return max_err, ms_sum, plain_sum


def seeded_params(model, rng):
    """Random weights from a numpy seed: He-normal conv weights, small
    uniform biases."""
    params = {}
    for nname, d in model.params.items():
        w = d["w"]
        fan_in = int(np.prod(w.shape[1:]))
        params[nname] = {
            "w": rng.standard_normal(tuple(w.shape)) * np.sqrt(2.0 / fan_in),
            "b": rng.uniform(-0.1, 0.1, size=tuple(d["b"].shape))}
    return params


def check_probs(out, shape):
    if tuple(out.shape) != shape:
        raise AssertionError(f"output shape {tuple(out.shape)} != {shape}")
    if not bool(torch.isfinite(out).all()):
        raise AssertionError("non-finite output")
    dev = (out.sum(0) - 1.0).abs().max().item()
    if dev > 1e-5:
        raise AssertionError(f"channel sums deviate from 1 by {dev}")
    return dev


def phase_slice():
    """The flagship's dense MFP path; returns the K1 launch count of the
    three requests."""
    rng = np.random.RandomState(SEED)
    model = flagship_model(mfp=True, patch=[23, 103, 103])
    model.set_params(seeded_params(model, rng))
    model.to("cuda")
    model.set_dilated_impl("direct", zfold=True, pallas_tail=True)

    # MFP route (fragments + restitch, cuDNN convs) vs the dilated path (K1)
    patch = tuple(model.input_node.shape.spatial_shape)
    vol = torch.from_numpy(rng.rand(1, *patch).astype(np.float32)).cuda()
    frag = model.predict(vol[None])
    mfp = fragments2dense(frag, model.prediction_node.shape.mfp_offsets)[0]
    dense = model.predict_dense_device(vol, pad_raw=False)
    torch.cuda.synchronize()
    if tuple(mfp.shape) != tuple(dense.shape):
        raise AssertionError(f"MFP {tuple(mfp.shape)} vs dense "
                             f"{tuple(dense.shape)}")
    mfp_err = (mfp - dense).abs().max().item()
    emit("slice_mfp_vs_dense", patch=list(patch), out=list(dense.shape),
         max_abs_err=mfp_err)
    if mfp_err > SLICE_ATOL:
        raise AssertionError(f"MFP vs dense: {mfp_err} > {SLICE_ATOL}")
    del vol, frag, mfp, dense

    # three distinct requests, made on the host from the seed, staged first
    vols = [torch.from_numpy(rng.rand(*REQ_SHAPE).astype(np.float32)).cuda()
            for _ in range(N_REQUESTS)]
    warm = torch.from_numpy(rng.rand(*REQ_SHAPE).astype(np.float32)).cuda()
    out_shape = (2,) + REQ_SHAPE[1:]
    check_probs(model.predict_dense_device(warm, pad_raw=True), out_shape)
    del warm
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    mvox = np.prod(REQ_SHAPE[1:]) / 1e6

    tailconv.launches = 0
    first = None
    for i, v in enumerate(vols):
        before = tailconv.launches
        t0 = time.perf_counter()
        out = model.predict_dense_device(v, pad_raw=True)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        n = tailconv.launches - before
        dev = check_probs(out, out_shape)
        if n != 2:
            raise AssertionError(f"request {i}: {n} K1 launches, expected 2")
        emit("slice_request", request=i, seconds=dt, mvox_s=mvox / dt,
             k1_launches=n, channel_sum_dev=dev, out=list(out.shape),
             peak_gib=torch.cuda.max_memory_allocated() / 2**30)
        if first is None:
            first = out
    launches = tailconv.launches

    # the same request through the plain cuDNN route
    model.set_dilated_impl("direct", zfold=True, pallas_tail=False)
    t0 = time.perf_counter()
    plain = model.predict_dense_device(vols[0], pad_raw=True)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    err = (first - plain).abs().max().item()
    emit("slice_vs_plain_route", request=0, max_abs_err=err,
         plain_seconds=dt, plain_mvox_s=mvox / dt,
         k1_launches=tailconv.launches - launches)
    if err > SLICE_ATOL:
        raise AssertionError(f"K1 route vs cuDNN route: {err} > {SLICE_ATOL}")
    if tailconv.launches != launches:
        raise AssertionError("the plain route launched K1")
    return launches


def main():
    if not torch.cuda.is_available():
        sys.exit("chip_smoke.py: no CUDA device (torch.cuda.is_available() "
                 "is false); this script runs only on the card")
    smi = phase_device()
    phase_build()
    max_err, ms, plain_ms = phase_kernel()
    launches = phase_slice()
    print(json.dumps({"kernels": [{
        "name": "conv3x3_dilated", "route": "cuda",
        "source": "elektronn2_tpu_torch/csrc/tailconv.cu",
        "replaces": "elektronn2_tpu/ops/pallas_tailconv.py:318",
        "launches": launches, "max_abs_err": max_err,
        "ms": ms, "plain_ms": plain_ms}]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
