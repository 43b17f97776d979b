"""``elektronn2-torch-profile``: a size sweep of a saved model on the card.

Port of ``elektronn2_tpu/scripts/profile.py`` (reference:
``scripts/elektronn2-profile``): rebuilds the model at each input size
(snapped to the nearest valid patch of its Conv chain), times ``predict``
and, for a model with a loss and a target, ``trainingstep``, and writes a
CSV with the JAX package's columns (``size``, ``predict_s``,
``pred_Mvox_s``, ``trainingstep_s``). Times are seconds a call on the host
clock, closed by a synchronize of the card (``utils.profiling.benchmark``:
two warm-up calls, five timed). Everything runs on the card unless
``--cpu`` is given.

Usage: ``python -m elektronn2_tpu_torch.scripts.profile model.mdl
[--sizes 32,48,64] [--out profile.csv] [--cpu]``.
"""

from __future__ import annotations

import argparse
import csv
import time


def _synchronize(out):
    """Wait for the card when any tensor in ``out`` (a tensor, or a tuple,
    list or dict of them) lies on it."""
    import torch
    leaves = out.values() if isinstance(out, dict) else (
        out if isinstance(out, (tuple, list)) else (out,))
    if any(isinstance(t, torch.Tensor) and t.is_cuda for t in leaves):
        torch.cuda.synchronize()


def time_fn(fn, n_warmup=2, n_runs=5):
    """Mean seconds of ``fn()`` over ``n_runs`` calls on the host clock,
    after ``n_warmup`` calls, as the JAX package's ``time_fn``: where it
    blocks on ``fn``'s output, this synchronizes the card when the output
    lies there."""
    for _ in range(n_warmup):
        _synchronize(fn())
    t0 = time.perf_counter()
    out = None
    for _ in range(n_runs):
        out = fn()
    _synchronize(out)
    return (time.perf_counter() - t0) / n_runs


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="elektronn2-torch-profile",
        description="Sweep patch sizes, timing trainingstep and predict")
    ap.add_argument("model", help="saved .mdl file")
    ap.add_argument("--sizes", default="32,48,64,96,128",
                    help="comma-separated spatial sizes to sweep")
    ap.add_argument("--out", default="profile.csv")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (default: the card)")
    args = ap.parse_args(argv)

    import numpy as np
    import torch
    from ..log import logger
    from ..neuromancer import neural
    from ..neuromancer.model import modelload, rebuild_model
    from ..utils.cnncalculator import get_cloesest_valid_patch_size
    from ..utils.profiling import benchmark, enable_compile_cache

    enable_compile_cache()
    base = modelload(args.model, device="cpu" if args.cpu else "cuda")
    dev = base.device
    nsp = len(base.input_node.shape.spatial_axes)

    def snap_valid(size):
        """The cnncalculator-valid input nearest ``size`` per spatial dim
        for the model's Conv chain, or the raw size for an irregular one."""
        try:
            convs = [n for n in base.nodes.values()
                     if isinstance(n, neural.Conv)]
            return [int(get_cloesest_valid_patch_size(
                [c.filter_shape[d] for c in convs],
                [c.pool_shape[d] for c in convs], size,
                mfp=any(c.mfp for c in convs), ndim=1))
                for d in range(nsp)]
        except Exception:    # noqa: BLE001 — an irregular chain: raw size
            return [size] * nsp

    rng = np.random.RandomState(0)
    rows = []
    for size in [int(s) for s in args.sizes.split(",")]:
        patch = snap_valid(size)
        if patch != [size] * nsp:
            logger.info(f"size {size}: snapped to valid patch {patch}")
        try:
            model = rebuild_model(base, imposed_patch_size=patch)
        except ValueError as e:
            logger.warning(f"size {size}: rebuild failed ({e})")
            continue
        raw = torch.from_numpy(rng.rand(*tuple(model.input_node.shape))
                               .astype(np.float32)).to(dev)
        t_pred = benchmark(model.predict, raw, n_runs=5)
        pred = model.prediction_node.shape
        mvox = np.prod(pred.spatial_shape) * pred["b"] / t_pred / 1e6
        row = {"size": size, "predict_s": t_pred, "pred_Mvox_s": mvox}
        if model.target_node is not None and model.loss_node is not None:
            tgt = torch.from_numpy(rng.randint(
                0, 2, tuple(model.target_node.shape)).astype(np.int32)).to(dev)
            if model.optimiser is None:
                model.set_opt("SGD", lr=0.0, mom=0.0)
            row["trainingstep_s"] = benchmark(model.trainingstep, raw, tgt,
                                              n_runs=5)
        rows.append(row)
        logger.info(f"size {size}: predict {t_pred * 1e3:.1f} ms "
                    f"({mvox:.1f} Mvox/s)"
                    + (f", train {row['trainingstep_s'] * 1e3:.1f} ms"
                       if "trainingstep_s" in row else ""))
    if not rows:
        raise SystemExit(
            "no size in the sweep produced a measurable model (all "
            "rebuilds failed: sizes below the minimum valid patch?); "
            f"not writing {args.out}")
    with open(args.out, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=list(rows[0].keys()))
        w.writeheader()
        w.writerows(rows)
    logger.info(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    import sys
    sys.exit(main())
