"""``elektronn2-torch-predict``: dense prediction over a volume from the
command line, on the card.

Port of ``elektronn2_tpu/scripts/predict.py``, with the same arguments:
reads a saved model (the npz of ``Model.save``, from either package) and an
HDF5 volume or a KNOSSOS dataset, writes the dense prediction as HDF5 and
optionally as KNOSSOS datasets of uint8 maps, one per channel. A KNOSSOS
dataset is swept slab by slab (``Model.sweep_knossos``), an HDF5 volume goes
through ``Model.predict_dense``. ``--trace`` rolls out a tracing model from
seed positions instead (``DeviceTracer.trace_batch``) and writes a
``.k.zip``. Everything runs on the card unless ``--cpu`` is given.

``--bf16`` / ``--int8`` serve in reduced precision
(``Model.set_compute_dtype``; int8 calibrates its scales on the first slab
of a KNOSSOS sweep). ``--tune`` times the serving contenders on the device
before a KNOSSOS sweep (``Model.tune_serving``) and sweeps with the
fastest: a bare ``--tune`` keeps to float32 contenders, ``--tune --bf16``
or ``--tune --int8`` adds that lossy one; ``--step`` competes with the
default slab sizes, each clamped to the dataset. ``-o ''`` writes no HDF5
file (``--knossos-out`` then holds the maps; the module needs h5py only
for HDF5). ``--mesh`` (sharded serving) is not ported and raises
``NotImplementedError`` naming its ROADMAP.md item.

Usage: ``python -m elektronn2_tpu_torch.scripts.predict model.mdl
<knossos dir | in.h5[:dataset]> [--ptail] [--tune] [--bf16 | --int8]
[--knossos-out DIR] [-o out.h5]``.
"""

from __future__ import annotations

import argparse
import os

#: the flags whose features are not ported, with the ROADMAP.md item of each
NOT_PORTED = {
    "mesh": "sharded serving (ROADMAP.md §1 item 8b)",
}


def _ints(ap, flag, text, n):
    try:
        vals = [int(x) for x in text.split(",")]
    except ValueError:
        ap.error(f"{flag} {text!r}: expected comma-separated integers")
    if len(vals) != n:
        ap.error(f"{flag} {text!r}: expected {n} comma-separated integers")
    return vals


def _tune(model, ka, step, slab_batch, args):
    """``--tune``: the serving contenders timed over the default slab sizes
    and ``--step``, each clamped to the dataset, the winner applied; returns
    the (step, slab_batch) to sweep with. Lossy contenders only as the user
    asked for them: a bare ``--tune`` must not switch the output's
    numerics because bf16 or int8 ran faster."""
    from ..log import logger
    from ..neuromancer.inference import DEFAULT_TUNE_STEPS_3D
    rshape = [int(v) for v in ka.shape[-3:]]
    cand = []
    for c in ([tuple(step)] if step else []) + list(DEFAULT_TUNE_STEPS_3D):
        c = tuple(min(int(v), r) for v, r in zip(c, rshape))
        if c not in cand:
            cand.append(c)
    tuned = model.tune_serving(steps=cand, apply=True,
                               include_bf16=args.bf16,
                               include_int8=args.int8)
    best = tuned["best"]
    if best is None:
        logger.warning("--tune: no contender ran (a graph only the tiled "
                       "fallback serves); sweeping with the CLI settings")
        return step, slab_batch
    logger.info(f"--tune picked {best}")
    asked = "bfloat16" if args.bf16 else "int8" if args.int8 else None
    if asked and best["dtype"] != asked:
        logger.info(f"--tune overrode the requested {asked}: the measured "
                    f"winner runs {best['dtype'] or 'float32'}")
    return list(best["step"]), int(best["slab_batch"])


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="elektronn2-torch-predict",
        description="Dense (MFP/dilated) prediction over a volume")
    ap.add_argument("model", help="saved .mdl file")
    ap.add_argument("input", help="INPUT.h5[:dataset] or a KNOSSOS dir")
    ap.add_argument("-o", "--out", default="prediction.h5",
                    help="HDF5 output ('' for none)")
    ap.add_argument("--knossos-out", default=None,
                    help="also write a KNOSSOS dataset of uint8 maps")
    ap.add_argument("--mfp", action="store_true",
                    help="rebuild the model with MFP active")
    ap.add_argument("--patch", default=None,
                    help="comma-separated inference patch size override")
    ap.add_argument("--no-pad", action="store_true",
                    help="valid-only output (no reflect padding)")
    ap.add_argument("--uint8", action="store_true")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (default: the card)")
    ap.add_argument("--slab-batch", type=int, default=1,
                    help="KNOSSOS sweeps: slabs per forward (falls back "
                    "to per-slab sweeps when the card runs out of memory)")
    ap.add_argument("--step", default=None,
                    help="comma-separated KNOSSOS sweep slab size")
    ap.add_argument("--ptail", action="store_true",
                    help="route eligible (3,3,3) tail convs through the "
                    "tail-conv kernel K1 (set_dilated_impl(pallas_tail="
                    "True)), float32 grade")
    ap.add_argument("--convdense", default=None, metavar="KNOBS",
                    help="decoder (U-Net) graphs: conv-dense serving "
                    "lowerings as a comma list of 'd2s', 'zfold', 'ptail' "
                    "(set_convdense_impl; each computes the same function)")
    ap.add_argument("--trace", default=None, metavar="SEEDS",
                    help="tracing mode: roll out the tracing model from "
                    "seed positions 'z,x,y[;z,x,y...]' and write the "
                    "trajectories as a KNOSSOS skeleton (.k.zip) to --out")
    ap.add_argument("--trace-steps", type=int, default=256,
                    help="tracing mode: maximum rollout length per agent")
    ap.add_argument("--bf16", action="store_true",
                    help="bf16 serving (Conv operands in bf16)")
    ap.add_argument("--int8", action="store_true",
                    help="int8 quantised serving of the whole-volume paths")
    ap.add_argument("--tune", action="store_true",
                    help="KNOSSOS sweeps: autotune the serving "
                    "configuration on the device first (float32 contenders; "
                    "with --bf16 / --int8 that lossy one too)")
    ap.add_argument("--mesh", default=None, metavar="AXES",
                    help=f"not ported: {NOT_PORTED['mesh']}")
    args = ap.parse_args(argv)
    for flag in NOT_PORTED:
        if getattr(args, flag):
            raise NotImplementedError(
                f"--{flag}: {NOT_PORTED[flag]} is not ported to "
                "elektronn2_tpu_torch")

    import numpy as np
    from ..log import logger
    from ..neuromancer.model import modelload, rebuild_model
    from ..utils.basic import h5load, h5save
    from ..data.knossos_array import KnossosArray, save_knossos

    model = modelload(args.model, device="cpu" if args.cpu else "cuda")
    if args.mfp or args.patch:
        nsp = len(model.input_node.shape.spatial_axes)
        patch = _ints(ap, "--patch", args.patch, nsp) if args.patch else None
        model = rebuild_model(model, override_mfp_to_active=args.mfp,
                              imposed_patch_size=patch)
        logger.info(f"rebuilt for inference: patch="
                    f"{model.input_node.shape.spatial_shape}")
    if args.bf16 and args.int8:
        ap.error("--bf16 and --int8 are mutually exclusive")
    if args.bf16:
        model.set_compute_dtype("bfloat16")
    elif args.int8:
        model.set_compute_dtype("int8")
    if args.ptail:
        if args.bf16 or args.int8:
            ap.error("--ptail is a float32 mode (K1 serves float32 only); "
                     "drop --bf16/--int8")
        model.set_dilated_impl("direct", zfold=True, pallas_tail=True)
    if args.convdense:
        knobs = {k.strip() for k in args.convdense.split(",") if k.strip()}
        bad = knobs - {"d2s", "zfold", "ptail"}
        if bad:
            ap.error(f"--convdense: unknown knob(s) {sorted(bad)} "
                     "(expected 'd2s', 'zfold' and/or 'ptail')")
        if "ptail" in knobs and (args.bf16 or args.int8):
            ap.error("--convdense ptail is a float32 mode; drop "
                     "--bf16/--int8")
        model.set_convdense_impl(upconv="d2s" if "d2s" in knobs else "dilate",
                                 zfold="zfold" in knobs,
                                 ptail="ptail" in knobs)

    if args.trace:
        from ..data.tracing_utils import DeviceTracer
        try:
            seeds = np.asarray([[float(v) for v in s.split(",")]
                                for s in args.trace.split(";") if s.strip()],
                               np.float32)
            if seeds.ndim != 2 or seeds.shape[1] != 3:
                raise ValueError
        except ValueError:
            ap.error(f"--trace {args.trace!r}: expected "
                     "'z,x,y[;z,x,y...]' float seed positions")
        if os.path.isdir(args.input):
            ka = KnossosArray(args.input)
            vol = np.asarray(ka[tuple(slice(0, s) for s in ka.shape[-3:])])
        else:
            path, _, key = args.input.partition(":")
            vol = np.asarray(h5load(path, key or None))
        # the same normalisation as every dense-serving path
        if vol.dtype == np.uint8:
            vol = vol.astype(np.float32) / 255.0
        vol = vol.astype(np.float32, copy=False)
        if vol.ndim == 3:
            vol = vol[None]
        tracer = DeviceTracer(model, vol, max_steps=args.trace_steps)
        out_name = args.out
        if out_name.endswith(".h5"):        # the default --out is a dense name
            out_name = out_name[:-3] + ".k.zip"
        traces = tracer.trace_batch(seeds, save_kzip=out_name)
        logger.info(f"traced {len(traces)} agent(s) "
                    f"({[len(t) for t in traces]} nodes) -> {out_name}")
        return 0

    if not args.out and not args.knossos_out:
        ap.error("-o '' writes no HDF5 file: give --knossos-out")
    if os.path.isdir(args.input):
        ka = KnossosArray(args.input)
        step = _ints(ap, "--step", args.step, 3) if args.step else None
        slab_batch = args.slab_batch
        if args.tune:
            step, slab_batch = _tune(model, ka, step, slab_batch, args)
        out = model.sweep_knossos(ka, step=step, verbose=True,
                                  slab_batch=slab_batch)
    else:
        path, _, key = args.input.partition(":")
        out = model.predict_dense(np.asarray(h5load(path, key or None)),
                                  pad_raw=not args.no_pad,
                                  as_uint8=args.uint8, verbose=True)

    if args.out:
        h5save({"prediction": out}, args.out)
        logger.info(f"wrote {args.out} {out.shape} {out.dtype}")
    if args.knossos_out:
        u8 = (out if out.dtype == np.uint8
              else np.clip(out * 255.0, 0, 255).astype(np.uint8))
        for c in range(u8.shape[0]):
            save_knossos(u8[c], os.path.join(args.knossos_out, f"c{c}"),
                         exp_name=f"pred_c{c}")
    return 0


if __name__ == "__main__":
    import sys
    sys.exit(main())
