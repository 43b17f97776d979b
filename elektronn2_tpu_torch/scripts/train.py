"""``elektronn2-torch-train``: train a model from an experiment config file,
on the card.

Port of ``elektronn2_tpu/scripts/train.py`` (reference:
``scripts/elektronn2-train``), with the same arguments: exec the config
(``config.ExperimentConfig.from_file``, which reads the JAX package's
imports in the file as the port's, so the files under ``examples/`` run
unchanged), build the trainer (``trainer_class``, ``trainer_kwargs`` and
``data_instance`` as there) and ``run()`` it. Everything runs on the card
unless ``--cpu`` is given; without a card it raises.

``--profile LOGDIR`` records a ``torch.profiler`` trace (CPU and CUDA
activity) of the per-step or per-chunk calls 3 to 13 into
``LOGDIR/trace.json`` (Perfetto, ``chrome://tracing``); the trace is
stopped and written on exit also when the run is shorter.

Usage: ``python -m elektronn2_tpu_torch.scripts.train
examples/neuro3d.py [--cpu] [--n-steps N] [--save-path DIR]``.

Data-parallel training (a config with ``mesh_axes``, e.g.
``examples/neuro3d_pod.py``) over N processes: ``torchrun
--nproc_per_node=N -m elektronn2_tpu_torch.scripts.train cfg.py``; under
torchrun the process group is started first (``parallel.multihost.
initialize``: NCCL, one card a process; gloo with ``--cpu``), so the
config's device count is the group's.
"""

from __future__ import annotations

import argparse
import os


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="elektronn2-torch-train",
        description="Train a model from an exec'd Python experiment config")
    ap.add_argument("config", help="path to the experiment config file")
    ap.add_argument("--cpu", action="store_true",
                    help="train on the CPU (debugging)")
    ap.add_argument("--n-steps", type=int, default=None)
    ap.add_argument("--save-path", default=None)
    ap.add_argument("--profile", default=None, metavar="LOGDIR",
                    help="record a torch.profiler trace of steps ~3-13 into "
                         "LOGDIR/trace.json")
    args = ap.parse_args(argv)

    import torch

    from ..neuromancer.model import target_device
    from ..parallel import multihost

    device = target_device("cpu" if args.cpu else "cuda")
    if multihost.under_torchrun():
        multihost.initialize(device=device.type)
        if device.type == "cuda":
            device = torch.device("cuda", torch.cuda.current_device())
        try:
            return _run(args, device)
        finally:
            torch.distributed.destroy_process_group()
    return _run(args, device)


def _run(args, device):
    """Build the trainer from the config and run it (``--profile``: with a
    trace of a window of its calls)."""
    import torch

    from ..config import ExperimentConfig
    from ..log import logger
    from ..training import fused_loop
    from ..training.trainer import Trainer

    override = {}
    if args.n_steps is not None:
        override["n_steps"] = args.n_steps
    if args.save_path is not None:
        override["save_path"] = args.save_path
    exp = ExperimentConfig.from_file(args.config, override=override)
    logger.info(f"device: {device}"
                + (f" ({torch.cuda.get_device_name(device)})"
                   if device.type == "cuda" else ""))
    cfg = exp.as_dict()
    trainer_cls = Trainer
    if cfg.get("trainer_class"):
        from .. import training as tmod
        trainer_cls = getattr(tmod, cfg.pop("trainer_class"))
    tkwargs = dict(cfg.pop("trainer_kwargs", {}) or {})
    data = cfg.pop("data_instance", None)
    trainer = trainer_cls(None, data=data, device=device, **cfg, **tkwargs)
    if not args.profile:
        trainer.run()
        return 0

    # trace a window after the warm-up; counts both per-step and chunk
    # calls, so fused_steps configs are covered, and always stops the
    # trace on exit (a run shorter than the window still writes one)
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    state = {"n": 0, "prof": None}
    out = os.path.join(args.profile, "trace.json")

    def stop():
        prof, state["prof"] = state["prof"], None
        if prof is not None:
            prof.stop()
            os.makedirs(args.profile, exist_ok=True)
            prof.export_chrome_trace(out)
            logger.info(f"profiler trace written to {out}")

    def wrap(obj, attr):
        orig = getattr(obj, attr)

        def traced(*a, **kw):
            state["n"] += 1
            if state["n"] == 3 and state["prof"] is None:
                state["prof"] = profile(activities=acts)
                state["prof"].start()
            res = orig(*a, **kw)
            if state["n"] == 13:
                stop()
            return res

        setattr(obj, attr, traced)

    wrap(trainer.model, "trainingstep")
    saved = {cls: cls.run_chunk for cls in (fused_loop.FusedTrainLoop,
                                            fused_loop.HostFedFusedLoop)}
    for cls in saved:
        wrap(cls, "run_chunk")
    try:
        trainer.run()
    finally:
        stop()
        for cls, fn in saved.items():
            cls.run_chunk = fn
    return 0


if __name__ == "__main__":
    main()
