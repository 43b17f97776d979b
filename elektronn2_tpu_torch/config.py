"""Two-tier configuration: machine rc file + exec'd experiment file.

Port of ``elektronn2_tpu/config.py`` (reference: ``elektronn2/config.py``):
a machine config (``~/.elektronn2_tpurc`` or ``~/.elektronn2rc``: save
root, plotting, UI) plus a per-experiment exec'd Python file defining plain
variables and ``create_model()``. ``Config.device`` defaults to ``"cuda"``:
the Trainer runs on the card unless it is asked for the CPU.

The example configs import the JAX package inside their functions
(``import elektronn2_tpu.neuromancer as nm`` in ``create_model``), and
reference-style configs import ``elektronn2.*``. So
:meth:`ExperimentConfig.from_file` execs a file with builtins of its own
whose ``__import__`` maps the top-level names ``elektronn2_tpu`` and
``elektronn2`` to ``elektronn2_tpu_torch``; the functions the file defines
keep those globals, so their imports resolve to the port too. A config's
``import jax`` (``examples/neuro3d_pod.py`` counts its devices that way)
gets :data:`JAX_STAND_IN`, whose ``devices()`` and ``device_count()`` list
the port's devices; any other name taken from it raises ``ImportError``.
``sys.modules`` is not touched: both packages can live in one process.
"""

from __future__ import annotations

import builtins
import os
import types

from .log import logger

RC_PATHS = (os.path.expanduser("~/.elektronn2_tpurc"),
            os.path.expanduser("~/.elektronn2rc"))

_PORT_PKG = "elektronn2_tpu_torch"
#: top-level packages a config may import, read as the port
_MAPPED = ("elektronn2_tpu", "elektronn2")


class Config:
    """Machine-level configuration (rc file + environment overrides)."""

    def __init__(self):
        self.save_path = os.path.expanduser("~/elektronn2_training/")
        self.plot_on = True
        self.print_status = True
        self.device = "cuda"        # the Trainer's device; "cpu" on request
        self.batch_size_override = None
        self.use_ui = True
        for p in RC_PATHS:
            if os.path.exists(p):
                # ONE namespace for globals and locals: separate dicts
                # break rc-file helper functions and comprehensions that
                # reference other rc-level names
                ns = {}
                with open(p) as f:
                    exec(compile(f.read(), p, "exec"), ns)
                for k, v in ns.items():
                    if not k.startswith("_") and k != "__builtins__":
                        setattr(self, k, v)
                logger.debug(f"loaded machine config from {p}")
                break
        if os.environ.get("ELEKTRONN2_SAVE_PATH"):
            self.save_path = os.environ["ELEKTRONN2_SAVE_PATH"]


config = Config()

#: experiment-config variables recognised by the Trainer (reference names)
EXPERIMENT_KEYS = (
    "save_path", "save_name", "batch_size", "n_steps", "max_runtime",
    "history_freq", "preview_freq", "save_freq", "monitor_batch_size",
    "data_class", "data_init_kwargs", "data_batch_args", "preview_data",
    "preview_data_path", "preview_kwargs", "optimiser", "optimiser_params",
    "schedules", "model_load_path", "n_workers", "dr",
    "trainer_class", "trainer_kwargs", "data_instance",
    "fused_steps", "resume", "tensorboard", "seed", "worker_mode",
    "mesh_axes",
)


_STAND_IN_ONLY = ("a config exec'd by elektronn2_tpu_torch's loader "
                  "(config.ExperimentConfig.from_file) gets a stand-in for "
                  "jax with devices() and device_count() only")


class _JaxStandIn(types.ModuleType):
    """What a config's ``import jax`` gets: ``devices()`` and
    ``device_count()`` over the port's devices, nothing else."""

    def devices(self):
        """The process group's ranks when one is up (one device each),
        else the visible cards, else the CPU."""
        import torch
        import torch.distributed as dist
        kind = "cuda" if torch.cuda.is_available() else "cpu"
        if dist.is_available() and dist.is_initialized():
            n = dist.get_world_size()
        else:
            n = torch.cuda.device_count() if kind == "cuda" else 1
        return [torch.device(kind, i) for i in range(n)]

    def device_count(self):
        return len(self.devices())

    def __getattr__(self, name):
        raise ImportError(f"jax.{name}: {_STAND_IN_ONLY}")


JAX_STAND_IN = _JaxStandIn("jax")


def _port_import(name, globals=None, locals=None, fromlist=(), level=0):
    """``__import__`` that reads an absolute import of the JAX package or
    of the reference's ``elektronn2`` as one of the port, and ``jax`` as
    :data:`JAX_STAND_IN`."""
    if level == 0:
        if name == "jax":
            return JAX_STAND_IN
        if name.startswith("jax."):
            raise ImportError(f"{name}: {_STAND_IN_ONLY}")
        for pkg in _MAPPED:
            if name == pkg or name.startswith(pkg + "."):
                name = _PORT_PKG + name[len(pkg):]
                break
    return builtins.__import__(name, globals, locals, fromlist, level)


class ExperimentConfig:
    """An exec'd experiment file: plain variables + ``create_model()``.

    Reference: the config files under ``examples/`` (e.g. neuro3d.py).
    """

    def __init__(self, namespace, source_path=None):
        self._ns = dict(namespace)
        self.source_path = source_path
        if "save_name" not in self._ns and source_path:
            base = os.path.splitext(os.path.basename(source_path))[0]
            self._ns["save_name"] = base
        if "save_path" not in self._ns:
            self._ns["save_path"] = os.path.join(
                config.save_path, self._ns.get("save_name", "experiment"))

    @classmethod
    def from_file(cls, path, override=None):
        path = os.path.expanduser(path)
        own = dict(vars(builtins))          # the file's builtins: its
        own["__import__"] = _port_import    # imports read as the port's
        ns = {"__file__": os.path.abspath(path), "__builtins__": own}
        with open(path) as f:
            code = compile(f.read(), path, "exec")
        exec(code, ns)
        ns = {k: v for k, v in ns.items() if not k.startswith("__")}
        if override:
            ns.update(override)
        return cls(ns, source_path=path)

    def as_dict(self):
        d = {k: v for k, v in self._ns.items()
             if k in EXPERIMENT_KEYS or k == "create_model"}
        # preview_data_path → loaded preview volume
        ppath = self._ns.get("preview_data_path")
        if ppath and "preview_data" not in d:
            from .utils.basic import h5load
            try:
                d["preview_data"] = h5load(ppath)
            except Exception as e:
                logger.warning(f"could not load preview data {ppath}: {e}")
        return d

    def __getattr__(self, k):
        try:
            return self._ns[k]
        except KeyError:
            raise AttributeError(k) from None
