"""Graph manager — records node construction so models are replayable.

Port of ``elektronn2_tpu/neuromancer/graphmanager.py``. The node spec is the
same JSON (format ``elektronn2_tpu/v1``) and the same arg encoding, so a
``.mdl`` file written by the JAX package's ``Model.save`` replays here into
port nodes of the same class names, and one written here loads there.
Parameter init draws from a ``torch.Generator`` seeded by
``model_manager.reset(seed=...)``; it gives other numbers than the JAX
package's numpy stream, so comparisons between the two load weights.
"""

from __future__ import annotations

import json

import numpy as np
import torch

# registry of node classes by name, filled by node modules on import
NODE_CLASSES = {}


def register_node_class(cls):
    """Class decorator: make a Node subclass replayable by name."""
    NODE_CLASSES[cls.__name__] = cls
    return cls


def _encode_arg(a, arrays, prefix):
    """JSON-encode one constructor arg; Nodes become references, arrays go
    to the side-car ``arrays`` dict."""
    from .node_basic import Node
    if isinstance(a, Node):
        return {"__node__": a.name}
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().numpy()
    if isinstance(a, np.ndarray):
        key = f"{prefix}/a{len(arrays)}"
        arrays[key] = a
        return {"__array__": key}
    if isinstance(a, (list, tuple)):
        enc = [_encode_arg(x, arrays, prefix) for x in a]
        return {"__tuple__": enc} if isinstance(a, tuple) else enc
    if isinstance(a, dict):
        return {k: _encode_arg(v, arrays, prefix) for k, v in a.items()}
    if isinstance(a, (np.integer,)):
        return int(a)
    if isinstance(a, (np.floating,)):
        return float(a)
    if a is None or isinstance(a, (bool, int, float, str)):
        return a
    raise TypeError(
        f"constructor arg of type {type(a).__name__} is not serialisable; "
        "use plain Python values / numpy arrays / Nodes in node specs")


def _decode_arg(a, arrays, nodes):
    if isinstance(a, dict):
        if "__node__" in a:
            return nodes[a["__node__"]]
        if "__array__" in a:
            return arrays[a["__array__"]]
        if "__tuple__" in a:
            return tuple(_decode_arg(x, arrays, nodes) for x in a["__tuple__"])
        return {k: _decode_arg(v, arrays, nodes) for k, v in a.items()}
    if isinstance(a, list):
        return [_decode_arg(x, arrays, nodes) for x in a]
    return a


class GraphManager:
    """Collects constructed nodes; source of truth for name→node lookup,
    replayable node descriptors, and model assembly."""

    def __init__(self, name="graph"):
        self.name = name
        self.nodes = {}          # name -> Node, in construction order
        self._name_counters = {}
        self._rng = torch.Generator().manual_seed(0)
        self.designations = {}
        self._models = []        # weak references to the Models built here

    # -- construction-time services ----------------------------------------
    def reset(self, seed=0):
        self.nodes.clear()
        self._name_counters.clear()
        self.designations = {}
        self._rng = torch.Generator().manual_seed(int(seed))
        self._models = []

    def register_model(self, model):
        import weakref
        self._models.append(weakref.ref(model))

    def last_model(self, node_name=None):
        """The most recently built Model of this graph that is still alive
        (and, with ``node_name``, that held that node when it was built),
        or None. ``Node.predict_dense`` serves through it. Reference:
        ``GraphManager.last_model``."""
        for ref in reversed(self._models):
            m = ref()
            if m is not None and (node_name is None
                                  or node_name in m._node_names):
                return m
        return None

    def unique_name(self, name):
        if name not in self.nodes and name not in self._name_counters:
            self._name_counters[name] = 0
            return name
        # the counter-suffixed candidate can collide with an explicitly
        # named node: advance until actually free
        c = self._name_counters.get(name, 0)
        while True:
            c += 1
            cand = f"{name}{c}"
            if cand not in self.nodes:
                self._name_counters[name] = c
                return cand

    def register(self, node):
        if node.name in self.nodes:
            raise ValueError(f"duplicate node name {node.name!r}")
        self.nodes[node.name] = node

    def init_rng(self):
        """``torch.Generator`` for eager parameter init (deterministic per
        graph: seeded by :meth:`reset`)."""
        return self._rng

    @property
    def sinks(self):
        """Nodes nobody consumes (graph outputs), in registration order."""
        return [n for n in self.nodes.values() if not n.children]

    def getmodel(self, name=None):
        from .model import Model
        return Model(self, name=name or self.name)

    # -- serialisation -------------------------------------------------------
    def get_descriptors(self):
        """Replayable spec: list of {name, cls, args, kwargs} + arg arrays."""
        descriptors, arrays = [], {}
        for node in self.nodes.values():
            if node._init_args is None:
                raise TypeError(
                    f"node {node.name!r} ({type(node).__name__}) was not "
                    "constructed through its public constructor and cannot "
                    "be serialised")
            args, kwargs = node._init_args
            prefix = f"__spec__/{node.name}"
            descriptors.append({
                "name": node.name,
                "cls": type(node).__name__,
                "args": [_encode_arg(a, arrays, prefix) for a in args],
                "kwargs": {k: _encode_arg(v, arrays, prefix)
                           for k, v in kwargs.items()},
            })
        return descriptors, arrays

    @classmethod
    def replay(cls, descriptors, arrays, batch_size_override=None):
        """Reconstruct a graph by re-running node constructors (the model
        loading mechanism). An unknown node class raises
        ``NotImplementedError`` naming it. ``batch_size_override`` is
        accepted and ignored, as in the JAX package: a node's batch size
        comes from its replayed constructor arguments."""
        gm = cls()
        push_manager(gm)
        try:
            for d in descriptors:
                klass = NODE_CLASSES.get(d["cls"])
                if klass is None:
                    raise NotImplementedError(
                        f"unknown node class {d['cls']!r} (node "
                        f"{d['name']!r}); known: {sorted(NODE_CLASSES)}")
                args = [_decode_arg(a, arrays, gm.nodes) for a in d["args"]]
                kwargs = {k: _decode_arg(v, arrays, gm.nodes)
                          for k, v in d["kwargs"].items()}
                kwargs["name"] = d["name"]
                node = klass(*args, **kwargs)
                if node.name != d["name"]:
                    raise RuntimeError(
                        f"replayed node name {node.name!r} != {d['name']!r}")
        finally:
            pop_manager()
        return gm

    def spec_json(self):
        descriptors, arrays = self.get_descriptors()
        return json.dumps({"format": "elektronn2_tpu/v1",
                           "graph": self.name,
                           "designations": self.designations,
                           "nodes": descriptors}, indent=1), arrays


#: module-global manager (reference: ``node_basic.py::model_manager``).
#: Nodes register with the *current* manager — normally this default one;
#: ``replay`` (model loading) temporarily pushes a fresh manager so loading a
#: model never pollutes the user's graph under construction.
model_manager = GraphManager()
_manager_stack = [model_manager]


def current_manager():
    return _manager_stack[-1]


def push_manager(gm):
    _manager_stack.append(gm)


def pop_manager():
    if len(_manager_stack) == 1:
        raise RuntimeError("cannot pop the default model_manager")
    return _manager_stack.pop()
