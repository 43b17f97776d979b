"""neuromancer — the declarative graph layer (forward only in this slice).

Port of ``elektronn2_tpu/neuromancer``: every node is a spec whose
construction computes shapes (``TaggedShape``) and initial parameters;
``Model`` evaluates the graph eagerly on torch tensors.
"""

from .graphutils import TaggedShape, floatX, as_floatX
from .graphmanager import GraphManager, model_manager
from .node_basic import Node, Input, Concat
from .neural import Conv, Pool, FragmentsToDense
from .loss import Softmax, MultinoulliNLL, AggregateLoss
from .model import Model, modelload

__all__ = [
    "TaggedShape", "floatX", "as_floatX", "GraphManager", "model_manager",
    "Node", "Input", "Concat", "Conv", "Pool", "FragmentsToDense",
    "Softmax", "MultinoulliNLL", "AggregateLoss", "Model", "modelload",
]
