"""neuromancer — the declarative graph layer.

Port of ``elektronn2_tpu/neuromancer``: every node is a spec whose
construction computes shapes (``TaggedShape``) and initial parameters;
``Model`` evaluates the graph eagerly on torch tensors and trains it
(``optimiser``: SGD, Adam, AdaGrad, AdaDelta).
"""

from .graphutils import TaggedShape, floatX, as_floatX
from .graphmanager import GraphManager, model_manager
from .node_basic import Node, Input, Concat, InitialState_like, Split, split
from .neural import (Perceptron, Dot, Conv, Pool, UpConv, Crop,
                     FaithlessMerge, FragmentsToDense, GRU, LSTM)
from .various import ScanN
from .loss import (Softmax, MultinoulliNLL, SquaredLoss, Errors,
                   AggregateLoss)
from .model import Model, modelload
from . import optimiser

__all__ = [
    "TaggedShape", "floatX", "as_floatX", "GraphManager", "model_manager",
    "Node", "Input", "Concat", "InitialState_like", "Split", "split",
    "Perceptron", "Dot", "Conv", "Pool", "UpConv", "Crop", "FaithlessMerge",
    "FragmentsToDense", "GRU", "LSTM", "ScanN", "Softmax", "MultinoulliNLL",
    "SquaredLoss", "Errors", "AggregateLoss", "Model", "modelload",
    "optimiser",
]
