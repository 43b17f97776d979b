"""neuromancer — the declarative graph layer.

Port of ``elektronn2_tpu/neuromancer``: every node is a spec whose
construction computes shapes (``TaggedShape``) and initial parameters;
``Model`` evaluates the graph eagerly on torch tensors and trains it
(``optimiser``: SGD, Adam, AdaGrad, AdaDelta).
"""

from .graphutils import TaggedShape, floatX, as_floatX
from .graphmanager import GraphManager, model_manager
from .node_basic import (Node, Input, GenericInput, ValueNode, Concat,
                         InitialState_like, Split, Reshape, Transpose, split)
from .neural import (Perceptron, Dot, Conv, Pool, UpConv, Crop, Pad,
                     Dropout, BatchNorm, FaithlessMerge, FragmentsToDense,
                     GRU, LSTM)
from .various import (GaussianRV, ScanN, SkelLoss, SkelLossField, SkelPrior,
                      SkelGetBatch)
from .loss import (Softmax, MultinoulliNLL, BinaryNLL, GaussianNLL,
                   SquaredLoss, AbsLoss, Errors, AggregateLoss)
from .model import Model, modelload, simple_cnn
from . import optimiser

__all__ = [
    "TaggedShape", "floatX", "as_floatX", "GraphManager", "model_manager",
    "Node", "Input", "GenericInput", "ValueNode", "Concat",
    "InitialState_like", "Split", "Reshape", "Transpose", "split",
    "Perceptron", "Dot", "Conv", "Pool", "UpConv", "Crop", "Pad", "Dropout",
    "BatchNorm", "FaithlessMerge", "FragmentsToDense", "GRU", "LSTM",
    "GaussianRV", "ScanN", "SkelLoss", "SkelLossField", "SkelPrior",
    "SkelGetBatch", "Softmax", "MultinoulliNLL", "BinaryNLL", "GaussianNLL",
    "SquaredLoss", "AbsLoss", "Errors", "AggregateLoss", "Model",
    "modelload", "simple_cnn", "optimiser",
]
