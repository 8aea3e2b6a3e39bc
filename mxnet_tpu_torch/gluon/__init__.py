"""Gluon — the imperative high-level API.

The port's counterpart of the reference's ``gluon/``: Block /
HybridBlock containers (``hybridize`` keeps a per-signature cache and
runs the body eagerly, see ``block.py``), Parameter / ParameterDict,
Trainer, the ``nn`` layers, the recurrent cells and layers (``rnn``),
losses, ``data`` and the vision model zoo.
"""
from . import block
from . import nn
from . import rnn
from . import loss
from . import parameter
from . import trainer
from . import utils
from . import data
from . import model_zoo

from .parameter import Parameter, ParameterDict, DeferredInitializationError
from .block import Block, HybridBlock, SymbolBlock
from .trainer import Trainer

__all__ = ["nn", "rnn", "loss", "data", "utils", "model_zoo", "Parameter",
           "ParameterDict", "DeferredInitializationError", "Block",
           "HybridBlock", "SymbolBlock", "Trainer"]
