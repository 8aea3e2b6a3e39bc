"""Operators of the port: plain PyTorch functions over tensors, and the
ops that carry a hand-written Hopper kernel (``flash_attention``).

Importing this package registers every op (``registry.OP_REGISTRY``).
"""
from __future__ import annotations

from . import (elemwise, flash_attention, indexing, init_op, matrix, nn,
               optimizer_op, reduce, rnn_op, sequence)
from .registry import OP_REGISTRY, OpDef, get_op, register

__all__ = ["OP_REGISTRY", "OpDef", "get_op", "register",
           "elemwise", "flash_attention", "indexing", "init_op", "matrix",
           "nn", "optimizer_op", "reduce", "rnn_op", "sequence"]
