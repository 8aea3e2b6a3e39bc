"""Operators of the port: plain PyTorch functions over tensors, and the
ops that carry a hand-written Hopper kernel (``flash_attention``).
The structured families (``vision``, ``detection``, ``contrib``) follow
the reference's ops of the same files.

Importing this package registers every op (``registry.OP_REGISTRY``).
"""
from __future__ import annotations

from . import (contrib, detection, elemwise, flash_attention, indexing,
               init_op, matrix, nn, optimizer_op, random_op, reduce, rnn_op,
               sequence, vision)
from .registry import OP_REGISTRY, OpDef, get_op, register

__all__ = ["OP_REGISTRY", "OpDef", "get_op", "register",
           "contrib", "detection", "elemwise", "flash_attention",
           "indexing", "init_op", "matrix", "nn", "optimizer_op",
           "random_op", "reduce", "rnn_op", "sequence", "vision"]
