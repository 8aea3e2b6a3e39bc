"""Base utilities for mxnet_tpu_torch (the PyTorch/CUDA port).

The port's own copy of the reference package's ``base.py`` error type:
the port never imports the JAX package, whose ``__init__`` imports jax.
"""
from __future__ import annotations

__all__ = ["MXNetError"]


class MXNetError(RuntimeError):
    """Error raised by the framework (reference: python/mxnet/base.py:66)."""
