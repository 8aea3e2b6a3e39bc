"""Base utilities for mxnet_tpu_torch (the PyTorch/CUDA port).

The port's own copy of the reference package's ``base.py`` error type
(the port never imports the JAX package, whose ``__init__`` imports
jax), and the atomic file write its checkpoint files go through.
"""
from __future__ import annotations

__all__ = ["MXNetError", "atomic_write"]


class MXNetError(RuntimeError):
    """Error raised by the framework (reference: python/mxnet/base.py:66)."""


def atomic_write(path: str, data: bytes) -> None:
    """Write ``data`` to ``path`` through :func:`checkpoint.atomic_open`:
    a crash leaves the old file or the new one, never a torn one."""
    from .checkpoint.atomic import atomic_open
    with atomic_open(path, "wb") as f:
        f.write(data)
