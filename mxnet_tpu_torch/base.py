"""Base utilities for mxnet_tpu_torch (the PyTorch/CUDA port).

The port's own copy of the reference package's ``base.py`` error type
(the port never imports the JAX package, whose ``__init__`` imports
jax), and the atomic file write its checkpoint files go through.
"""
from __future__ import annotations

import os
import tempfile

__all__ = ["MXNetError", "atomic_write"]


class MXNetError(RuntimeError):
    """Error raised by the framework (reference: python/mxnet/base.py:66)."""


def atomic_write(path: str, data: bytes) -> None:
    """Write ``data`` to ``path`` through a temporary file in the same
    directory, flushed to disk and renamed over ``path``: a crash leaves
    the old file or the new one, never a torn one (as the reference's
    ``checkpoint.atomic_open`` does)."""
    path = os.path.abspath(path)
    fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path),
                               prefix=os.path.basename(path) + ".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            f.write(data)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        os.unlink(tmp)
        raise
