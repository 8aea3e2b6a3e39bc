"""``nd`` — the port's imperative array namespace (training-path subset)."""
from __future__ import annotations

from .ndarray import NDArray, array, zeros

__all__ = ["NDArray", "array", "zeros"]
