"""``io`` — data iterators (training-path subset)."""
from __future__ import annotations

from .io import DataBatch, DataDesc, DataIter, NDArrayIter

__all__ = ["DataBatch", "DataDesc", "DataIter", "NDArrayIter"]
