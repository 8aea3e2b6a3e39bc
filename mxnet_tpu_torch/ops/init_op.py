"""Creation ops (no array inputs): ``_arange``.

The port's counterpart of the reference's ``ops/init_op.py``. The
executor passes the device to create on as ``_device``.
"""
from __future__ import annotations

import torch

from ..ndarray.ndarray import to_torch_dtype
from .registry import register

__all__ = []


@register("_arange", num_inputs=0, aliases=("arange",))
def arange(start=0, stop=None, step=1.0, repeat=1, dtype="float32",
           _device=None):
    """Evenly spaced values, each repeated ``repeat`` times."""
    if stop is None:
        start, stop = 0, start
    out = torch.arange(start, stop, step, dtype=to_torch_dtype(dtype),
                       device=_device)
    if repeat and repeat > 1:
        out = out.repeat_interleave(int(repeat))
    return out
