"""Creation ops (no array inputs): ``_zeros``, ``_ones``, ``_full``,
``_arange`` and ``_eye``.

The port's counterpart of the reference's ``ops/init_op.py``. The
executor passes the device to create on as ``_device``.
"""
from __future__ import annotations

import torch

from ..ndarray.ndarray import to_torch_dtype
from .registry import register

__all__ = []


def _shape(shape):
    return (int(shape),) if isinstance(shape, int) else tuple(shape)


@register("_zeros", num_inputs=0, aliases=("zeros",))
def zeros(shape=(), dtype="float32", _device=None):
    return torch.zeros(_shape(shape), dtype=to_torch_dtype(dtype),
                       device=_device)


@register("_ones", num_inputs=0, aliases=("ones",))
def ones(shape=(), dtype="float32", _device=None):
    return torch.ones(_shape(shape), dtype=to_torch_dtype(dtype),
                      device=_device)


@register("_full", num_inputs=0, aliases=("full",))
def full(shape=(), value=0.0, dtype="float32", _device=None):
    return torch.full(_shape(shape), value, dtype=to_torch_dtype(dtype),
                      device=_device)


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


@register("_eye", num_inputs=0, aliases=("eye",))
def eye(N=0, M=0, k=0, dtype="float32", _device=None):
    """An ``N`` x ``M`` (``M`` 0: ``N``) matrix with ones on diagonal
    ``k``."""
    n, m, k = int(N), int(M) or int(N), int(k)
    rows = torch.arange(n, device=_device).unsqueeze(1)
    cols = torch.arange(m, device=_device).unsqueeze(0)
    return (cols - rows == k).to(to_torch_dtype(dtype))
