"""``Embedding`` (rows of a weight matrix by token id) and ``pick``.

The port's counterpart of the reference's ``ops/indexing.py``
``Embedding`` and ``pick``. Ids may arrive as floats (the training
batch is float32) and are truncated to integers; the weight's gradient
is a dense scatter-add into ``(input_dim, output_dim)``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .registry import register

__all__ = []


@register("Embedding", num_inputs=2, aliases=("embedding",))
def embedding(data, weight, input_dim=None, output_dim=None,
              dtype="float32"):
    return F.embedding(data.to(torch.int64), weight)


@register("pick", num_inputs=2)
def pick(data, index, axis=-1, keepdims=False):
    """One element per position along ``axis``, chosen by ``index``
    (clipped into range): the backbone of cross-entropy."""
    axis = axis % data.dim()
    idx = index.to(torch.int64).clamp(0, data.shape[axis] - 1)
    if idx.dim() < data.dim():
        idx = idx.unsqueeze(axis)
    out = torch.gather(data, axis, idx)
    return out if keepdims else out.squeeze(axis)
