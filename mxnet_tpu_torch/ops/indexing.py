"""``Embedding``: rows of a weight matrix by token id.

The port's counterpart of the reference's ``ops/indexing.py``
``Embedding``. Token ids may arrive as floats (the training batch is
float32) and are truncated to integers; the weight's gradient is a dense
scatter-add into ``(input_dim, output_dim)``.
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
