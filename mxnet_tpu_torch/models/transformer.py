"""Parameter geometry of the zoo decoder-only transformer LM.

The reference package builds this model as a Symbol
(``mxnet_tpu/models/transformer.py``); the port serves it from a
parameter dict. :func:`param_shapes` gives the names and shapes that the
reference's Symbol binds, so one set of seeded numpy weights can be
drawn for both packages, and :func:`param_count` the reference's
analytic count.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Dict, Optional, Tuple

__all__ = ["param_shapes", "param_count"]


def param_shapes(vocab_size: int = 32000, num_layers: int = 12,
                 d_model: int = 768, n_heads: int = 12,
                 d_ff: Optional[int] = None,
                 seq_len: int = 512) -> Dict[str, Tuple[int, ...]]:
    """Name -> shape of every parameter, in the Symbol's order."""
    if d_model % n_heads:
        raise ValueError("d_model %d not divisible by n_heads %d"
                         % (d_model, n_heads))
    d_ff = d_ff or 4 * d_model
    shapes = OrderedDict()
    shapes["tok_embed_weight"] = (vocab_size, d_model)
    shapes["pos_embed_weight"] = (seq_len, d_model)
    for i in range(num_layers):
        p = "layer%d" % i
        shapes[p + "_ln1_gamma"] = (d_model,)
        shapes[p + "_ln1_beta"] = (d_model,)
        shapes[p + "_att_qkv_weight"] = (3 * d_model, d_model)
        shapes[p + "_att_qkv_bias"] = (3 * d_model,)
        shapes[p + "_att_proj_weight"] = (d_model, d_model)
        shapes[p + "_att_proj_bias"] = (d_model,)
        shapes[p + "_ln2_gamma"] = (d_model,)
        shapes[p + "_ln2_beta"] = (d_model,)
        shapes[p + "_ff1_weight"] = (d_ff, d_model)
        shapes[p + "_ff1_bias"] = (d_ff,)
        shapes[p + "_ff2_weight"] = (d_model, d_ff)
        shapes[p + "_ff2_bias"] = (d_model,)
    shapes["final_ln_gamma"] = (d_model,)
    shapes["final_ln_beta"] = (d_model,)
    shapes["lm_head_weight"] = (vocab_size, d_model)
    shapes["lm_head_bias"] = (vocab_size,)
    return shapes


def param_count(vocab_size: int = 32000, num_layers: int = 12,
                d_model: int = 768, n_heads: int = 12,
                d_ff: Optional[int] = None, seq_len: int = 512) -> int:
    """Analytic parameter count (for FLOP estimates)."""
    d_ff = d_ff or 4 * d_model
    per_layer = 3 * d_model * d_model + 3 * d_model \
        + (d_model + 1) * d_model \
        + (d_model + 1) * d_ff + (d_ff + 1) * d_model + 4 * d_model
    return (vocab_size * d_model + seq_len * d_model
            + num_layers * per_layer + 2 * d_model
            + (d_model + 1) * vocab_size)
