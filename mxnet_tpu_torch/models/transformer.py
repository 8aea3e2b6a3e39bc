"""The zoo decoder-only transformer LM (GPT-style).

:func:`get_symbol` builds the training Symbol exactly as the reference
does (``mxnet_tpu/models/transformer.py``): the same ops, argument
names and order, so a Symbol JSON file, a parameter dict or a set of
seeded numpy weights carries between the two packages. The serving path
runs the same model from a parameter dict: :func:`param_shapes` gives
the names and shapes the Symbol binds, and :func:`param_count` the
reference's analytic count.

Shapes: data (N, T) token ids (float), softmax_label (N, T) next-token
ids; the output is the softmax over the vocabulary, (N·T, V).
"""
from __future__ import annotations

import math
from collections import OrderedDict
from typing import Dict, Optional, Tuple

from .. import symbol as sym

__all__ = ["get_symbol", "param_shapes", "param_count"]


def _attention(x, n_heads, d_model, T, name, attention="dense"):
    """Causal multi-head self-attention over x (N, T, D). ``"flash"``
    runs the flash-attention op (the port's Hopper kernels);
    ``"dense"`` the batch_dot + masked-softmax composition."""
    d_head = d_model // n_heads
    qkv = sym.FullyConnected(x, num_hidden=3 * d_model, flatten=False,
                             name="%s_qkv" % name)          # (N, T, 3D)
    qkv = sym.reshape(qkv, (-1, T, 3, n_heads, d_head))
    qkv = sym.transpose(qkv, axes=(2, 0, 3, 1, 4))          # (3,N,H,T,d)
    if attention == "flash":
        q = sym.reshape(sym.slice_axis(qkv, axis=0, begin=0, end=1),
                        (-1, n_heads, T, d_head))           # (N, H, T, d)
        k = sym.reshape(sym.slice_axis(qkv, axis=0, begin=1, end=2),
                        (-1, n_heads, T, d_head))
        v = sym.reshape(sym.slice_axis(qkv, axis=0, begin=2, end=3),
                        (-1, n_heads, T, d_head))
        ctx = sym.FlashAttention(q, k, v, causal=True)      # (N, H, T, d)
        ctx = sym.transpose(ctx, axes=(0, 2, 1, 3))         # (N, T, H, d)
    else:
        q = sym.reshape(sym.slice_axis(qkv, axis=0, begin=0, end=1),
                        (-1, T, d_head))                    # (N*H, T, d)
        k = sym.reshape(sym.slice_axis(qkv, axis=0, begin=1, end=2),
                        (-1, T, d_head))
        v = sym.reshape(sym.slice_axis(qkv, axis=0, begin=2, end=3),
                        (-1, T, d_head))
        scores = sym.batch_dot(q, k, transpose_b=True)      # (N*H, T, T)
        scores = scores * (1.0 / float(math.sqrt(d_head)))
        # causal bias: -1e9 where key position > query position
        pos = sym.arange(start=0, stop=T)
        qpos = sym.reshape(pos, (T, 1))
        kpos = sym.reshape(pos, (1, T))
        future = sym.broadcast_greater(kpos, qpos)          # (T, T)
        bias = sym.reshape(future * -1e9, (1, T, T))
        scores = sym.broadcast_add(scores, bias)
        att = sym.softmax(scores, axis=-1)
        ctx = sym.batch_dot(att, v)                         # (N*H, T, d)
        ctx = sym.reshape(ctx, (-1, n_heads, T, d_head))
        ctx = sym.transpose(ctx, axes=(0, 2, 1, 3))         # (N, T, H, d)
    ctx = sym.reshape(ctx, (-1, T, d_model))
    return sym.FullyConnected(ctx, num_hidden=d_model, flatten=False,
                              name="%s_proj" % name)


def _block(x, n_heads, d_model, d_ff, T, name, attention="dense"):
    ln1 = sym.LayerNorm(x, sym.Variable("%s_ln1_gamma" % name),
                        sym.Variable("%s_ln1_beta" % name))
    x = x + _attention(ln1, n_heads, d_model, T, name + "_att",
                       attention=attention)
    ln2 = sym.LayerNorm(x, sym.Variable("%s_ln2_gamma" % name),
                        sym.Variable("%s_ln2_beta" % name))
    h = sym.FullyConnected(ln2, num_hidden=d_ff, flatten=False,
                           name="%s_ff1" % name)
    h = sym.Activation(h, act_type="relu")
    h = sym.FullyConnected(h, num_hidden=d_model, flatten=False,
                           name="%s_ff2" % name)
    return x + h


def get_symbol(vocab_size=32000, num_layers=12, d_model=768, n_heads=12,
               d_ff=None, seq_len=512, attention="dense"):
    """The LM training symbol: embeddings -> L blocks -> output
    projection -> per-token SoftmaxOutput (``normalization="batch"``)."""
    d_ff = d_ff or 4 * d_model
    T = seq_len
    data = sym.Variable("data")                             # (N, T) ids
    tok = sym.Embedding(data, sym.Variable("tok_embed_weight"),
                        input_dim=vocab_size, output_dim=d_model,
                        name="tok_embed")                   # (N, T, D)
    pos_ids = sym.arange(start=0, stop=T)
    pos = sym.Embedding(pos_ids, sym.Variable("pos_embed_weight"),
                        input_dim=T, output_dim=d_model,
                        name="pos_embed")                   # (T, D)
    x = sym.broadcast_add(tok, sym.reshape(pos, (1, T, d_model)))
    for i in range(num_layers):
        x = _block(x, n_heads, d_model, d_ff, T, "layer%d" % i,
                   attention=attention)
    x = sym.LayerNorm(x, sym.Variable("final_ln_gamma"),
                      sym.Variable("final_ln_beta"))
    logits = sym.FullyConnected(x, num_hidden=vocab_size, flatten=False,
                                name="lm_head")             # (N, T, V)
    logits = sym.reshape(logits, (-1, vocab_size))          # (N*T, V)
    label = sym.reshape(sym.Variable("softmax_label"), (-1,))
    return sym.SoftmaxOutput(logits, label, name="softmax",
                             normalization="batch")


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
