"""``mt.viz`` — network structure inspection.

The port's copy of the reference package's ``visualization.py``
(reference MXNet: ``python/mxnet/visualization.py``).
``print_summary`` walks the Symbol graph with inferred shapes and
parameter counts; ``plot_network`` emits a graphviz Digraph and raises
``ImportError`` without the ``graphviz`` package.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np

__all__ = ["print_summary", "plot_network"]


def _node_params(node, shape_of):
    """Parameter count of a node = total size of its variable inputs that
    look like parameters (weight/bias/gamma/beta)."""
    total = 0
    for src, _ in node.inputs:
        if src.is_variable and src.name.endswith(
                ("weight", "bias", "gamma", "beta")):
            shp = shape_of.get(src.name)
            if shp:
                total += int(np.prod(shp))
    return total


def print_summary(symbol, shape: Optional[Dict] = None, line_length: int = 98,
                  positions=(0.44, 0.64, 0.74, 1.0)):
    """Print a per-layer summary table (columns: Layer (type), Output
    Shape, Param #, Previous Layer); returns the total parameter
    count."""
    from .symbol.symbol import _topo_order

    shape_of: Dict[str, tuple] = {}
    if shape:
        arg_shapes, out_shapes, _ = symbol.infer_shape(**shape)
        for name, shp in zip(symbol.list_arguments(), arg_shapes):
            shape_of[name] = shp
    nodes = _topo_order(symbol._entries)

    positions = [int(line_length * p) for p in positions]
    fields = ["Layer (type)", "Output Shape", "Param #", "Previous Layer"]

    def print_row(values):
        line = ""
        for v, p in zip(values, positions):
            line = (line + str(v))[:p - 1].ljust(p)
        print(line)

    print("_" * line_length)
    print_row(fields)
    print("=" * line_length)
    total = 0
    for node in nodes:
        if node.is_variable:
            continue
        prev = ",".join(src.name for src, _ in node.inputs
                        if not (src.is_variable and src.name != "data"))
        n_params = _node_params(node, shape_of)
        total += n_params
        out_shape = ""
        if shape:
            try:
                from .symbol.symbol import Symbol
                sub = Symbol([(node, 0)])
                needed = {k: v for k, v in shape.items()
                          if k in sub.list_arguments()}
                _, outs, _ = sub.infer_shape_partial(**needed)
                if outs and outs[0]:
                    out_shape = str(tuple(outs[0]))
            except Exception:
                out_shape = "?"
        print_row(["%s (%s)" % (node.name, node.op.name), out_shape,
                   n_params, prev])
    print("=" * line_length)
    print("Total params: %d" % total)
    print("_" * line_length)
    return total


def plot_network(symbol, title="plot", shape=None, node_attrs=None,
                 save_format="pdf"):
    """Build a graphviz Digraph of the symbol graph. Requires the
    ``graphviz`` python package."""
    try:
        from graphviz import Digraph
    except ImportError as e:
        raise ImportError("plot_network requires the graphviz package") \
            from e
    from .symbol.symbol import _topo_order

    node_attrs = dict({"shape": "box", "fixedsize": "false"},
                      **(node_attrs or {}))
    dot = Digraph(name=title, format=save_format)
    # palette per op family, loosely matching the reference's color scheme
    palette = {"FullyConnected": "#fb8072", "Convolution": "#fb8072",
               "Activation": "#ffffb3", "BatchNorm": "#bebada",
               "Pooling": "#80b1d3", "SoftmaxOutput": "#fccde5"}
    _param_suffix = ("weight", "bias", "gamma", "beta", "moving_mean",
                     "moving_var", "label")
    for node in _topo_order(symbol._entries):
        if node.is_variable:
            # draw data-like inputs only; parameters would be orphan boxes
            # since their edges are suppressed below
            if not node.name.endswith(_param_suffix):
                dot.node(node.name, node.name,
                         _attributes=dict(node_attrs,
                                          fillcolor="#8dd3c7",
                                          style="filled"))
            continue
        color = palette.get(node.op.name, "#b3de69")
        dot.node(node.name, "%s\n(%s)" % (node.name, node.op.name),
                 _attributes=dict(node_attrs, fillcolor=color,
                                  style="filled"))
        for src, _ in node.inputs:
            # skip parameter variables, like the reference
            if src.is_variable and src.name.endswith(_param_suffix):
                continue
            dot.edge(src.name, node.name)
    return dot
