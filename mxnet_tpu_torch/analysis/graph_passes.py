"""Static passes over ``Symbol`` graphs, run before a bind's first step.

The part of the reference's ``analysis/graph_passes.py`` that
``MXNET_TPU_REMAT=auto`` needs: :class:`GraphContext`, the pass
registry, the node-wise shape pass (``shape-error``), the static FLOP
rules (:func:`_node_flops`) and :func:`analyze_symbol`. The memory
pass ``remat-opportunity`` registers from :mod:`.memory_passes`. The
structural passes (cycle, dup-name, dead-node), the cost model and the
HBM budget are queue A10.

The reference finds each node's output shapes and dtypes with
``jax.eval_shape``; the port runs the node's op on ``meta`` tensors of
the input shapes and dtypes (or the op's ``meta_fn``), under whatever
amp policy is set, as the reference traces under it. The per-node
shapes and dtypes are the reference's (``tests/test_torch_remat.py``).
"""
from __future__ import annotations

import ast as _pyast
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from .findings import Finding, Report, Severity

__all__ = ["analyze_symbol", "GRAPH_PASSES", "GraphContext"]


# ------------------------------------------------------------ pass context


def _torch_dtype(dt) -> torch.dtype:
    if isinstance(dt, torch.dtype):
        return dt
    from ..ndarray.ndarray import to_torch_dtype
    return to_torch_dtype(dt)


class GraphContext:
    """Shared state the passes read and fill: the topo node list, the
    resolved variable shapes and dtypes, and per-entry output
    ``(shape, torch dtype)`` from the node-wise evaluation (filled by the
    shape pass, read by the remat pass). ``device`` is where the remat
    pass's calibration runs one block."""

    def __init__(self, sym, input_shapes=None, input_dtypes=None,
                 device=None):
        from ..symbol.symbol import _topo_order
        self.sym = sym
        self.entries = list(sym._entries)
        self.input_shapes = {k: tuple(v) for k, v in
                             (input_shapes or {}).items()}
        self.input_dtypes = {k: _torch_dtype(v) for k, v in
                             (input_dtypes or {}).items()}
        self.device = device
        self.has_cycle = False
        self.calibrate_remat = None
        self.nodes = _topo_order(self.entries)
        self.arg_names = sym.list_arguments()
        self.aux_names = sym.list_auxiliary_states()
        # (id(node), out_idx) -> (shape tuple, torch dtype); variables at 0
        self.shapes: Dict[Tuple[int, int], Tuple[tuple, Any]] = {}
        self.var_shapes: Dict[str, tuple] = {}

    def resolve_variables(self):
        """Variable shapes: caller-provided > ``__shape__`` attrs >
        structural parameter derivation (``symbol._propagate_shapes``),
        skipped when the caller gave every shape (a bind does)."""
        resolved = dict(self.input_shapes)
        resolved.pop("__batch_size__", None)
        for node in self.nodes:
            if node.is_variable and node.name not in resolved and \
                    "__shape__" in node.str_attrs:
                try:
                    resolved[node.name] = tuple(
                        _pyast.literal_eval(node.str_attrs["__shape__"]))
                except (ValueError, SyntaxError):
                    pass
        if any(n not in resolved for n in self.arg_names + self.aux_names):
            from ..symbol.symbol import _propagate_shapes
            try:
                resolved.update(_propagate_shapes(self.sym, resolved)[1])
            except Exception:                               # noqa: BLE001
                pass  # best-effort; the shape pass reports the gaps
        self.var_shapes = {k: v for k, v in resolved.items()
                           if not any(d == 0 for d in v)}

    def var_dtype(self, node) -> torch.dtype:
        if node.name in self.input_dtypes:
            return self.input_dtypes[node.name]
        dt = node.str_attrs.get("__dtype__")
        if dt:
            try:
                return _torch_dtype(np.dtype(dt))
            except (TypeError, KeyError, ValueError):
                pass
        return torch.float32


GRAPH_PASSES: List[Tuple[str, Any]] = []


def graph_pass(code):
    def _reg(fn):
        GRAPH_PASSES.append((code, fn))
        return fn
    return _reg


def _eval_node_meta(node, in_avals):
    """One node's outputs as ``(shape, dtype)`` pairs, from its op run
    on meta tensors of ``in_avals`` (or its ``meta_fn``)."""
    from ..symbol.symbol import run_node
    ins = [torch.empty(s, dtype=dt, device="meta") for s, dt in in_avals]
    meta_fn = getattr(node.op, "meta_fn", None)
    with torch.no_grad():
        if meta_fn is not None:
            attrs = {k: v for k, v in node.attrs.items() if k != "name"}
            outs = meta_fn(*ins, **attrs)
            outs = outs if isinstance(outs, tuple) else (outs,)
        else:
            outs = run_node(node, ins, True, torch.device("meta"))
    return tuple((tuple(o.shape), o.dtype) for o in outs)


# ------------------------------------------------------------------ passes


@graph_pass("shape-error")
def check_shapes(ctx: GraphContext, report: Report) -> None:
    """Node-wise evaluation with shape and dtype propagation. Failures
    get op-contextualized ERROR findings; successful nodes fill
    ``ctx.shapes``. The key chain is left as it was (a sampler run on
    meta tensors would take a key)."""
    if ctx.has_cycle:
        return
    from .. import random as _random

    ctx.resolve_variables()
    missing = [n for n in ctx.arg_names + ctx.aux_names
               if n not in ctx.var_shapes]
    if missing:
        report.add(
            "shape-error", Severity.INFO,
            "shapes unknown for %s — shape/cost analysis is partial "
            "(pass input_shapes= to analyze, or set Variable(shape=...))"
            % missing[:8])

    def entry_aval(src, i):
        if src.is_variable:
            s = ctx.var_shapes.get(src.name)
            if s is None:
                return None
            return (tuple(s), ctx.var_dtype(src))
        return ctx.shapes.get((id(src), i))

    key = _random.current_key()
    eval_memo: Dict[tuple, Any] = {}
    try:
        for node in ctx.nodes:
            if node.is_variable:
                s = ctx.var_shapes.get(node.name)
                if s is not None:
                    ctx.shapes[(id(node), 0)] = (tuple(s),
                                                 ctx.var_dtype(node))
                continue
            in_avals = [entry_aval(src, i) for src, i in node.inputs]
            if any(a is None for a in in_avals):
                continue
            ckey = (node.op.name, tuple(in_avals),
                    tuple(sorted((k, repr(v))
                                 for k, v in node.attrs.items())))
            cached = eval_memo.get(ckey)
            if cached is None and ckey not in eval_memo:
                try:
                    cached = _eval_node_meta(node, in_avals)
                except Exception as exc:                    # noqa: BLE001
                    cached = exc
                eval_memo[ckey] = cached
            if isinstance(cached, BaseException):
                shapes_str = ", ".join(
                    "%s: %s %s" % (src.name, "x".join(map(str, a[0])) or
                                   "scalar", a[1])
                    for (src, _), a in zip(node.inputs, in_avals))
                report.add(
                    "shape-error", Severity.ERROR,
                    "op %s rejects its inputs [%s]: %s"
                    % (node.op.name, shapes_str,
                       str(cached).splitlines()[0] if str(cached) else
                       type(cached).__name__),
                    node=node.name, op=node.op.name,
                    detail={"input_shapes": [a[0] for a in in_avals]})
            elif cached is not None:
                for i, aval in enumerate(cached):
                    ctx.shapes[(id(node), i)] = aval
    finally:
        _random.set_key(key)


# ---------------------------------------------------------------- FLOP rules


def _nelem(shape) -> int:
    return int(np.prod(shape)) if shape else 1


def _attr_bool(v) -> bool:
    if isinstance(v, str):
        return v.strip().lower() in ("1", "true", "yes", "on")
    return bool(v)


def _attr_tuple(v):
    """Attr values are python tuples from the symbol API but strings
    after a JSON round-trip."""
    if isinstance(v, str):
        try:
            v = _pyast.literal_eval(v)
        except (ValueError, SyntaxError):
            return None
    if v is None:
        return None
    return tuple(v) if isinstance(v, (tuple, list)) else (int(v),)


def _node_flops(node, in_avals, out_avals) -> int:
    """Static FLOP estimate; default one flop per output element
    (elementwise), with explicit rules for the contraction-heavy ops."""
    name = node.op.name
    a = node.attrs
    out_elems = sum(_nelem(s) for s, _ in out_avals)
    try:
        if name == "FullyConnected" and len(in_avals) >= 2:
            k = in_avals[1][0][-1]                 # weight (nh, K)
            return 2 * _nelem(out_avals[0][0]) * int(k)
        if name in ("Convolution", "Convolution_v1") and len(in_avals) >= 2:
            # weight (nf, cin/g, *kernel): each output element needs
            # cin/g * prod(kernel) MACs, so grouped/depthwise conv is
            # priced correctly through the weight shape itself
            w = in_avals[1][0]
            return 2 * _nelem(out_avals[0][0]) * _nelem(w[1:])
        if name == "Deconvolution" and len(in_avals) >= 2:
            # weight (cin, nf/g, *kernel) — NOT the conv layout; pricing
            # through w[1:] would charge nf/g where the contraction depth
            # is cin/g (wrong whenever cin != nf)
            w = in_avals[1][0]
            g = int(a.get("num_group", 1) or 1)
            return 2 * _nelem(out_avals[0][0]) * (int(w[0]) // g) \
                * _nelem(w[2:])
        if name in ("Pooling", "Pooling_v1"):
            # one compare/add per window element per output element (the
            # per-element fallback would undercount by prod(kernel)); avg
            # adds one divide per output element
            in_shape = in_avals[0][0]
            if _attr_bool(a.get("global_pool")):
                kernel = in_shape[2:]
            else:
                kernel = _attr_tuple(a.get("kernel")) or ()
            out_elems0 = _nelem(out_avals[0][0])
            flops = out_elems0 * max(1, _nelem(kernel))
            if str(a.get("pool_type", "max")) == "avg":
                flops += out_elems0
            return flops
        if name in ("dot", "batch_dot", "linalg_gemm2"):
            k = in_avals[0][0][-1]
            return 2 * _nelem(out_avals[0][0]) * int(k)
        if name == "FlashAttention":
            # fused QK^T + softmax-weighted V: two (T x d)·(d x T)-class
            # contractions per head — 4*T*d FLOPs per output element
            # (q: (..., T, d)); the default one-per-element rule would
            # undercount attention ~15x
            q_shape = in_avals[0][0]
            t, d = int(q_shape[-2]), int(q_shape[-1])
            return 4 * _nelem(q_shape[:-2]) * t * t * d
        if name == "Embedding":
            return 0                               # a gather, no FLOPs
        if name in ("BatchNorm", "BatchNorm_v1", "LayerNorm",
                    "InstanceNorm", "L2Normalization"):
            return 8 * _nelem(in_avals[0][0])      # mean/var/scale/shift
        if name in ("softmax", "SoftmaxActivation", "SoftmaxOutput",
                    "log_softmax"):
            return 5 * _nelem(in_avals[0][0])
        if name == "RNN":
            T, N, I = in_avals[0][0][:3]
            H = int(a.get("state_size"))
            L = int(a.get("num_layers", 1))
            gates = {"lstm": 4, "gru": 3}.get(a.get("mode", "lstm"), 1)
            return 2 * gates * T * N * (I + H) * H * L
    except (IndexError, KeyError, TypeError, ValueError):
        pass
    return out_elems


# -------------------------------------------------------------- entry point


def analyze_symbol(sym, input_shapes=None, input_dtypes=None,
                   context: str = "graph", calibrate_remat=None,
                   device=None) -> Report:
    """Run the graph passes over ``sym``; returns a :class:`Report`.

    ``input_shapes``/``input_dtypes`` play the role of bind-time shapes
    (name -> shape/dtype); omitted names fall back to ``__shape__`` attrs
    and structural parameter derivation. ``calibrate_remat`` forces
    (True) or suppresses (False) the remat pass's block calibration,
    which runs one block on ``device`` (None: the card, as every entry
    point); None (the default) runs it only when a remat knob is on.
    """
    report = Report(context=context)
    ctx = GraphContext(sym, input_shapes, input_dtypes, device=device)
    ctx.calibrate_remat = calibrate_remat
    for _, fn in GRAPH_PASSES:
        fn(ctx, report)
    return report
