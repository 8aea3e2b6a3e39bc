"""Static passes over ``Symbol`` graphs, run before a bind's first step.

The port of the reference's ``analysis/graph_passes.py``, in the
reference's order:

* ``cycle`` — the graph must be a DAG (a hand-mutated node list can
  close a loop; the graph function would recurse forever);
* ``dup-name`` — two distinct nodes sharing a name (duplicate Variables
  bind ONE buffer to both; duplicate op names collide in
  ``list_outputs`` and checkpoint JSON);
* ``dead-node`` / ``unused-input`` — outputs of a multi-output op that
  nothing consumes, and bindings that name no graph variable;
* ``shape-error`` — the node-wise shape pass, with op-contextualized
  errors;
* ``cost-model`` — per-node FLOPs (:func:`_node_flops`) and bytes and
  the liveness peak (``Report.extras["cost"]``), which
  ``Module.analyze``, the MFU gauge (:mod:`..obs.mfu`) and the
  ``hbm-budget`` pass read.

The memory passes (``remat-opportunity``, ``hbm-budget``) register from
:mod:`.memory_passes`.

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
                 device=None, grad_accum=None, batch_inputs=None):
        from ..symbol.symbol import _topo_order
        self.sym = sym
        self.entries = list(sym._entries)
        self.input_shapes = {k: tuple(v) for k, v in
                             (input_shapes or {}).items()}
        self.input_dtypes = {k: _torch_dtype(v) for k, v in
                             (input_dtypes or {}).items()}
        self.device = device
        # microbatch accumulation factor + the inputs carrying the batch
        # axis (data/label names): the cost model prices the microbatch
        # peak, not the full batch
        self.grad_accum = max(1, int(grad_accum or 1))
        self.batch_inputs = frozenset(batch_inputs or ())
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


def _find_cycle(entries) -> Optional[List[Any]]:
    """Iterative 3-color DFS; returns one cycle's node list or None.
    Must not rely on ``_topo_order`` (which silently tolerates cycles)."""
    WHITE, GRAY, BLACK = 0, 1, 2
    color: Dict[int, int] = {}
    for root, _ in entries:
        if color.get(id(root), WHITE) != WHITE:
            continue
        stack = [(root, iter([n for n, _ in root.inputs]))]
        color[id(root)] = GRAY
        path = [root]
        while stack:
            node, it = stack[-1]
            child = next(it, None)
            if child is None:
                color[id(node)] = BLACK
                stack.pop()
                path.pop()
                continue
            c = color.get(id(child), WHITE)
            if c == GRAY:
                i = next(i for i, n in enumerate(path) if n is child)
                return path[i:] + [child]
            if c == WHITE:
                color[id(child)] = GRAY
                stack.append((child, iter([n for n, _ in child.inputs])))
                path.append(child)
    return None


# ------------------------------------------------------- structural passes


@graph_pass("cycle")
def check_cycles(ctx: GraphContext, report: Report) -> None:
    cyc = _find_cycle(ctx.entries)
    if cyc is not None:
        ctx.has_cycle = True
        names = " -> ".join(n.name for n in cyc)
        report.add(
            "cycle", Severity.ERROR,
            "graph contains a cycle (%s) — binding would recurse forever "
            "while the graph runs" % names,
            node=cyc[0].name, op=getattr(cyc[0].op, "name", "null"))


@graph_pass("dup-name")
def check_duplicate_names(ctx: GraphContext, report: Report) -> None:
    by_name: Dict[str, List[Any]] = {}
    for node in ctx.nodes:
        by_name.setdefault(node.name, []).append(node)
    for name, nodes in by_name.items():
        if len(nodes) < 2:
            continue
        kinds = ["variable" if n.is_variable else n.op.name for n in nodes]
        if all(n.is_variable for n in nodes):
            msg = ("%d distinct Variable nodes named %r — bind maps ONE "
                   "buffer onto all of them and gradients silently merge"
                   % (len(nodes), name))
        else:
            msg = ("%d distinct nodes named %r (%s) — output names and "
                   "checkpoint JSON collide" % (len(nodes), name,
                                                ", ".join(kinds)))
        report.add("dup-name", Severity.ERROR, msg, node=name,
                   op=kinds[0])


@graph_pass("dead-node")
def check_dead_nodes(ctx: GraphContext, report: Report) -> None:
    from ..symbol.symbol import _num_visible_outputs
    consumed = {(id(src), i) for node in ctx.nodes
                for src, i in node.inputs}
    heads = {(id(n), i) for n, i in ctx.entries}
    for node in ctx.nodes:
        if node.is_variable:
            continue
        try:
            n_out = _num_visible_outputs(node.op, node.attrs)
        except Exception:                                   # noqa: BLE001
            continue
        if n_out < 2:
            # single-output nodes are reachable == consumed by construction
            continue
        dead = [i for i in range(n_out)
                if (id(node), i) not in consumed
                and (id(node), i) not in heads]
        if dead:
            report.add(
                "dead-node", Severity.WARNING,
                "output(s) %s of %d-output op are never consumed — computed "
                "then discarded every run (slice less, or drop the op)"
                % (dead, n_out), node=node.name, op=node.op.name)
    graph_vars = {n.name for n in ctx.nodes if n.is_variable}
    for name in ctx.input_shapes:
        if name != "__batch_size__" and name not in graph_vars:
            report.add(
                "unused-input", Severity.WARNING,
                "provided binding %r names no graph variable (typo, or a "
                "stale shape dict)" % name, node=name)


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


def cost_model(ctx: GraphContext, report: Report) -> None:
    """Static per-node FLOPs/bytes + liveness memory high-water. Runs only
    over nodes the shape pass resolved; partial graphs yield partial (but
    still useful) totals, flagged in the summary.

    With ``ctx.grad_accum = N > 1`` the liveness sweep prices what the
    accumulating step materializes: one microbatch holds a 1/N slice of
    every batch-leading activation, plus a gradient buffer per
    grad-bearing parameter (in the parameter's own dtype) alive across
    the step. FLOPs and bytes_moved stay full-batch — the step runs all
    N microbatches. The numbers are the reference's for the same graph,
    shapes and dtypes."""
    if ctx.has_cycle:
        return
    # every bound variable buffer (params AND data/label inputs): this is
    # what bind actually allocates and holds live for the whole program
    bound_bytes = 0
    for node in ctx.nodes:
        if node.is_variable and (id(node), 0) in ctx.shapes:
            s, dt = ctx.shapes[(id(node), 0)]
            bound_bytes += _nelem(s) * dt.itemsize

    # microbatching: resolve the batch axis from the declared batch
    # inputs; scaling applies only when every batch input agrees and N
    # divides it (exactly the fused step's own set_grad_accum contract)
    accum = ctx.grad_accum
    batch = None
    if accum > 1 and ctx.batch_inputs:
        leads = set()
        for node in ctx.nodes:
            if node.is_variable and node.name in ctx.batch_inputs:
                aval = ctx.shapes.get((id(node), 0))
                if aval and aval[0]:
                    leads.add(int(aval[0][0]))
        if len(leads) == 1:
            b = leads.pop()
            if b % accum == 0:
                batch = b

    # batch-tainted nodes: everything dataflow-reachable from a batch
    # input. A tainted activation whose element count divides by the
    # batch carries the batch axis SOMEWHERE — leading ((N,T,D)), folded
    # into the lead by reshape ((N*T, D)), or moved inward by transpose
    # ((3, N, H, T, d)) — and shrinks by 1/N inside the scan body.
    # Weight-only intermediates with coincidentally-divisible sizes must
    # NOT shrink (scan-invariant), which is what the taint gate is for;
    # the residue this rule mis-prices is batch REDUCTIONS (tainted,
    # batch axis summed away, size still divisible by luck) — small by
    # construction, and an underestimate only of the scaled-down term.
    tainted = set()
    if batch is not None:
        for node in ctx.nodes:
            if node.is_variable:
                if node.name in ctx.batch_inputs:
                    tainted.add(id(node))
            elif any(id(src) in tainted for src, _ in node.inputs):
                tainted.add(id(node))

    def _live_bytes(node_id, aval) -> int:
        shape, dt = aval
        n = _nelem(shape)
        full = n * dt.itemsize
        if batch is not None and node_id in tainted and n \
                and n % batch == 0:
            return full // accum
        return full

    # the gradient buffers: one accumulator per grad-bearing parameter,
    # live for the whole step, priced at the parameter's own dtype
    grad_carry_bytes = 0
    if batch is not None:
        skip = ctx.batch_inputs | frozenset(ctx.aux_names)
        for node in ctx.nodes:
            if node.is_variable and node.name not in skip:
                aval = ctx.shapes.get((id(node), 0))
                if aval is not None:
                    grad_carry_bytes += _nelem(aval[0]) * aval[1].itemsize

    # last topo index consuming each entry; heads live to the end
    order = {id(n): i for i, n in enumerate(ctx.nodes)}
    last_use: Dict[Tuple[int, int], int] = {}
    for node in ctx.nodes:
        for src, i in node.inputs:
            last_use[(id(src), i)] = order[id(node)]
    end = len(ctx.nodes)
    for n, i in ctx.entries:
        last_use[(id(n), i)] = end

    total_flops = 0
    total_bytes = 0
    live = 0
    peak = 0
    skipped = 0
    per_node = []
    # live-set snapshot at the high-water (the graph twin of
    # analyze_program_memory's top_live): what the peak is MADE of —
    # which is what the tuner's remat/accum decisions need to see
    live_entries: Dict[Tuple[int, int], Tuple[str, int]] = {}
    peak_live: List[Tuple[str, int]] = []
    for idx, node in enumerate(ctx.nodes):
        if node.is_variable:
            continue
        in_avals = []
        ok = True
        for src, i in node.inputs:
            aval = ctx.shapes.get((id(src), i))
            if aval is None:
                ok = False
                break
            in_avals.append(aval)
        out_avals = []
        i = 0
        while (id(node), i) in ctx.shapes:
            out_avals.append(ctx.shapes[(id(node), i)])
            i += 1
        if not ok or not out_avals:
            skipped += 1
            continue
        flops = _node_flops(node, in_avals, out_avals)
        in_b = sum(_nelem(s) * dt.itemsize for s, dt in in_avals)
        out_b = sum(_nelem(s) * dt.itemsize for s, dt in out_avals)
        total_flops += flops
        total_bytes += in_b + out_b
        per_node.append((node.name, node.op.name, flops, in_b + out_b))
        # liveness: outputs materialize, then inputs whose last use is
        # this node die (variables/params are counted separately above);
        # under grad_accum only a microbatch slice of each batch-leading
        # activation is live inside the scan body
        for a_i, a in enumerate(out_avals):
            b = _live_bytes(id(node), a)
            live += b
            live_entries[(id(node), a_i)] = (node.name, b)
        if live > peak:
            peak = live
            peak_live = sorted(live_entries.values(),
                               key=lambda t: -t[1])[:10]
        # each dying entry frees ONCE even when consumed through several
        # edges of this node (x*x, concat(x, x))
        dying = {(id(src), i) for src, i in node.inputs
                 if not src.is_variable
                 and last_use.get((id(src), i)) == idx}
        for key in dying:
            aval = ctx.shapes.get(key)
            if aval is not None:
                live -= _live_bytes(key[0], aval)
                live_entries.pop(key, None)

    per_node.sort(key=lambda r: -r[2])
    act_peak = peak + grad_carry_bytes
    cost = {
        "flops": total_flops,
        "bytes_moved": total_bytes,
        "bound_bytes": bound_bytes,
        "peak_bytes": bound_bytes + act_peak,
        "activation_peak_bytes": act_peak,
        "grad_accum": accum,
        "grad_carry_bytes": grad_carry_bytes,
        "nodes_skipped": skipped,
        "top_nodes": [
            {"node": n, "op": o, "flops": f, "bytes": b}
            for n, o, f, b in per_node[:10]],
        "peak_live": [{"node": n, "bytes": b} for n, b in peak_live],
    }
    report.extras["cost"] = cost
    report.add(
        "cost-model", Severity.INFO,
        "%.3g GFLOP, %.3g MB moved, bound buffers %.3g MB, est. peak "
        "memory %.3g MB%s" % (
            total_flops / 1e9, total_bytes / 1e6, bound_bytes / 1e6,
            cost["peak_bytes"] / 1e6,
            " (%d nodes unresolved)" % skipped if skipped else ""),
        detail=cost)


GRAPH_PASSES.append(("cost-model", cost_model))


# -------------------------------------------------------------- entry point


def analyze_symbol(sym, input_shapes=None, input_dtypes=None,
                   context: str = "graph", calibrate_remat=None,
                   device=None, passes=None, grad_accum=None,
                   batch_inputs=None) -> Report:
    """Run the graph passes over ``sym``; returns a :class:`Report`.

    ``input_shapes``/``input_dtypes`` play the role of bind-time shapes
    (name -> shape/dtype); omitted names fall back to ``__shape__`` attrs
    and structural parameter derivation. ``calibrate_remat`` forces
    (True) or suppresses (False) the remat pass's block calibration,
    which runs one block on ``device`` (None: the card, as every entry
    point); None (the default) runs it only when a remat knob is on.
    ``passes`` optionally restricts the run to a subset of pass codes.
    ``grad_accum=N`` with ``batch_inputs`` (the data/label variable
    names) makes the cost model price the microbatch peak instead of
    the full batch — see :func:`cost_model`.
    """
    report = Report(context=context)
    ctx = GraphContext(sym, input_shapes, input_dtypes, device=device,
                       grad_accum=grad_accum, batch_inputs=batch_inputs)
    ctx.calibrate_remat = calibrate_remat
    for code, fn in GRAPH_PASSES:
        if passes is not None and code not in passes:
            continue
        fn(ctx, report)
    return report
