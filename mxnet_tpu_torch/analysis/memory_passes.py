"""Memory passes: the ``remat-opportunity`` pass and its calibration.

The part of the reference's ``analysis/memory_passes.py`` that
``MXNET_TPU_REMAT=auto`` needs. ``remat-opportunity`` (graph pass,
INFO) ranks long-lived, cheap-to-recompute activations: bytes held from
the forward until the backward revisits them, against the FLOPs it
would cost to recompute them. The report (``Report.extras["remat"]``)
carries the candidates and a policy suggestion, which :mod:`..remat`
applies; with a verified repeated chain, the suggestion's
``est_peak_saving`` is calibrated on one block
(:func:`_predict_block_savings`). The HBM budget and the program
liveness walk are queue A10.
"""
from __future__ import annotations

from typing import Any, Dict, List, Tuple

from .findings import Report, Severity
from .graph_passes import GraphContext, _nelem, _node_flops, graph_pass

__all__ = ["REMAT_CHEAP_FLOPS_PER_BYTE", "REMAT_TOP_N", "saved_bytes"]

# recompute cost ceiling for a "cheap" activation: recomputing must cost
# no more than this many FLOPs per byte saved (elementwise/norm/softmax
# chains are ~0.25-8; contractions are 2*K/itemsize and land here only
# for tiny K)
REMAT_CHEAP_FLOPS_PER_BYTE = 16.0
# candidates surfaced as findings (the full ranked list rides in extras)
REMAT_TOP_N = 5
# activations smaller than this are not worth a finding (bytes)
REMAT_MIN_BYTES = 4096

# ops whose outputs a dot-saveable policy would still SAVE (contraction
# outputs); when these dominate the candidate list only the per-block
# nothing_saveable form recovers the bytes
_CONTRACTION_OPS = {"FullyConnected", "dot", "batch_dot", "linalg_gemm2",
                    "Convolution", "Convolution_v1", "Deconvolution"}


# ------------------------------------------------------- remat opportunity


@graph_pass("remat-opportunity")
def remat_pass(ctx: GraphContext, report: Report) -> None:
    """Rank activations by bytes-held-until-backward vs recompute FLOPs.

    In a training bind every forward intermediate is a residual: it is
    produced at topo position p and must survive until the backward pass
    revisits it — the earlier it is produced, the longer it occupies HBM.
    An activation is a remat candidate when recomputing it from its own
    inputs is cheap (``REMAT_CHEAP_FLOPS_PER_BYTE``). The emitted
    suggestion is a concrete ``jax.checkpoint`` policy:

    * candidates dominated by contraction outputs (matmul/conv) need the
      per-block ``nothing_saveable`` form — a dots-saveable policy would
      keep exactly the bytes we want back;
    * elementwise/norm/softmax-dominated candidates are recovered by
      ``dots_with_no_batch_dims_saveable`` (keep matmuls, recompute the
      cheap tail) — the policy ``MXNET_EXEC_ENABLE_REMAT`` applies.
    """
    if ctx.has_cycle or not ctx.shapes:
        return
    n_nodes = len(ctx.nodes)
    order = {id(n): i for i, n in enumerate(ctx.nodes)}
    candidates: List[Dict[str, Any]] = []
    for node in ctx.nodes:
        if node.is_variable:
            continue
        in_avals = [ctx.shapes.get((id(src), i)) for src, i in node.inputs]
        out_avals = []
        i = 0
        while (id(node), i) in ctx.shapes:
            out_avals.append(ctx.shapes[(id(node), i)])
            i += 1
        if not out_avals or any(a is None for a in in_avals):
            continue
        out_bytes = sum(_nelem(s) * dt.itemsize for s, dt in out_avals)
        if out_bytes < REMAT_MIN_BYTES:
            continue
        recompute = _node_flops(node, in_avals, out_avals)
        flops_per_byte = recompute / float(out_bytes)
        if flops_per_byte > REMAT_CHEAP_FLOPS_PER_BYTE:
            continue
        # residual lifetime: from production to the end of the forward
        # (the backward walks the graph in reverse, so an activation
        # produced at p is held for ~(n_nodes - p) of the program)
        span = n_nodes - order[id(node)]
        candidates.append({
            "node": node.name, "op": node.op.name,
            "bytes": int(out_bytes), "recompute_flops": int(recompute),
            "flops_per_byte": round(flops_per_byte, 3),
            "live_span": int(span),
            "shape": [list(s) for s, _ in out_avals],
        })
    candidates.sort(key=lambda c: (-c["bytes"], -c["live_span"]))
    if not candidates:
        return
    top = candidates[:REMAT_TOP_N]
    total_bytes = sum(c["bytes"] for c in candidates)
    # bytes-dominance, as documented: only when contraction outputs hold
    # the majority of the recoverable top-N bytes is the aggressive
    # per-block nothing_saveable worth it — a dots-saveable policy would
    # keep exactly those bytes. Otherwise keep the matmuls and recompute
    # the cheap elementwise/norm tail.
    top_bytes = sum(c["bytes"] for c in top) or 1
    contraction_bytes = sum(c["bytes"] for c in top
                            if c["op"] in _CONTRACTION_OPS)
    policy = "nothing_saveable" if contraction_bytes * 2 > top_bytes \
        else "dots_with_no_batch_dims_saveable"
    suggestion = {
        "policy": policy,
        "wrap": "repeated_block",
        "hint": "wrap each repeated block (layer) under the %s policy "
                "(MXNET_TPU_REMAT=auto applies it to each block of the "
                "scan plan)" % policy,
        "est_bytes_saved": int(total_bytes),
    }
    # calibrated peak prediction: when the graph has a verified repeated
    # chain (the scan-plan detector), measure ONE block's saved tensors
    # with and without the policy and scale by depth — the number
    # applied per-block remat is held to (within 25%)
    est_peak = _predict_block_savings(ctx, policy)
    if est_peak is not None:
        suggestion["est_peak_saving"] = int(est_peak)
    report.extras["remat"] = {"candidates": candidates,
                              "suggestion": suggestion}
    for c in top:
        report.add(
            "remat-opportunity", Severity.INFO,
            "%s output (%s, %.3g MB) is held from topo position %d to the "
            "backward but costs only %.3g FLOP/byte to recompute — "
            "rematerialize it (suggested policy: %s)"
            % (c["op"], "x".join(map(str, c["shape"][0])), c["bytes"] / 1e6,
               n_nodes - c["live_span"], c["flops_per_byte"], policy),
            node=c["node"], op=c["op"], detail=c)


def saved_bytes(fn, inputs, policy=None) -> int:
    """Bytes ``fn(*inputs)`` leaves saved for its backward: with
    ``policy`` None, each distinct storage autograd packs
    (``saved_tensors_hooks``); with a :class:`..remat.Policy`, what its
    checkpoint keeps, the distinct storages of the outputs of the ops
    the policy saves (none for ``nothing_saveable``). The storages of
    ``inputs`` (and of tensors they hold) are not counted: they are
    alive either way."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_leaves

    skip = {t.untyped_storage().data_ptr() for t in tree_leaves(inputs)
            if isinstance(t, torch.Tensor)}
    seen: Dict[int, int] = {}
    held: List[Any] = []     # alive to the end, as the backward holds them

    def note(t):
        if isinstance(t, torch.Tensor) and t.device.type != "meta":
            st = t.untyped_storage()
            if st.data_ptr() not in skip:
                seen[st.data_ptr()] = st.nbytes()
                held.append(t)

    if policy is None:
        def pack(t):
            note(t)
            return t

        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            fn(*inputs)
    else:
        class _Kept(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                out = func(*args, **(kwargs or {}))
                if policy.saves_output(func):
                    for t in tree_leaves(out):
                        note(t)
                return out

        with _Kept():
            fn(*inputs)
    return sum(seen.values())


def _predict_block_savings(ctx: GraphContext, policy_name: str):
    """Predicted drop in saved activation bytes from applying
    ``policy_name`` per repeated block: detect the chain (the scan-plan
    machinery), run ONE block on zeros of the bound shapes on
    ``ctx.device`` under autograd, and compare the bytes it leaves saved
    plain and under the policy (:func:`saved_bytes`), scaled by the layer
    count. Saved sizes depend on shapes, not values, so zeros suffice.
    Returns None when no verified chain exists or anything fails.

    Gated: a plain analysis must not execute compute, so the calibration
    runs only when a remat knob is on (the consumer of the number) or
    when the caller forces it (``analyze_symbol(calibrate_remat=True)``)."""
    want = getattr(ctx, "calibrate_remat", None)
    if want is None:
        from ..remat import remat_knob_on
        want = remat_knob_on()
    if not want:
        return None
    try:
        import torch
        from .. import random as _random
        from ..context import resolve_device
        from ..remat import Policy, set_current_op
        from ..symbol.scan import build_scan_plan
        from ..symbol.symbol import run_node
        plan = build_scan_plan(ctx.sym, min_repeat=2)
        if plan is None:
            return None
        device = resolve_device(ctx.device)

        def zeros(key, grad=False):
            shape, dt = ctx.shapes[key]
            return torch.zeros(shape, dtype=dt, device=device,
                               requires_grad=grad and dt.is_floating_point)

        stream_key = (id(plan.stream_in[0]), plan.stream_in[1])
        out_key = (plan.layer_table[0][plan._out_pos()], plan.out_idx)
        tvars = {tid: zeros((tid, 0), True) for tid in plan.var_lists}
        shared: Dict[Tuple[int, int], Any] = {}
        for node in plan.template:
            for src, ei in node.inputs:
                k = (id(src), ei)
                if k != stream_key and id(src) not in tvars and \
                        id(src) not in plan.scanned_ids:
                    shared[k] = zeros(k)
        x0 = zeros(stream_key, True)

        def block(x):
            seg: Dict[Tuple[int, int], Any] = {}
            for node in plan.template:
                ins = []
                for src, ei in node.inputs:
                    k = (id(src), ei)
                    ins.append(x if k == stream_key else seg[k]
                               if k in seg else tvars[id(src)]
                               if id(src) in tvars else shared[k])
                set_current_op(node.op.name)
                for i, o in enumerate(run_node(node, ins, True, device)):
                    seg[(id(node), i)] = o
            return seg[out_key]

        inputs = (x0, list(tvars.values()), list(shared.values()))
        key = _random.current_key()
        try:
            with torch.enable_grad():
                plain = saved_bytes(lambda *a: block(x0), inputs)
                kept = saved_bytes(lambda *a: block(x0), inputs,
                                   Policy(policy_name))
        finally:
            _random.set_key(key)
        return plan.n_layers * max(0, plain - kept)
    except Exception:                                       # noqa: BLE001
        return None
