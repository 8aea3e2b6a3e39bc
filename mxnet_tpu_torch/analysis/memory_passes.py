"""Memory passes: activation liveness, remat opportunities, HBM budget.

The port of the reference's ``analysis/memory_passes.py``:

* ``remat-opportunity`` (graph pass, INFO) ranks long-lived,
  cheap-to-recompute activations: bytes held from the forward until the
  backward revisits them, against the FLOPs it would cost to recompute
  them. The report (``Report.extras["remat"]``) carries the candidates
  and a policy suggestion, which :mod:`..remat` applies; with a verified
  repeated chain, the suggestion's ``est_peak_saving`` is calibrated on
  one block (:func:`_predict_block_savings`);
* ``hbm-budget`` (graph pass, ERROR) — an enforceable per-device memory
  budget (``MXNET_TPU_ANALYZE_HBM_BUDGET``, e.g. ``16G``): when the
  static peak estimate (bound buffers + activation high-water) exceeds
  it, the finding names the offending arrays and ``strict`` mode rejects
  the bind before anything is allocated for it;
* :func:`analyze_program_memory` (program-level) — liveness over the
  aten graph a trace captured (:func:`.program_passes.trace`): the
  activation high-water plus the largest values live at the peak. This
  is the program twin of the graph cost model's ``peak_bytes``;
* :func:`check_reservation` — the budget check of a long-lived
  reservation (the serve KV cache's audit).

The budget knob is parsed with K/M/G/T suffixes (:func:`parse_bytes`).
"""
from __future__ import annotations

import operator
import re
from typing import Any, Dict, List, Tuple

from .findings import Report, Severity
from .graph_passes import GraphContext, _nelem, _node_flops, graph_pass

__all__ = ["analyze_program_memory", "parse_bytes", "check_reservation",
           "saved_bytes", "REMAT_CHEAP_FLOPS_PER_BYTE", "REMAT_TOP_N"]

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


def parse_bytes(spec) -> int:
    """``"16G"``/``"16GB"``/``"512MiB"``/``"1.5T"``/plain ints -> bytes
    (0 = unset). Raises ``ValueError`` naming the accepted grammar on
    garbage — callers on the bind path degrade to a finding instead of
    crashing the bind."""
    if spec is None:
        return 0
    s = str(spec).strip()
    if not s:
        return 0
    mult = 1
    m = re.match(r"^([0-9.eE+-]+)\s*([KMGT])(I?B)?$", s, re.IGNORECASE)
    if m:
        mult = {"K": 1 << 10, "M": 1 << 20, "G": 1 << 30,
                "T": 1 << 40}[m.group(2).upper()]
        s = m.group(1)
    try:
        val = int(float(s) * mult)
    except ValueError:
        raise ValueError(
            "cannot parse byte size %r (expected a number with an "
            "optional K/M/G/T[B|iB] suffix, e.g. '16G')" % (spec,))
    if val < 0:
        # a stray minus must not silently disable budget enforcement
        raise ValueError("byte size %r is negative" % (spec,))
    return val


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


# ------------------------------------------------------------- HBM budget


@graph_pass("hbm-budget")
def budget_pass(ctx: GraphContext, report: Report) -> None:
    """Reject binds whose static peak estimate cannot fit the budget.

    Reads ``Report.extras["cost"]`` (the cost-model pass runs first) and
    the ``MXNET_TPU_ANALYZE_HBM_BUDGET`` knob; the ERROR finding names
    the offending arrays — the largest bound buffers and the activations
    live at the high-water point — so the fix (shard it, remat it,
    shrink the batch) is actionable from the message alone.
    """
    from .. import config as _config
    raw = _config.get("MXNET_TPU_ANALYZE_HBM_BUDGET")
    try:
        budget = parse_bytes(raw)
    except ValueError as exc:
        # a config typo must not brick every bind in warn mode: degrade
        # to a finding that names the knob (strict mode still proceeds —
        # WARNING, not ERROR, because no memory claim was established)
        report.add(
            "hbm-budget", Severity.WARNING,
            "MXNET_TPU_ANALYZE_HBM_BUDGET=%r is unparseable (%s) — the "
            "memory budget is NOT being enforced" % (raw, exc))
        return
    if budget <= 0:
        return
    cost = report.extras.get("cost")
    if not cost:
        return
    peak = int(cost.get("peak_bytes") or 0)
    if peak <= budget:
        report.extras["hbm_budget"] = {"budget_bytes": budget,
                                       "peak_bytes": peak, "fits": True}
        return
    # name the offenders: biggest bound variables + biggest activations
    offenders: List[Tuple[str, str, int]] = []
    for node in ctx.nodes:
        aval = ctx.shapes.get((id(node), 0)) if node.is_variable else None
        if aval is not None:
            offenders.append((node.name, "bound", _nelem(aval[0])
                              * aval[1].itemsize))
    for rec in cost.get("top_nodes", ()):
        offenders.append((rec["node"], "op bytes-moved", int(rec["bytes"])))
    offenders.sort(key=lambda r: -r[2])
    offenders = offenders[:6]
    named = ", ".join("%s (%s, %.3g MB)" % (n, kind, b / 1e6)
                      for n, kind, b in offenders)
    report.extras["hbm_budget"] = {
        "budget_bytes": budget, "peak_bytes": peak, "fits": False,
        "offenders": [{"name": n, "kind": k, "bytes": b}
                      for n, k, b in offenders]}
    report.add(
        "hbm-budget", Severity.ERROR,
        "estimated peak memory %.3g MB exceeds MXNET_TPU_ANALYZE_HBM_BUDGET"
        " %.3g MB — largest contributors: %s (shard/remat them or shrink "
        "the batch; strict mode rejects this bind before it allocates)"
        % (peak / 1e6, budget / 1e6, named),
        detail={"budget_bytes": budget, "peak_bytes": peak})


# ------------------------------------------------ reservation budget


def check_reservation(name: str, nbytes: int,
                      detail: str = "") -> Dict[str, Any]:
    """Audit a long-lived device reservation (the serve KV cache) against
    ``MXNET_TPU_ANALYZE_HBM_BUDGET`` — the runtime twin of the bind-time
    ``hbm-budget`` pass for memory claimed OUTSIDE a graph bind.

    Returns ``{"budget_bytes", "reserved_bytes", "fits"}`` (budget 0 =
    unset, always fits). Over budget: ``MXNET_TPU_ANALYZE=strict`` raises
    :class:`~mxnet_tpu.base.MXNetError` NAMING the reservation before any
    device allocation; ``warn`` logs a WARNING with the same message.
    Callers gate the import of this module on the analyze knob, so the
    analyzer stays unimported when analysis is off.
    """
    import logging
    from .. import config as _config
    from ..base import MXNetError
    raw = _config.get("MXNET_TPU_ANALYZE_HBM_BUDGET")
    try:
        budget = parse_bytes(raw)
    except ValueError as exc:
        logging.getLogger(__name__).warning(
            "MXNET_TPU_ANALYZE_HBM_BUDGET=%r is unparseable (%s) — "
            "reservation %r is NOT being audited", raw, exc, name)
        return {"budget_bytes": 0, "reserved_bytes": int(nbytes),
                "fits": True}
    out = {"budget_bytes": budget, "reserved_bytes": int(nbytes),
           "fits": budget <= 0 or int(nbytes) <= budget}
    if out["fits"]:
        return out
    msg = ("reservation %r (%s%.3g MB) exceeds MXNET_TPU_ANALYZE_HBM_BUDGET"
           " %.3g MB — shrink max_sequences / the decode bucket set, or "
           "enable MXNET_TPU_SERVE_KV_INT8"
           % (name, (detail + ", ") if detail else "",
              nbytes / 1e6, budget / 1e6))
    if _config.get("MXNET_TPU_ANALYZE") == "strict":
        raise MXNetError("hbm-budget: " + msg)
    logging.getLogger(__name__).warning("hbm-budget: %s", msg)
    return out


# ------------------------------------------------- program-level liveness


def _node_values(node) -> List[int]:
    """Bytes of each value a graph node makes: one per tensor of its
    result (a multi-output op's tuple elements each), none for a
    ``getitem`` (it names an element of its source's result)."""
    from .program_passes import _tensors, nbytes
    if node.target is operator.getitem:
        return []
    return [nbytes(t) for t in _tensors(node.meta.get("val"))]


def _graph_peak(gm) -> Tuple[int, List[Dict[str, Any]]]:
    """Liveness high-water of one traced graph's *intermediates*
    (placeholders and constants excluded — those are the caller's and
    the closure's buffers). Each call node's values come alive when it
    runs and die after their last use; a value nothing uses dies right
    after the peak check. A ``getitem`` is not a use: its users use the
    element it names. Returns (peak_bytes, live-set snapshot at the
    peak)."""
    from .program_passes import _tensors, target_name
    nodes = [n for n in gm.graph.nodes if n.op == "call_function"]
    order = {n: i for i, n in enumerate(nodes)}

    def sources(user):
        """(producer, element) pairs a node consumes."""
        out = set()
        for a in user.all_input_nodes:
            if a.op == "call_function" and a.target is operator.getitem:
                src, idx = a.args[0], a.args[1]
                if src in order:
                    out.add((src, int(idx)))
            elif a in order:
                for i in range(len(_node_values(a))):
                    out.add((a, i))
        return out

    end = len(nodes)
    last: Dict[Tuple[Any, int], int] = {}
    for i, n in enumerate(nodes):
        for key in sources(n):
            last[key] = i
    out_node = next(n for n in gm.graph.nodes if n.op == "output")
    for key in sources(out_node):
        last[key] = end
    live = 0
    peak = 0
    alive: Dict[Tuple[Any, int], Tuple[int, str]] = {}
    at_peak: List[Dict[str, Any]] = []
    for i, n in enumerate(nodes):
        vals = _node_values(n)
        for j, b in enumerate(vals):
            live += b
            t = _tensors(n.meta.get("val"))[j]
            alive[(n, j)] = (b, "%s -> %s%s" % (
                target_name(n), str(t.dtype).replace("torch.", ""),
                list(t.shape)))
        if live > peak:
            peak = live
            at_peak = [{"bytes": b, "value": v} for b, v in
                       sorted(alive.values(), key=lambda r: -r[0])[:5]]
        for key in sources(n):
            if last.get(key) == i and key in alive:
                live -= alive.pop(key)[0]
        for j in range(len(vals)):
            # values nothing ever consumes die right after the peak
            # check — leaving them "live" to the end would inflate every
            # later point
            if (n, j) not in last and (n, j) in alive:
                live -= alive.pop((n, j))[0]
    return peak, at_peak


def analyze_program_memory(fn, *args, context: str = "program-memory",
                           **kwargs) -> Report:
    """Trace ``fn(*args, **kwargs)`` (:func:`.program_passes.trace`, on
    fake tensors) and report its activation high-water by liveness over
    the traced aten graph.

    ``fn`` may be a function of tensors or an already-made
    ``GraphModule``. ``Report.extras["program_memory"]`` carries
    ``activation_peak_bytes`` (intermediates only), ``arg_bytes`` (the
    caller's input buffers), ``const_bytes`` (closure constants),
    ``peak_bytes`` (their sum — comparable to the graph cost model's),
    ``n_eqns`` (call nodes) and ``top_live`` — the largest values alive
    at the peak, named by producing op. Every node's result counts at
    its full size, a view's too, as the reference counts every jaxpr
    equation's output.
    """
    import torch
    from .program_passes import _constants, _tensors, nbytes, trace

    report = Report(context=context)
    gm = fn if isinstance(fn, torch.fx.GraphModule) \
        else trace(fn, *args, **kwargs)[0]
    peak, top_live = _graph_peak(gm)
    arg_bytes = sum(nbytes(t) for n in gm.graph.nodes
                    if n.op == "placeholder"
                    for t in _tensors(n.meta.get("val")))
    const_bytes = sum(nbytes(c) for _, c in _constants(gm))
    mem = {
        "activation_peak_bytes": int(peak),
        "arg_bytes": int(arg_bytes),
        "const_bytes": int(const_bytes),
        "peak_bytes": int(peak + arg_bytes + const_bytes),
        "n_eqns": sum(n.op == "call_function" for n in gm.graph.nodes),
        "top_live": top_live,
    }
    report.extras["program_memory"] = mem
    report.add(
        "program-memory", Severity.INFO,
        "activation high-water %.3g MB over %d nodes (+%.3g MB args); "
        "largest at peak: %s"
        % (peak / 1e6, mem["n_eqns"], arg_bytes / 1e6,
           ", ".join("%s (%.3g MB)" % (r["value"], r["bytes"] / 1e6)
                     for r in top_live[:3]) or "n/a"),
        detail=mem)
    return report
