"""Scan-over-layers: the repeated homogeneous blocks of a Symbol, found
and verified at bind, run layer by layer as one plan.

The port's copy of the reference's ``symbol/scan.py``. The reference
lowers a verified chain of isomorphic blocks through one
``jax.lax.scan`` over the per-layer parameters stacked on a leading
axis, so a deep model traces and compiles one block. PyTorch runs
eagerly and compiles nothing, so :meth:`ScanPlan.execute` runs the pre
nodes, then each layer's own segment with that layer's own parameters
(nothing is stacked: the reference stacks only because ``lax.scan``
needs its xs), then the post nodes. The result is bit for bit the
unrolled graph's. What the plan gives the port is the block boundary:
``body_wrapper``, the hook per-block rematerialization wraps each layer
in (:mod:`..remat`), and ``var_lists``, the per-layer parameter
families ``Module`` counts as update groups.

Detection is the reference's, unchanged (``MXNET_TPU_SCAN_LAYERS``,
default ``auto``):

1. **Layer families** from parameter names: variables whose names
   differ only in one integer position form an indexed family
   (``layer3_att_qkv_weight``); all families must agree on one index
   set, the layer axis.
2. **Segmentation**: a node belongs to layer *i* when the deepest layer
   family it transitively depends on is *i*, which places the
   auto-named residual adds in the right block.
3. **Verification**: the segments must be pairwise isomorphic, matched
   node by node from each block's single output backwards (same op,
   attrs and wiring), with exactly one streaming activation entering
   each block, per-layer parameters mapping position for position with
   equal shapes and dtypes, and shared values (a causal mask computed
   once in the prefix, a weight every block shares) the same graph
   entry everywhere; layer-invariant copies of a prefix computation
   (each layer's own causal mask) read the template's copy. The last
   raw segment also holds the suffix (final LayerNorm, head), trimmed
   by matching the template against it.

Anything that does not verify (ResNet's stage transitions, a shared
weight unrolled, cross-layer skips, BatchNorm's aux states inside a
block, an interior block output consumed outside) falls back to the
unrolled path silently; falling back is always correct.

Ops that draw from the key chain (``Dropout``, ``rrelu``, the samplers)
run in the unrolled program's order inside each layer, so a seeded run
draws the same masks with the plan and without it.
"""
from __future__ import annotations

import logging
import re
from typing import Any, Dict, List, Optional, Tuple

__all__ = ["ScanPlan", "build_scan_plan", "DEFAULT_MIN_REPEAT"]

log = logging.getLogger(__name__)

# auto mode only plans chains at least this deep
# (override: MXNET_TPU_SCAN_LAYERS=<int>)
DEFAULT_MIN_REPEAT = 4

# candidate out-node tries when trimming the suffix off the last raw
# segment (every residual add shares the out node's op)
_MAX_OUT_CANDIDATES = 8

_INT_RE = re.compile(r"\d+")

# ops that draw from the key chain (the reference's ``needs_rng`` ops
# that are not samplers); samplers are ``OpDef.is_random``
_RNG_OPS = frozenset(("Dropout", "LeakyReLU", "RNN",
                      "stochastic_activation_pruning"))


def _draws_rng(op) -> bool:
    return bool(getattr(op, "is_random", False)) or op.name in _RNG_OPS


class ScanPlan:
    """What :func:`..executor.graph_function` needs to run the repeated
    chain layer by layer: the execution split (pre / layers / post),
    the template block's nodes and each layer's own, and the per-layer
    parameter families."""

    __slots__ = (
        "n_layers", "template", "pre_nodes", "post_nodes",
        "stream_in", "out_idx", "var_lists", "scanned_ids",
        "final_out_key", "layer_table",
        "layer_nodes", "body_wrapper",
    )

    def __init__(self):
        self.n_layers = 0
        self.template: List[Any] = []        # seg-0 nodes, topo order
        self.pre_nodes: List[Any] = []       # nodes the chain depends on
        self.post_nodes: List[Any] = []      # nodes depending on it
        self.stream_in: Tuple[Any, int] = None   # entry feeding block 0
        self.out_idx = 0                     # block output's out index
        # id(template var node) -> [per-layer arg names, layer order]
        self.var_lists: Dict[int, List[str]] = {}
        self.scanned_ids: set = set()
        # layer_table[layer][t_pos] = id of layer's node for template
        # position t_pos (template itself is layer 0); layer_nodes holds
        # the nodes themselves
        self.layer_table: List[List[int]] = []
        self.layer_nodes: List[List[Any]] = []
        # vals[] key the chain's result lands under: the LAST layer's out
        # entry, so post nodes look it up exactly like unrolled code
        self.final_out_key: Tuple[int, int] = None
        # optional transform of one layer's body, ``body(carry, layer)
        # -> block output``: the applied-remat hook (remat.wrap runs each
        # block under torch.utils.checkpoint)
        self.body_wrapper = None

    # ------------------------------------------------------------ checks
    def check_bindings(self, shapes: Dict[str, tuple],
                       dtypes: Dict[str, Any]) -> bool:
        """Per-layer parameters must agree on shape and dtype across
        layers (the reference's stackability check, kept so that both
        packages fall back on the same bindings)."""
        for names in self.var_lists.values():
            s0, d0 = shapes.get(names[0]), dtypes.get(names[0])
            if s0 is None:
                return False
            for nm in names[1:]:
                if shapes.get(nm) != s0 or dtypes.get(nm) != d0:
                    return False
        return True

    # --------------------------------------------------------- execution
    def execute(self, vals, args, run_node):
        """Run the chain: each layer's own nodes in template order, its
        inputs mapped through the template (the streaming activation,
        the layer's own parameters, values of this layer's segment, or
        the template's shared pre values), the last block's output landed
        under ``final_out_key``. ``vals`` already holds every pre-node
        output; ``args`` is the full name -> tensor argument dict;
        ``run_node(node, ins)`` runs one node and returns its outputs."""
        template = self.template
        stream_key = (id(self.stream_in[0]), self.stream_in[1])
        out_pos = self._out_pos()
        tvar_ids = set(self.var_lists)
        # the shared values the layers read, taken out of ``vals`` so that
        # a wrapped body (held by its checkpoint until the backward) keeps
        # only these alive
        shared = {(id(src), ei): vals[(id(src), ei)] for t in template
                  for src, ei in t.inputs
                  if (id(src), ei) in vals and (id(src), ei) != stream_key
                  and id(src) not in tvar_ids}

        def body(carry, layer):
            nodes = self.layer_nodes[layer]
            seg: Dict[Tuple[int, int], Any] = {}
            for t, node in zip(template, nodes):
                ins = []
                for (tsrc, ti), (src, ei) in zip(t.inputs, node.inputs):
                    k = (id(src), ei)
                    if k in seg:
                        ins.append(seg[k])
                    elif (id(tsrc), ti) == stream_key:
                        ins.append(carry)
                    elif id(tsrc) in tvar_ids:
                        ins.append(args[src.name])
                    else:
                        # shared value, computed by the pre nodes (the
                        # same entry for every layer, verified at build)
                        ins.append(shared[(id(tsrc), ti)])
                for i, o in enumerate(run_node(node, ins)):
                    seg[(id(node), i)] = o
            return seg[(id(nodes[out_pos]), self.out_idx)]

        if self.body_wrapper is not None:
            body = self.body_wrapper(body)
        carry = vals[stream_key]
        for layer in range(self.n_layers):
            carry = body(carry, layer)
        vals[self.final_out_key] = carry

    def _out_pos(self) -> int:
        """Template position of the block's output node."""
        final_id = self.final_out_key[0]
        last = self.layer_table[-1]
        return last.index(final_id)


# ------------------------------------------------------ plan construction


def _attrs_equal(a, b) -> bool:
    try:
        if a.attrs == b.attrs and a.str_attrs == b.str_attrs:
            return True
    except Exception:                                       # noqa: BLE001
        pass
    try:
        return repr(sorted(a.attrs.items())) == \
            repr(sorted(b.attrs.items())) and \
            repr(sorted(a.str_attrs.items())) == \
            repr(sorted(b.str_attrs.items()))
    except Exception:                                       # noqa: BLE001
        return False


class _Reject(Exception):
    """Internal: this graph does not verify; fall back to unrolled."""


def _var_families(variables):
    """Group per-layer parameters by name templates: for each integer
    position in a variable name, starring it out yields a template; a
    template shared by >=2 variables at distinct indices is a family.
    All families must agree on ONE index set (the layer axis). Returns
    (layer_sets, L) with layer_sets[i] = the variables of layer i, or
    None."""
    for pos in range(4):
        templates: Dict[str, Dict[int, Any]] = {}
        for v in variables:
            ints = list(_INT_RE.finditer(v.name))
            if len(ints) <= pos:
                continue
            m = ints[pos]
            tpl = v.name[:m.start()] + "<*>" + v.name[m.end():]
            templates.setdefault(tpl, {})[int(m.group())] = v
        families = {t: mbrs for t, mbrs in templates.items()
                    if len(mbrs) >= 2}
        if not families:
            continue
        index_sets = {frozenset(m) for m in families.values()}
        if len(index_sets) != 1:
            continue
        idxs = sorted(next(iter(index_sets)))
        layer_sets: List[List[Any]] = [[] for _ in idxs]
        for mbrs in families.values():
            for raw_idx, v in mbrs.items():
                layer_sets[idxs.index(raw_idx)].append(v)
        return layer_sets, len(idxs)
    return None


def build_scan_plan(symbol, min_repeat: int = DEFAULT_MIN_REPEAT,
                    shapes: Optional[Dict[str, tuple]] = None,
                    dtypes: Optional[Dict[str, Any]] = None
                    ) -> Optional["ScanPlan"]:
    """Detect and verify a repeated homogeneous chain in ``symbol``.

    Returns a :class:`ScanPlan`, or ``None`` when no chain of at least
    ``min_repeat`` verified-isomorphic blocks exists (the caller then
    uses the unrolled path). When ``shapes``/``dtypes`` are given,
    per-layer parameters are also checked stackable."""
    try:
        return _build(symbol, min_repeat, shapes, dtypes)
    except _Reject:
        return None
    except Exception:                                       # noqa: BLE001
        # detection must never take down a bind
        log.debug("scan: plan construction failed", exc_info=True)
        return None


def _build(symbol, min_repeat, shapes, dtypes):
    from .symbol import _topo_order

    nodes = _topo_order(symbol._entries)
    by_id = {id(n): n for n in nodes}
    variables = [n for n in nodes if n.is_variable]
    fam = _var_families(variables)
    if fam is None:
        return None
    layer_sets, L = fam
    if L < max(2, int(min_repeat)):
        return None

    var_layer: Dict[int, int] = {}
    for i, vs in enumerate(layer_sets):
        for v in vs:
            if v.is_aux:
                raise _Reject()  # aux-state threading unsupported
            var_layer[id(v)] = i

    # ---- segmentation: deepest layer family each node depends on
    maxlayer: Dict[int, int] = {}
    for n in nodes:
        if n.is_variable:
            ml = var_layer.get(id(n), -1)
        else:
            ml = -1
            for src, _ in n.inputs:
                ml = max(ml, maxlayer[id(src)])
        maxlayer[id(n)] = ml
    segs: List[List[Any]] = [[] for _ in range(L)]
    for n in nodes:
        if not n.is_variable and maxlayer[id(n)] >= 0:
            segs[maxlayer[id(n)]].append(n)       # topo order preserved
    if any(not s for s in segs):
        raise _Reject()

    consumers: Dict[Tuple[int, int], List[Any]] = {}
    for n in nodes:
        for src, ei in n.inputs:
            consumers.setdefault((id(src), ei), []).append(n)

    def escapes(seg):
        """Entries of ``seg`` consumed outside it, plus symbol outputs
        pointing into it."""
        seg_ids = {id(n) for n in seg}
        outs = []
        for (nid, ei), cons in consumers.items():
            if nid in seg_ids and any(id(c) not in seg_ids
                                      for c in cons):
                outs.append((by_id[nid], ei))
        for n, ei in symbol._entries:
            if id(n) in seg_ids and (n, ei) not in outs:
                outs.append((n, ei))
        return outs

    # interior segments: exactly one escaping value, consumed only by
    # that segment itself and the NEXT one
    out_entries: List[Tuple[Any, int]] = []
    for i in range(L - 1):
        outs = escapes(segs[i])
        if len(outs) != 1:
            raise _Reject()
        node, ei = outs[0]
        allowed = {id(n) for n in segs[i]} | {id(n) for n in segs[i + 1]}
        cons = consumers.get((id(node), ei), [])
        if not cons or any(id(c) not in allowed for c in cons):
            raise _Reject()
        if any(n is node and e == ei for n, e in symbol._entries):
            raise _Reject()       # internal block output exposed
        out_entries.append((node, ei))

    # layer-invariant equivalence of prefix entries: blocks often
    # rebuild identical constant subgraphs per layer (the causal mask's
    # arange/compare chain) — structurally equal, depending on nothing
    # layer-indexed, and RNG-free, they compute the same value, so the
    # scan body can read the template's copy for every layer
    _equiv_memo: Dict[Tuple[int, int], bool] = {}

    def _equiv_outside(a, b) -> bool:
        if a is b:
            return True
        key = (id(a), id(b))
        hit = _equiv_memo.get(key)
        if hit is not None:
            return hit
        ok = (not a.is_variable and not b.is_variable
              and maxlayer[id(a)] == -1 and maxlayer[id(b)] == -1
              and a.op is b.op and not _draws_rng(a.op)
              and len(a.inputs) == len(b.inputs)
              and _attrs_equal(a, b))
        if ok:
            for (asrc, ai), (bsrc, bi) in zip(a.inputs, b.inputs):
                if ai != bi or not _equiv_outside(asrc, bsrc):
                    ok = False
                    break
        _equiv_memo[key] = ok
        return ok

    # ---- pairwise matching from block outputs backward
    def match_pair(a_root, b_root, seg_b_ids, b_stream, layer_i):
        """Map the template onto segment ``layer_i``. ``b_stream`` is
        the entry feeding that segment from outside (the previous
        block's output). Returns (node_map a->b, var_map a->b,
        template-side stream entry or None)."""
        a_ids = {id(n) for n in segs[0]}
        node_map: Dict[int, Any] = {}
        var_map: Dict[int, Any] = {}
        a_stream: List[Tuple[Any, int]] = []

        def match_entry(ae, be):
            (an, ai), (bn, bi) = ae, be
            if ai != bi:
                raise _Reject()
            a_in, b_in = id(an) in a_ids, id(bn) in seg_b_ids
            if a_in != b_in:
                raise _Reject()
            if a_in:
                match_node(an, bn)
                return
            if an is bn:
                return                       # shared value / variable
            # THE stream crossing: the previous block's output on the b
            # side; the a side is whatever feeds the template (an op
            # output, or a plain variable — the chain may start at the
            # graph input)
            if b_stream is not None and bn is b_stream[0] \
                    and bi == b_stream[1]:
                if a_stream and a_stream[0] != (an, ai):
                    raise _Reject()
                if not a_stream:
                    a_stream.append((an, ai))
                return
            if an.is_variable != bn.is_variable:
                raise _Reject()
            if an.is_variable:
                # per-layer parameter pair: template side must belong
                # to layer 0, the b side to THIS layer
                if var_layer.get(id(an)) != 0 or \
                        var_layer.get(id(bn)) != layer_i:
                    raise _Reject()
                prev = var_map.setdefault(id(an), bn)
                if prev is not bn:
                    raise _Reject()
                return
            if _equiv_outside(an, bn):
                return    # layer-invariant prefix computation: the
                          # body reads the template's copy (value-equal)
            raise _Reject()

        def match_node(a, b):
            prev = node_map.get(id(a))
            if prev is not None:
                if prev is not b:
                    raise _Reject()
                return
            if a.is_variable or b.is_variable:
                raise _Reject()
            if a.op is not b.op or len(a.inputs) != len(b.inputs):
                raise _Reject()
            if not _attrs_equal(a, b):
                raise _Reject()
            node_map[id(a)] = b
            for ae, be in zip(a.inputs, b.inputs):
                match_entry(ae, be)

        match_node(a_root, b_root)
        return node_map, var_map, (a_stream[0] if a_stream else None)

    template_seg = segs[0]
    n_tmpl = len(template_seg)
    t_out_node, t_out_idx = out_entries[0]
    maps: List[Dict[int, Any]] = []
    vmaps: List[Dict[int, Any]] = []
    t_stream = None

    for i in range(1, L - 1):
        if out_entries[i][1] != t_out_idx:
            raise _Reject()
        nm, vm, st = match_pair(t_out_node, out_entries[i][0],
                                {id(n) for n in segs[i]},
                                out_entries[i - 1], i)
        if len(nm) != n_tmpl or len(nm) != len(segs[i]):
            raise _Reject()
        if st is not None:
            if t_stream is None:
                t_stream = st
            elif st != t_stream:
                raise _Reject()
        maps.append(nm)
        vmaps.append(vm)

    # last raw segment = block L-1 + suffix; find the block's out node
    # by trying template-shaped candidates from the back
    last_seg = segs[L - 1]
    last_ids = {id(n) for n in last_seg}
    tried = 0
    last_map = last_vmap = last_out = None
    for cand in reversed(last_seg):
        if cand.op is not t_out_node.op:
            continue
        tried += 1
        if tried > _MAX_OUT_CANDIDATES:
            break
        try:
            nm, vm, st = match_pair(t_out_node, cand, last_ids,
                                    out_entries[L - 2], L - 1)
        except _Reject:
            continue
        if len(nm) != n_tmpl:
            continue
        if st is not None and t_stream is not None and st != t_stream:
            continue
        last_map, last_vmap, last_out = nm, vm, (cand, t_out_idx)
        if st is not None and t_stream is None:
            t_stream = st
        break
    if last_map is None:
        raise _Reject()
    maps.append(last_map)
    vmaps.append(last_vmap)

    if t_stream is None:
        raise _Reject()   # no block reads its streaming input: no chain

    # the matched block inside the last raw segment must escape ONLY
    # through its out entry
    matched_last = {id(b) for b in last_map.values()}
    for (nid, ei), cons in consumers.items():
        if nid in matched_last and (nid, ei) != (id(last_out[0]),
                                                 last_out[1]):
            if any(id(c) not in matched_last for c in cons):
                raise _Reject()
    for n, ei in symbol._entries:
        if id(n) in matched_last and (n is not last_out[0]
                                      or ei != last_out[1]):
            raise _Reject()

    # ---- template nodes must be pure tensor ops (no aux states)
    for n in template_seg:
        if getattr(n.op, "num_aux", 0):
            raise _Reject()

    # ---- assemble
    plan = ScanPlan()
    plan.n_layers = L
    plan.template = list(template_seg)
    plan.stream_in = t_stream
    plan.out_idx = t_out_idx

    all_maps = [{id(t): t for t in template_seg}] + maps
    for layer in range(L):
        m = all_maps[layer]
        plan.layer_nodes.append([m[id(t)] for t in template_seg])
        row = [id(m[id(t)]) for t in template_seg]
        plan.layer_table.append(row)
        plan.scanned_ids |= set(row)

    tvar_ids = set()
    for vm in vmaps:
        tvar_ids |= set(vm)
    tvar_nodes = {id(v): v for v in layer_sets[0]}
    matched_vars = set()
    for tv in tvar_ids:
        tnode = tvar_nodes.get(tv)
        if tnode is None:
            raise _Reject()
        names = [tnode.name]
        matched_vars.add(tv)
        for vm in vmaps:
            mapped = vm.get(tv)
            if mapped is None:
                raise _Reject()   # a layer never consumed this param
            names.append(mapped.name)
            matched_vars.add(id(mapped))
        plan.var_lists[tv] = names
    # a per-layer var that is consumed somewhere but never matched
    # would silently lose its gradient path — reject
    for vs in layer_sets:
        for v in vs:
            if (id(v), 0) in consumers and id(v) not in matched_vars:
                raise _Reject()

    last_out_node = last_map[id(t_out_node)]
    plan.final_out_key = (id(last_out_node), t_out_idx)

    # ---- execution split: pre = not scanned & not depending on the
    # scan; post = the rest (suffix + anything downstream)
    dep_scan: Dict[int, bool] = {}
    for n in nodes:
        if id(n) in plan.scanned_ids:
            dep_scan[id(n)] = True
        else:
            dep_scan[id(n)] = any(dep_scan[id(src)]
                                  for src, _ in n.inputs)
    stacked_names = {nm for names in plan.var_lists.values()
                     for nm in names}
    pre_nodes = [
        n for n in nodes
        if id(n) not in plan.scanned_ids and not dep_scan[id(n)]
        and not (n.is_variable and n.name in stacked_names)]
    plan.post_nodes = [n for n in nodes
                       if id(n) not in plan.scanned_ids
                       and dep_scan[id(n)]]

    # prune prefix work the scan made dead: layers 1..L-1's copies of
    # layer-invariant subgraphs (the per-layer causal masks) are never
    # read once the body aliases them to the template's — without
    # pruning, the prefix trace would still grow O(L). Roots that must
    # stay: the template's outside inputs, the stream, everything post
    # nodes and symbol outputs read, and any aux-writing op (its
    # new_aux side effect is part of unrolled semantics).
    keep_roots = {id(plan.stream_in[0])}
    for t in template_seg:
        for src, _ in t.inputs:
            if id(src) not in plan.scanned_ids and \
                    not (src.is_variable and src.name in stacked_names):
                keep_roots.add(id(src))
    for n in plan.post_nodes:
        for src, _ in n.inputs:
            keep_roots.add(id(src))
    for n, _ in symbol._entries:
        keep_roots.add(id(n))
    for n in pre_nodes:
        if not n.is_variable and getattr(n.op, "num_aux", 0):
            keep_roots.add(id(n))
    keep: set = set()
    stack = [by_id[r] for r in keep_roots if r in by_id]
    while stack:
        n = stack.pop()
        if id(n) in keep:
            continue
        keep.add(id(n))
        for src, _ in n.inputs:
            stack.append(src)
    plan.pre_nodes = [n for n in pre_nodes
                      if n.is_variable or id(n) in keep]

    # post nodes may only read pre values, other post values, or the
    # final block output — a reference into a scanned interior (e.g. a
    # suffix node reading block L-2's output) has no materialized value
    visible = {id(n) for n in plan.pre_nodes} | \
        {id(n) for n in plan.post_nodes}
    for n in plan.post_nodes:
        for src, ei in n.inputs:
            if id(src) in visible:
                continue
            if (id(src), ei) == plan.final_out_key:
                continue
            raise _Reject()
    # symbol outputs likewise
    for n, ei in symbol._entries:
        if id(n) in visible or (id(n), ei) == plan.final_out_key:
            continue
        raise _Reject()

    if shapes is not None and not plan.check_bindings(shapes,
                                                      dtypes or {}):
        raise _Reject()
    return plan
