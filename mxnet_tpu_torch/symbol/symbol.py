"""Symbol — the declarative graph API, over the port's op registry.

The port's counterpart of the reference's ``symbol/symbol.py``, as far
as the ported paths need it: ``Variable``, one function per op,
operators (``x + h``, ``future * -1e9``), ``list_arguments`` /
``list_outputs``, ``infer_shape`` and JSON save and load.

* A node of an op with several outputs (``OpDef.num_outputs``: a user
  kernel's ``split``, a custom op) is a Symbol with one entry per
  output, named ``<name>_output``, ``<name>_output1``, ... as in the
  reference; ``sym[i]`` (or ``sym["<name>_output1"]``) is one of them,
  and may be the input of another op.

* An op with aux state (``OpDef.num_aux``: BatchNorm) gets its
  missing aux inputs as Variables marked ``is_aux``, named
  ``<name>_moving_mean`` and ``<name>_moving_var`` as in the reference;
  ``list_arguments`` leaves them out and ``list_auxiliary_states`` lists
  them.
* ``infer_shape`` derives parameter and aux shapes from the data shapes
  alone with the reference's per-op rules (``_derive_param_shapes``)
  and propagates shapes by running every node's op on meta tensors,
  which carry shapes and no data (the reference uses
  ``jax.eval_shape``).
* ``tojson`` writes, and ``load_json`` reads, the reference's schema
  (``nodes`` with ``op``/``param``/``name``/``inputs``/``attr``, plus
  ``arg_nodes`` and ``heads``), so a graph that ``mxnet_tpu`` saves
  loads here with the same node names and attributes. As in the
  reference, the auto-created aux variables are not written, and
  ``load_json`` creates them again from the op's aux arity.
"""
from __future__ import annotations

import ast
import json
import threading
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

from ..base import MXNetError, atomic_write
from ..context import resolve_device
from ..ndarray.ndarray import to_torch_dtype
from ..ops import OP_REGISTRY, OpDef, get_op
from ..ops.nn import _tup

__all__ = ["Symbol", "Variable", "Group", "load", "load_json",
           "NameManager"]


# ------------------------------------------------------------------ naming

_local = threading.local()


class NameManager:
    """Per-op-type counter naming: ``fullyconnected0``, ``reshape3``, ...
    (the reference's ``name.NameManager``)."""

    def __init__(self):
        self._counter: Dict[str, int] = {}
        self._old: Optional[NameManager] = None

    def get(self, name: Optional[str], hint: str) -> str:
        if name:
            return name
        hint = hint.lower()
        idx = self._counter.get(hint, 0)
        self._counter[hint] = idx + 1
        return "%s%d" % (hint, idx)

    def __enter__(self):
        self._old = current_name_manager()
        _local.name_manager = self
        return self

    def __exit__(self, *exc):
        _local.name_manager = self._old


def current_name_manager() -> NameManager:
    nm = getattr(_local, "name_manager", None)
    if nm is None:
        nm = NameManager()
        _local.name_manager = nm
    return nm


# ------------------------------------------------------------------ graph

class _Node:
    """One graph node: an op application or a variable (op=None)."""

    __slots__ = ("op", "name", "attrs", "str_attrs", "inputs", "is_aux")

    def __init__(self, op: Optional[OpDef], name: str,
                 attrs: Optional[Dict[str, Any]] = None,
                 inputs: Optional[List[Tuple["_Node", int]]] = None,
                 is_aux: bool = False):
        self.op = op
        self.name = name
        self.attrs = attrs or {}          # op kwargs (python values)
        self.str_attrs: Dict[str, str] = {}   # user attrs (__shape__, ...)
        self.inputs = inputs or []
        self.is_aux = is_aux              # an aux-state variable

    @property
    def is_variable(self) -> bool:
        return self.op is None


def _topo_order(entries: Sequence[Tuple[_Node, int]]) -> List[_Node]:
    order: List[_Node] = []
    seen = set()

    def visit(node: _Node):
        if id(node) in seen:
            return
        seen.add(id(node))
        for n, _ in node.inputs:
            visit(n)
        order.append(node)

    for n, _ in entries:
        visit(n)
    return order


def _attr_str(v) -> str:
    return str(v)


def _parse_attr(s: str):
    try:
        return ast.literal_eval(s)
    except (ValueError, SyntaxError):
        return s


class Symbol:
    """An output list over the graph."""

    __slots__ = ("_entries",)

    def __init__(self, entries: Sequence[Tuple[_Node, int]]):
        self._entries = list(entries)

    @property
    def name(self) -> Optional[str]:
        if len(self._entries) == 1:
            return self._entries[0][0].name
        return None

    def __repr__(self):
        return "<Symbol %s>" % ", ".join(n.name for n, _ in self._entries)

    def __len__(self):
        return len(self._entries)

    def __iter__(self):
        return (self[i] for i in range(len(self._entries)))

    def __getitem__(self, idx) -> "Symbol":
        """One output, by position or by its ``list_outputs`` name."""
        if isinstance(idx, str):
            outputs = self.list_outputs()
            if idx not in outputs:
                raise ValueError("output %s not found (have %s)"
                                 % (idx, outputs))
            idx = outputs.index(idx)
        return Symbol([self._entries[idx]])

    # ------------------------------------------------------------ listing
    def list_arguments(self) -> List[str]:
        """Variable inputs in topological order, aux states left out."""
        return [n.name for n in _topo_order(self._entries)
                if n.is_variable and not n.is_aux]

    def list_auxiliary_states(self) -> List[str]:
        """Aux-state variables (BatchNorm's moving statistics) in
        topological order."""
        return [n.name for n in _topo_order(self._entries)
                if n.is_variable and n.is_aux]

    def list_outputs(self) -> List[str]:
        names = []
        for node, idx in self._entries:
            if node.is_variable:
                names.append(node.name)
            else:
                names.append(node.name + ("_output" if idx == 0
                                          else "_output%d" % idx))
        return names

    def attr_dict(self) -> Dict[str, Dict[str, str]]:
        out = {}
        for node in _topo_order(self._entries):
            d = dict(node.str_attrs)
            if node.op is not None:
                d.update({k: _attr_str(v) for k, v in node.attrs.items()})
            if d:
                out[node.name] = d
        return out

    # ------------------------------------------------------------ math
    def _binop(self, other, opname, scalar_op, reverse=False):
        if isinstance(other, Symbol):
            a, b = (other, self) if reverse else (self, other)
            return _create(get_op(opname), [a, b], {}, None)
        return _create(get_op(scalar_op), [self], {"scalar": float(other)},
                       None)

    def __add__(self, o):
        return self._binop(o, "elemwise_add", "_plus_scalar")

    __radd__ = __add__

    def __sub__(self, o):
        return self._binop(o, "elemwise_sub", "_minus_scalar")

    def __rsub__(self, o):
        return self._binop(o, "elemwise_sub", "_rminus_scalar", reverse=True)

    def __mul__(self, o):
        return self._binop(o, "elemwise_mul", "_mul_scalar")

    __rmul__ = __mul__

    def __truediv__(self, o):
        return self._binop(o, "elemwise_div", "_div_scalar")

    def __rtruediv__(self, o):
        return self._binop(o, "elemwise_div", "_rdiv_scalar", reverse=True)

    def __neg__(self):
        return _create(get_op("negative"), [self], {}, None)

    # ------------------------------------------------------------ shapes
    def infer_shape(self, *args, **kwargs):
        """``(arg_shapes, out_shapes, aux_shapes)`` from the given input
        shapes; parameter and aux shapes the graph implies are derived.
        Raises :class:`MXNetError` naming what cannot be inferred."""
        arg_names = self.list_arguments()
        aux_names = self.list_auxiliary_states()
        known: Dict[str, Tuple[int, ...]] = {}
        for n, s in zip(arg_names, args):
            if s is not None:
                known[n] = tuple(s)
        batch_size = kwargs.pop("__batch_size__", None)
        known.update({k: tuple(v) for k, v in kwargs.items()
                      if v is not None})
        if batch_size is None:
            batch_size = _batch_hint(known)
        for node in _topo_order(self._entries):
            if node.is_variable and "__shape__" in node.str_attrs and \
                    node.name not in known:
                known[node.name] = _pinned_shape(node, batch_size)
        node_shapes, derived = _propagate_shapes(self, known)
        resolved = dict(known)
        resolved.update(derived)
        missing = [n for n in arg_names + aux_names if n not in resolved]
        if missing:
            raise MXNetError("infer_shape: cannot infer %s (provide its "
                             "shape)" % missing)
        out_shapes = []
        for node, idx in self._entries:
            s = resolved.get(node.name) if node.is_variable \
                else node_shapes.get((id(node), idx))
            if s is None:
                raise MXNetError("infer_shape: op %s (node %r) rejects its "
                                 "input shapes" % (node.op.name, node.name))
            out_shapes.append(tuple(s))
        return ([tuple(resolved[n]) for n in arg_names], out_shapes,
                [tuple(resolved[n]) for n in aux_names])

    # ------------------------------------------------------------ save/load
    def tojson(self) -> str:
        """Serialize to the reference's symbol-JSON schema. An op's
        trailing aux variables are left out of its inputs, and an aux
        variable nothing else refers to is not written (``load_json``
        creates it again), as the reference does."""
        topo = _topo_order(self._entries)
        trimmed: Dict[int, list] = {}
        for n in topo:
            ins = list(n.inputs)
            k = 0 if n.is_variable else n.op.num_aux
            if k and len(ins) >= k and all(src.is_variable and src.is_aux
                                           for src, _ in ins[-k:]):
                ins = ins[:-k]
            trimmed[id(n)] = ins
        referenced = {id(src) for n in topo for src, _ in trimmed[id(n)]}
        referenced |= {id(n) for n, _ in self._entries}
        nodes = [n for n in topo if not (n.is_variable and n.is_aux and
                                         id(n) not in referenced)]
        index = {id(n): i for i, n in enumerate(nodes)}
        out_nodes = []
        for n in nodes:
            entry = {
                "op": "null" if n.is_variable else n.op.name,
                "param": {} if n.is_variable else
                         {k: _attr_str(v) for k, v in n.attrs.items()},
                "name": n.name,
                "inputs": [[index[id(src)], i]
                           for src, i in trimmed[id(n)]],
                "backward_source_id": -1,
            }
            if n.str_attrs:
                entry["attr"] = dict(n.str_attrs)
            out_nodes.append(entry)
        arg_nodes = [i for i, n in enumerate(nodes) if n.is_variable]
        heads = [[index[id(n)], i] for n, i in self._entries]
        return json.dumps({"nodes": out_nodes, "arg_nodes": arg_nodes,
                           "heads": heads}, indent=2)

    def save(self, fname: str) -> None:
        """Write :meth:`tojson` to ``fname`` (atomically)."""
        atomic_write(fname, self.tojson().encode("utf-8"))

    # ------------------------------------------------------------ bind
    def bind(self, ctx, args, args_grad=None, grad_req="write",
             aux_states=None):
        from ..executor import Executor
        return Executor(self, ctx, args, args_grad, grad_req, aux_states)

    def simple_bind(self, ctx, grad_req="write", type_dict=None,
                    shared_arg_names=None, shared_exec=None, **kwargs):
        """Infer shapes, allocate arguments and aux states (zeros) and
        gradient buffers on ``ctx`` (None: ``cuda:0``) and bind.

        With ``shared_exec``, the arguments named in ``shared_arg_names``
        (and their gradient buffers) and every aux state are not
        allocated: the executor holds ``shared_exec``'s arrays
        themselves, so a write through one executor is seen by the
        other. A shared name that ``shared_exec`` lacks, or holds at
        another shape, device or dtype, raises."""
        from ..executor import Executor
        from ..ndarray import zeros
        ctx = resolve_device(ctx)
        arg_shapes, _, aux_shapes = self.infer_shape(**kwargs)
        arg_names = self.list_arguments()
        type_dict = type_dict or {}
        reqs = grad_req if isinstance(grad_req, dict) else \
            {n: grad_req for n in arg_names}
        shared = set(shared_arg_names or ()) if shared_exec is not None \
            else set()

        def take(pool, name, shape, dtype, what):
            arr = pool.get(name)
            if arr is None:
                raise MXNetError("simple_bind: the shared executor has no "
                                 "%s %r to share" % (what, name))
            want = (tuple(shape), ctx, to_torch_dtype(dtype))
            have = (arr.shape, arr.context, arr.data.dtype)
            if have != want:
                raise MXNetError(
                    "simple_bind: cannot share %s %r: the shared executor "
                    "holds it as %s, this graph needs %s (shape, device, "
                    "dtype)" % (what, name, have, want))
            return arr

        args, args_grad = {}, {}
        for n, shape in zip(arg_names, arg_shapes):
            dtype = type_dict.get(n, "float32")
            if n in shared:
                args[n] = take(shared_exec.arg_dict, n, shape, dtype,
                               "argument")
            else:
                args[n] = zeros(shape, ctx=ctx, dtype=dtype)
            if grad_req != "null" and reqs.get(n, "null") != "null":
                args_grad[n] = take(shared_exec.grad_dict, n, shape,
                                    "float32", "gradient") \
                    if n in shared else zeros(shape, ctx=ctx)
        aux = {n: take(shared_exec.aux_dict, n, shape, "float32",
                       "auxiliary state") if shared_exec is not None
               else zeros(shape, ctx=ctx)
               for n, shape in zip(self.list_auxiliary_states(),
                                   aux_shapes)}
        return Executor(self, ctx, args,
                        args_grad if grad_req != "null" else None,
                        grad_req, aux)


def _batch_hint(known: Dict[str, Tuple[int, ...]]) -> Optional[int]:
    """The batch size the given input shapes imply: the leading dim of
    ``data`` if given, else of the first given input that is not a
    parameter (pass ``__batch_size__`` for time-major data)."""
    data_like = [(n, s) for n, s in known.items()
                 if s and not str(n).endswith(
                     ("weight", "bias", "gamma", "beta", "moving_mean",
                      "moving_var"))]
    for n, s in data_like:
        if n == "data":
            return s[0]
    return data_like[0][1][0] if data_like else None


def _pinned_shape(node: "_Node", batch_size) -> Tuple[int, ...]:
    """A variable's ``__shape__``, its 0 (batch wildcard) dims resolved
    from ``batch_size``: the one its ``__layout__`` marks N, else every
    0 (a recurrent cell's begin states are (0, H), layout NC)."""
    shape = list(ast.literal_eval(node.str_attrs["__shape__"]))
    if any(d == 0 for d in shape) and batch_size:
        n_axis = node.str_attrs.get("__layout__", "").find("N")
        if 0 <= n_axis < len(shape) and shape[n_axis] == 0:
            shape[n_axis] = int(batch_size)
        else:
            shape = [int(batch_size) if d == 0 else d for d in shape]
    return tuple(shape)


def Group(symbols: Sequence[Symbol]) -> Symbol:
    """One Symbol whose outputs are those of ``symbols``, in order."""
    entries = []
    for s in symbols:
        entries.extend(s._entries)
    return Symbol(entries)


# ------------------------------------------------------------------ factory

def Variable(name: str, attr=None, shape=None, dtype=None, init=None,
             **kwargs) -> Symbol:
    node = _Node(None, name)
    attrs = dict(attr or {})
    if shape is not None:
        attrs["__shape__"] = str(tuple(shape))
    if dtype is not None:
        attrs["__dtype__"] = str(dtype)
    if init is not None:
        attrs["__init__"] = init if isinstance(init, str) else init.dumps()
    attrs.update({k: str(v) for k, v in kwargs.items()})
    node.str_attrs = attrs
    return Symbol([(node, 0)])


def _num_visible_outputs(op: OpDef, attrs: Dict[str, Any]) -> int:
    nout = op.num_outputs
    return int(nout(attrs) if callable(nout) else nout)


def _create(op: OpDef, input_syms: List[Symbol], attrs: Dict[str, Any],
            name: Optional[str]) -> Symbol:
    """An op node with one Symbol entry per visible output (the
    ``input_syms`` end with its aux states, if it has any)."""
    name = current_name_manager().get(name, op.name.lower().replace("_", ""))
    entries = []
    for s in input_syms:
        if len(s._entries) != 1:
            raise MXNetError("op %s input must be single-output symbol "
                             "(pick one output with sym[i])" % op.name)
        entries.append(s._entries[0])
    node = _Node(op, name, attrs, entries)
    return Symbol([(node, i) for i in range(_num_visible_outputs(op,
                                                                 attrs))])


def make_symbol_function(op: OpDef):
    """The ``sym.<Op>`` wrapper: Symbols fill tensor-input slots (by
    position or name), other positional arguments map onto the op's
    parameters at the same position, and missing weight/bias/label and
    aux inputs become Variables named ``<name>_<input>`` (aux ones marked
    ``is_aux``), as in the reference."""
    def fn(*args, **kwargs):
        name = current_name_manager().get(kwargs.pop("name", None),
                                          op.name.lower().replace("_", ""))
        if op.input_names_fn is not None:
            # Custom: the Prop named by the attributes lists the inputs
            input_names = op.input_names_fn(
                {k: v for k, v in kwargs.items()
                 if not isinstance(v, Symbol)})
        else:
            input_names = op.input_names
        if op.num_inputs is None and op.input_names_fn is None and \
                len(args) > 1 and all(
                isinstance(a, Symbol) for a in args) and \
                not any(k in kwargs for k in input_names) and \
                len(args) > len(input_names):
            return _create(op, list(args), dict(kwargs), name)
        inputs: Dict[str, Symbol] = {}
        attrs: Dict[str, Any] = {}
        params = op.param_names
        for i, a in enumerate(args):
            if isinstance(a, Symbol):
                if i >= len(input_names):
                    raise MXNetError("%s: too many symbol inputs (expected "
                                     "%s)" % (op.name, input_names))
                inputs[input_names[i]] = a
            elif i < len(params):
                attrs[params[i]] = a
            else:
                raise MXNetError("%s: unexpected positional argument %r"
                                 % (op.name, a))
        for k, v in kwargs.items():
            if isinstance(v, Symbol):
                inputs[k] = v
            else:
                attrs[k] = v
        in_syms = [inputs[n] if n in inputs else Variable("%s_%s" % (name, n))
                   for n in input_names]
        if attrs.get("no_bias") and "bias" in input_names and \
                "bias" not in inputs:
            del in_syms[input_names.index("bias")]
        for n in op.aux_input_names:
            if n not in inputs:
                inputs[n] = Variable("%s_%s" % (name, n))
                inputs[n]._entries[0][0].is_aux = True
            in_syms.append(inputs[n])
        return _create(op, in_syms, attrs, name)

    fn.__name__ = op.name
    fn.__doc__ = op.__doc__
    return fn


# ------------------------------------------------------------------ loading

def load_json(json_str: str) -> Symbol:
    """Load a symbol JSON file in the reference's schema (the 0.8-era
    ``param``+``attr`` nodes that ``mxnet_tpu`` writes, or the 1.x-era
    merged ``attrs``). Op attributes the port's op does not take are
    dropped, as the reference drops backend tuning knobs."""
    g = json.loads(json_str)
    built: List[_Node] = []
    for rn in g["nodes"]:
        if rn["op"] == "null":
            node = _Node(None, rn["name"], is_aux=bool(rn.get("is_aux")))
            node.str_attrs = {k: str(v) for k, v in
                              (rn.get("attr") or rn.get("attrs") or
                               {}).items()}
        else:
            op = get_op(rn["op"])
            if "param" in rn:
                op_attrs = rn["param"]
                user_attrs = rn.get("attr", {})
            else:
                merged = dict(rn.get("attrs", {}))
                user_attrs = {k: merged.pop(k) for k in list(merged)
                              if k.startswith("__")}
                op_attrs = merged
            known = set(op.param_names)
            attrs = {k: _parse_attr(v) for k, v in op_attrs.items()
                     if k in known}
            inputs = [(built[e[0]], e[1]) for e in rn["inputs"]]
            if op.num_aux:
                visible = len(op.input_names)
                if attrs.get("no_bias") and "bias" in op.input_names:
                    visible -= 1
                if len(inputs) >= visible + op.num_aux:
                    # the aux states were written as inputs (1.x files)
                    for src, _ in inputs[-op.num_aux:]:
                        if src.is_variable:
                            src.is_aux = True
                else:
                    inputs += [(_Node(None, "%s_%s" % (rn["name"], a),
                                      is_aux=True), 0)
                               for a in op.aux_input_names]
            node = _Node(op, rn["name"], attrs, inputs)
            node.str_attrs = {k: str(v) for k, v in user_attrs.items()}
        built.append(node)
    return Symbol([(built[e[0]], e[1]) for e in g["heads"]])


def load(fname: str) -> Symbol:
    """A Symbol from a JSON file (:meth:`Symbol.save`, or the
    reference's)."""
    with open(fname) as f:
        return load_json(f.read())


# ------------------------------------------------------------------ shapes

def run_node(node: _Node, ins, is_train: bool, device):
    """Execute one op node on tensors; returns a tuple of outputs. An op
    that takes ``_is_train`` (Custom) is told whether this is a training
    pass."""
    attrs = dict(node.attrs)
    attrs.pop("name", None)
    if node.op.num_inputs == 0:
        attrs["_device"] = device
    if "_is_train" in node.op.param_names:
        attrs["_is_train"] = bool(is_train)
    outs = node.op.fn(*ins, **attrs)
    return outs if isinstance(outs, tuple) else (outs,)


def _eval_meta(node: _Node, in_shapes):
    ins = [torch.empty(s, device="meta") for s in in_shapes]
    meta_fn = getattr(node.op, "meta_fn", None)
    with torch.no_grad():
        if meta_fn is not None:
            attrs = {k: v for k, v in node.attrs.items() if k != "name"}
            outs = meta_fn(*ins, **attrs)
            outs = outs if isinstance(outs, tuple) else (outs,)
        else:
            outs = run_node(node, ins, True, torch.device("meta"))
    return tuple(tuple(o.shape) for o in outs)


def _propagate_shapes(sym: Symbol, known: Dict[str, Tuple[int, ...]]):
    """Walk the graph in order: derive the parameter shapes each
    parameter-owning op implies from its data input's shape (the
    reference's ``_derive_param_shapes`` rules), then evaluate the node
    on meta tensors. Returns ``(node output shapes, derived shapes)``."""
    derived: Dict[str, Tuple[int, ...]] = {}
    shapes: Dict[Tuple[int, int], Tuple[int, ...]] = {}
    memo: Dict[tuple, Optional[tuple]] = {}

    def shape_of(entry):
        node, idx = entry
        if node.is_variable:
            s = known.get(node.name) or derived.get(node.name)
            return tuple(s) if s is not None else None
        return shapes.get((id(node), idx))

    for node in _topo_order(sym._entries):
        if node.is_variable:
            continue
        a = node.attrs
        ds = shape_of(node.inputs[0]) if node.inputs else None

        def setvar(pos, shape):
            if pos >= len(node.inputs):
                return
            n, _ = node.inputs[pos]
            if n.is_variable and n.name not in known and \
                    n.name not in derived:
                derived[n.name] = tuple(int(x) for x in shape)

        if ds is not None:
            opname = node.op.name
            if opname == "FullyConnected":
                nh = int(a["num_hidden"])
                flat = 1
                for x in ds[1:]:
                    flat *= x
                setvar(1, (nh, flat if a.get("flatten", True) else ds[-1]))
                setvar(2, (nh,))
            elif opname == "Convolution":
                # only a weight that is a variable: the s2d stem feeds a
                # re-laid-out (F, 12, 4, 4) view of its (F, 3, 7, 7) one
                nf = int(a["num_filter"])
                kernel = _tup(a.get("kernel"), len(ds) - 2) or \
                    (1,) * (len(ds) - 2)
                setvar(1, (nf, ds[1] // int(a.get("num_group", 1)))
                       + kernel)
                setvar(2, (nf,))
            elif opname == "BatchNorm":
                ax = int(a.get("axis", 1)) % len(ds)
                for pos in range(1, 5):      # gamma, beta and the aux
                    setvar(pos, (ds[ax],))
            elif opname == "LayerNorm":
                ax = int(a.get("axis", -1)) % len(ds)
                setvar(1, (ds[ax],))
                setvar(2, (ds[ax],))
            elif opname == "Embedding":
                setvar(1, (int(a["input_dim"]), int(a["output_dim"])))
            elif opname == "SoftmaxOutput":
                setvar(1, (ds[0],))
            elif opname == "RNN":
                # data (T, N, input): the packed vector and the states
                from ..ops.rnn_op import rnn_param_size
                H, L = int(a["state_size"]), int(a.get("num_layers", 1))
                mode = a.get("mode", "lstm")
                bidir = bool(a.get("bidirectional"))
                setvar(1, (rnn_param_size(L, ds[2], H, mode, bidir),))
                setvar(2, (L * (2 if bidir else 1), ds[1], H))
                if mode == "lstm":
                    setvar(3, (L * (2 if bidir else 1), ds[1], H))
            elif opname == "Custom":
                # the user's Prop owns the shape rules; its infer_shape may
                # reject partly unknown shapes, which only skips the
                # derivation for this node (as in the reference)
                from ..operator import _make_prop
                try:
                    ish, _, _ = _make_prop(a["op_type"], a).infer_shape(
                        [list(shape_of(e)) if shape_of(e) is not None
                         else None for e in node.inputs])
                except Exception:                           # noqa: BLE001
                    ish = []
                for pos, shape in enumerate(ish):
                    if shape is not None:
                        setvar(pos, shape)

        in_shapes = [shape_of(e) for e in node.inputs]
        if any(s is None for s in in_shapes):
            continue
        key = (node.op.name, tuple(in_shapes),
               tuple(sorted((k, repr(v)) for k, v in a.items())))
        if key not in memo:
            try:
                memo[key] = _eval_meta(node, in_shapes)
            except Exception as exc:                        # noqa: BLE001
                desc = ", ".join(
                    "%s=(%s)" % (src.name, ",".join(map(str, s)))
                    for (src, _), s in zip(node.inputs, in_shapes))
                raise MXNetError(
                    "infer_shape: op %s (node %r) rejects its input shapes "
                    "[%s]: %s" % (node.op.name, node.name, desc,
                                  str(exc).strip().splitlines()[0]
                                  if str(exc).strip() else
                                  type(exc).__name__)) from exc
        for i, o in enumerate(memo[key]):
            shapes[(id(node), i)] = o
    return shapes, derived


def _install_op_functions(namespace: Dict[str, Any]) -> List[str]:
    names = []
    for opname, op in OP_REGISTRY.items():
        if opname not in namespace:
            namespace[opname] = make_symbol_function(op)
            names.append(opname)
    return names
