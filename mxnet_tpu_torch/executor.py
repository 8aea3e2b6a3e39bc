"""Graph executor: a bound Symbol run op by op on torch tensors.

The port's counterpart of the reference's ``executor.py``. The
reference traces the graph into one jitted XLA program and takes
gradients with ``jax.vjp``; here :func:`graph_function` runs the nodes
in topological order (PyTorch runs eagerly) and gradients come from
``torch.autograd``:

* ``forward(is_train=True)`` runs with autograd recording, on detached
  views of the bound arguments that ask for a gradient (the bound
  tensors themselves never carry autograd state, so an optimizer may
  update them in place);
* aux states (BatchNorm's moving statistics, ``aux_dict``) are read
  by the graph and their new values returned beside the outputs; a
  training forward commits them in place after the graph has run (under
  ``no_grad``, detached), and an inference forward leaves them as they
  were. The moving statistics take no part in the gradient, and a value
  an op returns unchanged (the same tensor) is not written, so no tensor
  that autograd saved is ever modified;
* ``gradients(out_grads)`` differentiates the outputs, with a ones
  head gradient per output when none is given (as the reference's
  fused step does); ``backward(out_grads)`` writes those gradients
  into ``grad_dict`` per ``grad_req`` (``write``, ``add`` or
  ``null``), and ``Module``'s fused step hands them to the optimizer
  directly;
* the monitor hook (:mod:`..monitor`): ``set_monitor_callback`` is
  called with every graph output after each forward, and
  ``monitor_values`` yields every op node's outputs of the last forward
  (the values that ran, kept only while ``keep_node_outputs`` is set,
  which ``Monitor.install`` does), named ``<node>_output`` or
  ``<node>_output<i>`` as the reference names them;
* model parallelism (``group2ctx``, the reference's
  ``graph_executor.cc`` PlaceDevice pass): each op node runs on the
  device its ``ctx_group`` attribute (``AttrScope(ctx_group=)``) maps
  to, else on the bind's device. Its inputs made on another device are
  copied over with ``Tensor.to``, which autograd differentiates, so each
  gradient lands on its argument's device; every argument, gradient
  buffer and aux state is held on its group's device
  (:func:`placement`). A group on the CPU runs the CPU versions of its
  ops, a group on the card its kernels;
* compile levers, as the reference's bind applies them: with
  ``MXNET_TPU_SCAN_LAYERS`` (default ``auto``) the executor finds the
  graph's repeated blocks (:mod:`.symbol.scan`) and runs them as a plan,
  layer by layer, bit for bit the unrolled graph (no plan under
  ``group2ctx``; a chain that does not verify falls back silently), and
  counts ``scan_applied`` and the ``scan_layers`` gauge; with
  ``MXNET_TPU_REMAT`` (or ``MXNET_EXEC_ENABLE_REMAT``) the training
  forward runs under the resolved policy (:mod:`.remat`): each layer of
  the plan wrapped, or, without a plan, the whole forward, counted once
  in ``remat_applied``;
* bind-time analysis (:func:`check_bind`, ``MXNET_TPU_ANALYZE``): the
  graph passes run over the symbol with the bound shapes and dtypes
  before the graph function is built (``simple_bind`` runs them before
  it allocates the arrays); ``strict`` refuses the bind on an ERROR
  finding;
* observability: building the graph function (with its scan plan and
  remat policy) is the executor's compile, recorded in the compile ring
  (:mod:`.obs.compiles`, ``trace_ms``) under the scope
  ``graph:<first output>``; while the profiler runs, a training forward
  and its gradients log one ``graph_fwd_bwd`` event, waited on so its
  duration is device time.
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional

import torch

from .base import MXNetError
from .context import DeviceLike, resolve_device
from .ndarray import NDArray
from . import profiler as _profiler
from . import remat as _remat

__all__ = ["Executor", "graph_function", "placement", "check_bind"]


def _group_device(node, group2ctx, default: torch.device) -> torch.device:
    group = node.str_attrs.get("ctx_group")
    if not group or group not in group2ctx:
        return default
    return resolve_device(group2ctx[group])


def placement(symbol, group2ctx, default: torch.device
              ) -> Dict[str, torch.device]:
    """The device of every argument and aux state under ``group2ctx``:
    its own ``ctx_group``'s, else that of the first op (in topological
    order) of a group that consumes it, else ``default``."""
    from .symbol.symbol import _topo_order

    names = symbol.list_arguments() + symbol.list_auxiliary_states()
    if not group2ctx:
        return {n: default for n in names}
    group_of: Dict[str, object] = {}
    for node in _topo_order(symbol._entries):
        if not node.str_attrs.get("ctx_group"):
            continue
        if node.is_variable:
            group_of.setdefault(node.name, node)
        else:
            for src, _ in node.inputs:
                if src.is_variable:
                    group_of.setdefault(src.name, node)
    return {n: _group_device(group_of[n], group2ctx, default)
            if n in group_of else default for n in names}


def graph_function(symbol, group2ctx=None, default=None, scan_plan=None):
    """A Symbol as a function of tensors: ``fn(args: {name: tensor},
    aux: {name: tensor}, is_train: bool, device) -> ([outputs],
    {aux name: new value})``, the new values being the trailing outputs
    of each op with aux state. ``device`` is where ops without inputs
    (``_arange``) create their result; ``tap(node, outputs)``, when
    given, sees every op node's outputs as they are made (not again
    when a remat wrap recomputes them). With ``group2ctx``, each op node
    runs on its group's device (else on ``default``), its inputs copied
    there. With ``scan_plan`` (not with ``group2ctx``), the plan's pre
    nodes run, then its layers (:meth:`ScanPlan.execute`, its traced
    form with ``traced``: a compiled step's capture), then its post
    nodes."""
    from .symbol.symbol import _topo_order, run_node

    nodes = _topo_order(symbol._entries)
    entries = list(symbol._entries)
    node_device = {id(n): _group_device(n, group2ctx, default)
                   for n in nodes if not n.is_variable} if group2ctx else {}
    if scan_plan is not None and group2ctx:
        raise MXNetError("a scan plan cannot combine with group2ctx "
                         "placement")

    def fn(args: Dict[str, torch.Tensor], aux: Dict[str, torch.Tensor],
           is_train: bool, device, tap=None, traced=False):
        vals = {}
        new_aux = {}

        def run(node, ins):
            dev = node_device.get(id(node), device)
            if node_device:
                ins = [x.to(dev) for x in ins]
            if not traced:
                # the selective remat policy classifies by it; a capture's
                # traced policy needs no per-node state
                _remat.set_current_op(node.op.name)
            outs = run_node(node, ins, is_train, dev)
            if tap is not None and not _remat.replaying():
                tap(node, outs)
            return outs

        def exec_node(node):
            if node.is_variable:
                src = aux if node.is_aux else args
                if node.name not in src:
                    raise MXNetError("unbound variable %r" % node.name)
                vals[(id(node), 0)] = src[node.name]
                return
            outs = run(node, [vals[(id(n), i)] for n, i in node.inputs])
            for i, o in enumerate(outs):
                vals[(id(node), i)] = o
            k = node.op.num_aux
            if k:
                for (src, _), val in zip(node.inputs[-k:], outs[-k:]):
                    if src.is_variable:
                        new_aux[src.name] = val

        if scan_plan is not None:
            for node in scan_plan.pre_nodes:
                exec_node(node)
            scan_plan.execute(vals, args, run, traced=traced)
            for node in scan_plan.post_nodes:
                exec_node(node)
        else:
            for node in nodes:
                exec_node(node)
        return [vals[(id(n), i)] for n, i in entries], new_aux

    return fn


def check_bind(symbol, shapes, dtypes) -> None:
    """The bind-time static analysis (``MXNET_TPU_ANALYZE``): the graph
    passes over ``symbol`` with the bind's shapes and dtypes, before
    anything is built for the bind. Off (the default) costs one config
    read and never imports the analyzer; ``warn`` logs WARNING+
    findings; ``strict`` raises ``MXNetError`` on ERROR findings, an
    over-``MXNET_TPU_ANALYZE_HBM_BUDGET`` bind among them."""
    from . import config as _config
    mode = _config.get("MXNET_TPU_ANALYZE")
    if mode != "off":
        from .analysis import check_bind as _check_bind
        _check_bind(symbol, input_shapes=shapes, input_dtypes=dtypes,
                    mode=mode, context="bind")


def _as_dict(values, names, what) -> Dict:
    if values is None:
        return {}
    if isinstance(values, dict):
        return dict(values)
    if isinstance(values, (list, tuple)):
        if len(values) != len(names):
            raise MXNetError("%s: expected %d entries, got %d"
                             % (what, len(names), len(values)))
        return dict(zip(names, values))
    raise MXNetError("%s must be list or dict" % what)


class Executor:
    """A Symbol bound to arrays on one device: ``ctx`` None means
    ``cuda:0``, and raises without a GPU (``context.resolve_device``).
    With ``group2ctx`` ({ctx_group: context}), each group's nodes run on
    their context, and the bound arrays are moved to their group's
    device (:func:`placement`)."""

    def __init__(self, symbol, ctx: DeviceLike, args, args_grad=None,
                 grad_req="write", aux_states=None, group2ctx=None,
                 _checked=False):
        self._symbol = symbol
        self._device = resolve_device(ctx)
        self._group2ctx = dict(group2ctx) if group2ctx else None
        self._arg_names = symbol.list_arguments()
        self._aux_names = symbol.list_auxiliary_states()
        self._output_names = symbol.list_outputs()
        self.arg_dict: Dict[str, NDArray] = _as_dict(args, self._arg_names,
                                                     "args")
        missing = [n for n in self._arg_names if n not in self.arg_dict]
        if missing:
            raise MXNetError("bind: missing arguments %s" % missing)
        self.aux_dict: Dict[str, NDArray] = _as_dict(
            aux_states, self._aux_names, "aux_states")
        missing = [n for n in self._aux_names if n not in self.aux_dict]
        if missing:
            raise MXNetError("bind: missing auxiliary states %s" % missing)
        if isinstance(grad_req, str):
            self._grad_req = {n: grad_req for n in self._arg_names}
        elif isinstance(grad_req, (list, tuple)):
            self._grad_req = dict(zip(self._arg_names, grad_req))
        else:
            self._grad_req = {n: grad_req.get(n, "null")
                              for n in self._arg_names}
        for req in self._grad_req.values():
            if req not in ("write", "add", "null"):
                raise MXNetError("grad_req must be write, add or null, got "
                                 "%r" % (req,))
        self.grad_dict: Dict[str, NDArray] = _as_dict(
            args_grad, self._arg_names, "args_grad")
        self._wrt = [n for n in self._arg_names
                     if self._grad_req.get(n, "null") != "null"
                     and n in self.grad_dict]
        if not _checked:      # simple_bind checked before it allocated
            check_bind(symbol, *self._bound_shapes_dtypes())
        if self._group2ctx:
            where = placement(symbol, self._group2ctx, self._device)
            for pool in (self.arg_dict, self.grad_dict, self.aux_dict):
                for n, arr in pool.items():
                    dev = where.get(n, self._device)
                    if arr.data.device != dev:
                        arr._data = arr.data.to(dev)
        self._remat = None       # the whole-forward remat policy
        self._remat_name = "off"
        # compile-accounting label: this executor's build is attributed
        # to it in mt.obs.report()
        self._obs_label = "graph:%s" % (
            self._output_names[0] if self._output_names else "?")
        from .obs import compiles as _compiles
        t_build = time.perf_counter()
        with _compiles.scope(self._obs_label):
            self._build_graph()
            _compiles.record(0.0, (time.perf_counter() - t_build) * 1e3,
                             source="graph")
        self._outputs: Optional[List[NDArray]] = None
        self._pending = None     # (outputs, leaves) awaiting backward
        self._t_fwd = 0.0        # the training forward's start (profiler)
        self._monitor_callback = None
        self.keep_node_outputs = False
        self._node_outputs: List = []

    def _build_graph(self) -> None:
        """The graph function, its scan plan and the remat policy: the
        executor's compile."""
        self._scan_plan = self._build_scan_plan()
        self._fn = graph_function(self._symbol, self._group2ctx,
                                  self._device, scan_plan=self._scan_plan)
        if self._wrt and self._scan_plan is None and _remat.remat_knob_on():
            # no plan: the whole forward under the policy (the
            # reference's fused step and fwd_bwd wrap; one count a bind)
            policy, name = _remat.resolve_policy(
                self._symbol, *self._bound_shapes_dtypes())
            if policy is not None:
                self._remat, self._remat_name = policy, name
                _profiler.incr_counter("remat_applied")

    def _bound_shapes_dtypes(self):
        """``(shapes, dtypes)`` of every bound argument and aux state."""
        pools = list(self.arg_dict.items()) + list(self.aux_dict.items())
        return ({n: tuple(a.shape) for n, a in pools},
                {n: a.data.dtype for n, a in pools})

    def _build_scan_plan(self):
        """The scan plan (``MXNET_TPU_SCAN_LAYERS``, default auto) and
        its per-block remat: None under ``group2ctx``, with the knob
        off, or when no chain verifies (the unrolled path, silently)."""
        from . import config as _config
        if self._group2ctx:
            return None
        mode = _config.get("MXNET_TPU_SCAN_LAYERS")
        if mode == "off":
            return None
        from .symbol.scan import DEFAULT_MIN_REPEAT, build_scan_plan
        shapes, dtypes = self._bound_shapes_dtypes()
        plan = build_scan_plan(
            self._symbol, min_repeat=DEFAULT_MIN_REPEAT if mode == "auto"
            else int(mode), shapes=shapes, dtypes=dtypes)
        if plan is None:
            return None
        _profiler.incr_counter("scan_applied")
        _profiler.set_gauge("scan_layers", plan.n_layers)
        if _remat.remat_knob_on():
            policy, name = _remat.resolve_policy(self._symbol, shapes,
                                                 dtypes)
            if policy is not None:
                # each layer of the plan under the policy: the "wrap each
                # repeated block" form the remat suggestion prescribes
                plan.body_wrapper = policy.wrap
                plan.remat_policy = policy
                self._remat_name = name
                _profiler.incr_counter("remat_applied")
        return plan

    def forward(self, is_train: bool = False, **kwargs) -> List[NDArray]:
        """Run the graph; with ``is_train`` and gradients requested,
        record it for :meth:`backward`. A training forward commits the
        new aux states."""
        for k, v in kwargs.items():
            if k not in self.arg_dict:
                raise MXNetError("forward: unknown argument %r" % k)
            self.arg_dict[k][:] = v
        return self.forward_inputs(is_train)

    def step_body(self):
        """The training forward as a compiled step captures it:
        ``body(args, aux) -> (outputs, {aux name: new value})``, the
        graph function with the scan plan in its traced form and the
        remat policy's traced wrap (:meth:`.remat.Policy.wrap_traced`)
        around the whole forward where there is no plan. The parameters
        and aux states are arguments, never constants of the capture."""
        fn, device = self._fn, self._device
        if self._remat is not None:
            fn = self._remat.wrap_traced(fn)
        from .symbol.symbol import _topo_order
        for node in _topo_order(self._symbol._entries):
            if not node.is_variable:
                # settled before the capture: a cached property the
                # capture computed would change under its guard
                node.op.takes_is_train
        if self._scan_plan is not None:
            from .symbol.symbol import run_node

            def run(node, ins):
                return run_node(node, ins, True, device)

            self._scan_plan.traced_layer(run)

        def body(args, aux):
            return fn(args, aux, True, device, None, True)

        return body

    def forward_inputs(self, is_train: bool, inputs=None,
                       program=None) -> List[NDArray]:
        """:meth:`forward` with ``inputs`` ({name: tensor}) in place of
        those bound arguments, which are not written: ``Module``'s
        gradient accumulation runs each microbatch so. ``program`` (a
        training forward with gradients requested) is a compiled step
        (:class:`._fused.StepProgram` over :meth:`step_body`) that runs
        the graph in place of the graph function."""
        args = {n: a.data for n, a in self.arg_dict.items()}
        if inputs:
            args.update(inputs)
        aux = {n: a.data for n, a in self.aux_dict.items()}
        tap = None
        if self.keep_node_outputs:
            self._node_outputs = []
            tap = lambda node, outs: self._node_outputs.append(  # noqa: E731
                (node.name, [o.detach() for o in outs]))
        if is_train and self._wrt:
            if _profiler._tracing:
                self._t_fwd = time.perf_counter()
            leaves = {n: args[n].detach().requires_grad_(True)
                      for n in self._wrt}
            args.update(leaves)
            with torch.enable_grad():
                if program is not None:
                    outs, new_aux = program(args, aux)
                else:
                    fn = self._fn
                    if self._remat is not None:
                        fn = self._remat.wrap(fn)
                    outs, new_aux = fn(args, aux, True, self._device, tap)
            self._pending = (outs, leaves)
        else:
            with torch.no_grad():
                outs, new_aux = self._fn(args, aux, bool(is_train),
                                         self._device, tap)
            self._pending = None
        if is_train:
            with torch.no_grad():
                for n, v in new_aux.items():
                    if v is not aux[n]:
                        aux[n].copy_(v.detach())
        self._outputs = [NDArray(o.detach()) for o in outs]
        if self._monitor_callback is not None:
            for name, arr in zip(self._output_names, self._outputs):
                self._monitor_callback(name, arr)
        return self._outputs

    def gradients(self, out_grads=None, into=None):
        """Differentiate the last training forward: ``(names, grads)``,
        one gradient tensor per argument that asks for one (zeros where
        the outputs do not depend on it), without touching
        ``grad_dict``. With ``into`` (one buffer per such argument, in
        ``names``' order), each gradient is added into its buffer in
        place as autograd produces it, and the buffers are returned: a
        gradient set is never alive beside the sum."""
        if self._pending is None:
            raise MXNetError("backward called without forward(is_train="
                             "True)")
        outs, leaves = self._pending
        self._pending = None
        if out_grads is None:
            # ones head gradients, as broadcast views (no allocation)
            heads = [o.new_ones(()).expand_as(o) for o in outs]
        else:
            if not isinstance(out_grads, (list, tuple)):
                out_grads = [out_grads]
            heads = [(g.data if isinstance(g, NDArray)
                      else torch.as_tensor(g)).to(o.device, o.dtype)
                     for g, o in zip(out_grads, outs)]
        names = list(leaves)
        if into is not None:
            for n, buf in zip(names, into):
                leaves[n].grad = buf
            torch.autograd.backward(outs, heads,
                                    inputs=[leaves[n] for n in names])
            grads = list(into)
        else:
            grads = torch.autograd.grad(outs, [leaves[n] for n in names],
                                        grad_outputs=heads,
                                        allow_unused=True)
            grads = [g if g is not None else torch.zeros_like(leaves[n])
                     for n, g in zip(names, grads)]
        if _profiler._tracing and self._t_fwd:
            # the forward + backward as one event, waited on so its
            # duration is device time
            if self._device.type == "cuda":
                torch.cuda.current_stream(self._device).synchronize()
            _profiler.record_event("graph_fwd_bwd", self._t_fwd,
                                   time.perf_counter(), "graph")
        self._t_fwd = 0.0
        return names, grads

    def backward(self, out_grads=None) -> None:
        """Differentiate the last training forward; writes
        ``grad_dict``."""
        names, grads = self.gradients(out_grads)
        with torch.no_grad():
            for n, g in zip(names, grads):
                buf = self.grad_dict[n]
                if self._grad_req[n] == "add":
                    buf.data.add_(g.to(buf.data.dtype))
                else:
                    buf.data.copy_(g)

    @property
    def outputs(self) -> List[NDArray]:
        if self._outputs is None:
            raise MXNetError("no forward has been run")
        return self._outputs

    @property
    def arg_arrays(self) -> List[NDArray]:
        return [self.arg_dict[n] for n in self._arg_names]

    # ------------------------------------------------------------ monitor
    def set_monitor_callback(self, callback) -> None:
        """Call ``callback(name, NDArray)`` for every graph output after
        each forward."""
        self._monitor_callback = callback

    def monitor_values(self):
        """``(name, NDArray)`` for every output of every op node of the
        last forward, in graph order (empty unless
        ``keep_node_outputs`` was set before it)."""
        for name, outs in self._node_outputs:
            for i, o in enumerate(outs):
                suffix = "_output" if len(outs) == 1 else "_output%d" % i
                yield name + suffix, NDArray(o)
