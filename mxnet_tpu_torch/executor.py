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
  directly.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import torch

from .base import MXNetError
from .context import DeviceLike, resolve_device
from .ndarray import NDArray

__all__ = ["Executor", "graph_function"]


def graph_function(symbol):
    """A Symbol as a function of tensors: ``fn(args: {name: tensor},
    aux: {name: tensor}, is_train: bool, device) -> ([outputs],
    {aux name: new value})``, the new values being the trailing outputs
    of each op with aux state. ``device`` is where ops without inputs
    (``_arange``) create their result."""
    from .symbol.symbol import _topo_order, run_node

    nodes = _topo_order(symbol._entries)
    entries = list(symbol._entries)

    def fn(args: Dict[str, torch.Tensor], aux: Dict[str, torch.Tensor],
           is_train: bool, device):
        vals = {}
        new_aux = {}
        for node in nodes:
            if node.is_variable:
                src = aux if node.is_aux else args
                if node.name not in src:
                    raise MXNetError("unbound variable %r" % node.name)
                vals[(id(node), 0)] = src[node.name]
                continue
            ins = [vals[(id(n), i)] for n, i in node.inputs]
            outs = run_node(node, ins, is_train, device)
            for i, o in enumerate(outs):
                vals[(id(node), i)] = o
            k = node.op.num_aux
            if k:
                for (src, _), val in zip(node.inputs[-k:], outs[-k:]):
                    if src.is_variable:
                        new_aux[src.name] = val
        return [vals[(id(n), i)] for n, i in entries], new_aux

    return fn


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
    ``cuda:0``, and raises without a GPU (``context.resolve_device``)."""

    def __init__(self, symbol, ctx: DeviceLike, args, args_grad=None,
                 grad_req="write", aux_states=None):
        self._symbol = symbol
        self._device = resolve_device(ctx)
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
        self._fn = graph_function(symbol)
        self._outputs: Optional[List[NDArray]] = None
        self._pending = None     # (outputs, leaves) awaiting backward

    def forward(self, is_train: bool = False, **kwargs) -> List[NDArray]:
        """Run the graph; with ``is_train`` and gradients requested,
        record it for :meth:`backward`. A training forward commits the
        new aux states."""
        for k, v in kwargs.items():
            if k not in self.arg_dict:
                raise MXNetError("forward: unknown argument %r" % k)
            self.arg_dict[k][:] = v
        args = {n: a.data for n, a in self.arg_dict.items()}
        aux = {n: a.data for n, a in self.aux_dict.items()}
        if is_train and self._wrt:
            leaves = {n: args[n].detach().requires_grad_(True)
                      for n in self._wrt}
            args.update(leaves)
            with torch.enable_grad():
                outs, new_aux = self._fn(args, aux, True, self._device)
            self._pending = (outs, leaves)
        else:
            with torch.no_grad():
                outs, new_aux = self._fn(args, aux, bool(is_train),
                                         self._device)
            self._pending = None
        if is_train:
            with torch.no_grad():
                for n, v in new_aux.items():
                    if v is not aux[n]:
                        aux[n].copy_(v.detach())
        self._outputs = [NDArray(o.detach()) for o in outs]
        return self._outputs

    def gradients(self, out_grads=None):
        """Differentiate the last training forward: ``(names, grads)``,
        one gradient tensor per argument that asks for one (zeros where
        the outputs do not depend on it), without touching
        ``grad_dict``."""
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
        grads = torch.autograd.grad(outs, [leaves[n] for n in names],
                                    grad_outputs=heads, allow_unused=True)
        return names, [g if g is not None else torch.zeros_like(leaves[n])
                       for n, g in zip(names, grads)]

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
