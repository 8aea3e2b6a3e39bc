"""Operator registry — one plain function over torch tensors per op.

The port's counterpart of the reference's ``ops/registry.py``: the same
``register(name, num_inputs, aliases)`` decorator and ``get_op`` lookup,
with the reference's op names and aliases, so that a Symbol JSON file
written by the reference names ops that exist here. Shapes are inferred
by running the same function on meta tensors (``symbol.infer_shape``)
and gradients come from ``torch.autograd``; ops whose gradient is not
the derivative of their forward (loss heads, LayerNorm's analytic
backward, flash attention) are ``torch.autograd.Function``\\ s.

Ops without array inputs (``num_inputs=0``, e.g. ``_arange``) take the
device to create their result on as the keyword ``_device``.

An op with several outputs returns a tuple and declares
``num_outputs`` (an int, or a function of the node's attributes); a
Symbol node of it has that many outputs. An op whose function cannot run
on meta tensors (a user kernel, a custom op) declares ``meta_fn``, a
function of the same arguments that returns meta tensors of the output
shapes, and ``infer_shape`` calls it instead.

An op with auxiliary state (BatchNorm's moving statistics) declares
``num_aux``: its last ``num_aux`` tensor inputs are the aux states, and
its last ``num_aux`` outputs their updated values, which the caller
commits (the executor after a training forward, ``imperative_invoke``
into the arrays it was given). ``num_hidden_outputs`` more outputs come
before that tail (BatchNorm's batch mean and variance); neither kind is
listed by ``list_outputs`` or bound as a head of the graph.
"""
from __future__ import annotations

import functools
import inspect
from typing import Callable, Dict, List, Optional, Sequence, Union

__all__ = ["OpDef", "register", "get_op", "OP_REGISTRY"]

_PARAM_INPUTS = ("weight", "bias", "gamma", "beta", "label",
                 "moving_mean", "moving_var", "moving_avg")


class OpDef:
    """A registered operator: ``fn(*tensors, **attrs)``."""

    def __init__(self, name: str, fn: Callable,
                 num_inputs: Optional[int] = 1,
                 num_outputs: Union[int, Callable] = 1,
                 meta_fn: Optional[Callable] = None,
                 num_aux: int = 0, num_hidden_outputs: int = 0):
        self.name = name
        self.fn = fn
        self.num_inputs = num_inputs
        self.num_outputs = num_outputs
        self.meta_fn = meta_fn
        self.num_aux = num_aux
        self.num_hidden_outputs = num_hidden_outputs
        # an op whose inputs depend on its attributes (Custom: the Prop
        # lists them) sets this to a function of the attributes
        self.input_names_fn: Optional[Callable] = None
        self.aliases: List[str] = [name]
        self.__doc__ = fn.__doc__
        self._input_names: Optional[List[str]] = None
        self._aux_input_names: List[str] = []

    @property
    def input_names(self) -> List[str]:
        """Names of the op's tensor inputs other than its aux states,
        derived from the function's signature as the reference derives
        them: leading parameters without a default, plus the defaulted
        parameter inputs (weight, bias, gamma, beta, label and the
        moving statistics); ``num_inputs`` counts the aux states too."""
        if self._input_names is None:
            names: List[str] = []
            for p in inspect.signature(self.fn).parameters.values():
                if p.kind is p.VAR_POSITIONAL:
                    names.append("data")
                    break
                if p.kind not in (p.POSITIONAL_ONLY,
                                  p.POSITIONAL_OR_KEYWORD):
                    break
                if self.num_inputs is not None and \
                        len(names) >= self.num_inputs:
                    break
                if p.default is inspect.Parameter.empty or \
                        p.name in _PARAM_INPUTS:
                    names.append(p.name)
                else:
                    break
            if not names and self.num_inputs != 0:
                names = ["data"]
            if self.num_aux:
                self._aux_input_names = names[-self.num_aux:]
                names = names[:-self.num_aux]
            self._input_names = names
        return self._input_names

    @property
    def aux_input_names(self) -> List[str]:
        """Names of the trailing aux-state inputs (``moving_mean``,
        ``moving_var`` for BatchNorm)."""
        _ = self.input_names        # derives both lists
        return self._aux_input_names

    @functools.cached_property
    def takes_is_train(self) -> bool:
        """Whether the function takes ``_is_train`` (the training flag
        that ``imperative_invoke`` and the executor pass)."""
        return "_is_train" in self.param_names

    @property
    def param_names(self) -> List[str]:
        """Positional or keyword parameters of the function."""
        return [p.name for p in inspect.signature(self.fn).parameters.values()
                if p.kind in (p.POSITIONAL_ONLY, p.POSITIONAL_OR_KEYWORD,
                              p.KEYWORD_ONLY)]

    def __call__(self, *args, **kwargs):
        return self.fn(*args, **kwargs)

    def __repr__(self):
        return "OpDef(%s)" % self.name


OP_REGISTRY: Dict[str, OpDef] = {}


def register(name: Optional[str] = None, num_inputs: Optional[int] = 1,
             aliases: Sequence[str] = (),
             num_outputs: Union[int, Callable] = 1,
             meta_fn: Optional[Callable] = None, num_aux: int = 0,
             num_hidden_outputs: int = 0):
    """Decorator: register a function over tensors as an op."""

    def _reg(fn: Callable) -> OpDef:
        opname = name or fn.__name__
        op = OpDef(opname, fn, num_inputs=num_inputs,
                   num_outputs=num_outputs, meta_fn=meta_fn,
                   num_aux=num_aux, num_hidden_outputs=num_hidden_outputs)
        for n in (opname,) + tuple(aliases):
            if n in OP_REGISTRY:
                raise ValueError("Op %s already registered" % n)
            OP_REGISTRY[n] = op
        op.aliases.extend(aliases)
        functools.update_wrapper(op, fn, updated=())
        return op

    return _reg


def get_op(name: str) -> OpDef:
    try:
        return OP_REGISTRY[name]
    except KeyError:
        raise KeyError("Operator %r not registered (have %d ops)"
                       % (name, len(OP_REGISTRY))) from None
