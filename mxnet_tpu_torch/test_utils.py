"""Testing oracles (``mt.test_utils``).

The port's copy of the reference package's ``test_utils.py`` (reference
MXNet: ``python/mxnet/test_utils.py``): numpy is the reference
implementation, :func:`check_numeric_gradient` holds a backward against
central finite differences, and :func:`check_consistency` runs one
computation on several contexts and compares them.

The contexts are the port's: :func:`default_context` is the current
context (the card unless the caller entered ``with mt.cpu():``) and
never falls back to the host; :func:`check_consistency` compares the
host with the first card where the reference compares it with the
first TPU.
"""
from __future__ import annotations

import os
from typing import Callable, Dict, List, Mapping, Optional, Sequence, Union

import numpy as np

from . import autograd
from . import ndarray as nd
from .context import Context, cpu, current_context

__all__ = [
    "default_context", "set_default_context", "assert_almost_equal",
    "almost_equal", "same", "rand_ndarray", "random_arrays",
    "check_numeric_gradient", "check_symbolic_forward",
    "check_symbolic_backward", "check_consistency", "numeric_grad",
]

_default_ctx: Optional[Context] = None


def default_context() -> Context:
    """The context tests run on: the one :func:`set_default_context`
    set, else ``MXNET_TEST_DEFAULT_CTX`` (``"gpu:0"``, ``"cpu"``), else
    the current context (raises without a GPU unless the caller is in a
    CPU scope)."""
    if _default_ctx is not None:
        return _default_ctx
    env = os.environ.get("MXNET_TEST_DEFAULT_CTX")
    if env:
        kind, _, idx = env.partition(":")
        return Context(kind, int(idx or 0))
    return current_context()


def set_default_context(ctx: Optional[Context]) -> None:
    global _default_ctx
    _default_ctx = ctx


def same(a: np.ndarray, b: np.ndarray) -> bool:
    return np.array_equal(np.asarray(a), np.asarray(b))


def almost_equal(a, b, rtol=1e-5, atol=1e-8) -> bool:
    return np.allclose(_to_np(a), _to_np(b), rtol=rtol, atol=atol)


def _to_np(x):
    if isinstance(x, nd.NDArray):
        return x.asnumpy()
    return np.asarray(x)


def assert_almost_equal(a, b, rtol=1e-5, atol=1e-8, names=("a", "b")) -> None:
    """Raise ``AssertionError`` naming the worst element unless ``a``
    and ``b`` have one shape and agree within ``rtol`` / ``atol``."""
    a, b = _to_np(a), _to_np(b)
    if a.shape != b.shape:
        raise AssertionError("shape mismatch: %s=%s vs %s=%s"
                             % (names[0], a.shape, names[1], b.shape))
    if not np.allclose(a, b, rtol=rtol, atol=atol):
        err = np.abs(a - b)
        rel = err / (np.abs(b) + atol)
        idx = np.unravel_index(np.argmax(rel), rel.shape)
        raise AssertionError(
            "%s and %s differ: max rel err %g at %s (%g vs %g), "
            "max abs err %g" % (names[0], names[1], float(rel.max()), idx,
                                a[idx], b[idx], float(err.max())))


def random_arrays(*shapes, dtype=np.float32) -> List[np.ndarray]:
    """One standard-normal array per shape, from the global numpy
    state (a 0-d array for ``()``)."""
    return [np.random.randn(*s).astype(dtype) if s else
            np.array(np.random.randn(), dtype=dtype) for s in shapes]


def rand_ndarray(shape, ctx=None, dtype=np.float32) -> nd.NDArray:
    return nd.array(np.random.randn(*shape).astype(dtype), ctx=ctx)


# ------------------------------------------------------------------ gradient


def numeric_grad(f: Callable[[Mapping[str, np.ndarray]], float],
                 location: Dict[str, np.ndarray],
                 wrt: Sequence[str],
                 eps: float = 1e-4) -> Dict[str, np.ndarray]:
    """Central-difference gradient of a scalar function of named numpy
    arrays (float64), perturbing ``location`` in place and restoring
    it."""
    grads = {}
    for name in wrt:
        base = location[name]
        g = np.zeros_like(base, dtype=np.float64)
        flat = base.reshape(-1)
        gflat = g.reshape(-1)
        for i in range(flat.size):
            orig = flat[i]
            flat[i] = orig + eps
            fp = f(location)
            flat[i] = orig - eps
            fm = f(location)
            flat[i] = orig
            gflat[i] = (fp - fm) / (2 * eps)
        grads[name] = g.reshape(base.shape)
    return grads


def _projection(shape) -> np.ndarray:
    """The fixed head gradient the checks reduce an output with."""
    rng = np.random.RandomState(802)
    return rng.uniform(0.5, 1.5, size=shape).astype(np.float32)


def check_numeric_gradient(fn: Union[Callable, "object"],
                           location: Union[Dict[str, np.ndarray],
                                           Sequence[np.ndarray]],
                           aux_states: Optional[Dict[str, np.ndarray]] = None,
                           numeric_eps: float = 1e-3,
                           rtol: float = 2e-2,
                           atol: float = 2e-3,
                           grad_nodes: Optional[Sequence[str]] = None,
                           ctx: Optional[Context] = None) -> None:
    """Finite-difference-check the autograd backward of ``fn``.

    ``fn`` is a callable taking NDArrays (by name for a dict
    ``location``, by position for a list) and returning one NDArray, or
    a Symbol. The output is reduced with a fixed random projection, so
    the head gradient is not trivial. ``ctx`` None is the current
    context.
    """
    if hasattr(fn, "list_arguments"):  # Symbol
        sym = fn
        if isinstance(location, (list, tuple)):
            location = dict(zip(sym.list_arguments(), location))
        fwd = _symbol_forward_fn(sym, aux_states, ctx)
        return check_numeric_gradient(fwd, location, None, numeric_eps, rtol,
                                      atol, grad_nodes, ctx)

    if isinstance(location, (list, tuple)):
        location = {"arg%d" % i: v for i, v in enumerate(location)}
        positional = True
    else:
        positional = False
    location = {k: np.asarray(v, dtype=np.float64).astype(np.float32)
                for k, v in location.items()}
    names = list(location.keys())
    wrt = list(grad_nodes) if grad_nodes is not None else names

    def call(nds):
        out = fn(*nds.values()) if positional else fn(**nds)
        return out[0] if isinstance(out, (list, tuple)) else out

    def scalar_f(vals: Mapping[str, np.ndarray]) -> float:
        out = call({k: nd.array(v.astype(np.float32), ctx=ctx)
                    for k, v in vals.items()})
        return float(np.sum(out.asnumpy().astype(np.float64) * proj))

    # the gradient through autograd
    nds = {k: nd.array(v, ctx=ctx) for k, v in location.items()}
    for k in wrt:
        nds[k].attach_grad()
    with autograd.record():
        out = call(nds)
    proj = _projection(out.shape)
    out.backward(out_grad=nd.array(proj, ctx=out.context))
    sym_grads = {k: nds[k].grad.asnumpy() for k in wrt}

    num_grads = numeric_grad(scalar_f, location, wrt, eps=numeric_eps)
    for k in wrt:
        assert_almost_equal(sym_grads[k], num_grads[k].astype(np.float32),
                            rtol=rtol, atol=atol,
                            names=("autograd[%s]" % k, "numeric[%s]" % k))


def _symbol_forward_fn(sym, aux_states, ctx):
    """A Symbol as an imperative callable over NDArrays, so its
    evaluation is recorded on the autograd tape."""
    from .symbol.symbol import _topo_order

    nodes = _topo_order(sym._entries)

    def fwd(**kwargs):
        vals = {}
        for node in nodes:
            if node.is_variable:
                if node.name in kwargs:
                    v = kwargs[node.name]
                elif aux_states and node.name in aux_states:
                    a = aux_states[node.name]
                    v = a if isinstance(a, nd.NDArray) else \
                        nd.array(a, ctx=ctx)
                else:
                    raise ValueError("missing input %r" % node.name)
                vals[(id(node), 0)] = v
                continue
            ins = [vals[(id(n), i)] for n, i in node.inputs]
            attrs = {k: v for k, v in node.attrs.items() if k != "name"}
            out = nd.imperative_invoke(node.op, *ins, **attrs)
            outs = out if isinstance(out, (list, tuple)) else [out]
            for i, o in enumerate(outs):
                vals[(id(node), i)] = o
        results = [vals[(id(n), i)] for n, i in sym._entries]
        return results[0] if len(results) == 1 else results

    return fwd


def check_symbolic_forward(sym, location, expected, rtol=1e-4, atol=1e-6,
                           aux_states=None, ctx=None) -> None:
    """Forward outputs against numpy expectations."""
    outs = _eval_fn_or_sym(sym, location, aux_states, ctx)
    if not isinstance(outs, (list, tuple)):
        outs = [outs]
    for i, (o, e) in enumerate(zip(outs, expected)):
        assert_almost_equal(o, e, rtol=rtol, atol=atol,
                            names=("output[%d]" % i, "expected[%d]" % i))


def check_symbolic_backward(sym, location, out_grads, expected, rtol=1e-4,
                            atol=1e-6, grad_nodes=None, ctx=None) -> None:
    """Input gradients under the head gradient ``out_grads`` against
    numpy expectations (a dict by name, or a list in ``grad_nodes``
    order)."""
    if hasattr(sym, "list_arguments"):
        fn = _symbol_forward_fn(sym, None, ctx)
        if isinstance(location, (list, tuple)):
            location = dict(zip(sym.list_arguments(), location))
    else:
        fn = sym
    nds = {k: nd.array(v, ctx=ctx) for k, v in location.items()}
    wrt = list(grad_nodes) if grad_nodes is not None else list(nds)
    for k in wrt:
        nds[k].attach_grad()
    with autograd.record():
        out = fn(**nds)
        if isinstance(out, (list, tuple)):
            out = out[0]
    og = out_grads[0] if isinstance(out_grads, (list, tuple)) else out_grads
    out.backward(out_grad=nd.array(og, ctx=out.context))
    items = expected.items() if isinstance(expected, dict) \
        else zip(wrt, expected)
    for k, e in items:
        assert_almost_equal(nds[k].grad, e, rtol=rtol, atol=atol,
                            names=("grad[%s]" % k, "expected[%s]" % k))


def _eval_fn_or_sym(sym, location, aux_states, ctx):
    if hasattr(sym, "list_arguments"):
        if isinstance(location, (list, tuple)):
            location = dict(zip(sym.list_arguments(), location))
        return sym.eval(ctx=ctx, aux_states=aux_states,
                        **{k: nd.array(v, ctx=ctx)
                           for k, v in location.items()})
    if isinstance(location, dict):
        return sym(**{k: nd.array(v, ctx=ctx) for k, v in location.items()})
    return sym(*[nd.array(v, ctx=ctx) for v in location])


def check_consistency(fn, locations, ctx_list=None, rtol=1e-3, atol=1e-5):
    """Run ``fn(**arrays)`` on each context of ``ctx_list`` (default the
    host and, when there is one, the first card), each inside that
    context's scope so that arrays ``fn`` makes land there too, and
    hold every result to the first one. Returns the results as numpy
    arrays."""
    from .context import gpu, num_devices
    if ctx_list is None:
        ctx_list = [cpu(0)]
        if num_devices("gpu"):
            ctx_list.append(gpu(0))
    outs = []
    for ctx in ctx_list:
        with ctx:
            nds = {k: nd.array(v, ctx=ctx) for k, v in locations.items()}
            o = fn(**nds)
            if isinstance(o, (list, tuple)):
                o = o[0]
            outs.append(o.asnumpy())
    for o in outs[1:]:
        assert_almost_equal(outs[0], o, rtol=rtol, atol=atol)
    return outs
