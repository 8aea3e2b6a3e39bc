"""Post-trace hazard checks over the aten graph a trace captured — the
program-layer audits.

The port of the reference's ``analysis/program_passes.py``. Where the
graph passes verify the declarative Symbol, these verify what a trace
of a function actually *captured*:

* ``baked-const`` — closure-captured tensors baked into the program as
  graph constants. Big ones bloat every program that holds them and
  make the closure part of its identity;
* ``f64-promotion`` — a program whose float *inputs* are narrower than
  float64 but which computes in float64 somewhere (2x memory, and
  float64 runs at a fraction of the card's float32 rate);
* ``host-callback`` — a node that makes the host wait for the device:
  ``aten._local_scalar_dense`` (``.item()``), a copy from the card to
  the host (``.cpu()``, ``.numpy()``), or a ``Custom`` op whose
  ``forward`` / ``backward`` run Python on the host;
* ``donation`` — an argument named in ``donate_argnums`` that the
  program returns unchanged (ERROR) or never reads (WARNING).

The reference traces with ``jax.make_jaxpr``; :func:`trace` traces
with ``torch.fx.experimental.proxy_tensor.make_fx`` on fake tensors
(the trace runs no FLOPs and allocates nothing on the card): the
tensor leaves of the arguments become placeholders, closure tensors
become ``get_attr`` constants, and a backward the function runs
(``torch.autograd.grad``) is traced too. The flash-attention kernels
are ``torch.library`` ops (``mxnet_tpu_torch::flash_attention_fwd``,
``_bwd_dq``, ``_bwd_dkv``) with fake implementations, so each launch is
one node, and a host ``Custom`` op is one ``mxnet_tpu_torch::host_custom``
node: neither is traced into.

Departure: torch has no x64 switch, so ``f64-promotion`` fires on any
float64 value computed from narrower float inputs. A Python or numpy
float scalar stays a weak scalar in torch (``x * np.float64(3.0)`` is
float32), which is what the reference sees without x64.
"""
from __future__ import annotations

import operator
from typing import Any, Dict, List, Optional, Tuple

import torch

from .findings import Report, Severity

__all__ = ["analyze_program", "analyze_graph", "trace"]

# captured consts >= the warn bound get flagged; >= the error bound they
# are memory hazards in their own right
CONST_BYTES_WARN = 1 << 16       # 64 KiB
CONST_BYTES_ERROR = 1 << 26      # 64 MiB

_HOST_CUSTOM = "mxnet_tpu_torch.host_custom.default"


def trace(fn, *args, **kwargs) -> Tuple[torch.fx.GraphModule, int]:
    """``fn(*args, **kwargs)`` traced by ``make_fx`` on fake tensors:
    ``(GraphModule, number of tensor leaves)``. Every tensor leaf of the
    arguments (pytrees: dicts, lists, tuples) becomes a placeholder, in
    flattening order; other leaves are held as they are."""
    from torch.fx.experimental.proxy_tensor import make_fx
    from torch.utils._pytree import tree_flatten, tree_unflatten

    leaves, spec = tree_flatten((args, kwargs))
    pos = [i for i, x in enumerate(leaves) if isinstance(x, torch.Tensor)]

    def flat_fn(*tensors):
        vals = list(leaves)
        for i, t in zip(pos, tensors):
            vals[i] = t
        a, k = tree_unflatten(vals, spec)
        return fn(*a, **k)

    gm = make_fx(flat_fn, tracing_mode="fake",
                 _allow_non_fake_inputs=True)(*[leaves[i] for i in pos])
    return gm, len(pos)


def _val(node):
    return node.meta.get("val")


def _tensors(val) -> List[torch.Tensor]:
    if isinstance(val, torch.Tensor):
        return [val]
    if isinstance(val, (list, tuple)):
        return [t for v in val for t in _tensors(v)]
    return []


def nbytes(t: torch.Tensor) -> int:
    return int(t.numel()) * t.element_size()


def target_name(node) -> str:
    """``aten.mm.default`` / ``mxnet_tpu_torch.flash_attention_fwd.default``:
    the op's namespace, name and overload."""
    t = node.target
    return str(t) if isinstance(t, torch._ops.OpOverload) \
        else getattr(t, "__name__", str(t))


def _constants(gm) -> List[Tuple[Any, torch.Tensor]]:
    out = []
    for node in gm.graph.nodes:
        if node.op == "get_attr":
            val = getattr(gm, node.target, None)
            if isinstance(val, torch.Tensor):
                out.append((node, val))
    return out


def _placeholders(gm) -> List[Any]:
    return [n for n in gm.graph.nodes if n.op == "placeholder"]


def _output_args(gm) -> List[Any]:
    from torch.utils._pytree import tree_leaves
    out = next(n for n in gm.graph.nodes if n.op == "output")
    return [a for a in tree_leaves(out.args)
            if isinstance(a, torch.fx.Node)]


def _is_float(dtype) -> bool:
    return dtype.is_floating_point


# ------------------------------------------------------------------ passes


def _check_baked_consts(report, gm, const_bytes_warn, const_bytes_error):
    for node, c in _constants(gm):
        n = nbytes(c)
        if n < const_bytes_warn:
            continue
        sev = Severity.ERROR if n >= const_bytes_error \
            else Severity.WARNING
        report.add(
            "baked-const", sev,
            "closure-captured constant %s%s (%d bytes) is baked into "
            "the program — pass it as an argument: baked constants "
            "bloat every program that holds them and make the closure "
            "part of the program's identity"
            % (str(c.dtype).replace("torch.", ""), list(c.shape), n),
            node=node.target,
            detail={"nbytes": n, "shape": list(c.shape)})


def _check_f64(report, gm):
    in_dtypes = [t.dtype for n in _placeholders(gm)
                 for t in _tensors(_val(n))]
    float_ins = [d for d in in_dtypes if _is_float(d)]
    if not float_ins or all(d == torch.float64 for d in float_ins):
        return   # no float inputs, or intentionally f64 end-to-end
    names = sorted({str(d).replace("torch.", "") for d in float_ins})
    for node, c in _constants(gm):
        if c.dtype == torch.float64:
            report.add(
                "f64-promotion", Severity.WARNING,
                "float64 constant %s captured in a program with %s "
                "inputs — arithmetic promotes to float64 (2x memory, a "
                "fraction of the float32 rate); cast the constant or use "
                "a python float" % (list(c.shape), names),
                node=node.target)
            return
    for node in gm.graph.nodes:
        if node.op != "call_function":
            continue
        if not any(t.dtype == torch.float64 for t in _tensors(_val(node))):
            continue
        srcs = sorted({str(t.dtype).replace("torch.", "")
                       for a in node.all_input_nodes
                       for t in _tensors(_val(a))})
        if "float64" in srcs:
            continue   # promotion happened upstream; report once
        report.add(
            "f64-promotion", Severity.WARNING,
            "op %r promotes %s to float64 — a float64 tensor or cast "
            "leaked into a %s program (2x memory, a fraction of the "
            "float32 rate)" % (target_name(node), srcs or ["(consts)"],
                               "/".join(names)),
            node=node.name,
            detail={"primitive": target_name(node), "input_dtypes": srcs})
        return


def _host_wait(node) -> bool:
    name = target_name(node)
    if name in ("aten._local_scalar_dense.default", _HOST_CUSTOM):
        return True
    if name in ("aten._to_copy.default", "aten.copy.default",
                "aten.copy_.default"):
        outs = _tensors(_val(node))
        ins = [t for a in node.all_input_nodes for t in _tensors(_val(a))]
        return any(t.device.type == "cpu" for t in outs) and \
            any(t.device.type != "cpu" for t in ins)
    return False


def _check_host_callbacks(report, gm):
    found: Dict[str, int] = {}
    for node in gm.graph.nodes:
        if node.op == "call_function" and _host_wait(node):
            name = target_name(node)
            found[name] = found.get(name, 0) + 1
    for name, count in found.items():
        report.add(
            "host-callback", Severity.WARNING,
            "%d %r node(s) in the program — each makes the host wait for "
            "the card (a scalar read, a copy to the host, or a Custom op "
            "running Python on the host) and stalls the pipeline every "
            "step" % (count, name),
            detail={"primitive": name, "count": count})


def _check_donation(report, gm, donate_argnums, n_args):
    if not donate_argnums:
        return
    donate = set(int(i) for i in donate_argnums)
    params = _placeholders(gm)
    bad = [i for i in donate if i >= len(params)]
    if bad or n_args != len(params):
        report.add(
            "donation", Severity.INFO,
            "cannot map donate_argnums %s onto %d flattened arguments — "
            "donation audit skipped (pass flat tensor arguments)"
            % (sorted(donate), len(params)))
        return
    outs = set(_output_args(gm))
    for i in sorted(donate):
        p = params[i]
        if p in outs:
            report.add(
                "donation", Severity.ERROR,
                "donated argument %d is returned unchanged — the output "
                "aliases the donated buffer while the caller's array is "
                "given up (donation-after-use: any later read of the "
                "input OR the aliased output observes garbage)" % i,
                detail={"argnum": i})
        elif not p.users:
            report.add(
                "donation", Severity.WARNING,
                "donated argument %d is never consumed by the program — "
                "the caller's buffer is given up for nothing (drop it "
                "from donate_argnums)" % i, detail={"argnum": i})


# -------------------------------------------------------------- entry points


def analyze_graph(gm, donate_argnums=(), n_args: Optional[int] = None,
                  const_bytes_warn: int = CONST_BYTES_WARN,
                  const_bytes_error: int = CONST_BYTES_ERROR,
                  context: str = "program") -> Report:
    """Run the program passes over an already-traced ``GraphModule``
    (the counterpart of the reference's ``analyze_jaxpr``)."""
    report = Report(context=context)
    _check_baked_consts(report, gm, const_bytes_warn, const_bytes_error)
    _check_f64(report, gm)
    _check_host_callbacks(report, gm)
    _check_donation(report, gm, donate_argnums,
                    len(_placeholders(gm)) if n_args is None else n_args)
    report.extras["program"] = {
        "nodes": sum(n.op == "call_function" for n in gm.graph.nodes),
        "ops": op_counts(gm)}
    return report


def op_counts(gm) -> Dict[str, int]:
    """Call nodes by op name (``aten.mm.default``,
    ``mxnet_tpu_torch.flash_attention_fwd``, ...)."""
    counts: Dict[str, int] = {}
    for node in gm.graph.nodes:
        if node.op == "call_function" and node.target is not \
                operator.getitem:
            name = target_name(node)
            counts[name] = counts.get(name, 0) + 1
    return counts


def analyze_program(fn, *args, donate_argnums=(),
                    const_bytes_warn: int = CONST_BYTES_WARN,
                    const_bytes_error: int = CONST_BYTES_ERROR,
                    context: str = "program", **kwargs) -> Report:
    """Trace ``fn(*args, **kwargs)`` (:func:`trace`) and audit the
    captured program.

    ``fn`` may be any function of tensors (an executor's graph function
    ``ex._fn`` among them) or an already-made ``GraphModule`` (then
    ``args`` are ignored). The trace is abstract — no FLOPs run, nothing
    is allocated on the card. ``Report.extras["program"]`` counts the
    call nodes by op."""
    if isinstance(fn, torch.fx.GraphModule):
        gm, n_args = fn, None
    else:
        gm, n_args = trace(fn, *args, **kwargs)
    return analyze_graph(gm, donate_argnums=donate_argnums, n_args=n_args,
                         const_bytes_warn=const_bytes_warn,
                         const_bytes_error=const_bytes_error,
                         context=context)
