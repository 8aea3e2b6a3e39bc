"""One op by name in both packages: the shared helper of the port's op
tests, the registry guard and the cross-package sweep's case lists.

:func:`run_both` feeds the same numpy inputs to the reference op
(``jax.vjp`` of its function) and to the port's (``torch.autograd``),
forward and the gradient of every input under one random head, and
:func:`check_op` holds the port to the reference: each output within
``FWD_RTOL``·max(1, max|ref|), each gradient within ``GRAD_RTOL``·max(1,
max|ref|). NaN must stand where the reference has NaN. The op files
``tests/test_torch_ops_{elemwise,indexing,matrix,nn_heads}.py`` run the
sweep of their reference family at ``tests/test_op_sweep.py``'s inputs
(``_spec_for``) through it.

The head covers an op's visible outputs (not BatchNorm's batch
statistics nor any op's updated aux states, which are commits, not
results), and the gradients compared are those of its inputs but the
aux states: the reference differentiates BatchNorm's moving statistics
through its inference forward, which torch's kernel does not, and no
caller of either package asks for that gradient.

``requires_cuda`` (registered in ``pytest.ini``) marks a test that needs
the card; here it skips, and ``chip_smoke.py`` phase 12 runs the sweep
on the card.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import test_op_sweep as ref_sweep
from mxnet_tpu.ops import OP_REGISTRY as REF_REGISTRY
from mxnet_tpu_torch.ops import OP_REGISTRY

FWD_RTOL = 1e-5
GRAD_RTOL = 1e-4

# the reference's op files of the op library (A1) swept at
# test_op_sweep.py's inputs, and its structured families (A1b), held by
# their own files (tests/test_torch_ops_{vision,detection,contrib}.py)
FAMILIES = ("elemwise", "indexing", "init_op", "matrix", "reduce", "nn",
            "random_op")
STRUCTURED = ("vision", "detection", "contrib")
# registered in the port under the reference's names, but raising: the
# MoE op and expert parallelism are ROADMAP.md queue A9
NOT_PORTED = {"MoE"}


def family_of(name):
    """The reference file (``mxnet_tpu/ops/<family>.py``) of an op."""
    return REF_REGISTRY[name].fn.__module__.rsplit(".", 1)[-1]


def _canonical(registry):
    return {op.name for op in registry.values()}


SHARED = sorted(_canonical(REF_REGISTRY) & _canonical(OP_REGISTRY))


def sweep_names(*families):
    """The shared canonical ops of ``families`` that the cross-package
    sweep runs: every one but the samplers (compared by distribution,
    ``test_torch_ops_random.py``) and those ``test_op_sweep.py`` leaves
    to a dedicated file (the port's counterparts have their own)."""
    return [n for n in SHARED if family_of(n) in families and
            not REF_REGISTRY[n].is_random and
            n not in ref_sweep.COVERED_ELSEWHERE]


def _visible(op, outs):
    return outs[:len(outs) - op.num_aux - op.num_hidden_outputs]


def _heads(outs, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(o.shape).astype(o.dtype) for o in outs]


def _floating(a):
    return np.issubdtype(np.asarray(a).dtype, np.floating)


def run_both(name, inputs, attrs=None, seed=0, ref_attrs=None, jit=False):
    """Run op ``name`` in both packages on ``inputs`` (numpy arrays):
    returns ``(ref, port)``, each a dict with ``outs`` (numpy arrays,
    every output) and ``grads`` (one numpy array per input but the aux
    states, zeros where the input gets none; None when the op has no
    floating visible output). ``ref_attrs`` adds attributes only the
    reference's function takes (a sampler key). With ``jit`` the
    reference's function runs under ``jax.jit``, as its executor runs a
    graph: one compile instead of one per primitive, for ops of many
    primitives (the detection family)."""
    attrs = dict(attrs or {})
    rop, pop = REF_REGISTRY[name], OP_REGISTRY[name]
    n_grad = len(inputs) - pop.num_aux

    def ref_fn(*xs):
        out = rop.fn(*xs, **attrs, **(ref_attrs or {}))
        return out if isinstance(out, tuple) else (out,)

    if jit:
        ref_fn = jax.jit(ref_fn)

    xs = [jnp.asarray(a) for a in inputs]
    outs, vjp = jax.vjp(ref_fn, *xs)
    outs_np = [np.asarray(o) for o in outs]
    vis = _visible(rop, outs_np)
    heads = _heads(vis, seed + 1)
    ref = {"outs": outs_np, "grads": None}
    if vis and all(_floating(o) for o in vis):
        cts = [jnp.asarray(h) for h in heads] + \
            [jnp.zeros_like(o) for o in outs[len(vis):]]
        gs = vjp(tuple(cts))
        ref["grads"] = [np.zeros(np.shape(a), np.float32)
                        if g.dtype == jax.dtypes.float0 else np.asarray(g)
                        for a, g in zip(inputs[:n_grad], gs)]

    ts = [torch.from_numpy(np.array(a)) for a in inputs]
    for t in ts[:n_grad]:
        if t.is_floating_point():
            t.requires_grad_(True)
    pattrs = dict(attrs)
    if pop.num_inputs == 0:
        pattrs["_device"] = torch.device("cpu")
    pout = pop.fn(*ts, **pattrs)
    pout = pout if isinstance(pout, tuple) else (pout,)
    port = {"outs": [o.detach().float().numpy()
                     if o.dtype == torch.bfloat16 else o.detach().numpy()
                     for o in pout], "grads": None}
    pvis = _visible(pop, list(pout))
    if ref["grads"] is not None:
        live = [(o, torch.from_numpy(h)) for o, h in zip(pvis, heads)
                if o.requires_grad]
        want = [t for t in ts[:n_grad] if t.requires_grad]
        got = torch.autograd.grad([o for o, _ in live], want,
                                  [h for _, h in live], allow_unused=True) \
            if live and want else [None] * len(want)
        it = iter(got)
        port["grads"] = []
        for t in ts[:n_grad]:
            g = next(it) if t.requires_grad else None
            port["grads"].append(np.zeros(t.shape, np.float32) if g is None
                                 else g.numpy())
    return ref, port


def assert_close(got, want, rtol, what):
    """``got`` within ``rtol``·max(1, max|want|) of ``want`` elementwise,
    NaN where ``want`` is NaN, and of its shape."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    g64, w64 = got.astype(np.float64), want.astype(np.float64)
    assert np.array_equal(np.isnan(g64), np.isnan(w64)), (what, got, want)
    fin = ~np.isnan(w64)
    scale = max(1.0, float(np.abs(w64[fin]).max(initial=0.0)))
    np.testing.assert_allclose(g64[fin], w64[fin], rtol=0,
                               atol=rtol * scale, err_msg=what)


def check_op(name, inputs, attrs=None, seed=0, grads=True, jit=False):
    """The port's op ``name`` against the reference's: every output
    (values and dtype) and, with ``grads``, every input gradient
    (``jit``: :func:`run_both`'s)."""
    ref, port = run_both(name, inputs, attrs, seed, jit=jit)
    assert len(port["outs"]) == len(ref["outs"]), name
    for i, (g, w) in enumerate(zip(port["outs"], ref["outs"])):
        if w.dtype != jnp.bfloat16:
            assert g.dtype == w.dtype, (name, i, g.dtype, w.dtype)
        assert_close(g, w, FWD_RTOL, "%s output %d" % (name, i))
    if grads and ref["grads"] is not None:
        for i, (g, w) in enumerate(zip(port["grads"], ref["grads"])):
            assert_close(g, w, GRAD_RTOL, "%s gradient of input %d"
                         % (name, i))
    return ref, port


def sweep_case(name):
    """The sweep's inputs and attributes for ``name``:
    ``test_op_sweep._spec_for``'s."""
    inputs, kwargs, _, _ = ref_sweep._spec_for(name)
    return [np.asarray(a) for a in inputs], dict(kwargs)


# ------------------------------------------------------------------ tests

def test_the_op_library_is_registered_in_the_port():
    """Every name (canonical and alias) that the reference's op library
    files and its structured families (vision, detection, contrib)
    register is registered in the port, for the same op; the one
    exemption, ``MoE`` (A9), is registered too but raises, naming A9."""
    families = FAMILIES + STRUCTURED
    missing = sorted(n for n in REF_REGISTRY
                     if family_of(n) in families and n not in OP_REGISTRY)
    assert missing == []
    differ = sorted(n for n in REF_REGISTRY
                    if family_of(n) in families and
                    OP_REGISTRY[n].name != REF_REGISTRY[n].name)
    assert differ == []
    assert {REF_REGISTRY[n].name for n in REF_REGISTRY
            if family_of(n) in STRUCTURED} >= NOT_PORTED
    x = torch.zeros((2, 4))
    for name in NOT_PORTED:
        for alias in OP_REGISTRY[name].aliases:
            with pytest.raises(Exception, match="A9"):
                OP_REGISTRY[alias].fn(x, x, x, x)


def test_samplers_are_random_in_both_registries():
    names = {n for n in REF_REGISTRY if REF_REGISTRY[n].is_random}
    assert names == {n for n in OP_REGISTRY if OP_REGISTRY[n].is_random}


def test_every_family_has_a_sweep():
    """The sweep covers each shared op of the library's families but the
    samplers and the dedicated ones, and ``_spec_for`` serves each."""
    names = sweep_names(*FAMILIES)
    assert len(names) >= 159
    for n in names:
        sweep_case(n)


def test_check_op_catches_a_wrong_gradient(monkeypatch):
    """The helper fails on a port op whose gradient is off (the
    forward is right)."""
    right = OP_REGISTRY["square"].fn

    class _Twice(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x):
            ctx.save_for_backward(x)
            return x * x

        @staticmethod
        def backward(ctx, g):
            (x,) = ctx.saved_tensors
            return 2.2 * x * g

    x = np.linspace(-1, 1, 6, dtype=np.float32).reshape(2, 3)
    check_op("square", [x])
    monkeypatch.setattr(OP_REGISTRY["square"], "fn", _Twice.apply)
    with pytest.raises(AssertionError, match="gradient of input 0"):
        check_op("square", [x])
    monkeypatch.setattr(OP_REGISTRY["square"], "fn", right)


def test_assert_close_requires_the_reference_nans():
    assert_close([1.0, np.nan], [1.0, np.nan], 1e-5, "nan")
    with pytest.raises(AssertionError):
        assert_close([1.0, 0.0], [1.0, np.nan], 1e-5, "nan")


@pytest.mark.requires_cuda
def test_ops_on_the_card_match_the_cpu():
    """A few ops of each family on ``cuda:0`` against the CPU (the whole
    sweep runs in ``chip_smoke.py`` phase 12)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    for name in ("broadcast_mod", "topk", "dot", "LRN", "pick"):
        inputs, attrs = sweep_case(name)
        op = OP_REGISTRY[name]
        cpu = op.fn(*[torch.from_numpy(a) for a in inputs], **attrs)
        gpu = op.fn(*[torch.from_numpy(a).cuda() for a in inputs], **attrs)
        assert_close(gpu.cpu().numpy(), cpu.numpy(), FWD_RTOL, name)
