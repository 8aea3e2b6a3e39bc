"""The port's analyzer (``mxnet_tpu_torch.analysis``) against the
reference's ``tests/test_analysis.py``.

Graph passes: the same graphs, built by one function in both packages,
give the same finding codes, severities and node names. Program passes:
the reference's cases written in torch (the trace is ``make_fx`` on
fake tensors, not ``jax.make_jaxpr``), each held to the reference
test's own assertions; the f64 departure (torch has no x64 switch) is
held to hand-computed expectations. The bind hook under
``MXNET_TPU_ANALYZE`` off / warn / strict, the lint and its baseline on
the reference's sources in both packages, the port's own baseline over
``mxnet_tpu_torch/``, the CLI, and the import hygiene.

Last, ``chip_smoke.py``'s phase 20 rehearsed on the CPU at a small width
(the LM at 2 layers, ResNet-18 at 64x64), the CUDA-only calls stood in
for and the attention kernels replaced by counting wrappers around
their plain versions. It lives in this many-test file so that the test
scheduler does not run it last, beside the reference's timing gates.
"""
import logging
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import mxnet_tpu as mx
import mxnet_tpu_torch as mt
from mxnet_tpu import analysis as jan
from mxnet_tpu_torch import analysis as tan
from mxnet_tpu_torch.analysis import Severity
from mxnet_tpu_torch.base import MXNetError

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
import chip_smoke  # noqa: E402
sys.path.insert(0, os.path.join(REPO, "tests"))
from test_torch_wgmma_support import (_Event, _counting,  # noqa: E402
                                      _plain_dkv, _plain_dq)

# test files run side by side in parallel workers: each keeps torch's
# intra-op pool small
torch.set_num_threads(2)

CPU = mt.cpu()


def codes(report, code=None):
    if code is None:
        return [f.code for f in report]
    return [f for f in report if f.code == code]


def summary(report):
    """What both packages must agree on: codes, severities and nodes."""
    return sorted((f.code, f.severity.name, f.node or "") for f in report)


def both(build, **kw):
    """``build(pkg)`` -> (symbol, input_shapes) analyzed in each package;
    returns (reference report, port report)."""
    out = []
    for pkg, an in ((mx, jan), (mt, tan)):
        sym, shapes = build(pkg)
        extra = {} if an is jan else {"calibrate_remat": False}
        out.append(an.analyze_symbol(sym, input_shapes=shapes, **kw,
                                     **extra))
    return out


# ===================================================== graph passes


def _cycle(pkg):
    a = pkg.sym.Variable("a")
    s1 = pkg.sym.broadcast_add(a, a, name="s1")
    s2 = pkg.sym.broadcast_add(s1, a, name="s2")
    s1._entries[0][0].inputs.append((s2._entries[0][0], 0))
    return s2, None


def _diamond(pkg):
    a = pkg.sym.Variable("a")
    return pkg.sym.broadcast_add(pkg.sym.relu(a, name="left"),
                                 pkg.sym.tanh(a, name="right"),
                                 name="join"), {"a": (4, 4)}


def _dup_vars(pkg):
    return pkg.sym.broadcast_add(pkg.sym.Variable("x"), pkg.sym.Variable("x"),
                                 name="plus"), None


def _dup_ops(pkg):
    d = pkg.sym.Variable("data")
    f1 = pkg.sym.FullyConnected(d, num_hidden=4, name="fc")
    return pkg.sym.FullyConnected(f1, num_hidden=4, name="fc"), None


def _unique(pkg):
    d = pkg.sym.Variable("data")
    net = pkg.sym.FullyConnected(d, num_hidden=4, name="fc1")
    return pkg.sym.FullyConnected(net, num_hidden=2, name="fc2"), \
        {"data": (2, 8)}


def _dead(pkg):
    x = pkg.sym.Variable("data")
    parts = pkg.sym.SliceChannel(x, num_outputs=3, axis=1, name="split")
    return parts[0], {"data": (2, 6)}


def _all_used(pkg):
    x = pkg.sym.Variable("data")
    parts = pkg.sym.SliceChannel(x, num_outputs=2, axis=1, name="split")
    return pkg.sym.broadcast_add(parts[0], parts[1], name="sum"), \
        {"data": (2, 6)}


def _unused_input(pkg):
    d = pkg.sym.Variable("data")
    return pkg.sym.FullyConnected(d, num_hidden=4, name="fc"), \
        {"data": (2, 8), "weihgt": (4, 8)}


def _shape_conflict(pkg):
    d = pkg.sym.Variable("data")
    w = pkg.sym.Variable("w", shape=(7, 5))       # wrong: data is (4, 11)
    return pkg.sym.FullyConnected(d, w, num_hidden=7, no_bias=True,
                                  name="fc_bad"), {"data": (4, 11)}


GRAPHS = {"cycle": _cycle, "diamond": _diamond, "dup_vars": _dup_vars,
          "dup_ops": _dup_ops, "unique": _unique, "dead": _dead,
          "all_used": _all_used, "unused_input": _unused_input,
          "shape_conflict": _shape_conflict}


@pytest.mark.parametrize("case", sorted(GRAPHS))
def test_graph_pass_parity(case):
    """The same graph through both packages: the same codes, severities
    and node names (the reference's test_cycle_detected through
    test_unused_input_binding and the shape-conflict case)."""
    ref, port = both(GRAPHS[case])
    assert summary(port) == summary(ref)


def test_cycle_detected():
    report = tan.analyze_symbol(_cycle(mt)[0])
    hits = codes(report, "cycle")
    assert hits and hits[0].severity == Severity.ERROR
    assert "cycle" in hits[0].message
    assert not codes(tan.analyze_symbol(_diamond(mt)[0]), "cycle")


def test_duplicate_names():
    hits = codes(tan.analyze_symbol(_dup_vars(mt)[0]), "dup-name")
    assert hits and hits[0].severity == Severity.ERROR
    assert "'x'" in hits[0].message
    assert codes(tan.analyze_symbol(_dup_ops(mt)[0]), "dup-name")
    sym, shapes = _unique(mt)
    report = tan.analyze_symbol(sym, input_shapes=shapes)
    assert not codes(report, "dup-name") and not codes(report, "dead-node")
    assert not report.errors


def test_dead_output_and_unused_input():
    sym, shapes = _dead(mt)
    hits = codes(tan.analyze_symbol(sym, input_shapes=shapes), "dead-node")
    assert hits and hits[0].node == "split"
    assert "[1, 2]" in hits[0].message
    sym, shapes = _all_used(mt)
    assert not codes(tan.analyze_symbol(sym, input_shapes=shapes),
                     "dead-node")
    sym, shapes = _unused_input(mt)
    hits = codes(tan.analyze_symbol(sym, input_shapes=shapes),
                 "unused-input")
    assert hits and "weihgt" in hits[0].message


def test_structural_passes_run_before_the_shape_pass():
    order = [c for c, _ in tan.GRAPH_PASSES]
    assert order == [c for c, _ in jan.GRAPH_PASSES
                     if c in order], (order, jan.GRAPH_PASSES)
    assert order[:4] == ["cycle", "dup-name", "dead-node", "shape-error"]
    assert order[-1] == "hbm-budget"


def test_symbol_analyze_kwargs_form():
    d = mt.sym.Variable("data")
    net = mt.sym.FullyConnected(d, num_hidden=4, name="fc")
    report = net.analyze(data=(2, 8))
    assert "cost" in report.extras
    ref = mx.sym.FullyConnected(mx.sym.Variable("data"), num_hidden=4,
                                name="fc").analyze(data=(2, 8))
    assert report.extras["cost"]["flops"] == ref.extras["cost"]["flops"]
    assert report.extras["cost"]["peak_bytes"] == \
        ref.extras["cost"]["peak_bytes"]


def test_mt_analysis_lazy_attribute():
    assert mt.analysis.Severity is Severity
    with pytest.raises(AttributeError):
        mt.no_such_subsystem


def test_zoo_nets_zero_errors():
    from mxnet_tpu_torch.analysis.__main__ import _zoo_symbol
    for name in ("resnet8", "transformer", "mlp"):
        net, shapes = _zoo_symbol(name)
        report = tan.analyze_symbol(net, input_shapes=shapes,
                                    calibrate_remat=False)
        assert not report.errors, report.format(Severity.ERROR)


# ===================================================== program passes


def test_baked_const_pattern():
    """A closure-captured tensor is baked into the program; the same
    tensor passed as an argument is not."""
    big = torch.ones(256, 256)

    r = tan.analyze_program(lambda x: x @ big, torch.ones(8, 256))
    hits = codes(r, "baked-const")
    assert hits and hits[0].detail["nbytes"] == 256 * 256 * 4
    assert hits[0].severity == Severity.WARNING
    r = tan.analyze_program(lambda x, w: x @ w, torch.ones(8, 256), big)
    assert not codes(r, "baked-const")


def test_baked_const_threshold_and_error_bound():
    small = torch.ones(4)
    r = tan.analyze_program(lambda x: x + small, torch.ones(4))
    assert not codes(r, "baked-const")       # tiny consts are fine
    r = tan.analyze_program(lambda x: x + small, torch.ones(4),
                            const_bytes_warn=1)
    assert codes(r, "baked-const")
    r = tan.analyze_program(lambda x: x + small, torch.ones(4),
                            const_bytes_warn=1, const_bytes_error=16)
    assert codes(r, "baked-const")[0].severity == Severity.ERROR


def test_f64_promotion_departure():
    """Torch has no x64 switch: a float64 value computed from narrower
    float inputs fires (the reference's test under enable_x64); a
    float64 program does not; a numpy float64 scalar stays a weak
    scalar and computes in float32 (the reference without x64)."""
    x32 = torch.ones(4)
    hits = codes(tan.analyze_program(lambda x: x.double() * 3.0, x32),
                 "f64-promotion")
    assert len(hits) == 1 and hits[0].severity == Severity.WARNING
    assert hits[0].detail == {"primitive": "aten._to_copy.default",
                              "input_dtypes": ["float32"]}
    c64 = torch.ones(4, dtype=torch.float64)
    hits = codes(tan.analyze_program(lambda x: x * c64, x32),
                 "f64-promotion")
    assert len(hits) == 1 and "constant" in hits[0].message
    assert not codes(tan.analyze_program(lambda x: x * np.float64(3.0),
                                         torch.ones(4, dtype=torch.float64)),
                     "f64-promotion")
    assert not codes(tan.analyze_program(lambda x: x * np.float64(3.0), x32),
                     "f64-promotion")


def test_host_callback_detected():
    """``.item()`` and a host ``Custom`` op (the port's pure_callback:
    Python on the host) each fire; a plain program does not. The Custom
    op is one opaque node each way, not traced into."""
    r = tan.analyze_program(lambda x: x * x.sum().item(), torch.ones(4))
    hits = codes(r, "host-callback")
    assert hits and hits[0].detail["primitive"] == \
        "aten._local_scalar_dense.default"

    class Sq(mt.operator.CustomOp):
        def forward(self, is_train, req, in_data, out_data, aux):
            self.assign(out_data[0], req[0], in_data[0] * in_data[0])

        def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
            self.assign(in_grad[0], req[0], 2 * in_data[0] * out_grad[0])

    @mt.operator.register("analysis_host_sq")
    class SqProp(mt.operator.CustomOpProp):
        def __init__(self):
            super().__init__(need_top_grad=True)

        def list_arguments(self):
            return ["data"]

        def infer_shape(self, in_shape):
            return in_shape, [in_shape[0]], []

        def create_operator(self, ctx, shapes, dtypes):
            return Sq()

    def fn(x):
        x = x.detach().requires_grad_()
        y = mt.nd.Custom(mt.nd.NDArray(x), op_type="analysis_host_sq").data
        return torch.autograd.grad(y.sum(), [x])

    r = tan.analyze_program(fn, torch.ones(4))
    hits = codes(r, "host-callback")
    assert hits and hits[0].detail == {
        "primitive": "mxnet_tpu_torch.host_custom.default", "count": 2}
    # and the same op still runs for real outside a trace
    x = torch.arange(4.0)
    assert torch.equal(fn(x)[0], 2 * x)
    assert not codes(tan.analyze_program(lambda x: x + 1.0, torch.ones(4)),
                     "host-callback")


def test_host_callback_copy_to_host_needs_a_device_input():
    """A copy to the host from a host tensor moves nothing: silent."""
    r = tan.analyze_program(lambda x: x.cpu() + 1.0, torch.ones(4))
    assert not codes(r, "host-callback")


def test_donation_passthrough_and_unused():
    r = tan.analyze_program(lambda x, y: (x, x + y), torch.ones(4),
                            torch.ones(4), donate_argnums=(0,))
    hits = codes(r, "donation")
    assert hits and hits[0].severity == Severity.ERROR
    assert "returned unchanged" in hits[0].message
    r = tan.analyze_program(lambda x, y: y * 2.0, torch.ones(4),
                            torch.ones(4), donate_argnums=(0,))
    hits = codes(r, "donation")
    assert hits and hits[0].severity == Severity.WARNING
    assert "never consumed" in hits[0].message
    r = tan.analyze_program(lambda x, y: x + y, torch.ones(4),
                            torch.ones(4), donate_argnums=(0,))
    assert not codes(r, "donation")
    r = tan.analyze_program(lambda x, y: x + y, torch.ones(4),
                            torch.ones(4), donate_argnums=(5,))
    assert codes(r, "donation")[0].severity == Severity.INFO


def test_analyze_executor_program():
    """The executor's graph function audits clean through the same API,
    as the reference's fused graph function does."""
    d = mt.sym.Variable("data")
    net = mt.sym.FullyConnected(d, num_hidden=4, name="fc")
    ex = net.simple_bind(CPU, data=(2, 8))
    args = {n: a.data for n, a in ex.arg_dict.items()}
    r = tan.analyze_program(
        lambda a: ex._fn(a, {}, False, torch.device("cpu"))[0], args)
    assert not codes(r, "host-callback")
    assert not [f for f in codes(r, "baked-const")
                if f.severity == Severity.ERROR]
    assert r.extras["program"]["ops"]


def test_flash_kernels_are_one_node_each_way(monkeypatch):
    """A trace holds each flash-attention kernel as one node with its
    output shapes (the kernels are torch.library ops with fake
    implementations): forward, dQ and dK/dV, none traced into."""
    from mxnet_tpu_torch.ops import flash_attention as fa
    monkeypatch.setattr(fa, "_dispatch", lambda q, what: True)

    def fn(q, k, v):
        q = q.detach().requires_grad_()
        o = fa.flash_attention(q, k, v, causal=True)
        return torch.autograd.grad(o.sum(), [q])

    q = torch.randn(1, 2, 64, 32)
    gm, n = tan.program_passes.trace(fn, q, q, q)
    ops = tan.program_passes.op_counts(gm)
    for op in ("fwd", "bwd_dq", "bwd_dkv"):
        assert ops["mxnet_tpu_torch.flash_attention_%s.default" % op] == 1
    assert "aten.bmm.default" not in ops and "aten.mm.default" not in ops
    assert n == 3


def test_flash_ops_run_the_wrappers_bit_for_bit(monkeypatch):
    """Calling the flash ops runs the wrappers as they are: the output
    and the wrappers' counts equal a direct call's."""
    from mxnet_tpu_torch.ops import flash_attention as fa
    fwd = _counting(fa.flash_attention_reference)
    dq, dkv = _counting(_plain_dq), _counting(_plain_dkv)
    monkeypatch.setattr(fa, "_dispatch", lambda q, what: True)
    monkeypatch.setattr(fa, "flash_attention_fwd", fwd)
    monkeypatch.setattr(fa, "flash_attention_bwd_dq", dq)
    monkeypatch.setattr(fa, "flash_attention_bwd_dkv", dkv)
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(2, 64, 32, generator=g) for _ in range(3))
    o, lse = fa.flash_attention_reference(q, k, v, 0.125, True)
    o2, lse2 = torch.ops.mxnet_tpu_torch.flash_attention_fwd(q, k, v, 0.125,
                                                              True)
    assert torch.equal(o, o2) and torch.equal(lse, lse2)
    assert fwd.launches == {"f32": 1, "bf16": 0}
    qq = q.clone().requires_grad_()
    out = fa.FlashAttentionFunction.apply(qq, k, v, 0.125, True)
    out.sum().backward()
    assert fwd.launches["f32"] == 2 and dq.launches["f32"] == 1 and \
        dkv.launches["f32"] == 1
    delta = (torch.ones_like(o) * o).sum(-1)
    assert torch.equal(qq.grad, _plain_dq(q, k, v, torch.ones_like(o), lse,
                                          delta, 0.125, True))


# ============================================== bind hook / strictness


def test_strict_mode_raises_at_bind():
    mt.config.set("MXNET_TPU_ANALYZE", "strict")
    try:
        net = mt.sym.broadcast_add(mt.sym.Variable("x"), mt.sym.Variable("x"))
        with pytest.raises(MXNetError, match="dup-name"):
            net.bind(CPU, {"x": mt.nd.ones((2,), ctx=CPU)})
    finally:
        mt.config.reset("MXNET_TPU_ANALYZE")


def test_strict_mode_clean_net_binds():
    mt.config.set("MXNET_TPU_ANALYZE", "strict")
    try:
        net = mt.sym.FullyConnected(mt.sym.Variable("data"), num_hidden=4)
        ex = net.simple_bind(CPU, data=(2, 8))
        assert ex.forward()[0].shape == (2, 4)
    finally:
        mt.config.reset("MXNET_TPU_ANALYZE")


def test_warn_mode_logs_but_binds(caplog):
    mt.config.set("MXNET_TPU_ANALYZE", "warn")
    try:
        net = mt.sym.broadcast_add(mt.sym.Variable("x"), mt.sym.Variable("x"))
        with caplog.at_level(logging.WARNING, "mxnet_tpu_torch.analysis"):
            ex = net.bind(CPU, {"x": mt.nd.ones((2,), ctx=CPU)})
        assert any("dup-name" in r.message for r in caplog.records)
        assert ex.forward()[0].shape == (2,)
    finally:
        mt.config.reset("MXNET_TPU_ANALYZE")


def test_simple_bind_checks_once_before_it_allocates(monkeypatch):
    """simple_bind runs the analysis before any array is allocated, and
    the executor does not run it again."""
    import mxnet_tpu_torch.ndarray as nd_mod
    calls = []
    real = tan.check_bind

    def spy(*a, **k):
        calls.append(("check", a[0]))
        return real(*a, **k)

    real_zeros = nd_mod.zeros

    def zeros(*a, **k):
        calls.append(("alloc", None))
        return real_zeros(*a, **k)

    monkeypatch.setattr(tan, "check_bind", spy)
    monkeypatch.setattr(nd_mod, "zeros", zeros)
    mt.config.set("MXNET_TPU_ANALYZE", "warn")
    try:
        net = mt.sym.FullyConnected(mt.sym.Variable("data"), num_hidden=4)
        net.simple_bind(CPU, data=(2, 8))
    finally:
        mt.config.reset("MXNET_TPU_ANALYZE")
    kinds = [c[0] for c in calls]
    assert kinds[0] == "check" and kinds.count("check") == 1
    assert "alloc" in kinds


def test_finding_counters_increment():
    from mxnet_tpu_torch import profiler
    before = profiler.get_counter("analysis_dup_name")
    tan.analyze_symbol(_dup_vars(mt)[0])
    assert profiler.get_counter("analysis_dup_name") == before + 1


def test_analyze_off_is_zero_cost():
    """With MXNET_TPU_ANALYZE unset a bind never imports the analyzer."""
    prog = textwrap.dedent("""
        import sys
        sys.path.insert(0, %r)
        import torch
        import mxnet_tpu_torch as mt
        net = mt.sym.FullyConnected(mt.sym.Variable("data"), num_hidden=4)
        ex = net.simple_bind(mt.cpu(), data=(2, 8))
        ex.forward()
        mod = mt.mod.Module(net, context=mt.cpu(), label_names=())
        mod.bind(data_shapes=[("data", (2, 8))])
        assert not any(m.startswith("mxnet_tpu_torch.analysis")
                       for m in sys.modules), "analysis imported while off"
        print("ZERO_COST_OK")
    """) % (REPO,)
    env = dict(os.environ, PYTHONPATH="")
    env.pop("MXNET_TPU_ANALYZE", None)
    res = subprocess.run([sys.executable, "-c", prog], env=env,
                         capture_output=True, text=True, timeout=240)
    assert res.returncode == 0, res.stderr
    assert "ZERO_COST_OK" in res.stdout


def test_importing_the_analyzer_imports_no_jax():
    """The port's package, its analyzer and the CLI module import
    neither jax nor the reference."""
    prog = textwrap.dedent("""
        import sys
        sys.path.insert(0, %r)
        import mxnet_tpu_torch, mxnet_tpu_torch.analysis
        import mxnet_tpu_torch.analysis.__main__
        bad = [m for m in sys.modules if m == "jax" or m.startswith("jax.")
               or m == "mxnet_tpu" or m.startswith("mxnet_tpu.")]
        assert not bad, bad
        print("NO_JAX_OK")
    """) % (REPO,)
    res = subprocess.run([sys.executable, "-c", prog],
                         env=dict(os.environ, PYTHONPATH=""),
                         capture_output=True, text=True, timeout=240)
    assert res.returncode == 0, res.stderr
    assert "NO_JAX_OK" in res.stdout


# ============================================================= lint


LOCKED_SYNC = """
import threading

class S:
    def __init__(self):
        self._lock = threading.Lock()

    def fetch(self, arr):
        with self._lock:
            return arr.asnumpy()
"""

WALL = """
import time

def latency():
    t0 = time.time()
    return time.time() - t0
"""

LINT_SOURCES = {
    "locked_sync": LOCKED_SYNC,
    "unlocked_sync": LOCKED_SYNC.replace(
        "with self._lock:\n            return", "if True:\n            return"),
    "dispatch": """
import threading, jax
lock = threading.Lock()

def go(xs):
    with lock:
        return jax.jit(sum)(xs)
""",
    "wall_clock": WALL,
    "monotonic": WALL.replace("time.time()", "time.monotonic()"),
    "eager_loop": """
def fit(batches, metric):
    for batch in batches:
        metric.log(batch.out.asnumpy())
""",
    "deferred": """
def get(batch, metric):
    metric.log(batch.out.asnumpy())
""",
    "other_loop": """
def collect(batches, metric):
    for batch in batches:
        metric.log(batch.out.asnumpy())
""",
    "nested_def": """
import threading
lock = threading.Lock()

def outer(arr):
    with lock:
        def callback():
            return arr.asnumpy()
        return callback
""",
    "lambda": """
import threading
lock = threading.Lock()

def outer(arr, sink):
    with lock:
        sink.cb = lambda: arr.asnumpy()
""",
    "suppressed": LOCKED_SYNC.replace(
        "with self._lock:",
        "with self._lock:  # mx-lint: allow(lock-host-sync)"),
}


def lint_summary(report):
    return sorted((f.code, f.severity.name, f.func, f.line) for f in report)


@pytest.mark.parametrize("case", sorted(LINT_SOURCES))
def test_lint_parity_on_the_reference_sources(case):
    """The reference's lint sources give the same findings (code,
    severity, function, line) in both packages."""
    src = LINT_SOURCES[case]
    assert lint_summary(tan.lint_source(src, path="s.py")) == \
        lint_summary(jan.lint_source(src, path="s.py"))


def test_lint_host_sync_under_lock():
    hits = codes(tan.lint_source(LOCKED_SYNC, path="s.py"), "lock-host-sync")
    assert hits and hits[0].severity == Severity.ERROR
    assert hits[0].func == "S.fetch"
    assert not codes(tan.lint_source(LINT_SOURCES["unlocked_sync"],
                                     path="s.py"), "lock-host-sync")
    assert len(codes(tan.lint_source(WALL, path="t.py"), "wall-clock")) == 2


TORCH_SOURCES = {
    "item": ("x.item()", "lock-host-sync"),
    "tolist": ("x.tolist()", "lock-host-sync"),
    "cpu": ("x.cpu()", "lock-host-sync"),
    "numpy": ("x.numpy()", "lock-host-sync"),
    "cuda_sync": ("torch.cuda.synchronize()", "lock-host-sync"),
    "event_sync": ("self._event.synchronize()", "lock-host-sync"),
    "stream_sync": ("stream.synchronize()", "lock-host-sync"),
    "dispatch": ("torch.matmul(x, x)", "lock-dispatch"),
}


@pytest.mark.parametrize("case", sorted(TORCH_SOURCES))
def test_lint_torch_vocabulary(case):
    """torch's host syncs and dispatch under a lock fire the reference's
    codes; outside the lock they are silent."""
    call, code = TORCH_SOURCES[case]
    src = textwrap.dedent("""
        import threading, torch

        class S:
            def __init__(self):
                self._lock = threading.Lock()

            def run(self, x, stream):
                with self._lock:
                    return %s
    """) % call
    hits = codes(tan.lint_source(src, path="t.py"))
    assert hits == [code], hits
    free = src.replace("with self._lock:", "if True:")
    assert not tan.lint_source(free, path="t.py").findings
    # the reference's vocabulary does not know torch's
    assert code not in codes(jan.lint_source(src, path="t.py")) or \
        case == "item"


def test_the_ports_sources_lint_against_their_baseline():
    """Phase 20d's ``lint --baseline`` over the port, on the host: a new
    module must not bring a finding the baseline does not hold."""
    from mxnet_tpu_torch.analysis.__main__ import baseline_path, main
    assert main(["lint", "--baseline", baseline_path(),
                 os.path.join(REPO, "mxnet_tpu_torch")]) == 0


def test_lint_torch_sync_in_the_batch_loop():
    src = textwrap.dedent("""
        import torch

        def fit(batches):
            for b in batches:
                torch.cuda.synchronize()
    """)
    hits = codes(tan.lint_source(src, path="f.py"), "eager-loop-sync")
    assert hits and hits[0].func == "fit"


def test_lint_port_is_clean_against_its_baseline():
    """The CI gate, in-process: the port's checked-in baseline covers
    every current finding in mxnet_tpu_torch/, and no key is stale."""
    from mxnet_tpu_torch.analysis.__main__ import baseline_path
    report = tan.lint_paths([os.path.join(REPO, "mxnet_tpu_torch")])
    baseline = tan.load_baseline(baseline_path())
    fresh = tan.diff_baseline(report, baseline, REPO)
    assert not fresh, "\n".join(f.format() for f in fresh)
    assert not tan.stale_baseline(report, baseline, REPO)


def test_the_ports_settled_sites_stay_settled():
    """The sites the lint met in the port: the H2D stager (repaired: no
    lock held across its wait or its copies), the batcher's model lock
    and the MFU collector's wait (suppressed where the reference
    suppresses them), the flight recorder's one wall-clock read
    (suppressed, as the reference's), the example's epoch timer
    (repaired)."""
    pkg = os.path.join(REPO, "mxnet_tpu_torch")
    for rel, allowed in (("module/module.py", 0), ("serve/server.py", 1),
                         ("obs/mfu.py", 1), ("obs/blackbox.py", 1),
                         ("examples/super_resolution.py", 0)):
        path = os.path.join(pkg, rel)
        with open(path) as fh:
            src = fh.read()
        assert src.count("mx-lint: allow(") == allowed, rel
        assert not tan.lint_paths([path]).findings, rel


def test_h2d_stager_waits_with_no_lock_held():
    """The stager's wait for a slot's previous copy runs with its lock
    free; concurrent callers get distinct slots (a new one when every
    slot is taken), and every slot is given back."""
    import threading
    from mxnet_tpu_torch.module.module import _H2DStager
    st = _H2DStager.__new__(_H2DStager)
    st.lock = threading.Lock()
    st.slots = [{"event": None, "host": {}, "busy": False} for _ in range(2)]
    st.next = 0
    st.data_names, st.label_names, st.like = ["data"], [], {"data": None}
    seen = []

    class Stop(Exception):
        pass

    class Ev:
        def synchronize(self):
            seen.append(st.lock.locked())
            raise Stop

    st.slots[0]["event"] = Ev()
    batch = mt.io.DataBatch(data=[mt.nd.ones((2,), ctx=CPU)], label=[])
    with pytest.raises(Stop):
        st(batch)
    assert seen == [False]
    assert not any(s["busy"] for s in st.slots)
    held = [st._claim() for _ in range(3)]
    assert len({id(s) for s in held}) == 3 and len(st.slots) == 3
    for s in held:
        st._release(s)
    errors, order = [], []

    def worker():
        try:
            for _ in range(200):
                s = st._claim()
                if s in order:
                    errors.append("slot handed out twice")
                order.append(s)
                order.remove(s)
                st._release(s)
        except Exception as exc:                            # noqa: BLE001
            errors.append(exc)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=worker) for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert not errors
    assert not any(s["busy"] for s in st.slots)


def test_baseline_roundtrip_and_new_finding(tmp_path):
    report = tan.lint_source(LOCKED_SYNC, path=str(tmp_path / "s.py"))
    assert len(report) == 1
    bl_path = str(tmp_path / "bl.json")
    tan.write_baseline(report, bl_path, str(tmp_path))
    baseline = tan.load_baseline(bl_path)
    assert sum(baseline.values()) == 1
    assert not tan.diff_baseline(report, baseline, str(tmp_path))
    doubled = tan.lint_source(LOCKED_SYNC.replace(
        "return arr.asnumpy()",
        "arr.asnumpy()\n            return arr.asnumpy()"),
        path=str(tmp_path / "s.py"))
    assert len(tan.diff_baseline(doubled, baseline, str(tmp_path))) == 1


# ============================================================== CLI


def test_cli_graph_zoo_and_fail_on(capsys):
    from mxnet_tpu_torch.analysis.__main__ import main
    assert main(["graph", "zoo:mlp"]) == 0
    assert "cost-model" in capsys.readouterr().out
    assert main(["graph", "zoo:mlp", "--fail-on", "INFO"]) == 1


def test_cli_graph_symbol_json(tmp_path):
    from mxnet_tpu_torch.analysis.__main__ import main
    path = tmp_path / "dup.json"
    net = mt.sym.broadcast_add(mt.sym.Variable("x"), mt.sym.Variable("x"))
    path.write_text(net.tojson())
    assert main(["graph", str(path), "--shape", "x=2"]) == 1


def test_cli_lint_baseline_gate(tmp_path):
    from mxnet_tpu_torch.analysis.__main__ import main
    bad = tmp_path / "bad.py"
    bad.write_text(LOCKED_SYNC)
    assert main(["lint", str(bad), "--root", str(tmp_path)]) == 1
    bl = tmp_path / "bl.json"
    assert main(["lint", str(bad), "--root", str(tmp_path),
                 "--write-baseline", str(bl)]) == 0
    assert main(["lint", str(bad), "--root", str(tmp_path),
                 "--baseline", str(bl)]) == 0


def test_cli_self_check(capsys):
    from mxnet_tpu_torch.analysis.__main__ import main
    assert main(["self-check", "--cpu"]) == 0
    out = capsys.readouterr().out
    assert "async-loop   ok" in out


def test_cli_self_check_runs_on_the_card_by_default(monkeypatch):
    """Without --cpu the async fit asks for the card: here that raises,
    as every entry point does without a GPU."""
    from mxnet_tpu_torch.analysis import __main__ as cli
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(MXNetError):
        cli.main(["self-check"])


# =================================================== phase 20 rehearsal


@pytest.fixture
def small_analysis(monkeypatch, tmp_path):
    """Phase 20 on the CPU at a small width; returns the logged lines."""
    from mxnet_tpu_torch.ops import flash_attention as fa
    for name, value in (("DEVICE", "cpu"), ("VOCAB", 64), ("LAYERS", 2),
                        ("D_MODEL", 32), ("HEADS", 2), ("D_FF", 64),
                        ("MAX_SEQ", 64), ("TRAIN_BATCH", 2),
                        ("RESNET_LAYERS", 18), ("RESNET_IMAGE", 64),
                        ("RESNET_BATCH", 4), ("RESNET_CLASSES", 10)):
        monkeypatch.setattr(chip_smoke, name, value)
    monkeypatch.setattr(mt, "gpu", lambda i=0: mt.cpu())
    monkeypatch.setattr(torch.cuda, "Event", _Event)
    for fn in ("synchronize", "empty_cache", "reset_peak_memory_stats"):
        monkeypatch.setattr(torch.cuda, fn, lambda *a: None)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated", lambda *a: 0)
    monkeypatch.setattr(torch.cuda, "memory_allocated", lambda *a: 0)
    monkeypatch.setattr(fa, "_dispatch", lambda q, what: True)
    monkeypatch.setattr(fa, "flash_attention_fwd",
                        _counting(fa.flash_attention_reference))
    monkeypatch.setattr(fa, "flash_attention_bwd_dq", _counting(_plain_dq))
    monkeypatch.setattr(fa, "flash_attention_bwd_dkv", _counting(_plain_dkv))
    lines = []
    monkeypatch.setattr(chip_smoke, "log", lambda *a: lines.append(a[0]))
    snap = mt.config.snapshot_overrides(["MXNET_TPU_OBS_PEAK_FLOPS",
                                         "MXNET_TPU_ANALYZE_HBM_GBPS"])
    # no row for the host CPU: pin a roofline, as the reference's tests do
    mt.config.set("MXNET_TPU_OBS_PEAK_FLOPS", 1e12)
    mt.config.set("MXNET_TPU_ANALYZE_HBM_GBPS", 100.0)
    try:
        yield lines
    finally:
        mt.config.restore_overrides(snap)


def test_analysis_phase_rehearsal_on_cpu(small_analysis):
    """The whole of phase 20 at a small width: every check passes and
    each part logs its readings."""
    out = chip_smoke.analysis_phase(torch, np)
    lines = small_analysis
    for net in ("lm", "resnet"):
        assert out["20a %s" % net]["refused"]
        assert not [k for k in out["20a %s" % net]["findings"]
                    if k in ("analysis_hbm_budget", "analysis_dup_name")]
        assert abs(out["20b %s" % net]["ratio"] - 1.0) <= 0.25
    flash = out["20b lm"]["flash"]
    assert {k: v["launches"] for k, v in flash.items()} == {
        op: chip_smoke.LAYERS for op in chip_smoke.FLASH_OPS}
    assert out["20b lm"]["flash_flops"] == sum(v["flops"]
                                               for v in flash.values())
    assert set(out["20b report"]) >= {"bound", "attainable_mfu",
                                      "measured_mfu", "why"}
    assert out["20c"]["flash_nodes"] == {op: chip_smoke.LAYERS
                                         for op in chip_smoke.FLASH_OPS}
    assert out["20d"]["exit"] == {"lint": 0, "self-check": 0, "audit": 0}
    for prefix in ("20a LM", "20a ResNet-50", "20b LM", "20b ResNet-50",
                   "20b report()", "20c program passes",
                   "20d python -m mxnet_tpu_torch.analysis lint",
                   "20d python -m mxnet_tpu_torch.analysis self-check",
                   "20d python -m mxnet_tpu_torch.analysis audit",
                   "20 analysis"):
        assert any(ln.startswith(prefix) for ln in lines), prefix


def test_analysis_phase_catches_a_miscounted_flash_kernel(small_analysis,
                                                         monkeypatch):
    """20b fails when the roofline's count of a flash kernel is not its
    launches x its own per-launch FLOPs."""
    from mxnet_tpu_torch.analysis import roofline
    monkeypatch.setitem(roofline._FLASH_OPS, "flash_attention_bwd_dq", 4)
    with pytest.raises(chip_smoke.SmokeFailure, match="flash_attention_bwd"):
        chip_smoke.analysis_phase(torch, np)


def test_step_digests_rehearsal_is_deterministic(small_analysis):
    """``--pairs-of CHECKOUT steps`` (the parent's steps against this
    tree's, bit for bit): two runs in one process give equal digests,
    and a changed kernel result changes the LM's."""
    from mxnet_tpu_torch.ops import flash_attention as fa
    one = chip_smoke.step_digests(torch, np)
    assert one == chip_smoke.step_digests(torch, np)
    fwd = fa.flash_attention_fwd

    def off_by_one_ulp(q, k, v, scale, causal):
        o, lse = fwd(q, k, v, scale, causal)
        return torch.nextafter(o, torch.full_like(o, 2.0)), lse

    fa.flash_attention_fwd = off_by_one_ulp
    try:
        other = chip_smoke.step_digests(torch, np)
    finally:
        fa.flash_attention_fwd = fwd
    assert other["lm"] != one["lm"] and other["resnet"] == one["resnet"]
