"""The port's efficiency auditor against the reference's
``tests/test_analysis_efficiency.py``: the memory passes (byte-size
parsing, the ``hbm-budget`` pass, the strict rejection of an
over-budget bind, the remat report), the program liveness walk (the
same function in ``jnp`` and in torch, equal hand-computed byte counts),
the roofline (classification, ``flop-model-drift``, ``explain`` and the
``mt.obs.report()`` block, equal dicts in both packages under the same
peak and bandwidth overrides), the tuner's candidate lists, the
``signal-unsafe`` lint and the baseline drift gate, and the ``audit``
CLI. The sharding passes stay with ROADMAP A9; the mesh audit targets
exit 2 naming it.
"""
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import mxnet_tpu as mx
import mxnet_tpu_torch as mt
from mxnet_tpu import analysis as jan
from mxnet_tpu.analysis import roofline as jroof
from mxnet_tpu_torch import analysis as tan
from mxnet_tpu_torch.analysis import Severity, roofline, tuning
from mxnet_tpu_torch.base import MXNetError

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# test files run side by side in parallel workers: each keeps torch's
# intra-op pool small
torch.set_num_threads(2)

CPU = mt.cpu()
MLP_SHAPES = {"data": (32, 784), "softmax_label": (32,)}


def codes(report, code=None):
    if code is None:
        return [f.code for f in report]
    return [f for f in report if f.code == code]


class knobs:
    """Set config knobs in both packages for a block, then reset them."""

    def __init__(self, **values):
        self.values = values

    def __enter__(self):
        for k, v in self.values.items():
            mt.config.set(k, v)
            mx.config.set(k, v)

    def __exit__(self, *exc):
        for k in self.values:
            mt.config.reset(k)
            mx.config.reset(k)


def mlp(pkg):
    """The zoo MLP under a fresh name manager: its auto-named nodes
    (``flatten0``) are named alike in both packages whatever ran before
    in this process."""
    from importlib import import_module
    with pkg.name.NameManager():
        return import_module(pkg.__name__ + ".models.mlp").get_symbol(
            num_classes=10)


def budget_findings(pkg, an, spec):
    with knobs(MXNET_TPU_ANALYZE_HBM_BUDGET=spec):
        extra = {} if an is jan else {"calibrate_remat": False}
        report = an.analyze_symbol(mlp(pkg), input_shapes=MLP_SHAPES,
                                   **extra)
    return report


# ========================================================= memory passes


@pytest.mark.parametrize("spec", ["", None, "1024", "4K", "1.5M", "16G",
                                  "16GB", "512 MiB", "2T", "16Q", "-16G",
                                  "lots"])
def test_parse_bytes_matches_the_reference(spec):
    try:
        want = jan.parse_bytes(spec)
    except ValueError as exc:
        with pytest.raises(ValueError) as got:
            tan.parse_bytes(spec)
        assert str(got.value) == str(exc)
        return
    assert tan.parse_bytes(spec) == want


def test_parse_bytes_suffixes():
    assert tan.parse_bytes("") == 0 and tan.parse_bytes(None) == 0
    assert tan.parse_bytes("16G") == 16 << 30
    assert tan.parse_bytes("512 MiB") == 512 << 20
    with pytest.raises(ValueError, match="16Q"):
        tan.parse_bytes("16Q")


@pytest.mark.parametrize("spec", ["lots", "-16G"])
def test_hbm_budget_typo_and_negative_degrade_not_crash(spec):
    """A config typo or a stray minus must not brick binds nor silently
    disable the budget: a WARNING naming the knob, in both packages."""
    port = budget_findings(mt, tan, spec)
    hits = codes(port, "hbm-budget")
    assert hits and hits[0].severity == Severity.WARNING
    assert "NOT being enforced" in hits[0].message
    ref = codes(budget_findings(mx, jan, spec), "hbm-budget")
    assert [(f.code, f.severity.name) for f in ref] == \
        [(f.code, f.severity.name) for f in hits]


def test_negative_budget_rejected_not_silent():
    with pytest.raises(ValueError, match="negative"):
        tan.parse_bytes("-16G")


def test_hbm_budget_fires_and_names_offenders():
    port = budget_findings(mt, tan, "100K")
    hits = codes(port, "hbm-budget")
    assert hits and hits[0].severity == Severity.ERROR
    assert "fc1_weight" in hits[0].message
    assert not port.extras["hbm_budget"]["fits"]
    ref = budget_findings(mx, jan, "100K")
    assert port.extras["hbm_budget"] == ref.extras["hbm_budget"]


def test_hbm_budget_fits_stays_silent_and_unset_has_no_extras():
    port = budget_findings(mt, tan, "1G")
    assert not codes(port, "hbm-budget")
    assert port.extras["hbm_budget"] == \
        budget_findings(mx, jan, "1G").extras["hbm_budget"]
    assert port.extras["hbm_budget"]["fits"]
    assert "hbm_budget" not in budget_findings(mt, tan, "").extras


def test_strict_mode_rejects_over_budget_bind():
    """Strict mode rejects an over-budget bind before it allocates,
    naming the offending arrays; the same bind fits a real budget."""
    net = mt.sym.FullyConnected(mt.sym.Variable("data"), num_hidden=256,
                                name="fc_big")
    mt.config.set("MXNET_TPU_ANALYZE", "strict")
    mt.config.set("MXNET_TPU_ANALYZE_HBM_BUDGET", "64K")
    try:
        with pytest.raises(MXNetError, match="hbm-budget") as exc_info:
            net.simple_bind(CPU, data=(16, 512))
        assert "fc_big_weight" in str(exc_info.value)
        mt.config.set("MXNET_TPU_ANALYZE_HBM_BUDGET", "16G")
        ex = net.simple_bind(CPU, data=(16, 512))
        assert ex.forward()[0].shape == (16, 256)
    finally:
        mt.config.reset("MXNET_TPU_ANALYZE")
        mt.config.reset("MXNET_TPU_ANALYZE_HBM_BUDGET")


def test_strict_module_bind_rejects_over_budget():
    mt.config.set("MXNET_TPU_ANALYZE", "strict")
    mt.config.set("MXNET_TPU_ANALYZE_HBM_BUDGET", "100K")
    try:
        mod = mt.mod.Module(mlp(mt), context=CPU)
        with pytest.raises(MXNetError, match="fc1_weight"):
            mod.bind(data_shapes=[("data", (32, 784))],
                     label_shapes=[("softmax_label", (32,))])
        assert not mod.binded
    finally:
        mt.config.reset("MXNET_TPU_ANALYZE")
        mt.config.reset("MXNET_TPU_ANALYZE_HBM_BUDGET")


def test_remat_report_transformer_nonempty_and_silent_on_tiny():
    from mxnet_tpu_torch.analysis.__main__ import _zoo_symbol
    net, shapes = _zoo_symbol("transformer")
    report = tan.analyze_symbol(net, input_shapes=shapes,
                                calibrate_remat=False)
    assert codes(report, "remat-opportunity")
    assert report.extras["remat"]["candidates"]
    net = mt.sym.FullyConnected(mt.sym.Variable("data"), num_hidden=4)
    report = tan.analyze_symbol(net, input_shapes={"data": (2, 8)})
    assert not codes(report, "remat-opportunity")
    assert "remat" not in report.extras


# ================================================= program liveness


def chain(m):
    def f(a):
        b = a + 1.0
        return b * 2.0
    return f


def unused_output_jnp(x):
    a, v = jax.lax.sort_key_val(x, x * 2.0)   # v is never used
    big = jnp.concatenate([a, a, a, a], axis=0)
    return jnp.sum(big)


def unused_output_torch(x):
    a, v = torch.frexp(x * 2.0)               # v is never used
    big = torch.cat([a, a, a, a], 0)
    return big.sum()


def test_program_memory_hand_computed_chain():
    """b and the output coexist for one step: the 2-buffer peak, in both
    packages, equal to the hand count."""
    buf = 256 * 256 * 4
    port = tan.analyze_program_memory(
        chain(torch), torch.ones(256, 256)).extras["program_memory"]
    ref = jan.analyze_program_memory(
        chain(jnp), jnp.ones((256, 256), jnp.float32)
    ).extras["program_memory"]
    for mem in (port, ref):
        assert mem["activation_peak_bytes"] == 2 * buf
        assert mem["arg_bytes"] == buf
        assert mem["peak_bytes"] == 3 * buf
        assert mem["top_live"]


def test_program_memory_unused_output_dies_immediately():
    """An output nothing consumes must not stay live to the end: the
    peak is at the concat (a + 4a) = 5 buffers; had the unused second
    output leaked it would read 6. The reference's function
    (sort_key_val) and the torch one (frexp: two 4-byte outputs) give
    the hand count."""
    buf = 256 * 256 * 4
    port = tan.analyze_program_memory(
        unused_output_torch, torch.ones(256, 256)).extras["program_memory"]
    ref = jan.analyze_program_memory(
        unused_output_jnp, jnp.ones((256, 256), jnp.float32)
    ).extras["program_memory"]
    assert port["activation_peak_bytes"] == ref["activation_peak_bytes"] \
        == 5 * buf


def test_program_memory_takes_a_traced_graph():
    gm, _ = tan.program_passes.trace(chain(torch), torch.ones(8, 8))
    mem = tan.analyze_program_memory(gm).extras["program_memory"]
    assert mem["activation_peak_bytes"] == 2 * 8 * 8 * 4
    assert codes(tan.analyze_program_memory(gm), "program-memory")


# ============================================================== roofline


def test_roofline_table_is_the_cards_own_row():
    assert roofline.HBM_GBPS_BY_DEVICE_KIND == [
        ("NVIDIA H100 80GB HBM3", 3350.0)]
    assert roofline.hbm_gbps("NVIDIA H100 80GB HBM3") == 3350.0
    # matched on the whole name: another card or a TPU kind is unknown
    assert roofline.hbm_gbps("NVIDIA H100 PCIe") is None
    assert roofline.hbm_gbps("TPU v5 lite") is None
    with knobs(MXNET_TPU_ANALYZE_HBM_GBPS=100.0):
        assert roofline.hbm_gbps("NVIDIA H100 PCIe") == 100.0
    cls = roofline.classify(1e12, 1e9, device_kind="NVIDIA H100 80GB HBM3")
    assert cls["peak_flops"] == 989e12 and cls["hbm_gbps"] == 3350.0
    assert cls["balance_flops_per_byte"] == round(989e12 / 3.35e12, 3)


def test_roofline_classification_pair():
    """A fat matmul classifies compute-bound, an elementwise add
    memory-bound, against a knob-pinned roofline."""
    with knobs(MXNET_TPU_OBS_PEAK_FLOPS=1e12,
               MXNET_TPU_ANALYZE_HBM_GBPS=100.0):
        a = torch.ones(256, 256)
        roof = roofline.analyze_executable(
            lambda a, b: a @ b, a, a).extras["roofline"]
        assert roof["bound"] == "compute"
        assert roof["attainable_mfu"] == 1.0
        # the matmul's count is the closed form: 2 n^3 FLOPs, 3 n^2
        # f32 operands and results
        assert roof["compiled_flops"] == 2 * 256 ** 3
        assert roof["compiled_bytes_accessed"] == 3 * 256 * 256 * 4
        roof = roofline.analyze_executable(
            lambda a, b: a + b, a, a).extras["roofline"]
        assert roof["bound"] == "memory"
        assert roof["attainable_mfu"] < 0.05


def test_flop_model_drift_fires_and_stays_silent():
    a = torch.ones(128, 128)
    true_flops = 2 * 128 * 128 * 128
    r = roofline.analyze_executable(lambda a, b: a @ b, a, a,
                                    model_flops=128 * 128)
    assert codes(r, "flop-model-drift")
    r = roofline.analyze_executable(lambda a, b: a @ b, a, a,
                                    model_flops=true_flops)
    assert not codes(r, "flop-model-drift")
    assert abs(r.extras["roofline"]["model_ratio"] - 1.0) <= 0.25
    # the reference's compiled count of the same product
    j = jroof.analyze_executable(lambda a, b: a @ b, jnp.ones((128, 128)),
                                 jnp.ones((128, 128)),
                                 model_flops=true_flops)
    assert j.extras["roofline"]["compiled_flops"] == \
        r.extras["roofline"]["compiled_flops"]


def test_counting_skips_views_and_counts_flash_launches(monkeypatch):
    import sys
    sys.path.insert(0, os.path.join(REPO, "tests"))
    from test_torch_wgmma_support import _counting, _plain_dkv, _plain_dq
    from mxnet_tpu_torch.ops import flash_attention as fa
    monkeypatch.setattr(fa, "_dispatch", lambda q, what: True)
    monkeypatch.setattr(fa, "flash_attention_fwd",
                        _counting(fa.flash_attention_reference))
    monkeypatch.setattr(fa, "flash_attention_bwd_dq", _counting(_plain_dq))
    monkeypatch.setattr(fa, "flash_attention_bwd_dkv", _counting(_plain_dkv))
    c = roofline.count_executable(lambda x: x.view(-1).t(), torch.ones(4))
    assert c["ops"] == 0 and c["bytes"] == 0
    q = torch.randn(1, 2, 64, 32, requires_grad=True)

    def step(q):
        fa.flash_attention(q, q, q, causal=True).sum().backward()

    c = roofline.count_executable(step, q)
    pairs = 64 * 65 // 2
    assert c["flash"] == {
        "flash_attention_fwd": {"launches": 1, "flops": 4 * 2 * pairs * 32},
        "flash_attention_bwd_dq": {"launches": 1,
                                   "flops": 6 * 2 * pairs * 32},
        "flash_attention_bwd_dkv": {"launches": 1,
                                    "flops": 8 * 2 * pairs * 32}}
    assert c["flops"] > sum(v["flops"] for v in c["flash"].values())


@pytest.mark.parametrize("flops,nbytes,mfu", [(1e9, 1e9, 0.1),
                                              (1e9, 1e7, 0.05),
                                              (1e9, 1e8, 0.07),
                                              (1e9, 1e7, None)])
def test_roofline_explain_equals_the_reference(flops, nbytes, mfu):
    with knobs(MXNET_TPU_OBS_PEAK_FLOPS=1e12,
               MXNET_TPU_ANALYZE_HBM_GBPS=100.0):
        got = roofline.explain(flops, nbytes, measured_mfu=mfu)
        assert got == jroof.explain(flops, nbytes, measured_mfu=mfu)


def test_roofline_explain_reconciles_measured_mfu():
    with knobs(MXNET_TPU_OBS_PEAK_FLOPS=1e12,
               MXNET_TPU_ANALYZE_HBM_GBPS=100.0):
        out = roofline.explain(flops=1e9, bytes_moved=1e9, measured_mfu=0.1)
        assert out["bound"] == "memory" and "intensity" in out["why"]
        out = roofline.explain(flops=1e9, bytes_moved=1e7, measured_mfu=0.05)
        assert out["bound"] == "compute" and "scheduling" in out["why"]
    assert roofline.explain(1e9, 1e7, 0.05) is None     # the CPU: no row


def test_obs_report_carries_roofline_why():
    """mt.obs.report() attaches the roofline reconciliation to the
    module's record: its measured_mfu is the record's MFU."""
    data = mt.sym.Variable("data")
    net = mt.sym.SoftmaxOutput(mt.sym.FullyConnected(data, num_hidden=8,
                                                     name="fc1"),
                               name="softmax")
    mod = mt.mod.Module(net, context=CPU, label_names=("softmax_label",))
    mod.bind(data_shapes=[("data", (8, 16))],
             label_shapes=[("softmax_label", (8,))])
    mod.init_params(mt.init.Uniform(0.01))
    mod.init_optimizer(optimizer="sgd",
                       optimizer_params={"learning_rate": 0.1})
    rng = np.random.RandomState(0)
    batch = mt.io.DataBatch(
        data=[mt.nd.array(rng.uniform(-1, 1, (8, 16)), ctx=CPU)],
        label=[mt.nd.array(rng.randint(0, 8, (8,)), ctx=CPU)])
    with knobs(MXNET_TPU_OBS_PEAK_FLOPS=1e12,
               MXNET_TPU_ANALYZE_HBM_GBPS=100.0):
        for _ in range(4):
            mod._fit_step(batch)
        mt.obs.report()                      # opens the rate window
        for _ in range(3):
            mod._fit_step(batch)
        rep = mt.obs.report()
    recs = [r for r in rep["executors"]
            if r["name"] == mod._obs_label and r.get("roofline")]
    assert recs, rep["executors"]
    roof = recs[-1]["roofline"]
    assert roof["bound"] in ("compute", "memory")
    assert "why" in roof and roof["measured_mfu"] == \
        round(recs[-1]["mfu"], 4)


# ================================================================= tuning


def test_tuning_candidate_lists():
    from mxnet_tpu.analysis import tuning as jtun
    from mxnet_tpu_torch.analysis.__main__ import _zoo_symbol
    net, shapes = _zoo_symbol("transformer")
    rep = tuning.cost_report(net, shapes, device=CPU)
    assert tuning.peak_bytes(rep) == rep.extras["cost"]["peak_bytes"]
    ladder = tuning.remat_candidates(rep)
    assert ladder[0]["policy"] == "off" and len(ladder) == 2
    assert tuning.peak_bytes(tan.Report()) is None
    for n in (1, 4, 8):
        assert tuning.rank_layouts(n, 1 << 20, 1 << 18) == \
            jtun.rank_layouts(n, 1 << 20, 1 << 18)
    for kind in ("all-reduce", "all-gather", "reduce-scatter",
                 "collective-permute", "send"):
        for g in (1, 2, 8):
            assert tuning.comm_link_bytes(kind, 4096, g) == \
                jan.sharding_passes.comm_link_bytes(kind, 4096, g)


# ===================================================== signal-unsafe lint


SIG_BAD = """
import signal, threading, logging
lock = threading.Lock()

def handler(signum, frame):
    with lock:
        logging.warning("dying")

signal.signal(signal.SIGTERM, handler)
"""

SIG_SOURCES = {
    "bad": SIG_BAD,
    "flag_only": """
import signal

class Mgr:
    def install(self):
        def _handler(signum, frame):
            self._preempt = True
        signal.signal(signal.SIGTERM, _handler)
""",
    "method_queue": """
import signal

class Mgr:
    def install(self):
        signal.signal(signal.SIGTERM, self._on_term)

    def _on_term(self, signum, frame):
        self._queue.put(1)
""",
    "not_a_handler": """
import threading, logging
lock = threading.Lock()

def not_a_handler():
    with lock:
        logging.warning("fine: nobody registered this with signal")
""",
    "suppressed": SIG_BAD.replace(
        "with lock:", "with lock:  # mx-lint: allow(signal-unsafe)"),
}


@pytest.mark.parametrize("case", sorted(SIG_SOURCES))
def test_signal_unsafe_parity(case):
    src = SIG_SOURCES[case]

    def key(r):
        return sorted((f.code, f.severity.name, f.func, f.line) for f in r)

    assert key(tan.lint_source(src, path="s.py")) == \
        key(jan.lint_source(src, path="s.py"))


def test_signal_unsafe_fires_and_suppresses():
    hits = codes(tan.lint_source(SIG_BAD, path="s.py"), "signal-unsafe")
    assert {f.severity for f in hits} == {Severity.ERROR, Severity.WARNING}
    assert all(f.func == "handler" for f in hits)
    assert len(codes(tan.lint_source(SIG_SOURCES["suppressed"], path="s.py"),
                     "signal-unsafe")) == 1


def test_checkpoint_manager_handler_is_clean():
    path = os.path.join(REPO, "mxnet_tpu_torch", "checkpoint", "manager.py")
    assert not codes(tan.lint_paths([path]), "signal-unsafe")


# ======================================================= baseline drift


LOCKED = """
import threading

class S:
    def __init__(self):
        self._lock = threading.Lock()

    def fetch(self, arr):
        with self._lock:
            return arr.asnumpy()
"""


def test_stale_baseline_detected(tmp_path):
    src = tmp_path / "s.py"
    src.write_text(LOCKED)
    report = tan.lint_source(LOCKED, path=str(src))
    bl = str(tmp_path / "bl.json")
    tan.write_baseline(report, bl, str(tmp_path))
    fixed = LOCKED.replace("with self._lock:\n            return",
                           "if True:\n            return")
    src.write_text(fixed)
    stale = tan.stale_baseline(tan.lint_source(fixed, path=str(src)),
                               tan.load_baseline(bl), str(tmp_path))
    assert stale and list(stale.values()) == [1]
    from mxnet_tpu_torch.analysis.__main__ import main
    assert main(["lint", str(src), "--root", str(tmp_path),
                 "--baseline", bl]) == 1


def test_baseline_gate_passes_when_in_sync(tmp_path):
    src = tmp_path / "ok.py"
    src.write_text("x = 1\n")
    from mxnet_tpu_torch.analysis.__main__ import main
    bl = str(tmp_path / "bl.json")
    assert main(["lint", str(src), "--root", str(tmp_path),
                 "--write-baseline", bl]) == 0
    assert main(["lint", str(src), "--root", str(tmp_path),
                 "--baseline", bl]) == 0


def test_baseline_file_format_is_the_references(tmp_path):
    report = tan.lint_source(LOCKED, path=str(tmp_path / "s.py"))
    a, b = str(tmp_path / "a.json"), str(tmp_path / "b.json")
    tan.write_baseline(report, a, str(tmp_path))
    jan.write_baseline(jan.lint_source(LOCKED, path=str(tmp_path / "s.py")),
                       b, str(tmp_path))
    assert tan.load_baseline(a) == jan.load_baseline(b) == \
        tan.load_baseline(b)


# ============================================================= CLI


def test_cli_lint_no_paths_is_usage_error():
    from mxnet_tpu_torch.analysis.__main__ import main
    assert main(["lint"]) == 2


def test_cli_audit_typo_target_is_usage_error(capsys):
    from mxnet_tpu_torch.analysis.__main__ import main
    assert main(["audit", "--cpu", "transfromer"]) == 2
    assert "unknown zoo model" in capsys.readouterr().err


@pytest.mark.parametrize("target", ["tp-mesh", "islands"])
def test_cli_audit_mesh_targets_name_a9(target, capsys):
    """Departure: the reference audits these on an 8-device mesh; the
    port's sharded programs are ROADMAP A9, so the targets are a usage
    error naming it."""
    from mxnet_tpu_torch.analysis.__main__ import main
    assert main(["audit", "--cpu", target]) == 2
    assert "A9" in capsys.readouterr().err


def test_cli_audit_single_zoo_target(capsys):
    from mxnet_tpu_torch.analysis.__main__ import main
    assert main(["audit", "--cpu", "transformer"]) == 0
    out = capsys.readouterr().out
    assert "remat:" in out and "suggestion:" in out and "roofline:" in out
    assert "roofline unknown for the host CPU" in out


def test_cli_audit_accepts_zoo_prefix_and_reads_a_pinned_roofline(capsys):
    from mxnet_tpu_torch.analysis.__main__ import main
    with knobs(MXNET_TPU_OBS_PEAK_FLOPS=1e12,
               MXNET_TPU_ANALYZE_HBM_GBPS=100.0):
        assert main(["audit", "--cpu", "zoo:mlp"]) == 0
    out = capsys.readouterr().out
    assert "-bound, attainable MFU" in out and "ratio 0.99" in out
