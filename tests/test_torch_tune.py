"""The port's autotuner (``mxnet_tpu_torch.tune``), its store's hashing
helpers (``mxnet_tpu_torch.aot``) and the two op-level knobs, held
against the JAX package.

* **space**: ``enumerate_space`` equals the reference's for batch sizes
  1-64; ``Candidate`` dicts round-trip between the packages.
* **static rank**: given the same cost reports (stub estimates fed to
  both packages), ``static_rank`` keeps, prunes and orders as the
  reference does.
* **store**: ``program_key`` moves with each input; the store
  round-trips and handles a miss, a future version and no directory;
  the fingerprint is the same in two processes and moves with the
  trace-time knob.
* **probes**: one probe on the CPU leaves the searching process's knobs
  and counters as they were; a failed probe is scored, not raised.
* **fit(tune=)**: the winner is applied (``tune_applied``), explicit
  arguments win, the knobs do not outlive ``fit``; with the tuner off a
  ``fit`` imports no tune module (a subprocess).
* **knobs**: LayerNorm's two-pass variance against the reference's under
  ``MXNET_TPU_LAYERNORM_TWO_PASS``; ``MXNET_ENGINE_TYPE`` read and
  refreshed.
"""
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import mxnet_tpu as mx
import mxnet_tpu_torch as mt
from mxnet_tpu import config as jcfg
from mxnet_tpu.analysis import tuning as jtuning
from mxnet_tpu.tune import prune as jprune
from mxnet_tpu.tune import space as jspace
from mxnet_tpu_torch import aot, config, profiler
from mxnet_tpu_torch.analysis import tuning
from mxnet_tpu_torch.tune import prune, space, store

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KNOBS = ("MXNET_TPU_REMAT", "MXNET_TPU_SCAN_LAYERS",
         "MXNET_TPU_GROUP_UPDATE", "MXNET_TPU_ASYNC_WINDOW")


@pytest.fixture(autouse=True)
def _small_children(monkeypatch):
    """Child processes keep torch's intra-op pool small too (C20)."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")


def _mlp(pkg=mt):
    d = pkg.sym.Variable("data")
    h = pkg.sym.FullyConnected(d, num_hidden=16, name="fc1")
    h = pkg.sym.Activation(h, act_type="relu")
    h = pkg.sym.FullyConnected(h, num_hidden=4, name="fc2")
    return pkg.sym.SoftmaxOutput(h, name="softmax")


def _fit_data(nbatch=4, batch=8):
    with mt.device_scope("cpu"):
        return mt.io.NDArrayIter(np.zeros((nbatch * batch, 8), np.float32),
                                 np.zeros((nbatch * batch,), np.float32),
                                 batch_size=batch)


# ================================================================ space

@pytest.mark.parametrize("batch", range(1, 65))
def test_space_equals_the_references(batch):
    got = [c.to_dict() for c in space.enumerate_space(batch)]
    want = [c.to_dict() for c in jspace.enumerate_space(batch)]
    assert got == want
    assert got[0] == space.DEFAULT.to_dict()


def test_space_with_layouts_equals_the_references():
    lays = [(8, 1, 1), (4, 2, 1), (2, 2, 2)]
    got = space.enumerate_space(8, n_devices=8, layouts=lays)
    want = jspace.enumerate_space(8, n_devices=8, layouts=lays)
    assert [c.to_dict() for c in got] == [c.to_dict() for c in want]


@pytest.mark.parametrize("cand", [
    {}, {"remat": "auto", "grad_accum": 4}, {"async_window": 0,
                                            "group_update": False},
    {"scan_layers": "off", "layout": [2, 2, 2]}])
def test_candidate_dicts_round_trip_between_packages(cand):
    p = space.Candidate.from_dict(cand)
    j = jspace.Candidate.from_dict(cand)
    assert p.to_dict() == j.to_dict()
    assert jspace.Candidate.from_dict(p.to_dict()) == j
    assert space.Candidate.from_dict(j.to_dict()) == p
    assert p.knobs() == j.knobs() and p.order_key() == j.order_key()


# ========================================================== static rank

class _Report:
    def __init__(self, extras):
        self.extras = extras


def _stub_reports(peak_by_accum, saving=0, bound=1000):
    """One stub cost report per grad_accum: the peak estimate, the
    bound buffers and a remat suggestion."""
    def cost_report(sym, shapes, input_dtypes=None, grad_accum=1,
                    batch_inputs=None, device=None):
        extras = {"cost": {"peak_bytes": peak_by_accum[grad_accum],
                           "bound_bytes": bound,
                           "activation_peak_bytes":
                               peak_by_accum[grad_accum] - bound}}
        if saving:
            extras["remat"] = {"suggestion": {
                "policy": "dots_with_no_batch_dims_saveable",
                "est_peak_saving": saving, "est_bytes_saved": saving}}
        return _Report(extras)
    return cost_report


@pytest.mark.parametrize("budget", [None, 1, 5000, 9000, 12000, 40000])
@pytest.mark.parametrize("saving", [0, 3000])
def test_static_rank_decides_and_orders_as_the_reference(monkeypatch,
                                                         budget, saving):
    peaks = {1: 20000, 2: 11000, 4: 7000, 8: 5000}
    monkeypatch.setattr(tuning, "cost_report", _stub_reports(peaks, saving))
    monkeypatch.setattr(jtuning, "cost_report", _stub_reports(peaks, saving))
    cands = space.enumerate_space(8)
    jcands = jspace.enumerate_space(8)
    with profiler.counter_delta() as d:
        kept, audit = prune.static_rank(None, {}, [], cands,
                                        budget_bytes=budget)
    jkept, jaudit = jprune.static_rank(None, {}, [], jcands,
                                       budget_bytes=budget)
    assert [c.to_dict() for c in kept] == [c.to_dict() for c in jkept]
    assert audit == jaudit
    assert d.get("tune_pruned") == len(cands) - len(kept)


def test_static_rank_with_layouts_as_the_reference(monkeypatch):
    peaks = {1: 80000, 2: 50000, 4: 30000, 8: 20000}
    monkeypatch.setattr(tuning, "cost_report", _stub_reports(peaks))
    monkeypatch.setattr(jtuning, "cost_report", _stub_reports(peaks))
    layout_rank = jtuning.rank_layouts(8, param_bytes=1 << 20,
                                       activation_bytes=1 << 18)
    assert tuning.rank_layouts(8, param_bytes=1 << 20,
                               activation_bytes=1 << 18) == layout_rank
    lays = [(r["data"], r["fsdp"], r["tp"]) for r in layout_rank]
    cands = space.enumerate_space(8, n_devices=8, layouts=lays) + \
        [space.Candidate(layout=(3, 1, 1))]   # does not factor 8
    jcands = jspace.enumerate_space(8, n_devices=8, layouts=lays) + \
        [jspace.Candidate(layout=(3, 1, 1))]
    kept, audit = prune.static_rank(None, {}, [], list(reversed(cands)),
                                    budget_bytes=25000,
                                    layout_rank=layout_rank)
    jkept, jaudit = jprune.static_rank(None, {}, [], list(reversed(jcands)),
                                       budget_bytes=25000,
                                       layout_rank=layout_rank)
    assert [c.to_dict() for c in kept] == [c.to_dict() for c in jkept]
    assert audit == jaudit


def test_static_rank_on_the_ports_cost_model():
    """The port's own estimates: nothing binds in one byte, everything
    unbudgeted, and the order is deterministic."""
    shapes = {"data": (8, 8), "softmax_label": (8,)}
    cands = space.enumerate_space(8)
    kept, audit = prune.static_rank(_mlp(), shapes, list(shapes), cands,
                                    budget_bytes=1, device="cpu")
    assert kept == [] and all("budget" in a["why"] for a in audit)
    kept2, _ = prune.static_rank(_mlp(), shapes, list(shapes), cands,
                                 device="cpu")
    kept3, _ = prune.static_rank(_mlp(), shapes, list(shapes), cands,
                                 device="cpu")
    assert kept2 == kept3 and len(kept2) == len(cands)


# ================================================================ store

def test_program_key_moves_with_each_input():
    j = _mlp().tojson()
    args = (j, [("data", (16, 8))], [], "sgd", {}, "1G", 1)
    base = store.program_key(*args)
    assert base == store.program_key(*args)
    for i, other in ((0, _mlp().tojson().replace("fc1", "fcx")),
                     (1, [("data", (32, 8))]),
                     (2, [("softmax_label", (16,))]), (3, "adam"),
                     (4, {"learning_rate": 0.1}), (5, "2G"), (6, 8)):
        moved = list(args)
        moved[i] = other
        assert store.program_key(*moved) != base, i
    assert store.program_key(*args, amp="bfloat16") != base


def test_store_round_trip(tmp_path, monkeypatch):
    monkeypatch.setenv("MXNET_TPU_TUNE_STORE", str(tmp_path))
    cfg = store.TunedConfig(candidate=space.Candidate(grad_accum=4,
                                                      async_window=0),
                            key="k" * 64, source="probe",
                            score={"mfu": 0.5}, searched_s=1.25,
                            n_probed=3, n_pruned=7)
    with profiler.counter_delta() as d:
        path = store.store_config(cfg)
        got = store.load_config("k" * 64)
    assert path and os.path.exists(path)
    assert d.get("tune_store_write") == 1 and d.get("tune_store_hit") == 1
    assert got.to_dict() == cfg.to_dict()
    # the reference's record of the same config reads the same
    from mxnet_tpu.tune.store import TunedConfig as JTunedConfig
    assert JTunedConfig.from_dict(cfg.to_dict()).to_dict() == cfg.to_dict()


def test_store_miss_and_future_version(tmp_path, monkeypatch):
    monkeypatch.setenv("MXNET_TPU_TUNE_STORE", str(tmp_path))
    with profiler.counter_delta() as d:
        assert store.load_config("absent" * 10) is None
        with open(os.path.join(str(tmp_path),
                               "tune-%s.json" % ("v" * 64)), "w") as f:
            json.dump({"version": 99, "candidate": {}}, f)
        assert store.load_config("v" * 64) is None
        with open(os.path.join(str(tmp_path),
                               "tune-%s.json" % ("c" * 64)), "w") as f:
            f.write("{not json")
        assert store.load_config("c" * 64) is None
    assert d.get("tune_store_miss") == 3


def test_no_store_dir_is_none(monkeypatch):
    monkeypatch.delenv("MXNET_TPU_TUNE_STORE", raising=False)
    assert aot.enabled() is None and aot.config_store_dir() is None
    assert store.store_config(store.TunedConfig(
        candidate=space.Candidate(), key="x" * 64)) is None


def test_fingerprint_is_stable_across_processes_and_moves_with_knob():
    code = "from mxnet_tpu_torch import aot; print(aot.fingerprint())"
    out = [subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120, cwd=REPO,
                          env={**os.environ, "PYTHONPATH": REPO}
                          ).stdout.strip() for _ in range(2)]
    assert out[0] == out[1] == aot.fingerprint()
    snap = config.snapshot_overrides(["MXNET_TPU_LAYERNORM_TWO_PASS"])
    try:
        config.set("MXNET_TPU_LAYERNORM_TWO_PASS", True)
        assert aot.fingerprint() != out[0]
    finally:
        config.restore_overrides(snap)
    assert aot.digest(("a",)) != aot.digest(("b",))


# ============================================================ searching

def test_static_search_is_deterministic():
    from mxnet_tpu_torch.tune import search
    kw = dict(optimizer="sgd", budget="1G", mode="static", use_store=False,
              seed=3, device="cpu")
    net = _mlp()
    a = search(net, [("data", (16, 8))], [("softmax_label", (16,))], **kw)
    b = search(net, [("data", (16, 8))], [("softmax_label", (16,))], **kw)
    da = {k: v for k, v in a.to_dict().items() if k != "searched_s"}
    db = {k: v for k, v in b.to_dict().items() if k != "searched_s"}
    assert da == db and a.source == "static" and a.n_probed == 0


def test_one_probe_leaks_nothing_into_the_parent():
    from mxnet_tpu_torch.tune import make_spec, run_probe
    before = dict(profiler.counters())
    knobs = config.snapshot_overrides(KNOBS)
    spec = make_spec(_mlp().tojson(), [("data", (8, 8))],
                     [("softmax_label", (8,))], {}, {}, "sgd",
                     {"learning_rate": 0.01},
                     space.Candidate(async_window=0), steps=2,
                     device="cpu")
    assert spec["device"] == "cpu" and "tf32" in spec and "amp" in spec
    score = run_probe(spec, deadline_s=240)
    assert score["ok"], score
    assert score["device"] == "cpu" and score["steps_per_sec"] > 0
    after = profiler.counters()
    moved = {k for k in after if after[k] != before.get(k, 0)}
    assert moved == {"tune_probe"}
    assert config.snapshot_overrides(KNOBS) == knobs
    assert config.get("MXNET_TPU_ASYNC_WINDOW") == 2


def test_failed_probe_is_scored_not_raised():
    from mxnet_tpu_torch.tune.probe import run_probe
    with profiler.counter_delta() as d:
        score = run_probe({"candidate": {}, "symbol": "not json",
                           "data_shapes": [], "label_shapes": [],
                           "steps": 1, "optimizer": "sgd",
                           "device": "cpu"}, deadline_s=240)
    assert score["ok"] is False and score["why"]
    assert d.get("tune_probe") == 1 and d.get("tune_probe_fail") == 1


def test_a_layout_candidate_fails_its_probe_naming_a9():
    from mxnet_tpu_torch.tune.probe import run_probe_child
    spec = {"candidate": {"layout": [2, 1, 1]}}
    with pytest.raises(mt.MXNetError, match="A9"):
        run_probe_child(spec)


def test_cli_static_search_on_the_host():
    proc = subprocess.run(
        [sys.executable, "-m", "mxnet_tpu_torch.tune", "--net", "mlp",
         "--batch", "8", "--mode", "static", "--no-store", "--json",
         "--cpu"], capture_output=True, text=True, timeout=240, cwd=REPO,
        env={**os.environ, "PYTHONPATH": REPO})
    assert proc.returncode == 0, proc.stderr
    rec = json.loads(proc.stdout)
    assert rec["source"] == "static" and rec["candidate"]["layout"] is None


# ============================================================ fit(tune=)

def test_fit_applies_the_static_winner():
    with profiler.counter_delta() as d:
        mod = mt.mod.Module(_mlp(), context=mt.cpu())
        mod.fit(_fit_data(), num_epoch=1, tune="static",
                optimizer_params={"learning_rate": 0.01})
    assert d.get("tune_applied") == 1
    assert not d.get("tune_probe")
    assert not d.get("loop_recompile")


def test_explicit_grad_accum_beats_the_tuned_one(monkeypatch):
    from mxnet_tpu_torch import tune as mtune
    real = mtune.tune_fit

    def tuned_to_four(*a, **kw):
        cfg = real(*a, **kw)
        cfg.candidate = space.Candidate(grad_accum=4)
        return cfg
    monkeypatch.setattr(mtune, "tune_fit", tuned_to_four)
    mod = mt.mod.Module(_mlp(), context=mt.cpu())
    mod.fit(_fit_data(), num_epoch=1, tune="static",
            optimizer_params={"learning_rate": 0.01})
    assert mod._grad_accum == 4
    mod = mt.mod.Module(_mlp(), context=mt.cpu())
    mod.fit(_fit_data(), num_epoch=1, tune="static", grad_accum=2,
            optimizer_params={"learning_rate": 0.01})
    assert mod._grad_accum == 2


def test_tuned_knobs_do_not_outlive_fit(monkeypatch):
    from mxnet_tpu_torch import tune as mtune
    real = mtune.tune_fit

    def tuned(*a, **kw):
        cfg = real(*a, **kw)
        cfg.candidate = space.Candidate(async_window=0, group_update=False,
                                        scan_layers="off")
        return cfg
    monkeypatch.setattr(mtune, "tune_fit", tuned)
    seen = []
    config.set("MXNET_TPU_REMAT", "off")
    try:
        before = config.snapshot_overrides(KNOBS)
        mod = mt.mod.Module(_mlp(), context=mt.cpu())
        mod.fit(_fit_data(), num_epoch=1, tune="static",
                optimizer_params={"learning_rate": 0.01},
                batch_end_callback=lambda p: seen.append(
                    config.get("MXNET_TPU_ASYNC_WINDOW")))
        assert seen and set(seen) == {0}
        assert config.snapshot_overrides(KNOBS) == before
        assert config.get("MXNET_TPU_ASYNC_WINDOW") == 2
    finally:
        for k in KNOBS:
            config.reset(k)


def test_tune_off_is_zero_cost():
    prog = textwrap.dedent("""
        import sys
        import numpy as np
        import mxnet_tpu_torch as mt
        net = mt.sym.SoftmaxOutput(
            mt.sym.FullyConnected(mt.sym.Variable("data"), num_hidden=4),
            name="softmax")
        with mt.device_scope("cpu"):
            it = mt.io.NDArrayIter(np.zeros((16, 8), np.float32),
                                   np.zeros((16,), np.float32),
                                   batch_size=8)
        mod = mt.mod.Module(net, context=mt.cpu())
        mod.fit(it, num_epoch=1, optimizer_params={"learning_rate": 0.01})
        bad = [m for m in sys.modules if m.startswith("mxnet_tpu_torch.tune")]
        assert not bad, bad
        bad = [k for k in mt.profiler.counters() if k.startswith("tune")]
        assert not bad, bad
        print("TUNE_ZERO_COST_OK")
    """)
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("MXNET_TPU_TUNE")}
    res = subprocess.run([sys.executable, "-c", prog], cwd=REPO,
                         env=dict(env, PYTHONPATH=REPO),
                         capture_output=True, text=True, timeout=240)
    assert res.returncode == 0, res.stderr
    assert "TUNE_ZERO_COST_OK" in res.stdout


@pytest.mark.parametrize("name,samples", [
    ("MXNET_TPU_TUNE", ("auto", "static", "off", "1", "no", "")),
    ("MXNET_TPU_TUNE_PROBE_SECS", ("30", "2.5")),
    ("MXNET_TPU_TUNE_PROBE_STEPS", ("4",)),
    ("MXNET_TPU_TUNE_MAX_PROBES", ("0", "2")),
    ("MXNET_TPU_TUNE_STORE", ("/tmp/x", "")),
    ("MXNET_TPU_ELASTIC_MAX_RESTARTS", ("0", "3")),
    ("MXNET_TPU_LAYERNORM_TWO_PASS", ("1", "0", "yes")),
    ("MXNET_ENGINE_TYPE", ("NaiveEngine", "ThreadedEngine")),
])
def test_knob_defaults_and_parsers_match_the_reference(name, samples,
                                                       monkeypatch):
    assert config.get(name) == jcfg.get(name)
    for raw in samples:
        monkeypatch.setenv(name, raw)
        assert config.get(name) == jcfg.get(name), raw
    monkeypatch.setenv("MXNET_TPU_TUNE", "sometimes")
    with pytest.raises(ValueError):
        config.get("MXNET_TPU_TUNE")


# ================================================================ knobs

def _layer_norms(two_pass, offset, rows):
    """Both packages' LayerNorm of rows offset by ``offset`` under the
    knob, and the float64 value."""
    rng = np.random.RandomState(4)
    x = (rng.randn(rows, 256) + offset).astype(np.float32)
    g = rng.uniform(0.5, 1.5, 256).astype(np.float32)
    b = rng.randn(256).astype(np.float32)
    snaps = (config.snapshot_overrides(["MXNET_TPU_LAYERNORM_TWO_PASS"]),
             jcfg.snapshot_overrides(["MXNET_TPU_LAYERNORM_TWO_PASS"]))
    try:
        config.set("MXNET_TPU_LAYERNORM_TWO_PASS", two_pass)
        jcfg.set("MXNET_TPU_LAYERNORM_TWO_PASS", two_pass)
        with mt.device_scope("cpu"):
            got = mt.nd.LayerNorm(mt.nd.array(x), mt.nd.array(g),
                                  mt.nd.array(b)).asnumpy()
        want = mx.nd.LayerNorm(mx.nd.array(x), mx.nd.array(g),
                               mx.nd.array(b)).asnumpy()
    finally:
        config.restore_overrides(snaps[0])
        jcfg.restore_overrides(snaps[1])
    x64 = x.astype(np.float64)
    exact = (x64 - x64.mean(-1, keepdims=True)) / np.sqrt(
        x64.var(-1, keepdims=True) + 1e-5) * g + b
    return got, want, exact


# the reference reads the knob when it traces its op: a row count of
# each case's own gives each form a trace of its own
@pytest.mark.parametrize("two_pass,offset,rows", [(False, 0.0, 5),
                                                  (True, 4.0, 10)])
def test_layernorm_variance_forms_match_the_reference(two_pass, offset,
                                                      rows):
    got, want, _exact = _layer_norms(two_pass, offset, rows)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_two_pass_layernorm_keeps_its_precision_at_an_offset():
    one, _ref_one, exact_one = _layer_norms(False, 64.0, 11)
    two, ref_two, exact_two = _layer_norms(True, 64.0, 12)
    err_two = np.abs(two - exact_two).max()
    assert err_two * 10 < np.abs(one - exact_one).max()
    # as close to float64 as the reference's two-pass form
    assert err_two <= 2 * np.abs(ref_two - exact_two).max()


def test_engine_type_is_read_and_refreshed():
    from mxnet_tpu_torch.ndarray import ndarray as nd_mod
    assert nd_mod._SYNC_DISPATCH is False
    snap = config.snapshot_overrides(["MXNET_ENGINE_TYPE"])
    try:
        config.set("MXNET_ENGINE_TYPE", "NaiveEngine")
        assert nd_mod._SYNC_DISPATCH is True
        with mt.device_scope("cpu"):
            a = mt.nd.array(np.arange(6, dtype=np.float32))
            assert (mt.nd.exp(a) * 2).asnumpy().shape == (6,)
    finally:
        config.restore_overrides(snap)
    assert nd_mod._SYNC_DISPATCH is False
    code = ("from mxnet_tpu_torch.ndarray import ndarray as n; "
            "print(n._SYNC_DISPATCH)")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=REPO,
                         env={**os.environ, "PYTHONPATH": REPO,
                              "MXNET_ENGINE_TYPE": "NaiveEngine"})
    assert out.stdout.strip() == "True", out.stderr
