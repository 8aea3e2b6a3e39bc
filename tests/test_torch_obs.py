"""The port's observability (``mt.obs``, ``mt.profiler``) against the
reference's ``tests/test_obs.py`` and ``tests/test_profiler.py``.

Covers span gating and the zero-allocation disabled mode, per-thread
lanes, flow events linking one batch across the async fit's threads, the
bounded log-bucket histogram, Prometheus exposition with its grammar
check, the ``/metrics`` endpoint of both servers, compile accounting at
the port's build points, the MFU gauge against independently measured
throughput, and the cost model. Where a scenario makes sense in both
packages the same inputs go through both: each package's exposition
parses in the other's parser with equal samples, the same observations
give equal quantiles, the same scripted spans dump equal traces, and
the cost model counts equal FLOPs on one Symbol JSON.

Last, ``chip_smoke.py``'s phase 19 rehearsed on the CPU at a small
width (the zoo LM at 2 layers and d_model 32 behind ``GenerativeServer``,
ResNet-18 at 64x64 behind ``InferenceServer``, the LM's ``fit`` in amp
bf16 with obs on and off, the compile ring, the flight recorder's
SIGKILL drill in a child process and the lock witness), with the
CUDA-only calls stood in for and the attention kernels replaced by
counting wrappers around their plain versions. It lives in this
many-test file so that the test scheduler does not run it last, beside
the reference's timing gates.
"""
import gc
import json
import math
import os
import sys
import threading
import time
import tracemalloc
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

import mxnet_tpu as mx
import mxnet_tpu_torch as mt
from mxnet_tpu import profiler as jprof
from mxnet_tpu_torch import config as cfg
from mxnet_tpu_torch import profiler as _profiler
from mxnet_tpu_torch.base import MXNetError

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke  # noqa: E402
from test_torch_wgmma_support import (_Event, _counting,  # noqa: E402
                                      _plain_dkv, _plain_dq)

# test files run side by side in parallel workers: each keeps torch's
# intra-op pool small
torch.set_num_threads(2)

CPU = mt.cpu()


@pytest.fixture
def obs_on():
    snap = cfg.snapshot_overrides(["MXNET_TPU_OBS"])
    cfg.set("MXNET_TPU_OBS", 1)
    try:
        yield
    finally:
        cfg.restore_overrides(snap)


def _mlp(pkg=mt, hidden=8):
    data = pkg.sym.Variable("data")
    h = pkg.sym.FullyConnected(data, num_hidden=hidden, name="fc1")
    h = pkg.sym.Activation(h, act_type="relu", name="relu1")
    h = pkg.sym.FullyConnected(h, num_hidden=2, name="fc2")
    return pkg.sym.SoftmaxOutput(h, name="softmax")


def _fit_data(n=160, batch=16, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.uniform(-1, 1, (n, 6)).astype(np.float32)
    y = (x[:, 0] > 0).astype(np.float32)
    return mt.io.NDArrayIter(x, y, batch_size=batch,
                             label_name="softmax_label")


def _dump_trace(tmpdir, prof=_profiler):
    path = os.path.join(str(tmpdir), "trace.json")
    prof.set_config(filename=path)
    prof.dump()
    with open(path) as f:
        return json.load(f)


def _bound_mlp(hidden=8, batch=9):
    mod = mt.mod.Module(_mlp(hidden=hidden), context=CPU)
    mod.bind(data_shapes=[("data", (batch, 6))],
             label_shapes=[("softmax_label", (batch,))])
    mod.init_params(mt.init.Xavier())
    mod.init_optimizer(optimizer="sgd",
                       optimizer_params={"learning_rate": 0.1})
    return mod


def _batch(batch=9, seed=0):
    rng = np.random.RandomState(seed)
    return mt.io.DataBatch(
        data=[mt.nd.array(rng.rand(batch, 6).astype(np.float32), ctx=CPU)],
        label=[mt.nd.array(np.zeros((batch,), np.float32), ctx=CPU)])


# ------------------------------------------------------------ span gating


def test_disabled_span_is_shared_noop_and_allocates_nothing():
    """Disabled, ``span()`` returns one shared object, counts nothing and
    allocates nothing (tracemalloc sees no block made in the profiler
    over a thousand spans)."""
    assert not mt.obs.spans_enabled()
    s1 = mt.obs.span("a")
    s2 = mt.obs.span("b", flow=123, lane="x")
    assert s1 is s2, "disabled span() must return the shared singleton"
    with _profiler.counter_delta() as d:
        with mt.obs.span("region"):
            pass
        s1.mark_flow(7)
    assert d.get("obs_spans") == 0
    span = _profiler.span

    def loop():
        for _ in range(1000):
            with span("hot", "step", flow=None):
                pass

    loop()                      # warm any lazily made object first
    tracemalloc.start()
    try:
        before = tracemalloc.take_snapshot()
        loop()
        after = tracemalloc.take_snapshot()
    finally:
        tracemalloc.stop()
    flt = [tracemalloc.Filter(True, _profiler.__file__)]
    grown = [s for s in after.filter_traces(flt).compare_to(
        before.filter_traces(flt), "lineno") if s.size_diff > 0]
    assert not grown, grown[:3]


def test_disabled_fit_records_zero_spans():
    _profiler.set_state("stop")
    mod = mt.mod.Module(_mlp(), context=CPU)
    with _profiler.counter_delta() as d:
        mod.fit(_fit_data(), optimizer="sgd", initializer=mt.init.Xavier(),
                optimizer_params={"learning_rate": 0.1}, num_epoch=1)
    assert d.get("obs_spans") == 0


def test_disabled_servers_record_zero_spans():
    srv = mt.serve.InferenceServer(lambda x: x * 2.0, max_batch_size=4,
                                   ctx=CPU, name="tobs_nospan")
    try:
        with _profiler.counter_delta() as d:
            futs = [srv.submit(np.ones((3,), np.float32)) for _ in range(6)]
            for f in futs:
                f.result(timeout=30)
    finally:
        srv.close()
    assert d.get("obs_spans") == 0


def test_span_records_under_obs_knob_without_profiler(obs_on, tmp_path):
    assert mt.profiler.state() == "stop"
    with mt.obs.span("outer", "t"):
        with mt.obs.span("inner", "t"):
            time.sleep(0.001)
    trace = _dump_trace(tmp_path)
    spans = {e["name"]: e for e in trace["traceEvents"] if e["ph"] == "X"}
    assert "outer" in spans and "inner" in spans
    o, i = spans["outer"], spans["inner"]
    assert o["tid"] == i["tid"]
    assert o["ts"] <= i["ts"]
    assert i["ts"] + i["dur"] <= o["ts"] + o["dur"] + 1.0


def test_named_lanes_and_explicit_lane_override(obs_on, tmp_path):
    mt.obs.register_thread_lane("lane-test-main")
    done = threading.Event()

    def worker():
        mt.obs.register_thread_lane("lane-test-worker")
        with mt.obs.span("w"):
            pass
        done.set()

    t = threading.Thread(target=worker)
    t.start()
    t.join()
    assert done.is_set()
    with mt.obs.span("m"):
        pass
    with mt.obs.span("staged", lane="lane-test-stage"):
        pass
    trace = _dump_trace(tmp_path)
    lanes = {e["args"]["name"]: e["tid"] for e in trace["traceEvents"]
             if e["ph"] == "M" and e["name"] == "thread_name"}
    spans = {e["name"]: e["tid"] for e in trace["traceEvents"]
             if e["ph"] == "X"}
    assert spans["w"] == lanes["lane-test-worker"]
    assert spans["m"] == lanes["lane-test-main"]
    assert spans["staged"] == lanes["lane-test-stage"]
    assert all(0 < tid < 10000 for tid in lanes.values())


def test_async_fit_trace_links_batches_across_lanes(obs_on, tmp_path):
    """An async fit gives a loadable trace with the train, metric, place,
    prefetch/* and ckpt-writer lanes and every stage's span, and one
    batch's flow crosses at least three lanes from exactly one start."""
    ckpt_dir = os.path.join(str(tmp_path), "ck")
    mod = mt.mod.Module(_mlp(), context=CPU)
    mod.fit(_fit_data(), optimizer="sgd", initializer=mt.init.Xavier(),
            optimizer_params={"learning_rate": 0.1}, num_epoch=2,
            checkpoint=mt.checkpoint.CheckpointConfig(
                ckpt_dir, every_n_batches=5))
    trace = _dump_trace(tmp_path)
    events = trace["traceEvents"]
    lanes = {e["args"]["name"]: e["tid"] for e in events
             if e["ph"] == "M" and e["name"] == "thread_name"}
    assert len(lanes) >= 4, lanes
    for expect in ("train", "metric", "place", "ckpt-writer"):
        assert expect in lanes, lanes
    assert any(name.startswith("prefetch/") for name in lanes), lanes
    names = {e["name"] for e in events if e["ph"] == "X"}
    for expect in ("prefetch_next", "device_place", "fused_step_dispatch",
                   "metric_update", "metric_sync", "ckpt_snapshot",
                   "ckpt_write"):
        assert expect in names, (expect, sorted(names))
    flow_lanes, flow_phases = {}, {}
    for e in events:
        if e.get("cat") == "flow":
            flow_lanes.setdefault(e["id"], set()).add(e["tid"])
            flow_phases.setdefault(e["id"], []).append(e["ph"])
    linked = [fid for fid, ls in flow_lanes.items() if len(ls) >= 3]
    assert linked
    for fid in linked:
        assert flow_phases[fid].count("s") == 1, flow_phases[fid]


def _scripted_trace(prof, obs_span, new_flow, register, tmp_path, tag):
    """The same spans, lanes and flows on threads, run one after the
    other; the dump normalized to (name, ph, lane name, flow index)."""
    prof.set_config(filename=os.path.join(str(tmp_path), tag + "0.json"))
    prof.dump()                                    # a clean buffer
    flows = [new_flow(), new_flow()]

    def producer():
        register("xpkg-producer")
        with obs_span("produce", "io", flow=flows[0]):
            pass
        with obs_span("stage", "io", flow=flows[0], lane="xpkg-stage"):
            pass

    def consumer():
        register("xpkg-consumer")
        with obs_span("consume", "step", flow=flows[0]) as sp:
            sp.mark_flow(flows[1])
        with obs_span("plain", "step"):
            pass
        with obs_span("second", "metric", flow=flows[1],
                      lane="xpkg-metric"):
            pass

    for fn in (producer, consumer):
        t = threading.Thread(target=fn)
        t.start()
        t.join()
    trace = _dump_trace(tmp_path, prof)
    events = trace["traceEvents"]
    lanes = {e["tid"]: e["args"]["name"] for e in events
             if e["ph"] == "M" and e["name"] == "thread_name"}
    order = {}
    out = []
    for e in events:
        if e["ph"] == "M":
            continue
        fid = e.get("id", (e.get("args") or {}).get("flow"))
        if fid is not None:
            fid = order.setdefault(fid, len(order))
        out.append((e["name"], e["ph"], e.get("cat"), lanes[e["tid"]], fid))
    return out, sorted(lanes.values())


def test_scripted_trace_equals_the_reference(tmp_path):
    import mxnet_tpu as mx_ref
    snap = cfg.snapshot_overrides(["MXNET_TPU_OBS"])
    cfg.set("MXNET_TPU_OBS", 1)
    mx_ref.config.set("MXNET_TPU_OBS", 1)
    try:
        got = _scripted_trace(_profiler, _profiler.span, _profiler.new_flow,
                              _profiler.register_thread_lane, tmp_path, "p")
        want = _scripted_trace(jprof, jprof.span, jprof.new_flow,
                               jprof.register_thread_lane, tmp_path, "r")
    finally:
        cfg.restore_overrides(snap)
        mx_ref.config.reset("MXNET_TPU_OBS")
    assert got == want
    events, lanes = got
    assert lanes == sorted(["xpkg-producer", "xpkg-stage", "xpkg-consumer",
                            "xpkg-metric"])
    assert [e for e in events if e[1] == "s"] == [
        ("batch", "s", "flow", "xpkg-producer", 0),
        ("batch", "s", "flow", "xpkg-consumer", 1)]


def test_record_event_lane_is_stable_per_thread(tmp_path, obs_on):
    mt.profiler.set_state("run")
    try:
        t0 = time.perf_counter()
        mt.profiler.record_event("a1", t0, t0 + 1e-6)
        mt.profiler.record_event("a2", t0, t0 + 1e-6)

        def other():
            t = time.perf_counter()
            mt.profiler.record_event("b1", t, t + 1e-6)

        th = threading.Thread(target=other, name="obs-other-thread")
        th.start()
        th.join()
    finally:
        mt.profiler.set_state("stop")
    trace = _dump_trace(tmp_path)
    by_name = {e["name"]: e["tid"] for e in trace["traceEvents"]
               if e["ph"] == "X"}
    assert by_name["a1"] == by_name["a2"]
    assert by_name["b1"] != by_name["a1"]
    lanes = {e["args"]["name"] for e in trace["traceEvents"]
             if e["ph"] == "M" and e["name"] == "thread_name"}
    assert "obs-other-thread" in lanes


def test_profiler_concurrent_state_config_dump_hammer(tmp_path):
    errors = []
    stop = threading.Event()
    paths = [os.path.join(str(tmp_path), "h%d.json" % i) for i in range(2)]

    def flipper():
        i = 0
        while not stop.is_set():
            mt.profiler.set_state("run" if i % 2 else "stop")
            mt.profiler.set_config(filename=paths[i % 2])
            i += 1

    def recorder():
        while not stop.is_set():
            t = time.perf_counter()
            mt.profiler.record_event("evt", t, t + 1e-6)
            with mt.obs.span("sp"):
                pass

    def dumper():
        while not stop.is_set():
            try:
                p = mt.profiler.dump()
                with open(p) as f:
                    json.load(f)
            except Exception as exc:                       # noqa: BLE001
                errors.append(exc)

    threads = [threading.Thread(target=f)
               for f in (flipper, recorder, recorder, dumper)]
    for t in threads:
        t.start()
    time.sleep(0.5)
    stop.set()
    for t in threads:
        t.join(timeout=10)
    mt.profiler.set_state("stop")
    assert not errors, errors[0]


# ------------------------------------------------ the profiler's op events


def test_profiler_records_ops_and_dumps_chrome_trace(tmp_path):
    path = os.path.join(str(tmp_path), "prof.json")
    mt.profiler.set_config(filename=path)
    mt.profiler.set_state("run")
    try:
        with mt.cpu():
            a = mt.nd.random.uniform(shape=(8, 8))
            b = mt.nd.dot(a, a)
            (b + 1).asnumpy()
            with mt.profiler.record("my_region"):
                mt.nd.sum(b).asnumpy()
    finally:
        mt.profiler.set_state("stop")
    out = mt.profiler.dump()
    assert out == path
    trace = json.load(open(path))
    names = [e["name"] for e in trace["traceEvents"]]
    assert "dot" in names
    assert "my_region" in names
    for e in trace["traceEvents"]:
        assert e["ph"] in ("X", "M", "s", "t", "f")
        if e["ph"] == "X":
            assert e["dur"] >= 0


def test_profiler_off_records_nothing(tmp_path):
    mt.profiler.set_state("stop")
    path = os.path.join(str(tmp_path), "p.json")
    mt.profiler.set_config(filename=path)
    mt.profiler.dump()               # drop what earlier tests recorded
    with mt.cpu():
        mt.nd.random.uniform(shape=(4, 4)).asnumpy()
    mt.profiler.dump()
    assert json.load(open(path))["traceEvents"] == []


def test_executor_forward_backward_event(tmp_path):
    """While the profiler runs, a training step logs ``graph_fwd_bwd``
    (the executor's forward and gradients) beside the op events."""
    mod = _bound_mlp()
    mt.profiler.set_config(filename=os.path.join(str(tmp_path), "g.json"))
    mt.profiler.dump()
    mt.profiler.set_state("run")
    try:
        mod._fit_step(_batch())
    finally:
        mt.profiler.set_state("stop")
    trace = json.load(open(mt.profiler.dump()))
    ev = [e for e in trace["traceEvents"] if e["name"] == "graph_fwd_bwd"]
    assert len(ev) == 1 and ev[0]["cat"] == "graph" and ev[0]["dur"] > 0


def test_device_trace_names_write_a_torch_profiler_trace(tmp_path):
    """``start_xla_trace`` / ``stop_xla_trace`` keep the reference's
    names and write a ``torch.profiler`` chrome trace into ``logdir``;
    a second start or a stop without a start raises."""
    logdir = os.path.join(str(tmp_path), "tb")
    mt.profiler.start_xla_trace(logdir)
    try:
        with pytest.raises(MXNetError, match="already running"):
            mt.profiler.start_xla_trace(logdir)
        x = torch.randn(64, 64)
        (x @ x).sum()
    finally:
        path = mt.profiler.stop_xla_trace()
    assert os.path.dirname(path) == logdir
    with open(path) as f:
        assert json.load(f)["traceEvents"]
    with pytest.raises(MXNetError, match="no device trace"):
        mt.profiler.stop_xla_trace()


# ------------------------------------------------------------- histogram


def test_histogram_quantiles_within_one_bucket_of_numpy():
    rng = np.random.RandomState(7)
    samples = np.exp(rng.normal(-5.0, 1.5, size=5000))
    h = mt.obs.Histogram()
    for v in samples:
        h.observe(float(v))
    bounds = list(h.bounds)

    def bucket_of(v):
        import bisect
        return bisect.bisect_left(bounds, v)

    for q in (50.0, 95.0, 99.0):
        exact = float(np.percentile(samples, q))
        est = h.quantile(q / 100.0)
        assert est is not None
        assert abs(bucket_of(est) - bucket_of(exact)) <= 1
    snap = h.snapshot()
    assert snap["count"] == len(samples)
    assert abs(snap["sum"] - samples.sum()) / samples.sum() < 1e-9
    assert snap["max"] == samples.max() and snap["min"] == samples.min()


def test_histogram_quantiles_equal_the_reference():
    rng = np.random.RandomState(11)
    samples = np.concatenate([np.exp(rng.normal(-4.0, 2.0, size=3000)),
                              [0.0, 1e-7, 3e7, 0.5, 0.5]])
    hs = (mt.obs.Histogram(), jprof.Histogram())
    for v in samples:
        for h in hs:
            h.observe(float(v))
    qs = [0.0, 0.001, 0.25, 0.5, 0.9, 0.95, 0.99, 0.999, 1.0]
    assert hs[0].quantiles(qs) == hs[1].quantiles(qs)
    assert hs[0].snapshot() == hs[1].snapshot()


def test_histogram_registry_shared_and_resettable():
    h1 = mt.obs.histogram("obs_test_shared")
    h2 = mt.obs.histogram("obs_test_shared")
    assert h1 is h2
    mt.obs.observe("obs_test_shared", 0.5)
    assert h1.count >= 1
    h1.reset()
    assert h1.count == 0 and h1.quantile(0.5) is None
    with pytest.raises(ValueError):
        mt.obs.Histogram(bounds=(1.0, 1.0))


def test_serve_latency_stats_on_shared_histogram():
    from mxnet_tpu_torch.serve.stats import LatencyStats
    st = LatencyStats(name="obs_test_latency_seconds")
    st.reset()
    assert st.snapshot() is None
    rng = np.random.RandomState(3)
    vals = np.abs(rng.normal(0.010, 0.004, size=500)) + 1e-4
    for v in vals:
        st.record(float(v))
    snap = st.snapshot()
    assert snap["window"] == 500
    assert 0 < snap["p50_ms"] <= snap["p95_ms"] <= snap["p99_ms"] \
        <= snap["max_ms"]
    exact_p50 = float(np.percentile(vals, 50)) * 1e3
    assert abs(snap["p50_ms"] - exact_p50) / exact_p50 < 0.25
    assert mt.obs.histogram("obs_test_latency_seconds").count == 500


def test_gauges_survive_reset_counters():
    """The reference's ``tests/test_serve.py`` case the port's profiler
    can now run: gauges outlive a counter reset, and reset alone."""
    saved_counters = _profiler.counters()
    saved_gauges = _profiler.gauges()
    try:
        _profiler.set_gauge("serve_test_gauge", 7.0)
        _profiler.reset_counters()
        assert _profiler.get_gauge("serve_test_gauge") == 7.0
        _profiler.reset_gauges()
        assert _profiler.get_gauge("serve_test_gauge") == 0.0
    finally:
        with _profiler._lock:
            _profiler._counters.update(saved_counters)
            _profiler._gauges.update(saved_gauges)


# ------------------------------------------------------------ prometheus


def _xpkg_state(prof):
    """One registry state in a package: counters, nonfinite gauges and a
    histogram, all under names only this test uses."""
    prof.incr_counter("obs_xpkg_ctr", 5)
    prof.incr_counter("obs_xpkg_ms_total", 12)
    prof.set_gauge("obs_xpkg_gauge", 2.5)
    prof.set_gauge("obs_xpkg_inf", float("inf"))
    prof.set_gauge("obs_xpkg_ninf", float("-inf"))
    prof.set_gauge("obs_xpkg_nan", float("nan"))
    h = prof.histogram("obs_xpkg_hist")
    h.reset()
    for v in (0.001, 0.004, 0.4, 7.5):
        h.observe(v)


def _xpkg(samples):
    return {k: v for k, v in samples.items() if "obs_xpkg_" in k[0]}


def _same(a, b):
    assert a.keys() == b.keys(), sorted(set(a) ^ set(b))
    for k in a:
        assert (math.isnan(a[k]) and math.isnan(b[k])) or a[k] == b[k], k


def test_exposition_parses_in_both_packages_with_equal_samples():
    from mxnet_tpu.obs import prometheus as jprom
    from mxnet_tpu_torch.obs import prometheus as prom
    before = (_profiler.counters().get("obs_xpkg_ctr", 0),
              jprof.counters().get("obs_xpkg_ctr", 0))
    _xpkg_state(_profiler)
    _xpkg_state(jprof)
    # the counters are cumulative per process: equalize the starting
    # point of the two registries
    if before[0] != before[1]:
        lag = _profiler if before[0] < before[1] else jprof
        lag.incr_counter("obs_xpkg_ctr", abs(before[0] - before[1]))
        lag.incr_counter("obs_xpkg_ms_total",
                         12 * abs(before[0] - before[1]) // 5)
    for labels in (None, {}, {"process_index": "1", "world_size": "2"}):
        ours = prom.render_prometheus(labels=labels)
        theirs = jprom.render_prometheus(labels=labels)
        a = _xpkg(jprom.parse_prometheus(ours))
        b = _xpkg(prom.parse_prometheus(theirs))
        _same(a, b)
        _same(a, _xpkg(prom.parse_prometheus(ours)))
        assert len(a) >= 10
    assert "_total_total" not in ours


def test_render_prometheus_parses_and_matches_registry():
    _profiler.incr_counter("obs_test_ctr", 5)
    _profiler.set_gauge("obs_test_gauge", 2.5)
    mt.obs.observe("obs_test_hist", 0.002)
    mt.obs.observe("obs_test_hist", 0.008)
    text = mt.obs.render_prometheus()
    samples = mt.obs.parse_prometheus(text)

    def get(name, **labels):
        return samples[(name, tuple(sorted(labels.items())))]

    assert get("mxnet_tpu_obs_test_ctr_total") >= 5
    assert "_total_total" not in text
    assert get("mxnet_tpu_obs_test_gauge") == 2.5
    assert get("mxnet_tpu_obs_test_hist_count") >= 2
    assert get("mxnet_tpu_obs_test_hist_bucket", le="+Inf") >= 2
    buckets = sorted(
        ((float("inf") if lbl[0][1] == "+Inf" else float(lbl[0][1])), v)
        for (n, lbl) in samples
        if n == "mxnet_tpu_obs_test_hist_bucket"
        for v in [samples[(n, lbl)]])
    assert all(a[1] <= b[1] for a, b in zip(buckets, buckets[1:]))


def test_labeled_histogram_round_trip_with_le():
    h = _profiler.histogram("obs_fed_hist")
    h.reset()
    for v in (0.001, 0.004, 0.4):
        h.observe(v)
    lab0 = {"process_index": "0", "world_size": "2"}
    lab1 = {"process_index": "1", "world_size": "2"}
    text = mt.obs.render_prometheus(labels=lab0) + \
        mt.obs.render_prometheus(labels=lab1)
    samples = mt.obs.parse_prometheus(text)

    def bucket(le, **labels):
        return samples[("mxnet_tpu_obs_fed_hist_bucket",
                        tuple(sorted(dict(labels, le=le).items())))]

    for lab in (lab0, lab1):
        assert bucket("+Inf", **lab) == 3
        assert samples[("mxnet_tpu_obs_fed_hist_count",
                        tuple(sorted(lab.items())))] == 3
        assert samples[("mxnet_tpu_obs_fed_hist_sum",
                        tuple(sorted(lab.items())))] == pytest.approx(0.405)
        series = sorted(
            ((float("inf") if lbl_d["le"] == "+Inf"
              else float(lbl_d["le"])), v)
            for (n, lbl), v in samples.items()
            if n == "mxnet_tpu_obs_fed_hist_bucket"
            for lbl_d in [dict(lbl)]
            if lbl_d.get("process_index") == lab["process_index"])
        assert [v for _le, v in series] == sorted(v for _le, v in series)
        assert series[-1][1] == 3


def test_same_name_different_labels_coexist():
    _profiler.incr_counter("obs_fed_ctr", 2)
    text = mt.obs.render_prometheus(
        labels={"process_index": "0", "world_size": "2"}) + \
        mt.obs.render_prometheus(
            labels={"process_index": "1", "world_size": "2"})
    samples = mt.obs.parse_prometheus(text)
    keys = [lbl for (n, lbl) in samples
            if n == "mxnet_tpu_obs_fed_ctr_total"]
    assert len(keys) == 2 and keys[0] != keys[1]
    samples_bare = mt.obs.parse_prometheus(
        mt.obs.render_prometheus(labels={}))
    assert ("mxnet_tpu_obs_fed_ctr_total", ()) in samples_bare
    # one process: no identity labels by default
    assert mt.obs.pod_labels() == {}


def test_parse_prometheus_rejects_malformed():
    with pytest.raises(ValueError):
        mt.obs.parse_prometheus("not a metric line !!!\n")
    with pytest.raises(ValueError):
        mt.obs.parse_prometheus("metric_ok{le=unquoted} 1\n")
    with pytest.raises(ValueError):
        mt.obs.parse_prometheus("metric_ok notanumber\n")
    ok = mt.obs.parse_prometheus(
        '# HELP m doc\n# TYPE m counter\nm{a="b",c="d"} 1e3\nn +Inf\n')
    assert ok[("m", (("a", "b"), ("c", "d")))] == 1000.0


def test_metrics_http_endpoint():
    _profiler.incr_counter("obs_test_http_ctr")
    with mt.obs.start_metrics_server(port=0) as srv:
        assert srv.port > 0
        body = urllib.request.urlopen(srv.url, timeout=10).read().decode()
        samples = mt.obs.parse_prometheus(body)
        assert ("mxnet_tpu_obs_test_http_ctr_total", ()) in samples
        with pytest.raises(urllib.error.HTTPError):
            urllib.request.urlopen(
                "http://%s:%d/other" % (srv.host, srv.port), timeout=10)


# ---------------------------------------------------------------- serving


def _lm_params(vocab=64, layers=2, d_model=32, heads=2, d_ff=64, seq=32):
    from mxnet_tpu_torch.models.transformer import param_shapes
    rng = np.random.default_rng(5)
    out = {}
    for name, shape in param_shapes(vocab, layers, d_model, heads, d_ff,
                                    seq).items():
        if name.endswith("_gamma"):
            out[name] = np.ones(shape, np.float32)
        elif name.endswith(("_beta", "_bias")):
            out[name] = np.zeros(shape, np.float32)
        else:
            out[name] = rng.standard_normal(shape, np.float32) * 0.02
    return out


def _scrape(port):
    body = urllib.request.urlopen(
        "http://127.0.0.1:%d/metrics" % port, timeout=10).read().decode()
    return mt.obs.parse_prometheus(body)


def _inference(name, **kw):
    return mt.serve.InferenceServer(lambda x: x * 2.0, max_batch_size=4,
                                    ctx=CPU, name=name, **kw)


def _generative(name, **kw):
    return mt.serve.GenerativeServer(_lm_params(), n_heads=2,
                                     max_sequences=2, page=4, name=name,
                                     device="cpu", **kw)


def test_serve_server_metrics_port():
    srv = _inference("obs_msrv", metrics_port=0)
    try:
        assert srv.metrics_port and srv.metrics_port > 0
        srv.submit(np.ones((3,), np.float32)).result(timeout=30)
        samples = _scrape(srv.metrics_port)
        assert ("mxnet_tpu_obs_msrv_latency_seconds_count", ()) in samples
    finally:
        srv.close()
    srv2 = _inference("obs_msrv2")
    try:
        assert srv2.metrics_port is None
    finally:
        srv2.close()


def test_generative_server_metrics_port():
    srv = _generative("obs_gsrv", metrics_port=0)
    try:
        assert srv.metrics_port and srv.metrics_port > 0
        out = srv.submit_generate([1, 2, 3], max_new_tokens=4).result(
            timeout=60)
        samples = _scrape(srv.metrics_port)
        st = srv.stats()
        assert samples[("mxnet_tpu_obs_gsrv_tokens_total", ())] == \
            st["tokens"] == len(out)
        assert samples[("mxnet_tpu_obs_gsrv_ttft_seconds_count", ())] == \
            st["ttft"]["window"] == 1
        assert samples[("mxnet_tpu_obs_gsrv_tpot_seconds_count", ())] == \
            st["tpot"]["window"]
    finally:
        srv.close()
    # closed: the port is released
    with pytest.raises(urllib.error.URLError):
        _scrape(srv.metrics_port)


@pytest.mark.parametrize("make", [_inference, _generative],
                         ids=["inference", "generative"])
def test_metrics_port_knob_starts_the_endpoint(make):
    snap = cfg.snapshot_overrides(["MXNET_TPU_OBS_METRICS_PORT"])
    cfg.set("MXNET_TPU_OBS_METRICS_PORT", 0)
    try:
        srv = make("obs_knob_" + make.__name__.strip("_"))
        try:
            assert srv.metrics_port and srv.metrics_port > 0
            assert _scrape(srv.metrics_port)
        finally:
            srv.close()
        # the argument wins over the knob
        srv = make("obs_knob2_" + make.__name__.strip("_"), metrics_port=-1)
        try:
            assert srv.metrics_port is None
        finally:
            srv.close()
    finally:
        cfg.restore_overrides(snap)


@pytest.mark.parametrize("make", [_inference, _generative],
                         ids=["inference", "generative"])
def test_serve_metrics_port_conflict_degrades_not_raises(make):
    """A port conflict must not take the serving path down: the second
    server comes up WITHOUT an endpoint, counted."""
    name = "obs_conflict_" + make.__name__.strip("_")
    srv1 = make(name, metrics_port=0)
    try:
        with _profiler.counter_delta() as d:
            srv2 = make(name, metrics_port=srv1.metrics_port)
            try:
                assert srv2.metrics_port is None
                assert d.get(name + "_metrics_bind_failed") == 1
                if make is _inference:
                    srv2.submit(np.ones((2,), np.float32)).result(timeout=30)
                else:
                    srv2.submit_generate([1, 2], max_new_tokens=2).result(
                        timeout=60)
            finally:
                srv2.close()
    finally:
        srv1.close()


def test_abandoned_server_releases_its_port():
    srv = _inference("obs_gc", metrics_port=0)
    port = srv.metrics_port
    del srv
    gc.collect()
    deadline = time.monotonic() + 10
    while time.monotonic() < deadline:
        try:
            _scrape(port)
        except urllib.error.URLError:
            break
        time.sleep(0.05)
    else:
        pytest.fail("the endpoint of a collected server still answers")


def test_request_flows_through_the_batcher(obs_on, tmp_path):
    """Every request's flow runs from ``serve_submit`` on its client's
    lane through ``serve_launch`` to ``serve_resolve`` on the batcher's
    lane (chip_smoke's 19b check), with a coalesce span per batch."""
    _profiler.set_config(filename=os.path.join(str(tmp_path), "s.json"))
    _profiler.dump()
    srv = mt.serve.InferenceServer(lambda x: x * 2.0, max_batch_size=4,
                                   max_delay_us=20000, ctx=CPU,
                                   name="tobs_flow")

    def client(i):
        for _ in range(3):
            srv.submit(np.full((3,), i, np.float32)).result(timeout=30)

    try:
        threads = [threading.Thread(target=client, args=(i,),
                                    name="client-%d" % i) for i in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(30)
        batches = srv.stats()["batches"]
    finally:
        srv.close()
    events, lanes = chip_smoke.load_trace(_profiler.dump())
    flows = chip_smoke.request_flows(events, lanes,
                                     "mxnet_tpu_torch.serve[tobs_flow]")
    assert len(flows) == 12
    assert sorted(set(flows.values())) == ["client-%d" % i for i in range(4)]
    coalesce = [e for e in events
                if e["ph"] == "X" and e["name"] == "serve_coalesce"]
    assert len(coalesce) == batches


# ----------------------------------------------------- compile accounting


def test_bind_populates_compile_telemetry():
    """An executor's graph build lands in the ring with its scope and
    feeds the counters and histograms; a build inside a fit step is the
    fused step's (the scope is open with the module's signature)."""
    hist = mt.obs.histogram("obs_bind_ms")
    count_before = hist.count
    with _profiler.counter_delta() as d:
        mod = _bound_mlp(hidden=5)
    assert d.get("obs_compile_count") >= 1
    assert d.get("obs_bind_ms_total") >= 0
    assert hist.count > count_before
    recs = [r for r in mt.obs.compiles.snapshot()
            if r["scope"] == "graph:softmax_output"]
    assert recs, "no executor record in the ring"
    r = recs[-1]
    assert r["source"] == "graph" and r["trace_ms"] > 0
    assert r["bind_ms"] >= r["compile_ms"] >= 0 and r["lower_ms"] == 0
    assert mt.obs.histogram("obs_trace_ms").count > 0
    seen = []
    fwd = mod._exec.forward_inputs

    def spy(*a, **kw):
        seen.append(getattr(mt.obs.compiles._tls, "scope", None))
        return fwd(*a, **kw)

    # the step's forward, compiled or eager, runs through forward_inputs
    mod._exec.forward_inputs = spy
    mod._fit_step(_batch())
    assert seen == [("fused_step", mod._obs_sig)]
    assert "fused_step" in repr(mod._obs_sig)
    assert getattr(mt.obs.compiles._tls, "scope", None) is None


def test_compile_scope_attributes_unscoped_as_none():
    rec = mt.obs.compiles.record(1.5, 0.5, source="test")
    assert rec["scope"] is None and rec["bind_ms"] == 2.0
    with mt.obs.compile_scope("outer", ("sig", 1)):
        with mt.obs.compile_scope("inner"):
            assert mt.obs.compiles.record(1.0)["scope"] == "inner"
        rec = mt.obs.compiles.record(1.0)
        assert rec["scope"] == "outer" and rec["signature"] == "('sig', 1)"
    recs = mt.obs.compiles.snapshot()
    assert recs and len(recs) <= mt.obs.compiles.RING_CAPACITY


def test_serve_runner_first_bind_is_recorded():
    """Each bucket's first bind lands in the ring under the server's
    name; a warm bucket adds nothing."""
    srv = _inference("tobs_bind")
    try:
        with _profiler.counter_delta() as d:
            srv.submit(np.ones((3,), np.float32)).result(timeout=30)
            srv.submit(np.ones((3,), np.float32)).result(timeout=30)
    finally:
        srv.close()
    recs = [r for r in mt.obs.compiles.snapshot()
            if r["scope"] == "tobs_bind"]
    assert len(recs) == d.get("tobs_bind_compile") == 1
    assert recs[0]["source"] == "runner" and "1" in recs[0]["signature"]
    gen = _generative("tobs_gbind")
    try:
        gen.submit_generate([1, 2, 3], max_new_tokens=3).result(timeout=60)
    finally:
        gen.close()
    recs = [r for r in mt.obs.compiles.snapshot()
            if r["scope"] == "tobs_gbind"]
    kinds = sorted({eval(r["signature"])[0] for r in recs})
    assert kinds == ["gen_decode", "gen_prefill"]
    assert len(recs) == _profiler.get_counter("tobs_gbind_compile")


def test_export_is_recorded(tmp_path):
    data = mt.sym.Variable("data")
    net = mt.sym.FullyConnected(data, num_hidden=4, name="efc")
    rng = np.random.RandomState(0)
    params = {"arg:efc_weight": rng.rand(4, 6).astype(np.float32),
              "arg:efc_bias": np.zeros(4, np.float32)}
    pred = mt.Predictor(net.tojson(), params, {"data": (2, 6)}, ctx=CPU)
    path = os.path.join(str(tmp_path), "e.mxprog")
    pred.export(path)
    recs = [r for r in mt.obs.compiles.snapshot() if r["scope"] == "export"]
    assert recs and recs[-1]["source"] == "export"
    assert recs[-1]["compile_ms"] > 0 and path in recs[-1]["signature"]


def test_native_build_lands_in_the_ring_before_obs_is_imported(tmp_path):
    """The port's compile events come from its builds: a g++ build made
    before anything imported ``mt.obs`` still lands in the ring (scope
    None), and one made under a scope is that scope's."""
    import subprocess
    import sys
    code = """
import sys
import mxnet_tpu_torch as mt
from mxnet_tpu_torch import native
assert "mxnet_tpu_torch.obs" not in sys.modules
native.build(out_dir=sys.argv[1] + "/a")
assert "mxnet_tpu_torch.obs" in sys.modules
from mxnet_tpu_torch.obs import compiles
with compiles.scope("fused_step", "sig"):
    native.build(out_dir=sys.argv[1] + "/b")
native.build(out_dir=sys.argv[1] + "/b")      # up to date: a load
recs = compiles.snapshot()
assert [(r["scope"], r["source"]) for r in recs] == \\
    [(None, "g++"), ("fused_step", "g++")], recs
assert all(r["compile_ms"] > 0 and r["trace_ms"] == 0 for r in recs)
assert mt.profiler.get_counter("obs_compile_count") == 2
print("BUILD-RECORDED")
"""
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=repo)
    res = subprocess.run([sys.executable, "-c", code, str(tmp_path)],
                         env=env, capture_output=True, text=True,
                         timeout=120)
    assert res.returncode == 0, res.stderr[-3000:]
    assert "BUILD-RECORDED" in res.stdout


# ------------------------------------------------------------------- MFU


def test_obs_mfu_matches_independent_throughput_math():
    snap = cfg.snapshot_overrides(["MXNET_TPU_OBS_PEAK_FLOPS"])
    cfg.set("MXNET_TPU_OBS_PEAK_FLOPS", 1e9)
    try:
        mod = _bound_mlp(hidden=64, batch=32)
        db = _batch(batch=32)
        for _ in range(2):
            mod._fit_step(db)
        assert mod._step_token() is None         # the CPU: done on return
        mt.obs.report()
        n = 100
        t0 = time.perf_counter()
        for _ in range(n):
            mod._fit_step(db)
        dt = time.perf_counter() - t0
        rep = mt.obs.report()
        execs = [e for e in rep["executors"] if e["steps_per_sec"]
                 and e["name"] == mod._obs_label]
        assert execs, rep["executors"]
        e = max(execs, key=lambda r: r["steps_per_sec"])
        assert e["flops_per_step"] and e["flops_per_step"] > 0
        independent_rate = n / dt
        rel = abs(e["steps_per_sec"] - independent_rate) / independent_rate
        assert rel < 0.10, (e["steps_per_sec"], independent_rate)
        assert e["mfu"] == pytest.approx(e["flops_per_sec"] / 1e9)
        assert rep["gauges"]["obs_mfu"] > 0
        assert rep["gauges"]["obs_flops_per_sec"] > 0
        score = mt.obs.probe_score()
        assert set(score) == {"steps_per_sec", "mfu", "flops_per_sec",
                              "pod", "loop_recompile"}
    finally:
        cfg.restore_overrides(snap)


def test_mfu_flops_model_matches_mlp_closed_form():
    from mxnet_tpu_torch.obs import mfu as _mfu
    mod = _bound_mlp(hidden=16, batch=8)
    mod._obs_flops_per_step = None
    fps = _mfu._flops_per_step(mod)
    fwd = 2 * 8 * 16 * 6 + 8 * 16 + 8 * 16 + 2 * 8 * 2 * 16 + 8 * 2 \
        + 5 * 8 * 2
    assert fps == pytest.approx(3 * fwd, rel=0.15)


def _lm_symbols(attn, V=1000, L=2, D=256, H=4, T=128):
    from mxnet_tpu.models import transformer as jtr
    sym = jtr.get_symbol(vocab_size=V, num_layers=L, d_model=D, n_heads=H,
                         seq_len=T, attention=attn)
    return sym, mt.sym.load_json(sym.tojson())


@pytest.mark.parametrize("net", ["mlp", "dense", "flash"])
def test_cost_model_flops_equal_the_reference(net):
    """One Symbol JSON through both packages' cost model: equal FLOPs
    (rel 1e-9) and bytes moved; the MLP also equals its closed form."""
    from mxnet_tpu.analysis import analyze_symbol as janalyze
    from mxnet_tpu_torch.analysis import analyze_symbol
    if net == "mlp":
        ref = _mlp(mx, hidden=16)
        sym = mt.sym.load_json(ref.tojson())
        shapes = {"data": (8, 6), "softmax_label": (8,)}
    else:
        ref, sym = _lm_symbols(net)
        shapes = {"data": (4, 128), "softmax_label": (4, 128)}
    want = janalyze(ref, input_shapes=shapes).extras["cost"]
    got = analyze_symbol(sym, input_shapes=shapes, device="cpu",
                         calibrate_remat=False).extras["cost"]
    assert got["nodes_skipped"] == want["nodes_skipped"] == 0
    assert got["flops"] == pytest.approx(want["flops"], rel=1e-9)
    assert got["bytes_moved"] == want["bytes_moved"]
    assert got["bound_bytes"] == want["bound_bytes"]
    if net == "mlp":
        # fc1, relu, fc2, softmax; the bias adds are not priced
        assert got["flops"] == 2 * 8 * 16 * 6 + 8 * 16 + 2 * 8 * 2 * 16 \
            + 5 * 8 * 2


def test_transformer_flops_model_matches_palm_accounting():
    from mxnet_tpu_torch.analysis import analyze_symbol
    from mxnet_tpu_torch.models import transformer
    L, D, H, T, V, B = 2, 256, 4, 128, 1000, 4
    n_params = transformer.param_count(V, L, D, H, seq_len=T)
    palm = 6 * (n_params - (V * D + T * D)) + 12 * L * D * T
    for attn in ("dense", "flash"):
        sym = transformer.get_symbol(vocab_size=V, num_layers=L,
                                     d_model=D, n_heads=H, seq_len=T,
                                     attention=attn)
        rep = analyze_symbol(sym, input_shapes={"data": (B, T),
                                                "softmax_label": (B, T)},
                             device="cpu", calibrate_remat=False)
        per_tok = 3.0 * rep.extras["cost"]["flops"] / (B * T)
        assert abs(per_tok / palm - 1.0) < 0.05, (attn, per_tok, palm)


def test_module_analyze_surface():
    mod = _bound_mlp()
    rep = mod.analyze()
    assert rep.extras["cost"]["flops"] > 0
    assert any(f.code == "cost-model" for f in rep.findings)
    with pytest.raises(MXNetError, match="A9"):
        mod.analyze(sharding=True)
    unbound = mt.mod.Module(_mlp(), context=CPU)
    rep = unbound.analyze(input_shapes={"data": (4, 6),
                                        "softmax_label": (4,)})
    assert rep.extras["cost"]["flops"] > 0
    # Symbol.analyze (A10b): without shapes the analysis is partial
    rep = _mlp().analyze()
    assert any(f.code == "shape-error" and f.severity.name == "INFO"
               for f in rep.findings)


def test_peak_flops_table_and_override():
    from mxnet_tpu.obs import mfu as jmfu
    from mxnet_tpu_torch.obs import mfu as _mfu
    assert _mfu.peak_flops("TPU v4") == 275e12
    assert _mfu.peak_flops("TPU v5 lite") == 197e12
    assert _mfu.peak_flops("weird accelerator") is None
    # the reference's rows are kept, for the same kinds the same peaks
    for kind, _ in jmfu.PEAK_FLOPS_BY_DEVICE_KIND:
        assert _mfu.peak_flops("TPU " + kind) == \
            jmfu.peak_flops("TPU " + kind)
    assert _mfu.peak_flops("NVIDIA H100 80GB HBM3") == 989e12
    for other in ("NVIDIA H100 PCIe", "NVIDIA A100-SXM4-80GB",
                  "NVIDIA GeForce RTX 4090", "Tesla V100-SXM2-16GB"):
        assert _mfu.peak_flops(other) is None, other
    assert _mfu.peak_flops() is None          # no card here
    snap = cfg.snapshot_overrides(["MXNET_TPU_OBS_PEAK_FLOPS"])
    cfg.set("MXNET_TPU_OBS_PEAK_FLOPS", 123.0)
    try:
        assert _mfu.peak_flops("TPU v4") == 123.0
        assert _mfu.peak_flops("NVIDIA A100-SXM4-80GB") == 123.0
    finally:
        cfg.restore_overrides(snap)


def test_report_schema():
    mod = _bound_mlp()
    mod._fit_step(_batch())
    rep = mt.obs.report()
    assert set(rep) == {"executors", "compiles", "counters", "gauges",
                        "histograms"}
    assert any(e["name"] == mod._obs_label for e in rep["executors"])
    assert all(k.startswith("obs_") for k in rep["counters"])
    h = rep["histograms"]["obs_bind_ms"]
    assert set(h) == {"count", "sum", "max", "p50", "p99"}
    rec = [e for e in rep["executors"] if e["name"] == mod._obs_label][0]
    # the roofline block (A10b): the MFU collector's cost model loaded
    # the analyzer; no roofline row for the host CPU, so None here
    assert set(rec) == {"name", "steps", "flops_per_step", "steps_per_sec",
                        "flops_per_sec", "mfu", "peak_flops", "cost", "mesh",
                        "roofline"}
    assert rec["mesh"] is None and rec["roofline"] is None


# ------------------------------------ phase 19 rehearsed on the CPU


@pytest.fixture
def small_obs(monkeypatch, tmp_path):
    """Phase 19 on the CPU at a small width; returns the logged lines."""
    from mxnet_tpu_torch.ops import flash_attention as fa
    for name, value in (("DEVICE", "cpu"), ("VOCAB", 64), ("LAYERS", 2),
                        ("D_MODEL", 32), ("HEADS", 2), ("D_FF", 64),
                        ("MAX_SEQ", 64), ("SLOTS", 4), ("PAGE", 4),
                        ("NEW_TOKENS", 5), ("PROMPT_LENS", (3, 9, 17, 30)),
                        ("TRAIN_BATCH", 2),
                        ("SERVE_LAYERS", 18), ("SERVE_CLASSES", 10),
                        ("SERVE_IMAGE", 64), ("SERVE_MAX_BATCH", 4),
                        ("OBS_SERVE_CLIENTS", 4), ("OBS_SERVE_EACH", 2),
                        ("ROOT", tmp_path)):
        monkeypatch.setattr(chip_smoke, name, value)
    monkeypatch.setattr(mt, "gpu", lambda i=0: mt.cpu())
    monkeypatch.setattr(torch.cuda, "Event", _Event)
    for fn in ("synchronize", "empty_cache", "reset_peak_memory_stats"):
        monkeypatch.setattr(torch.cuda, fn, lambda *a: None)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated", lambda *a: 0)
    monkeypatch.setattr(fa, "_dispatch", lambda q, what: True)
    monkeypatch.setattr(fa, "flash_attention_fwd",
                        _counting(fa.flash_attention_reference))
    monkeypatch.setattr(fa, "flash_attention_bwd_dq", _counting(_plain_dq))
    monkeypatch.setattr(fa, "flash_attention_bwd_dkv", _counting(_plain_dkv))
    lines = []
    monkeypatch.setattr(chip_smoke, "log", lambda *a: lines.append(a[0]))
    # what phase 4 leaves: its weights and its f32 burst's greedy tokens
    params = chip_smoke.seeded_params(np, chip_smoke.SEED)
    rng = np.random.default_rng(chip_smoke.SEED + 1)
    prompts = [rng.integers(0, 64, n) for n in chip_smoke.PROMPT_LENS]
    srv = mt.serve.GenerativeServer(params, n_heads=2, max_sequences=4,
                                    page=4, name="rehearse19_p4",
                                    device="cpu")
    try:
        outs = [h.result(timeout=240) for h in
                [srv.submit_generate(p, max_new_tokens=5) for p in prompts]]
    finally:
        srv.close(timeout=240)
    monkeypatch.setattr(chip_smoke, "PHASE4",
                        {"params": params, "outs": outs})
    return lines


def test_obs_phase_rehearsal_on_cpu(small_obs):
    """The whole of phase 19 at a small width: every check passes and
    each part logs its readings."""
    out = chip_smoke.obs_phase(torch, np)
    lines = small_obs
    n = chip_smoke.OBS_SERVE_CLIENTS * chip_smoke.OBS_SERVE_EACH
    assert out["19a"]["scrape"]["tokens"] == out["19a"]["tokens"] > 0
    assert out["19b"]["flows"] == out["19b"]["requests"] == n
    fit = out["19c"]
    assert abs(fit["flops_per_step"] / fit["palm_flops"] - 1) <= \
        chip_smoke.OBS_FLOPS_RTOL
    # no peak is known for the CPU: obs does not fabricate an MFU
    assert fit["mfu"] is None
    assert out["19d"]["records"] > 0
    assert all(not k.startswith("None/") for k in out["19d"]["by_scope"])
    assert out["19e"]["beats"] >= chip_smoke.OBS_BB_BEATS
    for prefix in ("19a GenerativeServer with /metrics",
                   "19b InferenceServer over a Predictor",
                   "19c fit of the LM", "19c step time",
                   "19d compile ring", "19f lockcheck (warn)",
                   "19e flight recorder", "19 observability"):
        assert any(ln.startswith(prefix) for ln in lines), prefix
    assert not (chip_smoke.ROOT / "build" / "phase19").exists()


def test_request_flow_check_fails_a_broken_trace():
    """The 19b flow check tells a request that never reached the batcher
    from one that did."""
    lanes = {"client-0": 1, "batcher": 2}
    ok = [{"ph": "X", "name": "serve_submit", "ts": 0.0, "dur": 1.0,
           "tid": 1, "args": {"flow": 7}},
          {"ph": "s", "cat": "flow", "id": 7, "ts": 0.0, "tid": 1},
          {"ph": "X", "name": "serve_launch", "ts": 5.0, "dur": 4.0,
           "tid": 2},
          {"ph": "t", "cat": "flow", "id": 7, "ts": 6.0, "tid": 2},
          {"ph": "X", "name": "serve_resolve", "ts": 10.0, "dur": 2.0,
           "tid": 2},
          {"ph": "t", "cat": "flow", "id": 7, "ts": 11.0, "tid": 2}]
    assert chip_smoke.request_flows(ok, lanes, "batcher") == {7: "client-0"}
    no_resolve = ok[:-1]
    with pytest.raises(chip_smoke.SmokeFailure, match="serve_resolve"):
        chip_smoke.request_flows(no_resolve, lanes, "batcher")
    outside = ok[:3] + [dict(ok[3], ts=20.0)] + ok[4:]
    with pytest.raises(chip_smoke.SmokeFailure, match="serve_launch"):
        chip_smoke.request_flows(outside, lanes, "batcher")
    two_starts = ok + [{"ph": "s", "cat": "flow", "id": 7, "ts": 1.0,
                        "tid": 1}]
    with pytest.raises(chip_smoke.SmokeFailure, match="flow starts"):
        chip_smoke.request_flows(two_starts, lanes, "batcher")
