"""The port's ``InferenceServer``, ``wrap_model`` and ``BucketSpec``
against the reference's (oracle: ``tests/test_serve.py``), and
``chip_smoke.py``'s phase 17 (serving) rehearsed on the CPU.

Every case of the oracle runs here on the port on the CPU (the
profiler's gauge reset and the ``/metrics`` endpoint in
``tests/test_torch_obs.py``); where
a served value is compared across packages, the same numpy-seeded
weights and requests go through the reference's server too, and the
rows agree within 1e-5 of max(1, max|ref|) (the same f32 formulas,
summed in another order). Within the port, coalescing and padding are
exact: served rows equal the model's rows on the stacked (padded) batch
bit for bit.

The rehearsal runs phase 17's code as the card runs it, at a small
width: ResNet-18 at 64x64 with 10 classes behind a ``Predictor``, 8
closed-loop clients over ``BucketSpec(4)``, the Module and Gluon
(``resnet18_v1``) adapters, the export run by the standalone loader in a
subprocess, and the int8 ``GenerativeServer`` on a 2-layer zoo LM, with
the CUDA-only calls stood in for and the flash forward kernel replaced
by a counting wrapper around its plain version. Each of the phase's
checks holds here.
"""
import gc
import sys
import threading
import time
import weakref
from pathlib import Path

import numpy as np
import pytest
import torch

import mxnet_tpu as mx
import mxnet_tpu_torch as mt
from mxnet_tpu import config as jax_cfg
from mxnet_tpu import serve as jax_serve
from mxnet_tpu_torch import config as cfg
from mxnet_tpu_torch import faults, lockcheck, profiler, serve
from mxnet_tpu_torch._fused import Uncacheable, structural_failure
from mxnet_tpu_torch.base import MXNetError

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
import chip_smoke  # noqa: E402
from test_torch_wgmma_support import _Event, _counting  # noqa: E402

# test files run side by side in parallel workers: each keeps torch's
# intra-op pool small
torch.set_num_threads(2)

CPU = mt.cpu()
TOL = 1e-5


def _close(got, want, tol=TOL, what=""):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(1.0, float(np.abs(want).max(initial=0.0)))
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale,
                               err_msg=what)


def _mlp_pair(seed=0):
    """The oracle's MLP (Dense 32 relu, Dense 8 over 24 features) in
    both packages, the port's holding the reference's Xavier weights."""
    nets = []
    for pkg in (mx, mt):
        nn = pkg.gluon.nn
        net = nn.Sequential(prefix="smlp_")
        with net.name_scope():
            net.add(nn.Dense(32, activation="relu", in_units=24),
                    nn.Dense(8, in_units=32))
        nets.append(net)
    ref, net = nets
    ref.initialize(mx.init.Xavier(rnd_type="uniform"))
    net.initialize(ctx=CPU)
    want = {k: p.data().asnumpy() for k, p in ref.collect_params().items()}
    for k, p in net.collect_params().items():
        p.set_data(want[k])
    return ref, net


def _port_rows(net, x):
    return net(mt.nd.array(x, ctx=CPU)).asnumpy()


def _samples(n, dim=24, seed=0):
    rng = np.random.RandomState(seed)
    return [rng.rand(dim).astype(np.float32) for _ in range(n)]


def _server(model, **kw):
    kw.setdefault("ctx", CPU)
    return serve.InferenceServer(model, **kw)


def _sym_net(pkg):
    data = pkg.sym.Variable("data")
    fc1 = pkg.sym.FullyConnected(data, num_hidden=16, name="fc1")
    act = pkg.sym.Activation(fc1, act_type="relu")
    fc2 = pkg.sym.FullyConnected(act, num_hidden=4, name="fc2")
    return pkg.sym.SoftmaxOutput(fc2, name="softmax")


def _sym_params(seed=7):
    rng = np.random.RandomState(seed)
    return {"fc1_weight": rng.randn(16, 12).astype(np.float32) * 0.1,
            "fc1_bias": np.zeros(16, np.float32),
            "fc2_weight": rng.randn(4, 16).astype(np.float32) * 0.1,
            "fc2_bias": np.zeros(4, np.float32)}


# ------------------------------------------------------------ correctness

def test_batch_split_bit_for_bit():
    """A burst that fills one bucket returns, per request, the bits of
    the model on the stacked batch; and the reference's server rows."""
    ref, net = _mlp_pair()
    xs = _samples(16)
    direct = _port_rows(net, np.stack(xs))
    srv = _server(net, max_batch_size=16, max_delay_us=300_000,
                  name="tserve_split")
    try:
        got = [np.asarray(f.result(timeout=60))
               for f in [srv.submit(x) for x in xs]]
    finally:
        srv.close()
    assert srv.stats()["batches"] == 1
    with jax_serve.InferenceServer(ref, max_batch_size=16,
                                   max_delay_us=300_000,
                                   name="jserve_split") as jsrv:
        want = [np.asarray(f.result(timeout=60))
                for f in [jsrv.submit(x) for x in xs]]
    for i in range(16):
        assert np.array_equal(got[i], direct[i]), i
        _close(got[i], want[i], what="row %d" % i)


def test_padded_rows_bit_for_bit():
    """Serving 3 requests at bucket 4 returns the bits of the model on
    the zero-padded 4-row buffer."""
    _, net = _mlp_pair()
    xs = _samples(3, seed=11)
    buf = np.zeros((4, 24), np.float32)
    buf[:3] = np.stack(xs)
    direct = _port_rows(net, buf)
    srv = _server(net, max_batch_size=4, max_delay_us=300_000,
                  name="tserve_pad")
    try:
        got = [np.asarray(f.result(timeout=60))
               for f in [srv.submit(x) for x in xs]]
    finally:
        srv.close()
    for i in range(3):
        assert np.array_equal(got[i], direct[i]), "padding bled into %d" % i


def test_concurrent_requests_match_sequential():
    """8 threads x 25 requests: every request served, none mixed up,
    each within 1e-5 of sequential batch-1 prediction and of the same
    request served by the reference's server."""
    ref, net = _mlp_pair()
    xs = _samples(200)
    seq = [_port_rows(net, x[None])[0] for x in xs]
    with jax_serve.InferenceServer(ref, max_batch_size=16, max_delay_us=500,
                                   name="jserve_conc") as jsrv:
        want = [np.asarray(f.result(timeout=60))
                for f in [jsrv.submit(x) for x in xs]]
    results = [None] * len(xs)
    errors = []
    with _server(net, max_batch_size=16, max_delay_us=500,
                 name="tserve_conc") as srv:
        def client(tid, lo, hi):
            try:
                futs = [(i, srv.submit(xs[i])) for i in range(lo, hi)]
                for i, f in futs:
                    results[i] = np.asarray(f.result(timeout=60))
            except Exception as exc:               # noqa: BLE001
                errors.append((tid, exc))

        threads = [threading.Thread(target=client,
                                    args=(t, t * 25, (t + 1) * 25))
                   for t in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(120)
        assert not errors, errors
        assert srv.stats()["requests"] == 200
    for i in range(200):
        _close(results[i], seq[i], what="row %d vs batch-1" % i)
        _close(results[i], want[i], what="row %d vs reference" % i)


def test_batched_submit_roundtrip():
    _, net = _mlp_pair()
    x = np.random.RandomState(1).rand(3, 24).astype(np.float32)
    direct = _port_rows(net, np.concatenate([x, np.zeros((1, 24),
                                                          np.float32)]))
    with _server(net, max_batch_size=8, max_delay_us=200,
                 name="tserve_batched") as srv:
        got = np.asarray(srv.submit(x, batched=True).result(timeout=60))
    assert got.shape == (3, 8)
    assert np.array_equal(got, direct[:3])


def test_oversized_batched_request_rejected():
    _, net = _mlp_pair()
    with _server(net, max_batch_size=4, name="tserve_oversize") as srv:
        with pytest.raises(ValueError, match="exceeds max_batch_size"):
            srv.submit(np.zeros((5, 24), np.float32), batched=True)


# -------------------------------------------------------------- bucketing

def _sum_model(x):
    return mt.nd.sum(x, axis=1)


@pytest.mark.parametrize("kw", [
    dict(max_batch_size=32),
    dict(max_batch_size=12),
    dict(max_batch_size=8, batch_buckets=[2, 8]),
    dict(max_batch_size=8, seq_axis=0, max_seq_len=32),
    dict(max_batch_size=4, seq_axis=1, max_seq_len=20, seq_buckets=[5, 20]),
])
def test_bucket_spec_matches_reference(kw):
    """The port's BucketSpec (a copy) maps every geometry where the
    reference's does."""
    mine, ref = serve.BucketSpec(**kw), jax_serve.BucketSpec(**kw)
    assert mine.batch_buckets == ref.batch_buckets
    assert mine.seq_buckets == ref.seq_buckets
    assert mine.executable_bound() == ref.executable_bound()
    for rows in range(1, mine.max_batch_size + 1):
        assert mine.batch_bucket(rows) == ref.batch_bucket(rows)
    if mine.seq_axis is not None:
        for n in range(1, mine.max_seq_len + 1):
            shape = (n, 3) if mine.seq_axis == 0 else (3, n)
            assert mine.sample_bucket(shape) == ref.sample_bucket(shape)


def test_bucketing_bounds_executable_count():
    """Mixed-length load through a seq-bucketed server: the runner count
    stays under the grid bound however many request shapes arrive."""
    spec = serve.BucketSpec(max_batch_size=8, seq_axis=0, max_seq_len=32)
    rng = np.random.RandomState(2)
    with _server(_sum_model, buckets=spec, max_delay_us=500,
                 name="tserve_bucket") as srv:
        futs = []
        for _ in range(120):
            t = int(rng.randint(1, 33))
            futs.append(srv.submit(rng.rand(t, 4).astype(np.float32)))
        for f in futs:
            f.result(timeout=60)
        stats = srv.stats()
    bound = spec.executable_bound()
    assert bound == len(spec.batch_buckets) * len(spec.seq_buckets)
    assert profiler.get_counter("tserve_bucket_compile") <= bound
    assert len(stats["buckets"]) <= len(spec.seq_buckets)


def test_bucketed_padding_matches_unpadded_values():
    spec = serve.BucketSpec(max_batch_size=4, seq_axis=0, max_seq_len=16)
    rng = np.random.RandomState(3)
    xs = [rng.rand(int(t), 4).astype(np.float32)
          for t in rng.randint(1, 17, size=20)]
    with _server(_sum_model, buckets=spec, max_delay_us=200,
                 name="tserve_padval") as srv:
        got = [np.asarray(srv.submit(x).result(60)) for x in xs]
    for x, g in zip(xs, got):
        np.testing.assert_allclose(g, x.sum(axis=0), rtol=1e-6)


def test_negative_seq_axis_rejected():
    with pytest.raises(ValueError, match="non-negative"):
        serve.BucketSpec(max_batch_size=4, seq_axis=-1, max_seq_len=16)


def test_overlong_dynamic_axis_rejected_at_submit():
    spec = serve.BucketSpec(max_batch_size=4, seq_axis=0, max_seq_len=8)
    with _server(lambda x: x, buckets=spec, name="tserve_long") as srv:
        with pytest.raises(ValueError, match="max_seq_len"):
            srv.submit(np.zeros((9, 4), np.float32))


def test_steady_state_serves_with_zero_recompiles():
    """Warm the bucket grid, then a 500-request mixed-shape load leaves
    the runner counter unchanged."""
    spec = serve.BucketSpec(max_batch_size=8, seq_axis=0, max_seq_len=16)
    rng = np.random.RandomState(4)
    with _server(_sum_model, buckets=spec, max_delay_us=300,
                 name="tserve_steady") as srv:
        for b in spec.batch_buckets:
            for s in spec.seq_buckets:
                srv.submit(np.zeros((b, s, 4), np.float32),
                           batched=True).result(timeout=60)
        warm = profiler.get_counter("tserve_steady_compile")
        assert warm == spec.executable_bound()
        futs = [srv.submit(rng.rand(int(rng.randint(1, 17)), 4)
                           .astype(np.float32)) for _ in range(500)]
        for f in futs:
            f.result(timeout=60)
        assert profiler.get_counter("tserve_steady_compile") == warm
        assert profiler.get_counter("tserve_steady_cache_hit") > 0
        lat = srv.stats()["latency"]
    assert lat and lat["p50_ms"] > 0 and lat["p99_ms"] >= lat["p50_ms"]


# ------------------------------------------------------------- robustness

def test_deadline_exceeded_before_launch():
    _, net = _mlp_pair()
    with _server(net, max_batch_size=16, max_delay_us=300_000,
                 name="tserve_deadline") as srv:
        t0 = time.monotonic()
        f = srv.submit(_samples(1)[0], timeout=0.001)
        with pytest.raises(serve.DeadlineExceeded):
            f.result(timeout=30)
        elapsed = time.monotonic() - t0
    assert elapsed < 0.15, "deadline fired %.0f ms late" % (elapsed * 1e3)
    assert profiler.get_counter("tserve_deadline_deadline_expired") >= 1


def test_queue_full_load_shed():
    _, net = _mlp_pair()
    srv = _server(net, max_batch_size=2, queue_bound=2,
                  max_delay_us=500_000, name="tserve_shed")
    try:
        accepted, shed = [], 0
        for x in _samples(8):
            try:
                accepted.append(srv.submit(x))
            except serve.QueueFull:
                shed += 1
        assert shed >= 1, "admission bound never tripped"
        assert profiler.get_counter("tserve_shed_shed") == shed
        for f in accepted:
            f.result(timeout=60)
    finally:
        srv.close()


def test_graceful_close_drains_inflight():
    _, net = _mlp_pair()
    srv = _server(net, max_batch_size=4, max_delay_us=200_000,
                  name="tserve_drain")
    futs = [srv.submit(x) for x in _samples(10)]
    srv.close(drain=True)
    for f in futs:
        assert f.result(timeout=60) is not None
    with pytest.raises(serve.ServerClosed):
        srv.submit(_samples(1)[0])


def test_close_without_drain_fails_queued():
    _, net = _mlp_pair()
    srv = _server(net, max_batch_size=4, max_delay_us=500_000,
                  name="tserve_nodrain")
    futs = [srv.submit(x) for x in _samples(6)]
    srv.close(drain=False)
    outcomes = []
    for f in futs:
        try:
            f.result(timeout=30)
            outcomes.append("done")
        except serve.ServerClosed:
            outcomes.append("closed")
    assert "closed" in outcomes


def test_batched_failure_degrades_to_eager():
    """A model that cannot run the padded geometry: the server
    negative-caches it and serves its traffic per request, each counted
    under ``_eager`` and ``_fallback``."""
    def fragile(x):
        if x.shape[0] == 4:         # the padded bucket size
            raise RuntimeError("no batch-4 for you")
        return mt.nd.sum(x, axis=1)

    with _server(fragile, max_batch_size=4, max_delay_us=200,
                 name="tserve_fragile") as srv:
        x = np.random.RandomState(5).rand(3, 6).astype(np.float32)
        got = np.asarray(srv.submit(x, batched=True).result(timeout=60))
        np.testing.assert_allclose(got, x.sum(axis=1), rtol=1e-6)
    assert profiler.get_counter("tserve_fragile_compile_failed") >= 1
    assert profiler.get_counter("tserve_fragile_eager") >= 1
    assert profiler.get_counter("tserve_fragile_fallback") >= 1


def test_structural_failure_is_permanent_for_its_geometry():
    """A shape error of the model pins its bucket geometry to the eager
    path at once (no retries: the next batch of that geometry is a
    negative-cache hit); a plain RuntimeError is retried up to the
    reference's bound."""
    w = torch.ones(6, 2)

    def shapely(x):
        t = x.data
        if t.shape[0] == 4:
            t = t[:, :5]            # a (4, 5) @ (6, 2) product: a shape error
        return mt.nd.array(t @ w, ctx=CPU)

    with _server(shapely, max_batch_size=4, max_delay_us=200,
                 name="tserve_struct") as srv:
        x = np.random.RandomState(6).rand(3, 6).astype(np.float32)
        for _ in range(2):
            got = np.asarray(srv.submit(x, batched=True).result(timeout=60))
            np.testing.assert_allclose(got, x @ w.numpy(), rtol=1e-6)
    assert profiler.get_counter("tserve_struct_compile_failed") == 1
    assert profiler.get_counter("tserve_struct_neg_hit") == 1
    assert profiler.get_counter("tserve_struct_fallback") == 2


def test_structural_failure_rule():
    def raised(fn):
        try:
            fn()
        except Exception as exc:                   # noqa: BLE001
            return exc
        raise AssertionError("no error")

    shape_errors = [
        raised(lambda: torch.ones(2, 3) @ torch.ones(4, 5)),
        raised(lambda: torch.ones(2, 3) + torch.ones(4, 5)),
        raised(lambda: torch.ones(6).view(4, 2)),
        raised(lambda: torch.nn.functional.conv2d(torch.ones(1, 3, 4, 4),
                                                  torch.ones(2, 4, 1, 1))),
    ]
    assert all(structural_failure(e) for e in shape_errors)
    assert structural_failure(Uncacheable("no fast path"))
    try:
        try:
            raise Uncacheable("inner")
        except Uncacheable as inner:
            raise RuntimeError("wrapped") from inner
    except RuntimeError as outer:
        assert structural_failure(outer)
    assert not structural_failure(RuntimeError("no batch-4 for you"))
    assert not structural_failure(ValueError("bad value"))
    assert not structural_failure(torch.cuda.OutOfMemoryError(
        "CUDA out of memory: shape mismatch"))


def test_row_contract_violation_errors_do_not_kill_batcher():
    def broken(x):
        return mt.nd.sum(x)            # scalar: no row axis at all

    srv = _server(broken, max_batch_size=4, max_delay_us=200,
                  name="tserve_rowviol")
    try:
        f = srv.submit(np.ones((3, 2), np.float32))
        with pytest.raises(Exception):
            f.result(timeout=30)
        assert srv._worker.is_alive(), "batcher thread died"
        f2 = srv.submit(np.ones((3, 2), np.float32))
        with pytest.raises(Exception):
            f2.result(timeout=30)
        assert srv._worker.is_alive()
    finally:
        srv.close()


def test_submit_fault_site_fails_one_request():
    _, net = _mlp_pair()
    with _server(net, max_batch_size=4, max_delay_us=200,
                 name="tserve_fault") as srv:
        faults.install("serve.submit@1")
        try:
            with pytest.raises(faults.FaultInjected):
                srv.submit(_samples(1)[0])
        finally:
            faults.clear()
        assert srv.submit(_samples(1)[0]).result(timeout=60).shape == (8,)


# ------------------------------------------------------------ kill switch

def test_kill_switch_concurrent_eager_is_serialized():
    """With the kill switch off, eager forwards run in caller threads
    against a stateful Module: the model lock keeps concurrent submits
    from swapping each other's inputs."""
    mod = mt.mod.Module(_sym_net(mt), context=CPU)
    mod.bind(data_shapes=[("data", (1, 12))], for_training=False)
    mod.init_params(mt.init.Xavier())
    rng = np.random.RandomState(12)
    xs = [rng.rand(12).astype(np.float32) for _ in range(40)]
    seq = []
    for x in xs:
        mod.forward(mt.io.DataBatch(data=[mt.nd.array(x[None], ctx=CPU)]),
                    is_train=False)
        seq.append(mod.get_outputs()[0].asnumpy()[0])
    cfg.set("MXNET_TPU_SERVE", False)
    try:
        with _server(mod, name="tserve_killconc") as srv:
            got = [None] * len(xs)
            errs = []

            def client(lo, hi):
                try:
                    for i in range(lo, hi):
                        got[i] = np.asarray(srv.submit(xs[i]).result(60))
                except Exception as exc:       # noqa: BLE001
                    errs.append(exc)

            ts = [threading.Thread(target=client, args=(t * 10, t * 10 + 10))
                  for t in range(4)]
            for t in ts:
                t.start()
            for t in ts:
                t.join(120)
            assert not errs, errs
    finally:
        cfg.reset("MXNET_TPU_SERVE")
    assert profiler.get_counter("tserve_killconc_eager") == len(xs)
    for i in range(len(xs)):
        np.testing.assert_allclose(got[i], seq[i], rtol=1e-5, atol=1e-6,
                                   err_msg="request %d" % i)


def test_kill_switch_eager_parity():
    _, net = _mlp_pair()
    xs = _samples(5, seed=6)
    seq = [_port_rows(net, x[None])[0] for x in xs]
    cfg.set("MXNET_TPU_SERVE", False)
    try:
        with _server(net, max_batch_size=8, name="tserve_kill") as srv:
            before = profiler.get_counter("tserve_kill_batches")
            got = [np.asarray(srv.submit(x).result(timeout=60)) for x in xs]
            assert profiler.get_counter("tserve_kill_batches") == before
            assert profiler.get_counter("tserve_kill_eager") >= len(xs)
    finally:
        cfg.reset("MXNET_TPU_SERVE")
    for a, b in zip(seq, got):
        assert np.array_equal(a, b)


def test_serve_knobs_match_reference():
    for name in ("MXNET_TPU_SERVE", "MXNET_TPU_SERVE_MAX_BATCH",
                 "MXNET_TPU_SERVE_MAX_DELAY_US", "MXNET_TPU_SERVE_KV_INT8",
                 "MXNET_TPU_SERVE_QUEUE_BOUND", "MXNET_TPU_ANALYZE",
                 "MXNET_TPU_ANALYZE_HBM_BUDGET"):
        assert cfg.get(name) == jax_cfg.get(name), name
        assert cfg.KNOBS[name].default == jax_cfg.KNOBS[name].default, name
    for raw in ("0", "1", "true", "off", "yes"):
        for name in ("MXNET_TPU_SERVE", "MXNET_TPU_SERVE_KV_INT8"):
            assert cfg.KNOBS[name].typ(raw) == jax_cfg.KNOBS[name].typ(raw)
    for raw in ("off", "warn", "strict", "1", ""):
        assert cfg.KNOBS["MXNET_TPU_ANALYZE"].typ(raw) == \
            jax_cfg.KNOBS["MXNET_TPU_ANALYZE"].typ(raw)
    with pytest.raises(ValueError):
        cfg.KNOBS["MXNET_TPU_ANALYZE"].typ("loud")


# --------------------------------------------------------------- adapters

def test_predictor_adapter_parity():
    """A Predictor served through the batcher: rows within 1e-5 of the
    same requests served by the reference's server over its Predictor,
    and a later direct forward at the declared (1, 12) geometry still
    returns one row."""
    params = _sym_params()
    pred = mt.Predictor(_sym_net(mt).tojson(), params, {"data": (1, 12)},
                        ctx=CPU)
    jpred = mx.Predictor(_sym_net(mx).tojson(), params, {"data": (1, 12)})
    rng = np.random.RandomState(7)
    xs = [rng.rand(12).astype(np.float32) for _ in range(12)]
    seq = []
    for x in xs:
        pred.forward(data=x[None])
        seq.append(pred.get_output(0).asnumpy()[0])
    with _server(pred, max_batch_size=8, max_delay_us=500,
                 name="tserve_pred") as srv:
        got = [np.asarray(f.result(timeout=60))
               for f in [srv.submit(x) for x in xs]]
    with jax_serve.InferenceServer(jpred, max_batch_size=8,
                                   max_delay_us=500,
                                   name="jserve_pred") as jsrv:
        want = [np.asarray(f.result(timeout=60))
                for f in [jsrv.submit(x) for x in xs]]
    for i, (a, b, c) in enumerate(zip(seq, got, want)):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-7)
        _close(b, c, what="request %d" % i)
    pred.forward(data=xs[0][None])
    direct = pred.get_output(0).asnumpy()
    assert direct.shape == (1, 4), direct.shape
    np.testing.assert_allclose(direct[0], seq[0], rtol=1e-6, atol=1e-7)


def test_module_adapter_parity():
    mod = mt.mod.Module(_sym_net(mt), context=CPU)
    mod.bind(data_shapes=[("data", (4, 12))], for_training=False)
    mod.init_params(mt.init.Xavier())
    rng = np.random.RandomState(8)
    xs = [rng.rand(12).astype(np.float32) for _ in range(8)]
    batch = np.zeros((4, 12), np.float32)
    seq = []
    for x in xs:
        batch[0] = x
        mod.forward(mt.io.DataBatch(data=[mt.nd.array(batch, ctx=CPU)]),
                    is_train=False)
        seq.append(mod.get_outputs()[0].asnumpy()[0])
    with _server(mod, max_batch_size=8, max_delay_us=500,
                 name="tserve_mod") as srv:
        got = [np.asarray(f.result(timeout=60))
               for f in [srv.submit(x) for x in xs]]
    for a, b in zip(seq, got):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-7)
    # the bound (4, 12) input was not replaced by a bucket's batch
    assert mod._exec.arg_dict["data"].shape == (4, 12)


def test_wrap_model_rejects_what_it_cannot_batch():
    pred = mt.Predictor(_sym_net(mt).tojson(), _sym_params(),
                        {"data": (1, 12), "softmax_label": (1,)}, ctx=CPU)
    with pytest.raises(ValueError, match="single request tensor"):
        serve.wrap_model(pred)
    with pytest.raises(TypeError, match="cannot wrap"):
        serve.wrap_model(42)


def test_abandoned_server_is_collected_and_thread_exits():
    _, net = _mlp_pair()
    srv = _server(net, max_batch_size=4, max_delay_us=200,
                  name="tserve_gc")
    srv.submit(_samples(1)[0]).result(timeout=60)
    worker = srv._worker
    ref = weakref.ref(srv)
    del srv
    for _ in range(100):
        gc.collect()
        if ref() is None:
            break
        time.sleep(0.05)
    assert ref() is None, "dropped server was never collected"
    worker.join(5.0)
    assert not worker.is_alive(), "batcher thread outlived its server"


# ------------------------------------------------------------------ stats

def test_stats_snapshot_schema():
    """The schema of the reference's stats(), and its invariants."""
    ref, net = _mlp_pair()
    xs = _samples(30, seed=9)
    with _server(net, max_batch_size=8, max_delay_us=300,
                 name="tserve_stats") as srv:
        for f in [srv.submit(x) for x in xs]:
            f.result(timeout=60)
        s = srv.stats()
    with jax_serve.InferenceServer(ref, max_batch_size=8, max_delay_us=300,
                                   name="jserve_stats") as jsrv:
        jsrv.submit(xs[0]).result(timeout=60)
        want = jsrv.stats()
    assert set(s) == set(want)
    assert set(s["latency"]) == set(want["latency"])
    assert s["requests"] == 30
    assert s["batches"] >= 1
    assert 0 < s["occupancy"] <= 1.0
    assert s["avg_batch_rows"] >= 1
    lat = s["latency"]
    assert lat["p50_ms"] <= lat["p95_ms"] <= lat["p99_ms"] <= lat["max_ms"]
    assert s["buckets"], "per-bucket table empty"
    assert s["eager_fallback"] == 0
    assert profiler.get_gauge("tserve_stats_queue_depth") == 0
    assert serve.LatencyStats(capacity=16, name="tserve_cap").capacity == 16


# ------------------------------------------------------ port departures

def test_no_device_without_gpu_raises(monkeypatch):
    """The server stages requests to the card by default and never
    falls back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(MXNetError, match="no CUDA device"):
        serve.InferenceServer(_sum_model)
    with pytest.raises(MXNetError, match="no CUDA device"):
        mt.Predictor(_sym_net(mt).tojson(), _sym_params(), {"data": (1, 12)})


def test_model_lock_allows_sync_under_witness():
    """The model lock carries the reference's ``allow_sync`` through the
    lock witness, and a burst records no lock-order inversion."""
    cfg.set("MXNET_TPU_LOCKCHECK", "abort")
    try:
        lockcheck.reset_order_graph()
        before = profiler.get_counter("lockcheck_inversion")
        _, net = _mlp_pair()
        with _server(net, max_batch_size=4, max_delay_us=200,
                     name="tserve_witness") as srv:
            for f in [srv.submit(x) for x in _samples(8)]:
                f.result(timeout=60)
            assert isinstance(srv._model_lock, lockcheck._WitnessLock)
            assert srv._model_lock._allow_sync is True
            assert srv._lock._allow_sync is False
        assert profiler.get_counter("lockcheck_inversion") == before
    finally:
        cfg.reset("MXNET_TPU_LOCKCHECK")
        lockcheck.reset_order_graph()


# ------------------------------------------- phase 17 rehearsed on the CPU

@pytest.fixture
def small_serve(monkeypatch, tmp_path):
    """Phase 17 on the CPU at a small width; returns the logged lines."""
    from mxnet_tpu_torch.ops import flash_attention as fa
    for name, value in (("DEVICE", "cpu"), ("VOCAB", 64), ("LAYERS", 2),
                        ("D_MODEL", 32), ("HEADS", 2), ("D_FF", 64),
                        ("MAX_SEQ", 64), ("SLOTS", 4), ("PAGE", 4),
                        ("NEW_TOKENS", 5), ("PROMPT_LENS", (3, 9, 17, 30)),
                        ("SERVE_LAYERS", 18), ("SERVE_CLASSES", 10),
                        ("SERVE_IMAGE", 64), ("SERVE_GLUON", "resnet18_v1"),
                        ("SERVE_MAX_BATCH", 4), ("SERVE_CLIENTS", 8),
                        ("SERVE_REPEATS", 2), ("SERVE_SECOND", 8),
                        ("SERVE_KILL", 3), ("SERVE_ADAPTER", 4),
                        ("SERVE_EXPORT_BATCH", 2), ("SERVE_BUDGET", 1e6),
                        ("ROOT", tmp_path)):
        monkeypatch.setattr(chip_smoke, name, value)
    mt.config.set("MXNET_TPU_SERVE_MAX_BATCH", 4)
    # card_phase turns TF32 off; the phase checks that it is
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    monkeypatch.setattr(mt, "gpu", lambda i=0: mt.cpu())
    monkeypatch.setattr(torch.cuda, "Event", _Event)
    for fn in ("synchronize", "empty_cache", "reset_peak_memory_stats"):
        monkeypatch.setattr(torch.cuda, fn, lambda *a: None)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated", lambda *a: 0)
    monkeypatch.setattr(fa, "_dispatch", lambda q, what: True)
    monkeypatch.setattr(fa, "flash_attention_fwd",
                        _counting(fa.flash_attention_reference))
    lines = []
    monkeypatch.setattr(chip_smoke, "log", lambda *a: lines.append(a[0]))
    # what phase 4 leaves: its weights and its f32 burst's greedy tokens
    params = chip_smoke.seeded_params(np, chip_smoke.SEED)
    rng = np.random.default_rng(chip_smoke.SEED + 1)
    prompts = [rng.integers(0, 64, n) for n in chip_smoke.PROMPT_LENS]
    srv = mt.serve.GenerativeServer(params, n_heads=2, max_sequences=4,
                                    page=4, name="rehearse_p4",
                                    device="cpu")
    try:
        outs = [h.result(timeout=240) for h in
                [srv.submit_generate(p, max_new_tokens=5) for p in prompts]]
    finally:
        srv.close(timeout=240)
    monkeypatch.setattr(chip_smoke, "PHASE4",
                        {"params": params, "outs": outs})
    yield lines
    mt.config.reset("MXNET_TPU_SERVE_MAX_BATCH")


def test_serve_phase_rehearsal_on_cpu(small_serve):
    """The whole of phase 17 at a small width: every check passes and
    each part logs its readings."""
    out = chip_smoke.serve_phase(torch, np)
    lines = small_serve
    b = out["batcher"]
    assert b["runners"] == len(b["buckets"]) and b["buckets"]
    assert 0 < b["occupancy"] <= 1
    assert out["export"]["err"] <= chip_smoke.SERVE_EXPORT_ATOL
    g = out["int8"]
    assert g["softmax_worst"] <= chip_smoke.SERVE_INT8_SOFTMAX_TOL
    assert g["slots_int8"] >= 2 * g["slots_f32"]
    assert g["codes_diff"] == 0 and g["decode_codes_diff"] == 0
    # K and V of every layer at each teacher-forced step
    assert g["decode_writes"] == 2 * chip_smoke.LAYERS * (
        chip_smoke.NEW_TOKENS - 1)
    for prefix in ("17a InferenceServer", "17a second pass",
                   "17a padded rows", "17a MXNET_TPU_SERVE=0",
                   "17a wrap_model(Module)",
                   "17a wrap_model(Gluon resnet18_v1)",
                   "17b Predictor.export", "17b loader: loaded",
                   "17c int8 KV cache", "17c teacher-forced",
                   "17c decode's", "17c int8 decode step profiled",
                   "17c f32 decode step profiled", "17 serving"):
        assert any(ln.startswith(prefix) for ln in lines), prefix


def _stale_scale_write(self, codes, scales, new, pos):
    """Requantize-on-write that never resets a page's scale on entry."""
    page = self.cache.page
    n, h, s, d = codes.shape
    slots = torch.arange(n)
    pi, off = pos // page, pos % page
    pages = codes.view(n, h, s // page, page, d)
    old = scales[slots, :, pi]
    deq = pages[slots, :, pi].to(torch.float32) * old[..., None, None]
    scale = torch.maximum(old, torch.clamp(new.abs().amax(-1) / 127.0,
                                           min=1e-8))
    deq[slots, :, off] = new
    pages[slots, :, pi] = torch.clamp(
        torch.round(deq / scale[..., None, None]), -127, 127).to(torch.int8)
    scales[slots, :, pi] = scale


def _misindexed_read(self, li, s_b):
    """``_read_bucket`` dequantizing V with K's page scales."""
    c = self.cache
    k, v = c.k[li, :, :, :s_b], c.v[li, :, :, :s_b]
    if not c.int8:
        return k, v
    n, h, pb = k.shape[0], k.shape[1], s_b // c.page
    sc = c.k_scale[li][:, :, :pb, None, None]
    return tuple((q.to(torch.float32).view(n, h, pb, c.page, -1) * sc)
                 .view(n, h, s_b, -1) for q in (k, v))


@pytest.mark.parametrize("fault,method,match", [
    (_stale_scale_write, "_write_token_i8", "scales after decode differ"),
    (_misindexed_read, "_read_bucket", "_read_bucket's dequantize"),
], ids=["stale_page_scale", "misindexed_read_scale"])
def test_serve_phase_catches_a_faulty_int8_decode(small_serve, monkeypatch,
                                                  fault, method, match):
    """17c holds decode's int8 write and read against a plain version on
    the host: a page scale kept past its tenancy, or a dequantize with
    the wrong scales, ends the phase even where the softmax stays within
    the reference's 5e-2."""
    from mxnet_tpu_torch.serve.decode import DecodeEngine
    monkeypatch.setattr(DecodeEngine, method, fault)
    with pytest.raises(chip_smoke.SmokeFailure, match=match):
        chip_smoke.serve_int8(torch, np, mt)


def test_serve_phase_ends_on_a_fallback(small_serve, monkeypatch):
    """A batched run that falls back to per-request forwards ends the
    run: phase 17 requires ``_eager`` and ``_fallback`` to be 0."""
    from mxnet_tpu_torch.serve import server
    real = server.InferenceServer._call_model

    def fragile(self, x):
        if self.name == "phase17" and x.shape[0] > 1:
            raise RuntimeError("no batched forward")
        return real(self, x)

    monkeypatch.setattr(server.InferenceServer, "_call_model", fragile)
    sym, params = chip_smoke.serve_model(torch, np, mt)
    rng = np.random.RandomState(0)
    images = [rng.uniform(-1, 1, (3, 64, 64)).astype(np.float32)
              for _ in range(chip_smoke.SERVE_CLIENTS)]
    with pytest.raises(chip_smoke.SmokeFailure, match="went eager"):
        chip_smoke.serve_batcher(torch, np, mt, sym, params, images)
