"""The async fit loop of the port, against the synchronous loop and
against the reference's async ``fit``.

The oracle is the reference's ``tests/test_async_fit.py``: window 2 ends
on the weights and metric values of window 0 bit for bit (an MLP, and a
conv / BatchNorm / pool stem whose aux states ride along); window 0 runs
none of the async machinery (the kill switch); the steady state has no
per-batch host sync, places every batch through the prefetch stage and
reads the metric once an epoch; a ``CustomMetric`` falls back to the host
per batch and is counted; a user's ``PrefetchingIter`` is not wrapped
twice; ``fit`` closes the prefetcher it made. Beside those: an MLP through
both packages' async ``fit`` ends within 1e-5, and a mid-epoch and an
epoch-boundary resume from a ``DataLoader`` cursor are bit-identical to
the uninterrupted run. A loader worker that is alive but stuck ends its
test at the 60 s ``MXNET_TPU_DATA_TIMEOUT`` set here, and the prefetch
threads end with ``close()``'s bounded join.
"""
import threading
import time

import numpy as np
import pytest

import mxnet_tpu as mx
import mxnet_tpu_torch as mt
from mxnet_tpu_torch import _fused, profiler, recordio
from mxnet_tpu_torch import config as cfg
from mxnet_tpu_torch import metric as mmetric
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.checkpoint import CheckpointConfig, restore_latest

BATCH, NSAMP, FEAT, NCLS, EPOCHS = 8, 64, 16, 8, 3
LOOP = ("loop_window_wait", "loop_window_drain", "loop_prefetch_placed",
        "loop_metric_sync", "loop_host_sync", "loop_prefetch_stall",
        "loop_nonfinite")


@pytest.fixture(autouse=True)
def _deadline():
    cfg.set("MXNET_TPU_DATA_TIMEOUT", 60.0)
    yield
    cfg.reset("MXNET_TPU_DATA_TIMEOUT")


def _mlp(pkg):
    data = pkg.sym.Variable("data")
    fc1 = pkg.sym.FullyConnected(data, num_hidden=12, name="fc1")
    act = pkg.sym.Activation(fc1, act_type="relu", name="relu1")
    fc2 = pkg.sym.FullyConnected(act, num_hidden=NCLS, name="fc2")
    return pkg.sym.SoftmaxOutput(fc2, name="softmax")


def _stem(pkg):
    data = pkg.sym.Variable("data")
    c = pkg.sym.Convolution(data, num_filter=8, kernel=(3, 3), pad=(1, 1),
                            name="conv0")
    r = pkg.sym.Activation(pkg.sym.BatchNorm(c, name="bn0"),
                           act_type="relu", name="relu0")
    p = pkg.sym.Pooling(r, kernel=(2, 2), stride=(2, 2), pool_type="max",
                        name="pool0")
    fc = pkg.sym.FullyConnected(pkg.sym.Flatten(p, name="flat"),
                                num_hidden=NCLS, name="fc1")
    return pkg.sym.SoftmaxOutput(fc, name="softmax")


def _data(shape=(FEAT,), seed=0):
    rng = np.random.RandomState(seed)
    return (rng.uniform(-1, 1, (NSAMP,) + shape).astype(np.float32),
            rng.randint(0, NCLS, (NSAMP,)).astype(np.float32))


def _init(sym, x_shape):
    rng = np.random.RandomState(42)
    shapes = {"data": (BATCH,) + x_shape, "softmax_label": (BATCH,)}
    args, _, _ = sym.infer_shape(**shapes)
    return {n: rng.uniform(-0.1, 0.1, s).astype(np.float32)
            for n, s in zip(sym.list_arguments(), args) if n not in shapes}


class _Delta:
    def __enter__(self):
        self.before = {c: profiler.get_counter(c) for c in LOOP}
        return self

    def __exit__(self, *exc):
        self.d = {c: profiler.get_counter(c) - self.before[c] for c in LOOP}


def _fit(make_sym, X, Y, window, metric=None, epochs=EPOCHS,
         dev_metrics=True, prefetch=None, it=None, lr=0.1, callback=None):
    sym = make_sym(mt)
    init = _init(sym, X.shape[1:])
    cfg.set("MXNET_TPU_ASYNC_WINDOW", window)
    cfg.set("MXNET_TPU_DEVICE_METRICS", dev_metrics)
    if prefetch is not None:
        cfg.set("MXNET_TPU_DEVICE_PREFETCH", prefetch)
    try:
        it = it if it is not None else mt.io.NDArrayIter(X, Y,
                                                         batch_size=BATCH)
        mod = mt.mod.Module(sym, context=mt.cpu())
        m = metric if metric is not None else mmetric.Accuracy()
        with _Delta() as d:
            mod.fit(it, eval_metric=m, num_epoch=epochs, optimizer="sgd",
                    optimizer_params={"learning_rate": lr},
                    arg_params={k: mt.nd.array(v, ctx=mt.cpu())
                                for k, v in init.items()},
                    batch_end_callback=callback)
        arg, aux = mod.get_params()
        w = {k: v.asnumpy() for k, v in list(arg.items()) +
             list(aux.items())}
        return m.get_name_value(), w, d.d
    finally:
        for k in ("MXNET_TPU_ASYNC_WINDOW", "MXNET_TPU_DEVICE_METRICS",
                  "MXNET_TPU_DEVICE_PREFETCH"):
            cfg.reset(k)


def _equal(w0, w1):
    assert set(w0) == set(w1)
    for k in sorted(w0):
        np.testing.assert_array_equal(w0[k], w1[k], err_msg=k)


# ---------------------------------------------------------------- parity

@pytest.mark.parametrize("make_sym,shape", [(_mlp, (FEAT,)),
                                            (_stem, (3, 8, 8))])
@pytest.mark.parametrize("window,prefetch", [(2, None), (1, 1), (4, 0),
                                             (16, 3)])
def test_async_sync_parity(make_sym, shape, window, prefetch):
    X, Y = _data(shape)
    m0, w0, _ = _fit(make_sym, X, Y, window=0)
    m2, w2, _ = _fit(make_sym, X, Y, window=window, prefetch=prefetch)
    assert m0 == m2
    _equal(w0, w2)


def test_kill_switch_window_zero_runs_no_async_machinery():
    X, Y = _data()
    _, _, d = _fit(_mlp, X, Y, window=0)
    assert d == {c: 0 for c in LOOP}


def test_steady_state_has_no_per_batch_sync():
    X, Y = _data()
    _, _, d = _fit(_mlp, X, Y, window=2)
    assert d["loop_host_sync"] == 0
    assert d["loop_prefetch_placed"] == (NSAMP // BATCH) * EPOCHS
    assert d["loop_metric_sync"] == EPOCHS           # one read an epoch


@pytest.mark.parametrize("name", ["custom", "f1", "pearson"])
def test_host_only_metrics_fall_back_per_batch(name):
    X, Y = _data()
    Y = (Y > NCLS // 2).astype(np.float32) if name == "f1" else Y
    m = {"custom": lambda: mmetric.CustomMetric(
        lambda lab, pred: float((pred.argmax(1) == lab).mean()),
        name="np_top1"),
         "f1": lambda: mmetric.F1(),
         "pearson": lambda: mmetric.PearsonCorrelation()}[name]
    if name == "pearson":
        sym = lambda pkg: pkg.sym.LinearRegressionOutput(   # noqa: E731
            pkg.sym.FullyConnected(pkg.sym.Variable("data"), num_hidden=1,
                                   name="fc"), name="softmax")
        Y = Y.reshape(-1, 1)
    else:
        sym = _mlp
    nv, w2, d = _fit(sym, X, Y, window=2, metric=m(), epochs=1)
    assert d["loop_host_sync"] == NSAMP // BATCH
    assert d["loop_metric_sync"] == 0
    nv0, w0, _ = _fit(sym, X, Y, window=0, metric=m(), epochs=1)
    assert nv == nv0
    _equal(w0, w2)


def test_device_metrics_knob_falls_back_with_the_same_result():
    X, Y = _data()
    m0, w0, _ = _fit(_mlp, X, Y, window=0)
    m2, w2, d = _fit(_mlp, X, Y, window=2, dev_metrics=False)
    assert d["loop_host_sync"] == (NSAMP // BATCH) * EPOCHS
    assert m0 == m2
    _equal(w0, w2)


def test_user_prefetching_iter_not_double_wrapped():
    X, Y = _data()
    m_ref, w_ref, _ = _fit(_mlp, X, Y, window=2)
    it = mt.io.PrefetchingIter(mt.io.NDArrayIter(X, Y, batch_size=BATCH))
    try:
        m, w, d = _fit(_mlp, X, Y, window=2, it=it)
        assert it._device_placer is None
        assert d["loop_prefetch_placed"] == 0
        assert m == m_ref
        _equal(w_ref, w)
    finally:
        assert it.close(join_timeout=5.0)


def test_fit_closes_its_prefetcher():
    X, Y = _data()
    before = threading.active_count()
    _fit(_mlp, X, Y, window=2, epochs=1)
    deadline = time.monotonic() + 5.0
    while threading.active_count() > before:
        assert time.monotonic() < deadline, "fit leaked prefetch threads"
        time.sleep(0.01)


def test_each_step_reads_its_own_batch():
    """With the prefetch stage a batch ahead, the bound input at each
    step's end is that step's batch, never a stale or a later one."""
    X, Y = _data()
    seen = []
    mods = []

    def cb(param):
        mod = param.locals["self"]
        mods.append(mod)
        seen.append(mod._exec.arg_dict["data"].data.numpy().copy())

    _fit(_mlp, X, Y, window=2, prefetch=2, epochs=1, callback=cb)
    assert len(seen) == NSAMP // BATCH
    for k, x in enumerate(seen):
        np.testing.assert_array_equal(x, X[k * BATCH:(k + 1) * BATCH])


def test_inflight_window_holds_at_most_depth_tokens():
    class Token:
        waited = []

        def __init__(self, i):
            self.i = i

        def synchronize(self):
            Token.waited.append(self.i)

    w = _fused.InflightWindow(2)
    for i in range(5):
        w.push(Token(i))
        assert len(w._fifo) <= 2
    assert Token.waited == [0, 1, 2]
    w.push(None)                        # a CPU step: nothing to hold
    w.drain()
    assert Token.waited[-1] == 4 and not w._fifo
    zero = _fused.InflightWindow(0)
    zero.push(Token(9))
    assert not zero._fifo
    mod = mt.mod.Module(_mlp(mt), context=mt.cpu())
    assert mod._step_token() is None and not mod._async_capable()


@pytest.mark.parametrize("mode", ["warn", "abort"])
def test_nancheck_counts_a_non_finite_output(mode):
    X, Y = _data()
    X[9, 3] = np.nan
    cfg.set("MXNET_TPU_NANCHECK", mode)
    try:
        if mode == "abort":
            with pytest.raises(MXNetError, match="non-finite values in "
                                                 "output 'softmax_output'"):
                _fit(_mlp, X, Y, window=2, epochs=1)
        else:
            _, _, d = _fit(_mlp, X, Y, window=2, epochs=2)
            assert d["loop_nonfinite"] == 2
    finally:
        cfg.reset("MXNET_TPU_NANCHECK")
    _, _, d = _fit(_mlp, X, Y, window=2, epochs=1)
    assert d["loop_nonfinite"] == 0                  # off by default


# ------------------------------------------------------- device metrics

_DEV_CASES = {
    "acc": (lambda m: m.Accuracy(),
            lambda r: (r.randint(0, 4, (16,)), r.uniform(0, 1, (16, 4)))),
    "topk": (lambda m: m.TopKAccuracy(top_k=3),
             lambda r: (r.randint(0, 6, (16,)), r.uniform(0, 1, (16, 6)))),
    "mse": (lambda m: m.MSE(),
            lambda r: (r.uniform(-1, 1, (16, 4)), r.uniform(-1, 1, (16, 4)))),
    "mae": (lambda m: m.MAE(),
            lambda r: (r.uniform(-1, 1, (16, 4)), r.uniform(-1, 1, (16, 4)))),
    "rmse": (lambda m: m.RMSE(),
             lambda r: (r.uniform(-1, 1, (16, 4)),
                        r.uniform(-1, 1, (16, 4)))),
    "ce": (lambda m: m.CrossEntropy(),
           lambda r: (r.randint(0, 4, (16,)), r.dirichlet(np.ones(4), 16))),
    "ppl": (lambda m: m.Perplexity(ignore_label=0),
            lambda r: (r.randint(0, 4, (16,)), r.dirichlet(np.ones(4), 16))),
    "loss": (lambda m: m.Loss(),
             lambda r: (r.uniform(0, 1, (16,)), r.uniform(0, 2, (16,)))),
}


@pytest.mark.parametrize("name", sorted(_DEV_CASES))
def test_update_device_matches_host_and_reference(name):
    make, gen = _DEV_CASES[name]
    rng = np.random.RandomState(7)
    batches = [tuple(a.astype(np.float32) for a in gen(rng))
               for _ in range(4)]
    dev, host, ref = make(mmetric), make(mmetric), make(mx.metric)
    assert dev.device_capable()
    for label, pred in batches:
        assert dev.update_device([mt.nd.array(label, ctx=mt.cpu())],
                                 [mt.nd.array(pred, ctx=mt.cpu())])
        host.update([mt.nd.array(label, ctx=mt.cpu())],
                    [mt.nd.array(pred, ctx=mt.cpu())])
        ref.update([mx.nd.array(label)], [mx.nd.array(pred)])
    assert dev.get() == host.get()
    assert dev.get()[0] == ref.get()[0]
    np.testing.assert_allclose(dev.get()[1], ref.get()[1], rtol=2e-6,
                               atol=2e-7)
    cfg.set("MXNET_TPU_DEVICE_METRICS", False)
    try:
        assert not make(mmetric).device_capable()
    finally:
        cfg.reset("MXNET_TPU_DEVICE_METRICS")


def test_composite_device_capability():
    both = mmetric.CompositeEvalMetric([mmetric.Accuracy(),
                                        mmetric.TopKAccuracy(top_k=2)])
    assert both.device_capable()
    mixed = mmetric.CompositeEvalMetric([mmetric.Accuracy(), mmetric.F1()])
    assert not mixed.device_capable()
    zeros = [mt.nd.zeros((4,), ctx=mt.cpu())]
    assert not mixed.update_device(zeros,
                                   [mt.nd.zeros((4, 2), ctx=mt.cpu())])
    assert mixed.metrics[0].num_inst == 0
    for m in (mmetric.CustomMetric(lambda a, b: 0.0), mmetric.F1(),
              mmetric.PearsonCorrelation()):
        assert not m.device_capable()
    acc = mmetric.Accuracy()
    assert acc.update_device([mt.nd.array([1.0, 0.0], ctx=mt.cpu())],
                             [mt.nd.array([[0.1, 0.9], [0.2, 0.8]],
                                          ctx=mt.cpu())])
    acc.reset()
    assert acc.num_inst == 0 and np.isnan(acc.get()[1])


# --------------------------------------------- against the reference fit

def test_async_fit_matches_reference_fit():
    X, Y = _data()
    init = _init(_mlp(mt), X.shape[1:])
    nv, w, _ = _fit(_mlp, X, Y, window=2)
    mx.config.set("MXNET_TPU_ASYNC_WINDOW", 2)
    try:
        mod = mx.mod.Module(_mlp(mx), context=mx.cpu())
        m = mx.metric.Accuracy()
        mod.fit(mx.io.NDArrayIter(X, Y, batch_size=BATCH), eval_metric=m,
                num_epoch=EPOCHS, optimizer="sgd",
                optimizer_params={"learning_rate": 0.1},
                arg_params={k: mx.nd.array(v) for k, v in init.items()})
    finally:
        mx.config.reset("MXNET_TPU_ASYNC_WINDOW")
    arg, aux = mod.get_params()
    want = {k: v.asnumpy() for k, v in list(arg.items()) + list(aux.items())}
    assert set(want) == set(w)
    for k in want:
        np.testing.assert_allclose(w[k], want[k], rtol=0, atol=1e-5,
                                   err_msg=k)
    assert dict(nv)["accuracy"] == pytest.approx(
        dict(m.get_name_value())["accuracy"], abs=1e-6)


# ----------------------------------------------------- resume by cursor

NREC = 48


@pytest.fixture()
def dataset(tmp_path):
    rec, idx = str(tmp_path / "t.rec"), str(tmp_path / "t.idx")
    rng = np.random.RandomState(0)
    w = recordio.MXIndexedRecordIO(idx, rec, "w")
    for i in range(NREC):
        payload = rng.uniform(-1, 1, FEAT).astype(np.float32)
        w.write_idx(i, recordio.pack(recordio.IRHeader(0, float(i % NCLS),
                                                       i, 0),
                                     payload.tobytes()))
    w.close()
    return rec, idx


class _Stop(Exception):
    pass


def _loader_fit(dataset, epochs, workers, ckpt=None, resume=None,
                stop_after=None):
    rec, idx = dataset
    mt.random.seed(7)
    it = mt.data.DataLoader(rec, idx_path=idx, batch_size=BATCH,
                            transform=mt.data.RawTransform((FEAT,)),
                            shuffle=True, seed=11, num_workers=workers,
                            part=(0, 1), label_name="softmax_label")
    mod = mt.mod.Module(_mlp(mt), context=mt.cpu())
    kw = {}
    if resume is None:
        kw["arg_params"] = {k: mt.nd.array(v, ctx=mt.cpu()) for k, v in
                            _init(_mlp(mt), (FEAT,)).items()}
    calls = [0]

    def cb(_param):
        calls[0] += 1
        if stop_after is not None and calls[0] >= stop_after:
            raise _Stop()

    try:
        mod.fit(it, num_epoch=epochs, optimizer="sgd",
                optimizer_params={"learning_rate": 0.1, "momentum": 0.9},
                checkpoint=ckpt, resume_from=resume, batch_end_callback=cb,
                **kw)
    except _Stop:
        pass
    finally:
        it.close()
    arg, aux = mod.get_params()
    return {k: v.asnumpy() for k, v in list(arg.items()) + list(aux.items())}


def test_mid_epoch_resume_by_cursor_is_bit_identical(dataset, tmp_path):
    ref = _loader_fit(dataset, epochs=2, workers=2)
    base = str(tmp_path / "ckpt")
    ck = CheckpointConfig(base, every_n_batches=4, period_epochs=1)
    # 6 batches an epoch: the save at batch 4 of epoch 1, then the stop
    _loader_fit(dataset, epochs=2, workers=2, ckpt=ck, stop_after=11)
    saved = restore_latest(base)
    assert saved.mid_epoch and saved.batches_done == 4
    cur = saved.data_cursor
    assert cur["epoch"] == 1 and cur["batches_done"] == 4
    assert cur["num_workers"] == 2 and cur["seed"] == 11
    assert cur["num_records"] == NREC and cur["batch_size"] == BATCH
    _equal(ref, _loader_fit(dataset, epochs=2, workers=4, resume=base))
    _equal(ref, _loader_fit(dataset, epochs=2, workers=0, resume=base))


def test_epoch_boundary_resume_by_cursor_is_bit_identical(dataset,
                                                          tmp_path):
    ref = _loader_fit(dataset, epochs=2, workers=2)
    base = str(tmp_path / "ckpt")
    _loader_fit(dataset, epochs=1, workers=2,
                ckpt=CheckpointConfig(base, period_epochs=1))
    saved = restore_latest(base)
    assert not saved.mid_epoch
    assert saved.data_cursor["epoch"] == 1
    assert saved.data_cursor["batches_done"] == 0
    _equal(ref, _loader_fit(dataset, epochs=2, workers=1, resume=base))


def test_resume_with_another_stream_names_the_field(dataset, tmp_path):
    base = str(tmp_path / "ckpt")
    _loader_fit(dataset, epochs=1, workers=0,
                ckpt=CheckpointConfig(base, every_n_batches=2),
                stop_after=3)
    rec, idx = dataset
    it = mt.data.DataLoader(rec, idx_path=idx, batch_size=BATCH,
                            transform=mt.data.RawTransform((FEAT,)),
                            seed=12, num_workers=0, part=(0, 1),
                            label_name="softmax_label")
    mod = mt.mod.Module(_mlp(mt), context=mt.cpu())
    try:
        with pytest.raises(MXNetError, match="mismatch on seed"):
            mod.fit(it, num_epoch=1, resume_from=base)
    finally:
        it.close()
