"""The port's Module trains the zoo transformer LM as the reference's
does.

A reference ``Module`` (JAX, on the CPU, flash attention through the
Pallas kernels in interpret mode) and the port's ``Module(context=
cpu())`` are bound on the same small transformer (vocab 64, 2 layers,
d_model 32, 2 heads, T 64, batch 4, ``attention="flash"``); the port's
parameters are set from the reference's ``get_params()``, and both take
the same numpy-drawn batches.

Tolerances: float32 outputs and parameters at atol 1e-5 (the same f32
formulas, summed in another order; after five SGD steps the measured
gap is ~1e-7). Under amp bf16, the cross-entropy after three steps
within 5e-3 nats (measured: 1e-4 to 4e-4): both sides round matmul
operands and results to bf16 (~3 significant digits) at slightly
different points (the reference's Pallas kernel rounds P and dS to
bf16, the port's plain backward keeps them in f32).
"""
import logging

import numpy as np
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu.models import transformer as jax_transformer
import mxnet_tpu_torch as mt
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.models import transformer as port_transformer

ATOL = 1e-5
AMP_CE_TOL = 5e-3
V, L, D, H, T, N = 64, 2, 32, 2, 64, 4
KW = dict(vocab_size=V, num_layers=L, d_model=D, n_heads=H, seq_len=T,
          attention="flash")
SHAPES = dict(data_shapes=[("data", (N, T))],
              label_shapes=[("softmax_label", (N, T))])


def _pair(optimizer_params):
    jm = mx.mod.Module(jax_transformer.get_symbol(**KW), context=mx.cpu())
    jm.bind(**SHAPES)
    jm.init_params(mx.init.Xavier())
    jm.init_optimizer(optimizer="sgd", optimizer_params=optimizer_params)
    pm = mt.mod.Module(port_transformer.get_symbol(**KW), context=mt.cpu())
    pm.bind(**SHAPES)
    args, _ = jm.get_params()
    pm.set_params({k: v.asnumpy() for k, v in args.items()})
    pm.init_optimizer(optimizer="sgd", optimizer_params=optimizer_params)
    return jm, pm


def _batches(seed, n):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, V, (N, T)).astype(np.float32),
             rng.integers(0, V, (N, T)).astype(np.float32))
            for _ in range(n)]


def _step_both(jm, pm, x, y):
    jm._fit_step(mx.io.DataBatch([mx.nd.array(x)], [mx.nd.array(y)]))
    pm._fit_step(mt.io.DataBatch([mt.nd.array(x, ctx=mt.cpu())],
                                 [mt.nd.array(y, ctx=mt.cpu())]))
    return jm.get_outputs()[0].asnumpy(), pm.get_outputs()[0].asnumpy()


def _assert_same_params(jm, pm, atol=ATOL):
    ja, _ = jm.get_params()
    pa, _ = pm.get_params()
    assert sorted(ja) == sorted(pa)
    for name in ja:
        np.testing.assert_allclose(pa[name].asnumpy(), ja[name].asnumpy(),
                                   atol=atol, err_msg=name)


@pytest.mark.parametrize("momentum", [0.0, 0.9])
def test_five_fit_steps_match_reference(momentum):
    jm, pm = _pair({"learning_rate": 0.1, "momentum": momentum,
                    "wd": 1e-4})
    for x, y in _batches(0, 5):
        want, got = _step_both(jm, pm, x, y)
        np.testing.assert_allclose(got, want, atol=ATOL)
    _assert_same_params(jm, pm)


def test_fit_over_ndarray_iter_ends_at_reference_params():
    rng = np.random.default_rng(1)
    x = rng.integers(0, V, (3 * N, T)).astype(np.float32)
    y = rng.integers(0, V, (3 * N, T)).astype(np.float32)
    opt = {"learning_rate": 0.1, "momentum": 0.9}
    init = mx.mod.Module(jax_transformer.get_symbol(**KW), context=mx.cpu())
    init.bind(**SHAPES)
    init.init_params(mx.init.Xavier())
    args = {k: v.asnumpy() for k, v in init.get_params()[0].items()}

    jm = mx.mod.Module(jax_transformer.get_symbol(**KW), context=mx.cpu())
    jm.fit(mx.io.NDArrayIter(x, y, batch_size=N), num_epoch=1,
           eval_metric="ce", optimizer="sgd", optimizer_params=opt,
           arg_params={k: mx.nd.array(v) for k, v in args.items()})
    pm = mt.mod.Module(port_transformer.get_symbol(**KW), context=mt.cpu())
    seen = []
    pm.fit(mt.io.NDArrayIter(x, y, batch_size=N), num_epoch=1,
           eval_metric="ce", optimizer="sgd", optimizer_params=opt,
           arg_params=args,
           batch_end_callback=lambda p: seen.append(p.nbatch))
    assert seen == [0, 1, 2]
    _assert_same_params(jm, pm)


def test_unfused_forward_backward_update_matches_fit_step():
    """``forward`` + ``backward`` + ``update`` is the same step as
    ``_fit_step``."""
    opt = {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-4}
    _, fused = _pair(opt)
    _, eager = _pair(opt)
    eager.set_params({k: v.asnumpy()
                      for k, v in fused.get_params()[0].items()})
    for x, y in _batches(2, 2):
        batch = mt.io.DataBatch([mt.nd.array(x, ctx=mt.cpu())],
                                [mt.nd.array(y, ctx=mt.cpu())])
        fused._fit_step(batch)
        eager.forward(batch, is_train=True)
        eager.backward()
        eager.update()
    for name, arr in fused.get_params()[0].items():
        np.testing.assert_allclose(eager.get_params()[0][name].asnumpy(),
                                   arr.asnumpy(), atol=1e-6, err_msg=name)


def _ce(probs, y):
    p = probs[np.arange(probs.shape[0]), y.reshape(-1).astype(np.int64)]
    return float(-np.log(p + 1e-12).mean())


def test_amp_bf16_loss_after_three_steps_matches_reference():
    try:
        mx.amp.init("bfloat16")
        mt.amp.init("bfloat16")
        jm, pm = _pair({"learning_rate": 0.1})
        for x, y in _batches(3, 3):
            want, got = _step_both(jm, pm, x, y)
    finally:
        mx.amp.off()
        mt.amp.off()
    assert got.dtype == np.float32
    assert abs(_ce(got, y) - _ce(want, y)) < AMP_CE_TOL
    for arr in pm.get_params()[0].values():
        assert arr.dtype == np.float32       # f32 master weights


def test_no_context_without_gpu_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    sym = port_transformer.get_symbol(**KW)
    with pytest.raises(MXNetError, match="no CUDA device"):
        mt.mod.Module(sym)
    with pytest.raises(MXNetError, match="no CUDA device"):
        mt.mod.Module(sym, context=mt.gpu(0))


@pytest.mark.parametrize("option,value", [
    ("grad_accum", 2), ("layout", object()), ("tune", "auto"),
    ("monitor", object())])
def test_fit_options_of_later_slices_raise(option, value):
    pm = mt.mod.Module(port_transformer.get_symbol(**KW), context=mt.cpu())
    x = np.zeros((N, T), np.float32)
    with pytest.raises(MXNetError, match="not ported yet.*ROADMAP"):
        pm.fit(mt.io.NDArrayIter(x, x, batch_size=N), num_epoch=1,
               **{option: value})
    assert not pm.binded


def test_distributed_kvstore_raises():
    pm = mt.mod.Module(port_transformer.get_symbol(**KW), context=mt.cpu())
    pm.bind(**SHAPES)
    pm.init_params(mt.init.Xavier())
    with pytest.raises(MXNetError, match="kvstore"):
        pm.init_optimizer(kvstore="dist_sync")
    pm.init_optimizer(kvstore=None)
    assert pm._optimizer.rescale_grad == 1.0 / N


def test_fit_logs_metrics_and_calls_epoch_end(caplog):
    rng = np.random.default_rng(4)
    x = rng.integers(0, V, (N, T)).astype(np.float32)
    pm = mt.mod.Module(port_transformer.get_symbol(**KW), context=mt.cpu(),
                       logger=logging.getLogger("fit-test"))
    epochs = []
    with caplog.at_level(logging.INFO, logger="fit-test"):
        pm.fit(mt.io.NDArrayIter(x, (x + 1) % V, batch_size=N),
               eval_data=mt.io.NDArrayIter(x, (x + 1) % V, batch_size=N),
               num_epoch=2, eval_metric="ce",
               epoch_end_callback=lambda e, sym, a, b: epochs.append(
                   (e, sorted(a) == sorted(pm.get_params()[0]))))
    messages = [r.getMessage() for r in caplog.records]
    assert sum("Train-cross-entropy" in m for m in messages) == 2
    assert sum("Validation-cross-entropy" in m for m in messages) == 2
    assert epochs == [(0, True), (1, True)]


@pytest.mark.parametrize("momentum", [0.0, 0.9])
def test_sgd_per_parameter_and_fused_updates_match_reference(momentum):
    """The eager per-parameter update, the fused foreach update and the
    reference SGD agree (lr, wd with the bias's wd_mult 0, rescale_grad,
    clip_gradient, momentum), over two steps."""
    rng = np.random.default_rng(5)
    names = {0: "fc_weight", 1: "fc_bias"}
    ws = [rng.standard_normal(s).astype(np.float32) for s in ((4, 3), (4,))]
    gs = [[rng.standard_normal(w.shape).astype(np.float32) for w in ws]
          for _ in range(2)]
    kw = dict(learning_rate=0.1, momentum=momentum, wd=1e-2,
              rescale_grad=0.5, clip_gradient=0.3, param_idx2name=names)
    jopt = mx.optimizer.SGD(**kw)
    popt_eager, popt_fused = mt.optimizer.SGD(**kw), mt.optimizer.SGD(**kw)
    for o in (jopt, popt_eager, popt_fused):
        o.set_wd_mult({})
    jup = mx.optimizer.get_updater(jopt)
    eager = mt.optimizer.get_updater(popt_eager)
    fused = mt.optimizer.get_updater(popt_fused)
    jw = [mx.nd.array(w) for w in ws]
    ew = [mt.nd.array(w, ctx=mt.cpu()) for w in ws]
    fw = [mt.nd.array(w, ctx=mt.cpu()) for w in ws]
    for step in gs:
        for i, g in enumerate(step):
            jup(i, mx.nd.array(g), jw[i])
            eager(i, mt.nd.array(g, ctx=mt.cpu()), ew[i])
        fused.update_multi([0, 1], fw, [torch.from_numpy(g) for g in step])
    for j, e, f in zip(jw, ew, fw):
        np.testing.assert_allclose(e.asnumpy(), j.asnumpy(), atol=1e-6)
        np.testing.assert_allclose(f.asnumpy(), j.asnumpy(), atol=1e-6)
