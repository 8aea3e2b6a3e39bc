"""The port's ``BucketingModule``, ``Module.bind(shared_module=,
inputs_need_grad=)``, ``Perplexity`` and callbacks against the
reference's.

* The bucketing LM of ``examples/lstm_bucketing.py`` (embedding, a
  2-layer ``LSTMCell`` stack unrolled per bucket, ``SoftmaxOutput``
  with ``ignore_label`` 0 and ``normalization="valid"``) at a small
  width, from the same parameters in both packages: ``_fit_step``s
  alternating two buckets (SGD with momentum and weight decay), then a
  ``fit`` epoch over a seeded ``BucketSentenceIter``; the parameters,
  the outputs and the perplexity within 1e-5 of the reference's. Every
  bucket's module holds the default bucket's parameter, gradient and
  aux arrays themselves (identity), and one optimizer state.
* ``Module.bind(shared_module=)`` shares by identity and refuses what it
  cannot share; ``inputs_need_grad`` gives the reference's data
  gradients.
* ``Perplexity`` (with and without ``ignore_label``) equals the
  reference's.
* ``Speedometer``, ``log_train_metric`` and ``do_checkpoint`` run
  under ``fit``; the checkpoint loads in both packages.
"""
import contextlib
import logging

import numpy as np
import pytest

import mxnet_tpu as mx
import mxnet_tpu_torch as mt
from mxnet_tpu_torch.base import MXNetError
import torch

# test files run side by side in parallel workers: each keeps torch's
# intra-op pool small
torch.set_num_threads(2)

TOL = 1e-5
VOCAB, EMBED, HIDDEN, BATCH = 30, 6, 8, 4
PKGS = [mx, mt]


def _scope(pkg):
    return mt.device_scope("cpu") if pkg is mt else contextlib.nullcontext()


def _close(got, want, what="", tol=TOL):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(1.0, float(np.abs(want).max(initial=0.0)))
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale,
                               err_msg=what)


def _sym_gen(pkg):
    stack = pkg.rnn.SequentialRNNCell()
    for i in range(2):
        stack.add(pkg.rnn.LSTMCell(num_hidden=HIDDEN, prefix="lstm_l%d_" % i))

    def sym_gen(seq_len):
        data = pkg.sym.Variable("data")
        label = pkg.sym.Variable("softmax_label")
        embed = pkg.sym.Embedding(data, input_dim=VOCAB, output_dim=EMBED,
                                  name="embed")
        stack.reset()
        outputs, _ = stack.unroll(seq_len, inputs=embed, merge_outputs=True)
        pred = pkg.sym.Reshape(outputs, shape=(-1, HIDDEN))
        pred = pkg.sym.FullyConnected(pred, num_hidden=VOCAB, name="pred")
        lab = pkg.sym.Reshape(label, shape=(-1,))
        pred = pkg.sym.SoftmaxOutput(pred, lab, use_ignore=True,
                                     ignore_label=0, normalization="valid",
                                     name="softmax")
        return pred, ("data",), ("softmax_label",)

    return sym_gen


def _module(pkg, default_key):
    return pkg.mod.BucketingModule(_sym_gen(pkg),
                                   default_bucket_key=default_key,
                                   context=pkg.cpu())


def _values(default_key, seed=0):
    """Seeded parameters of the bucketing LM, from the reference's graph."""
    sym, _, _ = _sym_gen(mx)(default_key)
    args, _, _ = sym.infer_shape(data=(BATCH, default_key),
                                 softmax_label=(BATCH, default_key))
    rng = np.random.RandomState(seed)
    return {n: rng.uniform(-0.3, 0.3, s).astype(np.float32)
            for n, s in zip(sym.list_arguments(), args)
            if n not in ("data", "softmax_label")
            and "begin_state" not in n}


def _batch(pkg, key, seed):
    rng = np.random.RandomState(seed)
    data = rng.randint(0, VOCAB, (BATCH, key)).astype(np.float32)
    data[:, -2:] = 0                       # padding: ignored labels
    label = np.zeros_like(data)
    label[:, :-1] = data[:, 1:]
    desc = pkg.io.DataDesc
    return pkg.io.DataBatch(
        [pkg.nd.array(data, ctx=pkg.cpu())],
        [pkg.nd.array(label, ctx=pkg.cpu())], pad=0, bucket_key=key,
        provide_data=[desc("data", (BATCH, key))],
        provide_label=[desc("softmax_label", (BATCH, key))])


OPT = {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-5}


def _trained(pkg, keys, values):
    mod = _module(pkg, 7)
    mod.bind(data_shapes=[("data", (BATCH, 7))],
             label_shapes=[("softmax_label", (BATCH, 7))])
    mod.init_params(pkg.init.Zero())
    mod.set_params(values, {}, allow_missing=True)
    mod.init_optimizer(optimizer="sgd", optimizer_params=OPT)
    outs = []
    for i, key in enumerate(keys):
        mod._fit_step(_batch(pkg, key, i))
        outs.append(mod.get_outputs()[0].asnumpy())
    return mod, outs


def test_fit_steps_alternating_buckets_match_reference():
    keys = [7, 4, 7, 4]
    values = _values(7)
    want_mod, want_outs = _trained(mx, keys, values)
    got_mod, got_outs = _trained(mt, keys, values)
    for i, (a, b) in enumerate(zip(got_outs, want_outs)):
        _close(a, b, "step %d output" % i)
    want, _ = want_mod.get_params()
    got, _ = got_mod.get_params()
    assert sorted(got) == sorted(want)
    assert set(values) < set(got)       # and the begin states
    for k in want:
        _close(got[k].asnumpy(), want[k].asnumpy(), "param " + k)
    assert sorted(got_mod._buckets) == [4, 7]


def test_buckets_share_arrays_and_optimizer_by_identity():
    mod, _ = _trained(mt, [7, 4, 5], _values(7))
    default = mod._buckets[7]
    for key, m in mod._buckets.items():
        ex = m._exec
        for n in default._param_names:
            assert ex.arg_dict[n] is default._exec.arg_dict[n], (key, n)
            assert ex.grad_dict[n] is default._exec.grad_dict[n], (key, n)
            assert m._arg_params[n] is default._arg_params[n]
        assert m._updater is default._updater
        assert m._param_index is default._param_index
    # an update through one bucket is what every other reads
    w = default._exec.arg_dict["pred_weight"].asnumpy().copy()
    mod._fit_step(_batch(mt, 4, 9))
    after = mod._buckets[5]._exec.arg_dict["pred_weight"].asnumpy()
    assert not np.array_equal(after, w)
    np.testing.assert_array_equal(
        after, mod._buckets[7]._exec.arg_dict["pred_weight"].asnumpy())


def _sentences(seed, n=48):
    rng = np.random.RandomState(seed)
    return [list(rng.randint(1, VOCAB, size=rng.choice([3, 5, 7])))
            for _ in range(n)]


def _fit(pkg, values, tmp_path=None):
    it = pkg.rnn.BucketSentenceIter(_sentences(1), BATCH, buckets=[4, 6, 8],
                                    invalid_label=0, seed=2)
    mod = _module(pkg, it.default_bucket_key)
    metric = pkg.metric.Perplexity(ignore_label=0)
    seen = []
    batch_cbs = [pkg.callback.Speedometer(BATCH, 2),
                 pkg.callback.log_train_metric(3),
                 lambda p: seen.append((p.epoch, p.nbatch))]
    epoch_cbs = [pkg.callback.do_checkpoint(str(tmp_path / "lm"))] \
        if tmp_path is not None else None
    mod.fit(it, eval_metric=metric, optimizer="sgd", optimizer_params=OPT,
            arg_params=values, allow_missing=True,
            initializer=pkg.init.Zero(), num_epoch=1,
            batch_end_callback=batch_cbs, epoch_end_callback=epoch_cbs)
    score = mod.score(it, pkg.metric.Perplexity(ignore_label=0))
    return mod, score, seen


def test_fit_epoch_matches_reference(tmp_path, caplog):
    values = _values(8, seed=3)
    want_mod, want_score, want_seen = _fit(mx, values)
    caplog.set_level(logging.INFO)
    got_mod, got_score, got_seen = _fit(mt, values, tmp_path)
    assert got_seen == want_seen and len(got_seen) >= 10
    assert sorted(got_mod._buckets) == [4, 6, 8]
    _close(got_score[0][1], want_score[0][1], "perplexity after the epoch")
    want, _ = want_mod.get_params()
    got, _ = got_mod.get_params()
    for k in want:
        _close(got[k].asnumpy(), want[k].asnumpy(), "param " + k)
    assert any("Speed" in r.getMessage() for r in caplog.records)
    # the epoch checkpoint loads in both packages
    for pkg in PKGS:
        with _scope(pkg):
            sym, args, aux = pkg.model.load_checkpoint(
                str(tmp_path / "lm"), 1)
        assert aux == {}
        for k in want:
            _close(args[k].asnumpy(), got[k].asnumpy(), "checkpoint " + k,
                   tol=0)
        assert "softmax_label" in sym.list_arguments()


def test_bucketing_save_checkpoint(tmp_path):
    mod, _ = _trained(mt, [7, 4], _values(7))
    mod.save_checkpoint(str(tmp_path / "b"), 3)
    sym, args, _ = mx.model.load_checkpoint(str(tmp_path / "b"), 3)
    got, _ = mod.get_params()
    for k in got:
        np.testing.assert_array_equal(args[k].asnumpy(), got[k].asnumpy())
    assert sym.list_arguments() == mod._buckets[7].symbol.list_arguments()


# ------------------------------------------------------------ Module.bind

def _mlp(pkg):
    data = pkg.sym.Variable("data")
    fc = pkg.sym.FullyConnected(data, num_hidden=5, name="fc1")
    fc = pkg.sym.Activation(fc, act_type="tanh", name="act")
    fc = pkg.sym.FullyConnected(fc, num_hidden=3, name="fc2")
    return pkg.sym.SoftmaxOutput(fc, pkg.sym.Variable("softmax_label"),
                                 name="softmax")


def test_shared_module_shares_by_identity_and_refuses():
    owner = mt.mod.Module(_mlp(mt), context=mt.cpu())
    owner.bind(data_shapes=[("data", (4, 6))],
               label_shapes=[("softmax_label", (4,))])
    owner.init_params(mt.init.Xavier())
    other = mt.mod.Module(_mlp(mt), context=mt.cpu())
    other.bind(data_shapes=[("data", (2, 6))],
               label_shapes=[("softmax_label", (2,))], shared_module=owner)
    assert other.params_initialized
    for n in ("fc1_weight", "fc1_bias", "fc2_weight", "fc2_bias"):
        assert other._exec.arg_dict[n] is owner._exec.arg_dict[n]
        assert other._exec.grad_dict[n] is owner._exec.grad_dict[n]
    assert other._exec.arg_dict["data"] is not owner._exec.arg_dict["data"]
    # another width cannot share fc1_weight
    wide = mt.mod.Module(_mlp(mt), context=mt.cpu())
    with pytest.raises(MXNetError, match="fc1_weight"):
        wide.bind(data_shapes=[("data", (4, 7))],
                  label_shapes=[("softmax_label", (4,))],
                  shared_module=owner)
    unbound = mt.mod.Module(_mlp(mt), context=mt.cpu())
    with pytest.raises(MXNetError, match="bound"):
        other.bind(data_shapes=[("data", (4, 6))], force_rebind=True,
                   shared_module=unbound)


def test_inputs_need_grad_matches_reference():
    rng = np.random.RandomState(4)
    x = rng.randn(4, 6).astype(np.float32)
    y = np.array([0, 2, 1, 2], np.float32)
    grads = {}
    for pkg in PKGS:
        mod = pkg.mod.Module(_mlp(pkg), context=pkg.cpu())
        mod.bind(data_shapes=[("data", (4, 6))],
                 label_shapes=[("softmax_label", (4,))],
                 inputs_need_grad=True)
        if pkg is mx:
            mod.init_params(mx.init.Xavier())
            values = {k: v.asnumpy() for k, v in mod.get_params()[0].items()}
        else:
            mod.set_params(values, {})
        batch = pkg.io.DataBatch([pkg.nd.array(x, ctx=pkg.cpu())],
                                 [pkg.nd.array(y, ctx=pkg.cpu())])
        mod.forward(batch, is_train=True)
        mod.backward()
        grads[pkg] = mod.get_input_grads()[0].asnumpy()
    _close(grads[mt], grads[mx], "data gradient")
    assert np.abs(grads[mt]).max() > 0


# ---------------------------------------------------------------- metric

@pytest.mark.parametrize("ignore", [None, 0, -1])
def test_perplexity_matches_reference(ignore):
    rng = np.random.RandomState(5)
    got = {}
    for pkg in PKGS:
        metric = pkg.metric.Perplexity(ignore_label=ignore)
        for i in range(3):
            r = np.random.RandomState(10 + i)
            logits = r.randn(12, 7)
            probs = (np.exp(logits) / np.exp(logits).sum(1, keepdims=True)) \
                .astype(np.float32)
            probs[0, :] = 0.0                      # the 1e-10 floor
            label = r.randint(-1, 7, (3, 4)).astype(np.float32)
            metric.update([pkg.nd.array(label, ctx=pkg.cpu())],
                          [pkg.nd.array(probs, ctx=pkg.cpu())])
        got[pkg] = metric.get()
    assert got[mt][0] == got[mx][0] == "perplexity"
    _close(got[mt][1], got[mx][1], "perplexity", tol=1e-6)
    del rng


def test_callbacks_checkpoint_and_subsystem(tmp_path):
    data = mt.sym.Variable("data")
    net = mt.sym.SoftmaxOutput(mt.sym.FullyConnected(
        data, num_hidden=3, name="cbfc"), name="softmax")
    mod = mt.mod.Module(net, context=mt.cpu())
    mod.bind(data_shapes=[("data", (2, 4))],
             label_shapes=[("softmax_label", (2,))])
    mod.init_params(mt.init.Xavier())
    cb = mt.callback.subsystem_checkpoint(mod, str(tmp_path), period=2)
    cb(0)
    cb(1)
    cb.manager.close()
    ckpts = mt.checkpoint.list_checkpoints(str(tmp_path))
    assert len(ckpts) == 1
    ckpt = mt.checkpoint.restore_latest(str(tmp_path))
    assert ckpt.epoch == 1 and sorted(ckpt.arg_params()) == \
        ["cbfc_bias", "cbfc_weight"]
    bar = mt.callback.ProgressBar(total=4)
    bar(mt.callback.BatchEndParam(0, 2, None))
