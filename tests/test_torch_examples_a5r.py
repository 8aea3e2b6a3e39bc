"""The recurrent and symbolic examples of ``chip_smoke.py`` phase 14
against the reference's examples, and phase 14 rehearsed on the CPU.

For each of ``examples/fine_tune.py``, ``model_parallel_lstm.py``,
``bi_lstm_sort.py``, ``multi_task.py``, ``lstm_crf.py`` and
``tree_lstm.py`` the reference runs the example's own builder (the two
Gluon nets are local to their examples' ``main``, so ``chip_smoke``'s
builders build them with the reference's API, as ``ctc_net`` does) and
the port ``chip_smoke``'s: the symbols serialize alike, the data
generators agree, and from the reference's initial parameters the
step-1 loss (outputs) and every gradient agree within 1e-5 of max(1,
max|ref|) and three steps of the example's optimizer stay in step.

The rehearsal runs phase 14 on the CPU at small sizes (the "card" being
the CPU, CUDA-only calls stood in for, the examples' gates off: they
hold at the examples' sizes, which ``chip_smoke.py`` runs on the card);
then the checks end the run when the port is broken.
"""
import os
import sys
import time

import numpy as np
import pytest
import torch

import mxnet_tpu as mx
import mxnet_tpu_torch as mt
import chip_smoke as cs
from mxnet_tpu_torch.ops import flash_attention as fa

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "examples"))
import bi_lstm_sort  # noqa: E402
import fine_tune  # noqa: E402
import lstm_crf  # noqa: E402
import model_parallel_lstm  # noqa: E402
import multi_task  # noqa: E402
import tree_lstm  # noqa: E402

# test files run side by side in parallel workers: each keeps torch's
# intra-op pool small
torch.set_num_threads(2)

RTOL = 1e-5


@pytest.fixture(autouse=True)
def _on_cpu():
    with mt.cpu():
        yield


def _close(got, want, what, rtol=RTOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    scale = max(1.0, float(np.abs(want).max(initial=0.0)))
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol * scale,
                               err_msg=what)


def _both(build_ref, build_port):
    """Each package's symbol under a fresh name manager, and their JSON
    held equal."""
    with mx.name.NameManager():
        ref = build_ref()
    with mt.name.NameManager():
        port = build_port()
    assert port.tojson() == ref.tojson()
    return ref, port


def _batch(pkg, data, labels):
    return pkg.io.DataBatch(
        data=[pkg.nd.array(d, ctx=pkg.cpu()) for d in data],
        label=[pkg.nd.array(lb, ctx=pkg.cpu()) for lb in labels])


def _module_pair(syms, data, labels, optimizer, params, fixed=None,
                 fused=False, **names):
    """Both packages' Modules from the reference's seeded Xavier
    parameters: step 1 (outputs and the gradient of every trained
    argument) without an update, then three steps of ``optimizer``
    (``fit``'s fused step, or ``forward_backward`` + ``update``) on the
    same batches, the outputs of each and the parameters after them
    compared."""
    mods = [pkg.mod.Module(s, context=pkg.cpu(), fixed_param_names=fixed,
                           **names) for pkg, s in zip((mx, mt), syms)]
    data_shapes = [(n, d.shape) for n, d in zip(
        names.get("data_names", ("data",)), data)]
    label_shapes = [(n, lb.shape) for n, lb in zip(
        names.get("label_names", ("softmax_label",)), labels)]
    for m in mods:
        m.bind(data_shapes=data_shapes, label_shapes=label_shapes)
    mods[0].init_params(mx.init.Xavier().set_rng(np.random.default_rng(0)))
    mods[1].set_params({k: v.asnumpy()
                        for k, v in mods[0].get_params()[0].items()}, {})
    batches = [_batch(pkg, data, labels) for pkg in (mx, mt)]
    for m, b in zip(mods, batches):
        m.forward_backward(b)
    for i, (g, w) in enumerate(zip(mods[1].get_outputs(),
                                   mods[0].get_outputs())):
        _close(g.asnumpy(), w.asnumpy(), "step 1 output %d" % i)
    trained = [n for n in mods[1]._param_names if n not in (fixed or ())]
    for n in trained:
        _close(mods[1]._exec.grad_dict[n].asnumpy(),
               mods[0]._exec.grad_dict[n].asnumpy(), "gradient of " + n)
    for m in mods:
        m.init_optimizer(optimizer=optimizer, optimizer_params=params)
    for s in range(3):
        for m, b in zip(mods, batches):
            if fused:
                m._fit_step(b)
            else:
                m.forward_backward(b)
                m.update()
        for i, (g, w) in enumerate(zip(mods[1].get_outputs(),
                                       mods[0].get_outputs())):
            _close(g.asnumpy(), w.asnumpy(), "step %d output %d"
                   % (s + 2, i))
    ja, pa = mods[0].get_params()[0], mods[1].get_params()[0]
    assert sorted(ja) == sorted(pa)
    for k in ja:
        _close(pa[k].asnumpy(), ja[k].asnumpy(), k)
    return mods


# ------------------------------------------------------------ fine_tune

def test_fine_tune_matches_the_reference():
    """``fine_tune.py``'s net with a new head over the fixed backbone
    (its ``fixed_param_names``), SGD 0.05 / 0.9 through
    ``forward_backward`` + ``update`` as its ``train`` does."""
    x, y = cs.ft_shapes(np, 8, 3, seed=2)
    rx, ry = fine_tune.synth_shapes(8, 3, seed=2)
    np.testing.assert_array_equal(x, rx)
    np.testing.assert_array_equal(y, ry)
    syms = _both(lambda: fine_tune.with_head(fine_tune.feature_net(), 3,
                                             "fc_new"),
                 lambda: cs.ft_head(mt, cs.ft_features(mt), 3, "fc_new"))
    fixed = ["c1_weight", "c1_bias", "c2_weight", "c2_bias", "feat_weight",
             "feat_bias"]
    mods = _module_pair(syms, [x[:4]], [y[:4]], "sgd",
                        {"learning_rate": 0.05, "momentum": 0.9},
                        fixed=fixed)
    p0 = mods[1].get_params()[0]
    assert mods[1]._exec.grad_dict.get("c1_weight") is None
    assert p0["c1_weight"].shape == (8, 1, 5, 5)


# --------------------------------------------------- model_parallel_lstm

MP = dict(cs.MP_LSTM, hidden=8, batch=4, steps=3)


def test_model_parallel_lstm_matches_the_reference():
    """The stacked LSTM with its embedding, layers and head in four ctx
    groups: the reference over cpu(0) / cpu(1), the port's groups on
    cpu(0); the step-1 gradients and three steps of the example's
    momentum SGD (its nll a step) agree."""
    a = MP
    syms = _both(lambda: model_parallel_lstm.build_symbol(
        mx, a["layers"], a["hidden"], a["seq"], a["vocab"]),
        lambda: cs.mp_lstm_symbol(mt, a["layers"], a["hidden"], a["seq"],
                                  a["vocab"]))
    groups = ["embed", "layer0", "layer1", "head"]
    exs = [cs.mp_lstm_bind(pkg, s, a, pkg.cpu(0), {
        g: pkg.cpu(i % 2 if pkg is mx else 0) for i, g in enumerate(groups)})
        for pkg, s in zip((mx, mt), syms)]
    assert str(exs[0].arg_dict["lstm0_i2h_weight"].context) == "cpu(1)"
    params = cs.mp_lstm_params(mx, np, exs[0], 7)
    x, y = cs.mp_lstm_data(np, a)
    grads = []
    for ex in exs:
        for n, arr in ex.arg_dict.items():
            arr[:] = x if n == "data" else y if n == "label" else params[n]
        ex.forward(is_train=True)
        ex.backward()
        grads.append({n: g.asnumpy() for n, g in ex.grad_dict.items()})
    for n in grads[0]:
        _close(grads[1][n], grads[0][n], "gradient of " + n)
    nlls = [cs.mp_lstm_train(pkg, np, ex, params, a)
            for pkg, ex in zip((mx, mt), exs)]
    _close(nlls[1], nlls[0], "nll per step")
    for n in params:
        _close(exs[1].arg_dict[n].asnumpy(), exs[0].arg_dict[n].asnumpy(), n)


# --------------------------------------------------------- bi_lstm_sort

def test_bi_lstm_sort_matches_the_reference():
    """The bidirectional LSTM sorter through ``fit``'s fused step with
    the example's Adam. At the example's lr 0.05 one weight of 3,072
    parts by 1.3e-5 after three steps: Adam's normalized step turns the
    last-bit difference of a gradient near zero into up to lr (C10), so
    the steps run at lr 1e-3, as the LM's Adam parity test runs at
    1e-4."""
    x, y = cs.sort_data(np, 8)
    rx, ry = bi_lstm_sort.synth(8)
    np.testing.assert_array_equal(x, rx)
    np.testing.assert_array_equal(y, ry)
    syms = _both(bi_lstm_sort.get_symbol, lambda: cs.sort_symbol(mt))
    _module_pair(syms, [x[:4]], [y[:4]], "adam", {"learning_rate": 1e-3},
                 fused=True)


# ----------------------------------------------------------- multi_task

def test_multi_task_matches_the_reference():
    """Two SoftmaxOutput heads over one backbone, two labels, SGD 0.05 /
    0.9 through ``forward_backward`` + ``update``."""
    X, Y1, Y2 = cs.multi_data(np, 8, seed=1)
    for a, b in zip((X, Y1, Y2), multi_task.synth(8, seed=1)):
        np.testing.assert_array_equal(a, b)
    syms = _both(multi_task.build, lambda: cs.multi_symbol(mt))
    _module_pair(syms, [X[:4]], [Y1[:4], Y2[:4]], "sgd",
                 {"learning_rate": 0.05, "momentum": 0.9},
                 label_names=("digit_label", "parity_label"))


# ---------------------------------------------------- the two Gluon nets

def _gluon_pair(build, data, loss_fn, steps=3, lr=0.01):
    """Both packages' Gluon nets from the reference's initial
    parameters (Xavier), then ``steps`` steps of Adam under
    ``autograd.record()``: each step's loss and the step-1 gradients
    agree, and the parameters after them."""
    nets = []
    for pkg in (mx, mt):
        net = build(pkg)
        net.initialize(pkg.init.Xavier(), ctx=pkg.cpu())
        nets.append(net)
    jp, pp = nets[0].collect_params(), nets[1].collect_params()
    assert sorted(jp.keys()) == sorted(pp.keys())
    for pkg, net in zip((mx, mt), nets):       # finish deferred shapes
        loss_fn(pkg, net, data)
    for k in jp.keys():
        pp[k].set_data(mt.nd.array(jp[k].data().asnumpy(), ctx=mt.cpu()))
    trainers = [pkg.gluon.Trainer(net.collect_params(), "adam",
                                  {"learning_rate": lr})
                for pkg, net in zip((mx, mt), nets)]
    for s in range(steps):
        losses = []
        for pkg, net, tr in zip((mx, mt), nets, trainers):
            with pkg.autograd.record():
                loss = loss_fn(pkg, net, data)
            loss.backward()
            if s == 0:
                losses.append({k: p.grad().asnumpy()
                               for k, p in net.collect_params().items()})
            tr.step(1)
            losses.append(float(np.asarray(loss.asnumpy()).ravel()[0]))
        if s == 0:
            for k in jp.keys():
                _close(losses[2][k], losses[0][k], "gradient of " + k)
            losses = losses[1::2]
        _close(losses[1], losses[0], "step %d loss" % (s + 1))
    for k in jp.keys():
        _close(pp[k].data().asnumpy(), jp[k].data().asnumpy(), k)


def test_lstm_crf_matches_the_reference():
    """The BiLSTM-CRF tagger: the reference's loss is the example's own
    ``crf_log_likelihood``, the port's ``chip_smoke.crf_nll``."""
    X, Y = cs.crf_data(np, 6, seed=1)
    RX, RY = lstm_crf.synth_tagging(6, seed=1)
    np.testing.assert_array_equal(X, RX)
    np.testing.assert_array_equal(Y, RY)

    def loss(pkg, net, data):
        x, y = data
        em = net.emissions(pkg.nd.array(x, ctx=pkg.cpu()))
        ems = cs.crf_emission_list(pkg, em)
        if pkg is mx:
            return lstm_crf.crf_log_likelihood(ems, net.transitions.data(),
                                               y)
        return cs.crf_nll(pkg, np, ems, net.transitions.data(), y)

    _gluon_pair(lambda pkg: cs.crf_tagger(pkg, 8, prefix="tagger_"),
                (X, Y), loss)


def test_tree_lstm_matches_the_reference():
    """The child-sum Tree-LSTM over depth-2 trees with the example's
    ``SoftmaxCrossEntropyLoss`` and Adam (lr 0.02)."""
    X, Y = cs.tree_data(np, np.random.RandomState(1), 2, 6)
    RX, RY = tree_lstm.gen_heap_trees(np.random.RandomState(1), 2, 6)
    np.testing.assert_array_equal(X, RX)
    np.testing.assert_array_equal(Y, RY)

    def loss(pkg, net, data):
        x, y = data
        logits = net(pkg.nd.array(x.astype(np.float32), ctx=pkg.cpu()), 7)
        sce = pkg.gluon.loss.SoftmaxCrossEntropyLoss()
        return pkg.nd.mean(sce(logits, pkg.nd.array(
            y.astype(np.float32), ctx=pkg.cpu())))

    _gluon_pair(lambda pkg: cs.tree_net(pkg, 8, prefix="tree_"), (X, Y),
                loss, lr=0.02)


def test_crf_viterbi_equals_the_example():
    rng = np.random.RandomState(3)
    ems = [rng.randn(4, 3) for _ in range(cs.CRF_T)]
    trans = rng.randn(3, 3)
    np.testing.assert_array_equal(cs.crf_viterbi(np, ems, trans),
                                  lstm_crf.viterbi(ems, trans))


# ------------------------------------------------------------ rehearsal

class _Event:
    def __init__(self, enable_timing=False):
        self.t = None

    def record(self):
        self.t = time.perf_counter()

    def elapsed_time(self, end):
        return (end.t - self.t) * 1e3


def _counting(plain):
    def wrapper(*args):
        wrapper.launches["bf16" if args[0].dtype == torch.bfloat16
                         else "f32"] += 1
        return plain(*args)
    wrapper.launches = {"f32": 0, "bf16": 0}
    return wrapper


@pytest.fixture
def small(monkeypatch, tmp_path):
    """Phase 14 on the CPU at a small width: the LM at 2 layers of 32,
    ResNet-18 at 64x64, the examples at a few steps with their gates
    off; counting wrappers around the plain attention versions, and the
    CUDA-only calls stood in for."""
    from test_torch_wgmma_support import _plain_dkv, _plain_dq
    for name, value in (
            ("DEVICE", "cpu"), ("ROOT", tmp_path), ("VOCAB", 64),
            ("LAYERS", 2), ("D_MODEL", 32), ("HEADS", 2), ("D_FF", 64),
            ("MAX_SEQ", 16), ("TRAIN_BATCH", 2), ("RESNET_LAYERS", 18),
            ("RESNET_IMAGE", 64), ("RESNET_BATCH", 2),
            ("RESNET_CLASSES", 10), ("FT_PRE_BATCHES", 1), ("FT_STEPS", 3),
            ("FT_TIMED", 1), ("GROUP_TIMED", 1),
            ("FINE_TUNE", dict(cs.FINE_TUNE, pretrain_epochs=1,
                               tune_epochs=1, n_pre=100, n_tune=50,
                               min_acc=-1.0)),
            ("MP_LSTM", dict(cs.MP_LSTM, steps=3, hidden=8, batch=4,
                             max_ratio=10.0)),
            ("SORT", dict(cs.SORT, epochs=1, examples=120, batch=10,
                          min_acc=-1.0)),
            ("MULTI", dict(cs.MULTI, epochs=1, examples=100, batch=50,
                           min_acc=-1.0)),
            ("CRF", dict(cs.CRF, epochs=1, examples=50, min_acc=-1.0)),
            ("TREE", dict(cs.TREE, epochs=1, trees=100, hidden=8,
                          min_acc=-1.0))):
        monkeypatch.setattr(cs, name, value)
    monkeypatch.setattr(mt, "gpu", lambda i=0: mt.cpu())
    monkeypatch.setattr(torch.cuda, "Event", _Event)
    for fn in ("synchronize", "empty_cache", "reset_peak_memory_stats"):
        monkeypatch.setattr(torch.cuda, fn, lambda *a: None)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated", lambda *a: 0)
    for flag in (torch.backends.cudnn, torch.backends.cuda.matmul):
        monkeypatch.setattr(flag, "allow_tf32", False)
    monkeypatch.setattr(fa, "_dispatch", lambda q, what: True)
    monkeypatch.setattr(fa, "flash_attention_fwd",
                        _counting(fa.flash_attention_reference))
    monkeypatch.setattr(fa, "flash_attention_bwd_dq", _counting(_plain_dq))
    monkeypatch.setattr(fa, "flash_attention_bwd_dkv",
                        _counting(_plain_dkv))
    # the CPU's profile has no device kernels: name the counted ones
    monkeypatch.setattr(cs, "device_kernel_names", lambda prof: {
        "fa_fwd_bf16", "fa_bwd_dq_bf16", "fa_bwd_dkv_bf16"})
    lines = []
    monkeypatch.setattr(cs, "log", lambda *a: lines.append(a[0]))
    return lines


def test_symbol_phase_rehearsal_on_cpu(small):
    cs.symbol_phase(torch, np)
    for head in ("14a fluent methods: 42", "14a resnet:", "14a lm:",
                 "14b fine-tune:", "14c grouped LM: 2 layers",
                 "14d fine_tune:", "14d model_parallel_lstm:",
                 "14d bi_lstm_sort:", "14d multi_task:", "14d lstm_crf:",
                 "14d tree_lstm:"):
        assert any(ln.startswith(head) for ln in small), head
    assert any("launches {'flash_attention_fwd_bf16': {'f32': 0, 'bf16': "
               "6}" in ln for ln in small)


def test_surface_ends_on_a_card_result_off_the_cpu(small, monkeypatch):
    real = cs.eval_symbol
    calls = []

    def off(mt_, s, inputs, ctx):
        calls.append(1)
        outs = real(mt_, s, inputs, ctx)
        return [o + 1e-3 for o in outs] if len(calls) % 2 else outs

    monkeypatch.setattr(cs, "eval_symbol", off)
    with pytest.raises(cs.SmokeFailure, match="14a fluent"):
        cs.surface_phase(torch, np)


def test_grouped_lm_ends_when_the_grouped_bind_differs(small, monkeypatch):
    real = cs.grouped_step
    seen = []

    def off(ex, lr):
        out, grads = real(ex, lr)
        seen.append(ex)
        return (out + 1e-6 if len(seen) == 1 else out), grads

    monkeypatch.setattr(cs, "grouped_step", off)
    with pytest.raises(cs.SmokeFailure, match="14c step 1: the grouped"):
        cs.grouped_lm_phase(torch, np)


def test_grouped_lm_ends_without_attention_in_the_profile(small,
                                                          monkeypatch):
    monkeypatch.setattr(cs, "device_kernel_names", lambda prof: set())
    with pytest.raises(cs.SmokeFailure, match="no fa_fwd kernel"):
        cs.grouped_lm_phase(torch, np)


def test_fine_tune_ends_when_a_fixed_argument_moves(small, monkeypatch):
    """A fine-tune whose optimizer also updates the fixed arguments (the
    reference's C19, say) ends the run."""
    real = mt.mod.Module.__init__

    def unfixed(self, *args, **kwargs):
        kwargs["fixed_param_names"] = None
        real(self, *args, **kwargs)

    monkeypatch.setattr(mt.mod.Module, "__init__", unfixed)
    with pytest.raises(cs.SmokeFailure, match="fixed arguments changed"):
        cs.fine_tune_resnet(torch, np)


def test_examples_gates_end_the_run(small, monkeypatch):
    for name, fn, match in (("CRF", cs.crf_example, "tag accuracy"),
                            ("TREE", cs.tree_example, "accuracy"),
                            ("SORT", cs.sort_example, "accuracy"),
                            ("MULTI", cs.multi_example, "gate"),
                            ("FINE_TUNE", cs.fine_tune_example, "accuracy")):
        monkeypatch.setattr(cs, name, dict(getattr(cs, name), min_acc=1.01))
        with pytest.raises(cs.SmokeFailure, match=match):
            fn(torch, np)
    monkeypatch.setattr(cs, "MP_LSTM", dict(cs.MP_LSTM, max_ratio=0.0))
    with pytest.raises(cs.SmokeFailure, match="gate is < 0"):
        cs.mp_lstm_example(torch, np)
