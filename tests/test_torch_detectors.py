"""The SSD, Fast R-CNN and CTC OCR graphs of ``chip_smoke.py`` phase 13
against the reference's examples, and phase 13 rehearsed on the CPU.

The reference builds each net with its example's own code
(``examples/train_ssd.py`` ``build_ssd``, ``examples/train_rcnn.py``
``build_net`` with its ``proposal_target`` CustomOp; ``ctc_ocr.py``'s
Gluon net is local to its ``main``, so ``chip_smoke.ctc_net`` builds it
with the reference's API); the port with ``chip_smoke``'s builders. Both
bind a few images of the examples' data with the reference's seeded
initial parameters: the step-1 outputs and every parameter gradient
agree within 1e-5 of max(1, max|ref|), three SGD steps (two Adam
steps for CTC) stay in step within 1e-5, and SSD's detection module
gives the same detections (every row's class id equal, the kept rows'
scores and boxes within 1e-5).

The rehearsal runs phase 13 on the CPU at small sizes (a few images and
epochs, the examples' gates off: they hold at the examples' sizes, which
``chip_smoke.py`` runs on the card), the "card" being the CPU, with
CUDA-only calls stood in for; then the checks end the run when the port
is broken (a 13a case off the CPU's, SSD's first step off its plain
forward, an example under its gate).
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

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "examples"))
import train_rcnn  # noqa: E402
import train_ssd  # noqa: E402

RTOL = 1e-5


@pytest.fixture(autouse=True)
def _on_cpu():
    with mt.device_scope("cpu"):
        yield


def _close(got, want, what, rtol=RTOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    scale = max(1.0, float(np.abs(want).max(initial=0.0)))
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol * scale,
                               err_msg=what)


def _same_params(jm, pm, rtol=RTOL):
    ja, pa = jm.get_params()[0], pm.get_params()[0]
    assert sorted(ja) == sorted(pa)
    for k in ja:
        _close(pa[k].asnumpy(), ja[k].asnumpy(), k, rtol)


def _same_grads(jm, pm):
    for k in pm._param_names:
        _close(pm._exec.grad_dict[k].asnumpy(),
               jm._exec.grad_dict[k].asnumpy(), "gradient of " + k)


def _batch(pkg, data, label=None):
    return pkg.io.DataBatch(data=[pkg.nd.array(d) for d in data],
                            label=None if label is None
                            else [pkg.nd.array(lb) for lb in label])


def _pair(jm, pm, data_shapes, label_shapes, seed_name):
    for m in (jm, pm):
        m.bind(data_shapes=data_shapes, label_shapes=label_shapes)
    jm.init_params(mx.init.Xavier(magnitude=2).set_rng(
        mx.random.derive_numpy_rng(seed_name)))
    pm.set_params({k: v.asnumpy() for k, v in jm.get_params()[0].items()},
                  {})


# --------------------------------------------------------------------- SSD

N_SSD = 4


@pytest.fixture(scope="module")
def ssd_pair():
    """Both packages' SSD after step 1 (outputs and gradients) and three
    SGD steps, and their detection modules on the trained weights."""
    with mt.device_scope("cpu"):
        mx.random.seed(cs.SSD_SEED)
        x, labels = cs.ssd_data(np, N_SSD * 2, cs.SSD_SIZE, seed=5)
        jm = mx.mod.Module(train_ssd.build_ssd(True), context=mx.cpu(),
                           data_names=("data",), label_names=("label",))
        pm = mt.mod.Module(cs.ssd_symbol(mt, True), context=mt.cpu(),
                           data_names=("data",), label_names=("label",))
        _pair(jm, pm, [("data", (N_SSD, 3, cs.SSD_SIZE, cs.SSD_SIZE))],
              [("label", (N_SSD, 1, 5))], "train_ssd")
        out = {"x": x}
        for m, pkg in ((jm, mx), (pm, mt)):
            m.init_optimizer(optimizer="sgd", optimizer_params={
                "learning_rate": cs.SSD_LR, "momentum": cs.SSD_MOMENTUM,
                "wd": cs.SSD_WD})
        steps = []
        for s in range(3):
            sl = slice((s % 2) * N_SSD, (s % 2 + 1) * N_SSD)
            for m, pkg in ((jm, mx), (pm, mt)):
                m.forward_backward(_batch(pkg, [x[sl]], [labels[sl]]))
            steps.append(([o.asnumpy() for o in jm.get_outputs()],
                          [o.asnumpy() for o in pm.get_outputs()]))
            if s == 0:
                _same_grads(jm, pm)
            for m in (jm, pm):
                m.update()
        out["steps"] = steps
        out["pair"] = (jm, pm)
        dets = []
        for m, pkg, build in ((jm, mx, train_ssd.build_ssd),
                              (pm, mt, lambda t: cs.ssd_symbol(mt, t))):
            d = pkg.mod.Module(build(False), context=pkg.cpu(),
                               data_names=("data",), label_names=())
            d.bind(data_shapes=[("data", (N_SSD, 3, cs.SSD_SIZE,
                                          cs.SSD_SIZE))], for_training=False)
            d.set_params(*m.get_params())
            it = pkg.io.NDArrayIter(x, batch_size=N_SSD)
            dets.append(d.predict(it).asnumpy())
        out["dets"] = dets
        return out


def test_ssd_step_one_outputs(ssd_pair):
    want, got = ssd_pair["steps"][0]
    assert len(got) == len(want) == 2
    for i, (g, w) in enumerate(zip(got, want)):
        _close(g, w, "SSD output %d" % i)


def test_ssd_three_sgd_steps_in_step(ssd_pair):
    for s, (want, got) in enumerate(ssd_pair["steps"]):
        for i, (g, w) in enumerate(zip(got, want)):
            _close(g, w, "SSD step %d output %d" % (s + 1, i))
    _same_params(*ssd_pair["pair"])


def test_ssd_detections_equal(ssd_pair):
    """The same class id (or -1) in every row and the same kept
    detections. Suppressed rows (-1) stay in score order too, and two of
    them whose scores part in the last bits (f32 sums in another
    order) may trade places, so their boxes are not compared."""
    want, got = ssd_pair["dets"]
    # 16x16 and 8x8 maps, 4 anchors a cell
    assert got.shape == want.shape == (2 * N_SSD, 1280, 6)
    np.testing.assert_array_equal(got[..., 0], want[..., 0])
    kept = want[..., 0] >= 0
    assert kept.sum() > 0
    _close(got[kept], want[kept], "SSD detections")


# ------------------------------------------------------------ Fast R-CNN

N_RCNN = 4


def test_fast_rcnn_matches_the_reference():
    """The R-CNN graph with its host CustomOp in both packages: step-1
    probabilities and gradients, then three SGD steps."""
    train_rcnn.register_proposal_target(mx)
    cs.register_proposal_target(mt, np)
    x, rois, gt = cs.rcnn_data(np, N_RCNN * 2, seed=9)
    R = cs.RCNN_R
    bidx = np.repeat(np.arange(N_RCNN, dtype=np.float32), R).reshape(
        N_RCNN, R, 1)
    names = dict(data_names=("data", "rois", "roi_batch_idx"),
                 label_names=("gt",))
    jm = mx.mod.Module(train_rcnn.build_net(mx), context=mx.cpu(), **names)
    pm = mt.mod.Module(cs.rcnn_symbol(mt), context=mt.cpu(), **names)
    _pair(jm, pm, [("data", (N_RCNN, 3, cs.RCNN_SIZE, cs.RCNN_SIZE)),
                   ("rois", (N_RCNN, R, 4)),
                   ("roi_batch_idx", (N_RCNN, R, 1))],
          [("gt", (N_RCNN, 5))], "train_rcnn")
    for m in (jm, pm):
        m.init_optimizer(optimizer="sgd", optimizer_params={
            "learning_rate": cs.RCNN_LR, "momentum": 0.9})
    for s in range(3):
        sl = slice((s % 2) * N_RCNN, (s % 2 + 1) * N_RCNN)
        for m, pkg in ((jm, mx), (pm, mt)):
            m.forward_backward(_batch(pkg, [x[sl], rois[sl], bidx], [gt[sl]]))
        _close(pm.get_outputs()[0].asnumpy(), jm.get_outputs()[0].asnumpy(),
               "R-CNN step %d probabilities" % (s + 1))
        if s == 0:
            _same_grads(jm, pm)
        for m in (jm, pm):
            m.update()
    _same_params(jm, pm)


# ------------------------------------------------------------------- CTC

def test_ctc_ocr_matches_the_reference():
    """The CTC OCR Gluon net with ``nd.CTCLoss`` under ``record()`` and
    ``Trainer("adam")`` in both packages: two steps' losses and the
    parameters after them."""
    X, Y = cs.ctc_data(np, 4, seed=1)
    nets = []
    for pkg in (mx, mt):
        net = cs.ctc_net(pkg, 8)
        net.initialize(pkg.init.Xavier(), ctx=pkg.cpu())
        nets.append(net)
    jp, pp = nets[0].collect_params(), nets[1].collect_params()
    assert sorted(jp.keys()) == sorted(pp.keys())
    net_in = nets[0](mx.nd.array(X))             # finish deferred shapes
    nets[1](mt.nd.array(X))
    for k in jp.keys():
        pp[k].set_data(mt.nd.array(jp[k].data().asnumpy()))
    trainers = [pkg.gluon.Trainer(net.collect_params(), "adam",
                                  {"learning_rate": cs.CTC_LR})
                for pkg, net in ((mx, nets[0]), (mt, nets[1]))]
    for s in range(2):
        losses = []
        for pkg, net, tr in ((mx, nets[0], trainers[0]),
                             (mt, nets[1], trainers[1])):
            xb, yb = pkg.nd.array(X), pkg.nd.array(Y)
            with pkg.autograd.record():
                act = pkg.nd.transpose(net(xb), axes=(1, 0, 2))
                loss = pkg.nd.mean(pkg.nd.CTCLoss(act, yb + 1))
            loss.backward()
            tr.step(1)
            losses.append(float(loss.asnumpy().ravel()[0]))
        _close(losses[1], losses[0], "CTC step %d loss" % (s + 1))
    for k in jp.keys():
        _close(pp[k].data().asnumpy(), jp[k].data().asnumpy(), k)
    assert net_in.shape == (4, cs.CTC_DIGITS * cs.CTC_DIGIT_W + 6,
                            cs.CTC_CLASSES + 1)


def test_greedy_decode_collapses_repeats_and_blanks():
    probs = np.zeros((6, 1, 4))
    for t, k in enumerate([1, 1, 0, 1, 3, 3]):
        probs[t, 0, k] = 1
    assert cs.greedy_decode(probs) == [[0, 0, 2]]


# -------------------------------------------------------------- rehearsal

class _Event:
    def __init__(self, enable_timing=False):
        self.t = None

    def record(self):
        self.t = time.perf_counter()

    def elapsed_time(self, end):
        return (end.t - self.t) * 1e3


@pytest.fixture
def small(monkeypatch):
    for name, value in (
            ("DEVICE", "cpu"), ("SSD_IMAGES", 32), ("SSD_BATCH", 16),
            ("SSD_EPOCHS", 1), ("SSD_WARM", 0), ("SSD_MIN_IOU", -1.0),
            ("SSD300_LAYERS", ((4, (0.1, 0.141), (1.0, 2.0, 0.5)),
                               (2, (0.2, 0.272),
                                (1.0, 2.0, 0.5, 3.0, 1.0 / 3)))),
            ("SSD300_ANCHORS", 4 * 16 + 6 * 4), ("SSD300_BATCH", 2),
            ("SSD300_GT", 4), ("RPN_MAP", (4, 6)), ("RPN_PRE", 60),
            ("RPN_POST", 12), ("ROI_DATA", (2, 8, 6, 8)),
            ("ROI_PER_IMAGE", 4), ("SAP_SHAPES", ((4, 3, 5, 5),)),
            ("SAP_DRAWS", 16), ("CTC_SHAPE", (12, 3, 6, 4)),
            ("RCNN_IMAGES", 32), ("RCNN_EPOCHS", 1), ("RCNN_MIN_ACC", -1.0),
            ("CTC_EXAMPLES", 20), ("CTC_EPOCHS", 1), ("CTC_MIN_ACC", -1.0)):
        monkeypatch.setattr(cs, name, value)
    monkeypatch.setattr(mt, "gpu", lambda i=0: mt.cpu())
    monkeypatch.setattr(torch.cuda, "Event", _Event)
    for fn in ("synchronize", "empty_cache", "reset_peak_memory_stats"):
        monkeypatch.setattr(torch.cuda, fn, lambda *a: None)
    for fn in ("max_memory_allocated", "memory_allocated"):
        monkeypatch.setattr(torch.cuda, fn, lambda *a: 0)
    for flag in (torch.backends.cudnn, torch.backends.cuda.matmul):
        monkeypatch.setattr(flag, "allow_tf32", False)
    lines = []
    monkeypatch.setattr(cs, "log", lambda *a: lines.append(a[0]))
    return lines


def test_structured_phase_rehearsal_on_cpu(small):
    cs.structured_phase(torch, np)
    lines = small
    for head in ("13a structured ops: 18 ops in 20 cases",
                 "13a ROIPooling batch index [1, 2, -1, -3] on cpu -> "
                 "[31.0, nan, 21.0, nan]",
                 "13b ssd f32: step 1", "13b ssd f32: 1 epochs",
                 "13b ssd amp bf16", "13c SSD300 MultiBoxPrior",
                 "13c SSD300 MultiBoxTarget", "13c SSD300 MultiBoxDetection",
                 "13c RPN Proposal", "13c Fast R-CNN ROIPooling",
                 "13c SAP (4, 3, 5, 5)", "13c CTCLoss", "13d fast r-cnn",
                 "13e ctc ocr"):
        assert any(ln.startswith(head) for ln in lines), head


def test_structured_sweep_ends_on_a_differing_case(small, monkeypatch):
    """A 13a case whose "card" result differs from the CPU's ends the
    run."""
    real = cs.op_run
    calls = []

    def off(torch_, op, inputs, attrs, device, seed):
        outs, grads = real(torch_, op, inputs, attrs, device, seed)
        calls.append(op.name)
        if op.name == "ROIPooling" and len(calls) % 2:
            outs = [o + 1e-3 for o in outs]
        return outs, grads
    monkeypatch.setattr(cs, "op_run", off)
    with pytest.raises(cs.SmokeFailure, match="13a ROIPooling"):
        cs.structured_op_sweep(torch, np)


def test_ssd_step_one_check_ends_the_run(small, monkeypatch):
    """SSD's first step held to the plain forward: a plain forward off
    by 1e-3 ends the run."""
    real = cs.plain_ssd
    monkeypatch.setattr(cs, "plain_ssd", lambda *a: tuple(
        t + 1e-3 for t in real(*a)))
    with pytest.raises(cs.SmokeFailure, match="step 1 outputs"):
        cs.ssd_phase(torch, np)


def test_examples_gates_end_the_run(small, monkeypatch):
    monkeypatch.setattr(cs, "RCNN_MIN_ACC", 1.01)
    with pytest.raises(cs.SmokeFailure, match="ROI accuracy"):
        cs.rcnn_phase(torch, np)
    monkeypatch.setattr(cs, "CTC_MIN_ACC", 1.01)
    with pytest.raises(cs.SmokeFailure, match="sequence accuracy"):
        cs.ctc_phase(torch, np)
