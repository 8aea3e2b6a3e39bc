"""The detection ops of the port against the reference's
(``mxnet_tpu/ops/detection.py``): MultiBoxPrior, MultiBoxTarget,
MultiBoxDetection, Proposal / MultiProposal and CTCLoss, with the
helpers ``box_iou`` and ``_nms_keep``.

Each case runs one op by name in both packages (``test_torch_ops_parity``'s
``check_op``: forward and the gradient of every input under one random
head, 1e-5 / 1e-4 of max(1, max|ref|)); discrete outputs (class targets,
masks, class ids, kept rows, batch indices) must be equal. The
reference's own oracles in ``tests/test_vision_ops.py`` run on the port
too. The traps the port must not fall into each have a case named after
them: ``-inf`` ties in the hard-negative ranks and in Proposal's top-k,
a dropped Proposal slot, NMS ties, a label outside the classes, and CTC
alignments that are impossible (a finite loss near 1e30 with finite
gradients, where ``F.ctc_loss`` gives ``inf``).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import mxnet_tpu_torch as mt
from mxnet_tpu.ops import detection as ref_det
from mxnet_tpu_torch.ops import detection as det
from test_torch_ops_parity import assert_close, check_op as _check_op

# test files run side by side in parallel workers: each keeps torch's
# intra-op pool small
torch.set_num_threads(2)


def check_op(name, inputs, attrs=None):
    """``check_op`` with the reference's function under ``jax.jit`` (one
    compile per case instead of one per primitive)."""
    return _check_op(name, inputs, attrs, jit=True)


def _boxes(rng, *lead):
    c = np.sort(rng.uniform(0, 1, lead + (2, 2)), axis=-2)
    return np.swapaxes(c, -1, -2).reshape(lead + (4,)).astype(np.float32)


def _labels(rng, n, o, classes=3, pad=1):
    lab = np.concatenate([rng.integers(0, classes, (n, o, 1)).astype(
        np.float32), _boxes(rng, n, o)], -1)
    if pad:
        lab[-1, -pad:] = -1.0
    return lab


def _equal(port, ref, *idx):
    for i in idx:
        np.testing.assert_array_equal(port["outs"][i], ref["outs"][i])


def _same_batch_column(port, ref):
    """Proposal's discrete column: each roi's batch index (its box
    corners are held by ``check_op``'s limit: decoding takes ``exp``)."""
    np.testing.assert_array_equal(port["outs"][0][:, 0], ref["outs"][0][:, 0])


# ------------------------------------------------------------------ helpers

def test_box_iou_matches_the_reference():
    rng = np.random.default_rng(0)
    a, b = _boxes(rng, 7), _boxes(rng, 5)
    b[0] = [0.5, 0.5, 0.5, 0.9]          # an empty box: IoU 0, not NaN
    want = np.asarray(ref_det.box_iou(jnp.asarray(a), jnp.asarray(b)))
    got = det.box_iou(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    assert_close(got, want, 1e-6, "box_iou")


@pytest.mark.parametrize("force, topk", [(False, -1), (True, -1),
                                         (False, 3), (True, 0)])
def test_nms_keep_matches_the_reference(force, topk):
    """Order and kept set, with tied scores (stable order) and -inf
    (invalid) slots."""
    rng = np.random.default_rng(1)
    boxes = _boxes(rng, 12) * 0.5 + 0.2
    scores = np.round(rng.uniform(0, 1, 12), 1).astype(np.float32)
    scores[[2, 7]] = -np.inf
    classes = rng.integers(0, 2, 12).astype(np.float32)
    o_ref, k_ref = ref_det._nms_keep(jnp.asarray(boxes), jnp.asarray(scores),
                                     jnp.asarray(classes), 0.3, force, topk)
    o, k = det._nms_keep(torch.from_numpy(boxes), torch.from_numpy(scores),
                         torch.from_numpy(classes), 0.3, force, topk)
    np.testing.assert_array_equal(o.numpy(), np.asarray(o_ref))
    np.testing.assert_array_equal(k.numpy(), np.asarray(k_ref))


# ------------------------------------------------------------------- priors

@pytest.mark.parametrize("attrs", [
    {"sizes": (0.5, 0.25), "ratios": (1.0, 2.0)},
    {"sizes": (0.3,), "ratios": (1.0, 2.0, 0.5, 3.0, 1.0 / 3), "clip": True},
    {"sizes": (0.2, 0.4), "ratios": (1.0,), "steps": (0.25, 0.2),
     "offsets": (0.3, 0.6)}])
def test_multibox_prior(attrs):
    x = np.zeros((1, 3, 4, 5), np.float32)
    check_op("MultiBoxPrior", [x], attrs)


def test_multibox_prior_reference_enumeration():
    """``tests/test_vision_ops.py``'s oracle on the port."""
    with mt.device_scope("cpu"):
        out = mt.nd.MultiBoxPrior(mt.nd.zeros((1, 3, 2, 2)), sizes=(0.5, 0.25),
                                  ratios=(1.0, 2.0)).asnumpy()
    assert out.shape == (1, 12, 4)
    np.testing.assert_allclose(out[0, 0], [0.0, 0.0, 0.5, 0.5], atol=1e-6)
    np.testing.assert_allclose(out[0, 1], [0.125, 0.125, 0.375, 0.375],
                               atol=1e-6)
    w, h = 0.5 * np.sqrt(2.0) / 2, 0.5 / np.sqrt(2.0) / 2
    np.testing.assert_allclose(out[0, 2], [0.25 - w, 0.25 - h, 0.25 + w,
                                           0.25 + h], atol=1e-6)


# ------------------------------------------------------------------- target

@pytest.mark.parametrize("attrs", [{"overlap_threshold": 0.3},
                                   {"negative_mining_ratio": 3.0},
                                   {"negative_mining_ratio": 1.5,
                                    "minimum_negative_samples": 4,
                                    "negative_mining_thresh": 0.3,
                                    "ignore_label": -2.0,
                                    "variances": (0.2, 0.2, 0.1, 0.1)}])
def test_multibox_target(attrs):
    rng = np.random.default_rng(2)
    A = 30
    ref, port = check_op("MultiBoxTarget",
                         [_boxes(rng, 1, A), _labels(rng, 3, 4),
                          rng.standard_normal((3, 4, A)).astype(np.float32)],
                         attrs)
    _equal(port, ref, 1, 2)


def test_hard_negative_minus_inf_ties():
    """Most anchors are ineligible (-inf hardness, tied) and several
    eligible ones tie on their background score: the double stable
    argsort must rank them as the reference does."""
    rng = np.random.default_rng(3)
    A = 40
    anchors = _boxes(rng, 1, A)
    label = _labels(rng, 2, 3, pad=0)
    cls_pred = np.round(rng.standard_normal((2, 4, A)), 0).astype(np.float32)
    ref, port = check_op("MultiBoxTarget", [anchors, label, cls_pred],
                         {"negative_mining_ratio": 2.0,
                          "negative_mining_thresh": 0.05})
    _equal(port, ref, 1, 2)
    assert (ref["outs"][2] == -1).sum() > A // 2      # most are ignored


def test_multibox_target_two_gts_share_best_anchor():
    """The bipartite rounds give the loser its own anchor
    (``tests/test_vision_ops.py``'s oracle)."""
    anchors = np.array([[[0.0, 0.0, 1.0, 1.0], [0.0, 0.0, 0.4, 0.4],
                         [2.0, 2.0, 3.0, 3.0]]], np.float32)
    label = np.array([[[1, 0.0, 0.0, 0.9, 1.0], [2, 0.0, 0.0, 1.0, 0.9]]],
                     np.float32)
    ref, port = check_op("MultiBoxTarget", [anchors, label,
                                            np.zeros((1, 4, 3), np.float32)])
    _equal(port, ref, 1, 2)
    assert sorted(c for c in port["outs"][2][0] if c > 0) == [2.0, 3.0]


# ---------------------------------------------------------------- detection

@pytest.mark.parametrize("attrs", [
    {}, {"nms_threshold": 0.3, "force_suppress": True},
    {"nms_threshold": 0.3, "nms_topk": 5}, {"background_id": 2},
    {"clip": False, "threshold": 0.3, "variances": (0.2, 0.2, 0.1, 0.1)}])
def test_multibox_detection(attrs):
    rng = np.random.default_rng(4)
    A = 25
    ref, port = check_op("MultiBoxDetection",
                         [rng.uniform(0, 1, (2, 4, A)).astype(np.float32),
                          (rng.standard_normal((2, A * 4)) * 0.2).astype(
                              np.float32), _boxes(rng, 1, A)], attrs)
    np.testing.assert_array_equal(port["outs"][0][..., 0],
                                  ref["outs"][0][..., 0])


def test_multibox_detection_nms_ties():
    """Equal scores keep the lower index first; the tied loser of an
    overlapping pair is suppressed as in the reference."""
    anchors = np.array([[[0.1, 0.1, 0.3, 0.3], [0.11, 0.11, 0.31, 0.31],
                         [0.6, 0.6, 0.9, 0.9], [0.61, 0.6, 0.9, 0.9]]],
                       np.float32)
    prob = np.array([[[0.2, 0.2, 0.2, 0.2], [0.8, 0.8, 0.8, 0.8]]],
                    np.float32)
    ref, port = check_op("MultiBoxDetection",
                         [prob, np.zeros((1, 16), np.float32), anchors],
                         {"nms_threshold": 0.5})
    np.testing.assert_array_equal(port["outs"][0], ref["outs"][0])
    assert (port["outs"][0][0, :, 0] >= 0).sum() == 2


# ----------------------------------------------------------------- proposal

RPN = dict(feature_stride=16, scales=(2.0,), ratios=(0.5, 1.0, 2.0),
           rpn_pre_nms_top_n=30, rpn_post_nms_top_n=8, rpn_min_size=4)


def _rpn_inputs(seed, n=1, a=3, h=4, w=4, size=64):
    rng = np.random.default_rng(seed)
    return [rng.uniform(0, 1, (n, 2 * a, h, w)).astype(np.float32),
            (rng.standard_normal((n, 4 * a, h, w)) * 0.1).astype(np.float32),
            np.tile(np.array([[size, size, 1.0]], np.float32), (n, 1))]


@pytest.mark.parametrize("attrs", [RPN, dict(RPN, threshold=0.95,
                                        rpn_post_nms_top_n=4),
                                   dict(RPN, rpn_pre_nms_top_n=100,
                                        scales=(1.0, 2.0))])
def test_proposal(attrs):
    a = len(attrs["scales"]) * len(attrs["ratios"])
    ref, port = check_op("Proposal", _rpn_inputs(5, a=a), attrs)
    _same_batch_column(port, ref)


def test_proposal_batch_of_two_and_the_alias():
    ref, port = check_op("MultiProposal", _rpn_inputs(6, n=2),
                         dict(RPN, output_score=True))
    _same_batch_column(port, ref)


def test_proposal_minus_inf_ties():
    """A minimum size most boxes fail: their scores are -inf and tie in
    the top-k, which keeps them lower index first (never ``topk``)."""
    ref, port = check_op("Proposal", _rpn_inputs(7),
                         dict(RPN, rpn_min_size=40, rpn_pre_nms_top_n=40,
                              output_score=True))
    _same_batch_column(port, ref)
    _equal(port, ref, 1)                  # scores are gathered, not computed
    assert np.isinf(ref["outs"][1]).sum() == 0      # padded with the best


def test_proposal_dropped_slot():
    """More boxes survive NMS than there are slots, and fewer: the
    scatter into ``post + 1`` slots drops index ``post`` as the
    reference's ``mode="drop"`` does, and empty slots repeat the
    first."""
    for post, thresh in ((4, 0.95), (40, 0.3)):
        ref, port = check_op("Proposal", _rpn_inputs(8, a=3, h=6, w=6,
                                                     size=96),
                             dict(RPN, rpn_pre_nms_top_n=100,
                                  rpn_post_nms_top_n=post, threshold=thresh,
                                  output_score=True))
        _same_batch_column(port, ref)
        _equal(port, ref, 1)
    rois = port["outs"][0]
    assert rois.shape == (40, 5)
    np.testing.assert_array_equal(rois[-1], rois[0])


# ---------------------------------------------------------------------- CTC

def test_ctc_loss():
    rng = np.random.default_rng(9)
    check_op("CTCLoss", [rng.standard_normal((8, 3, 5)).astype(np.float32),
                         np.array([[1, 2, 2], [3, 0, 0], [4, 4, 1]],
                                  np.float32)])


def test_ctc_loss_matches_bruteforce():
    """``tests/test_vision_ops.py``'s enumeration oracle on the port."""
    from test_vision_ops import _np_ctc_loss
    rng = np.random.RandomState(5)
    data = rng.randn(4, 2, 3).astype(np.float32)
    label = np.array([[1, 2], [2, 0]], np.float32)
    with mt.device_scope("cpu"):
        loss = mt.nd.CTCLoss(mt.nd.array(data), mt.nd.array(label)).asnumpy()
    np.testing.assert_allclose(loss[0], _np_ctc_loss(data[:, 0], [1, 2]),
                               rtol=1e-4)
    np.testing.assert_allclose(loss[1], _np_ctc_loss(data[:, 1], [2]),
                               rtol=1e-4)


def test_ctc_impossible_alignment():
    """T too short for the label (repeats need a blank between them):
    the reference's finite -1e30 gives a loss near 1e30 and finite
    gradients, and the port's equals them; torch's own CTC gives inf."""
    rng = np.random.default_rng(10)
    data = rng.standard_normal((2, 2, 4)).astype(np.float32)
    label = np.array([[1, 1, 2], [3, 3, 3]], np.float32)
    ref, port = check_op("CTCLoss", [data, label])
    assert np.all(np.isfinite(port["outs"][0]))
    assert np.all(port["outs"][0] > 1e29)
    assert np.all(np.isfinite(port["grads"][0]))
    lp = torch.log_softmax(torch.from_numpy(data), -1)
    torch_ctc = torch.nn.functional.ctc_loss(
        lp, torch.from_numpy(label).long(), torch.tensor([2, 2]),
        torch.tensor([3, 3]), reduction="none")
    assert torch.isinf(torch_ctc).all()


def test_ctc_label_outside_the_classes():
    """A label at or past C (or below -C) reads NaN, as
    ``jnp.take_along_axis`` fills; -1 wraps to the last class."""
    rng = np.random.default_rng(11)
    data = rng.standard_normal((5, 3, 4)).astype(np.float32)
    label = np.array([[1, 7], [-1, 0], [2, -9]], np.float32)
    ref, port = check_op("CTCLoss", [data, label])
    assert np.isnan(port["outs"][0][[0, 2]]).all()
    assert np.isfinite(port["outs"][0][1])


def test_ctc_grad_through_nd_and_autograd():
    rng = np.random.RandomState(6)
    with mt.device_scope("cpu"):
        x = mt.nd.array(rng.randn(5, 1, 4).astype(np.float32))
        x.attach_grad()
        with mt.autograd.record():
            s = mt.nd.sum(mt.nd.CTCLoss(x, mt.nd.array(
                np.array([[1, 3]], np.float32))))
        s.backward()
        g = x.grad.asnumpy()
    assert np.isfinite(g).all() and np.abs(g).max() > 0


def test_ctc_symbol_and_contrib_names():
    """``sym.CTCLoss`` binds with the reference's input names and shape;
    ``contrib.nd.CTCLoss`` is the same op."""
    s = mt.sym.CTCLoss(mt.sym.Variable("data"), mt.sym.Variable("label"))
    assert s.list_arguments() == ["data", "label"]
    _, out, _ = s.infer_shape(data=(6, 2, 5), label=(2, 3))
    assert out == [(2,)]
    with mt.device_scope("cpu"):
        x = mt.nd.array(np.zeros((3, 1, 4), np.float32))
        y = mt.nd.array(np.array([[1]], np.float32))
        np.testing.assert_array_equal(mt.contrib.nd.CTCLoss(x, y).asnumpy(),
                                      mt.nd.ctc_loss(x, y).asnumpy())


def test_detection_symbols_infer_shapes():
    """The ops' meta functions give the reference's output shapes and
    counts through the symbol layer."""
    anchors = mt.sym.MultiBoxPrior(mt.sym.Variable("feat"), sizes=(0.3, 0.6),
                                   ratios=(1.0, 0.5, 2.0))
    tgt = mt.sym.MultiBoxTarget(anchors, mt.sym.Variable("label"),
                                mt.sym.Variable("cls_pred"))
    assert len(tgt.list_outputs()) == 3
    _, out, _ = tgt.infer_shape(feat=(2, 8, 4, 4), label=(2, 3, 5),
                                cls_pred=(2, 4, 64))
    assert out == [(2, 256), (2, 256), (2, 64)]
    prop = mt.sym.Proposal(mt.sym.Variable("c"), mt.sym.Variable("b"),
                           mt.sym.Variable("i"), rpn_post_nms_top_n=7,
                           output_score=True)
    assert len(prop.list_outputs()) == 2
    _, out, _ = prop.infer_shape(c=(2, 24, 4, 4), b=(2, 48, 4, 4), i=(2, 3))
    assert out == [(14, 5), (14, 1)]
