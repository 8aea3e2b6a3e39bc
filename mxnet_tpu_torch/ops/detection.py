"""Detection operators: ``MultiBoxPrior`` / ``MultiBoxTarget`` /
``MultiBoxDetection`` (SSD), ``Proposal`` / ``MultiProposal`` (the
Faster R-CNN RPN) and ``CTCLoss``, with the helpers ``box_iou`` and
``_nms_keep``.

The port's counterpart of the reference's ``ops/detection.py``: the same
fixed shapes (invalid slots padded with -1), the same greedy orders and
the same gradients, since the reference differentiates every output that
depends smoothly on an input (decoded boxes, scores, encoded targets):

* Every sort breaks ties by index: ``torch.argsort(..., stable=True)``
  where the reference takes ``jnp.argsort`` (stable) or ``lax.top_k``
  (equal values lower index first), never ``torch.topk``. Hard negatives
  are ranked by a double stable argsort, where the ``-inf`` of
  ineligible anchors tie.
* The greedy NMS sweep (:func:`_nms_keep`) runs the reference's
  ``limit`` dependent steps over a suppression block of ``limit`` rows
  (only the first ``limit`` sorted boxes may suppress), batched over
  images; the block is built in row chunks so its IoU temporaries stay
  bounded.
* ``Proposal`` scatters the kept boxes into ``post + 1`` slots and cuts
  the last, where the reference's ``mode="drop"`` discards index
  ``post``.
* ``jnp.clip`` is ``minimum(maximum(x, lo), hi)``, and so is the port's,
  so a value on a bound shares its gradient as the reference's does;
  a ``max`` that is differentiated is ``torch.amax``, which shares the
  gradient among ties.
* ``CTCLoss`` runs the reference's alpha recursion over time in log
  space with its finite ``-1e30``: an impossible alignment gives a
  finite loss near 1e30 with finite gradients (``F.ctc_loss`` would
  return ``inf``). Its ``logaddexp`` has ``jnp.logaddexp``'s derivative,
  which differs from torch's where two values near -1e30 absorb
  ``log 2``. Label gathers clamp, then mask with NaN
  (``indexing._in_axis``), as ``jnp.take_along_axis`` fills.

Each op has a ``meta_fn`` for shape inference.
"""
from __future__ import annotations

import numpy as np
import torch

from .indexing import _in_axis, _nan_where
from .registry import register

__all__ = ["box_iou"]

_NEG = -1e30            # CTCLoss's finite minus infinity
# elements of one IoU temporary of the NMS block (~256 MB of float32)
_NMS_CHUNK = 1 << 26


def _ftup(v, n=None):
    t = (float(v),) if isinstance(v, (int, float)) else \
        tuple(float(x) for x in v)
    if n is not None and len(t) == 1:
        t = t * n
    return t


def _clip(x, lo, hi):
    """``jnp.clip``: ``minimum(maximum(x, lo), hi)``; ``lo`` / ``hi`` a
    number or a tensor that broadcasts."""
    lo = lo if isinstance(lo, torch.Tensor) else x.new_tensor(lo)
    hi = hi if isinstance(hi, torch.Tensor) else x.new_tensor(hi)
    return torch.minimum(torch.maximum(x, lo), hi)


def box_iou(a, b):
    """Pairwise IoU of corner-format boxes: a (..., A, 4) x b (..., B, 4)
    -> (..., A, B); 0 where the union is empty."""
    zero = a.new_tensor(0.0)
    area_a = torch.maximum(a[..., 2] - a[..., 0], zero) * \
        torch.maximum(a[..., 3] - a[..., 1], zero)
    area_b = torch.maximum(b[..., 2] - b[..., 0], zero) * \
        torch.maximum(b[..., 3] - b[..., 1], zero)
    lt = torch.maximum(a[..., :, None, :2], b[..., None, :, :2])
    rb = torch.minimum(a[..., :, None, 2:], b[..., None, :, 2:])
    wh = torch.maximum(rb - lt, zero)
    inter = wh[..., 0] * wh[..., 1]
    union = area_a[..., :, None] + area_b[..., None, :] - inter
    return torch.where(union > 0, inter / union, zero)


def _suppressors(bs, cs, valid, limit, thresh, force_suppress):
    """``(N, limit, A)``: row i suppresses column j when i < j, box i is
    valid, their IoU exceeds ``thresh`` and (unless ``force_suppress``)
    their classes agree."""
    N, A = bs.shape[:2]
    idx = torch.arange(A, device=bs.device)
    rows = max(1, min(limit, _NMS_CHUNK // max(1, N * A)))
    parts = []
    for r0 in range(0, limit, rows):
        r1 = min(limit, r0 + rows)
        sup = box_iou(bs[:, r0:r1], bs) > thresh
        if not force_suppress:
            sup = sup & (cs[:, r0:r1, None] == cs[:, None, :])
        later = idx[None, :] > idx[r0:r1, None]
        parts.append(sup & later & valid[:, r0:r1, None])
    return torch.cat(parts, 1) if parts else \
        torch.zeros((N, 0, A), dtype=torch.bool, device=bs.device)


def _nms_keep(boxes, scores, classes, thresh, force_suppress, topk):
    """Greedy NMS over score-sorted boxes: ``(order, keep-in-order)``.

    ``boxes`` (A, 4), ``scores`` (A,), ``classes`` (A,), or each with a
    leading batch axis. Scores at -inf mark invalid slots; ``topk``
    bounds how many sorted boxes may suppress (the reference's
    ``nms_topk``), and with ``topk >= 0`` boxes ranked past it are
    dropped. The sweep takes the reference's ``limit`` dependent steps,
    one per possible suppressor."""
    single = boxes.dim() == 2
    if single:
        boxes, scores, classes = boxes[None], scores[None], classes[None]
    with torch.no_grad():
        N, A = scores.shape
        order = torch.argsort(-scores, dim=1, stable=True)
        bs = torch.gather(boxes.detach(), 1,
                          order[..., None].expand(N, A, 4))
        cs = torch.gather(classes.detach(), 1, order)
        valid = torch.gather(scores.detach(), 1, order) > -float("inf")
        limit = A if (topk is None or topk < 0) else min(int(topk), A)
        sup = _suppressors(bs, cs, valid, limit, thresh, force_suppress)
        keep = valid.clone()
        for i in range(limit):
            keep &= ~(sup[:, i] & keep[:, i:i + 1])
        if topk is not None and topk >= 0:
            keep[:, limit:] = False
    if single:
        return order[0], keep[0]
    return order, keep


# ----------------------------------------------------------------- priors

def _prior_meta(data, sizes=(1.0,), ratios=(1.0,), **_):
    n = data.shape[2] * data.shape[3] * (len(_ftup(sizes)) +
                                         len(_ftup(ratios)) - 1)
    return torch.empty((1, n, 4), dtype=data.dtype, device="meta")


@register("MultiBoxPrior", num_inputs=1, meta_fn=_prior_meta,
          aliases=("_contrib_MultiBoxPrior", "multibox_prior"))
def multibox_prior(data, sizes=(1.0,), ratios=(1.0,), clip=False,
                   steps=(-1.0, -1.0), offsets=(0.5, 0.5)):
    """SSD anchors (1, H*W*A, 4) in normalized corners: per cell one box
    per size at ``ratios[0]``, then one per further ratio at
    ``sizes[0]``. The result depends on ``data``'s shape only."""
    H, W = data.shape[2], data.shape[3]
    sizes, ratios = _ftup(sizes), _ftup(ratios)
    steps, offsets = _ftup(steps, 2), _ftup(offsets, 2)
    step_y = steps[0] if steps[0] > 0 else 1.0 / H
    step_x = steps[1] if steps[1] > 0 else 1.0 / W
    wh = [(s / 2.0, s / 2.0) for s in sizes]
    wh += [(sizes[0] * np.sqrt(r) / 2.0, sizes[0] / np.sqrt(r) / 2.0)
           for r in ratios[1:]]
    dt, dev = data.dtype, data.device
    wh = torch.tensor(np.asarray(wh), dtype=dt, device=dev)      # (A, 2)
    cy = (torch.arange(H, dtype=dt, device=dev) + offsets[0]) * step_y
    cx = (torch.arange(W, dtype=dt, device=dev) + offsets[1]) * step_x
    cyx = torch.stack(torch.meshgrid(cy, cx, indexing="ij"),
                      dim=-1).reshape(H * W, 1, 2)               # (HW,1,[y,x])
    half = wh.flip(-1)[None]                                     # (1,A,[h,w])
    mins, maxs = cyx - half, cyx + half
    boxes = torch.cat([mins[..., 1:2], mins[..., 0:1], maxs[..., 1:2],
                       maxs[..., 0:1]], dim=-1).reshape(1, -1, 4)
    return _clip(boxes, 0.0, 1.0) if clip else boxes


# ----------------------------------------------------------------- target

def _encode_box(anchor, gt, variances):
    aw = anchor[..., 2] - anchor[..., 0]
    ah = anchor[..., 3] - anchor[..., 1]
    ax = (anchor[..., 0] + anchor[..., 2]) * 0.5
    ay = (anchor[..., 1] + anchor[..., 3]) * 0.5
    gw = gt[..., 2] - gt[..., 0]
    gh = gt[..., 3] - gt[..., 1]
    gx = (gt[..., 0] + gt[..., 2]) * 0.5
    gy = (gt[..., 1] + gt[..., 3]) * 0.5
    vx, vy, vw, vh = variances
    tiny = gw.new_tensor(1e-12)
    return torch.stack([(gx - ax) / aw / vx, (gy - ay) / ah / vy,
                        torch.log(torch.maximum(gw / aw, tiny)) / vw,
                        torch.log(torch.maximum(gh / ah, tiny)) / vh], dim=-1)


def _target_meta(anchor, label, cls_pred, **_):
    N, A = label.shape[0], anchor.numel() // 4
    return (torch.empty((N, A * 4), dtype=anchor.dtype, device="meta"),
            torch.empty((N, A * 4), dtype=anchor.dtype, device="meta"),
            torch.empty((N, A), dtype=label.dtype, device="meta"))


def _bipartite(iou):
    """The reference's forced matches: O rounds, each claiming the
    globally best remaining (anchor, gt) pair per image (the first in
    row-major order among equals) and retiring both. Returns
    ``(forced (N, A) bool, forced gt (N, A) int64)``."""
    N, A, O = iou.shape
    m = iou.clone()
    forced = torch.zeros((N, A), dtype=torch.bool, device=iou.device)
    f_gt = torch.zeros((N, A), dtype=torch.int64, device=iou.device)
    rows = torch.arange(N, device=iou.device)
    for _ in range(O):
        flat = torch.argmax(m.reshape(N, -1), dim=1)
        a, o = flat // O, flat % O
        good = m.reshape(N, -1)[rows, flat] > 1e-12
        forced[rows, a] = forced[rows, a] | good
        f_gt[rows, a] = torch.where(good, o, f_gt[rows, a])
        gone = good[:, None]
        m[rows, a, :] = torch.where(gone, m.new_tensor(-1.0), m[rows, a, :])
        m[rows, :, o] = torch.where(gone, m.new_tensor(-1.0), m[rows, :, o])
    return forced, f_gt


@register("MultiBoxTarget", num_inputs=3, num_outputs=3, meta_fn=_target_meta,
          aliases=("_contrib_MultiBoxTarget", "multibox_target"))
def multibox_target(anchor, label, cls_pred, overlap_threshold=0.5,
                    ignore_label=-1.0, negative_mining_ratio=-1.0,
                    negative_mining_thresh=0.5, minimum_negative_samples=0,
                    variances=(0.1, 0.1, 0.2, 0.2)):
    """SSD training targets: ``(box_target (N, A*4), box_mask (N, A*4),
    cls_target (N, A))`` for ``anchor`` (1, A, 4), ``label`` (N, O, 5)
    rows [cls, x1, y1, x2, y2] (cls -1 pads) and ``cls_pred`` (N, C, A),
    which only hard-negative mining reads. Each gt first claims its best
    anchor (bipartite rounds), then every anchor whose best IoU reaches
    ``overlap_threshold`` matches its best gt."""
    variances = _ftup(variances, 4)
    anchors = anchor.reshape(-1, 4)
    N, O = label.shape[0], label.shape[1]
    A = anchors.shape[0]
    with torch.no_grad():
        valid = label[:, :, 0] >= 0
        iou = box_iou(anchors.detach().expand(N, A, 4),
                      label[:, :, 1:5].detach())                 # (N, A, O)
        iou = torch.where(valid[:, None, :], iou, iou.new_tensor(0.0))
        best_iou = torch.amax(iou, dim=2)
        best_gt = torch.argmax(iou, dim=2)      # the first maximum
        forced, f_gt = _bipartite(iou)
        matched = forced | (best_iou >= overlap_threshold)
        best_gt = torch.where(forced, f_gt, best_gt)
    gt = torch.gather(label, 1, best_gt[..., None].expand(N, A, 5))
    box_t = _encode_box(anchors[None], gt[..., 1:5], variances)
    zero = box_t.new_tensor(0.0)
    box_t = torch.where(matched[..., None], box_t, zero)
    box_m = torch.where(matched[..., None], torch.ones_like(box_t), zero)
    cls_t = torch.where(matched, gt[..., 0] + 1.0, gt.new_tensor(0.0))
    if negative_mining_ratio > 0:
        with torch.no_grad():
            num_pos = matched.sum(dim=1).to(torch.float32)
            max_neg = torch.clamp_min(
                (negative_mining_ratio * num_pos).to(torch.int32),
                int(minimum_negative_samples))
            neg_ok = ~matched & (best_iou < negative_mining_thresh)
            inf = cls_pred.new_tensor(float("inf"))
            hardness = torch.where(neg_ok, -cls_pred[:, 0].detach(), -inf)
            first = torch.argsort(-hardness, dim=1, stable=True)
            rank = torch.argsort(first, dim=1, stable=True)
            selected = neg_ok & (rank < max_neg[:, None])
        cls_t = torch.where(matched, cls_t,
                            torch.where(selected, gt.new_tensor(0.0),
                                        gt.new_tensor(float(ignore_label))))
    return box_t.reshape(N, -1), box_m.reshape(N, -1), cls_t


multibox_target._input_names = ["anchor", "label", "cls_pred"]


# --------------------------------------------------------------- detection

def _decode_boxes(anchors, loc, variances, clip):
    aw = anchors[..., 2] - anchors[..., 0]
    ah = anchors[..., 3] - anchors[..., 1]
    ax = (anchors[..., 0] + anchors[..., 2]) * 0.5
    ay = (anchors[..., 1] + anchors[..., 3]) * 0.5
    vx, vy, vw, vh = variances
    ox = loc[..., 0] * vx * aw + ax
    oy = loc[..., 1] * vy * ah + ay
    ow = torch.exp(loc[..., 2] * vw) * aw * 0.5
    oh = torch.exp(loc[..., 3] * vh) * ah * 0.5
    out = torch.stack([ox - ow, oy - oh, ox + ow, oy + oh], dim=-1)
    return _clip(out, 0.0, 1.0) if clip else out


def _detection_meta(cls_prob, loc_pred, anchor, **_):
    N, A = cls_prob.shape[0], anchor.numel() // 4
    return torch.empty((N, A, 6), dtype=loc_pred.dtype, device="meta")


@register("MultiBoxDetection", num_inputs=3, meta_fn=_detection_meta,
          aliases=("_contrib_MultiBoxDetection", "multibox_detection"))
def multibox_detection(cls_prob, loc_pred, anchor, clip=True,
                       threshold=0.01, background_id=0, nms_threshold=0.5,
                       force_suppress=False,
                       variances=(0.1, 0.1, 0.2, 0.2), nms_topk=-1):
    """SSD inference: decode and per-class NMS. ``cls_prob`` (N, C, A)
    with a background class; returns (N, A, 6) rows [cls_id, score, x1,
    y1, x2, y2] in score order, invalid rows cls_id = score = -1. Class
    ids above the background shift down by one."""
    variances = _ftup(variances, 4)
    anchors = anchor.reshape(-1, 4)
    N, A = cls_prob.shape[0], anchors.shape[0]
    bg = int(background_id)
    p = cls_prob.clone()
    p[:, bg] = float("-inf")
    j = torch.argmax(p, dim=1)                    # (N, A), first maximum
    cls = torch.where(j > bg, j - 1, j).to(loc_pred.dtype)
    score = torch.amax(p, dim=1)
    boxes = _decode_boxes(anchors[None], loc_pred.reshape(N, A, 4),
                          variances, clip)
    scores = torch.where(score > threshold, score,
                         score.new_tensor(float("-inf")))
    order, keep = _nms_keep(boxes, scores, cls, nms_threshold,
                            force_suppress, nms_topk)
    minus = scores.new_tensor(-1.0)
    s_cls = torch.gather(cls, 1, order)
    s_score = torch.gather(scores, 1, order)
    s_boxes = torch.gather(boxes, 1, order[..., None].expand(N, A, 4))
    return torch.cat([torch.where(keep, s_cls, minus.to(cls.dtype))[..., None],
                      torch.where(keep, s_score, minus)[..., None],
                      s_boxes], dim=-1)


multibox_detection._input_names = ["cls_prob", "loc_pred", "anchor"]


# ---------------------------------------------------------------- proposal

def _rpn_base_anchors(base_size, scales, ratios):
    """py-faster-rcnn's anchor enumeration (the reference's
    ``GenerateAnchors``): keep the area under each ratio, then scale;
    numpy rounds half to even, as the reference does."""
    w = h = float(base_size)
    x = y = (base_size - 1) / 2.0
    out = []
    size = w * h
    for r in ratios:
        ws = np.round(np.sqrt(size / r))
        hs = np.round(ws * r)
        for s in scales:
            w2, h2 = ws * s, hs * s
            out.append([x - (w2 - 1) / 2, y - (h2 - 1) / 2,
                        x + (w2 - 1) / 2, y + (h2 - 1) / 2])
    return np.asarray(out, np.float32)


def _proposal_outputs(attrs):
    return 2 if attrs.get("output_score") else 1


def _proposal_meta(cls_prob, bbox_pred, im_info, rpn_post_nms_top_n=300,
                   output_score=False, **_):
    n = cls_prob.shape[0] * int(rpn_post_nms_top_n)
    rois = torch.empty((n, 5), dtype=torch.float32, device="meta")
    if output_score:
        return rois, torch.empty((n, 1), dtype=cls_prob.dtype, device="meta")
    return rois


@register("Proposal", num_inputs=3, num_outputs=_proposal_outputs,
          meta_fn=_proposal_meta,
          aliases=("_contrib_Proposal", "proposal",
                   "_contrib_MultiProposal", "MultiProposal"))
def proposal(cls_prob, bbox_pred, im_info, rpn_pre_nms_top_n=6000,
             rpn_post_nms_top_n=300, threshold=0.7, rpn_min_size=16,
             scales=(4, 8, 16, 32), ratios=(0.5, 1, 2), feature_stride=16,
             output_score=False, iou_loss=False):
    """RPN proposals: ``cls_prob`` (N, 2A, H, W), ``bbox_pred`` (N, 4A,
    H, W), ``im_info`` (N, 3) [height, width, scale] -> rois (N*post, 5)
    [batch index, x1, y1, x2, y2] (and scores (N*post, 1) with
    ``output_score``). Boxes under ``rpn_min_size`` score -inf; the top
    ``rpn_pre_nms_top_n`` by score (equal scores lower index first) go
    through NMS, and the kept ones fill the ``post`` slots in order,
    empty slots repeating the first."""
    scales, ratios = _ftup(scales), _ftup(ratios)
    N, twoA, H, W = cls_prob.shape
    A = twoA // 2
    dev = cls_prob.device
    base = torch.from_numpy(_rpn_base_anchors(feature_stride, scales,
                                              ratios)).to(dev)
    sy = torch.arange(H, dtype=torch.float32, device=dev) * feature_stride
    sx = torch.arange(W, dtype=torch.float32, device=dev) * feature_stride
    shift = torch.stack([sx[None, :].expand(H, W).reshape(-1),
                         sy[:, None].expand(H, W).reshape(-1)] * 2, dim=1)
    anchors = (base[None, :, :] + shift[:, None, :]).reshape(-1, 4)
    K = anchors.shape[0]
    fg = cls_prob[:, A:].reshape(N, A, H * W).transpose(1, 2).reshape(N, -1)
    d = bbox_pred.reshape(N, A, 4, H * W).permute(0, 3, 1, 2).reshape(N, -1, 4)
    aw = anchors[:, 2] - anchors[:, 0] + 1.0
    ah = anchors[:, 3] - anchors[:, 1] + 1.0
    ax = anchors[:, 0] + aw * 0.5
    ay = anchors[:, 1] + ah * 0.5
    cx = d[..., 0] * aw + ax
    cy = d[..., 1] * ah + ay
    w = torch.exp(d[..., 2]) * aw
    h = torch.exp(d[..., 3]) * ah
    zero = w.new_tensor(0.0)
    wmax = (im_info[:, 1] - 1)[:, None]
    hmax = (im_info[:, 0] - 1)[:, None]
    boxes = torch.stack([_clip(cx - 0.5 * (w - 1), zero, wmax),
                         _clip(cy - 0.5 * (h - 1), zero, hmax),
                         _clip(cx + 0.5 * (w - 1), zero, wmax),
                         _clip(cy + 0.5 * (h - 1), zero, hmax)], dim=-1)
    min_sz = (rpn_min_size * im_info[:, 2])[:, None]
    ok = ((boxes[..., 2] - boxes[..., 0] + 1) >= min_sz) & \
         ((boxes[..., 3] - boxes[..., 1] + 1) >= min_sz)
    scores = torch.where(ok, fg, fg.new_tensor(float("-inf")))
    pre = min(int(rpn_pre_nms_top_n), K)
    top_idx = torch.argsort(-scores.detach(), dim=1, stable=True)[:, :pre]
    top_scores = torch.gather(scores, 1, top_idx)
    top_boxes = torch.gather(boxes, 1, top_idx[..., None].expand(N, pre, 4))
    order, keep = _nms_keep(top_boxes, top_scores, torch.zeros_like(
        top_scores), threshold, True, -1)
    post = int(rpn_post_nms_top_n)
    # unkept entries, and kept ones past ``post``, land in slot ``post``,
    # which is cut (the reference's scatter drops that index)
    rank = torch.cumsum(keep.to(torch.int64), dim=1) - 1
    slot = torch.where(keep & (rank < post), rank, torch.full_like(rank, post))
    s_boxes = torch.gather(top_boxes, 1, order[..., None].expand(N, pre, 4))
    s_scores = torch.gather(top_scores, 1, order)
    out_boxes = s_boxes.new_zeros((N, post + 1, 4)).scatter(
        1, slot[..., None].expand(N, pre, 4), s_boxes)[:, :post]
    out_scores = s_scores.new_zeros((N, post + 1)).scatter(
        1, slot, s_scores)[:, :post]
    n_kept = keep.sum(dim=1, keepdim=True)
    pad = torch.arange(post, device=dev)[None, :] >= n_kept       # (N, post)
    out_boxes = torch.where(pad[..., None], out_boxes[:, :1], out_boxes)
    out_scores = torch.where(pad, out_scores[:, :1], out_scores)
    bidx = torch.arange(N, dtype=out_boxes.dtype,
                        device=dev).repeat_interleave(post)[:, None]
    rois = torch.cat([bidx, out_boxes.reshape(-1, 4)], dim=1)
    if output_score:
        return rois, out_scores.reshape(-1, 1)
    return rois


proposal._input_names = ["cls_prob", "bbox_pred", "im_info"]


# ---------------------------------------------------------------- CTC loss

class _LogAddExp(torch.autograd.Function):
    """``logaddexp`` with ``jnp.logaddexp``'s derivative, ``exp(x_i -
    out)`` for each input: where ``out`` absorbs ``log 2`` (two equal
    values near -1e30) each input takes the whole gradient, not torch's
    half."""

    @staticmethod
    def forward(ctx, x1, x2):
        out = torch.logaddexp(x1, x2)
        ctx.save_for_backward(x1, x2, out)
        return out

    @staticmethod
    def backward(ctx, g):
        x1, x2, out = ctx.saved_tensors
        return g * torch.exp(x1 - out), g * torch.exp(x2 - out)


_logaddexp = _LogAddExp.apply

def _ctc_meta(data, label, **_):
    return torch.empty((data.shape[1],), dtype=data.dtype, device="meta")


@register("CTCLoss", num_inputs=2, meta_fn=_ctc_meta,
          aliases=("_contrib_CTCLoss", "ctc_loss"))
def ctc_loss(data, label):
    """Connectionist Temporal Classification: ``data`` (T, N, C) raw
    activations (log-softmax taken here), ``label`` (N, L) with 0 as
    padding and blank as class 0; the negative log-likelihood per
    sequence (N,). The alpha recursion runs over T in log space with the
    finite ``-1e30`` as minus infinity."""
    T, N, C = data.shape
    L = label.shape[1]
    S = 2 * L + 1
    logp = torch.log_softmax(data, dim=-1)
    lbl = label.detach().to(torch.int32)
    lengths = (lbl != 0).sum(dim=1)
    ext = torch.zeros((N, S), dtype=torch.int32, device=data.device)
    ext[:, 1::2] = lbl
    skip_ok = torch.zeros((N, S), dtype=torch.bool, device=data.device)
    skip_ok[:, 2:] = (ext[:, 2:] != 0) & (ext[:, 2:] != ext[:, :-2])
    s_valid = torch.arange(S, device=data.device)[None, :] < \
        (2 * lengths[:, None] + 1)
    # a label outside the classes (after one wrap of a negative label)
    # reads NaN, as jnp.take_along_axis fills
    ext_safe, ext_ok = _in_axis(ext, C)

    def emit_at(lp):
        return _nan_where(ext_ok, torch.gather(lp, 1, ext_safe))

    neg = logp.new_tensor(_NEG)
    first = emit_at(logp[0])
    cols = [logp[0, :, :1]]
    if S > 1:
        cols.append(torch.where(lengths[:, None] > 0, first[:, 1:2], neg))
    if S > 2:
        cols.append(neg.expand(N, S - 2))
    alpha = torch.cat(cols, dim=1)
    pad1, pad2 = neg.expand(N, 1), neg.expand(N, 2)
    for t in range(1, T):
        prev1 = torch.cat([pad1, alpha[:, :-1]], dim=1)
        prev2 = torch.where(skip_ok, torch.cat([pad2, alpha[:, :-2]], dim=1),
                            neg)
        tot = _logaddexp(_logaddexp(alpha, prev1), prev2)
        alpha = torch.where(s_valid, tot + emit_at(logp[t]), neg)
    last = (2 * lengths).to(torch.int64)[:, None]
    a_last = torch.gather(alpha, 1, last)[:, 0]
    a_prev = torch.where(lengths > 0,
                         torch.gather(alpha, 1, (last - 1).clamp_min(0))[:, 0],
                         neg)
    return -_logaddexp(a_last, a_prev)


ctc_loss._input_names = ["data", "label"]
