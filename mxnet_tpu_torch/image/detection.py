"""Detection-aware augmentation + iterator.

Reference surface: ``python/mxnet/image/detection.py`` (941 LoC:
``DetAugmenter``, ``DetBorrowAug``, ``DetRandomSelectAug``,
``DetHorizontalFlipAug``, ``DetRandomCropAug``, ``DetRandomPadAug``,
``CreateDetAugmenter``, ``ImageDetIter``) and the C++ record iterator
``src/io/iter_image_det_recordio.cc:581`` (ImageDetRecordIter).

Labels ride with the image through every geometric transform: each label
is (O, 5+) rows ``[cls, x1, y1, x2, y2, ...]`` with corners normalized to
[0, 1]; cls = -1 marks padding rows. Like the classification pipeline this
is host-side numpy feeding the device; the port's copy of the reference
package's ``image/detection.py``, its arrays host NDArrays.
"""
from __future__ import annotations

import json
import random as pyrandom
from typing import List

import numpy as np

from .. import io as io_mod
from ..recordio import MXRecordIO, unpack
from .image import (Augmenter, CastAug, ColorJitterAug, ColorNormalizeAug,
                    HueJitterAug, LightingAug, RandomGrayAug, ResizeAug,
                    ForceResizeAug, _nd, _to_np, imdecode, imread)

__all__ = [
    "DetAugmenter", "DetBorrowAug", "DetRandomSelectAug",
    "DetHorizontalFlipAug", "DetRandomCropAug", "DetRandomPadAug",
    "CreateDetAugmenter", "ImageDetIter", "ImageDetRecordIter",
]


def _box_coverage(boxes, crop):
    """Fraction of each (O, 4) corner box covered by the crop window —
    intersection / box area (the reference's min_object_covered measure,
    NOT IoU: a crop fully containing a small object scores 1.0)."""
    lt = np.maximum(boxes[:, :2], crop[:2])
    rb = np.minimum(boxes[:, 2:], crop[2:])
    wh = np.maximum(rb - lt, 0)
    inter = wh[:, 0] * wh[:, 1]
    area_b = np.maximum(boxes[:, 2] - boxes[:, 0], 0) * \
        np.maximum(boxes[:, 3] - boxes[:, 1], 0)
    return np.where(area_b > 0, inter / np.maximum(area_b, 1e-12), 0.0)


class DetAugmenter(object):
    """Detection augmenter: ``__call__(src, label) -> (src, label)``
    (reference: detection.py DetAugmenter)."""

    def __init__(self, **kwargs):
        self._kwargs = kwargs

    def dumps(self):
        return json.dumps([self.__class__.__name__, self._kwargs])

    def __call__(self, src, label):
        raise NotImplementedError


class DetBorrowAug(DetAugmenter):
    """Lift an image-only Augmenter into the detection pipeline —
    photometric transforms don't move boxes (reference:
    detection.py DetBorrowAug)."""

    def __init__(self, augmenter):
        if not isinstance(augmenter, Augmenter):
            raise TypeError("DetBorrowAug needs an image Augmenter")
        super().__init__(augmenter=augmenter.dumps())
        self.augmenter = augmenter

    def __call__(self, src, label):
        return self.augmenter(src), label


class DetRandomSelectAug(DetAugmenter):
    """Randomly pick one of several augmenters (or skip) (reference:
    detection.py DetRandomSelectAug)."""

    def __init__(self, aug_list, skip_prob=0.0):
        super().__init__(skip_prob=skip_prob)
        self.aug_list = list(aug_list)
        self.skip_prob = skip_prob

    def __call__(self, src, label):
        if pyrandom.random() < self.skip_prob or not self.aug_list:
            return src, label
        return pyrandom.choice(self.aug_list)(src, label)


class DetHorizontalFlipAug(DetAugmenter):
    """Mirror the image AND the box x-coordinates (reference:
    detection.py DetHorizontalFlipAug)."""

    def __init__(self, p):
        super().__init__(p=p)
        self.p = p

    def __call__(self, src, label):
        if pyrandom.random() < self.p:
            img = _to_np(src)
            src = _nd(np.ascontiguousarray(img[:, ::-1]),
                           dtype=img.dtype)
            label = label.copy()
            valid = label[:, 0] >= 0
            x1 = label[:, 1].copy()
            label[valid, 1] = 1.0 - label[valid, 3]
            label[valid, 3] = 1.0 - x1[valid]
        return src, label


class DetRandomCropAug(DetAugmenter):
    """Random crop with a min-IoU constraint against the ground truths;
    boxes are clipped to the crop, fully-escaped boxes are dropped
    (reference: detection.py DetRandomCropAug — the SSD sampling scheme)."""

    def __init__(self, min_object_covered=0.1, aspect_ratio_range=(0.75,
                 1.33), area_range=(0.05, 1.0), max_attempts=50):
        super().__init__(min_object_covered=min_object_covered,
                         aspect_ratio_range=aspect_ratio_range,
                         area_range=area_range, max_attempts=max_attempts)
        self.min_object_covered = min_object_covered
        self.aspect_ratio_range = aspect_ratio_range
        self.area_range = area_range
        self.max_attempts = max_attempts

    def _crop_label(self, label, crop):
        """Clip boxes to a normalized crop window, renormalize, drop
        escapees."""
        x0, y0, x1, y1 = crop
        w, h = x1 - x0, y1 - y0
        out = label.copy()
        valid = out[:, 0] >= 0
        b = out[:, 1:5]
        b = np.stack([np.clip(b[:, 0], x0, x1), np.clip(b[:, 1], y0, y1),
                      np.clip(b[:, 2], x0, x1), np.clip(b[:, 3], y0, y1)],
                     axis=1)
        area = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
        keep = valid & (area > 1e-8)
        out[:, 1:5] = np.stack([(b[:, 0] - x0) / w, (b[:, 1] - y0) / h,
                                (b[:, 2] - x0) / w, (b[:, 3] - y0) / h],
                               axis=1)
        out[~keep, 0] = -1.0
        return out, keep.sum()

    def __call__(self, src, label):
        img = _to_np(src)
        h, w = img.shape[:2]
        valid = label[label[:, 0] >= 0]
        for _ in range(self.max_attempts):
            area = pyrandom.uniform(*self.area_range)
            aspect = pyrandom.uniform(*self.aspect_ratio_range)
            cw = min(np.sqrt(area * aspect), 1.0)
            ch = min(np.sqrt(area / aspect), 1.0)
            cx = pyrandom.uniform(0, 1.0 - cw)
            cy = pyrandom.uniform(0, 1.0 - ch)
            crop = np.array([cx, cy, cx + cw, cy + ch], np.float32)
            if len(valid):
                cov = _box_coverage(valid[:, 1:5], crop)
                if cov.max() < self.min_object_covered:
                    continue
            new_label, kept = self._crop_label(label, crop)
            if len(valid) and kept == 0:
                continue
            x0p, y0p = int(cx * w), int(cy * h)
            wp, hp = max(int(cw * w), 1), max(int(ch * h), 1)
            out = img[y0p:y0p + hp, x0p:x0p + wp]
            return _nd(out, dtype=img.dtype), new_label
        return src, label


class DetRandomPadAug(DetAugmenter):
    """Pad to a random larger canvas (zoom out); boxes shrink accordingly
    (reference: detection.py DetRandomPadAug)."""

    def __init__(self, aspect_ratio_range=(0.75, 1.33),
                 area_range=(1.0, 3.0), max_attempts=50,
                 pad_val=(127, 127, 127)):
        super().__init__(aspect_ratio_range=aspect_ratio_range,
                         area_range=area_range, max_attempts=max_attempts,
                         pad_val=pad_val)
        self.aspect_ratio_range = aspect_ratio_range
        self.area_range = area_range
        self.max_attempts = max_attempts
        self.pad_val = np.asarray(pad_val, np.float32)

    def __call__(self, src, label):
        img = _to_np(src)
        h, w = img.shape[:2]
        new_w = new_h = 0
        for _ in range(self.max_attempts):
            scale = pyrandom.uniform(*self.area_range)
            aspect = pyrandom.uniform(*self.aspect_ratio_range)
            cand_w = int(w * np.sqrt(scale * aspect))
            cand_h = int(h * np.sqrt(scale / aspect))
            if cand_w >= w and cand_h >= h and (cand_w > w or cand_h > h):
                new_w, new_h = cand_w, cand_h
                break
        if not new_w:
            return src, label
        x0 = pyrandom.randint(0, new_w - w)
        y0 = pyrandom.randint(0, new_h - h)
        canvas = np.empty((new_h, new_w, img.shape[2]), img.dtype)
        canvas[:] = self.pad_val.astype(img.dtype)
        canvas[y0:y0 + h, x0:x0 + w] = img
        label = label.copy()
        valid = label[:, 0] >= 0
        sx, sy = w / new_w, h / new_h
        ox, oy = x0 / new_w, y0 / new_h
        label[valid, 1] = label[valid, 1] * sx + ox
        label[valid, 3] = label[valid, 3] * sx + ox
        label[valid, 2] = label[valid, 2] * sy + oy
        label[valid, 4] = label[valid, 4] * sy + oy
        return _nd(canvas, dtype=img.dtype), label


def CreateDetAugmenter(data_shape, resize=0, rand_crop=0, rand_pad=0,
                       rand_gray=0, rand_mirror=False, mean=None, std=None,
                       brightness=0, contrast=0, saturation=0, pca_noise=0,
                       hue=0, inter_method=2,
                       min_object_covered=0.1,
                       aspect_ratio_range=(0.75, 1.33),
                       area_range=(0.05, 3.0), max_attempts=50,
                       pad_val=(127, 127, 127)):
    """Standard detection augmenter list (reference:
    detection.py CreateDetAugmenter — same knobs/ordering: resize, crop,
    pad, color, mirror, force-resize to data_shape, cast, normalize)."""
    auglist: List[DetAugmenter] = []
    if resize > 0:
        auglist.append(DetBorrowAug(ResizeAug(resize, inter_method)))
    if rand_crop > 0:
        crop = DetRandomCropAug(min_object_covered,
                                aspect_ratio_range,
                                (area_range[0], min(area_range[1], 1.0)),
                                max_attempts)
        auglist.append(DetRandomSelectAug([crop], 1 - rand_crop))
    if rand_pad > 0:
        pad = DetRandomPadAug(aspect_ratio_range,
                              (max(area_range[0], 1.0), area_range[1]),
                              max_attempts, pad_val)
        auglist.append(DetRandomSelectAug([pad], 1 - rand_pad))
    if rand_mirror:
        auglist.append(DetHorizontalFlipAug(0.5))
    # detection needs exact output size; aspect is already randomized
    auglist.append(DetBorrowAug(ForceResizeAug((data_shape[2],
                                                data_shape[1]),
                                               inter_method)))
    auglist.append(DetBorrowAug(CastAug()))
    if brightness or contrast or saturation:
        auglist.append(DetBorrowAug(ColorJitterAug(brightness, contrast,
                                                   saturation)))
    if hue:
        auglist.append(DetBorrowAug(HueJitterAug(hue)))
    if pca_noise > 0:
        eigval = np.array([55.46, 4.794, 1.148])
        eigvec = np.array([[-0.5675, 0.7192, 0.4009],
                           [-0.5808, -0.0045, -0.8140],
                           [-0.5836, -0.6948, 0.4203]])
        auglist.append(DetBorrowAug(LightingAug(pca_noise, eigval, eigvec)))
    if rand_gray > 0:
        auglist.append(DetBorrowAug(RandomGrayAug(rand_gray)))
    if mean is True:
        mean = np.array([123.68, 116.28, 103.53])
    if std is True:
        std = np.array([58.395, 57.12, 57.375])
    if mean is not None:
        auglist.append(DetBorrowAug(ColorNormalizeAug(mean, std)))
    return auglist


class ImageDetIter(io_mod.DataIter):
    """Detection batch iterator (reference: detection.py ImageDetIter +
    src/io/iter_image_det_recordio.cc:581).

    Sources: ``path_imgrec`` (.rec packed with ``pack_label`` headers) or
    ``imglist`` entries ``[label_rows_flat..., path]``. Labels are padded
    to the max object count: batch label (N, O, 5) with cls=-1 padding.
    """

    def __init__(self, batch_size, data_shape, path_imgrec=None,
                 imglist=None, shuffle=False, aug_list=None,
                 data_name="data", label_name="label", object_width=5,
                 **kwargs):
        super().__init__(batch_size)
        self.data_shape = tuple(data_shape)
        self._data_name = data_name
        self._label_name = label_name
        self._shuffle = shuffle
        self._ow = object_width

        # labels + record offsets only — image bytes stream from disk
        # (the offset-index pattern of io/image_record.py)
        self._records = []
        self._rec = None
        if path_imgrec is not None:
            self._rec = MXRecordIO(path_imgrec, "r")
            while True:
                pos = self._rec.tell()
                buf = self._rec.read()
                if buf is None:
                    break
                header, _ = unpack(buf)
                label = np.asarray(header.label, np.float32)
                self._records.append((self._parse_label(label), pos))
        elif imglist is not None:
            for entry in imglist:
                label = np.asarray(entry[:-1], np.float32)
                self._records.append((self._parse_label(label), entry[-1]))
        else:
            raise ValueError("ImageDetIter needs path_imgrec or imglist")
        if not self._records:
            raise ValueError("empty detection dataset")

        self.max_objects = max(lbl.shape[0] for lbl, _ in self._records)
        self.auglist = aug_list if aug_list is not None else \
            CreateDetAugmenter(data_shape, **kwargs)
        self._order = np.arange(len(self._records))
        self.cur = 0
        self.reset()

    def _parse_label(self, flat):
        """Flat label -> (O, object_width). Accepts either raw rows or the
        det-record header form [header_width, object_width, extras...,
        rows...] used by tools/im2rec detection lists (reference:
        detection.py _parse_label reads header_width = int(raw[0])
        generically)."""
        flat = np.asarray(flat, np.float32).ravel()
        ow = self._ow
        if flat.size >= 2:
            hw, how = int(flat[0]), int(flat[1])
            # a header iff the declared widths are integral, plausible, and
            # consistent with the payload length (coordinates are
            # normalized <1, so real box rows can't satisfy this)
            if float(flat[0]) == hw and float(flat[1]) == how and \
                    2 <= hw <= flat.size and how >= 5 and \
                    (flat.size - hw) % how == 0:
                ow = how
                flat = flat[hw:]
        self._ow = max(self._ow, ow)       # batch layout follows the widest
        n = flat.size // ow
        return flat[:n * ow].reshape(n, ow).copy()

    @property
    def provide_data(self):
        return [io_mod.DataDesc(self._data_name,
                                (self.batch_size,) + self.data_shape,
                                np.float32)]

    @property
    def provide_label(self):
        return [io_mod.DataDesc(
            self._label_name,
            (self.batch_size, self.max_objects, self._ow), np.float32)]

    def reset(self):
        if self._shuffle:
            np.random.shuffle(self._order)
        self.cur = 0

    def next(self):
        c, h, w = self.data_shape
        O = self.max_objects
        batch_data = np.zeros((self.batch_size, c, h, w), np.float32)
        batch_label = np.full((self.batch_size, O, self._ow), -1.0,
                              np.float32)
        i = 0
        pad = 0
        while i < self.batch_size:
            if self.cur >= len(self._records):
                if i == 0:
                    raise StopIteration
                pad = self.batch_size - i
                for j in range(i, self.batch_size):
                    batch_data[j] = batch_data[j - i]
                    batch_label[j] = batch_label[j - i]
                break
            label, src = self._records[self._order[self.cur]]
            self.cur += 1
            if isinstance(src, (int, np.integer)):
                self._rec.handle.seek(src)
                _, img_bytes = unpack(self._rec.read())
                img = imdecode(img_bytes)
            else:
                img = imread(src)
            label = label.copy()
            for aug in self.auglist:
                img, label = aug(img, label) \
                    if isinstance(aug, DetAugmenter) else (aug(img), label)
            arr = _to_np(img).astype(np.float32)
            batch_data[i] = arr.transpose(2, 0, 1)
            batch_label[i, :label.shape[0]] = label[:O]
            i += 1
        return io_mod.DataBatch(
            data=[_nd(batch_data)], label=[_nd(batch_label)],
            pad=pad, provide_data=self.provide_data,
            provide_label=self.provide_label)


def ImageDetRecordIter(path_imgrec, data_shape, batch_size, shuffle=False,
                       **kwargs):
    """Record-file detection iterator — the C++ ImageDetRecordIter's
    surface (src/io/iter_image_det_recordio.cc:581) as a thin constructor
    over :class:`ImageDetIter`."""
    return ImageDetIter(batch_size=batch_size, data_shape=data_shape,
                        path_imgrec=path_imgrec, shuffle=shuffle, **kwargs)
