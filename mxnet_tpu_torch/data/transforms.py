"""Record decoders for the streaming data plane.

A transform is any picklable callable ``raw_record_bytes ->
(data_ndarray, label_ndarray)`` — picklable because worker PROCESSES
receive it (top-level classes with plain attributes, never closures).
The stock ones cover the two shapes the tests and benches need:

* :class:`RawTransform` — float32 payload + IRHeader label, the exact
  format ``im2rec``-style float datasets and the determinism tests use.
* :class:`ImageTransform` — JPEG/PNG decode + resize + HWC->CHW, with
  the native library (libjpeg / libpng, :mod:`..native`) unless
  ``MXNET_USE_NATIVE_IO=0`` selects the reference's cv2 decode (a
  missing cv2 then raises; the reference's PIL fallback is not kept, so
  no other decoder is ever swapped in): a forked worker decodes with
  numpy and the native library only. The two decoders agree within one
  level where the resize interpolates.
* :class:`StallTransform` — wraps another transform with a fixed
  per-record stall, emulating remote-storage fetch latency; the bench
  uses it to model IO-bound decode honestly on small CI hosts, and the
  straggler regression drill uses it to build a "healthy rank, slow
  loader" shape.
"""
from __future__ import annotations

import time

import numpy as np

from .. import recordio as _recordio
from ..base import MXNetError

__all__ = ["RawTransform", "ImageTransform", "StallTransform"]


def _shape_label(label, width: int) -> np.ndarray:
    """IRHeader label -> float32 array: scalar-shaped for ``width=1``
    (batches stack to ``(B,)``, matching NDArrayIter and what
    SoftmaxOutput/LinearRegressionOutput infer shapes from), a
    ``(width,)`` vector otherwise (padded/truncated)."""
    lab = np.asarray(label, dtype=np.float32).reshape(-1)
    if lab.size < width:
        lab = np.pad(lab, (0, width - lab.size))
    if width == 1:
        return np.float32(lab[0])
    return lab[:width].copy()


class RawTransform(object):
    """Unpack ``recordio.pack`` records: float32 payload reshaped to
    ``data_shape``, the IRHeader label as a float32 vector of
    ``label_width`` (scalar-shaped when 1, so batches stack to the
    ``(B,)`` labels NDArrayIter and the loss heads expect)."""

    def __init__(self, data_shape, label_width: int = 1):
        self.data_shape = tuple(int(d) for d in data_shape)
        self.label_width = int(label_width)

    def __call__(self, raw: bytes):
        header, payload = _recordio.unpack(raw)
        data = np.frombuffer(payload, dtype=np.float32).reshape(
            self.data_shape).copy()
        return data, _shape_label(header.label, self.label_width)


class ImageTransform(object):
    """JPEG/PNG decode + resize to ``data_shape=(C, H, W)`` float32 —
    the minimal twin of ``ImageRecordIter``'s decode/augment stage for
    the multi-process path (mean/scale only; heavier augmentation
    composes as another transform)."""

    def __init__(self, data_shape=(3, 224, 224), label_width: int = 1,
                 mean: float = 0.0, scale: float = 1.0):
        self.data_shape = tuple(int(d) for d in data_shape)
        self.label_width = int(label_width)
        self.mean = float(mean)
        self.scale = float(scale)

    def _decode(self, buf: bytes) -> np.ndarray:
        c, h, w = self.data_shape
        from .. import native
        if native.enabled():
            img = native.decode(buf, 3 if c == 3 else 1)
            if img.shape[:2] != (h, w):
                img = native.resize(img, h, w)
            return img
        try:
            import cv2
        except ImportError as exc:
            raise MXNetError(
                "ImageTransform: MXNET_USE_NATIVE_IO=0 selects the cv2 "
                "decoder, and cv2 does not import (%s); install "
                "opencv-python or leave MXNET_USE_NATIVE_IO on" % exc) \
                from exc
        flag = cv2.IMREAD_COLOR if c == 3 else cv2.IMREAD_GRAYSCALE
        img = cv2.imdecode(np.frombuffer(buf, dtype=np.uint8), flag)
        if img is None:
            raise ValueError("cv2.imdecode returned None")
        if (img.shape[1], img.shape[0]) != (w, h):
            img = cv2.resize(img, (w, h), interpolation=cv2.INTER_LINEAR)
        if c == 3:
            img = cv2.cvtColor(img, cv2.COLOR_BGR2RGB)
        if img.ndim == 2:
            img = img[:, :, None]
        return img

    def __call__(self, raw: bytes):
        header, payload = _recordio.unpack(raw)
        img = self._decode(payload).astype(np.float32)
        img = (img - self.mean) * self.scale
        data = np.transpose(img, (2, 0, 1))          # HWC -> CHW
        return data, _shape_label(header.label, self.label_width)


class StallTransform(object):
    """``inner`` plus a fixed per-record stall — deterministic latency
    emulation (remote storage fetch, slow decoder). Test/bench-only."""

    def __init__(self, inner, stall_s: float):
        self.inner = inner
        self.stall_s = float(stall_s)

    def __call__(self, raw: bytes):
        if self.stall_s > 0:
            time.sleep(self.stall_s)
        return self.inner(raw)
