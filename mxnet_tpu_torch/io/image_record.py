"""ImageRecordIter — RecordIO image pipeline.

Reference: ``src/io/iter_image_recordio_2.cc:577`` (ImageRecordIter) =
record parser -> augmenter (image_aug_default.cc: resize/crop/mirror) ->
normalize (mean/std/scale) -> BatchLoader (iter_batchloader.h:41) ->
prefetcher (iter_prefetcher.h:46). Here: a pool of decode worker threads
feeding a bounded batch queue (the v2 iterator's fused thread pool,
iter_image_recordio_2.cc:513-566).

The port's copy of the reference package's ``io/image_record.py``. With
the native library (``MXNET_USE_NATIVE_IO``, on by default) the standard
crop / mirror / mean-std path runs in its C++ pipeline; a failed build
raises there (:mod:`..native`) instead of falling back. Custom augmenter
lists, ``mean_img`` files, random scales and ``MXNET_USE_NATIVE_IO=0``
take the Python/cv2 path. The Python path decodes in its worker threads,
draws each record's crop and mirror in the producer thread in record
order, and crops and normalizes in the workers again, so its stream
does not depend on ``preprocess_threads`` (the reference draws in the
workers, and equals this only with one thread). Both draw the epoch
order from
``np.random.RandomState(seed)``, and the native pipeline draws each
record's crop and mirror from ``(seed, epoch, position)``, so the two
packages' batches over one ``.rec`` are bit-identical. Batches are host
NDArrays; ``fit``'s device-prefetch stage copies them to the card.
"""
from __future__ import annotations

import queue
import threading
import time
from typing import List, Optional

import numpy as np

from .. import lockcheck as _lockcheck
from .. import ndarray as nd
from ..base import MXNetError
from ..context import cpu
from ..recordio import MXRecordIO, unpack_img
from .io import DataBatch, DataDesc, DataIter

__all__ = ["ImageRecordIter", "ImageRecordUInt8Iter", "imdecode", "imread"]


def imdecode(buf, flag=1, to_rgb=True):
    """Decode an encoded image buffer to an HWC uint8 host NDArray
    (reference: src/io/image_io.cc imdecode — same (buf, flag, to_rgb)
    order)."""
    import cv2
    arr = np.frombuffer(buf, dtype=np.uint8) \
        if isinstance(buf, (bytes, bytearray)) else np.asarray(buf, np.uint8)
    img = cv2.imdecode(arr, cv2.IMREAD_COLOR if flag else
                       cv2.IMREAD_GRAYSCALE)
    if img is None:
        raise ValueError("imdecode: cannot decode buffer")
    if flag and to_rgb:
        img = cv2.cvtColor(img, cv2.COLOR_BGR2RGB)
    if img.ndim == 2:
        img = img[:, :, None]
    return nd.array(img, ctx=cpu(), dtype=np.uint8)


def imread(filename, flag=1, to_rgb=True):
    """Read + decode an image file (reference: plugin/opencv cv_api.cc)."""
    with open(filename, "rb") as f:
        return imdecode(f.read(), flag=flag, to_rgb=to_rgb)


class ImageRecordIter(DataIter):
    """(reference: src/io/iter_image_recordio_2.cc:577; parameter names match
    the reference's ImageRecParserParam/ImageRecordParam/ImageNormalizeParam
    so reference training CLIs run unchanged)."""

    def __init__(self, path_imgrec: str, data_shape, batch_size: int,
                 path_imgidx: Optional[str] = None, label_width: int = 1,
                 shuffle: bool = False, rand_crop: bool = False,
                 rand_mirror: bool = False, resize: int = -1,
                 mean_img: Optional[str] = None, mean_r: float = 0.0,
                 mean_g: float = 0.0, mean_b: float = 0.0,
                 std_r: float = 1.0, std_g: float = 1.0, std_b: float = 1.0,
                 scale: float = 1.0, max_random_scale: float = 1.0,
                 min_random_scale: float = 1.0, seed: int = 0,
                 preprocess_threads: Optional[int] = None,
                 prefetch_buffer: Optional[int] = None,
                 round_batch: bool = True, data_name: str = "data",
                 label_name: str = "softmax_label", dtype="float32",
                 silent: bool = False, aug_list=None,
                 num_parts: int = 1, part_index: int = 0, **kwargs):
        super().__init__(batch_size)
        # distributed data sharding (reference: ImageRecParserParam
        # kNumParts/kPartIndex): worker part_index of num_parts reads
        # every num_parts-th record; num_data reports the shard size
        self._num_parts = max(int(num_parts), 1)
        self._part_index = int(part_index)
        if not 0 <= self._part_index < self._num_parts:
            raise ValueError("part_index %d not in [0, num_parts=%d)"
                             % (self._part_index, self._num_parts))
        self.data_shape = tuple(int(x) for x in data_shape)
        self.label_width = label_width
        self._dtype = np.dtype(dtype)
        self._params = dict(
            rand_crop=rand_crop, rand_mirror=rand_mirror, resize=resize,
            mean=np.array([mean_r, mean_g, mean_b], np.float32),
            std=np.array([std_r, std_g, std_b], np.float32),
            scale=scale)
        if mean_img is not None:
            try:
                self._params["mean_arr"] = \
                    nd.load(mean_img)["mean_img"].asnumpy()
            except Exception:
                self._params["mean_arr"] = None
        self._rng = np.random.RandomState(seed)
        self._aug_list = aug_list      # mx.image Augmenter pipeline override
        self._path = path_imgrec

        from .. import config as _config
        if preprocess_threads is None:
            preprocess_threads = _config.get("MXNET_CPU_WORKER_NTHREADS")
        if prefetch_buffer is None:
            prefetch_buffer = _config.get("MXNET_PREFETCH_BUFFER")
        self._n_threads = max(1, int(preprocess_threads))
        self._prefetch = max(2, int(prefetch_buffer))
        self._shuffle = shuffle
        self._round_batch = bool(round_batch)

        # Native C++ pipeline (native/: RecordIO mmap reader +
        # libjpeg/libpng decode + threaded augment/batch workers) handles
        # the standard crop/mirror/mean-std path entirely off the Python
        # thread; custom Augmenter pipelines and mean_img files take the
        # Python/cv2 path below, as does MXNET_USE_NATIVE_IO=0. A native
        # library that cannot build raises (native.lib).
        from .. import native
        self._native = None
        if (native.enabled() and aug_list is None
                and self._params.get("mean_arr") is None
                and max_random_scale == 1.0 and min_random_scale == 1.0
                and self.data_shape[0] in (1, 3)):
            self._native = _NativePipe(self, seed)
        if self._native is not None:
            self._order = np.arange(self._native.count)[
                self._part_index::self._num_parts]
            self._native.start_epoch(self._epoch_order())
            return

        # ---- pure-Python fallback path ----
        # index the record offsets once so shuffle is a permutation of offsets
        self._offsets: List[int] = []
        rec = MXRecordIO(path_imgrec, "r")
        while True:
            pos = rec.tell()
            buf = rec.read()
            if buf is None:
                break
            self._offsets.append(pos)
        rec.close()
        self._order = np.arange(len(self._offsets))[
            self._part_index::self._num_parts]
        self._epoch_queue: "queue.Queue" = queue.Queue()
        self._batch_queue: "queue.Queue" = queue.Queue(maxsize=self._prefetch)
        self._lock = _lockcheck.Lock(name="io.image_record_lock")
        self._cursor = 0
        self._alive = True
        self._loader = threading.Thread(target=self._produce, daemon=True)
        self._reset_evt = threading.Event()
        self._reset_evt.set()
        self._loader.start()

    def _epoch_order(self):
        order = self._order.copy()
        if self._shuffle:
            self._rng.shuffle(order)
        return order

    @property
    def num_data(self) -> int:
        """Number of records in the dataset (both pipeline backends)."""
        return len(self._order)

    # ------------------------------------------------------------ pipeline
    def _decode(self, buf: bytes):
        """Stage 1 (any worker thread): unpack and decode one record,
        then the short-side resize and the upscale to the crop window;
        with ``aug_list``, the whole augmenter pipeline."""
        import cv2
        header, img = self._unpack(buf)
        if self._aug_list is not None:
            # composable image.Augmenter pipeline replaces the built-in
            # crop/mirror/normalize params (reference: ImageIter aug_list)
            if img.ndim == 2:
                img = img[:, :, None]
            out = np.ascontiguousarray(img[:, :, ::-1])   # BGR -> RGB
            for aug in self._aug_list:
                out = aug(out)
            if hasattr(out, "asnumpy"):
                out = out.asnumpy()
            arr = np.asarray(out, np.float32)
            c, th, tw = self.data_shape
            if arr.shape[:2] != (th, tw):
                raise ValueError(
                    "aug_list produced image of shape %s, data_shape wants "
                    "%dx%d — add a crop/resize augmenter"
                    % (arr.shape, th, tw))
            return arr.transpose(2, 0, 1), self._label_of(header)
        p = self._params
        if p["resize"] > 0:
            h, w = img.shape[:2]
            if h < w:
                nh, nw = p["resize"], int(w * p["resize"] / h)
            else:
                nh, nw = int(h * p["resize"] / w), p["resize"]
            img = cv2.resize(img, (nw, nh))
        c, th, tw = self.data_shape
        h, w = img.shape[:2]
        if h < th or w < tw:
            img = cv2.resize(img, (max(tw, w), max(th, h)))
        return img, self._label_of(header)

    def _draw(self, img):
        """Stage 2 (the producer thread, in record order): the crop's
        corner and the mirror coin, from the iterator's RandomState in
        the reference's order, so the stream does not depend on the
        thread count (and equals the reference's single-thread one)."""
        p = self._params
        c, th, tw = self.data_shape
        h, w = img.shape[:2]
        if p["rand_crop"]:
            y = self._rng.randint(0, h - th + 1)
            x = self._rng.randint(0, w - tw + 1)
        else:
            y, x = (h - th) // 2, (w - tw) // 2
        mirror = bool(p["rand_mirror"] and self._rng.rand() < 0.5)
        return y, x, mirror

    def _augment(self, img, y, x, mirror):
        """Stage 3 (any worker thread): crop, mirror, RGB, mean / std /
        scale, HWC -> CHW."""
        p = self._params
        c, th, tw = self.data_shape
        img = img[y:y + th, x:x + tw]
        if mirror:
            img = img[:, ::-1]
        img = img.astype(np.float32)
        if img.ndim == 2:
            img = img[:, :, None]
        img = img[:, :, ::-1]  # BGR (cv2) -> RGB, matching the reference
        if p.get("mean_arr") is not None:
            img = img - p["mean_arr"].reshape(img.shape)
        elif p["mean"].any():
            img = img - p["mean"]
        if (p["std"] != 1.0).any():
            img = img / p["std"]
        if p["scale"] != 1.0:
            img = img * p["scale"]
        return img.transpose(2, 0, 1)  # HWC -> CHW

    def _decode_batch(self, pool, bufs):
        """One batch through the three stages: (images, labels)."""
        decoded = [f.result() for f in
                   [pool.submit(self._decode, b) for b in bufs]]
        if self._aug_list is not None:
            return zip(*decoded)
        draws = [self._draw(img) for img, _ in decoded]
        futures = [pool.submit(self._augment, img, *d)
                   for (img, _), d in zip(decoded, draws)]
        return [f.result() for f in futures], [lab for _, lab in decoded]

    def _label_of(self, header):
        label = header.label
        if isinstance(label, np.ndarray):
            label = label[:self.label_width] if self.label_width > 1 \
                else float(label[0])
        return label

    @staticmethod
    def _unpack(buf):
        return unpack_img(buf)

    def _produce(self):
        """Loader thread: stream records, decode via worker pool, emit
        batches in order."""
        from concurrent.futures import ThreadPoolExecutor
        pool = ThreadPoolExecutor(max_workers=self._n_threads)
        while self._alive:
            self._reset_evt.wait()
            if not self._alive:
                break
            self._reset_evt.clear()
            try:
                self._produce_epoch(pool)
            except Exception as exc:   # surface to the consumer, don't hang
                if self._alive:
                    self._batch_queue.put(("error", exc, None, 0))

    def _produce_epoch(self, pool):
        order = self._epoch_order()
        rec = MXRecordIO(self._path, "r")
        bufs = []
        # stream sequentially; shuffled access uses offsets
        for i in order:
            rec.handle.seek(self._offsets[i])
            b = rec.read()
            if b is not None:
                bufs.append(b)
            if len(bufs) == self.batch_size:
                imgs, labels = self._decode_batch(pool, bufs)
                if not self._alive:
                    break
                self._batch_queue.put(("data", np.stack(imgs),
                                       np.asarray(labels, np.float32), 0))
                bufs = []
        rec.close()
        if bufs and self._alive and self._round_batch:
            pad = self.batch_size - len(bufs)
            imgs, labels = self._decode_batch(pool, bufs)
            imgs = list(imgs) + [imgs[-1]] * pad
            labels = list(labels) + [labels[-1]] * pad
            self._batch_queue.put(("data", np.stack(imgs),
                                   np.asarray(labels, np.float32), pad))
        if self._alive:
            self._batch_queue.put(("stop", None, None, 0))

    # ------------------------------------------------------------ DataIter
    @property
    def provide_data(self):
        return [DataDesc("data", (self.batch_size,) + self.data_shape,
                         self._dtype)]

    @property
    def provide_label(self):
        shape = (self.batch_size,) if self.label_width == 1 else \
            (self.batch_size, self.label_width)
        return [DataDesc("softmax_label", shape, np.float32)]

    def reset(self):
        if self._native is not None:
            self._native.start_epoch(self._epoch_order())
            return
        while True:
            try:
                self._batch_queue.get_nowait()
            except queue.Empty:
                break
        self._reset_evt.set()

    def next(self):
        if self._native is not None:
            imgs, labels, pad = self._native.next()   # raises StopIteration
            if self.label_width == 1:
                labels = labels[:, 0]
            return DataBatch(data=[nd.array(imgs.astype(self._dtype,
                                                        copy=False),
                                            ctx=cpu(), dtype=self._dtype)],
                             label=[nd.array(labels, ctx=cpu())], pad=pad,
                             provide_data=self.provide_data,
                             provide_label=self.provide_label)
        kind, imgs, labels, pad = self._batch_queue.get()
        if kind == "error":
            raise imgs                # exception from the loader thread
        if kind == "stop":
            raise StopIteration
        return DataBatch(data=[nd.array(imgs.astype(self._dtype),
                                        ctx=cpu(), dtype=self._dtype)],
                         label=[nd.array(labels, ctx=cpu())], pad=pad,
                         provide_data=self.provide_data,
                         provide_label=self.provide_label)

    def iter_next(self):
        try:
            self._cached = self.next()
            return True
        except StopIteration:
            return False

    def close(self, join_timeout: float = 10.0) -> bool:
        """Stop the decode threads (idempotent); True when they are gone
        within ``join_timeout`` seconds. The iterator is dead after."""
        if getattr(self, "_native", None) is not None:
            self._native.close()
            return True
        if not hasattr(self, "_reset_evt"):
            return True
        self._alive = False
        self._reset_evt.set()
        deadline = time.monotonic() + join_timeout
        while self._loader.is_alive() and time.monotonic() < deadline:
            try:        # a producer blocked on the full queue moves on
                self._batch_queue.get_nowait()
            except queue.Empty:
                pass
            self._loader.join(timeout=0.05)
        return not self._loader.is_alive()

    def __del__(self):
        try:
            self.close(join_timeout=0.0)
        except Exception:                                  # noqa: BLE001
            pass


class _NativePipe:
    """ctypes wrapper around the libmxnative batch pipeline (one instance
    per ImageRecordIter; owns the reader + pipeline handles)."""

    def __init__(self, it: "ImageRecordIter", seed: int):
        import ctypes
        from .. import native
        self.handle = None
        self._rec = None
        lib = native.lib()
        rec = lib.mxrio_open(it._path.encode())
        if not rec:
            raise IOError("native pipeline: cannot open record file %s"
                          % it._path)
        self._lib = lib
        self._ct = ctypes
        self._rec = rec
        self.count = lib.mxrio_count(rec)
        p = it._params
        c, h, w = it.data_shape
        cfg = native.MXPipeConfig()
        cfg.batch_size = it.batch_size
        cfg.target_h, cfg.target_w, cfg.target_c = h, w, c
        cfg.label_width = it.label_width
        cfg.resize = int(p["resize"])
        cfg.rand_crop = int(bool(p["rand_crop"]))
        cfg.rand_mirror = int(bool(p["rand_mirror"]))
        cfg.mean[:] = [float(x) for x in p["mean"]]
        cfg.std_[:] = [float(x) for x in p["std"]]
        cfg.scale = float(p["scale"])
        cfg.seed = seed
        cfg.num_threads = it._n_threads
        cfg.queue_depth = it._prefetch
        cfg.round_batch = int(it._round_batch)
        self._shape = (it.batch_size, c, h, w)
        self._label_shape = (it.batch_size, it.label_width)
        self.handle = lib.mxpipe_create(rec, ctypes.byref(cfg))
        if not self.handle:
            self.handle = None
            self.close()
            raise MXNetError("native pipeline: mxpipe_create refused the "
                             "configuration (batch size %d)" % it.batch_size)

    def start_epoch(self, order):
        import numpy as _np
        ct = self._ct
        order = _np.ascontiguousarray(order, dtype=_np.int64)
        self._lib.mxpipe_start_epoch(
            self.handle, order.ctypes.data_as(ct.POINTER(ct.c_int64)),
            len(order))

    def next(self):
        import numpy as _np
        ct = self._ct
        data = _np.empty(self._shape, _np.float32)
        label = _np.empty(self._label_shape, _np.float32)
        pad = ct.c_int()
        rc = self._lib.mxpipe_next(
            self.handle, data.ctypes.data_as(ct.POINTER(ct.c_float)),
            label.ctypes.data_as(ct.POINTER(ct.c_float)), ct.byref(pad))
        if rc == 1:
            raise StopIteration
        if rc != 0:
            raise IOError("native pipeline: %s"
                          % self._lib.mxpipe_error(self.handle).decode())
        return data, label, pad.value

    def close(self):
        if self.handle:
            self._lib.mxpipe_close(self.handle)
            self.handle = None
        if self._rec:
            self._lib.mxrio_close(self._rec)
            self._rec = None


class ImageRecordUInt8Iter(ImageRecordIter):
    """uint8 output variant (reference: iter_image_recordio_2.cc:612)."""

    def __init__(self, *args, **kwargs):
        kwargs.setdefault("dtype", "uint8")
        super().__init__(*args, **kwargs)
