"""Image pipeline: decode, geometric/photometric transforms, composable
augmenters, and an in-memory/record-file image iterator.

Reference surface: ``python/mxnet/image/image.py`` (``resize_short:229``,
``fixed_crop:291``, ``random_crop:323``, ``center_crop:362``,
``color_normalize:411``, ``random_size_crop:435``, ``Augmenter:482``,
``CreateAugmenter:861``, ``ImageIter:975``).

The port's copy of the reference package's ``image/image.py``:
augmentation is host-side numpy (float32 HWC RGB) feeding the device,
as the reference's CPU decode/augment worker pool does; every array here
is a host NDArray, and the card sees only the final normalized NCHW
batch. The random draws are the reference's (Python's ``random`` and
numpy's global generator), so a seeded pipeline gives the reference's
arrays.
"""
from __future__ import annotations

import json
import os
import random as pyrandom
from typing import List

import numpy as np

from .. import io as io_mod
from .. import ndarray as nd
from ..context import cpu
from ..io.image_record import imdecode, imread  # noqa: F401  (re-export)
from ..recordio import MXRecordIO, unpack

__all__ = [
    "imdecode", "imread", "scale_down", "resize_short", "fixed_crop",
    "random_crop", "center_crop", "color_normalize", "random_size_crop",
    "Augmenter", "SequentialAug", "ResizeAug", "ForceResizeAug",
    "RandomCropAug", "RandomSizedCropAug", "CenterCropAug",
    "RandomOrderAug", "BrightnessJitterAug", "ContrastJitterAug",
    "SaturationJitterAug", "HueJitterAug", "ColorJitterAug", "LightingAug",
    "ColorNormalizeAug", "RandomGrayAug", "HorizontalFlipAug", "CastAug",
    "CreateAugmenter", "ImageIter",
]

# ITU-R BT.601 luma weights (RGB order) — the standard grayscale projection
_GRAY = np.array([0.299, 0.587, 0.114], np.float32)


def _nd(arr, dtype=None):
    """A host NDArray (an augmenter's result stays on the host)."""
    return nd.array(arr, ctx=cpu(), dtype=dtype)


def _to_np(img):
    if isinstance(img, nd.NDArray):
        return img.asnumpy()
    return np.asarray(img)


def _resize(img, w, h, interp=2):
    import cv2
    interps = {0: cv2.INTER_NEAREST, 1: cv2.INTER_LINEAR,
               2: cv2.INTER_AREA, 3: cv2.INTER_CUBIC,
               4: cv2.INTER_LANCZOS4}
    out = cv2.resize(_to_np(img), (int(w), int(h)),
                     interpolation=interps.get(int(interp),
                                               cv2.INTER_AREA))
    if out.ndim == 2:
        out = out[:, :, None]
    return out


def scale_down(src_size, size):
    """Shrink (w, h) to fit inside src (w, h) keeping aspect (reference:
    image.py:139)."""
    w, h = size
    sw, sh = src_size
    if sh < h:
        w, h = float(w * sh) / h, sh
    if sw < w:
        w, h = sw, float(h * sw) / w
    return int(w), int(h)


def resize_short(src, size, interp=2):
    """Resize so the SHORT side equals ``size`` (reference: image.py:229)."""
    img = _to_np(src)
    h, w = img.shape[:2]
    if h > w:
        new_w, new_h = size, int(h * size / w)
    else:
        new_w, new_h = int(w * size / h), size
    return _nd(_resize(img, new_w, new_h, interp), dtype=img.dtype)


def fixed_crop(src, x0, y0, w, h, size=None, interp=2):
    """Crop a fixed window, optionally resizing to ``size`` (w, h)
    (reference: image.py:291)."""
    img = _to_np(src)
    out = img[int(y0):int(y0) + int(h), int(x0):int(x0) + int(w)]
    if size is not None and (int(w), int(h)) != tuple(size):
        out = _resize(out, size[0], size[1], interp)
    return _nd(out, dtype=img.dtype)


def random_crop(src, size, interp=2):
    """Random position crop at target size (scaled down if the image is
    smaller); returns (img, (x0, y0, w, h)) (reference: image.py:323)."""
    img = _to_np(src)
    h, w = img.shape[:2]
    new_w, new_h = scale_down((w, h), size)
    x0 = pyrandom.randint(0, w - new_w)
    y0 = pyrandom.randint(0, h - new_h)
    out = fixed_crop(img, x0, y0, new_w, new_h, size, interp)
    return out, (x0, y0, new_w, new_h)


def center_crop(src, size, interp=2):
    """Center crop; returns (img, (x0, y0, w, h)) (reference:
    image.py:362)."""
    img = _to_np(src)
    h, w = img.shape[:2]
    new_w, new_h = scale_down((w, h), size)
    x0 = (w - new_w) // 2
    y0 = (h - new_h) // 2
    out = fixed_crop(img, x0, y0, new_w, new_h, size, interp)
    return out, (x0, y0, new_w, new_h)


def color_normalize(src, mean, std=None):
    """(src - mean) / std per channel (reference: image.py:411)."""
    img = _to_np(src).astype(np.float32)
    img = img - np.asarray(mean, np.float32)
    if std is not None:
        img = img / np.asarray(std, np.float32)
    return _nd(img)


def random_size_crop(src, size, min_area, ratio, interp=2):
    """Random area/aspect crop (Inception-style); returns
    (img, (x0, y0, w, h)) (reference: image.py:435)."""
    img = _to_np(src)
    h, w = img.shape[:2]
    area = h * w
    for _ in range(10):
        target_area = pyrandom.uniform(min_area, 1.0) * area
        log_ratio = (np.log(ratio[0]), np.log(ratio[1]))
        aspect = np.exp(pyrandom.uniform(*log_ratio))
        new_w = int(round(np.sqrt(target_area * aspect)))
        new_h = int(round(np.sqrt(target_area / aspect)))
        if new_w <= w and new_h <= h:
            x0 = pyrandom.randint(0, w - new_w)
            y0 = pyrandom.randint(0, h - new_h)
            out = fixed_crop(img, x0, y0, new_w, new_h, size, interp)
            return out, (x0, y0, new_w, new_h)
    return random_crop(img, size, interp)


# ---------------------------------------------------------------- augmenters


class Augmenter(object):
    """Composable image transform (reference: image.py:482). Subclasses
    implement ``__call__(src) -> src``; ``dumps`` serializes the config."""

    def __init__(self, **kwargs):
        self._kwargs = kwargs
        for k, v in kwargs.items():
            if isinstance(v, nd.NDArray):
                kwargs[k] = v.asnumpy().tolist()
            elif isinstance(v, np.ndarray):
                kwargs[k] = v.tolist()

    def dumps(self):
        return json.dumps([self.__class__.__name__, self._kwargs])

    def __call__(self, src):
        raise NotImplementedError


class SequentialAug(Augmenter):
    """Apply a list of augmenters in order (reference: gluon-era
    image.py SequentialAug)."""

    def __init__(self, ts):
        super().__init__()
        self.ts = list(ts)

    def dumps(self):
        return [self.__class__.__name__, [t.dumps() for t in self.ts]]

    def __call__(self, src):
        for t in self.ts:
            src = t(src)
        return src


class ResizeAug(Augmenter):
    """Short-side resize (reference: image.py:508)."""

    def __init__(self, size, interp=2):
        super().__init__(size=size, interp=interp)
        self.size, self.interp = size, interp

    def __call__(self, src):
        return resize_short(src, self.size, self.interp)


class ForceResizeAug(Augmenter):
    """Exact (w, h) resize ignoring aspect (reference: image.py:528)."""

    def __init__(self, size, interp=2):
        super().__init__(size=size, interp=interp)
        self.size, self.interp = size, interp

    def __call__(self, src):
        img = _to_np(src)
        return _nd(_resize(img, self.size[0], self.size[1],
                                self.interp), dtype=img.dtype)


class RandomCropAug(Augmenter):
    """(reference: image.py:549)."""

    def __init__(self, size, interp=2):
        super().__init__(size=size, interp=interp)
        self.size, self.interp = size, interp

    def __call__(self, src):
        return random_crop(src, self.size, self.interp)[0]


class RandomSizedCropAug(Augmenter):
    """(reference: image.py:569)."""

    def __init__(self, size, min_area, ratio, interp=2):
        super().__init__(size=size, min_area=min_area, ratio=ratio,
                         interp=interp)
        self.size, self.min_area = size, min_area
        self.ratio, self.interp = ratio, interp

    def __call__(self, src):
        return random_size_crop(src, self.size, self.min_area, self.ratio,
                                self.interp)[0]


class CenterCropAug(Augmenter):
    """(reference: image.py:596)."""

    def __init__(self, size, interp=2):
        super().__init__(size=size, interp=interp)
        self.size, self.interp = size, interp

    def __call__(self, src):
        return center_crop(src, self.size, self.interp)[0]


class RandomOrderAug(Augmenter):
    """Apply child augmenters in random order (reference: image.py:616)."""

    def __init__(self, ts):
        super().__init__()
        self.ts = list(ts)

    def dumps(self):
        return [self.__class__.__name__, [t.dumps() for t in self.ts]]

    def __call__(self, src):
        ts = list(self.ts)
        pyrandom.shuffle(ts)
        for t in ts:
            src = t(src)
        return src


class BrightnessJitterAug(Augmenter):
    """src *= 1 + U(-b, b) (reference: image.py:640)."""

    def __init__(self, brightness):
        super().__init__(brightness=brightness)
        self.brightness = brightness

    def __call__(self, src):
        alpha = 1.0 + pyrandom.uniform(-self.brightness, self.brightness)
        return _nd(_to_np(src).astype(np.float32) * alpha)


class ContrastJitterAug(Augmenter):
    """Blend with the mean gray level (reference: image.py:659)."""

    def __init__(self, contrast):
        super().__init__(contrast=contrast)
        self.contrast = contrast

    def __call__(self, src):
        img = _to_np(src).astype(np.float32)
        alpha = 1.0 + pyrandom.uniform(-self.contrast, self.contrast)
        gray = (img * _GRAY).sum(axis=2).mean()
        return _nd(img * alpha + gray * (1.0 - alpha))


class SaturationJitterAug(Augmenter):
    """Blend with the per-pixel gray image (reference: image.py:682)."""

    def __init__(self, saturation):
        super().__init__(saturation=saturation)
        self.saturation = saturation

    def __call__(self, src):
        img = _to_np(src).astype(np.float32)
        alpha = 1.0 + pyrandom.uniform(-self.saturation, self.saturation)
        gray = (img * _GRAY).sum(axis=2, keepdims=True)
        return _nd(img * alpha + gray * (1.0 - alpha))


class HueJitterAug(Augmenter):
    """Rotate hue in YIQ space (reference: image.py:706 — same
    yiq/rotation construction)."""

    def __init__(self, hue):
        super().__init__(hue=hue)
        self.hue = hue

    def __call__(self, src):
        img = _to_np(src).astype(np.float32)
        alpha = pyrandom.uniform(-self.hue, self.hue)
        theta = alpha * np.pi
        u, w = np.cos(theta), np.sin(theta)
        # RGB->YIQ, rotate IQ plane, YIQ->RGB, folded into one 3x3
        t_yiq = np.array([[0.299, 0.587, 0.114],
                          [0.596, -0.274, -0.321],
                          [0.211, -0.523, 0.311]], np.float32)
        t_rgb = np.array([[1.0, 0.956, 0.621],
                          [1.0, -0.272, -0.647],
                          [1.0, -1.107, 1.705]], np.float32)
        rot = np.array([[1.0, 0.0, 0.0],
                        [0.0, u, -w],
                        [0.0, w, u]], np.float32)
        t = t_rgb @ rot @ t_yiq
        return _nd(img @ t.T)


class ColorJitterAug(RandomOrderAug):
    """Brightness+contrast+saturation in random order (reference:
    image.py:740)."""

    def __init__(self, brightness, contrast, saturation):
        ts = []
        if brightness > 0:
            ts.append(BrightnessJitterAug(brightness))
        if contrast > 0:
            ts.append(ContrastJitterAug(contrast))
        if saturation > 0:
            ts.append(SaturationJitterAug(saturation))
        super().__init__(ts)


class LightingAug(Augmenter):
    """AlexNet-style PCA lighting noise (reference: image.py:763)."""

    def __init__(self, alphastd, eigval, eigvec):
        super().__init__(alphastd=alphastd, eigval=eigval, eigvec=eigvec)
        self.alphastd = alphastd
        self.eigval = np.asarray(eigval, np.float32)
        self.eigvec = np.asarray(eigvec, np.float32)

    def __call__(self, src):
        alpha = np.random.normal(0, self.alphastd, size=(3,))
        rgb = (self.eigvec * alpha * self.eigval).sum(axis=1)
        return _nd(_to_np(src).astype(np.float32) + rgb)


class ColorNormalizeAug(Augmenter):
    """(reference: image.py:789)."""

    def __init__(self, mean, std):
        super().__init__(mean=mean, std=std)
        self.mean = np.asarray(mean, np.float32)
        self.std = None if std is None else np.asarray(std, np.float32)

    def __call__(self, src):
        return color_normalize(src, self.mean, self.std)


class RandomGrayAug(Augmenter):
    """Randomly convert to 3-channel gray (reference: image.py:809)."""

    def __init__(self, p):
        super().__init__(p=p)
        self.p = p

    def __call__(self, src):
        img = _to_np(src).astype(np.float32)
        if pyrandom.random() < self.p:
            img = np.broadcast_to(
                (img * _GRAY).sum(axis=2, keepdims=True), img.shape).copy()
        return _nd(img)


class HorizontalFlipAug(Augmenter):
    """(reference: image.py:831)."""

    def __init__(self, p):
        super().__init__(p=p)
        self.p = p

    def __call__(self, src):
        img = _to_np(src)
        if pyrandom.random() < self.p:
            img = img[:, ::-1]
        return _nd(np.ascontiguousarray(img), dtype=img.dtype)


class CastAug(Augmenter):
    """To float32 (reference: image.py:850)."""

    def __init__(self, typ="float32"):
        super().__init__(type=typ)
        self.typ = typ

    def __call__(self, src):
        return _nd(_to_np(src).astype(self.typ), dtype=self.typ)


def CreateAugmenter(data_shape, resize=0, rand_crop=False, rand_resize=False,
                    rand_mirror=False, mean=None, std=None, brightness=0,
                    contrast=0, saturation=0, hue=0, pca_noise=0,
                    rand_gray=0, inter_method=2):
    """Build the standard augmenter list (reference: image.py:861 — same
    knobs, same ordering: resize, crop, color, lighting, gray, mirror,
    cast, normalize)."""
    auglist: List[Augmenter] = []
    if resize > 0:
        auglist.append(ResizeAug(resize, inter_method))
    crop_size = (data_shape[2], data_shape[1])
    if rand_resize:
        assert rand_crop
        auglist.append(RandomSizedCropAug(crop_size, 0.08, (3.0 / 4.0,
                                                            4.0 / 3.0),
                                          inter_method))
    elif rand_crop:
        auglist.append(RandomCropAug(crop_size, inter_method))
    else:
        auglist.append(CenterCropAug(crop_size, inter_method))
    if rand_mirror:
        auglist.append(HorizontalFlipAug(0.5))
    auglist.append(CastAug())
    if brightness or contrast or saturation:
        auglist.append(ColorJitterAug(brightness, contrast, saturation))
    if hue:
        auglist.append(HueJitterAug(hue))
    if pca_noise > 0:
        eigval = np.array([55.46, 4.794, 1.148])
        eigvec = np.array([[-0.5675, 0.7192, 0.4009],
                           [-0.5808, -0.0045, -0.8140],
                           [-0.5836, -0.6948, 0.4203]])
        auglist.append(LightingAug(pca_noise, eigval, eigvec))
    if rand_gray > 0:
        auglist.append(RandomGrayAug(rand_gray))
    if mean is True:
        mean = np.array([123.68, 116.28, 103.53])
    elif mean is not None:
        mean = np.asarray(mean, np.float32)
    if std is True:
        std = np.array([58.395, 57.12, 57.375])
    elif std is not None:
        std = np.asarray(std, np.float32)
    if mean is not None:
        assert mean.shape[0] in (1, 3)
        auglist.append(ColorNormalizeAug(mean, std))
    return auglist


# ------------------------------------------------------------------ iterator


class ImageIter(io_mod.DataIter):
    """Image iterator over a .rec file or an image list, with a pluggable
    augmenter pipeline (reference: image.py:975 — same construction forms:
    ``path_imgrec``, or ``imglist`` + ``path_root``).

    Produces NCHW float32 batches; ``aug_list`` defaults to
    ``CreateAugmenter(data_shape, **kwargs)``.
    """

    def __init__(self, batch_size, data_shape, label_width=1,
                 path_imgrec=None, path_imglist=None, path_root=None,
                 shuffle=False, aug_list=None, imglist=None,
                 data_name="data", label_name="softmax_label", **kwargs):
        super().__init__(batch_size)
        assert len(data_shape) == 3 and data_shape[0] in (1, 3)
        self.data_shape = tuple(data_shape)
        self.label_width = label_width
        self._data_name = data_name
        self._label_name = label_name
        self._shuffle = shuffle

        # (label, source) where source is a file path or a record offset —
        # image bytes stay on disk (the offset-index + seek pattern of
        # io/image_record.py) so huge .rec files stream instead of loading
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
                label = np.atleast_1d(np.asarray(header.label, np.float32))
                self._records.append((label, pos))
        elif imglist is not None or path_imglist is not None:
            if path_imglist is not None:
                imglist = []
                with open(path_imglist) as f:
                    for line in f:
                        parts = line.strip().split("\t")
                        # idx \t label... \t path
                        imglist.append([float(x) for x in parts[1:-1]]
                                       + [parts[-1]])
            for entry in imglist:
                label = np.atleast_1d(np.asarray(entry[:-1], np.float32))
                path = entry[-1]
                if path_root is not None:
                    path = os.path.join(path_root, path)
                self._records.append((label, path))
        else:
            raise ValueError("ImageIter needs path_imgrec, path_imglist or "
                             "imglist")

        self.auglist = aug_list if aug_list is not None else \
            CreateAugmenter(data_shape, **kwargs)
        self._order = np.arange(len(self._records))
        self.cur = 0
        self.reset()

    @property
    def provide_data(self):
        return [io_mod.DataDesc(self._data_name,
                                (self.batch_size,) + self.data_shape,
                                np.float32)]

    @property
    def provide_label(self):
        shape = (self.batch_size,) if self.label_width == 1 else \
            (self.batch_size, self.label_width)
        return [io_mod.DataDesc(self._label_name, shape, np.float32)]

    def reset(self):
        if self._shuffle:
            np.random.shuffle(self._order)
        self.cur = 0

    def next_sample(self):
        """One (label, decoded HWC image) pair (reference:
        image.py ImageIter.next_sample)."""
        if self.cur >= len(self._records):
            raise StopIteration
        label, src = self._records[self._order[self.cur]]
        self.cur += 1
        return label, self._read_image(src)

    def _read_image(self, src):
        if isinstance(src, (int, np.integer)):    # record offset
            self._rec.handle.seek(src)
            _, img_bytes = unpack(self._rec.read())
            return imdecode(img_bytes)
        return imread(src)

    def next(self):
        c, h, w = self.data_shape
        batch_data = np.zeros((self.batch_size, c, h, w), np.float32)
        batch_label = np.zeros((self.batch_size, self.label_width),
                               np.float32)
        i = 0
        pad = 0
        while i < self.batch_size:
            try:
                label, img = self.next_sample()
            except StopIteration:
                if i == 0:
                    raise
                pad = self.batch_size - i
                # repeat earlier samples like the reference's pad handling
                for j in range(i, self.batch_size):
                    batch_data[j] = batch_data[j - i]
                    batch_label[j] = batch_label[j - i]
                break
            for aug in self.auglist:
                img = aug(img)
            arr = _to_np(img).astype(np.float32)
            if arr.shape[:2] != (h, w):
                raise ValueError(
                    "augmented image has shape %s, expected %dx%d — add a "
                    "crop/resize augmenter" % (arr.shape, h, w))
            batch_data[i] = arr.transpose(2, 0, 1)
            batch_label[i] = label[:self.label_width]
            i += 1
        label_out = batch_label[:, 0] if self.label_width == 1 else \
            batch_label
        return io_mod.DataBatch(
            data=[_nd(batch_data)], label=[_nd(label_out)],
            pad=pad, provide_data=self.provide_data,
            provide_label=self.provide_label)
