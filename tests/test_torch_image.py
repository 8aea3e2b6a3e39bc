"""The port's image pipeline against the reference's, bit for bit: the
augmenters and ``CreateAugmenter`` under the same ``random`` / numpy
draws, ``ImageIter`` over an image list and a record file,
``ImageRecordIter`` on the native path and on the Python path, and the
detection augmenters and iterators.

The oracle is the reference's ``tests/test_image.py`` (and
``tests/test_native.py``'s pipeline cases). Both packages decode with
the same native sources and with cv2, so batches are compared with
``np.array_equal``. The reference's Python path draws each record's crop
in its decode threads, so it is compared at one thread; the port's draws
in record order whatever its thread count.
"""
import queue
import random as pyrandom
import time

import numpy as np
import pytest

import mxnet_tpu as mx
import mxnet_tpu_torch as mt
from mxnet_tpu import image as ref_img
from mxnet_tpu import recordio as ref_rio
from mxnet_tpu_torch import image as img
from mxnet_tpu_torch import recordio as rio

cv2 = pytest.importorskip("cv2")


def _np(x):
    return x.asnumpy() if hasattr(x, "asnumpy") else np.asarray(x)


def _toy(h=32, w=40, seed=0):
    return np.random.RandomState(seed).randint(0, 255, (h, w, 3)).astype(
        np.uint8)


def _seeded(fn, seed=3):
    pyrandom.seed(seed)
    np.random.seed(seed)
    return fn()


def _both(make, src, seed=3):
    """``make(pkg)(src)`` in each package from the same draws."""
    got = _seeded(lambda: make(img)(src), seed)
    want = _seeded(lambda: make(ref_img)(src), seed)
    return got, want


def _equal(got, want):
    if isinstance(want, tuple):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _equal(g, w)
        return
    g, w = _np(got), _np(want)
    assert g.dtype == w.dtype and g.shape == w.shape
    np.testing.assert_array_equal(g, w)


AUGMENTERS = {
    "resize": lambda m: m.ResizeAug(20),
    "force_resize": lambda m: m.ForceResizeAug((17, 23), interp=1),
    "random_crop": lambda m: m.RandomCropAug((24, 20)),
    "random_sized_crop": lambda m: m.RandomSizedCropAug(
        (16, 16), 0.3, (0.75, 1.33)),
    "center_crop": lambda m: m.CenterCropAug((24, 18)),
    "brightness": lambda m: m.BrightnessJitterAug(0.3),
    "contrast": lambda m: m.ContrastJitterAug(0.3),
    "saturation": lambda m: m.SaturationJitterAug(0.3),
    "hue": lambda m: m.HueJitterAug(0.2),
    "color_jitter": lambda m: m.ColorJitterAug(0.2, 0.2, 0.2),
    "lighting": lambda m: m.LightingAug(
        0.1, np.array([55.46, 4.794, 1.148]),
        np.array([[-0.5675, 0.7192, 0.4009], [-0.5808, -0.0045, -0.8140],
                  [-0.5836, -0.6948, 0.4203]])),
    "normalize": lambda m: m.ColorNormalizeAug(np.array([1.0, 2.0, 3.0]),
                                               np.array([2.0, 3.0, 4.0])),
    "gray": lambda m: m.RandomGrayAug(0.9),
    "flip": lambda m: m.HorizontalFlipAug(0.7),
    "cast": lambda m: m.CastAug(),
    "sequential": lambda m: m.SequentialAug([m.ResizeAug(24),
                                             m.CenterCropAug((20, 20))]),
}


@pytest.mark.parametrize("name", sorted(AUGMENTERS))
@pytest.mark.parametrize("seed", [0, 7])
def test_augmenter_matches_reference(name, seed):
    src = _toy(32, 40, seed)
    got, want = _both(AUGMENTERS[name], src, seed)
    _equal(got, want)
    assert got.data.device.type == "cpu"          # a host NDArray
    assert AUGMENTERS[name](img).dumps() == AUGMENTERS[name](ref_img).dumps()


@pytest.mark.parametrize("fn", ["resize_short", "fixed_crop", "random_crop",
                                "center_crop", "color_normalize",
                                "random_size_crop", "scale_down"])
def test_image_functions_match_reference(fn):
    src = _toy(30, 44, 2)
    calls = {
        "resize_short": lambda m: m.resize_short(src, 20),
        "fixed_crop": lambda m: m.fixed_crop(src, 3, 4, 20, 16, (10, 8)),
        "random_crop": lambda m: m.random_crop(src, (20, 24)),
        "center_crop": lambda m: m.center_crop(src, (50, 20)),
        "color_normalize": lambda m: m.color_normalize(
            src, np.array([10.0, 20.0, 30.0]), np.array([2.0, 2.0, 2.0])),
        "random_size_crop": lambda m: m.random_size_crop(
            src, (16, 16), 0.2, (0.5, 2.0)),
        "scale_down": lambda m: m.scale_down((44, 30), (50, 20)),
    }
    got = _seeded(lambda: calls[fn](img))
    want = _seeded(lambda: calls[fn](ref_img))
    _equal(got, want)


@pytest.mark.parametrize("kw", [
    dict(resize=28, rand_crop=True, rand_mirror=True, brightness=0.1,
         contrast=0.1, saturation=0.1, hue=0.1, pca_noise=0.05, mean=True,
         std=True),
    dict(rand_crop=True, rand_resize=True, rand_gray=0.5),
    dict(mean=np.array([100.0, 110.0, 120.0]))])
def test_create_augmenter_matches_reference(kw):
    src = _toy(50, 60, 4)

    def run(m):
        out = src
        for a in m.CreateAugmenter((3, 24, 24), **kw):
            out = a(out)
        return out

    _equal(_seeded(lambda: run(img), 11), _seeded(lambda: run(ref_img), 11))


def _imglist(tmp_path, n=6):
    entries = []
    for i in range(n):
        path = str(tmp_path / ("img%d.png" % i))
        cv2.imwrite(path, _toy(40, 36 + i, seed=i))
        entries.append([float(i % 3), path])
    return entries


def _drain(it):
    out = []
    for b in it:
        out.append((_np(b.data[0]), _np(b.label[0]), b.pad))
    return out


def _same_stream(a, b):
    assert len(a) == len(b)
    for (da, la, pa), (db, lb, pb) in zip(a, b):
        assert pa == pb
        np.testing.assert_array_equal(da, db)
        np.testing.assert_array_equal(la, lb)


def test_image_iter_from_imglist_matches_reference(tmp_path):
    entries = _imglist(tmp_path)

    def run(m):
        it = m.ImageIter(batch_size=4, data_shape=(3, 24, 24),
                         imglist=entries, shuffle=True, rand_crop=True,
                         rand_mirror=True)
        first = _drain(it)
        it.reset()
        return first + _drain(it)

    got, want = _seeded(lambda: run(img)), _seeded(lambda: run(ref_img))
    _same_stream(got, want)
    assert got[1][2] == 2                     # 2 real + 2 pad


def test_image_iter_from_rec_and_lst_match_reference(tmp_path):
    path = str(tmp_path / "i.rec")
    w = rio.MXRecordIO(path, "w")
    lines = []
    for i in range(5):
        w.write(rio.pack_img(rio.IRHeader(0, float(i), i, 0),
                             _toy(30, 30 + i, i), img_fmt=".png"))
        cv2.imwrite(str(tmp_path / ("p%d.png" % i)), _toy(30, 30, i))
        lines.append("%d\t%f\tp%d.png\n" % (i, i % 2, i))
    w.close()
    with open(tmp_path / "i.lst", "w") as f:
        f.writelines(lines)
    for kw in (dict(path_imgrec=path),
               dict(path_imglist=str(tmp_path / "i.lst"),
                    path_root=str(tmp_path))):
        got = _seeded(lambda: _drain(img.ImageIter(
            batch_size=2, data_shape=(3, 20, 20), rand_crop=True, **kw)))
        want = _seeded(lambda: _drain(ref_img.ImageIter(
            batch_size=2, data_shape=(3, 20, 20), rand_crop=True, **kw)))
        _same_stream(got, want)


def _image_rec(tmp_path, n=11, fmt=".png", name="imgs.rec"):
    rng = np.random.RandomState(1)
    path = str(tmp_path / name)
    w = rio.MXRecordIO(path, "w")
    imgs = []
    for i in range(n):
        im = (rng.rand(40 + i, 48, 3) * 255).astype(np.uint8)   # RGB
        imgs.append(im)
        ok, enc = cv2.imencode(fmt, im[:, :, ::-1])
        w.write(rio.pack(rio.IRHeader(0, float(i), i, 0), enc.tobytes()))
    w.close()
    return path, imgs


ITER_KW = [dict(),
           dict(shuffle=True, rand_crop=True, rand_mirror=True, seed=7),
           dict(resize=36, rand_crop=True, mean_r=123, mean_g=117,
                mean_b=104, std_r=58, std_g=57, std_b=57, scale=0.5),
           dict(round_batch=False, shuffle=True, seed=2)]


def _end(it):
    """End an iterator's decode thread under a bounded join. The port's
    has close(); the reference's has none, and the teardown in its
    __del__ never runs while its own thread holds it, so it runs here and
    the thread is joined."""
    if hasattr(it, "close"):
        assert it.close()
        return
    it.__del__()
    loader = getattr(it, "_loader", None)
    deadline = time.monotonic() + 10.0
    while loader is not None and loader.is_alive() and \
            time.monotonic() < deadline:
        try:
            it._batch_queue.get_nowait()
        except queue.Empty:
            pass
        loader.join(timeout=0.05)
    assert loader is None or not loader.is_alive()


def _record_stream(pkg, path, epochs=2, **kw):
    it = pkg.io.ImageRecordIter(path_imgrec=path, data_shape=(3, 32, 32),
                                batch_size=4, **kw)
    out = []
    for _ in range(epochs):
        out += _drain(it)
        it.reset()
    return it, out


@pytest.mark.parametrize("kw", ITER_KW)
def test_image_record_iter_native_matches_reference(tmp_path, kw):
    from mxnet_tpu import native as ref_native
    if ref_native.lib() is None:
        pytest.skip("the reference's native library did not build")
    path, _ = _image_rec(tmp_path)
    it, got = _record_stream(mt, path, **kw)
    assert it._native is not None
    ref, want = _record_stream(mx, path, **kw)
    assert ref._native is not None
    _end(ref)
    _same_stream(got, want)
    it.close()


@pytest.mark.parametrize("kw", ITER_KW)
@pytest.mark.parametrize("fmt", [".png", ".jpg"])
def test_image_record_iter_python_path_matches_reference(tmp_path, kw, fmt,
                                                        monkeypatch):
    from mxnet_tpu import native as ref_native
    path, _ = _image_rec(tmp_path, fmt=fmt)
    mt.config.set("MXNET_USE_NATIVE_IO", False)
    # the reference reads its knob once per process: its Python path is
    # the one it takes without a library
    monkeypatch.setattr(ref_native, "lib", lambda: None)
    try:
        it, got = _record_stream(mt, path, preprocess_threads=4, **kw)
        assert it._native is None
        ref, want = _record_stream(mx, path, preprocess_threads=1, **kw)
        assert ref._native is None
        _end(ref)
        assert it.close()
        # and the port's stream is the same at one thread
        it1, again = _record_stream(mt, path, preprocess_threads=1, **kw)
        assert it1.close()
    finally:
        mt.config.reset("MXNET_USE_NATIVE_IO")
    _same_stream(got, want)
    _same_stream(got, again)


def test_native_pipeline_against_numpy_oracle(tmp_path):
    """The native batch against plain numpy of the same records (center
    crop, mean, std): equal to float rounding."""
    path, imgs = _image_rec(tmp_path)
    mean = np.array([123., 117., 104.], np.float32)
    std = np.array([58., 57., 57.], np.float32)
    it = mt.io.ImageRecordIter(path_imgrec=path, data_shape=(3, 32, 32),
                               batch_size=4, mean_r=123, mean_g=117,
                               mean_b=104, std_r=58, std_g=57, std_b=57)
    assert it._native is not None
    i = 0
    for batch in it:
        dat, lab = _np(batch.data[0]), _np(batch.label[0])
        for k in range(4 - batch.pad):
            im = imgs[i]
            y0, x0 = (im.shape[0] - 32) // 2, (im.shape[1] - 32) // 2
            ref = ((im[y0:y0 + 32, x0:x0 + 32].astype(np.float32) - mean)
                   / std).transpose(2, 0, 1)
            np.testing.assert_allclose(dat[k], ref, atol=1e-4)
            assert lab[k] == float(i)
            i += 1
    assert i == len(imgs)
    it.close()


@pytest.mark.parametrize("native_io", [True, False])
def test_image_record_iter_sharding(tmp_path, native_io):
    path, _ = _image_rec(tmp_path, n=20)
    mt.config.set("MXNET_USE_NATIVE_IO", native_io)
    try:
        seen = []
        for part in (0, 1):
            it = mt.io.ImageRecordIter(
                path_imgrec=path, data_shape=(3, 32, 32), batch_size=5,
                num_parts=2, part_index=part, round_batch=False)
            assert it.num_data == 10
            labels = []
            for b in it:
                lab = _np(b.label[0]).ravel()
                labels.extend(lab[:len(lab) - b.pad].tolist())
            seen.append(set(int(v) for v in labels))
            it.close()
        assert seen[0].isdisjoint(seen[1])
        assert seen[0] | seen[1] == set(range(20))
        with pytest.raises(ValueError):
            mt.io.ImageRecordIter(path_imgrec=path, data_shape=(3, 8, 8),
                                  batch_size=5, num_parts=2, part_index=2)
    finally:
        mt.config.reset("MXNET_USE_NATIVE_IO")


def test_image_record_iter_aug_list_matches_reference(tmp_path):
    path, _ = _image_rec(tmp_path, n=4)

    def run(pkg, m):
        augs = [m.CenterCropAug((20, 20)), m.CastAug(),
                m.ColorNormalizeAug(np.zeros(3), np.full(3, 255.0))]
        it = pkg.io.ImageRecordIter(path_imgrec=path, data_shape=(3, 20, 20),
                                    batch_size=2, aug_list=augs,
                                    preprocess_threads=1)
        out = _drain(it)
        _end(it)
        return out

    _same_stream(run(mt, img), run(mx, ref_img))
    it = mt.io.ImageRecordIter(path_imgrec=path, data_shape=(3, 20, 20),
                               batch_size=2, aug_list=[img.CastAug()])
    with pytest.raises(ValueError, match="crop/resize"):
        it.next()
    assert it.close()


def test_uint8_iter_and_imdecode(tmp_path):
    path, imgs = _image_rec(tmp_path, n=4, fmt=".png")
    it = mt.io.ImageRecordUInt8Iter(path_imgrec=path, data_shape=(3, 32, 32),
                                    batch_size=2)
    b = it.next()
    assert _np(b.data[0]).dtype == np.uint8
    it.close()
    ok, enc = cv2.imencode(".png", imgs[0][:, :, ::-1])
    got = mt.image.imdecode(enc.tobytes())
    np.testing.assert_array_equal(_np(got), _np(mx.image.imdecode(
        enc.tobytes())))
    np.testing.assert_array_equal(_np(got), imgs[0])
    assert got.data.device.type == "cpu"


# ------------------------------------------------------------- detection

def _det_label(rows):
    return np.asarray(rows, np.float32)


DET_AUGS = {
    "flip": (lambda m: m.DetHorizontalFlipAug(0.8),
             [[1, 0.1, 0.2, 0.4, 0.6], [-1, 0, 0, 0, 0]]),
    "crop": (lambda m: m.DetRandomCropAug(min_object_covered=0.3,
                                          area_range=(0.3, 1.0)),
             [[0, 0.3, 0.3, 0.7, 0.7]]),
    "crop_small": (lambda m: m.DetRandomCropAug(min_object_covered=0.9,
                                                area_range=(0.5, 0.9)),
                   [[0, 0.45, 0.45, 0.55, 0.55]]),
    "pad": (lambda m: m.DetRandomPadAug(area_range=(1.5, 2.5)),
            [[0, 0.0, 0.0, 1.0, 1.0]]),
    "borrow": (lambda m: m.DetBorrowAug(m.ColorNormalizeAug(
        np.array([1.0, 2.0, 3.0]), None)), [[2, 0.1, 0.1, 0.3, 0.3]]),
    "select": (lambda m: m.DetRandomSelectAug(
        [m.DetHorizontalFlipAug(1.0), m.DetRandomPadAug()], skip_prob=0.3),
        [[1, 0.2, 0.1, 0.6, 0.9]]),
}


@pytest.mark.parametrize("name", sorted(DET_AUGS))
@pytest.mark.parametrize("seed", [0, 5])
def test_det_augmenter_matches_reference(name, seed):
    make, rows = DET_AUGS[name]
    src = _toy(48, 64, seed)
    for _ in range(3):
        got = _seeded(lambda: make(img)(src, _det_label(rows)), seed)
        want = _seeded(lambda: make(ref_img)(src, _det_label(rows)), seed)
        _equal(tuple(got), tuple(want))
        seed += 1


def test_create_det_augmenter_and_image_det_iter(tmp_path):
    entries = []
    for i in range(5):
        path = str(tmp_path / ("d%d.png" % i))
        cv2.imwrite(path, _toy(48, 44 + i, seed=i))
        entries.append([float(i % 2), 0.2, 0.2, 0.8, 0.8, path])

    def run(m):
        it = m.ImageDetIter(batch_size=2, data_shape=(3, 32, 32),
                            imglist=entries, rand_crop=0.5, rand_pad=0.5,
                            rand_mirror=True, mean=True, std=True)
        return _drain(it)

    got = _seeded(lambda: run(img), 9)
    want = _seeded(lambda: run(ref_img), 9)
    _same_stream(got, want)
    assert got[0][1].shape == (2, 1, 5)


def test_image_det_record_iter_matches_reference(tmp_path):
    path = str(tmp_path / "det.rec")
    w = ref_rio.MXRecordIO(path, "w")
    for i in range(3):
        ok, enc = cv2.imencode(".png", _toy(40, 40, seed=i))
        label = np.array([4, 5, 0, 0, 1.0, 0.1, 0.1, 0.5, 0.5], np.float32)
        w.write(ref_rio.pack(ref_rio.IRHeader(0, label, i, 0),
                             enc.tobytes()))
    w.close()
    got = _drain(mt.io.ImageDetRecordIter(path_imgrec=path,
                                          data_shape=(3, 24, 24),
                                          batch_size=3))
    want = _drain(mx.io.ImageDetRecordIter(path_imgrec=path,
                                           data_shape=(3, 24, 24),
                                           batch_size=3))
    _same_stream(got, want)
    np.testing.assert_allclose(got[0][1][0, 0], [1.0, 0.1, 0.1, 0.5, 0.5],
                               atol=1e-6)
