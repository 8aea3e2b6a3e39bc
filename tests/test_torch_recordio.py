"""The port's RecordIO, filesystem and native library against the
reference's.

The oracles are the reference's ``tests/test_io.py`` (records, index
validation, headers), ``tests/test_filesystem.py`` and
``tests/test_native.py``: a file written by either package reads back
byte for byte in the other, the native reader and writer agree with the
Python codec, native decode with cv2's, and a native library that cannot
build raises with the compiler's output instead of falling back.
"""
import ctypes
import os
import shutil
import struct

import numpy as np
import pytest

import mxnet_tpu as mx
import mxnet_tpu_torch as mt
from mxnet_tpu import filesystem as ref_fs
from mxnet_tpu import recordio as ref_rio
from mxnet_tpu_torch import filesystem as fs
from mxnet_tpu_torch import native
from mxnet_tpu_torch import recordio as rio
from mxnet_tpu_torch.base import MXNetError
import torch

# test files run side by side in parallel workers: each keeps torch's
# intra-op pool small
torch.set_num_threads(2)

PKGS = {"ref": ref_rio, "port": rio}
u8p = ctypes.POINTER(ctypes.c_uint8)


def _payloads():
    rng = np.random.RandomState(0)
    return [b"hello", b"x" * 1037, b"", rng.bytes(4096), b"abcd",
            rng.bytes(3)]


@pytest.mark.parametrize("writer,reader", [("ref", "port"),
                                           ("port", "ref"),
                                           ("port", "port")])
def test_records_cross_packages(tmp_path, writer, reader):
    path = str(tmp_path / "t.rec")
    w = PKGS[writer].MXRecordIO(path, "w")
    for b in _payloads():
        w.write(b)
    w.close()
    r = PKGS[reader].MXRecordIO(path, "r")
    assert [r.read() for _ in _payloads()] == _payloads()
    assert r.read() is None
    r.close()


@pytest.mark.parametrize("writer,reader", [("ref", "port"),
                                           ("port", "ref")])
def test_indexed_records_cross_packages(tmp_path, writer, reader):
    idx, rec = str(tmp_path / "t.idx"), str(tmp_path / "t.rec")
    w = PKGS[writer].MXIndexedRecordIO(idx, rec, "w")
    for i, b in enumerate(_payloads()):
        w.write_idx(i * 3, b)
    w.close()
    with open(idx) as f:
        lines = f.read()
    r = PKGS[reader].MXIndexedRecordIO(idx, rec, "r")
    assert r.keys == [i * 3 for i in range(len(_payloads()))]
    for i, b in reversed(list(enumerate(_payloads()))):
        assert r.read_idx(i * 3) == b
    r.close()
    # the sidecar is the same text whichever package wrote it
    other = "port" if writer == "ref" else "ref"
    idx2, rec2 = str(tmp_path / "u.idx"), str(tmp_path / "u.rec")
    w = PKGS[other].MXIndexedRecordIO(idx2, rec2, "w")
    for i, b in enumerate(_payloads()):
        w.write_idx(i * 3, b)
    w.close()
    assert open(idx2).read() == lines
    assert open(rec2, "rb").read() == open(rec, "rb").read()


@pytest.mark.parametrize("label", [3.0, [1.0, 2.0, 3.0, 4.0],
                                   np.array([0.5, -2.0], np.float32)])
def test_pack_unpack_headers_match(label):
    flag = 0 if np.isscalar(label) else len(label)
    h_ref = ref_rio.IRHeader(flag, label, 7, 9)
    h = rio.IRHeader(flag, label, 7, 9)
    packed = rio.pack(h, b"payload")
    assert packed == ref_rio.pack(h_ref, b"payload")
    for unpack in (rio.unpack, ref_rio.unpack):
        got, payload = unpack(packed)
        assert payload == b"payload"
        assert (got.flag, got.id, got.id2) == (flag, 7, 9)
        np.testing.assert_array_equal(np.asarray(got.label, np.float32),
                                      np.asarray(label, np.float32))


@pytest.mark.parametrize("fmt", [".jpg", ".png"])
def test_pack_img_unpack_img_match(fmt):
    pytest.importorskip("cv2")
    img = (np.random.RandomState(1).rand(21, 17, 3) * 255).astype(np.uint8)
    h = rio.IRHeader(0, 2.0, 1, 0)
    packed = rio.pack_img(h, img, quality=90, img_fmt=fmt)
    assert packed == ref_rio.pack_img(ref_rio.IRHeader(0, 2.0, 1, 0), img,
                                      quality=90, img_fmt=fmt)
    _, a = rio.unpack_img(packed)
    _, b = ref_rio.unpack_img(packed)
    np.testing.assert_array_equal(a, b)


def test_multipart_chain_reassembles(tmp_path):
    payload = bytes(range(256)) * 40
    path = str(tmp_path / "chain.rec")
    with open(path, "wb") as f:
        parts = [payload[:4000], payload[4000:8000], payload[8000:]]
        for i, chunk in enumerate(parts):
            cflag = 1 if i == 0 else (3 if i == len(parts) - 1 else 2)
            f.write(struct.pack("<II", 0xced7230a,
                                (cflag << 29) | len(chunk)))
            f.write(chunk + b"\x00" * ((-len(chunk)) % 4))
    for pkg in PKGS.values():
        r = pkg.MXRecordIO(path, "r")
        assert r.read() == payload and r.read() is None
        r.close()


def _tampered(tmp_path):
    idx, rec = str(tmp_path / "t.idx"), str(tmp_path / "t.rec")
    w = rio.MXIndexedRecordIO(idx, rec, "w")
    for i in range(4):
        w.write_idx(i, b"r%d" % i * 10)
    w.close()
    return idx, rec


@pytest.mark.parametrize("case,match", [
    ("past_eof", "does not match this record file"),
    ("malformed", "malformed index entry"),
    ("bad_magic", "reading index key 2"),
    ("missing_key", "not in index")])
def test_index_validation_names_the_key(tmp_path, case, match):
    idx, rec = _tampered(tmp_path)
    if case == "past_eof":
        with open(idx, "a") as f:
            f.write("9\t%d\n" % (os.path.getsize(rec) + 100))
    elif case == "malformed":
        with open(idx, "a") as f:
            f.write("oops\n")
    elif case == "bad_magic":
        offs = [int(ln.split("\t")[1]) for ln in open(idx)]
        with open(rec, "r+b") as f:
            f.seek(offs[2])
            f.write(b"\x00\x00\x00\x00")
    errors = []
    for pkg in PKGS.values():
        with pytest.raises((IOError, KeyError)) as exc:
            r = pkg.MXIndexedRecordIO(idx, rec, "r")
            r.read_idx(2 if case != "missing_key" else 42)
        errors.append(str(exc.value).replace(str(tmp_path), ""))
        assert match in errors[-1]
    assert errors[0] == errors[1]


# ------------------------------------------------------------ filesystem

@pytest.fixture()
def memfs(tmp_path):
    """A custom scheme registered in both packages, backed by a dir."""
    import contextlib
    store = tmp_path / "store"
    store.mkdir()

    @contextlib.contextmanager
    def opener(path, mode):
        local = str(store / path.replace("/", "_"))
        yield local

    fs.register_scheme("memfs", opener)
    ref_fs.register_scheme("memfs", opener)
    return store


def test_filesystem_local_and_unknown(tmp_path):
    p = str(tmp_path / "f.bin")
    with fs.open_uri(p, "w") as local:
        assert local == p
    with fs.open_uri("file://" + p, "r") as local:
        assert local == p
    assert fs.scheme_of("s3://b/k") == ref_fs.scheme_of("s3://b/k") == "s3"
    with pytest.raises(IOError, match="no filesystem registered"):
        fs.open_uri("nope://x")
    open(p, "wb").close()
    assert fs.exists(p) and fs.exists("file://" + p)
    assert not fs.exists(str(tmp_path / "missing"))


def test_filesystem_remote_errors_are_the_reference_s():
    import importlib.util
    if importlib.util.find_spec("boto3") is None:
        with pytest.raises(IOError, match="boto3"):
            with fs.open_uri("s3://bucket/key", "r"):
                pass
    for scheme in ("s3", "hdfs"):
        with pytest.raises(IOError, match="append mode") as a:
            with fs.open_uri("%s://b/k" % scheme, "a"):
                pass
        with pytest.raises(IOError, match="append mode") as b:
            with ref_fs.open_uri("%s://b/k" % scheme, "a"):
                pass
        assert str(a.value) == str(b.value)


def test_recordio_through_a_scheme_crosses_packages(memfs):
    w = rio.MXRecordIO("memfs://data/t.rec", "w")
    for b in _payloads():
        w.write(b)
    w.close()
    r = ref_rio.MXRecordIO("memfs://data/t.rec", "r")
    assert [r.read() for _ in _payloads()] == _payloads()
    r.close()
    with pytest.raises(ValueError, match="Invalid flag"):
        rio.MXRecordIO("memfs://data/t.rec", "x")
    assert fs.exists("memfs://data/t.rec")


# ------------------------------------------------------------ native

@pytest.fixture(scope="module")
def lib():
    if not native.enabled():
        pytest.skip("MXNET_USE_NATIVE_IO=0 in this environment")
    return native.lib()


def test_native_reader_matches_python_codec(tmp_path, lib):
    path = str(tmp_path / "t.rec")
    w = rio.MXRecordIO(path, "w")
    for b in _payloads():
        w.write(b)
    w.close()
    r = lib.mxrio_open(path.encode())
    assert r and lib.mxrio_count(r) == len(_payloads())
    for i, b in enumerate(_payloads()):
        ptr = u8p()
        n = lib.mxrio_get(r, i, ctypes.byref(ptr))
        assert (bytes(bytearray(ptr[:n])) if n else b"") == b
        assert lib.mxrio_index_of(r, lib.mxrio_offset(r, i)) == i
    lib.mxrio_close(r)


def test_native_writer_matches_both_python_readers(tmp_path, lib):
    path = str(tmp_path / "w.rec")
    w = lib.mxrio_writer_open(path.encode())
    offs = [lib.mxrio_writer_write(w, b, len(b)) for b in _payloads()]
    assert lib.mxrio_writer_close(w) == 0
    assert offs[0] == 0 and all(o >= 0 for o in offs)
    for pkg in PKGS.values():
        r = pkg.MXRecordIO(path, "r")
        assert [r.read() for _ in _payloads()] == _payloads()
        r.close()


# gray from PNG differs by design: libpng converts with the sRGB weights
# (0.2126, 0.7152, 0.0722), cv2 with BT.601's, as libjpeg does
@pytest.mark.parametrize("fmt,channels", [(".jpg", 3), (".png", 3),
                                          (".jpg", 1)])
def test_native_decode_matches_cv2(lib, fmt, channels):
    cv2 = pytest.importorskip("cv2")
    img = (np.random.RandomState(0).rand(37, 53, 3) * 255).astype(np.uint8)
    ok, enc = cv2.imencode(fmt, img)
    got = native.decode(enc.tobytes(), channels)
    if channels == 3:
        want = cv2.cvtColor(cv2.imdecode(enc, cv2.IMREAD_COLOR),
                            cv2.COLOR_BGR2RGB)
        np.testing.assert_array_equal(got, want)
    else:
        want = cv2.imdecode(enc, cv2.IMREAD_GRAYSCALE)
        assert got.shape == want.shape + (1,)
        # libjpeg's own gray conversion against cv2's weights: a level
        assert np.abs(got[:, :, 0].astype(int) - want.astype(int)).max() \
            <= 1
    with pytest.raises(ValueError, match="not a JPEG or PNG"):
        native.decode(b"GIF89a....", 3)


def test_native_resize_close_to_cv2(lib):
    cv2 = pytest.importorskip("cv2")
    img = (np.random.RandomState(3).rand(41, 67, 3) * 255).astype(np.uint8)
    got = native.resize(img, 23, 31)
    want = cv2.resize(img, (31, 23), interpolation=cv2.INTER_LINEAR)
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1


def test_native_library_is_built_under_build_by_hash(lib):
    path = native.build()
    assert path.parent == native.OUT_DIR
    assert path.name.startswith("libmxnative-") and path.exists()
    assert native.build() == path            # up to date: not rebuilt
    # the codec and decoder are the reference's C++ (the other two files
    # differ in their comments only)
    ref_dir = os.path.join(os.path.dirname(mx.__file__), "native")
    for name in ("recordio.cc", "image.cc"):
        assert open(os.path.join(ref_dir, name)).read() == \
            open(native.SRC_DIR / name).read()


def test_failed_native_build_raises_with_compiler_output(tmp_path):
    if shutil.which("g++") is None:
        pytest.skip("no g++ on this host")
    src = tmp_path / "src"
    shutil.copytree(native.SRC_DIR, src,
                    ignore=shutil.ignore_patterns("*.py", "__pycache__"))
    with open(src / "image.cc", "a") as f:
        f.write("\nthis is not C++;\n")
    with pytest.raises(MXNetError) as exc:
        native.build(src_dir=src, out_dir=tmp_path / "out")
    msg = str(exc.value)
    assert "native data library build failed" in msg
    assert "image.cc" in msg and "error" in msg      # the compiler's words
    assert "MXNET_USE_NATIVE_IO=0" in msg
    assert not list((tmp_path / "out").glob("*.so"))
    with pytest.raises(MXNetError, match="failed to run"):
        native.build(src_dir=native.SRC_DIR, out_dir=tmp_path / "out2",
                     cxx=str(tmp_path / "no-such-compiler"))


def test_native_io_knob_selects_the_python_path(tmp_path, monkeypatch):
    cv2 = pytest.importorskip("cv2")
    path = str(tmp_path / "k.rec")
    w = rio.MXRecordIO(path, "w")
    for i in range(4):
        img = (np.random.RandomState(i).rand(10, 12, 3) * 255).astype(
            np.uint8)
        w.write(rio.pack(rio.IRHeader(0, float(i), i, 0),
                         cv2.imencode(".png", img)[1].tobytes()))
    w.close()
    mt.config.set("MXNET_USE_NATIVE_IO", False)
    try:
        it = mt.io.ImageRecordIter(path_imgrec=path, data_shape=(3, 8, 8),
                                   batch_size=2)
        assert it._native is None
        assert it.next().data[0].shape == (2, 3, 8, 8)
        assert it.close()
    finally:
        mt.config.reset("MXNET_USE_NATIVE_IO")

    def refuse(*a, **k):
        raise MXNetError("native data library build failed: stand-in")

    # with the knob on, a library that cannot build raises: no fallback
    monkeypatch.setattr(native, "lib", refuse)
    with pytest.raises(MXNetError, match="build failed"):
        mt.io.ImageRecordIter(path_imgrec=path, data_shape=(3, 8, 8),
                              batch_size=2)
