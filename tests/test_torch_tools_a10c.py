"""The port's tools (``mxnet_tpu_torch/tools``: ``caffe_converter``,
``convert_params``, ``parse_log``, ``kill_mxnet``) against the
reference's (``tools/``), on the CPU.

* the Caffe converter: the parsed prototxt, the symbol JSON and its
  argument and aux names equal the reference's for the LeNet deploy net
  of ``tests/test_caffe_converter.py`` and for a BatchNorm + Scale net;
  the ``.caffemodel`` wire reader gives the reference's arrays bit for
  bit on a NetParameter hand-encoded by that test's encoder (new and V1
  layers, legacy and packed blobs); the CLI's ``-symbol.json`` and
  ``-0000.params`` load in both packages and their forwards agree to
  rtol 1e-5 / atol 1e-6 (f32 convolution in another order; measured
  ~1e-7), and to a numpy forward of the same weights to 1e-4;
* ``convert_params``: a reference-era binary ``.params`` re-encoded
  with every option gives the arrays the reference's tool gives, bit
  for bit, and loads into a port ``Module``;
* ``parse_log``: the same rows and the same printed tables as the
  reference for ``tests/test_config.py``'s log and for the log of a
  port ``fit``;
* ``kill_mxnet``: the local path ends a child process the test owns.
"""
import json
import logging
import os
import subprocess
import sys
import time
import uuid

import numpy as np
import pytest
import torch

import mxnet_tpu as mx
import mxnet_tpu_torch as mt
from mxnet_tpu_torch.tools import (caffe_converter, convert_params,
                                   kill_mxnet, parse_log)
from tests.test_caffe_converter import LENET_PROTOTXT, _enc_layer
from tools import caffe_converter as jcaffe
from tools import convert_params as jconvert
from tools import kill_mxnet as jkill
from tools import parse_log as jparse

# test files run side by side in parallel workers: each keeps torch's
# intra-op pool small
torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL, ATOL = 1e-5, 1e-6

BN_PROTOTXT = """
layer { name: "data" type: "Input" top: "data"
  input_param: { shape: { dim: 2 dim: 4 } } }
layer { name: "fc" type: "InnerProduct" bottom: "data" top: "fc"
  inner_product_param: { num_output: 3 } }
layer { name: "bn1" type: "BatchNorm" bottom: "fc" top: "bn1" }
layer { name: "sc1" type: "Scale" bottom: "bn1" top: "sc1" }
layer { name: "prob" type: "Softmax" bottom: "sc1" top: "prob" }
"""

TINY_PROTOTXT = """
name: "tiny"
input: "data"
input_dim: 1
input_dim: 2
input_dim: 4
input_dim: 4
layer { name: "conv1" type: "Convolution" bottom: "data" top: "conv1"
  convolution_param { num_output: 3 kernel_size: 3 pad: 1 } }
layer { name: "bn1" type: "BatchNorm" bottom: "conv1" top: "bn1" }
layer { name: "sc1" type: "Scale" bottom: "bn1" top: "sc1"
  scale_param { bias_term: true } }
layer { name: "fc1" type: "InnerProduct" bottom: "sc1" top: "fc1"
  inner_product_param { num_output: 4 } }
"""


@pytest.mark.parametrize("proto", [LENET_PROTOTXT, BN_PROTOTXT,
                                   TINY_PROTOTXT],
                         ids=["lenet", "bn-scale", "legacy-header"])
def test_caffe_symbol_is_the_references(proto):
    net = caffe_converter.parse_prototxt(proto)
    assert net == jcaffe.parse_prototxt(proto)
    with mt.name.NameManager():
        sym, shape = caffe_converter.convert(net)
    with mx.name.NameManager():
        jsym, jshape = jcaffe.convert(net)
    assert shape == jshape
    assert sym.list_arguments() == jsym.list_arguments()
    assert sym.list_auxiliary_states() == jsym.list_auxiliary_states()
    assert json.loads(sym.tojson()) == json.loads(jsym.tojson())


def test_caffe_converter_rejects_unknown_layer():
    net = caffe_converter.parse_prototxt("""
layer { name: "data" type: "Input" top: "data"
  input_param { shape { dim: 1 dim: 3 } } }
layer { name: "x" type: "FancyLayer" bottom: "data" top: "x" }
""")
    with pytest.raises(NotImplementedError, match="FancyLayer"):
        caffe_converter.convert(net)


def tiny_caffemodel():
    """A NetParameter for TINY_PROTOTXT, hand-encoded by the reference
    test's encoder, and its true weights."""
    rng = np.random.RandomState(0)
    w = {"W": rng.randn(3, 2, 3, 3).astype(np.float32) * 0.2,
         "bW": rng.randn(3).astype(np.float32),
         "mean": rng.rand(3).astype(np.float32),
         "var": (rng.rand(3) + 0.5).astype(np.float32),
         "gamma": rng.rand(3).astype(np.float32) + 0.5,
         "beta": rng.randn(3).astype(np.float32),
         "fc": rng.randn(4, 3 * 4 * 4).astype(np.float32) * 0.1,
         "fcb": rng.randn(4).astype(np.float32)}
    sf = 2.0        # caffe's scale-factor blob: stats stored times sf
    model = b"".join([
        _enc_layer("conv1", [w["W"], w["bW"]]),
        _enc_layer("bn1", [w["mean"] * sf, w["var"] * sf, np.array([sf])],
                   legacy=True, packed=False),
        _enc_layer("sc1", [w["gamma"], w["beta"]], v1=True),
        _enc_layer("fc1", [w["fc"].reshape(1, 1, 4, 3 * 4 * 4), w["fcb"]],
                   legacy=True),
    ])
    return model, w


def test_caffemodel_reader_is_the_references():
    raw, _ = tiny_caffemodel()
    got = caffe_converter.parse_caffemodel(raw)
    want = jcaffe.parse_caffemodel(raw)
    assert [n for n, _ in got] == [n for n, _ in want] == \
        ["conv1", "bn1", "sc1", "fc1"]
    for (_, gb), (_, wb) in zip(got, want):
        for g, w in zip(gb, wb):
            assert g.shape == w.shape
            np.testing.assert_array_equal(g, w)
    net = caffe_converter.parse_prototxt(TINY_PROTOTXT)
    gw = caffe_converter.caffemodel_weights(net, raw)
    ww = jcaffe.caffemodel_weights(net, raw)
    assert sorted(gw) == sorted(ww) and len(gw) == 8
    for k in gw:
        np.testing.assert_array_equal(gw[k], ww[k], err_msg=k)
    # varints beyond one byte, both readers
    for n in (0, 1, 127, 128, 300, 2 ** 35 + 5):
        enc = b""
        m = n
        while True:
            b7, m = m & 0x7F, m >> 7
            enc += bytes([b7 | (0x80 if m else 0)])
            if not m:
                break
        assert caffe_converter._read_varint(enc, 0) == \
            jcaffe._read_varint(enc, 0) == (n, len(enc))


def numpy_tiny(x, w):
    from numpy.lib.stride_tricks import sliding_window_view
    xp = np.pad(x, ((0, 0), (0, 0), (1, 1), (1, 1)))
    win = sliding_window_view(xp, (3, 3), axis=(2, 3))
    conv = np.einsum("nchwij,ocij->nohw", win, w["W"]) + \
        w["bW"][None, :, None, None]
    c = lambda v: v[None, :, None, None]                        # noqa: E731
    bn = (conv - c(w["mean"])) / np.sqrt(c(w["var"]) + 1e-5)
    bn = bn * c(w["gamma"]) + c(w["beta"])
    return bn.reshape(1, -1) @ w["fc"].T + w["fcb"]


def test_caffemodel_cli_round_trip_forward(tmp_path, capsys):
    raw, w = tiny_caffemodel()
    (tmp_path / "tiny.prototxt").write_text(TINY_PROTOTXT)
    (tmp_path / "tiny.caffemodel").write_bytes(raw)
    prefix = str(tmp_path / "out")
    assert caffe_converter.main([str(tmp_path / "tiny.prototxt"), prefix,
                                 "--caffemodel",
                                 str(tmp_path / "tiny.caffemodel")]) == 0
    assert "parsed 8 parameter tensors" in capsys.readouterr().out
    x = np.random.RandomState(1).randn(1, 2, 4, 4).astype(np.float32)
    shapes = {"data": (1, 2, 4, 4)}
    got = mt.Predictor(prefix + "-symbol.json", prefix + "-0000.params",
                       shapes, ctx=mt.cpu()).forward(data=x)[0].asnumpy()
    # the port's files in the reference's Predictor
    want = mx.predictor.Predictor(
        prefix + "-symbol.json", prefix + "-0000.params", shapes,
        ctx=mx.cpu(0)).forward(data=x)[0].asnumpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got, numpy_tiny(x, w), rtol=1e-4, atol=1e-4)


def test_npz_weights_cli_matches_the_reference_cli(tmp_path):
    """LeNet with ``--weights``: the port's CLI and the reference's
    write the same symbol and the same arrays."""
    proto = tmp_path / "lenet.prototxt"
    proto.write_text(LENET_PROTOTXT)
    rng = np.random.RandomState(0)
    weights = {
        "conv1_weight": rng.randn(8, 1, 5, 5).astype(np.float32) * 0.1,
        "conv1_bias": rng.randn(8).astype(np.float32) * 0.1,
        "ip1_weight": rng.randn(32, 8 * 12 * 12).astype(np.float32) * 0.01,
        "ip1_bias": rng.randn(32).astype(np.float32) * 0.1,
        "ip2_weight": rng.randn(10, 32).astype(np.float32) * 0.1,
        "ip2_bias": rng.randn(10).astype(np.float32) * 0.1,
        "unused_blob": np.zeros(3, np.float32)}
    np.savez(tmp_path / "w.npz", **weights)
    with mt.name.NameManager():
        assert caffe_converter.main([str(proto), str(tmp_path / "port"),
                                     "--weights",
                                     str(tmp_path / "w.npz")]) == 0
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable,
                        os.path.join(ROOT, "tools", "caffe_converter.py"),
                        str(proto), str(tmp_path / "ref"), "--weights",
                        str(tmp_path / "w.npz")],
                       capture_output=True, text=True, env=env, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    got = json.loads((tmp_path / "port-symbol.json").read_text())
    want = json.loads((tmp_path / "ref-symbol.json").read_text())
    assert got == want
    ga = mt.nd.load(str(tmp_path / "port-0000.params"), ctx=mt.cpu())
    wa = mx.nd.load(str(tmp_path / "ref-0000.params"))
    assert sorted(ga) == sorted(wa) and len(ga) == 6
    for k in ga:
        np.testing.assert_array_equal(ga[k].asnumpy(), wa[k].asnumpy())
    x = rng.rand(2, 1, 28, 28).astype(np.float32)
    out = mt.Predictor(str(tmp_path / "port-symbol.json"),
                       str(tmp_path / "port-0000.params"),
                       {"data": (2, 1, 28, 28)},
                       ctx=mt.cpu()).forward(data=x)[0].asnumpy()
    ref = mx.predictor.Predictor(str(tmp_path / "ref-symbol.json"),
                                 str(tmp_path / "ref-0000.params"),
                                 {"data": (2, 1, 28, 28)},
                                 ctx=mx.cpu(0)).forward(data=x)[0].asnumpy()
    np.testing.assert_allclose(out, ref, rtol=RTOL, atol=ATOL)


def reference_era_params(path):
    rng = np.random.RandomState(4)
    d = {"arg:fc_weight": rng.randn(3, 5).astype(np.float32),
         "arg:fc_bias": rng.randn(3).astype(np.float32),
         "aux:bn_moving_mean": rng.randn(3).astype(np.float32)}
    mx.nd.save(path, {k: mx.nd.array(v) for k, v in d.items()},
               format="mxnet")
    return d


@pytest.mark.parametrize("opts,dst", [
    ([], "out.npz"), ([], "out.params"), (["--format", "npz"], "o.params"),
    (["--strip-prefix"], "flat.params"),
    (["--strip-prefix", "--format", "mxnet"], "flat.bin")])
def test_convert_params_matches_the_reference(tmp_path, opts, dst, capsys,
                                              monkeypatch):
    src = str(tmp_path / "m.params")
    reference_era_params(src)
    got_path = str(tmp_path / ("p_" + dst))
    want_path = str(tmp_path / ("r_" + dst))
    assert convert_params.main([src, got_path] + opts) == 0
    monkeypatch.setattr(sys, "argv", ["convert_params.py", src, want_path]
                        + opts)
    assert jconvert.main() == 0
    with open(got_path, "rb") as f, open(want_path, "rb") as g:
        assert f.read() == g.read()     # the same container, byte for byte
    got = mt.nd.load(got_path, ctx=mt.cpu())
    want = mx.nd.load(want_path)
    assert sorted(got) == sorted(want)
    for k in got:
        np.testing.assert_array_equal(got[k].asnumpy(), want[k].asnumpy())


def test_convert_params_refuses_prefixes_on_a_list(tmp_path):
    src = str(tmp_path / "l.params")
    mt.nd.save(src, [mt.nd.array(np.ones(2, np.float32), ctx=mt.cpu())],
               format="mxnet")
    with pytest.raises(SystemExit):
        convert_params.main([src, str(tmp_path / "o.npz"), "--strip-prefix"])


def test_converted_params_load_into_a_module(tmp_path):
    src, dst = str(tmp_path / "m.params"), str(tmp_path / "m.npz")
    d = reference_era_params(src)
    assert convert_params.main([src, dst]) == 0
    data = mt.sym.Variable("data")
    net = mt.sym.FullyConnected(data, num_hidden=3, name="fc")
    mod = mt.mod.Module(net, label_names=None, context=mt.cpu())
    mod.bind(data_shapes=[("data", (2, 5))], for_training=False)
    loaded = mt.nd.load(dst, ctx=mt.cpu())
    mod.set_params({k[4:]: v for k, v in loaded.items()
                    if k.startswith("arg:")}, {})
    args, _ = mod.get_params()
    np.testing.assert_array_equal(args["fc_weight"].asnumpy(),
                                  d["arg:fc_weight"])


CONFIG_LOG = """
2026-01-01 Epoch[0] Batch [10]\tSpeed: 500.00 samples/sec\taccuracy=0.5
2026-01-01 Epoch[0] Batch [20]\tSpeed: 700.00 samples/sec\taccuracy=0.6
2026-01-01 Epoch[0] Train-accuracy=0.650000
2026-01-01 Epoch[0] Time cost=3.500
2026-01-01 Epoch[0] Validation-accuracy=0.700000
2026-01-01 Epoch[1] Train-accuracy=0.900000
2026-01-01 Epoch[1] Time cost=3.100
2026-01-01 Epoch[1] Validation-accuracy=0.950000
"""


def fit_log(tmp_path):
    """The log of a short port ``fit`` with a validation set."""
    rng = np.random.RandomState(0)
    x = rng.randn(64, 6).astype(np.float32)
    y = (x[:, 0] > 0).astype(np.float32)
    data = mt.sym.Variable("data")
    net = mt.sym.SoftmaxOutput(mt.sym.FullyConnected(data, num_hidden=2,
                                                     name="fc"),
                               name="softmax")
    path = tmp_path / "fit.log"
    handler = logging.FileHandler(path)
    logger = logging.getLogger("a10c_fit")
    logger.setLevel(logging.INFO)
    logger.addHandler(handler)
    try:
        with mt.cpu():
            mod = mt.mod.Module(net, logger=logger)
            mod.fit(mt.io.NDArrayIter(x, y, batch_size=16),
                    eval_data=mt.io.NDArrayIter(x, y, batch_size=16),
                    optimizer_params={"learning_rate": 0.1}, num_epoch=3,
                    batch_end_callback=mt.callback.Speedometer(16, 2))
    finally:
        logger.removeHandler(handler)
        handler.close()
    return path.read_text()


@pytest.mark.parametrize("source", ["config-log", "fit-log"])
def test_parse_log_matches_the_reference(tmp_path, capsys, source):
    text = CONFIG_LOG if source == "config-log" else fit_log(tmp_path)
    rows = parse_log.parse(text.splitlines())
    assert rows == jparse.parse(text.splitlines())
    if source == "config-log":
        assert rows[0]["train-accuracy"] == 0.65
        assert rows[0]["speed"] == 600.0
        assert rows[1]["val-accuracy"] == 0.95
    else:
        assert sorted(rows) == [0, 1, 2]
        assert all({"train-accuracy", "val-accuracy", "time"} <= set(r)
                   for r in rows.values())
    f = tmp_path / "t.log"
    f.write_text(text)
    for fmt in ("markdown", "csv"):
        assert parse_log.main([str(f), "--format", fmt]) == 0
        got = capsys.readouterr().out
        assert jparse.main([str(f), "--format", fmt]) == 0
        assert got == capsys.readouterr().out
    (tmp_path / "empty.log").write_text("nothing here\n")
    assert parse_log.main([str(tmp_path / "empty.log")]) == 1


def test_kill_mxnet_ends_a_child_the_test_owns():
    marker = "a10c_kill_%s" % uuid.uuid4().hex
    child = subprocess.Popen([sys.executable, "-c",
                              "import time; time.sleep(600)  # " + marker])
    try:
        deadline = time.monotonic() + 30
        while not kill_mxnet._local_pids(marker) and \
                time.monotonic() < deadline:
            time.sleep(0.05)
        assert kill_mxnet._local_pids(marker) == \
            jkill._local_pids(marker) == [child.pid]
        pids = kill_mxnet.kill_local(marker, grace=3.0)
        assert pids == [child.pid]
        assert child.wait(timeout=30) == -15        # SIGTERM was enough
        assert kill_mxnet._local_pids(marker) == []
    finally:
        if child.poll() is None:
            child.kill()
            child.wait(timeout=30)
