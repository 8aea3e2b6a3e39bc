"""The port's ``Predictor`` and its export against the reference's
(oracle: ``tests/test_predictor.py``).

A small convnet trained by the reference's ``Module.fit`` is
checkpointed by the reference; the port's ``Predictor`` loads that
checkpoint (``from_checkpoint``, a parameter dict, the JSON string) and
its outputs agree with the reference's ``Module.predict`` within 1e-5
(rtol, atol 1e-6: the oracle's own tolerance). LeNet's export is run
by ``mxnet_tpu_torch/tools/predict_exported.py`` in a subprocess with
no framework on its path, within 1e-5 of ``Predictor.forward``; a graph
that reaches one of the port's hand-written kernels must not export.
"""
import ast
import importlib.util
import os
import subprocess
import sys
import zipfile
from pathlib import Path

import numpy as np
import pytest
import torch

import mxnet_tpu as mx
import mxnet_tpu_torch as mt
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.predictor import EXPORT_FORMAT, Predictor

# test files run side by side in parallel workers: each keeps torch's
# intra-op pool small
torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parent.parent
TOOL = ROOT / "mxnet_tpu_torch" / "tools" / "predict_exported.py"
CPU = mt.cpu()


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """The oracle's ``_train_small``: the reference trains and
    checkpoints a conv net, and predicts the 64 samples."""
    tmp = tmp_path_factory.mktemp("pred")
    rng = np.random.RandomState(0)
    x = rng.rand(64, 1, 8, 8).astype(np.float32)
    y = (x.mean(axis=(1, 2, 3)) > x.mean()).astype(np.float32)
    data = mx.sym.Variable("data")
    net = mx.sym.Convolution(data, kernel=(3, 3), num_filter=4, name="cv")
    net = mx.sym.Activation(net, act_type="relu")
    net = mx.sym.Flatten(net)
    net = mx.sym.FullyConnected(net, num_hidden=2, name="fc")
    sym = mx.sym.SoftmaxOutput(net, name="softmax")
    it = mx.io.NDArrayIter(x, y, batch_size=16, label_name="softmax_label")
    mod = mx.mod.Module(sym, context=mx.cpu())
    mod.fit(it, num_epoch=2, optimizer="sgd",
            optimizer_params={"learning_rate": 0.1},
            initializer=mx.init.Xavier())
    prefix = str(tmp / "m")
    mod.save_checkpoint(prefix, 2)
    it.reset()
    ref = mod.predict(it).asnumpy()
    return prefix, x, ref


def test_predictor_from_checkpoint_matches_module(trained):
    """A reference-written checkpoint through the port's
    ``from_checkpoint``: the reference's ``Module.predict`` rows."""
    prefix, x, ref = trained
    pred = Predictor.from_checkpoint(prefix, 2,
                                     input_shapes={"data": (16, 1, 8, 8)},
                                     ctx=CPU)
    outs = []
    for s in range(0, 64, 16):
        pred.forward(data=x[s:s + 16])
        outs.append(pred.get_output(0).asnumpy())
    np.testing.assert_allclose(np.concatenate(outs), ref,
                               rtol=1e-5, atol=1e-6)
    assert len(pred.outputs) == 1


def test_predictor_reshape_and_validation(trained):
    prefix, x, ref = trained
    pred = Predictor.from_checkpoint(prefix, 2,
                                     input_shapes={"data": (16, 1, 8, 8)},
                                     ctx=CPU)
    with pytest.raises(ValueError):
        pred.set_input("data", x[:4])          # wrong batch for the bind
    with pytest.raises(KeyError):
        pred.set_input("nope", x[:16])
    pred.reshape({"data": (4, 1, 8, 8)})       # MXPredReshape parity
    pred.forward(data=x[:4])
    np.testing.assert_allclose(pred.get_output(0).asnumpy(), ref[:4],
                               rtol=1e-5, atol=1e-6)


def test_predictor_from_param_dict_and_json_string(trained):
    """The same checkpoint as an ``arg:`` / ``aux:`` dict and a JSON
    string, and as the raw ``.params`` bytes; also through the
    top-level ``mt.Predictor`` and ``mt.predictor``."""
    prefix, x, ref = trained
    with open(prefix + "-symbol.json") as f:
        sym_json = f.read()
    _, arg_params, aux_params = mx.model.load_checkpoint(prefix, 2)
    params = {"arg:" + k: v.asnumpy() for k, v in arg_params.items()}
    params.update({"aux:" + k: v.asnumpy() for k, v in aux_params.items()})
    assert mt.Predictor is mt.predictor.Predictor is Predictor
    pred = mt.Predictor(sym_json, params,
                        input_shapes={"data": (16, 1, 8, 8)}, ctx=CPU)
    pred.forward(data=x[:16])
    np.testing.assert_allclose(pred.get_output(0).asnumpy(), ref[:16],
                               rtol=1e-5, atol=1e-6)
    with open("%s-%04d.params" % (prefix, 2), "rb") as f:
        blob = f.read()
    pred = Predictor(sym_json, blob, [("data", (16, 1, 8, 8))], ctx=CPU)
    out = pred.forward(data=x[16:32])[0].asnumpy()
    np.testing.assert_allclose(out, ref[16:32], rtol=1e-5, atol=1e-6)


def test_predictor_missing_param_raises(trained):
    prefix, _, _ = trained
    with open(prefix + "-symbol.json") as f:
        sym_json = f.read()
    with pytest.raises(ValueError):
        Predictor(sym_json, {}, input_shapes={"data": (16, 1, 8, 8)},
                  ctx=CPU)


def _lenet_pair(seed=5):
    """LeNet in both packages with the reference's Xavier weights."""
    from mxnet_tpu.models import lenet as jlenet
    from mxnet_tpu_torch.models import lenet
    sym = jlenet.get_symbol(num_classes=10)
    mod = mx.mod.Module(sym, context=mx.cpu(0))
    mod.bind(data_shapes=[("data", (2, 1, 28, 28))],
             label_shapes=[("softmax_label", (2,))], for_training=False)
    mod.init_params(mx.init.Xavier())
    args, auxs = mod.get_params()
    blob = {"arg:%s" % k: v.asnumpy() for k, v in args.items()}
    blob.update({"aux:%s" % k: v.asnumpy() for k, v in auxs.items()})
    jpred = mx.predictor.Predictor(sym.tojson(), blob,
                                   {"data": (2, 1, 28, 28)}, ctx=mx.cpu(0))
    pred = Predictor(lenet.get_symbol(num_classes=10).tojson(), blob,
                     {"data": (2, 1, 28, 28)}, ctx=CPU)
    x = np.random.RandomState(seed).rand(2, 1, 28, 28).astype(np.float32)
    return pred, jpred, x


def test_predictor_export_runs_without_framework(tmp_path):
    """``Predictor.export`` -> the ``torch.export`` artifact, run by the
    standalone loader in-process and as a CLI in a subprocess from a
    neutral working directory with no ``PYTHONPATH``: outputs within
    1e-5 of ``forward`` (and of the reference's), and the subprocess
    never imports the framework."""
    pred, jpred, x = _lenet_pair()
    ref = pred.forward(data=x)[0].asnumpy()
    np.testing.assert_allclose(ref, jpred.forward(data=x)[0].asnumpy(),
                               rtol=1e-5, atol=1e-6)
    art = str(tmp_path / "lenet.mxprog")
    assert pred.export(art) == art
    assert not [p for p in os.listdir(tmp_path) if p != "lenet.mxprog"], \
        "export left a temporary file beside the artifact"
    with zipfile.ZipFile(art) as z:
        assert sorted(z.namelist()) == ["manifest.json", "program.pt2",
                                        "weights.npz"]
    # by path, under a name of its own: the reference's loader of the
    # same file name may be imported in this process too
    spec = importlib.util.spec_from_file_location("port_predict_exported",
                                                  TOOL)
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    call, manifest = tool.load_artifact(art)
    assert manifest["format"] == EXPORT_FORMAT
    assert manifest["inputs"] == ["data"]
    assert manifest["input_shapes"] == {"data": [2, 1, 28, 28]}
    assert manifest["device"] == "cpu"
    assert manifest["weights"][:2] == ["conv1_weight", "conv1_bias"]
    assert manifest["tf32"] == {
        "matmul": bool(torch.backends.cuda.matmul.allow_tf32),
        "cudnn": bool(torch.backends.cudnn.allow_tf32)}
    np.testing.assert_allclose(call(data=x)[0], ref, rtol=1e-5, atol=1e-6)

    xp = str(tmp_path / "x.npy")
    np.save(xp, x)
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    code = ("import runpy, sys\n"
            "sys.argv = %r\n"
            "try:\n"
            "    runpy.run_path(%r, run_name='__main__')\n"
            "except SystemExit as e:\n"
            "    assert not e.code, e.code\n"
            "bad = sorted(m for m in sys.modules\n"
            "             if m.split('.')[0] in ('mxnet_tpu_torch',\n"
            "                                    'mxnet_tpu', 'jax'))\n"
            "print('FRAMEWORK-MODULES', bad)\n"
            % ([str(TOOL), art, "--input", "data=%s" % xp, "--device",
                "cpu", "--save", str(tmp_path / "y.npz")], str(TOOL)))
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, env=env, cwd=str(tmp_path), timeout=240)
    assert r.returncode == 0, r.stderr[-2000:]
    assert "output[0] shape=(2, 10)" in r.stdout
    assert "FRAMEWORK-MODULES []" in r.stdout
    with np.load(tmp_path / "y.npz") as z:
        np.testing.assert_allclose(z["output_0"], ref, rtol=1e-5, atol=1e-6)


def test_export_records_the_exporters_tf32_switches(tmp_path,
                                                    monkeypatch):
    """The artifact computes at the precision ``forward`` ran at where it
    was exported: the manifest records the exporting process's TF32
    switches, the loader reads them (float32 when a manifest has none)
    and leaves the caller's switches as they were after a call."""
    data = mt.sym.Variable("data")
    sym = mt.sym.FullyConnected(data, num_hidden=3, name="fc")
    rng = np.random.RandomState(0)
    params = {"fc_weight": rng.rand(3, 4).astype(np.float32),
              "fc_bias": rng.rand(3).astype(np.float32)}
    pred = Predictor(sym.tojson(), params, {"data": (2, 4)}, ctx=CPU)
    spec = importlib.util.spec_from_file_location("port_predict_exported",
                                                  TOOL)
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    assert tool.precision({}) == {"matmul": False, "cudnn": False}
    x = rng.rand(2, 4).astype(np.float32)
    want = pred.forward(data=x)[0].asnumpy()
    for matmul, cudnn in ((True, False), (False, True)):
        monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32",
                            matmul)
        monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", cudnn)
        art = str(tmp_path / ("fc_%d%d.mxprog" % (matmul, cudnn)))
        pred.export(art)
        call, manifest = tool.load_artifact(art)
        assert manifest["tf32"] == {"matmul": matmul, "cudnn": cudnn}
        assert tool.precision(manifest) == manifest["tf32"]
        monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32",
                            not matmul)
        monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", not cudnn)
        np.testing.assert_allclose(call(data=x)[0], want, rtol=1e-6,
                                   atol=1e-7)
        assert torch.backends.cuda.matmul.allow_tf32 is (not matmul)
        assert torch.backends.cudnn.allow_tf32 is (not cudnn)


def test_export_of_a_flash_attention_graph_raises(tmp_path):
    """The flash kernels are called through ctypes, which torch.export
    cannot trace; exporting their plain version would compute something
    other than forward() on the card. So export raises, naming the op,
    and writes nothing."""
    from mxnet_tpu_torch.models import transformer
    sym = transformer.get_symbol(vocab_size=16, num_layers=1, d_model=8,
                                 n_heads=2, seq_len=4, attention="flash")
    shapes = {"data": (1, 4), "softmax_label": (1, 4)}
    arg_shapes, _, _ = sym.infer_shape(**shapes)
    rng = np.random.RandomState(0)
    params = {n: rng.rand(*s).astype(np.float32)
              for n, s in zip(sym.list_arguments(), arg_shapes)
              if n not in shapes}
    pred = Predictor(sym.tojson(), params, shapes, ctx=CPU)
    pred.forward(data=np.zeros((1, 4), np.float32))
    art = tmp_path / "lm.mxprog"
    with pytest.raises(MXNetError, match="FlashAttention"):
        pred.export(str(art))
    assert not art.exists()


def test_export_of_custom_and_rtc_graphs_raises(tmp_path):
    from mxnet_tpu_torch import operator

    class _Twice(operator.CustomOp):
        def forward(self, is_train, req, in_data, out_data, aux):
            self.assign(out_data[0], req[0], in_data[0] * 2)

    @operator.register("tpred_twice")
    class _TwiceProp(operator.CustomOpProp):
        def create_operator(self, ctx, shapes, dtypes):
            return _Twice()

    data = mt.sym.Variable("data")
    sym = mt.sym.Custom(data, op_type="tpred_twice", name="twice")
    pred = Predictor(sym.tojson(), {}, {"data": (2, 3)}, ctx=CPU)
    np.testing.assert_allclose(
        pred.forward(data=np.ones((2, 3), np.float32))[0].asnumpy(), 2.0)
    with pytest.raises(MXNetError, match="Custom"):
        pred.export(str(tmp_path / "c.mxprog"))

    from mxnet_tpu_torch import rtc_examples
    kern = rtc_examples.relu((2, 3))
    kern.register("tpred_relu_op")
    sym = mt.sym.tpred_relu_op(mt.sym.Variable("data"), name="relu")
    pred = Predictor(sym.tojson(), {}, {"data": (2, 3)}, ctx=CPU)
    with pytest.raises(MXNetError, match="rtc kernel"):
        pred.export(str(tmp_path / "r.mxprog"))


def test_predict_exported_imports_only_torch_numpy_stdlib():
    """The loader is standalone: every import in it is torch, numpy or
    the standard library (the import scan of ``test_torch_import.py``
    covers jax and the reference)."""
    tree = ast.parse(TOOL.read_text())
    tops = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            tops.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            assert node.level == 0, "relative import in the loader"
            tops.add(node.module.split(".")[0])
    assert tops <= {"torch", "numpy"} | set(sys.stdlib_module_names), tops
