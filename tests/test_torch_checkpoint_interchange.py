"""A ResNet checkpoint that one package writes loads in the other.

The checkpoint is the reference's pair of files: ``prefix-symbol.json``
and ``prefix-%04d.params`` with the arg params under ``arg:<name>`` and
the aux states under ``aux:<name>``, the params in the reference's npz
archive (what ``save_checkpoint`` writes) or in MXNet's binary
``.params`` format (``nd.save(..., format="mxnet")``). A ResNet-18 (v2,
s2d stem, 64x64) with numpy-seeded weights and moving statistics away
from their initial 0 and 1 is written by one package and read by the
other, through ``model.load_checkpoint`` and ``Module.load``: every
array arrives bit for bit, and an inference forward of the loaded
module (which normalises with the moving statistics, so it needs the aux
states carried) equals the writer's to 5e-5. That forward is f32 in both
packages, the same formulas summed in another order, through 18 layers
whose random moving statistics do not normalise the activations, which
grow: measured 6.6e-6.
"""
import numpy as np
import pytest

import mxnet_tpu as mx
from mxnet_tpu.models import resnet as jax_resnet
import mxnet_tpu_torch as mt
from mxnet_tpu_torch.models import resnet as port_resnet

ATOL = 5e-5
N, H = 2, 64
KW = dict(num_layers=18, image_shape="3,%d,%d" % (H, H), stem="s2d",
          num_classes=10)
DATA = [("data", (N, 3, H, H))]
LABEL = [("softmax_label", (N,))]


@pytest.fixture(scope="module")
def weights():
    """Arg and aux params as numpy, and one batch."""
    sym = port_resnet.get_symbol(**KW)
    mod = mt.mod.Module(sym, context=mt.cpu())
    mod.bind(data_shapes=DATA, label_shapes=LABEL, for_training=False)
    mod.init_params(mt.init.Xavier(rnd_type="gaussian", factor_type="in",
                                   magnitude=2).set_rng(
                                       np.random.default_rng(3)))
    args, aux = mod.get_params()
    rng = np.random.default_rng(4)
    aux = {k: (rng.uniform(0.5, 1.5, v.shape) if k.endswith("var") else
               rng.normal(0.0, 0.3, v.shape)).astype(np.float32)
           for k, v in aux.items()}
    x = rng.uniform(-1, 1, (N, 3, H, H)).astype(np.float32)
    return {k: v.asnumpy() for k, v in args.items()}, aux, x


def _reference_forward(mod, x):
    mod.forward(mx.io.DataBatch([mx.nd.array(x)], []), is_train=False)
    return mod.get_outputs()[0].asnumpy()


def _port_forward(mod, x):
    mod.forward(mt.io.DataBatch([mt.nd.array(x, ctx=mt.cpu())], []),
                is_train=False)
    return mod.get_outputs()[0].asnumpy()


def _reference_module(sym, args, aux):
    mod = mx.mod.Module(sym, context=mx.cpu())
    mod.bind(data_shapes=DATA, label_shapes=LABEL, for_training=False)
    mod.set_params({k: mx.nd.array(v) for k, v in args.items()},
                   {k: mx.nd.array(v) for k, v in aux.items()})
    return mod


def _port_module(sym, args, aux):
    mod = mt.mod.Module(sym, context=mt.cpu())
    mod.bind(data_shapes=DATA, label_shapes=LABEL, for_training=False)
    mod.set_params(args, aux)
    return mod


@pytest.mark.parametrize("fmt", ["npz", "mxnet"])
def test_reference_checkpoint_loads_in_the_port(weights, tmp_path, fmt):
    args, aux, x = weights
    jm = _reference_module(jax_resnet.get_symbol(**KW), args, aux)
    want = _reference_forward(jm, x)
    prefix = str(tmp_path / "resnet18")
    if fmt == "npz":
        mx.model.save_checkpoint(prefix, 3, jm.symbol, *jm.get_params())
    else:
        jm.symbol.save(prefix + "-symbol.json")
        ja, jx = jm.get_params()
        blob = {"arg:" + k: v for k, v in ja.items()}
        blob.update({"aux:" + k: v for k, v in jx.items()})
        mx.nd.save(prefix + "-0003.params", blob, format="mxnet")
    with mt.device_scope("cpu"):
        sym, p_args, p_aux = mt.model.load_checkpoint(prefix, 3)
    assert sorted(p_args) == sorted(args) and sorted(p_aux) == sorted(aux)
    assert sym.list_auxiliary_states() == \
        jm.symbol.list_auxiliary_states()
    for k, v in list(p_args.items()) + list(p_aux.items()):
        np.testing.assert_array_equal(v.asnumpy(), {**args, **aux}[k])
    np.testing.assert_allclose(
        _port_forward(_port_module(sym, p_args, p_aux), x), want, atol=ATOL)
    pm = mt.mod.Module.load(prefix, 3, context=mt.cpu())
    pm.bind(data_shapes=DATA, label_shapes=LABEL, for_training=False)
    np.testing.assert_allclose(_port_forward(pm, x), want, atol=ATOL)


@pytest.mark.parametrize("fmt", ["npz", "mxnet"])
def test_port_checkpoint_loads_in_the_reference(weights, tmp_path, fmt):
    args, aux, x = weights
    pm = _port_module(port_resnet.get_symbol(**KW), args, aux)
    want = _port_forward(pm, x)
    prefix = str(tmp_path / "resnet18")
    if fmt == "npz":
        pm.save_checkpoint(prefix, 7)
    else:
        pm.symbol.save(prefix + "-symbol.json")
        pa, px = pm.get_params()
        blob = {"arg:" + k: v for k, v in pa.items()}
        blob.update({"aux:" + k: v for k, v in px.items()})
        mt.nd.save(prefix + "-0007.params", blob, format="mxnet")
    sym, j_args, j_aux = mx.model.load_checkpoint(prefix, 7)
    assert sorted(j_args) == sorted(args) and sorted(j_aux) == sorted(aux)
    for k, v in list(j_args.items()) + list(j_aux.items()):
        np.testing.assert_array_equal(v.asnumpy(), {**args, **aux}[k])
    jm = mx.mod.Module.load(prefix, 7, context=mx.cpu())
    jm.bind(data_shapes=DATA, label_shapes=LABEL, for_training=False)
    np.testing.assert_allclose(_reference_forward(jm, x), want, atol=ATOL)


def test_nd_save_load_round_trip_keeps_lists_names_and_dtypes(tmp_path):
    cpu = mt.cpu()
    arrays = {"a": mt.nd.array(np.arange(6).reshape(2, 3), ctx=cpu),
              "b": mt.nd.array(np.arange(4), ctx=cpu, dtype="int32")}
    for fmt in ("npz", "mxnet"):
        path = str(tmp_path / ("named." + fmt))
        mt.nd.save(path, arrays, format=fmt)
        back = mt.nd.load(path, ctx=cpu)
        assert list(back) == ["a", "b"]
        assert back["b"].dtype == np.int32
        np.testing.assert_array_equal(back["a"].asnumpy(),
                                      arrays["a"].asnumpy())
        path = str(tmp_path / ("list." + fmt))
        mt.nd.save(path, list(arrays.values()), format=fmt)
        back = mt.nd.load(path, ctx=cpu)
        assert isinstance(back, list) and len(back) == 2
        ref = mx.nd.load(path)          # and the reference reads it
        assert isinstance(ref, list)
        np.testing.assert_array_equal(ref[1].asnumpy(), np.arange(4))
    with pytest.raises(ValueError, match="unknown save format"):
        mt.nd.save(str(tmp_path / "x"), arrays, format="hdf5")
