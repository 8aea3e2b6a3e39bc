"""The layer ops and loss heads of the port against the reference's
(``mxnet_tpu/ops/nn.py``).

The sweep runs each shared op at ``tests/test_op_sweep.py``'s inputs,
the gradient under one random head included: for a loss head that is
the reference's ``custom_vjp`` against the port's
``torch.autograd.Function``, both ignoring the head (or, for
``IdentityAttachKLSparseReg``, adding the penalty to it). The cases
after it cover the heads' attributes (``grad_scale``, ``normalization``
and ``valid_thresh``, ``margin``, ``regularization_coefficient``,
``use_linear``, the KL penalty's), ``UpSampling`` at its borders and
with several inputs, ``L2Normalization``'s three modes, ``LRN``'s window
widths, exponents and bf16 input, ``InstanceNorm``,
``LayerNorm(output_mean_var=True)``, ``SoftmaxActivation``'s channel mode,
``Convolution_v1``, and the KL head's aux state through a bound symbol.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import mxnet_tpu as mx
import mxnet_tpu_torch as mt
from mxnet_tpu.ops import get_op as ref_op
from test_torch_ops_parity import (assert_close, check_op, sweep_case,
                                   sweep_names)
from mxnet_tpu_torch.ops import get_op

# test files run side by side in parallel workers: each keeps torch's
# intra-op pool small
torch.set_num_threads(2)

NAMES = sweep_names("nn")


@pytest.mark.parametrize("name", NAMES)
def test_sweep(name):
    inputs, attrs = sweep_case(name)
    check_op(name, inputs, attrs)


def _data(seed, *shape, low=None, high=None):
    rng = np.random.default_rng(seed)
    if low is not None:
        return rng.uniform(low, high, shape).astype(np.float32)
    return rng.standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("name", ["LinearRegressionOutput",
                                  "MAERegressionOutput",
                                  "LogisticRegressionOutput"])
@pytest.mark.parametrize("shape, grad_scale", [((4, 3), 1.0), ((4, 1), 2.5),
                                               ((5,), 0.5)])
def test_regression_heads(name, shape, grad_scale):
    check_op(name, [_data(1, *shape), _data(2, *shape, low=0, high=1)],
             {"grad_scale": grad_scale})


@pytest.mark.parametrize("attrs", [{}, {"grad_scale": 3.0},
                                   {"normalization": "batch"},
                                   {"normalization": "valid",
                                    "valid_thresh": 0.5}])
def test_make_loss(attrs):
    check_op("MakeLoss", [_data(3, 4, 3)], attrs)


@pytest.mark.parametrize("attrs", [{}, {"margin": 0.5},
                                   {"regularization_coefficient": 0.3},
                                   {"use_linear": True, "margin": 2.0}])
def test_svm_output(attrs):
    check_op("SVMOutput", [_data(4, 5, 4), np.array([0, 3, 1, 2, 3],
                                                    np.float32)], attrs)


@pytest.mark.parametrize("attrs", [{}, {"sparseness_target": 0.3,
                                        "penalty": 0.1, "momentum": 0.5}])
def test_kl_sparse_reg(attrs):
    check_op("IdentityAttachKLSparseReg",
             [_data(5, 4, 2, 3, low=0.05, high=0.95),
              _data(6, 6, low=0.2, high=0.8)], attrs)


def test_kl_sparse_reg_aux_through_a_bound_symbol():
    """The moving average is an aux state named ``<name>_moving_avg`` of
    the units' count: committed by a training forward, used by the
    backward, the same in both packages."""
    x0 = _data(7, 4, 6, low=0.05, high=0.95)
    w0 = _data(8, 6, 6) * 0.3
    g0 = _data(9, 4, 6)
    results = []
    for pkg, ctx in ((mx, mx.cpu()), (mt, mt.cpu())):
        data = pkg.sym.Variable("data")
        fc = pkg.sym.FullyConnected(data, num_hidden=6, no_bias=True,
                                    name="fc")
        net = pkg.sym.IdentityAttachKLSparseReg(
            pkg.sym.Activation(fc, act_type="sigmoid", name="sig"),
            penalty=0.01, name="kl")
        assert net.list_auxiliary_states() == ["kl_moving_avg"]
        assert net.infer_shape(data=(4, 6))[2] == [(6,)]
        ex = net.simple_bind(ctx, data=(4, 6))
        ex.arg_dict["data"][:] = x0
        ex.arg_dict["fc_weight"][:] = w0
        ex.aux_dict["kl_moving_avg"][:] = np.full(6, 0.5, np.float32)
        out = ex.forward(is_train=True)[0].asnumpy()
        ex.backward([pkg.nd.array(g0, ctx=ctx)])
        results.append((out, ex.grad_dict["fc_weight"].asnumpy(),
                        ex.aux_dict["kl_moving_avg"].asnumpy()))
    for what, got, want in zip(("output", "weight gradient", "moving_avg"),
                               results[1], results[0]):
        assert_close(got, want, 1e-5, what)


@pytest.mark.parametrize("scale", [2, 3])
@pytest.mark.parametrize("sample_type", ["nearest", "bilinear"])
def test_upsampling_borders(scale, sample_type):
    """Every output pixel, the borders included (half-pixel centres;
    near an edge only the edge pixel contributes)."""
    ref, port = check_op("UpSampling", [_data(10, 2, 3, 4, 5)],
                         {"scale": scale, "sample_type": sample_type})
    out = port["outs"][0]
    assert out.shape == (2, 3, 4 * scale, 5 * scale)
    if sample_type == "bilinear":
        x = _data(10, 2, 3, 4, 5)
        assert_close(out[..., 0, 0], x[..., 0, 0], 1e-6, "corner")
        assert_close(out[..., -1, -1], x[..., -1, -1], 1e-6, "corner")


@pytest.mark.parametrize("mode", ["concat", "sum"])
@pytest.mark.parametrize("sample_type", ["nearest", "bilinear"])
def test_upsampling_several_inputs(mode, sample_type):
    """Each input to the first one's size times ``scale``."""
    ins = [_data(11, 1, 2, 3, 3), _data(12, 1, 2, 6, 6)]
    check_op("UpSampling", ins, {"scale": 4, "sample_type": sample_type,
                                 "multi_input_mode": mode, "num_args": 2})


@pytest.mark.parametrize("mode", ["instance", "channel", "spatial"])
def test_l2_normalization_modes(mode):
    check_op("L2Normalization", [_data(13, 2, 3, 4, 5)], {"mode": mode})


@pytest.mark.parametrize("attrs", [{"nsize": 5}, {"nsize": 3, "knorm": 1.0},
                                   {"nsize": 4}, {"nsize": 5, "beta": 0.5,
                                                  "alpha": 0.01}])
def test_lrn_windows(attrs):
    check_op("LRN", [_data(14, 2, 7, 4, 3) * 10], attrs)


def test_lrn_keeps_f32_statistics_in_bf16():
    """bf16 in, bf16 out, statistics in f32: within one bf16 step of the
    reference's bf16 output."""
    x = _data(15, 2, 6, 5, 5) * 10
    want = np.asarray(ref_op("LRN").fn(jnp.asarray(x).astype(jnp.bfloat16),
                                       nsize=5).astype(jnp.float32))
    got = get_op("LRN").fn(torch.from_numpy(x).bfloat16(), nsize=5)
    assert got.dtype == torch.bfloat16
    assert_close(got.float().numpy(), want, 2.0 ** -8, "bf16 LRN")


@pytest.mark.parametrize("shape, eps", [((2, 3, 4, 5), 1e-3),
                                        ((3, 2, 6), 1e-5)])
def test_instance_norm(shape, eps):
    c = shape[1]
    check_op("InstanceNorm", [_data(16, *shape), _data(17, c) + 1,
                              _data(18, c)], {"eps": eps})


@pytest.mark.parametrize("axis", [-1, 1])
def test_layer_norm_output_mean_var(axis):
    x = _data(19, 2, 5, 6)
    n = x.shape[axis]
    ref, port = check_op("LayerNorm", [x, _data(20, n) + 1, _data(21, n)],
                         {"axis": axis, "output_mean_var": True})
    assert len(port["outs"]) == 3


def test_layer_norm_output_mean_var_in_symbols():
    data = mt.sym.Variable("data")
    s = mt.sym.LayerNorm(data, output_mean_var=True, name="ln")
    assert s.list_outputs() == ["ln_output", "ln_output1", "ln_output2"]
    assert s.infer_shape(data=(2, 5, 6))[1] == [(2, 5, 6), (2, 5), (2, 5)]


@pytest.mark.parametrize("mode", ["instance", "channel"])
def test_softmax_activation_modes(mode):
    check_op("SoftmaxActivation", [_data(22, 2, 3, 4)], {"mode": mode})


def test_convolution_v1_is_convolution():
    assert get_op("Convolution_v1") is get_op("Convolution")
    check_op("Convolution_v1", [_data(23, 1, 2, 5, 5), _data(24, 3, 2, 3, 3),
                                _data(25, 3)],
             {"kernel": (3, 3), "num_filter": 3, "pad": (1, 1)})


def test_loss_heads_infer_their_label_shapes():
    """The derived shape rules: regression labels take the data's shape,
    SVM's the batch, InstanceNorm's gamma and beta the channels."""
    data = mt.sym.Variable("data")
    for name, want in (("LinearRegressionOutput", (4, 3)),
                       ("LogisticRegressionOutput", (4, 3)),
                       ("MAERegressionOutput", (4, 3)),
                       ("SVMOutput", (4,))):
        s = getattr(mt.sym, name)(data, name="head")
        args, _, _ = s.infer_shape(data=(4, 3))
        assert dict(zip(s.list_arguments(), args))["head_label"] == want
    s = mt.sym.InstanceNorm(mt.sym.Variable("data"), name="inorm")
    args, _, _ = s.infer_shape(data=(2, 5, 4, 4))
    assert args == [(2, 5, 4, 4), (5,), (5,)]
