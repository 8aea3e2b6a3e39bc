"""The elementwise, reduction and creation ops of the port against the
reference's (``mxnet_tpu/ops/{elemwise,reduce,init_op}.py``).

The sweep runs every shared op of the three files at
``tests/test_op_sweep.py``'s inputs through ``test_torch_ops_parity``'s
helper (forward within 1e-5·max(1, max|ref|), the gradient of every
input under one random head within 1e-4); the cases after it cover the
attributes the sweep leaves at their defaults: the divisor's sign of
``mod``, comparisons on equal values, ``broadcast_to``'s
0, several broadcast axes, NaN in ``nansum`` / ``nanprod``, and the
creation ops' shapes and dtypes.
"""
import numpy as np
import pytest
import torch

from test_torch_ops_parity import (assert_close, check_op, sweep_case,
                                   sweep_names)
from mxnet_tpu_torch.ops import get_op

NAMES = sweep_names("elemwise", "reduce", "init_op")


@pytest.mark.parametrize("name", NAMES)
def test_sweep(name):
    inputs, attrs = sweep_case(name)
    check_op(name, inputs, attrs)


def _signed(seed, shape):
    rng = np.random.default_rng(seed)
    return (rng.uniform(0.3, 3.0, shape) *
            rng.choice([-1.0, 1.0], shape)).astype(np.float32)


@pytest.mark.parametrize("name", ["broadcast_mod", "_mod", "broadcast_power",
                                  "broadcast_hypot", "minimum",
                                  "broadcast_minimum"])
def test_binary_with_either_sign(name):
    """``mod`` takes the divisor's sign (``jnp.mod``), on every sign
    pair and broadcast across a leading axis."""
    lhs, rhs = _signed(1, (3, 4)), _signed(2, (1, 4))
    if name == "broadcast_power":
        lhs = np.abs(lhs)
    check_op(name, [lhs, rhs])


@pytest.mark.parametrize("scalar", [2.5, -2.5])
def test_mod_scalar_with_either_sign(scalar):
    check_op("_mod_scalar", [_signed(3, (2, 5))], {"scalar": scalar})


@pytest.mark.parametrize("name", ["_power_scalar", "_rpower_scalar",
                                  "_maximum_scalar", "_minimum_scalar"])
@pytest.mark.parametrize("scalar", [0.5, 1.7])
def test_scalar_ops(name, scalar):
    x = np.abs(_signed(4, (3, 3))) if "power" in name else _signed(4, (3, 3))
    check_op(name, [x], {"scalar": scalar})


@pytest.mark.parametrize("name", ["equal", "not_equal", "greater",
                                  "greater_equal", "lesser", "lesser_equal"])
def test_comparisons_on_ties(name):
    """1 or 0 in the left operand's dtype, the scalar form and both
    broadcasting names, with equal values present."""
    lhs = np.array([[1, 2, 3], [3, 2, 1]], np.float32)
    rhs = np.array([[2, 2, 2]], np.float32)
    for op in ("broadcast_" + name, "_" + name):
        check_op(op, [lhs, rhs], grads=False)
    check_op("_%s_scalar" % name, [lhs], {"scalar": 2.0}, grads=False)


def test_identity_and_copy_are_copies():
    x = torch.arange(4.0)
    for name in ("identity", "_copy"):
        out = get_op(name).fn(x)
        out[0] = 9.0
        assert x[0] == 0.0


@pytest.mark.parametrize("scalar", [1.0, 2.0, 0.5])
def test_smooth_l1_across_the_threshold(scalar):
    x = np.linspace(-3, 3, 25, dtype=np.float32).reshape(5, 5)
    check_op("smooth_l1", [x], {"scalar": scalar})


@pytest.mark.parametrize("shape", [(2, 0, 4), (0, 3, 0), (2, 3, 4),
                                   (5, 2, 3, 4)])
def test_broadcast_to(shape):
    """A 0 keeps the input's length; a longer shape adds leading
    axes."""
    x = _signed(5, (2, 1, 4)) if shape != (0, 3, 0) else _signed(5, (2, 1, 4))
    check_op("broadcast_to", [x], {"shape": shape})


@pytest.mark.parametrize("name", ["broadcast_axis", "broadcast_axes"])
def test_broadcast_axis_over_several_axes(name):
    check_op(name, [_signed(6, (1, 3, 1))], {"axis": (0, 2), "size": (4, 5)})


@pytest.mark.parametrize("name", ["nansum", "nanprod"])
@pytest.mark.parametrize("attrs", [{}, {"axis": 1}, {"axis": (0, 2),
                                                    "keepdims": True},
                                   {"axis": 1, "exclude": True}])
def test_nan_reductions(name, attrs):
    x = _signed(7, (3, 4, 2)) * 0.7
    x[0, 1, 0] = x[2, 3, 1] = np.nan
    check_op(name, [x], attrs)


def test_argmax_channel():
    check_op("argmax_channel", [_signed(8, (4, 6))])


@pytest.mark.parametrize("name, attrs", [
    ("_zeros", {"shape": (2, 3), "dtype": "int32"}),
    ("_ones", {"shape": 4}),
    ("_full", {"shape": (3, 1), "value": -2.5}),
    ("_eye", {"N": 3, "M": 5, "k": 1}),
    ("_eye", {"N": 4, "k": -2, "dtype": "int32"}),
    ("_arange", {"start": 2, "stop": 11, "step": 3, "repeat": 2}),
])
def test_creation_ops(name, attrs):
    check_op(name, [], attrs)


def test_creation_ops_in_nd_and_sym():
    import mxnet_tpu_torch as mt
    with mt.device_scope("cpu"):
        assert mt.nd.full(shape=(2, 2), value=3.0).asnumpy().sum() == 12.0
        assert_close(mt.nd.eye(N=3).asnumpy(), np.eye(3), 0, "eye")
        s = mt.sym.ones(shape=(2, 5)) + mt.sym.Variable("x")
        _, out, _ = s.infer_shape(x=(2, 5))
        assert out == [(2, 5)]
        ex = s.simple_bind(mt.cpu(), x=(2, 5))
        assert_close(ex.forward()[0].asnumpy(), np.ones((2, 5)), 0, "ones")
