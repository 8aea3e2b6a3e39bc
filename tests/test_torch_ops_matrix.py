"""The matrix and shape ops of the port against the reference's
(``mxnet_tpu/ops/matrix.py``).

The sweep runs each shared op at ``tests/test_op_sweep.py``'s inputs;
the cases after it cover: ``dot`` on N-d operands with each transpose
(which swaps an operand's last two axes before the last axis of ``lhs``
meets the first of ``rhs``) and under amp; ``slice`` with ``None`` and
negative steps; ``Crop``'s one- and two-input forms, ``center_crop``
and ``offset``; ``repeat``, ``tile``, ``reverse``, ``add_n`` and
``khatri_rao`` over several inputs; and the ``linalg_*`` family with a
leading batch axis.

``linalg_potrf`` and ``linalg_potri`` take a symmetric input. The
reference's Cholesky symmetrizes its input (``(A + Aᵀ)/2``) before the
factorization, so its gradient is a symmetric matrix; torch's Cholesky
backward symmetrizes its gradient the same way, and the two agree
elementwise (checked, with the gradient's symmetry).
"""
import numpy as np
import pytest

import mxnet_tpu as mx
import mxnet_tpu_torch as mt
from test_torch_ops_parity import (GRAD_RTOL, assert_close, check_op,
                                   run_both, sweep_case, sweep_names)
import torch

# test files run side by side in parallel workers: each keeps torch's
# intra-op pool small
torch.set_num_threads(2)

NAMES = sweep_names("matrix")


@pytest.mark.parametrize("name", NAMES)
def test_sweep(name):
    inputs, attrs = sweep_case(name)
    check_op(name, inputs, attrs)


def _data(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


@pytest.mark.parametrize("lhs, rhs, ta, tb", [
    ((2, 3, 4), (4, 5), False, False),
    ((2, 3, 4), (3, 5), True, False),
    ((2, 4, 3), (5, 3), False, True),
    ((3, 4), (3, 2, 5), True, False),
    ((3, 4), (4, 5, 3), False, True),
    ((2, 3, 4), (3, 5, 2), True, True),
    ((4,), (4,), False, False),
    ((4,), (4, 3), False, False),
])
def test_dot_transposes_on_n_d(lhs, rhs, ta, tb):
    check_op("dot", [_data(1, *lhs), _data(2, *rhs)],
             {"transpose_a": ta, "transpose_b": tb})


def test_dot_under_amp_is_bf16():
    """Under amp both packages multiply bf16 operands, accumulate in f32
    and return bf16."""
    a, b = _data(3, 8, 16), _data(4, 16, 4)
    outs = []
    for pkg, kw in ((mx, {}), (mt, {"ctx": mt.cpu()})):
        pkg.amp.init("bfloat16")
        try:
            out = pkg.nd.dot(pkg.nd.array(a, **kw), pkg.nd.array(b, **kw))
            outs.append(out)
        finally:
            pkg.amp.off()
    assert str(outs[0].dtype) == "bfloat16"
    assert str(outs[1].dtype) == "torch.bfloat16"
    assert_close(outs[1].asnumpy(), np.asarray(outs[0].asnumpy(),
                                               np.float32), 0, "amp dot")


@pytest.mark.parametrize("begin, end, step", [
    ((None, 1), (2, None), None),
    ((3, None), (0, None), (-1, 2)),
    ((None,), (None,), (-2,)),
    ((1, -1), (-1, 0), (1, -1)),
    ((0, 1, None), (2, 4, None), (1, 2)),
])
def test_slice_with_none_and_negative_steps(begin, end, step):
    check_op("slice", [_data(5, 4, 5, 3)],
             {"begin": begin, "end": end, "step": step})


def test_crop_alias_is_slice():
    check_op("crop", [_data(6, 4, 5)], {"begin": (1, 0), "end": (3, 4)})


@pytest.mark.parametrize("inputs, attrs", [
    (((1, 2, 7, 6),), {"h_w": (4, 3)}),
    (((1, 2, 7, 6),), {"h_w": (4, 0), "offset": (2, 0)}),
    (((1, 2, 7, 6),), {"h_w": (3, 3), "center_crop": True}),
    (((2, 3, 8, 8), (2, 1, 5, 4)), {}),
    (((2, 3, 8, 8), (2, 1, 5, 4)), {"center_crop": True}),
    (((2, 3, 8, 8), (2, 1, 5, 4)), {"offset": (3, 4)}),
])
def test_crop_forms(inputs, attrs):
    check_op("Crop", [_data(7 + i, *s) for i, s in enumerate(inputs)],
             attrs)


def test_crop_outside_the_input_raises():
    with pytest.raises(ValueError, match="exceeds input"):
        mt.ops.get_op("Crop").fn(mt.nd.array(_data(8, 1, 1, 4, 4),
                                             ctx=mt.cpu()).data,
                                 h_w=(3, 3), offset=(2, 0))


@pytest.mark.parametrize("name, attrs", [
    ("repeat", {"repeats": 3}),
    ("repeat", {"repeats": 2, "axis": 1}),
    ("tile", {"reps": (2,)}),
    ("tile", {"reps": (2, 1, 3, 1)}),
    ("reverse", {"axis": (0, 2)}),
    ("flip", {"axis": 1}),
])
def test_repeat_tile_reverse(name, attrs):
    check_op(name, [_data(9, 2, 3, 2)], attrs)


@pytest.mark.parametrize("name", ["add_n", "ElementWiseSum",
                                  "element_wise_sum"])
def test_add_n_of_four(name):
    check_op(name, [_data(10 + i, 2, 3) for i in range(4)])


def test_khatri_rao_of_three():
    check_op("khatri_rao", [_data(20, 2, 3), _data(21, 4, 3),
                            _data(22, 3, 3)])


def _spd(seed, batch, n):
    a = _data(seed, batch, n, n)
    return (a @ a.transpose(0, 2, 1) + n * np.eye(n)).astype(np.float32)


def _lower(seed, batch, n):
    return (np.tril(_data(seed, batch, n, n)) +
            3 * np.eye(n)).astype(np.float32)


@pytest.mark.parametrize("ta, tb, alpha, beta", [(False, False, 1.0, 1.0),
                                                 (True, False, 0.5, -2.0),
                                                 (False, True, 2.0, 0.0),
                                                 (True, True, -1.0, 0.5)])
def test_gemm_batched(ta, tb, alpha, beta):
    A, B, C = _data(30, 2, 3, 4), _data(31, 2, 4, 5), _data(32, 2, 3, 5)
    A = A.transpose(0, 2, 1).copy() if ta else A
    B = B.transpose(0, 2, 1).copy() if tb else B
    check_op("linalg_gemm", [A, B, C], {"transpose_a": ta,
                                        "transpose_b": tb, "alpha": alpha,
                                        "beta": beta})
    check_op("linalg_gemm2", [A, B], {"transpose_a": ta, "transpose_b": tb,
                                      "alpha": alpha})


@pytest.mark.parametrize("transpose", [False, True])
@pytest.mark.parametrize("rightside", [False, True])
@pytest.mark.parametrize("name", ["linalg_trsm", "linalg_trmm"])
def test_triangular_batched(name, transpose, rightside):
    check_op(name, [_lower(40, 2, 4), _data(41, 2, 4, 4)],
             {"transpose": transpose, "rightside": rightside, "alpha": 1.5})


def test_sumlogdiag_batched():
    check_op("linalg_sumlogdiag", [_spd(50, 3, 4)])


@pytest.mark.parametrize("name", ["linalg_potrf", "linalg_potri"])
def test_cholesky_family_on_symmetric_inputs(name):
    """The forward (a lower factor), and a symmetric gradient equal to the
    reference's (see the module docstring)."""
    a = _spd(60, 2, 4)
    ref, port = run_both(name, [a])
    assert_close(port["outs"][0], ref["outs"][0], 1e-5, name)
    if name == "linalg_potrf":
        assert np.allclose(np.triu(port["outs"][0], 1), 0)
    g = port["grads"][0]
    assert_close(g, np.swapaxes(g, -1, -2), 1e-6, name + " symmetry")
    assert_close(port["grads"][0], ref["grads"][0], GRAD_RTOL,
                 name + " gradient")
