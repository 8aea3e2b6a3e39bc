"""The indexing and ordering ops of the port against the reference's
(``mxnet_tpu/ops/indexing.py``).

The sweep runs each shared op at ``tests/test_op_sweep.py``'s inputs;
the cases after it hold what the sweep does not reach:

* indices outside the axis. ``pick`` (C9) and ``Embedding`` (C11) wrap a
  negative index once and give NaN past the end, as ``jnp.take_along_axis``
  / ``jnp.take`` do, and their gradients drop those entries; ``take``'s
  ``clip`` / ``wrap`` / ``raise`` modes, ``batch_take``, ``one_hot``'s row
  of ``off_value`` and ``gather_nd``'s wrap-then-clamp;
* ties. The reference's descending ``sort`` / ``argsort`` flip a stable
  ascending sort (equal values in reverse index order), and ``topk``
  takes equal values lower index first, as ``lax.top_k`` does;
* every ``topk`` return type, ascending and on a leading axis.

A test marked ``requires_cuda`` repeats the out-of-range cases on the
card, where an index outside the axis reaching a gather would be a
device-side assert.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as mx
import mxnet_tpu_torch as mt
from test_torch_ops_parity import (assert_close, check_op, sweep_case,
                                   sweep_names)
from mxnet_tpu_torch.ops import get_op

# test files run side by side in parallel workers: each keeps torch's
# intra-op pool small
torch.set_num_threads(2)

NAMES = sweep_names("indexing")


@pytest.mark.parametrize("name", NAMES)
def test_sweep(name):
    inputs, attrs = sweep_case(name)
    check_op(name, inputs, attrs)


def _data(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def test_pick_out_of_range_is_the_references():
    """C9: indices [0, 5, -1] into a (3, 4) arange give [0, nan, 11]."""
    x = np.arange(12, dtype=np.float32).reshape(3, 4)
    idx = np.array([0, 5, -1], np.float32)
    ref, port = check_op("pick", [x, idx])
    assert_close(port["outs"][0], [0.0, np.nan, 11.0], 0, "pick")
    with mt.device_scope("cpu"):
        got = mt.nd.pick(mt.nd.array(x), mt.nd.array(idx)).asnumpy()
    assert_close(got, [0.0, np.nan, 11.0], 0, "nd.pick")


@pytest.mark.parametrize("axis, keepdims", [(0, False), (1, True),
                                            (-1, False)])
def test_pick_axes_with_out_of_range_indices(axis, keepdims):
    x = _data(1, (4, 5))
    n = 5 if axis in (1, -1) else 4
    idx = np.array([-6, -1, 0, 2, n, n + 3][:9 - n], np.float32)
    idx = np.resize(idx, 4 if axis in (1, -1) else 5).astype(np.float32)
    check_op("pick", [x, idx], {"axis": axis, "keepdims": keepdims})


def test_embedding_out_of_range_is_the_references():
    """C11: ids [-1, 5, 1] into a (3, 2) weight give [[4, 5], [nan, nan],
    [2, 3]], and the weight's gradient drops the row past the end."""
    w = np.arange(6, dtype=np.float32).reshape(3, 2)
    ids = np.array([-1, 5, 1], np.float32)
    ref, port = check_op("Embedding", [ids, w],
                         {"input_dim": 3, "output_dim": 2})
    assert_close(port["outs"][0], [[4, 5], [np.nan, np.nan], [2, 3]], 0,
                 "Embedding")
    assert np.isfinite(port["grads"][1]).all()


def test_embedding_weight_gradient_through_the_tape():
    w0 = _data(2, (4, 3))
    ids = np.array([[0, -1, 9], [3, 3, -5]], np.float32)
    grads = []
    for pkg, kw in ((mx, {}), (mt, {"ctx": mt.cpu()})):
        w = pkg.nd.array(w0, **kw)
        w.attach_grad()
        with pkg.autograd.record():
            out = pkg.nd.Embedding(pkg.nd.array(ids, **kw), w, input_dim=4,
                                   output_dim=3)
            loss = pkg.nd.nansum(out * out)
        loss.backward()
        grads.append(w.grad.asnumpy())
    assert_close(grads[1], grads[0], 1e-5, "Embedding weight gradient")


@pytest.mark.parametrize("mode", ["clip", "wrap", "raise"])
@pytest.mark.parametrize("axis", [0, 1, -1])
def test_take_modes(mode, axis):
    a = _data(3, (4, 5, 3))
    idx = np.array([[-7, -1, 0], [2, 4, 11]], np.float32)
    check_op("take", [a, idx], {"axis": axis, "mode": mode})


def test_batch_take_out_of_range():
    a = _data(4, (4, 3))
    check_op("batch_take", [a, np.array([0, -1, 3, -4], np.float32)])


@pytest.mark.parametrize("attrs", [{"depth": 4},
                                   {"depth": 3, "on_value": 2.5,
                                    "off_value": -1.0},
                                   {"depth": 5, "dtype": "int32"}])
def test_one_hot_out_of_range(attrs):
    idx = np.array([[0, 3, -1], [4, 2, 7]], np.float32)
    check_op("one_hot", [idx], attrs)


def test_gather_nd_wraps_then_clamps():
    """Negative indices count from the end once, then every index is
    clamped into its axis (the reference's ``data[tuple(indices)]``)."""
    data = _data(5, (4, 3, 2))
    idx = np.array([[-5, -1, 5, 2, 0], [0, -1, 7, -4, 1]], np.float32)
    check_op("gather_nd", [data, idx])
    check_op("gather_nd", [data, idx[:1]])


TIES = np.array([[3, 1, 3, 2, 1, 3], [0, 0, 5, 0, 5, 0]], np.float32)


@pytest.mark.parametrize("name", ["sort", "argsort"])
@pytest.mark.parametrize("is_ascend", [True, False])
@pytest.mark.parametrize("axis", [-1, 0])
def test_sort_ties(name, is_ascend, axis):
    """Descending is the flip of the stable ascending order: ties come
    out in reverse index order."""
    check_op(name, [TIES], {"axis": axis, "is_ascend": is_ascend})


@pytest.mark.parametrize("ret_typ", ["indices", "value", "mask", "both"])
@pytest.mark.parametrize("is_ascend", [False, True])
@pytest.mark.parametrize("axis, k", [(-1, 3), (0, 1)])
def test_topk_ties_and_return_types(ret_typ, is_ascend, axis, k):
    """Equal values lower index first, as ``lax.top_k``."""
    check_op("topk", [TIES], {"axis": axis, "k": k, "ret_typ": ret_typ,
                              "is_ascend": is_ascend})


def test_topk_both_is_two_outputs_in_symbols():
    data = mt.sym.Variable("data")
    s = mt.sym.topk(data, k=2, ret_typ="both", name="top")
    assert s.list_outputs() == ["top_output", "top_output1"]
    assert s.infer_shape(data=(3, 5))[1] == [(3, 2), (3, 2)]


def test_ndarray_methods():
    """The reference's NDArray methods of this slice call its ops."""
    x0 = _data(6, (3, 4))
    with mt.device_scope("cpu"):
        x = mt.nd.array(x0)
        idx = mt.nd.array([2, 0, 1])
        for name, got, want in (
                ("sort", x.sort(), np.sort(x0)),
                ("topk", x.topk(k=1), np.argmax(x0, -1)[:, None]),
                ("take", x.take(idx), x0[[2, 0, 1]]),
                ("tile", x.tile(reps=(1, 2)), np.tile(x0, (1, 2))),
                ("repeat", x.repeat(repeats=2, axis=0),
                 np.repeat(x0, 2, 0)),
                ("flip", x.flip(axis=1), x0[:, ::-1]),
                ("one_hot", idx.one_hot(depth=3), np.eye(3)[[2, 0, 1]]),
                ("broadcast_to", x[0:1].broadcast_to(shape=(2, 4)),
                 np.broadcast_to(x0[0:1], (2, 4))),
                ("slice", x.slice(begin=(1, None), end=(3, 3)),
                 x0[1:3, :3])):
            assert_close(got.asnumpy(), want, 0, name)


@pytest.mark.requires_cuda
def test_out_of_range_indices_on_the_card():
    """The C9 / C11 inputs on ``cuda:0`` give the reference's values and
    no device-side assert (a later launch still works)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda:0")
    x = torch.arange(12.0, device=dev).reshape(3, 4)
    got = get_op("pick").fn(x, torch.tensor([0.0, 5.0, -1.0], device=dev))
    assert_close(got.cpu().numpy(), [0.0, np.nan, 11.0], 0, "pick")
    w = torch.arange(6.0, device=dev).reshape(3, 2)
    got = get_op("Embedding").fn(torch.tensor([-1.0, 5.0, 1.0], device=dev),
                                 w)
    assert_close(got.cpu().numpy(), [[4, 5], [np.nan, np.nan], [2, 3]], 0,
                 "Embedding")
    torch.cuda.synchronize()
    assert float((x + 1).sum()) == 78.0
