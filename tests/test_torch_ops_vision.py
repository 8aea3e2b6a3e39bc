"""The spatial and sampling ops of the port against the reference's
(``mxnet_tpu/ops/vision.py``): ROIPooling, PSROIPooling, BilinearSampler,
GridGenerator, SpatialTransformer, Correlation and
DeformableConvolution.

Each case runs one op by name in both packages (``check_op``: forward
and the gradient of every input under one random head, 1e-5 / 1e-4 of
max(1, max|ref|)), the reference under ``jax.jit`` but for the ROI
poolings: their bin edges, ``floor`` / ``ceil`` of ``k * (extent /
n)``, fall on integers for some extents, and jitted the reference
divides by ``n`` as a multiply by ``1 / n`` and rounds some of them to
the next integer (ROADMAP C13); the port follows the reference's eager
ops, as its own tests run them. The traps have cases
named after them: ROIPooling's tied maxima on ReLU'd input (the bin's
gradient shared equally over both axes, as jax's ``max`` VJP shares it,
which neither ``torch.max(dim=)`` nor a row-then-column max does),
overlapping bins, a negative and an out-of-range ROI batch index (NaN,
as ``jnp.take`` fills), corners exactly half way (rounded half to even)
and Correlation's wrap-around shift.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu_torch as mt
from mxnet_tpu_torch.ops import get_op
from test_torch_ops_parity import check_op as _check_op


def check_op(name, inputs, attrs=None):
    return _check_op(name, inputs, attrs,
                     jit=name not in ("ROIPooling", "PSROIPooling"))


def _rand(seed, *shape, lo=None, hi=None):
    rng = np.random.default_rng(seed)
    if lo is not None:
        return rng.uniform(lo, hi, shape).astype(np.float32)
    return rng.standard_normal(shape).astype(np.float32)


ROIS = np.array([[0, 0, 0, 7, 7], [1, 2, 2, 6, 6], [0, 4, 4, 4, 4],
                 [1, 1.2, 0.7, 5.6, 3.4]], np.float32)


# --------------------------------------------------------------- ROIPooling

@pytest.mark.parametrize("pooled, scale", [((2, 2), 1.0), ((3, 2), 0.5)])
def test_roi_pooling(pooled, scale):
    check_op("ROIPooling", [_rand(0, 2, 3, 8, 8), ROIS],
             {"pooled_size": pooled, "spatial_scale": scale})


def test_roi_pooling_ties_share_the_gradient():
    """ReLU'd input: whole bins of zeros tie, and every tied element
    takes an equal share of its bin's gradient (counted over both axes
    at once); overlapping bins (a 7-row ROI in 3 bins) add."""
    x = np.maximum(_rand(1, 2, 3, 8, 8), 0.0)
    x[0, :, 0:4, 0:4] = 0.0
    rois = np.array([[0, 0, 0, 6, 6], [0, 0, 0, 3, 3], [1, 1, 1, 7, 5]],
                    np.float32)
    ref, port = check_op("ROIPooling", [x, rois],
                         {"pooled_size": (3, 3), "spatial_scale": 1.0})
    g = port["grads"][0]
    # ROI 1's bins over the zero block: each tied zero takes a share
    assert np.count_nonzero(g[0, :, 0:4, 0:4]) > 3 * 9


def test_roi_pooling_tie_rule_on_a_constant_bin():
    """One bin of 2x3 equal values: each takes 1/6 of the bin's
    gradient (a row-then-column max would give 1/2 to each row's first,
    ``torch.max(dim=)`` all to one element)."""
    x = torch.zeros((1, 1, 2, 3), requires_grad=True)
    out = get_op("ROIPooling").fn(x, torch.tensor([[0, 0, 0, 2, 1.0]]),
                                  pooled_size=(1, 1))
    out.sum().backward()
    np.testing.assert_allclose(x.grad.numpy(), np.full((1, 1, 2, 3), 1 / 6),
                               rtol=1e-6)


def test_roi_pooling_batch_index_out_of_range():
    """A negative batch index counts from the end once; one still
    outside the batch reads NaN (and passes no gradient)."""
    rois = np.array([[-1, 0, 0, 5, 5], [2, 0, 0, 3, 3], [-3, 1, 1, 4, 4],
                     [1, 0, 0, 2, 2]], np.float32)
    ref, port = check_op("ROIPooling", [_rand(2, 2, 3, 6, 6), rois],
                         {"pooled_size": (2, 2)})
    assert np.isnan(port["outs"][0][[1, 2]]).all()
    assert np.isfinite(port["outs"][0][[0, 3]]).all()


def test_roi_pooling_half_way_rounding():
    """Corners at k + 0.5 round half to even (``jnp.round``), not up."""
    rois = np.array([[0, 0.5, 1.5, 2.5, 3.5], [0, 1.5, 0.5, 4.5, 2.5],
                     [0, 2.5, 2.5, 5.5, 5.5]], np.float32)
    ref, port = check_op("ROIPooling", [_rand(3, 1, 2, 7, 7), rois],
                         {"pooled_size": (2, 2)})
    x = torch.from_numpy(_rand(3, 1, 2, 7, 7))
    up = get_op("ROIPooling").fn(x, torch.from_numpy(rois + 0.01),
                                 pooled_size=(2, 2)).numpy()
    assert not np.allclose(up, port["outs"][0])


def test_roi_pooling_reference_oracles():
    """``tests/test_vision_ops.py``'s two ROIPooling oracles on the
    port."""
    rng = np.random.RandomState(0)
    x = rng.rand(2, 3, 8, 8).astype(np.float32)
    rois = np.array([[0, 0, 0, 7, 7], [1, 2, 2, 6, 6], [0, 4, 4, 4, 4]],
                    np.float32)
    with mt.device_scope("cpu"):
        out = mt.nd.ROIPooling(mt.nd.array(x), mt.nd.array(rois),
                               pooled_size=(2, 2), spatial_scale=1.0).asnumpy()
        np.testing.assert_allclose(out[0], x[0].reshape(3, 2, 4, 2, 4)
                                   .max(axis=(2, 4)), rtol=1e-6)
        np.testing.assert_allclose(out[2, :, 1, 1], x[0, :, 4, 4], rtol=1e-6)
        xa = mt.nd.array(np.arange(32, dtype=np.float32).reshape(1, 2, 4, 4))
        xa.attach_grad()
        with mt.autograd.record():
            s = mt.nd.sum(mt.nd.ROIPooling(
                xa, mt.nd.array(np.array([[0, 0, 0, 3, 3]], np.float32)),
                pooled_size=(1, 1), spatial_scale=1.0))
        s.backward()
        g = xa.grad.asnumpy()
    assert g.sum() == 2.0 and g[0, 0, 3, 3] == 1.0 and g[0, 1, 3, 3] == 1.0


def test_roi_pooling_chunks_agree(monkeypatch):
    """Chunks of one ROI (checkpointed) give what one chunk gives,
    values and gradients."""
    from mxnet_tpu_torch.ops import vision
    x = torch.from_numpy(np.maximum(_rand(4, 2, 3, 8, 8), 0))
    rois = torch.from_numpy(ROIS)

    def run():
        xx = x.clone().requires_grad_(True)
        out = get_op("ROIPooling").fn(xx, rois, pooled_size=(2, 3))
        out.backward(torch.from_numpy(_rand(5, *out.shape)))
        return out.detach(), xx.grad
    whole = run()
    monkeypatch.setattr(vision, "_ROI_CHUNK", 1)
    chunked = run()
    for a, b in zip(whole, chunked):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-6)


# -------------------------------------------------------------- the others

def test_psroi_pooling():
    x = _rand(6, 1, 8, 6, 6)
    rois = np.array([[0, 0, 0, 5, 5], [0, 1, 1, 4, 3], [0, 2.5, 0.5, 5, 4]],
                    np.float32)
    check_op("PSROIPooling", [x, rois], {"spatial_scale": 1.0,
                                         "output_dim": 2, "pooled_size": 2,
                                         "group_size": 2})


def test_bilinear_sampler_with_outside_points():
    check_op("BilinearSampler", [_rand(7, 2, 3, 5, 6),
                                 _rand(8, 2, 2, 4, 5, lo=-1.2, hi=1.2)])


@pytest.mark.parametrize("attrs, shape", [
    ({"target_shape": (4, 5)}, (2, 6)),
    ({"transform_type": "warp"}, (2, 2, 4, 5)),
    ({"transform_type": "warp"}, (1, 2, 1, 3))])
def test_grid_generator(attrs, shape):
    check_op("GridGenerator", [_rand(9, *shape)], attrs)


def test_spatial_transformer():
    theta = np.tile(np.array([1, 0, 0, 0, 1, 0], np.float32), (2, 1)) + \
        0.1 * _rand(10, 2, 6)
    check_op("SpatialTransformer", [_rand(11, 2, 3, 6, 6), theta],
             {"target_shape": (5, 4)})


@pytest.mark.parametrize("attrs", [
    {"kernel_size": 1, "max_displacement": 1, "pad_size": 1},
    {"kernel_size": 3, "max_displacement": 2, "stride2": 2, "pad_size": 3,
     "is_multiply": False},
    {"kernel_size": 1, "max_displacement": 2, "stride1": 2, "pad_size": 2}])
def test_correlation(attrs):
    check_op("Correlation", [_rand(12, 1, 3, 8, 8), _rand(13, 1, 3, 8, 8)],
             attrs)


def test_correlation_wraps_around():
    """No padding: a displaced window reads the far edge of the second
    map (``jnp.roll``), which zero padding would not."""
    a, b = _rand(14, 1, 2, 5, 5), _rand(15, 1, 2, 5, 5)
    ref, port = check_op("Correlation", [a, b], {"kernel_size": 1,
                                                 "max_displacement": 1})
    rolled = (a * np.roll(b, (-1, -1), axis=(2, 3))).mean(1)
    np.testing.assert_allclose(port["outs"][0][0, 8], rolled[0, 1:4, 1:4],
                               rtol=1e-6)


def test_deformable_convolution():
    """Groups, deformable groups, stride, pad and a bias."""
    shapes = ((2, 4, 7, 7), (2, 36, 4, 4), (6, 2, 3, 3), (6,))
    ins = [_rand(16 + i, *s) for i, s in enumerate(shapes)]
    check_op("DeformableConvolution", ins,
             {"kernel": (3, 3), "num_filter": 6, "num_group": 2,
              "num_deformable_group": 2, "stride": (2, 2), "pad": (1, 1)})


def test_deformable_convolution_zero_offset_is_convolution():
    rng = np.random.RandomState(8)
    x = rng.rand(1, 3, 7, 7).astype(np.float32)
    w = rng.rand(4, 3, 3, 3).astype(np.float32)
    with mt.device_scope("cpu"):
        out_d = mt.nd.DeformableConvolution(
            mt.nd.array(x), mt.nd.array(np.zeros((1, 18, 5, 5), np.float32)),
            mt.nd.array(w), kernel=(3, 3), num_filter=4,
            no_bias=True).asnumpy()
        out_c = mt.nd.Convolution(mt.nd.array(x), mt.nd.array(w),
                                  kernel=(3, 3), num_filter=4,
                                  no_bias=True).asnumpy()
    np.testing.assert_allclose(out_d, out_c, rtol=1e-4, atol=1e-5)


def test_vision_symbols_infer_shapes():
    s = mt.sym.ROIPooling(mt.sym.Variable("data"), mt.sym.Variable("rois"),
                          pooled_size=(7, 7), spatial_scale=0.0625)
    _, out, _ = s.infer_shape(data=(2, 16, 38, 63), rois=(12, 5))
    assert out == [(12, 16, 7, 7)]
    d = mt.sym.DeformableConvolution(
        mt.sym.Variable("data"), mt.sym.Variable("offset"),
        mt.sym.Variable("weight"), kernel=(3, 3), num_filter=4, no_bias=True)
    assert d.list_arguments() == ["data", "offset", "weight"]
