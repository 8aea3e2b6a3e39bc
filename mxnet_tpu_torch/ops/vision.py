"""Spatial and sampling operators: ``ROIPooling``, ``PSROIPooling``,
``BilinearSampler``, ``GridGenerator``, ``SpatialTransformer``,
``Correlation`` and ``DeformableConvolution``.

The port's counterpart of the reference's ``ops/vision.py``, with its
semantics:

* ``ROIPooling`` rounds ROI corners half to even (``torch.round``, as
  ``jnp.round``), bins span ``floor`` / ``ceil`` of the scaled ROI (so
  neighbouring bins may share a row; the bin size is a true division,
  which CUDA does not do for a Python divisor), an empty bin gives 0 and no
  gradient, and a bin's gradient is shared equally by every element
  equal to its maximum over both axes at once (``torch.amax`` over the
  two axes, as jax's ``max`` VJP). The reference masks the whole map per
  bin, (R, C, ph, pw, H, W) elements at once (61 GB at Fast R-CNN's
  VGG-16 shape); the port gathers per bin a window of the largest bin
  extent (one host read of that extent per chunk), masks what lies
  outside the bin, and runs over chunks of ROIs of at most
  ``_ROI_CHUNK`` window elements, each under activation checkpointing,
  so the backward recomputes one chunk at a time.
* A ROI's batch index counts from the end once when negative, and an
  index still outside the batch reads NaN (``jnp.take``'s fill); every
  gather clamps first (``indexing._in_axis``), so no index outside an
  axis reaches the card.
* The samplers gather the four corners with zero padding outside;
  ``GridGenerator``'s warp divides by ``max(W - 1, 1)``.
* ``Correlation`` shifts with ``torch.roll`` (``jnp.roll`` wraps; it
  does not pad).
* ``DeformableConvolution`` samples every kernel tap bilinearly and
  reduces taps and channels in one product, with the amp policy's
  operands and float32 accumulation.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from .. import amp
from .indexing import _in_axis
from .nn import _tup
from .registry import register

__all__ = []

# elements of one chunk's windows (ROIPooling) or masks (PSROIPooling)
_ROI_CHUNK = 1 << 26


def _roi_image(data, roi_batch):
    """The images the ROIs read, ``(R, C, H, W)``: NaN for a batch index
    outside the batch (after one wrap of a negative index)."""
    b, valid = _in_axis(roi_batch, data.shape[0])
    img = data.index_select(0, b)
    return torch.where(valid[:, None, None, None], img,
                       img.new_tensor(float("nan")))


def _chunks(n_rois, per_roi):
    step = max(1, _ROI_CHUNK // max(1, per_roi))
    return [(r, min(n_rois, r + step)) for r in range(0, n_rois, step)]


# ----------------------------------------------------------------- ROI pool

def _true_div(x, n):
    """``x / n`` correctly rounded on every device: CUDA divides by a
    Python number as a multiply by its reciprocal, which rounds some
    bin edges to the next integer (the reference's eager ops divide)."""
    return x / torch.full_like(x, float(n))


def _bins(lo, n_bins, extent, limit, dev):
    """Per ROI and bin, ``[start, end)`` along one axis: ``floor(k *
    extent / n)`` and ``ceil((k + 1) * extent / n)`` from ``lo``,
    clamped to ``[0, limit]``."""
    size = _true_div(extent.to(torch.float32), n_bins)[:, None]
    k = torch.arange(n_bins, device=dev)
    start = (torch.floor(k * size).to(torch.int32) + lo[:, None]).clamp(
        0, limit)
    end = (torch.ceil((k + 1) * size).to(torch.int32) + lo[:, None]).clamp(
        0, limit)
    return start, end


def _roi_pool_chunk(table, rois, shape, ph, pw, spatial_scale):
    """ROIPooling of one chunk of ROIs from ``table``, the data as
    (N*H*W, C) rows: each bin gathers a window of the chunk's largest
    bin extent, masks what lies outside the bin with -inf and takes
    ``torch.amax`` over the window's two axes at once."""
    N, C, H, W = shape
    dev = table.device
    R = rois.shape[0]
    corner = torch.round(rois[:, 1:5] * spatial_scale).to(torch.int32)
    x1, y1, x2, y2 = corner.unbind(1)
    hs, he = _bins(y1, ph, torch.clamp_min(y2 - y1 + 1, 1), H, dev)
    ws, we = _bins(x1, pw, torch.clamp_min(x2 - x1 + 1, 1), W, dev)
    kh = max(1, int((he - hs).max()))
    kw = max(1, int((we - ws).max()))
    yy = hs[..., None] + torch.arange(kh, device=dev)          # (R, ph, kh)
    xx = ws[..., None] + torch.arange(kw, device=dev)          # (R, pw, kw)
    ok = (yy < he[..., None])[:, :, None, :, None] & \
        (xx < we[..., None])[:, None, :, None, :]          # (R,ph,pw,kh,kw)
    b, valid = _in_axis(rois[:, 0], N)
    flat = (b[:, None, None, None, None] * H
            + yy.clamp(max=H - 1)[:, :, None, :, None]) * W \
        + xx.clamp(max=W - 1)[:, None, :, None, :]
    win = table.index_select(0, flat.reshape(-1)).reshape(
        R, ph, pw, kh, kw, C)
    win = torch.where(valid[:, None, None, None, None, None], win,
                      win.new_tensor(float("nan")))
    masked = torch.where(ok[..., None], win, win.new_tensor(float("-inf")))
    out = torch.amax(masked, dim=(3, 4))                        # (R,ph,pw,C)
    empty = ~ok.any(dim=4).any(dim=3)
    out = torch.where(empty[..., None], out.new_tensor(0.0), out)
    return out.permute(0, 3, 1, 2)


def _roi_meta(data, rois, pooled_size=None, **_):
    ph, pw = _tup(pooled_size, 2)
    return torch.empty((rois.shape[0], data.shape[1], ph, pw),
                       dtype=data.dtype, device="meta")


@register("ROIPooling", num_inputs=2, meta_fn=_roi_meta,
          aliases=("roi_pooling",))
def roi_pooling(data, rois, pooled_size=None, spatial_scale=1.0):
    """Max-pool each ROI onto a fixed (ph, pw) grid: ``data`` (N, C, H,
    W), ``rois`` (R, 5) rows [batch index, x1, y1, x2, y2] in image
    coordinates -> (R, C, ph, pw); empty bins give 0."""
    ph, pw = _tup(pooled_size, 2)
    N, C, H, W = data.shape
    R = rois.shape[0]
    if R == 0:
        return data.new_zeros((0, C, ph, pw))
    table = data.permute(0, 2, 3, 1).reshape(N * H * W, C)
    # a ROI inside the map has bins of at most (H/ph + 1) x (W/pw + 1)
    parts = []
    for r0, r1 in _chunks(R, C * (H + ph) * (W + pw)):
        args = (table, rois[r0:r1], (N, C, H, W), ph, pw,
                float(spatial_scale))
        if torch.is_grad_enabled() and data.requires_grad:
            parts.append(checkpoint(_roi_pool_chunk, *args,
                                    use_reentrant=False))
        else:
            parts.append(_roi_pool_chunk(*args))
    return torch.cat(parts, 0)


def _psroi_chunk(data, rois, p, g, od, spatial_scale):
    N, C, H, W = data.shape
    dev = data.device
    R = rois.shape[0]
    x1 = torch.round(rois[:, 1] * spatial_scale)[:, None]
    y1 = torch.round(rois[:, 2] * spatial_scale)[:, None]
    x2 = torch.round(rois[:, 3] * spatial_scale)[:, None]
    y2 = torch.round(rois[:, 4] * spatial_scale)[:, None]
    rw = torch.clamp_min(x2 - x1, 0.1)
    rh = torch.clamp_min(y2 - y1, 0.1)
    a = torch.arange(p, device=dev)
    hs = torch.floor(_true_div(a * rh, p) + y1).to(torch.int32).clamp(0, H)
    he = torch.ceil(_true_div((a + 1) * rh, p) + y1).to(torch.int32).clamp(
        0, H)
    ws = torch.floor(_true_div(a * rw, p) + x1).to(torch.int32).clamp(0, W)
    we = torch.ceil(_true_div((a + 1) * rw, p) + x1).to(torch.int32).clamp(
        0, W)
    iy = torch.arange(H, device=dev)
    ix = torch.arange(W, device=dev)
    mh = (iy >= hs[..., None]) & (iy < he[..., None])           # (R, p, H)
    mw = (ix >= ws[..., None]) & (ix < we[..., None])           # (R, p, W)
    mk = (mh[:, :, None, :, None] & mw[:, None, :, None, :]).to(
        data.dtype).reshape(R, p * p, H, W)
    img = _roi_image(data, rois[:, 0]).reshape(R, od, g * g, H, W)
    # bin (i, j) pools plane i*g + j of each output channel's block
    plane = (a[:, None] * g + a[None, :]).reshape(-1)
    safe, ok = _in_axis(plane, g * g)
    planes = img.index_select(2, safe)                          # (R,od,pp,H,W)
    planes = torch.where(ok[None, None, :, None, None], planes,
                         planes.new_tensor(float("nan")))
    s = torch.einsum("rkhw,rckhw->rck", mk, planes)
    cnt = torch.clamp_min(mk.sum((-1, -2)), 1.0)
    return (s / cnt[:, None]).reshape(R, od, p, p)


def _psroi_meta(data, rois, output_dim=None, pooled_size=None, **_):
    p = int(pooled_size)
    return torch.empty((rois.shape[0], int(output_dim), p, p),
                       dtype=data.dtype, device="meta")


@register("PSROIPooling", num_inputs=2, meta_fn=_psroi_meta,
          aliases=("_contrib_PSROIPooling", "psroi_pooling"))
def psroi_pooling(data, rois, spatial_scale=1.0, output_dim=None,
                  pooled_size=None, group_size=0):
    """Position-sensitive ROI average pooling (R-FCN): output channel c
    at bin (i, j) averages input channel c*g*g + i*g + j over the bin."""
    g = int(group_size) or int(pooled_size)
    p, od = int(pooled_size), int(output_dim)
    N, C, H, W = data.shape
    parts = [_psroi_chunk(data, rois[r0:r1], p, g, od, float(spatial_scale))
             for r0, r1 in _chunks(rois.shape[0], od * p * p * H * W)]
    if not parts:
        return data.new_zeros((0, od, p, p))
    return torch.cat(parts, 0)


# ------------------------------------------------------------- sampling ops

def _bilinear_gather(data, gx, gy):
    """Sample ``data`` (N, C, H, W) at fractional pixel coordinates
    ``gx`` / ``gy`` (N, ...) -> (N, C, ...), zero outside: the four
    corners summed in the reference's order."""
    N, C, H, W = data.shape
    x0 = torch.floor(gx)
    y0 = torch.floor(gy)
    wx = gx - x0
    wy = gy - y0
    flat = data.reshape(N, C, H * W)
    out = 0.0
    for dy, dx, w in ((0, 0, (1 - wx) * (1 - wy)), (0, 1, wx * (1 - wy)),
                      (1, 0, (1 - wx) * wy), (1, 1, wx * wy)):
        xi = x0.to(torch.int32) + dx
        yi = y0.to(torch.int32) + dy
        valid = (xi >= 0) & (xi < W) & (yi >= 0) & (yi < H)
        xi = xi.clamp(0, W - 1)
        yi = yi.clamp(0, H - 1)
        idx = (yi * W + xi).to(torch.int64).reshape(N, 1, -1)
        v = torch.gather(flat, 2, idx.expand(N, C, idx.shape[2]))
        v = v.reshape((N, C) + gx.shape[1:])
        out = out + v * (w * valid)[:, None]
    return out


@register("BilinearSampler", num_inputs=2, aliases=("bilinear_sampler",))
def bilinear_sampler(data, grid):
    """Sample ``data`` at ``grid`` (N, 2, Ho, Wo): channel 0 is x and 1
    is y, both in [-1, 1]; outside reads zero."""
    N, C, H, W = data.shape
    gx = (grid[:, 0] + 1.0) * (W - 1) / 2.0
    gy = (grid[:, 1] + 1.0) * (H - 1) / 2.0
    return _bilinear_gather(data, gx, gy)


def _linspace(n, device):
    """``jnp.linspace(-1.0, 1.0, n)`` in float32."""
    return torch.linspace(-1.0, 1.0, n, dtype=torch.float32, device=device)


@register("GridGenerator", num_inputs=1)
def grid_generator(data, transform_type="affine", target_shape=None):
    """A sampling grid: ``affine`` takes (N, 6) row-major 2x3 matrices
    to (N, 2, H, W) source coordinates; ``warp`` adds an (N, 2, H, W)
    pixel flow to the identity grid."""
    if transform_type == "affine":
        H, W = _tup(target_shape, 2)
        ys, xs = torch.meshgrid(_linspace(H, data.device),
                                _linspace(W, data.device), indexing="ij")
        tgt = torch.stack([xs.reshape(-1), ys.reshape(-1),
                           torch.ones(H * W, device=data.device)])
        theta = data.reshape(-1, 2, 3)
        src = torch.einsum("nij,jk->nik", theta, tgt.to(theta.dtype))
        return src.reshape(-1, 2, H, W)
    if transform_type == "warp":
        N, _, H, W = data.shape
        ys, xs = torch.meshgrid(
            torch.arange(H, dtype=data.dtype, device=data.device),
            torch.arange(W, dtype=data.dtype, device=data.device),
            indexing="ij")
        gx = (data[:, 0] + xs) * 2.0 / max(W - 1, 1) - 1.0
        gy = (data[:, 1] + ys) * 2.0 / max(H - 1, 1) - 1.0
        return torch.stack([gx, gy], dim=1)
    raise ValueError("transform_type must be 'affine' or 'warp'")


@register("SpatialTransformer", num_inputs=2,
          aliases=("spatial_transformer",))
def spatial_transformer(data, loc, target_shape=None,
                        transform_type="affine", sampler_type="bilinear"):
    """A spatial transformer: an affine grid from ``loc`` and bilinear
    sampling (affine / bilinear only, as in the reference)."""
    if transform_type != "affine" or sampler_type != "bilinear":
        raise ValueError("only affine/bilinear is supported (as in the "
                         "reference)")
    grid = grid_generator.fn(loc, transform_type="affine",
                             target_shape=target_shape)
    return bilinear_sampler.fn(data, grid)


# ------------------------------------------------------------- correlation

@register("Correlation", num_inputs=2)
def correlation(data1, data2, kernel_size=1, max_displacement=1, stride1=1,
                stride2=1, pad_size=0, is_multiply=True):
    """Patch cross-correlation (FlowNet): for each displacement of a
    (2d+1)^2 grid, the channel mean of the kernel-window sum of the
    products (or absolute differences), the second map shifted with
    wrap-around."""
    N, C, H, W = data1.shape
    k = int(kernel_size)
    d = int(max_displacement)
    s1, s2, pad = int(stride1), int(stride2), int(pad_size)
    steps = d // s2
    p1 = F.pad(data1, (pad, pad, pad, pad))
    p2 = F.pad(data2, (pad, pad, pad, pad))
    Hp, Wp = H + 2 * pad, W + 2 * pad
    bk = k // 2
    win = torch.ones((1, 1, k, k), dtype=data1.dtype, device=data1.device)
    maps = []
    with amp.conv_precision(data1.dtype):
        for dy in range(-steps, steps + 1):
            for dx in range(-steps, steps + 1):
                shifted = torch.roll(p2, (-dy * s2, -dx * s2), dims=(2, 3))
                prod = p1 * shifted if is_multiply else (p1 - shifted).abs()
                summed = F.conv2d(prod.reshape(N * C, 1, Hp, Wp), win,
                                  padding=bk).reshape(N, C, Hp, Wp)
                maps.append(summed.mean(dim=1))
    out = torch.stack(maps, dim=1)
    out = out[:, :, bk + d:Hp - bk - d:s1, bk + d:Wp - bk - d:s1]
    return out / (k * k)


# ----------------------------------------------------- deformable conv

@register("DeformableConvolution", num_inputs=None,
          aliases=("_contrib_DeformableConvolution",))
def deformable_convolution(data, offset, weight, bias=None, kernel=None,
                           stride=None, dilate=None, pad=None,
                           num_filter=None, num_group=1,
                           num_deformable_group=1, no_bias=False,
                           workspace=1024):
    """Deformable convolution v1: ``offset`` (N, 2*dg*kh*kw, Ho, Wo)
    holds a (dy, dx) pair per kernel tap and deformable group; each tap
    samples the input bilinearly at its offset position, then one
    product reduces taps and channels (bf16 operands under amp, float32
    accumulation)."""
    kh, kw = _tup(kernel, 2)
    sh, sw = _tup(stride, 2) or (1, 1)
    dh, dw = _tup(dilate, 2) or (1, 1)
    ph_, pw_ = _tup(pad, 2) or (0, 0)
    N, C, H, W = data.shape
    Fn, g, dg = int(num_filter), int(num_group), int(num_deformable_group)
    Ho = (H + 2 * ph_ - (dh * (kh - 1) + 1)) // sh + 1
    Wo = (W + 2 * pw_ - (dw * (kw - 1) + 1)) // sw + 1
    data, weight = amp.cast_compute(data, weight)
    dev = data.device
    base_y = torch.arange(Ho, device=dev) * sh - ph_
    base_x = torch.arange(Wo, device=dev) * sw - pw_
    off = offset.reshape(N, dg, kh * kw, 2, Ho, Wo)
    cpg = C // dg
    groups = data.reshape(N * dg, cpg, H, W)
    taps = []
    for ki in range(kh):
        for kj in range(kw):
            t = ki * kw + kj
            gy = base_y[:, None] + ki * dh + off[:, :, t, 0]
            gx = base_x[None, :] + kj * dw + off[:, :, t, 1]
            smp = _bilinear_gather(groups,
                                   gx.to(data.dtype).reshape(N * dg, Ho, Wo),
                                   gy.to(data.dtype).reshape(N * dg, Ho, Wo))
            taps.append(smp.reshape(N, C, Ho, Wo))
    col = torch.stack(taps, dim=2).reshape(N, g, C // g, kh * kw, Ho, Wo)
    w = weight.reshape(g, Fn // g, C // g, kh * kw)
    out_dtype = torch.promote_types(data.dtype, weight.dtype)
    out = torch.einsum("ngckhw,gfck->ngfhw", col.float(), w.float())
    out = out.reshape(N, Fn, Ho, Wo).to(out_dtype)
    if not no_bias and bias is not None:
        out = out + bias.reshape(1, -1, 1, 1).to(out.dtype)
    return out


deformable_convolution._input_names = ["data", "offset", "weight", "bias"]
