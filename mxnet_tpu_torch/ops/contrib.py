"""Contrib operators and the fork's Stochastic Activation Pruning.

The port's counterpart of the reference's ``ops/contrib.py``:
``stochastic_activation_pruning`` (aliases ``StochasticActivationPruning``
and ``sap``), the one operator by which this fork differs from upstream
MXNet 0.11 (the ICLR'18 SAP adversarial defense), and ``quantize``,
``dequantize``, ``count_sketch``, ``fft`` and ``ifft``.

SAP draws per row ``k = max(int(frac * cols), 1)`` categorical samples
from ``prob`` by inverse CDF (``searchsorted(side="right")``, so a
zero-probability column is never chosen, clipped to ``cols - 1``) with a
generator of :mod:`..random`'s key chain (``random.torch_generator``:
the draws repeat under ``mt.random.seed`` but are not the reference's
threefry bits, so the two packages agree in distribution, and exactly
where the draw is forced). A kept activation is scaled by the inverse
retention propensity ``1 / (1 - (1 - p)^k)``, ``(1 - p)^k`` taken by
repeated squaring as ``lax.integer_pow`` does; duplicate draws set the
same weight. The gradient reaches ``act`` as ``grad * mask`` and
``prob`` receives none (zeros through the tape).

``MoE`` is registered under the reference's names but raises: the op
and its expert parallelism are ROADMAP.md queue A9.
"""
from __future__ import annotations

import torch

from .. import random as _random
from ..base import MXNetError
from .indexing import _in_axis
from .registry import register

__all__ = []


def _integer_pow(x, k: int):
    """``x ** k`` for an int ``k >= 1`` by repeated squaring, in the
    order ``lax.integer_pow`` multiplies."""
    acc = None
    while k > 0:
        if k & 1:
            acc = x if acc is None else acc * x
        k >>= 1
        if k > 0:
            x = x * x
    return acc


def _sap_meta(act, prob, **_):
    return torch.empty(act.shape, dtype=act.dtype, device="meta")


@register("stochastic_activation_pruning", num_inputs=2, meta_fn=_sap_meta,
          aliases=("StochasticActivationPruning", "sap"))
def stochastic_activation_pruning(act, prob, frac=1.0):
    """Stochastic Activation Pruning: inputs flatten to (rows, cols);
    per row ``k = max(int(frac * cols), 1)`` draws from ``prob``, kept
    activations scaled by ``1 / (1 - (1 - p)^k)``, the rest zeroed."""
    shape = act.shape
    rows = shape[0] if act.dim() > 1 else 1
    a2 = act.reshape(rows, -1)
    p2 = prob.detach().reshape(rows, -1)
    cols = a2.shape[1]
    k = max(int(frac * cols), 1)
    cdf = torch.cumsum(p2, dim=1)
    gen = _random.torch_generator(act.device)
    u = torch.rand((rows, k), generator=gen, device=act.device,
                   dtype=cdf.dtype) * cdf[:, -1:]
    idx = torch.searchsorted(cdf.contiguous(), u.contiguous(), right=True)
    idx = idx.clamp_max(cols - 1)
    weights = 1.0 / (1.0 - _integer_pow(1.0 - p2, k))
    mask = torch.zeros_like(a2).scatter(1, idx,
                                        torch.gather(weights, 1, idx).to(
                                            a2.dtype))
    return (a2 * mask).reshape(shape)


@register("quantize", num_inputs=3, aliases=("_contrib_quantize",))
def quantize(data, min_range, max_range, out_type="uint8"):
    """Affine quantization to uint8 [0, 255] or int8 [-127, 127]:
    ``(q, min_range, max_range)``."""
    if out_type == "uint8":
        qmin, qmax, dt = 0.0, 255.0, torch.uint8
    else:
        qmin, qmax, dt = -127.0, 127.0, torch.int8
    scale = (qmax - qmin) / (max_range - min_range)
    q = torch.round((data - min_range) * scale + qmin).clamp(qmin, qmax)
    return q.to(dt), min_range, max_range


@register("dequantize", num_inputs=3, aliases=("_contrib_dequantize",))
def dequantize(data, min_range, max_range, out_type="float32"):
    """The inverse affine map of :func:`quantize` (uint8 data reads [0,
    255], any other [-127, 127])."""
    from ..ndarray.ndarray import to_torch_dtype
    if data.dtype == torch.uint8:
        qmin, qmax = 0.0, 255.0
    else:
        qmin, qmax = -127.0, 127.0
    scale = (max_range - min_range) / (qmax - qmin)
    return ((data.to(torch.float32) - qmin) * scale + min_range).to(
        to_torch_dtype(out_type))


@register("count_sketch", num_inputs=3, aliases=("_contrib_count_sketch",))
def count_sketch(data, h, s, out_dim=None, processing_batch_size=32):
    """Count-sketch projection: ``out[n, h[i]] += s[i] * data[n, i]``; a
    bucket outside ``[0, out_dim)`` (after one wrap of a negative one)
    is dropped, as the reference's scatter drops it."""
    n = data.shape[0]
    safe, valid = _in_axis(h.reshape(-1), int(out_dim))
    sign = s.reshape(-1).to(data.dtype) * valid.to(data.dtype)
    out = torch.zeros((n, int(out_dim)), dtype=data.dtype, device=data.device)
    return out.index_add(1, safe, data * sign)


def _fft_meta(data, **_):
    return torch.empty(data.shape[:-1] + (2 * data.shape[-1],),
                       dtype=data.dtype, device="meta")


@register("fft", meta_fn=_fft_meta, aliases=("_contrib_fft",))
def fft(data, compute_size=128):
    """FFT along the last axis, real and imaginary parts interleaved
    (the reference's cuFFT op's packing)."""
    out = torch.fft.fft(data.to(torch.float32), dim=-1)
    packed = torch.stack([out.real, out.imag], dim=-1)
    return packed.reshape(data.shape[:-1] + (2 * data.shape[-1],)).to(
        data.dtype)


def _ifft_meta(data, **_):
    return torch.empty(data.shape[:-1] + (data.shape[-1] // 2,),
                       dtype=data.dtype, device="meta")


@register("ifft", meta_fn=_ifft_meta, aliases=("_contrib_ifft",))
def ifft(data, compute_size=128):
    """Inverse FFT of interleaved real / imaginary input: the real part,
    unnormalized as cuFFT's."""
    n = data.shape[-1] // 2
    x = data.reshape(data.shape[:-1] + (n, 2)).to(torch.float32)
    c = torch.complex(x[..., 0], x[..., 1])
    out = torch.fft.ifft(c, dim=-1) * n
    return out.real.to(data.dtype)


def _moe_meta(data, router, wi, wo, **_):
    raise MXNetError("the MoE op is not ported yet: it and expert "
                     "parallelism are ROADMAP.md queue A9")


@register("MoE", num_inputs=4, num_outputs=2, meta_fn=_moe_meta,
          aliases=("_contrib_MoE",))
def moe(data, router, wi, wo, top_k=2, capacity_factor=1.25):
    """The reference's mixture-of-experts op. Not ported: it raises,
    naming ROADMAP.md queue A9."""
    _moe_meta(data, router, wi, wo)
