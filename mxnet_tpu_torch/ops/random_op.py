"""Samplers: ``_random_{uniform,normal,gamma,exponential,poisson,
negative_binomial,generalized_negative_binomial}``,
``_sample_multinomial`` and ``shuffle``, under the reference's names and
aliases (``random_uniform``, ``_sample_uniform``, ``uniform``, ...).

The port's counterpart of the reference's ``ops/random_op.py``. Each
draw takes a ``torch.Generator`` on the result's device seeded from one
split of ``mt.random``'s key chain (``random.torch_generator``: torch's
Philox on the card), so a seeded run repeats itself, but its numbers are
not the reference's threefry ones: the two packages agree in
distribution, not bit for bit. The ops are ``is_random`` (not recorded
by ``autograd.record()``), and each has a ``meta_fn`` for shape
inference, since a generator cannot draw on meta tensors.
"""
from __future__ import annotations

import math

import torch

from .. import random as _random
from ..ndarray.ndarray import to_torch_dtype
from .init_op import _shape
from .registry import register

__all__ = []


def _meta(shape=(), dtype="float32", **_):
    return torch.empty(_shape(shape), dtype=to_torch_dtype(dtype),
                       device="meta")


def _sampler(name, aliases):
    return register(name, num_inputs=0, is_random=True, meta_fn=_meta,
                    aliases=aliases)


def _gamma(alpha, shape, device, gen):
    """Gamma(alpha, 1) draws in float32."""
    conc = torch.full(shape, float(alpha), dtype=torch.float32,
                      device=device)
    return torch._standard_gamma(conc, generator=gen)


@_sampler("_random_uniform",
          ("uniform", "random_uniform", "_sample_uniform"))
def random_uniform(low=0.0, high=1.0, shape=(), dtype="float32",
                   _device=None):
    """Uniform on ``[low, high)``."""
    gen = _random.torch_generator(_device)
    u = torch.rand(_shape(shape), generator=gen, device=_device)
    return (low + (high - low) * u).to(to_torch_dtype(dtype))


@_sampler("_random_normal", ("normal", "random_normal", "_sample_normal"))
def random_normal(loc=0.0, scale=1.0, shape=(), dtype="float32",
                  _device=None):
    """Normal with mean ``loc`` and standard deviation ``scale``."""
    gen = _random.torch_generator(_device)
    z = torch.randn(_shape(shape), generator=gen, device=_device)
    return (loc + scale * z).to(to_torch_dtype(dtype))


@_sampler("_random_gamma", ("random_gamma", "_sample_gamma"))
def random_gamma(alpha=1.0, beta=1.0, shape=(), dtype="float32",
                 _device=None):
    """Gamma with shape ``alpha`` and scale ``beta``."""
    gen = _random.torch_generator(_device)
    return (beta * _gamma(alpha, _shape(shape), _device, gen)).to(
        to_torch_dtype(dtype))


@_sampler("_random_exponential",
          ("random_exponential", "_sample_exponential"))
def random_exponential(lam=1.0, shape=(), dtype="float32", _device=None):
    """Exponential with rate ``lam``."""
    gen = _random.torch_generator(_device)
    out = torch.empty(_shape(shape), device=_device)
    return out.exponential_(float(lam), generator=gen).to(
        to_torch_dtype(dtype))


@_sampler("_random_poisson", ("random_poisson", "_sample_poisson"))
def random_poisson(lam=1.0, shape=(), dtype="float32", _device=None):
    """Poisson with rate ``lam``."""
    gen = _random.torch_generator(_device)
    rate = torch.full(_shape(shape), float(lam), device=_device)
    return torch.poisson(rate, generator=gen).to(to_torch_dtype(dtype))


@_sampler("_random_negative_binomial",
          ("random_negative_binomial", "_sample_negbinomial"))
def random_negative_binomial(k=1, p=1.0, shape=(), dtype="float32",
                             _device=None):
    """Failures before the ``k``-th success at success probability
    ``p``: a Poisson of a Gamma(k, (1 − p)/p) rate."""
    gen = _random.torch_generator(_device)
    rate = _gamma(k, _shape(shape), _device, gen) * ((1 - p) / p)
    return torch.poisson(rate, generator=gen).to(to_torch_dtype(dtype))


@_sampler("_random_generalized_negative_binomial",
          ("random_generalized_negative_binomial", "_sample_gennegbinomial"))
def random_gen_negative_binomial(mu=1.0, alpha=1.0, shape=(),
                                 dtype="float32", _device=None):
    """Mean ``mu``, dispersion ``alpha``: a Poisson of a Gamma(1/alpha,
    mu·alpha) rate."""
    gen = _random.torch_generator(_device)
    rate = _gamma(1.0 / alpha, _shape(shape), _device, gen) * (mu * alpha)
    return torch.poisson(rate, generator=gen).to(to_torch_dtype(dtype))


def _draws(shape):
    return 1 if not shape else (int(shape) if isinstance(shape, int)
                                else math.prod(int(s) for s in shape))


def _multinomial_meta(data, shape=(), get_prob=False, dtype="int32"):
    n = _draws(shape)
    out = torch.empty(data.shape[:-1] + ((n,) if n > 1 else ()),
                      dtype=to_torch_dtype(dtype), device="meta")
    return (out, torch.empty(out.shape, device="meta")) if get_prob else out


@register("_sample_multinomial", num_inputs=1, is_random=True,
          aliases=("sample_multinomial",), meta_fn=_multinomial_meta,
          num_outputs=lambda attrs: 2 if attrs.get("get_prob") else 1)
def sample_multinomial(data, shape=(), get_prob=False, dtype="int32"):
    """Class ids drawn from each row of probabilities (the last axis):
    one per row, or a trailing axis of ``prod(shape)`` draws; with
    ``get_prob`` also the log-probability of each draw."""
    n = _draws(shape)
    k = data.shape[-1]
    gen = _random.torch_generator(data.device)
    flat = data.reshape(-1, k).float()
    ids = torch.multinomial(flat, n, replacement=True, generator=gen)
    ids = ids.reshape(data.shape[:-1] + (n,))
    out = ids.to(to_torch_dtype(dtype))
    if n == 1:
        out = out.squeeze(-1)
    if get_prob:
        p = torch.gather(data, -1, ids)
        if n == 1:
            p = p.squeeze(-1)
        return out, torch.log(p)
    return out


@register("shuffle", num_inputs=1, is_random=True, aliases=("_shuffle",),
          meta_fn=lambda data: torch.empty_like(data))
def shuffle(data):
    """The array with its first axis in a random order."""
    gen = _random.torch_generator(data.device)
    perm = torch.randperm(data.shape[0], generator=gen, device=data.device)
    return data.index_select(0, perm)
