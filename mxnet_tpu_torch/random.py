"""Global PRNG state: the reference's threefry key chain, in numpy.

The port's copy of ``mxnet_tpu/random.py``. The reference keeps one
counter-based threefry2x32 key chain: ``seed()`` resets it, and each
consumer splits off a fresh key. ``derive_numpy_rng`` turns one split,
folded with a tag, into a numpy ``Generator``; ``fit``'s default
initializer draws from it. This module computes the same keys without
jax, so a seeded port run derives the same numpy generators, and so the
same initial weights, as a seeded reference run.

The key chain follows jax's default ``threefry2x32`` PRNG with
``jax_threefry_partitionable`` on (jax 0.9's defaults):

* ``PRNGKey(s)`` is the pair ``(0, s & 0xFFFFFFFF)`` (jax without x64
  keeps a seed's low 32 bits, negative seeds included);
* ``split(k)[i]`` is ``threefry2x32(k, (0, i))``;
* ``fold_in(k, d)`` is ``threefry2x32(k, (0, d))``.

The sampler ops (``Dropout``, ``LeakyReLU``'s ``rrelu``) draw from a
``torch.Generator`` on the data's device, seeded from one split of the
chain (:func:`torch_generator`): a seeded run draws the same masks
again, though not the reference's (jax's bits are its own). Torch's
global generators are untouched.
"""
from __future__ import annotations

import threading
import zlib

import numpy as np

__all__ = ["seed", "next_key", "current_key", "set_key",
           "derive_numpy_rng", "torch_generator", "prng_key", "split",
           "fold_in", "threefry2x32"]

_M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))

_state = threading.local()


def _rotl(x: int, r: int) -> int:
    return ((x << r) | (x >> (32 - r))) & _M32


def threefry2x32(key, count) -> np.ndarray:
    """The 20-round Threefry-2x32 block of ``count`` (two uint32 words)
    under ``key`` (two uint32 words), as jax's ``threefry2x32`` computes
    it; returns the two output words as a uint32 array."""
    k0, k1 = (int(w) & _M32 for w in key)
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (int(count[0]) + ks[0]) & _M32
    x1 = (int(count[1]) + ks[1]) & _M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _M32
    return np.array([x0, x1], dtype=np.uint32)


def prng_key(seed_state: int) -> np.ndarray:
    """jax's ``PRNGKey(seed_state)``: 0 and the seed's low 32 bits."""
    return np.array([0, int(seed_state) & _M32], dtype=np.uint32)


def split(key, num: int = 2) -> np.ndarray:
    """jax's ``random.split(key, num)``: ``num`` keys, one per row."""
    return np.stack([threefry2x32(key, (0, i)) for i in range(num)])


def fold_in(key, data: int) -> np.ndarray:
    """jax's ``random.fold_in(key, data)`` for ``0 <= data < 2**32``."""
    return threefry2x32(key, (0, int(data) & _M32))


def _key() -> np.ndarray:
    if not hasattr(_state, "key"):
        _state.key = prng_key(0)
    return _state.key


def seed(seed_state: int) -> None:
    """Seed this thread's generator (reference: ``mx.random.seed``)."""
    _state.key = prng_key(seed_state)


def next_key() -> np.ndarray:
    """Split off a fresh key for one consumer."""
    k, sub = split(_key())
    _state.key = k
    return sub


def current_key() -> np.ndarray:
    return _key()


def set_key(key) -> None:
    """Restore the generator to a key captured by :func:`current_key`."""
    _state.key = np.asarray(key, dtype=np.uint32).reshape(2).copy()


def derive_numpy_rng(tag: str = "") -> np.random.Generator:
    """A numpy ``Generator`` derived from the key chain: one split is
    consumed and, with a tag, folded with ``crc32(tag) & 0x7FFFFFFF``; the
    key's two words seed the generator. Equal, for the same seed and
    the same calls, to the reference's ``derive_numpy_rng``; ``fit``'s
    default initializer draws from it."""
    sub = next_key()
    if tag:
        sub = fold_in(sub, zlib.crc32(tag.encode()) & 0x7FFFFFFF)
    return np.random.default_rng([int(w) for w in sub])


def torch_generator(device):
    """A ``torch.Generator`` on ``device`` seeded from one split of the
    key chain (its two words as one 64-bit seed)."""
    import torch
    k0, k1 = (int(w) for w in next_key())
    gen = torch.Generator(device=device)
    gen.manual_seed((k0 << 32) | k1)
    return gen
