"""The arithmetic of the float32 kernels' 3xTF32 route, emulated on the
CPU.

``fa_fwd_f32_tf32x3`` (``mxnet_tpu_torch/csrc/flash_attention_fwd.cu``)
runs the serving prefill's and the amp-off training step's float32
attention on the tensor cores, and ``fa_bwd_dq_f32_tf32x3`` /
``fa_bwd_dkv_f32_tf32x3`` (``flash_attention_bwd.cu``) its backward. Each
operand x is split into big = tf32(x), rounded to nearest (ties away from
zero) at a 10-bit mantissa, and small = x - big, which the tensor cores
read truncated to tf32; each product is small * big + big * small +
big * big with float32 accumulation. The kernel runs only on the card,
where ``chip_smoke.py`` holds it against the plain version within
``KERNEL_ATOL``; here the same split runs through the plain attention
formula, so that the route's error is shown to be of float32's order
before any card sees it: within ``KERNEL_ATOL`` of the float32 plain
version and of the reference's ``_xla_attention`` on the same
numpy-seeded inputs, where a single TF32 pass is not; and the same for
the backward formulas (dQ, dK, dV) against the plain backward and the
reference's Pallas backward.
"""
import numpy as np
import pytest
import torch

import chip_smoke
from mxnet_tpu.ops.pallas.flash_attention import _xla_attention
from mxnet_tpu_torch.ops.flash_attention import flash_attention_reference

_LOW = 0x1FFF        # the 13 mantissa bits that tf32 drops


def _tf32_round(x: torch.Tensor) -> torch.Tensor:
    """cvt.rna.tf32.f32: nearest at a 10-bit mantissa, ties away."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~_LOW).view(torch.float32)


def _tf32_trunc(x: torch.Tensor) -> torch.Tensor:
    """How the tensor cores read a float32 operand: its top 19 bits."""
    return (x.contiguous().view(torch.int32) & ~_LOW).view(torch.float32)


def _split(x):
    big = _tf32_round(x)
    return big, x - big


def _mm_3xtf32(a, b):
    a_big, a_small = _split(a)
    b_big, b_small = _split(b)
    a_small, b_small = _tf32_trunc(a_small), _tf32_trunc(b_small)
    return a_small @ b_big + a_big @ b_small + a_big @ b_big


def _mm_1xtf32(a, b):
    return _tf32_round(a) @ _tf32_round(b)


def _attention(q, k, v, scale, causal, mm):
    """The plain attention formula with both products taken by ``mm``."""
    s = mm(q, k.transpose(-1, -2)) * scale
    if causal:
        mask = torch.ones(s.shape[-2:], dtype=torch.bool).tril()
        s = torch.where(mask, s, torch.full_like(s, -1e30))
    return mm(torch.softmax(s, dim=-1), v)


def _inputs(seed, bh, s, d):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((bh, s, d)).astype(np.float32)
            for _ in range(3)]


def test_split_halves_are_tf32_and_exact():
    """big + small is x exactly; big has a 10-bit mantissa and is within
    half a tf32 step of x; small, read truncated, keeps all but ~2^-21
    of x."""
    rng = np.random.default_rng(0)
    x = torch.from_numpy(
        (rng.standard_normal(4096) * 10.0 ** rng.uniform(-3, 3, 4096))
        .astype(np.float32))
    big, small = _split(x)
    assert torch.equal(big + small, x)
    assert not (big.view(torch.int32) & _LOW).any()
    assert (small.abs() <= 2.0 ** -11 * x.abs()).all()
    lost = (x - big - _tf32_trunc(small)).abs()
    assert (lost <= 2.0 ** -21 * x.abs()).all()


def test_ties_round_away_from_zero():
    one = torch.tensor([1.0], dtype=torch.float32)
    half_step = (one.view(torch.int32) + 0x1000).view(torch.float32)
    assert _tf32_round(half_step).item() == 1.0 + 2.0 ** -10
    assert _tf32_round(-half_step).item() == -(1.0 + 2.0 ** -10)


@pytest.mark.parametrize("d", [64, 128])
def test_3xtf32_product_is_float32_accurate(d):
    """A (256, d) x (d, 256) product: the three-pass error stays of the
    order of a float32 product's own, a single pass is orders worse."""
    rng = np.random.default_rng(d)
    a = rng.standard_normal((256, d)).astype(np.float32)
    b = rng.standard_normal((d, 256)).astype(np.float32)
    exact = a.astype(np.float64) @ b.astype(np.float64)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    err_f32 = np.abs((ta @ tb).numpy() - exact).max()
    err_3 = np.abs(_mm_3xtf32(ta, tb).numpy() - exact).max()
    err_1 = np.abs(_mm_1xtf32(ta, tb).numpy() - exact).max()
    assert err_3 <= 8 * err_f32 + 1e-6
    assert err_1 >= 100 * err_3


@pytest.mark.parametrize("causal", [True, False])
def test_3xtf32_attention_within_kernel_atol(causal):
    """At D 128, S 256 (a serving bucket), the 3xTF32 route through the
    attention formula stays within chip_smoke.KERNEL_ATOL max(1,
    max|ref|) of the float32 plain version and of the reference's
    _xla_attention on the same inputs; one TF32 pass does not get as
    close (its error is logged)."""
    bh, s, d = 2, 256, 128
    q, k, v = _inputs(7, bh, s, d)
    scale = d ** -0.5
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    got = _attention(tq, tk, tv, scale, causal, _mm_3xtf32).numpy()
    one = _attention(tq, tk, tv, scale, causal, _mm_1xtf32).numpy()
    plain = flash_attention_reference(tq, tk, tv, scale, causal)[0].numpy()
    ref = np.asarray(_xla_attention(q, k, v, scale, causal))
    limit = chip_smoke.KERNEL_ATOL * max(1.0, np.abs(plain).max())
    err_plain = np.abs(got - plain).max()
    err_ref = np.abs(got - ref).max()
    err_one = np.abs(one - plain).max()
    print("3xTF32 vs plain %.3g, vs _xla_attention %.3g; one TF32 pass "
          "vs plain %.3g (limit %.3g)" % (err_plain, err_ref, err_one, limit))
    assert err_plain <= limit and err_ref <= limit
    assert err_one > 10 * err_plain


def _backward(q, k, v, do, scale, causal, mm):
    """The kernels' backward formulas with every product taken by ``mm``:
    S = Q Kᵀ, P = exp(S scale − lse), dP = dO Vᵀ, dS = P ⊙ (dP − Δ) scale,
    dQ = dS K, dK = dSᵀ Q, dV = Pᵀ dO (Δ = rowsum(dO ⊙ O) and O = P V
    from the same forward)."""
    s = mm(q, k.transpose(-1, -2)) * scale
    if causal:
        mask = torch.ones(s.shape[-2:], dtype=torch.bool).tril()
        s = torch.where(mask, s, torch.full_like(s, -1e30))
    p = torch.exp(s - torch.logsumexp(s, dim=-1, keepdim=True))
    o = mm(p, v)
    delta = (do * o).sum(-1, keepdim=True)
    ds = p * (mm(do, v.transpose(-1, -2)) - delta) * scale
    return (mm(ds, k), mm(ds.transpose(-1, -2), q),
            mm(p.transpose(-1, -2), do))


@pytest.mark.parametrize("causal", [True, False])
def test_3xtf32_backward_within_kernel_atol(causal):
    """The f32 dQ and dK/dV kernels (fa_bwd_dq_f32_tf32x3,
    fa_bwd_dkv_f32_tf32x3) take S, dP, dQ, dK and dV through the same
    split. At D 128, S 256, that route's dQ, dK and dV stay within
    chip_smoke.KERNEL_ATOL max(1, max|ref|) of the plain backward
    (flash_attention_backward_reference) and of the reference's Pallas
    backward (interpret mode); one TF32 pass does not."""
    import jax
    import jax.numpy as jnp
    from mxnet_tpu.ops.pallas.flash_attention import flash_attention
    from mxnet_tpu_torch.ops.flash_attention import (
        flash_attention_backward_reference)
    bh, s, d = 2, 256, 128
    q, k, v = _inputs(11, bh, s, d)
    do = np.random.default_rng(12).standard_normal((bh, s, d)).astype(
        np.float32)
    scale = d ** -0.5
    tq, tk, tv, tdo = (torch.from_numpy(x) for x in (q, k, v, do))
    got = _backward(tq, tk, tv, tdo, scale, causal, _mm_3xtf32)
    one = _backward(tq, tk, tv, tdo, scale, causal, _mm_1xtf32)
    o, lse = flash_attention_reference(tq, tk, tv, scale, causal)
    plain = flash_attention_backward_reference(tq, tk, tv, o, lse, tdo,
                                               scale, causal)

    def loss(q, k, v):
        out = flash_attention(q[None], k[None], v[None], causal=causal,
                              scale=scale, interpret=True)[0]
        return (out * do).sum()
    ref = jax.grad(loss, argnums=(0, 1, 2))(
        *(jnp.asarray(x) for x in (q, k, v)))
    for name, g, g1, p, r in zip(("dq", "dk", "dv"), got, one, plain, ref):
        g, g1, p, r = g.numpy(), g1.numpy(), p.numpy(), np.asarray(r)
        limit = chip_smoke.KERNEL_ATOL * max(1.0, np.abs(p).max())
        err_plain = np.abs(g - p).max()
        err_ref = np.abs(g - r).max()
        err_one = np.abs(g1 - p).max()
        print("%s: 3xTF32 vs plain %.3g, vs Pallas %.3g; one TF32 pass vs "
              "plain %.3g (limit %.3g)" % (name, err_plain, err_ref, err_one,
                                           limit))
        assert err_plain <= limit and err_ref <= limit
        assert err_one > limit
