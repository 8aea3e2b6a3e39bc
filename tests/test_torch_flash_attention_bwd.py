"""The port's flash-attention backward against the reference's fused
Pallas backward (``_fa_bwd_dq_kernel`` / ``_fa_bwd_dkv_kernel``, run in
interpret mode as the reference's own tests run it on the CPU).

On the CPU the port's autograd function takes the plain backward
(``flash_attention_backward_reference``); the CUDA kernels are held
against that same plain version on the card by ``chip_smoke.py``. The
shapes are the reference's oracle shapes (``tests/test_rtc.py``): a
non-causal 128-row head, a causal 96-row head with blocks 64 / 32 (q is
padded), and cross-attention with Sk != S. Inputs and the output
cotangent are drawn with numpy from a seed.

Tolerances: float32 at the reference oracle's rtol 2e-4, atol 2e-5
(both sides sum in f32 over at most 128 keys); bfloat16 at the
reference's own bf16 bound, max error / max magnitude < 0.06 against
the float32 gradients.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mxnet_tpu.ops.pallas.flash_attention import \
    flash_attention as jax_flash_attention
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.ops import get_op
from mxnet_tpu_torch.ops.flash_attention import (
    FlashAttentionFunction, flash_attention,
    flash_attention_backward_reference, flash_attention_bwd_dkv,
    flash_attention_bwd_dq, flash_attention_fwd, flash_attention_reference)

RTOL, ATOL = 2e-4, 2e-5
BF16_REL = 0.06

# (B, H, S, Sk, D, causal, block_q, block_k)
ORACLE_SHAPES = [
    (1, 1, 128, 128, 16, False, 512, 512),
    (1, 1, 96, 96, 16, True, 64, 32),
    (1, 2, 64, 128, 16, False, 32, 32),
]
IDS = ["noncausal-128", "causal-96-padded-q", "cross-64x128"]


def _inputs(seed, b, h, s, sk, d):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32)
            for shape in ((b, h, s, d), (b, h, sk, d), (b, h, sk, d),
                          (b, h, s, d))]


def _jax_grads(q, k, v, ct, dtype=jnp.float32, **kw):
    def f(q, k, v):
        out = jax_flash_attention(q, k, v, interpret=True, **kw)
        return (out.astype(jnp.float32) * ct).sum()
    args = [jnp.asarray(x).astype(dtype) for x in (q, k, v)]
    return [np.asarray(g, np.float32)
            for g in jax.grad(f, argnums=(0, 1, 2))(*args)]


def _port_grads(q, k, v, ct, dtype=torch.float32, **kw):
    ts = [torch.from_numpy(x).to(dtype).requires_grad_(True)
          for x in (q, k, v)]
    out = flash_attention(*ts, **kw)
    (out.float() * torch.from_numpy(ct)).sum().backward()
    return [t.grad.float().numpy() for t in ts]


@pytest.mark.parametrize("shape", ORACLE_SHAPES, ids=IDS)
def test_grads_match_pallas_backward_f32(shape):
    b, h, s, sk, d, causal, bq, bk = shape
    q, k, v, ct = _inputs(0, b, h, s, sk, d)
    kw = dict(causal=causal, block_q=bq, block_k=bk)
    for got, want in zip(_port_grads(q, k, v, ct, **kw),
                         _jax_grads(q, k, v, ct, **kw)):
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("shape", ORACLE_SHAPES, ids=IDS)
def test_grads_bf16_within_reference_bound(shape):
    """bf16 inputs: the port's gradients stay within the reference's own
    bf16 bound of the f32 gradients, as the reference's do."""
    b, h, s, sk, d, causal, bq, bk = shape
    q, k, v, ct = _inputs(1, b, h, s, sk, d)
    kw = dict(causal=causal, block_q=bq, block_k=bk)
    want = _jax_grads(q, k, v, ct, **kw)
    port16 = _port_grads(q, k, v, ct, dtype=torch.bfloat16, **kw)
    jax16 = _jax_grads(q, k, v, ct, dtype=jnp.bfloat16, **kw)
    for got, ref16, w in zip(port16, jax16, want):
        scale = np.abs(w).max() + 1e-6
        assert np.abs(got - w).max() / scale < BF16_REL
        assert np.abs(ref16 - w).max() / scale < BF16_REL


@pytest.mark.parametrize("causal", [False, True])
def test_plain_backward_matches_autograd_of_plain_forward(causal):
    """The plain backward's formulas (P rebuilt from lse, Δ = rowsum(dO ⊙
    O)) equal torch.autograd through the plain forward, atol 1e-5."""
    rng = np.random.default_rng(2)
    q, k, v, do = (torch.from_numpy(rng.standard_normal((3, 40, 16))
                                    .astype(np.float32)) for _ in range(4))
    scale = 0.25
    ts = [t.clone().requires_grad_(True) for t in (q, k, v)]
    o, _ = flash_attention_reference(*ts, scale, causal)
    want = torch.autograd.grad(o, ts, do)
    with torch.no_grad():
        o, lse = flash_attention_reference(q, k, v, scale, causal)
    got = flash_attention_backward_reference(q, k, v, o, lse, do, scale,
                                             causal)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=1e-5)


def test_backward_keeps_input_dtypes():
    rng = np.random.default_rng(3)
    q, k, v = (torch.from_numpy(rng.standard_normal((2, 32, 16))
                                .astype(np.float32)).bfloat16()
               .requires_grad_(True) for _ in range(3))
    FlashAttentionFunction.apply(q, k, v, 0.25, True).sum().backward()
    assert q.grad.dtype == k.grad.dtype == v.grad.dtype == torch.bfloat16


def test_cpu_path_launches_no_kernel():
    counters = (flash_attention_fwd, flash_attention_bwd_dq,
                flash_attention_bwd_dkv)
    before = [dict(c.launches) for c in counters]
    q, k, v, ct = _inputs(4, 1, 2, 32, 32, 16)
    _port_grads(q, k, v, ct, causal=True)
    assert [c.launches for c in counters] == before


def test_backward_kernels_take_no_cpu_tensor():
    """The kernel wrappers launch or raise: a CPU tensor is refused, not
    routed to the plain version."""
    t = torch.zeros((1, 16, 16))
    lse = torch.zeros((1, 16))
    with pytest.raises(MXNetError, match="CUDA kernel"):
        flash_attention_bwd_dq(t, t, t, t, lse, lse, 0.25, True)
    with pytest.raises(MXNetError, match="CUDA kernel"):
        flash_attention_bwd_dkv(t, t, t, t, lse, lse, 0.25, True)


def test_registered_op_and_alias_accept_interpret():
    """``FlashAttention`` / ``_contrib_FlashAttention`` name one op; the
    reference's ``interpret`` attribute is accepted and ignored."""
    op = get_op("FlashAttention")
    assert get_op("_contrib_FlashAttention") is op
    q, k, v, _ = _inputs(5, 1, 2, 32, 32, 16)
    ts = [torch.from_numpy(x) for x in (q, k, v)]
    got = op.fn(*ts, causal=True, interpret=True).numpy()
    want = np.asarray(jax_flash_attention(q, k, v, causal=True,
                                          interpret=True))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
