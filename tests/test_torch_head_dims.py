"""Head dims outside the kernels' {16, 32, 64, 128, 256}: the port's
``flash_attention`` zero-pads q, k and v along D up to the next of them
(scale from the real D) and slices the output back, on every device.

Forward and autograd backward at D 8, 24, 48, 80, 96 and 160, float32,
causal and not, S 64 and a ragged S 40 (q padded to block_q 32), against
the reference's ``flash_attention`` (Pallas in interpret mode, as
``tests/test_torch_flash_attention_bwd.py`` runs it) and against the
port's plain versions at the unpadded D. Tolerance: each output within
1e-5 max(1, max|ref|) (float32 sums over at most 64 keys and the padded
columns, which add exact zeros, in another order). A head dim above 256
raises ``ValueError`` naming ROADMAP B7.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mxnet_tpu.ops.pallas.flash_attention import \
    flash_attention as jax_flash_attention
from mxnet_tpu_torch.ops.flash_attention import (
    flash_attention, flash_attention_backward_reference,
    flash_attention_reference, padded_head_dim)

TOL = 1e-5
DIMS = [8, 24, 48, 80, 96, 160]
# (S, block_q): a whole tile, and a ragged length whose q is padded
LENGTHS = [(64, 512), (40, 32)]


def _inputs(seed, s, d):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((1, 2, s, d)).astype(np.float32)
            for _ in range(4)]


def _close(got, want):
    err = np.abs(got - want).max()
    assert err <= TOL * max(1.0, np.abs(want).max()), err


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("s, block_q", LENGTHS, ids=["s64", "ragged40"])
@pytest.mark.parametrize("d", DIMS)
def test_padded_head_dims_match_reference_and_plain(d, s, block_q, causal):
    q, k, v, ct = _inputs(d + s, s, d)
    kw = dict(causal=causal, block_q=block_q)

    def jax_loss(q, k, v):
        out = jax_flash_attention(q, k, v, interpret=True, **kw)
        return (out * ct).sum(), out
    (_, want_o), want_g = jax.value_and_grad(
        jax_loss, argnums=(0, 1, 2), has_aux=True)(
            *(jnp.asarray(x) for x in (q, k, v)))

    ts = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v)]
    out = flash_attention(*ts, **kw)
    assert out.shape == (1, 2, s, d)
    (out * torch.from_numpy(ct)).sum().backward()
    got_o = out.detach().numpy()
    got_g = [t.grad.numpy() for t in ts]
    assert all(g.shape == (1, 2, s, d) for g in got_g)

    _close(got_o, np.asarray(want_o))
    for g, w in zip(got_g, want_g):
        _close(g, np.asarray(w))

    # the port's plain versions at the real head dim, no padding
    q3, k3, v3, ct3 = (torch.from_numpy(x[0]) for x in (q, k, v, ct))
    o3, lse3 = flash_attention_reference(q3, k3, v3, d ** -0.5, causal)
    _close(got_o[0], o3.numpy())
    plain = flash_attention_backward_reference(q3, k3, v3, o3, lse3, ct3,
                                               d ** -0.5, causal)
    for g, w in zip(got_g, plain):
        _close(g[0], w.numpy())


def test_padded_head_dim_ladder():
    assert [padded_head_dim(d) for d in (1, 16, 17, 48, 80, 96, 128, 129,
                                         160, 256)] == \
        [16, 16, 32, 64, 128, 128, 128, 256, 256, 256]


@pytest.mark.parametrize("d", [257, 320])
def test_head_dims_above_256_raise_naming_b7(d):
    q = torch.zeros((1, 1, 8, d))
    with pytest.raises(ValueError, match="B7"):
        flash_attention(q, q, q)
    with pytest.raises(ValueError, match="B7"):
        padded_head_dim(d)
