"""The port's flash-attention forward against the reference's Pallas
kernel (run in interpret mode, as the reference's own tests run it on
the CPU).

On the CPU the port's wrapper takes its plain PyTorch version; that is
what these tests hold against the Pallas kernel's numbers. The CUDA
kernel itself is held against the same plain version on the card by
``chip_smoke.py``. All inputs are drawn with numpy from a seed; f32
throughout, atol 1e-5 (both sides accumulate in f32 over at most 64
keys, so their difference is rounding only).
"""
import numpy as np
import pytest
import torch

from mxnet_tpu.ops.pallas.flash_attention import _fa_forward
from mxnet_tpu.ops.pallas.flash_attention import \
    flash_attention as jax_flash_attention
from mxnet_tpu_torch import _build
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.ops.flash_attention import (flash_attention,
                                                 flash_attention_fwd,
                                                 flash_attention_reference)

ATOL = 1e-5


def _qkv(seed, b, h, s, sk, d):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, h, s, d)).astype(np.float32),
            rng.standard_normal((b, h, sk, d)).astype(np.float32),
            rng.standard_normal((b, h, sk, d)).astype(np.float32))


def _port(q, k, v, **kw):
    out = flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                          torch.from_numpy(v), **kw)
    return out.numpy()


def _jax(q, k, v, **kw):
    return np.asarray(jax_flash_attention(q, k, v, interpret=True, **kw))


@pytest.mark.parametrize("causal", [False, True])
def test_matches_pallas_kernel(causal):
    """BH 4, S 64, D 16: outputs equal the Pallas kernel's."""
    q, k, v = _qkv(0, 2, 2, 64, 64, 16)
    np.testing.assert_allclose(
        _port(q, k, v, causal=causal, block_q=32, block_k=16),
        _jax(q, k, v, causal=causal, block_q=32, block_k=16), atol=ATOL)


@pytest.mark.parametrize("causal", [False, True])
def test_lse_matches_pallas_forward(causal):
    """The per-row log-sum-exp equals the Pallas forward's lane 0."""
    q, k, v = _qkv(1, 1, 4, 64, 64, 16)
    flat = [x.reshape(4, 64, 16) for x in (q, k, v)]
    scale = 1.0 / np.sqrt(16)
    o_j, lse_j = _fa_forward(*flat, scale, causal, 32, 16, True)
    o_t, lse_t = flash_attention_fwd(*(torch.from_numpy(x) for x in flat),
                                     scale, causal)
    assert lse_t.shape == (4, 64) and lse_t.dtype == torch.float32
    np.testing.assert_allclose(lse_t.numpy(), np.asarray(lse_j)[..., 0],
                               atol=ATOL)
    np.testing.assert_allclose(o_t.numpy(), np.asarray(o_j), atol=ATOL)


@pytest.mark.parametrize("causal", [False, True])
def test_padded_q(causal):
    """S = 40 with block_q 16 pads q to 48 rows and slices them off."""
    q, k, v = _qkv(2, 1, 4, 40, 40, 16)
    out = _port(q, k, v, causal=causal, block_q=16, block_k=8)
    assert out.shape == (1, 4, 40, 16)
    np.testing.assert_allclose(
        out, _jax(q, k, v, causal=causal, block_q=16, block_k=8),
        atol=ATOL)


def test_cross_attention_shapes():
    """Sk != S (non-causal) with an explicit scale."""
    q, k, v = _qkv(3, 2, 2, 24, 32, 16)
    np.testing.assert_allclose(
        _port(q, k, v, scale=0.3, block_q=8, block_k=16),
        _jax(q, k, v, scale=0.3, block_q=8, block_k=16), atol=ATOL)


def test_unaligned_keys_raise_in_both():
    q, k, v = _qkv(4, 1, 1, 40, 40, 16)
    with pytest.raises(ValueError, match="multiple of block_k"):
        _port(q, k, v, block_k=16)
    with pytest.raises(ValueError, match="multiple of block_k"):
        _jax(q, k, v, block_k=16)


def test_bhsd_layout_round_trip():
    """(B, H, S, D) in and out: head (b, h) of the result is the
    attention of head (b, h) alone."""
    q, k, v = _qkv(5, 2, 3, 32, 32, 16)
    full = _port(q, k, v, causal=True)
    for b in range(2):
        for h in range(3):
            one = _port(q[b:b + 1, h:h + 1], k[b:b + 1, h:h + 1],
                        v[b:b + 1, h:h + 1], causal=True)
            np.testing.assert_allclose(full[b, h], one[0, 0], atol=1e-6)


def test_reference_matches_dense_causal_bias():
    """The kernel's -1e30 causal mask and the serve path's -1e9 additive
    bias give the same rows (every causal row keeps key 0)."""
    q, k, v = (torch.from_numpy(x[0]) for x in _qkv(6, 1, 2, 16, 16, 16))
    o, _ = flash_attention_reference(q, k, v, 0.25, True)
    s = q @ k.transpose(-1, -2) * 0.25
    s = s + torch.triu(torch.ones(16, 16), 1) * -1e9
    np.testing.assert_allclose(o.numpy(),
                               (torch.softmax(s, -1) @ v).numpy(),
                               atol=ATOL)


def test_cpu_path_launches_nothing():
    q, k, v = _qkv(7, 1, 1, 16, 16, 16)
    before = dict(flash_attention_fwd.launches)
    _port(q, k, v, causal=True)
    assert flash_attention_fwd.launches == before


def test_other_devices_raise_not_fall_back():
    """Only a CPU tensor takes the plain version: any other device
    launches the kernel or raises."""
    q = torch.zeros((1, 1, 16, 16), device="meta")
    with pytest.raises(MXNetError, match="unsupported device"):
        flash_attention(q, q, q)


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    """A missing compiler is an error naming it, never a quiet
    fallback to the plain version."""
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(MXNetError, match="nvcc not found"):
        _build.build(["flash_attention_fwd.cu"])
