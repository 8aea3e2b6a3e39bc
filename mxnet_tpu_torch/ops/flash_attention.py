"""Flash attention forward: a hand-written Hopper kernel and its plain
PyTorch version.

Counterpart of ``mxnet_tpu/ops/pallas/flash_attention.py``: the kernel
in ``csrc/flash_attention_fwd.cu`` replaces the Pallas forward
``_fa_kernel``/``_fa_forward`` (online-softmax attention, causal or not,
writing O and the per-row log-sum-exp), and :func:`flash_attention`
keeps the reference wrapper's rules — (B, H, S, D) in and out, q padded
up to ``block_q`` and sliced back, ``ValueError`` when the key length is
not a multiple of ``min(block_k, Sk)``. ``block_q`` and ``block_k`` set
only those rules; the kernel's own tiles are fixed by the card.

Where the work runs is decided by where the tensors lie: a CPU tensor
takes :func:`flash_attention_reference` (plain PyTorch, equal to the
reference's ``_xla_attention`` plus the lse), a CUDA tensor launches the
kernel or raises. Unlike the reference wrapper there is no quiet
fallback: a failed build or launch propagates.

The backward kernels (the reference's ``_fa_bwd_dq_kernel`` and
``_fa_bwd_dkv_kernel``) come with the training path.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

from ..base import MXNetError

__all__ = ["flash_attention", "flash_attention_fwd",
           "flash_attention_reference"]

_NEG_INF = -1e30
_SOURCE = "flash_attention_fwd.cu"
_HEAD_DIMS = (16, 32, 64, 128)


def flash_attention_reference(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, scale: float,
                              causal: bool) -> Tuple[torch.Tensor,
                                                     torch.Tensor]:
    """Plain attention over (BH, S, D) / (BH, Sk, D): returns
    ``(o, lse)`` with lse of shape (BH, S) in float32. Causal masking is
    top-aligned (``q_pos >= k_pos``) with the kernel's finite -1e30."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if causal:
        sq, sk = s.shape[-2], s.shape[-1]
        mask = torch.ones(sq, sk, dtype=torch.bool,
                          device=s.device).tril()
        s = torch.where(mask, s, torch.full_like(s, _NEG_INF))
    lse = torch.logsumexp(s, dim=-1)
    p = torch.softmax(s, dim=-1)
    return torch.matmul(p.to(v.dtype), v).to(q.dtype), lse


def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            scale: float, causal: bool) -> Tuple[torch.Tensor,
                                                 torch.Tensor]:
    bh, sq, d = q.shape
    sk = k.shape[1]
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype != torch.float32:
            raise TypeError("flash_attention kernel takes float32, got %s "
                            "for %s" % (t.dtype, name))
        if t.device != q.device:
            raise ValueError("flash_attention: %s on %s, q on %s"
                             % (name, t.device, q.device))
    if d not in _HEAD_DIMS:
        raise ValueError("flash_attention kernel takes head dim in %s, got "
                         "%d" % (_HEAD_DIMS, d))
    if bh > 65535 or bh < 1 or sq < 1 or sk < 1:
        raise ValueError("flash_attention kernel: bad shape bh=%d sq=%d "
                         "sk=%d" % (bh, sq, sk))
    q, k, v = (_aligned(t) for t in (q, k, v))
    lib = _library()
    o = torch.empty_like(q)
    lse = torch.empty((bh, sq), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.mxt_flash_attention_fwd_f32(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            lse.data_ptr(), bh, sq, sk, d, float(scale), int(bool(causal)),
            stream)
    if err:
        raise MXNetError("flash_attention kernel launch failed: %s (%d)"
                         % (lib.mxt_cuda_error_string(err).decode(), err))
    flash_attention_fwd.launches += 1
    return o, lse


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """The kernel reads rows as float4: contiguous and 16-byte aligned."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _library() -> ctypes.CDLL:
    from .. import _build
    lib = _build.load(_SOURCE)
    fn = lib.mxt_flash_attention_fwd_f32
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.mxt_cuda_error_string.argtypes = [ctypes.c_int]
    lib.mxt_cuda_error_string.restype = ctypes.c_char_p
    return lib


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        scale: float, causal: bool) -> Tuple[torch.Tensor,
                                                             torch.Tensor]:
    """The forward over (BH, S, D) / (BH, Sk, D): ``(o, lse)``, lse
    (BH, S) float32 — the counterpart of the reference's
    ``_fa_forward``. CPU tensors take the plain version; CUDA tensors
    launch the kernel (counted in ``flash_attention_fwd.launches``)."""
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, scale, causal)
    if q.device.type == "cuda":
        return _launch(q, k, v, scale, causal)
    raise MXNetError("flash_attention: unsupported device %s (cpu or cuda)"
                     % (q.device,))


flash_attention_fwd.launches = 0


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = False, scale: Optional[float] = None,
                    block_q: int = 512, block_k: int = 512) -> torch.Tensor:
    """Flash attention over (B, H, S, D) inputs (see module docstring).

    The query length is padded to ``min(block_q, S)`` (padded rows are
    computed then sliced off — they influence nothing). The key length
    must be a multiple of ``min(block_k, Sk)``. ``causal`` masks
    top-aligned, ``q_pos >= k_pos``.
    """
    b, h, s, d = q.shape
    sk = k.shape[2]
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    bq = min(block_q, s)
    bk = min(block_k, sk)
    if sk % bk:
        raise ValueError(
            "flash_attention: key length %d must be a multiple of block_k "
            "%d (padded keys would join the softmax)" % (sk, bk))
    pad_q = (-s) % bq
    qf = q.reshape(b * h, s, d)
    if pad_q:
        qf = torch.nn.functional.pad(qf, (0, 0, 0, pad_q))
    out, _ = flash_attention_fwd(qf, k.reshape(b * h, sk, d),
                                 v.reshape(b * h, sk, d), float(scale),
                                 bool(causal))
    return out[:, :s].reshape(b, h, s, d)
