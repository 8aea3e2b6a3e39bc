"""Flash attention: hand-written Hopper kernels, their plain PyTorch
versions and the autograd wrapper.

Counterpart of ``mxnet_tpu/ops/pallas/flash_attention.py``. Three
kernels replace the reference's three Pallas kernels:

* ``csrc/flash_attention_fwd.cu`` — the forward ``_fa_kernel`` /
  ``_fa_forward`` (online-softmax attention writing O and the per-row
  log-sum-exp);
* ``csrc/flash_attention_bwd.cu`` — ``_fa_bwd_dq_kernel`` (dQ, one
  block per q tile walking the KV tiles) and ``_fa_bwd_dkv_kernel``
  (dK and dV, one block per KV tile walking the q tiles), both
  rebuilding P from the saved lse.

Each comes in float32 (the serving path, and training with amp off) and
bfloat16 (training under amp), both accumulating in float32. The routes,
chosen by the C entry points by dtype and head dim alone:

* float32 forward, dQ and dK/dV, every head dim: 3xTF32 on ``mma.sync``
  tensor cores (each operand split into two tf32 halves, three products;
  float32's accuracy), the tiles that stream through a ``cp.async``
  ring;
* bfloat16 forward, dQ and dK/dV at head dims 64 and 128: ``wgmma`` over
  shared-memory tiles that TMA loads into a ring of ``mbarrier``-guarded
  stages (``csrc/flash_attention_sm90.cuh``);
* bfloat16 at head dims 16, 32 and 256: ``mma.sync``.

The kernels take head dims 16, 32, 64, 128 and 256. :func:`flash_attention`
takes any head dim up to 256, as the reference's kernels do: it
zero-pads q, k and v along D up to the next of those and slices the
output back, on every device, so that the CPU runs the same code.
Zero columns add nothing to q·kᵀ, and the padded columns of O, dQ, dK
and dV are zero and dropped, so the padding is exact. Head dims above
256 raise (ROADMAP B7).

:class:`FlashAttentionFunction` is the reference's ``custom_vjp``: the
forward saves q, k, v, O and lse; the backward computes
Δ = rowsum(dO ⊙ O) in float32 and calls the two backward kernels.
:func:`flash_attention` keeps the reference wrapper's rules — (B, H, S,
D) in and out, q padded up to ``min(block_q, S)`` and sliced back,
``ValueError`` when the key length is not a multiple of ``min(block_k,
Sk)``, ``scale`` defaulting to ``1/sqrt(D)``. ``block_q`` and
``block_k`` set only those rules; the kernels' own tiles are fixed by
the card. ``interpret`` is accepted and ignored, so that Symbol JSON
written by the reference loads.

Where the work runs is decided by where the tensors lie: CPU tensors
take the plain versions :func:`flash_attention_reference` and
:func:`flash_attention_backward_reference`; CUDA tensors launch the
kernels or raise. Unlike the reference wrapper there is no quiet
fallback: a failed build or launch propagates.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

from ..base import MXNetError
from .registry import register

__all__ = ["flash_attention", "flash_attention_fwd",
           "flash_attention_bwd_dq", "flash_attention_bwd_dkv",
           "flash_attention_reference",
           "flash_attention_backward_reference", "FlashAttentionFunction",
           "padded_head_dim"]

_NEG_INF = -1e30
_FWD_SOURCE = "flash_attention_fwd.cu"
_BWD_SOURCE = "flash_attention_bwd.cu"
_HEAD_DIMS = (16, 32, 64, 128, 256)
_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}


def _launch_counts():
    """A kernel wrapper's launch counts, one per input dtype."""
    return {suffix: 0 for suffix in _SUFFIX.values()}


def _scores(q, k, scale, causal):
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if causal:
        sq, sk = s.shape[-2], s.shape[-1]
        mask = torch.ones(sq, sk, dtype=torch.bool, device=s.device).tril()
        s = torch.where(mask, s, torch.full_like(s, _NEG_INF))
    return s


def flash_attention_reference(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, scale: float,
                              causal: bool) -> Tuple[torch.Tensor,
                                                     torch.Tensor]:
    """Plain attention over (BH, S, D) / (BH, Sk, D): returns
    ``(o, lse)`` with lse of shape (BH, S) in float32. Causal masking is
    top-aligned (``q_pos >= k_pos``) with the kernel's finite -1e30."""
    s = _scores(q, k, scale, causal)
    lse = torch.logsumexp(s, dim=-1)
    p = torch.softmax(s, dim=-1)
    return torch.matmul(p.to(v.dtype), v).to(q.dtype), lse


def flash_attention_backward_reference(q, k, v, o, lse, do, scale: float,
                                       causal: bool):
    """Plain backward over (BH, S, D) / (BH, Sk, D) by the kernels'
    formulas, in float32: P = exp(s − lse), Δ = rowsum(dO ⊙ O),
    dS = P ⊙ (dO·Vᵀ − Δ)·scale, dQ = dS·K, dK = dSᵀ·Q, dV = Pᵀ·dO.
    Returns ``(dq, dk, dv)`` in q's, k's and v's dtypes."""
    p = torch.exp(_scores(q, k, scale, causal) - lse.float()[..., None])
    dof = do.float()
    delta = (dof * o.float()).sum(-1)
    dv = torch.matmul(p.transpose(-1, -2), dof)
    dp = torch.matmul(dof, v.float().transpose(-1, -2))
    ds = p * (dp - delta[..., None]) * scale
    dq = torch.matmul(ds, k.float())
    dk = torch.matmul(ds.transpose(-1, -2), q.float())
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


# ------------------------------------------------------------------ kernels

def _aligned(t: torch.Tensor) -> torch.Tensor:
    """The kernels read rows as 16-byte vectors, and TMA needs a 16-byte
    aligned base: contiguous and 16-byte aligned."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _check(name_tensors, bh, sq, sk, d):
    dtype = name_tensors[0][1].dtype
    dev = name_tensors[0][1].device
    if dtype not in _SUFFIX:
        raise TypeError("flash_attention kernels take float32 or bfloat16, "
                        "got %s" % (dtype,))
    for name, t in name_tensors:
        if t.dtype != dtype:
            raise TypeError("flash_attention: %s is %s, q is %s"
                            % (name, t.dtype, dtype))
        if t.device != dev:
            raise ValueError("flash_attention: %s on %s, q on %s"
                             % (name, t.device, dev))
    if d not in _HEAD_DIMS:
        raise ValueError("flash_attention kernels take head dim in %s, got "
                         "%d" % (_HEAD_DIMS, d))
    if bh > 65535 or bh < 1 or sq < 1 or sk < 1:
        raise ValueError("flash_attention kernels: bad shape bh=%d sq=%d "
                         "sk=%d" % (bh, sq, sk))
    return _SUFFIX[dtype]


_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    # C entry point (less its _f32/_bf16 suffix) -> ctypes argument types:
    # tensor pointers, bh, sq, sk, d, scale, causal, stream
    "mxt_flash_attention_fwd": [_P] * 5 + [_I] * 4 + [_F, _I, _P],
    "mxt_flash_attention_bwd_dq": [_P] * 7 + [_I] * 4 + [_F, _I, _P],
    "mxt_flash_attention_bwd_dkv": [_P] * 8 + [_I] * 4 + [_F, _I, _P],
}


def _kernel(source: str, name: str, suffix: str):
    from .. import _build
    lib = _build.load(source)
    fn = getattr(lib, "%s_%s" % (name, suffix))
    fn.argtypes = _SIGNATURES[name]
    fn.restype = ctypes.c_int
    lib.mxt_cuda_error_string.argtypes = [ctypes.c_int]
    lib.mxt_cuda_error_string.restype = ctypes.c_char_p
    return lib, fn


def _run(source, name, suffix, device, *args):
    lib, fn = _kernel(source, name, suffix)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(*args, stream)
    if err:
        raise MXNetError("%s_%s launch failed: %s (%d)" % (
            name, suffix, lib.mxt_cuda_error_string(err).decode(), err))


def _dispatch(q, what):
    if q.device.type == "cpu":
        return False
    if q.device.type == "cuda":
        return True
    raise MXNetError("%s: unsupported device %s (cpu or cuda)"
                     % (what, q.device))


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        scale: float, causal: bool) -> Tuple[torch.Tensor,
                                                             torch.Tensor]:
    """The forward over (BH, S, D) / (BH, Sk, D): ``(o, lse)``, o in
    q's dtype, lse (BH, S) float32 — the counterpart of the reference's
    ``_fa_forward``. CPU tensors take the plain version; CUDA tensors
    launch the kernel (counted per input dtype in
    ``flash_attention_fwd.launches``, keyed ``"f32"`` / ``"bf16"``)."""
    if not _dispatch(q, "flash_attention_fwd"):
        return flash_attention_reference(q, k, v, scale, causal)
    bh, sq, d = q.shape
    sk = k.shape[1]
    suffix = _check((("q", q), ("k", k), ("v", v)), bh, sq, sk, d)
    q, k, v = (_aligned(t) for t in (q, k, v))
    o = torch.empty_like(q)
    lse = torch.empty((bh, sq), dtype=torch.float32, device=q.device)
    _run(_FWD_SOURCE, "mxt_flash_attention_fwd", suffix, q.device,
         q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
         lse.data_ptr(), bh, sq, sk, d, float(scale), int(bool(causal)))
    flash_attention_fwd.launches[suffix] += 1
    return o, lse


flash_attention_fwd.launches = _launch_counts()


def _bwd_inputs(q, k, v, do, lse, delta):
    bh, sq, d = q.shape
    sk = k.shape[1]
    suffix = _check((("q", q), ("k", k), ("v", v), ("do", do)),
                    bh, sq, sk, d)
    for name, t in (("lse", lse), ("delta", delta)):
        if t.dtype != torch.float32 or tuple(t.shape) != (bh, sq):
            raise ValueError("flash_attention backward: %s must be float32 "
                             "(%d, %d), got %s %s" % (name, bh, sq, t.dtype,
                                                      tuple(t.shape)))
    q, k, v, do = (_aligned(t) for t in (q, k, v, do))
    lse, delta = _aligned(lse), _aligned(delta)
    return suffix, (bh, sq, sk, d), (q, k, v, do, lse, delta)


def flash_attention_bwd_dq(q, k, v, do, lse, delta, scale: float,
                           causal: bool) -> torch.Tensor:
    """dQ kernel (the reference's ``_fa_bwd_dq_kernel``) over (BH, S,
    D) / (BH, Sk, D) CUDA tensors, with lse and Δ (BH, S) float32; dQ in
    q's dtype. Counted per input dtype in
    ``flash_attention_bwd_dq.launches``."""
    if q.device.type != "cuda":
        raise MXNetError("flash_attention_bwd_dq launches a CUDA kernel; "
                         "got %s tensors (the CPU path is "
                         "flash_attention_backward_reference)" % q.device)
    suffix, (bh, sq, sk, d), ins = _bwd_inputs(q, k, v, do, lse, delta)
    q, k, v, do, lse, delta = ins
    dq = torch.empty_like(q)
    _run(_BWD_SOURCE, "mxt_flash_attention_bwd_dq", suffix, q.device,
         q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
         lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), bh, sq, sk, d,
         float(scale), int(bool(causal)))
    flash_attention_bwd_dq.launches[suffix] += 1
    return dq


flash_attention_bwd_dq.launches = _launch_counts()


def flash_attention_bwd_dkv(q, k, v, do, lse, delta, scale: float,
                            causal: bool) -> Tuple[torch.Tensor,
                                                   torch.Tensor]:
    """dK/dV kernel (the reference's ``_fa_bwd_dkv_kernel``) over CUDA
    tensors; ``(dk, dv)`` in k's and v's dtype. Counted per input dtype
    in ``flash_attention_bwd_dkv.launches``."""
    if q.device.type != "cuda":
        raise MXNetError("flash_attention_bwd_dkv launches a CUDA kernel; "
                         "got %s tensors (the CPU path is "
                         "flash_attention_backward_reference)" % q.device)
    suffix, (bh, sq, sk, d), ins = _bwd_inputs(q, k, v, do, lse, delta)
    q, k, v, do, lse, delta = ins
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    _run(_BWD_SOURCE, "mxt_flash_attention_bwd_dkv", suffix, q.device,
         q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
         lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
         bh, sq, sk, d, float(scale), int(bool(causal)))
    flash_attention_bwd_dkv.launches[suffix] += 1
    return dk, dv


flash_attention_bwd_dkv.launches = _launch_counts()


def flash_attention_backward(q, k, v, o, lse, do, scale: float,
                             causal: bool):
    """``(dq, dk, dv)``: the plain version for CPU tensors, Δ and the
    two backward kernels for CUDA tensors."""
    if not _dispatch(q, "flash_attention_backward"):
        return flash_attention_backward_reference(q, k, v, o, lse, do,
                                                  scale, causal)
    # Δ_i = rowsum(dO ⊙ O) in f32: as in the reference, outside the kernels
    delta = (do.float() * o.float()).sum(-1)
    dq = flash_attention_bwd_dq(q, k, v, do, lse, delta, scale, causal)
    dk, dv = flash_attention_bwd_dkv(q, k, v, do, lse, delta, scale, causal)
    return dq, dk, dv


class FlashAttentionFunction(torch.autograd.Function):
    """Flash attention over (BH, S, D) / (BH, Sk, D) with the kernels'
    backward (the reference's ``_fa`` custom_vjp)."""

    @staticmethod
    def forward(ctx, q, k, v, scale, causal):
        o, lse = flash_attention_fwd(q, k, v, scale, causal)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.scale, ctx.causal = scale, causal
        return o

    @staticmethod
    def backward(ctx, g):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_backward(
            q, k, v, o, lse, g.to(q.dtype), ctx.scale, ctx.causal)
        return dq, dk, dv, None, None


def padded_head_dim(d: int) -> int:
    """The kernels' head dim that ``flash_attention`` pads ``d`` up to:
    the smallest of 16, 32, 64, 128 and 256 that is at least ``d``."""
    for dk in _HEAD_DIMS:
        if d <= dk:
            return dk
    raise ValueError(
        "flash_attention takes head dims up to %d, got %d (head dims above "
        "256 are ROADMAP B7)" % (_HEAD_DIMS[-1], d))


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = False, scale: Optional[float] = None,
                    block_q: int = 512, block_k: int = 512,
                    interpret=None) -> torch.Tensor:
    """Flash attention over (B, H, S, D) inputs (see module docstring).

    The head dim D is zero-padded up to :func:`padded_head_dim` after
    ``scale`` is taken from it, and the output sliced back (exact). The
    query length is padded to ``min(block_q, S)`` (padded rows are
    computed then sliced off — they influence nothing). The key length
    must be a multiple of ``min(block_k, Sk)``. ``causal`` masks
    top-aligned, ``q_pos >= k_pos``. Differentiable: the backward runs
    the dQ and dK/dV kernels.
    """
    b, h, s, d = q.shape
    sk = k.shape[2]
    if scale is None:
        scale = 1.0 / math.sqrt(d)      # from the real head dim
    dp = padded_head_dim(d)
    if dp != d:
        q, k, v = (torch.nn.functional.pad(t, (0, dp - d))
                   for t in (q, k, v))
    bq = min(block_q, s)
    bk = min(block_k, sk)
    if sk % bk:
        raise ValueError(
            "flash_attention: key length %d must be a multiple of block_k "
            "%d (padded keys would join the softmax)" % (sk, bk))
    pad_q = (-s) % bq
    qf = q.reshape(b * h, s, dp)
    if pad_q:
        qf = torch.nn.functional.pad(qf, (0, 0, 0, pad_q))
    out = FlashAttentionFunction.apply(qf, k.reshape(b * h, sk, dp),
                                       v.reshape(b * h, sk, dp),
                                       float(scale), bool(causal))
    return out[:, :s, :d].reshape(b, h, s, d)


@register("FlashAttention", num_inputs=3,
          aliases=("_contrib_FlashAttention",))
def _flash_attention_op(q, k, v, causal=False, scale=None, block_q=512,
                        block_k=512, interpret=None):
    """Flash attention over (B, H, S, D) q/k/v as a framework op."""
    return flash_attention(q, k, v, causal=causal, scale=scale,
                           block_q=block_q, block_k=block_k)


# shape inference runs ops on meta tensors, which no kernel takes
_flash_attention_op.meta_fn = lambda q, k, v, **attrs: torch.empty_like(q)
