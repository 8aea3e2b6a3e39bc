"""Automatic mixed precision — bf16 compute with f32 master weights.

The port's counterpart of the reference package's ``amp.py``, over torch
dtypes. Parameters and optimizer state stay float32; the matrix-product
ops (FullyConnected, batch_dot, Convolution) cast their float32
operands to the compute dtype, accumulate in float32 and return the
compute dtype, and the loss head (SoftmaxOutput) is computed in float32.

The reference reads the policy when it traces a program; the port runs
eagerly, so the policy is read at every op call: set it before
``Module.bind`` and leave it for the run, as with the reference::

    amp.init("bfloat16")      # on
    amp.off()                 # back to full precision
    with amp.scope("bfloat16"):
        ...                   # on within the block

On the card, a bf16 product accumulates in float32 as the reference
asks only when cuBLAS may not reduce in bf16:
``torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction``
is set to False by :func:`init`. A float32 convolution is taken in full
float32, as the reference asks (``preferred_element_type=float32``):
cuDNN may use TF32 for it by default, so the convolution runs inside
:func:`conv_precision`, which turns that off for its float32 operands;
so does the fused RNN op, which runs on cuDNN's RNN.
"""
from __future__ import annotations

from contextlib import contextmanager
from typing import Optional

import torch

__all__ = ["init", "off", "active", "compute_dtype", "cast_compute",
           "mxu_operands", "conv_precision", "scope"]

_COMPUTE_DTYPE: Optional[torch.dtype] = None

_ALLOWED = {"bfloat16": torch.bfloat16, "float16": torch.float16}


def _as_dtype(dtype) -> torch.dtype:
    if isinstance(dtype, torch.dtype):
        for name, dt in _ALLOWED.items():
            if dt == dtype:
                return dt
        raise ValueError("amp compute dtype must be one of %s, got %r"
                         % (sorted(_ALLOWED), dtype))
    name = getattr(dtype, "name", str(dtype))
    if name not in _ALLOWED:
        raise ValueError("amp compute dtype must be one of %s, got %r"
                         % (sorted(_ALLOWED), name))
    return _ALLOWED[name]


def init(dtype="bfloat16") -> None:
    """Enable mixed precision: matmul operands cast to ``dtype``."""
    global _COMPUTE_DTYPE
    _COMPUTE_DTYPE = _as_dtype(dtype)
    # the reference accumulates low-precision products in f32
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = \
        False
    torch.backends.cuda.matmul.allow_fp16_reduced_precision_reduction = \
        False


def off() -> None:
    """Disable mixed precision."""
    global _COMPUTE_DTYPE
    _COMPUTE_DTYPE = None


def active() -> bool:
    return _COMPUTE_DTYPE is not None


def compute_dtype() -> Optional[torch.dtype]:
    """The low-precision compute dtype, or None when amp is off."""
    return _COMPUTE_DTYPE


def cast_compute(*tensors):
    """Cast float32 operands to the compute dtype (no-op when amp is off);
    other operands (ints, already-low-precision floats, None) pass
    through untouched."""
    if _COMPUTE_DTYPE is None:
        return tensors if len(tensors) != 1 else tensors[0]
    out = tuple(t.to(_COMPUTE_DTYPE)
                if t is not None and t.dtype == torch.float32 else t
                for t in tensors)
    return out if len(out) != 1 else out[0]


def mxu_operands(a: torch.Tensor, b: torch.Tensor):
    """Cast two matrix-product or convolution operands under the policy,
    then to their common dtype (the reference's ``result_type``), in
    which the product is taken with float32 accumulation and returned:
    under amp a convolution's output stays in the compute dtype, as the
    reference's does."""
    a, b = cast_compute(a, b)
    dtype = torch.promote_types(a.dtype, b.dtype)
    return a.to(dtype), b.to(dtype)


@contextmanager
def conv_precision(dtype: torch.dtype):
    """Within the block, cuDNN convolves ``dtype`` operands (and runs
    the fused RNN op on them) with float32 accumulation: for float32
    operands TF32 is turned off (it is on by default for cuDNN), and
    the previous setting is restored after. Inside a compiled step's
    capture it sets nothing: the capture would not keep the switch
    around the convolution, so the step sets it around the whole
    program instead (:func:`step_precision`)."""
    if dtype != torch.float32 or torch.compiler.is_compiling():
        yield
        return
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = prev


@contextmanager
def step_precision(device: torch.device):
    """Around a compiled training step's forward and backward on the
    card: cuDNN with TF32 off, as :func:`conv_precision` holds each
    float32 convolution and the fused RNN op of the eager route (bf16
    operands do not read the switch)."""
    if device.type != "cuda":
        yield
        return
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = prev


@contextmanager
def scope(dtype="bfloat16"):
    """Context manager form of :func:`init`/:func:`off`."""
    global _COMPUTE_DTYPE
    prev = _COMPUTE_DTYPE
    init(dtype)
    try:
        yield
    finally:
        _COMPUTE_DTYPE = prev
