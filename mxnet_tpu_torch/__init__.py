"""mxnet_tpu_torch — the PyTorch/CUDA port of mxnet_tpu for NVIDIA Hopper.

A package beside ``mxnet_tpu`` (the JAX reference, which stays as it
is): plain tensor code is PyTorch, and each Pallas kernel of the
reference becomes a kernel written by hand for Hopper (``sm_90a``) under
``csrc/``. The port imports ``torch``, numpy and the standard library,
never ``jax`` and nothing of ``mxnet_tpu``; the few jax-free modules it
needs from the reference are copied in.

Entry points run on ``cuda:0`` unless the caller passes
``device="cpu"``; without a GPU and without that request they raise.

Ported so far: generative serving of the zoo transformer LM
(:mod:`.serve`) with prefill attention on the flash-attention forward
kernel (:mod:`.ops.flash_attention`).
"""
from __future__ import annotations

from .base import MXNetError
from .context import cpu, gpu

__all__ = ["MXNetError", "cpu", "gpu"]

__version__ = "0.1.0"
