"""mxnet_tpu_torch — the PyTorch/CUDA port of mxnet_tpu for NVIDIA Hopper.

A package beside ``mxnet_tpu`` (the JAX reference, which stays as it
is): plain tensor code is PyTorch, and each Pallas kernel of the
reference becomes a kernel written by hand for Hopper (``sm_90a``) under
``csrc/``. The port imports ``torch``, numpy and the standard library,
never ``jax`` and nothing of ``mxnet_tpu``; the few jax-free modules it
needs from the reference are copied in.

Entry points run on ``cuda:0`` unless the caller passes
``device="cpu"`` (``ctx=cpu()``) or enters ``device_scope("cpu")``;
without a GPU and without that request they raise.

Ported so far:

* generative serving of the zoo transformer LM (:mod:`.serve`), with
  prefill attention on the flash-attention forward kernel;
* training through ``Module.fit`` (:mod:`.module`) over the Symbol
  layer (:mod:`.symbol`, :mod:`.executor`), with amp bf16
  (:mod:`.amp`), the SGD optimizer (:mod:`.optimizer`) and flash
  attention's forward, dQ and dK/dV kernels
  (:mod:`.ops.flash_attention`);
* the user-kernel tier: CUDA C++ compiled at run time (:mod:`.rtc`),
  callable on NDArrays and registrable as ``nd.<op>`` / ``sym.<op>``,
  and custom operators (:mod:`.operator`), with the ``nd.<op>`` and
  :mod:`.contrib` namespaces;
* the seeded key chain of ``mx.random`` (:mod:`.random`), from which
  ``fit``'s default initializer draws;
* ResNet (:mod:`.models.resnet`) training through ``Module``: the
  ``Convolution``, ``Pooling``, ``BatchNorm``, ``Flatten`` and ``Pad``
  ops, aux states from the symbol to the executor and the module, and
  checkpoints (:mod:`.model`) that load in both packages;
* the imperative API: the autograd tape (:mod:`.autograd`, on
  ``torch.autograd``) over ``nd`` and Gluon (:mod:`.gluon`) —
  Parameter, Block / HybridBlock, the ``nn`` layers, losses, Trainer,
  ``data`` and the vision model zoo, whose parameters load in both
  packages;
* the recurrent family: the fused ``RNN`` op (:mod:`.ops.rnn_op`, on
  cuDNN's RNN), the ``Sequence*`` ops, the symbolic cells and
  ``BucketSentenceIter`` (:mod:`.rnn`), ``BucketingModule``
  (:mod:`.module.bucketing_module`), Gluon's recurrent cells and layers
  (:mod:`.gluon.rnn`), the ``Perplexity`` metric and the callbacks
  (:mod:`.callback`);
* every optimizer of the reference (:mod:`.optimizer`, the update ops of
  :mod:`.ops.optimizer_op`), the learning-rate schedules
  (:mod:`.lr_scheduler`), every metric (:mod:`.metric`), and crash-safe
  checkpoints with exact resume (:mod:`.checkpoint`,
  ``Module.fit(checkpoint=, resume_from=)``) in the reference's format.
"""
from __future__ import annotations

from . import amp, autograd, callback, checkpoint, contrib
from . import initializer as init
from . import io, lr_scheduler, metric, model
from . import module as mod
from . import ndarray as nd
from . import gluon, operator, optimizer, random, rnn, rtc
from . import symbol as sym
from .base import MXNetError
from .context import cpu, current_device, device_scope, gpu

__all__ = ["MXNetError", "cpu", "gpu", "device_scope", "current_device",
           "amp", "autograd", "callback", "checkpoint", "contrib", "gluon",
           "init", "io", "lr_scheduler", "metric", "mod", "model", "nd",
           "operator",
           "optimizer", "random", "rnn", "rtc", "sym"]

__version__ = "0.1.0"
