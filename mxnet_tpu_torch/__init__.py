"""mxnet_tpu_torch — the PyTorch/CUDA port of mxnet_tpu for NVIDIA Hopper.

A package beside ``mxnet_tpu`` (the JAX reference, which stays as it
is): plain tensor code is PyTorch, and each Pallas kernel of the
reference becomes a kernel written by hand for Hopper (``sm_90a``) under
``csrc/``. The port imports ``torch``, numpy and the standard library,
never ``jax`` and nothing of ``mxnet_tpu``; the few jax-free modules it
needs from the reference are copied in.

Entry points run on ``cuda:0`` unless the caller passes
``device="cpu"`` (``ctx=cpu()``) or enters ``with cpu():`` (or
``device_scope("cpu")``); without a GPU and without that request they
raise. ``cpu()``, ``gpu()`` and ``tpu()`` return a :class:`Context`
(``tpu`` names the accelerator, here the CUDA card), and
``current_context()`` is the card unless a scope says otherwise.

Ported so far:

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
  ``Module.fit(checkpoint=, resume_from=)``) in the reference's format;
* the op library (:mod:`.ops`) with the structured families: vision
  (ROI pooling, the samplers, ``Correlation``, deformable convolution),
  detection (the SSD ``MultiBox*`` ops, ``Proposal``, ``CTCLoss``) and
  contrib, with the fork's Stochastic Activation Pruning;
* Module's inference surface: ``predict`` / ``iter_predict``,
  ``save_params`` / ``load_params``, the shape properties, ``reshape``,
  ``get_states`` / ``set_states``, the executor monitor (:mod:`.monitor`,
  ``fit(monitor=)``) and ``SequentialModule``;
* Symbol's whole surface (``get_internals``, composition, ``eval``,
  ``infer_type``, the fluent methods), naming and attribute scopes
  (:mod:`.name`), :class:`Context`, and model parallelism through
  ``AttrScope(ctx_group=)`` and ``simple_bind(group2ctx=)``
  (:mod:`.executor`);
* the data plane: RecordIO (:mod:`.recordio`, :mod:`.filesystem`), the
  native decode pipeline (:mod:`.native`, built with g++ against
  libjpeg / libpng), ``ImageRecordIter`` and the other iterators
  (:mod:`.io`), the augmenters and ``ImageIter`` (:mod:`.image`), the
  multi-process ``DataLoader`` with its resumable cursor
  (:mod:`.data`, imported on first use) and Gluon's file datasets;
  ``fit`` runs the reference's async loop: a window of in-flight steps,
  batches copied to the card ahead of their step, metrics summed on the
  card;
* deployment and serving: the forward-only :class:`Predictor`
  (:mod:`.predictor`) with its ``torch.export`` artifact, which
  ``tools/predict_exported.py`` runs without the framework, and
  :mod:`.serve`: ``InferenceServer`` (dynamic batching over the bucket
  grid) and ``GenerativeServer`` (continuous-batching decode of the zoo
  LM over an f32 or int8 KV cache, prefill attention on the
  flash-attention forward kernel);
* the one-process ``KVStore`` (:mod:`.kvstore`, ``kv.create``), which
  ``Module`` and ``gluon.Trainer`` take, and the examples
  (:mod:`.examples`) with the reference's fit harness
  (``examples/common/fit.py``);
* observability (:mod:`.profiler`, :mod:`.obs`, imported on first use):
  spans on named lanes with flows across threads and a chrome-trace
  dump, the ``/metrics`` endpoint both servers start, compile
  accounting, the MFU gauge and the flight recorder; the knob layer
  (:mod:`.config`) and the lock witness (:mod:`.lockcheck`);
* the legacy surface and the tools: ``operator.PythonOp`` /
  ``NumpyOp`` / ``NDArrayOp``, :mod:`.test_utils`, :mod:`.visualization`
  (``viz``), and ``tools/`` (``caffe_converter``, ``convert_params``,
  ``parse_log``, ``kill_mxnet``);
* the serving fleet (:mod:`.fleet`, imported on first use): a gateway
  over ``GenerativeServer`` replica processes with least-loaded routing,
  supervision and exact fail-over;
* the single-host training supervisor (:mod:`.elastic`, ``python -m
  mxnet_tpu_torch.elastic``): restarts after a preemption or a crash,
  and the child resumes from its checkpoints; the configuration
  autotuner (:mod:`.tune`, imported only when ``fit(tune=)`` or
  ``MXNET_TPU_TUNE`` arms it) with its store keyed by :mod:`.aot`'s
  fingerprint.
"""
from __future__ import annotations

from . import amp, autograd, callback, checkpoint, contrib, executor
from . import initializer as init
from . import filesystem, image, io, kvstore, lr_scheduler, metric, model
from . import name
from . import kvstore as kv
from . import recordio
from . import module as mod
from . import monitor as mon
from . import ndarray as nd
from . import gluon, operator, optimizer, random, rnn, rtc
from . import symbol as sym
from . import predictor, serve
from . import config, lockcheck, profiler
from . import models, test_utils
from . import optimizer as opt
from . import visualization
from . import visualization as viz
from .base import MXNetError
from .context import (Context, cpu, current_context, current_device,
                      device_scope, gpu, num_devices, tpu)
from .initializer import (Constant, Normal, One, Orthogonal, Uniform,
                          Xavier, Zero)
from .name import AttrScope, NameManager
from .predictor import Predictor

__all__ = ["MXNetError", "Context", "cpu", "gpu", "tpu", "current_context",
           "num_devices", "device_scope", "current_device", "NameManager",
           "AttrScope", "amp", "autograd", "callback", "checkpoint",
           "contrib", "executor", "gluon", "init", "io", "kv", "kvstore",
           "lr_scheduler",
           "metric", "mod", "model", "mon", "name", "nd", "operator",
           "optimizer", "random", "rnn", "rtc", "sym", "filesystem",
           "recordio", "image", "data", "predictor", "Predictor", "serve",
           "config", "lockcheck", "profiler", "obs", "opt", "models",
           "test_utils", "visualization", "viz", "fleet", "elastic", "tune",
           "aot"]

__version__ = "0.1.0"


def __getattr__(name):
    # data is lazy, as in the reference: a fit fed by any other iterator
    # never imports the multi-process loader; obs loads at first use (a
    # build, a bind, a server's endpoint); analysis at the first call
    # that asks for it (a bind under MXNET_TPU_ANALYZE, Symbol.analyze);
    # fleet and elastic likewise: a plain serve process never loads the
    # multi-replica gateway; the tuner only when a fit arms it
    if name in ("data", "obs", "analysis", "fleet", "elastic", "tune",
                "aot"):
        import importlib
        return importlib.import_module("." + name, __name__)
    raise AttributeError("module %r has no attribute %r" % (__name__, name))


# knobs that act once at import (MXNET_PROFILER_AUTOSTART)
config._apply_import_knobs()
