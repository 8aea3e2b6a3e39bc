"""Applied rematerialization: the analyzer's ``remat-opportunity``
suggestion, or a named policy, turned into the ``torch.utils.checkpoint``
wrap the train step runs under.

The port's copy of the reference's ``remat.py``, behind the same knob:

``MXNET_TPU_REMAT = off | auto | <policy-name>``

* ``off`` (default): every activation is saved.
* ``auto``: run the analysis passes over the bound symbol and apply the
  policy the ``remat-opportunity`` pass suggests for this graph
  (``extras["remat"]["suggestion"]["policy"]``); the name becomes
  ``auto:<policy>``. No suggestion means no wrap.
* a policy name, one of jax's predicate policies, in its torch form:

  - ``nothing_saveable``: a plain non-reentrant checkpoint (the block's
    inputs are kept, everything inside is recomputed);
  - ``everything_saveable``: no wrap;
  - ``dots_saveable`` / ``checkpoint_dots``: a selective checkpoint
    (``create_selective_checkpoint_contexts``) that saves the outputs of
    the contractions jax counts as ``dot_general``: those of
    ``FullyConnected``, ``dot`` and ``batch_dot`` nodes;
  - ``dots_with_no_batch_dims_saveable`` /
    ``checkpoint_dots_with_no_batch_dims``: the same without batch
    dimensions (``FullyConnected``, ``dot``).

  A contraction is classified by the graph node that runs it, not by
  its aten name: a convolution is not a dot in jax, nor is the Pallas
  attention call, so under the dots policies cuDNN convolutions and the
  flash kernels (launched outside the dispatcher) are recomputed.
  jax's six policy factories (``save_only_these_names``, ...) are not
  policies: the reference fails on them at the first step, the port
  raises :class:`MXNetError` at bind. Any other name raises naming the
  valid ones.

The legacy ``MXNET_EXEC_ENABLE_REMAT=1`` means
``dots_with_no_batch_dims_saveable`` and loses to an explicit
``MXNET_TPU_REMAT``.

Where it applies (the executor): with a scan plan bound, each layer's
segment is wrapped (``ScanPlan.body_wrapper``); without one, the whole
forward. ``remat_applied`` counts each bind that wraps.

A recompute replays what the forward drew: :func:`Policy.wrap` takes the
key chain of :mod:`.random` (``current_key``) and the amp policy at the
block's entry and sets them again around the recompute, then restores
the thread's own, so a ``Dropout`` recomputes the mask it drew and the
chain ends where an unwrapped run leaves it. Aux states are committed by
the executor from the forward's outputs; a recompute's are discarded.
"""
from __future__ import annotations

import logging
import threading
from typing import Any, Optional, Tuple

from .base import MXNetError

__all__ = ["resolve_policy", "Policy", "POLICY_NAMES", "replaying",
           "set_current_op", "remat_knob_on"]

log = logging.getLogger(__name__)

# jax.checkpoint_policies' predicate names -> what the port's wrap saves
_SAVES = {
    "everything_saveable": "all",
    "nothing_saveable": "none",
    "dots_saveable": "dots",
    "checkpoint_dots": "dots",
    "dots_with_no_batch_dims_saveable": "dots_no_batch",
    "checkpoint_dots_with_no_batch_dims": "dots_no_batch",
}
POLICY_NAMES = tuple(sorted(_SAVES))
# jax.checkpoint_policies' factories: they take names or policies and
# return a policy, so as a knob value they are no policy at all
_FACTORIES = ("offload_dot_with_no_batch_dims",
              "save_and_offload_only_these_names",
              "save_any_names_but_these", "save_anything_except_these_names",
              "save_from_both_policies", "save_only_these_names")

# graph ops whose contractions jax lowers to dot_general, with and
# without batch dimensions
_DOT_OPS = {"dots": frozenset(("FullyConnected", "dot", "batch_dot")),
            "dots_no_batch": frozenset(("FullyConnected", "dot"))}

_local = threading.local()


def set_current_op(name: str) -> None:
    """Record the op of the graph node this thread runs now: the
    selective policies classify an aten contraction by it."""
    _local.op = name


def replaying() -> bool:
    """True while this thread recomputes a wrapped block."""
    return getattr(_local, "replaying", False)


def _contractions():
    import torch
    aten = torch.ops.aten
    return frozenset((aten.mm.default, aten.addmm.default, aten.bmm.default,
                      aten.baddbmm.default, aten.dot.default,
                      aten.mv.default, aten.addmv.default))


class Policy(object):
    """A resolved policy: ``name`` (jax's) and ``saves`` (``all``,
    ``none``, ``dots``, ``dots_no_batch``)."""

    def __init__(self, name: str):
        self.name = name
        self.saves = _SAVES[name]
        self._dots = None

    def saves_output(self, func) -> bool:
        """Whether the selective policy keeps the output of aten op
        ``func`` run by the current graph node."""
        if self.saves not in _DOT_OPS:
            return self.saves == "all"
        if self._dots is None:
            self._dots = _contractions()
        return func in self._dots and \
            getattr(_local, "op", None) in _DOT_OPS[self.saves]

    def _context_fn(self):
        from torch.utils.checkpoint import (
            CheckpointPolicy, create_selective_checkpoint_contexts)

        def policy_fn(ctx, func, *args, **kwargs):
            return CheckpointPolicy.MUST_SAVE if self.saves_output(func) \
                else CheckpointPolicy.PREFER_RECOMPUTE

        return create_selective_checkpoint_contexts(policy_fn)

    def wrap(self, fn):
        """``fn`` run under this policy's checkpoint: the forward saves
        only what the policy keeps, and the backward recomputes the rest
        with the key chain and amp policy the forward ran with."""
        if self.saves == "all":
            return fn

        def run(*args):
            import torch
            import torch.utils.checkpoint as ckpt
            from . import amp as _amp
            from . import random as _random
            if not torch.is_grad_enabled():
                return fn(*args)      # inference: nothing to recompute
            entry = (_random.current_key(), _amp.compute_dtype())
            state = {"ran": False}

            def inner(*a):
                if not state["ran"]:
                    state["ran"] = True
                    return fn(*a)
                own = (_random.current_key(), _amp.compute_dtype(),
                       replaying())
                _random.set_key(entry[0])
                _amp._COMPUTE_DTYPE = entry[1]
                _local.replaying = True
                try:
                    return fn(*a)
                finally:
                    _random.set_key(own[0])
                    _amp._COMPUTE_DTYPE = own[1]
                    _local.replaying = own[2]

            kw = {}
            if self.saves != "none":
                kw["context_fn"] = self._context_fn
            return ckpt.checkpoint(inner, *args, use_reentrant=False, **kw)

        return run


def _policy_by_name(name: str) -> Policy:
    if name in _FACTORIES:
        raise MXNetError(
            "MXNET_TPU_REMAT=%r names a jax.checkpoint_policies factory, "
            "which takes arguments and returns a policy; valid policies: "
            "%s (or off/auto)" % (name, ", ".join(POLICY_NAMES)))
    if name not in _SAVES:
        raise MXNetError(
            "MXNET_TPU_REMAT=%r is not a jax.checkpoint_policies name; "
            "valid policies: %s (or off/auto)"
            % (name, ", ".join(POLICY_NAMES)))
    return Policy(name)


def remat_knob_on() -> bool:
    from . import config as _config
    return _config.get("MXNET_TPU_REMAT") != "off" or \
        bool(_config.get("MXNET_EXEC_ENABLE_REMAT"))


def resolve_policy(symbol=None, input_shapes=None, input_dtypes=None
                   ) -> Tuple[Optional[Any], str]:
    """The active remat policy for a bind: ``(policy, name)``, ``policy``
    a :class:`Policy` (None = remat off). ``auto`` takes the analyzer's
    suggestion for ``symbol`` at the bound shapes and dtypes."""
    from . import config as _config
    mode = _config.get("MXNET_TPU_REMAT")
    if mode == "off":
        if _config.get("MXNET_EXEC_ENABLE_REMAT"):
            name = "dots_with_no_batch_dims_saveable"
            return _policy_by_name(name), name
        return None, "off"
    if mode != "auto":
        return _policy_by_name(mode), mode
    if symbol is None:
        return None, "off"
    from .analysis import analyze_symbol
    # only the policy's name is needed: no block calibration
    report = analyze_symbol(symbol, input_shapes=input_shapes,
                            input_dtypes=input_dtypes,
                            context="remat-auto", calibrate_remat=False)
    remat = report.extras.get("remat") or {}
    name = (remat.get("suggestion") or {}).get("policy")
    if not name:
        log.info("MXNET_TPU_REMAT=auto: remat-opportunity found nothing "
                 "worth rematerializing; running without checkpoint")
        return None, "off"
    return _policy_by_name(name), "auto:%s" % name
