"""Module — a bound Symbol with parameters and an optimizer.

The port's counterpart of the reference's ``module/module.py`` on one
device: ``bind``, ``init_params`` / ``set_params`` / ``get_params``,
``init_optimizer``, ``forward`` / ``backward`` / ``update`` /
``get_outputs``, and ``_fit_step``, the counterpart of the reference's
fused train step (``_build_fused_step``): one forward, one backward and
one ``torch._foreach_*`` update of every parameter per call, with no
host synchronisation inside, so the host queues the next step while the
card runs this one.

As in the reference, the backward runs with a ones head gradient on
every output, so a loss head's own backward (``SoftmaxOutput``) drives
training; ``rescale_grad`` is ``1 / batch_size``.

Aux states (BatchNorm's moving statistics) are bound beside the
arguments, initialised and set with them (``aux_params``), committed by
every training forward and returned by ``get_params``;
``save_checkpoint`` and ``Module.load`` write and read both, in the
reference's checkpoint files (:mod:`..model`), with the optimizer's
states in the reference's ``.states`` pickle when asked.

``_fit_step`` updates as the reference's fused step does: the update
count ``t`` is ``num_update + 1`` for every parameter and the learning
rate the scheduler's at ``t``; ``update`` (after ``forward`` and
``backward``) takes each parameter's own count, as the reference's
``Module.update`` does. ``_checkpoint_snapshot`` / ``_checkpoint_restore``
carry everything exact resume needs to and from :mod:`..checkpoint`.

Gradient accumulation (``set_grad_accum(n)``, ``fit(grad_accum=n)``):
``_fit_step`` splits the bound batch into ``n`` equal microbatches, runs
a forward and ``torch.autograd.grad`` per microbatch (aux states
advancing microbatch by microbatch, each drawing its own dropout masks),
sums the gradients into one buffer per parameter, rescales them as the
loss heads' normalization asks (:func:`_accum_loss_scale`) and makes one
update; the outputs are concatenated back to the full batch, so metrics
see every row. Only one microbatch's activations are alive at a time.
The remat policy (``MXNET_TPU_REMAT``) is the executor's: each
microbatch's forward runs under it.

The inference surface follows the reference's: ``data_shapes`` /
``label_shapes`` / ``output_shapes``, ``reshape`` (a new executor for
new input shapes holding this one's parameter, gradient and aux arrays
themselves), ``get_states`` / ``set_states`` over ``state_names``, and
``install_monitor``.

The module runs on ``cuda:0`` unless ``context`` says otherwise
(``context=cpu()`` for the host); without a GPU and without that request
it raises.
"""
from __future__ import annotations

import logging
import pickle
import threading
from typing import Dict, List, Optional

import numpy as np
import torch

from ..base import MXNetError
from ..checkpoint import manager as _ckpt_manager
from ..checkpoint.atomic import atomic_open
from ..checkpoint.format import CheckpointCorrupt, CheckpointError
from ..context import device_scope, resolve_device
from ..initializer import InitDesc
from ..io import DataDesc
from ..ndarray import NDArray
from .. import model as _model
from .. import optimizer as opt
from .. import profiler as _profiler
from .base_module import BaseModule, _check_input_names

__all__ = ["Module"]


def _accum_loss_scale(symbol, accum: int) -> float:
    """Gradient rescale that makes an N-microbatch accumulated step
    match the unaccumulated full-batch step (the reference's).

    ``normalization='null'`` heads (and plain outputs driven by ones
    head gradients) produce per-sample gradients: their sum over the N
    microbatches is the full-batch gradient, scale 1.
    ``normalization='batch'`` divides by the (micro)batch size, so the
    sum is N x the full-batch mean: scale 1/N. ``normalization='valid'``
    divides by a data-dependent count per microbatch, which no uniform
    rescale reproduces: it raises, as does a mix of batch-mean and
    per-sample heads."""
    kinds = set()
    for node, _ in symbol._entries:
        if node.is_variable:
            kinds.add("sample")
            continue
        norm = node.attrs.get("normalization")
        if norm == "valid":
            raise MXNetError(
                "grad_accum: %s head %r uses normalization='valid' "
                "(a per-batch valid count cannot be replayed per "
                "microbatch) — use 'batch' or 'null'"
                % (node.op.name, node.name))
        kinds.add("batch" if norm == "batch" else "sample")
    if kinds == {"batch"}:
        return 1.0 / accum
    if "batch" in kinds:
        raise MXNetError(
            "grad_accum: loss heads mix batch-mean and per-sample/sum "
            "normalization; the accumulated gradient cannot be rescaled "
            "consistently — align the heads' normalization")
    return 1.0


def _host_tensor(value) -> torch.Tensor:
    """A tensor view of an NDArray, a tensor, a numpy array or any array
    with ``asnumpy()``, wherever it lies (no copy for a host array)."""
    if isinstance(value, NDArray):
        return value.data
    if isinstance(value, torch.Tensor):
        return value
    arr = value.asnumpy() if hasattr(value, "asnumpy") else np.asarray(value)
    return torch.from_numpy(np.ascontiguousarray(arr))


def _as_tensor(value, like: torch.Tensor) -> torch.Tensor:
    """A tensor on ``like``'s device and dtype from any of the above."""
    return _host_tensor(value).to(like.device, like.dtype)


class _H2DStager:
    """The card's device-prefetch stage (``Module._device_placer``): a
    ring of pinned host buffers per bound input, one H2D copy stream,
    and per slot the event of the last copy out of it."""

    def __init__(self, device, like, data_names, label_names, slots):
        self.device = device
        self.data_names = list(data_names)
        self.label_names = list(label_names)
        self.like = like
        self.stream = torch.cuda.Stream(device)
        self.slots = [{"event": None, "host": {}}
                      for _ in range(max(2, slots))]
        self.next = 0
        self.lock = threading.Lock()

    def __call__(self, data_batch):
        arrs = list(data_batch.data or []) + list(data_batch.label or [])
        pairs = [(n, a) for n, a in zip(self.data_names + self.label_names,
                                        arrs) if n in self.like]
        with self.lock:
            slot = self.slots[self.next]
            self.next = (self.next + 1) % len(self.slots)
            if slot["event"] is not None:
                # the previous copy out of these buffers must be done
                # before the host overwrites them
                slot["event"].synchronize()
            placed = {}
            with torch.no_grad(), torch.cuda.device(self.device), \
                    torch.cuda.stream(self.stream):
                for name, arr in pairs:
                    like = self.like[name]
                    host = slot["host"].get(name)
                    if host is None:
                        host = torch.empty(like.shape, dtype=like.dtype,
                                           pin_memory=True)
                        slot["host"][name] = host
                    src = _host_tensor(arr)
                    if src.device.type == "cuda":
                        # already on the card: the step's own copy into
                        # the bound input casts it
                        placed[name] = src
                        continue
                    host.copy_(src.reshape(like.shape))
                    dev = torch.empty(like.shape, dtype=like.dtype,
                                      device=self.device)
                    dev.copy_(host, non_blocking=True)
                    placed[name] = dev
                event = torch.cuda.Event()
                event.record(self.stream)
            slot["event"] = event
        data_batch._mx_placed = placed
        data_batch._mx_ready = event
        return data_batch



class Module(BaseModule):
    """A Symbol bound on one device, with parameters and an optimizer."""

    def __init__(self, symbol, data_names=("data",),
                 label_names=("softmax_label",), logger=logging,
                 context=None, fixed_param_names=None, state_names=None):
        super().__init__(logger=logger)
        if isinstance(context, (list, tuple)):
            if len(context) != 1:
                raise MXNetError("this slice of the port binds one device; "
                                 "got %d contexts (data parallelism is "
                                 "ROADMAP.md queue A9)" % len(context))
            context = context[0]
        self._device = resolve_device(context)
        self._symbol = symbol
        data_names = list(data_names) if data_names is not None else []
        label_names = list(label_names) if label_names is not None else []
        state_names = list(state_names) if state_names is not None else []
        fixed = list(fixed_param_names) if fixed_param_names else []
        _check_input_names(symbol, data_names, "data", True)
        _check_input_names(symbol, label_names, "label", False)
        _check_input_names(symbol, state_names, "state", True)
        _check_input_names(symbol, fixed, "fixed_param", True)
        arg_names = symbol.list_arguments()
        inputs = data_names + label_names + state_names
        self._param_names = [n for n in arg_names if n not in inputs]
        self._aux_names = symbol.list_auxiliary_states()
        self._fixed_param_names = fixed
        self._data_names = data_names
        self._label_names = [n for n in label_names if n in arg_names]
        self._state_names = state_names
        self._output_names = symbol.list_outputs()
        self._arg_params: Optional[Dict[str, NDArray]] = None
        self._aux_params: Optional[Dict[str, NDArray]] = None
        self._optimizer = None
        self._updater = None
        self._exec = None
        self._data_shapes = None
        self._label_shapes = None
        self._grad_req = None
        self._param_index: Dict[str, int] = {}
        self._preload_opt_states = None
        self.inputs_need_grad = False
        self._grad_accum = 1
        self._accum_scale = 1.0
        self._remat_name = "off"
        self._nancheck_mode = "off"
        self._nan_flags = None

    # ------------------------------------------------------------ names
    @property
    def data_names(self):
        return self._data_names

    @property
    def label_names(self):
        return self._label_names

    @property
    def output_names(self):
        return self._output_names

    @property
    def data_shapes(self):
        assert self.binded
        return self._data_shapes

    @property
    def label_shapes(self):
        assert self.binded
        return self._label_shapes

    @property
    def output_shapes(self):
        """``[(name, shape)]`` of the outputs at the bound input shapes."""
        assert self.binded
        arg_names = self._symbol.list_arguments()
        shapes = {d.name: d.shape for d in self._data_shapes +
                  self._label_shapes if d.name in arg_names}
        _, out_shapes, _ = self._symbol.infer_shape(**shapes)
        return list(zip(self._output_names, [tuple(s) for s in out_shapes]))

    # ------------------------------------------------------------ loading
    @staticmethod
    def load(prefix, epoch, load_optimizer_states=False, **kwargs):
        """A Module over a checkpoint's symbol whose ``bind`` takes the
        checkpoint's arg and aux params (``prefix-symbol.json``,
        ``prefix-%04d.params``, as :func:`model.save_checkpoint`
        writes them, here or in the reference). ``kwargs`` go to
        ``Module``; the arrays wait on the host until ``bind`` copies
        them to the module's device. With ``load_optimizer_states``,
        ``init_optimizer`` loads ``prefix-%04d.states``."""
        with device_scope("cpu"):
            sym, args, auxs = _model.load_checkpoint(prefix, epoch)
        mod = Module(symbol=sym, **kwargs)
        mod._arg_params, mod._aux_params = args, auxs
        mod.params_initialized = True
        if load_optimizer_states:
            mod._preload_opt_states = "%s-%04d.states" % (prefix, epoch)
        return mod

    def save_checkpoint(self, prefix, epoch, save_optimizer_states=False):
        """Write the symbol and the arg and aux params as
        :func:`model.save_checkpoint` does, and with
        ``save_optimizer_states`` the optimizer's states to
        ``prefix-%04d.states``."""
        _model.save_checkpoint(prefix, epoch, self.symbol,
                               *self.get_params())
        if save_optimizer_states:
            self.save_optimizer_states("%s-%04d.states" % (prefix, epoch))

    # ------------------------------------------------------------ params
    def get_params(self):
        """``(arg_params, aux_params)``: the bound parameter and aux-state
        arrays by name."""
        assert self.binded and self.params_initialized
        return dict(self._arg_params), dict(self._aux_params)

    def init_params(self, initializer=None, arg_params=None, aux_params=None,
                    allow_missing=False, force_init=False, allow_extra=False):
        """Fill every parameter from ``arg_params`` and every aux state
        from ``aux_params`` (by name) or, failing that, from
        ``initializer``. Names the module does not have are ignored, as
        the reference ignores them (a checkpoint's old head, when a
        fine-tune cut the net)."""
        assert self.binded, "call bind before initializing the parameters"
        if self.params_initialized and not force_init:
            return
        attrs = self.symbol.attr_dict()

        def fill(names, arrays, given):
            for name in names:
                arr = arrays[name]
                if given is not None and name in given:
                    src = given[name]
                    if tuple(src.shape) != arr.shape:
                        raise MXNetError("shape mismatch for %s: %s vs %s"
                                         % (name, tuple(src.shape),
                                            arr.shape))
                    with torch.no_grad():
                        arr.data.copy_(_as_tensor(src, arr.data))
                elif given is not None and not allow_missing:
                    raise RuntimeError("%s is not presented" % name)
                elif initializer is not None:
                    initializer(InitDesc(name, attrs.get(name, None)), arr)

        fill(self._param_names, self._exec.arg_dict, arg_params)
        fill(self._aux_names, self._exec.aux_dict, aux_params)
        self._arg_params = {n: self._exec.arg_dict[n]
                            for n in self._param_names}
        self._aux_params = {n: self._exec.aux_dict[n]
                            for n in self._aux_names}
        self.params_initialized = True

    # ------------------------------------------------------------ bind
    def bind(self, data_shapes, label_shapes=None, for_training=True,
             inputs_need_grad=False, force_rebind=False, shared_module=None,
             grad_req="write"):
        """Infer every shape from the input shapes and allocate the
        arguments and gradient buffers on the module's device.

        ``inputs_need_grad`` gives the data inputs gradient buffers
        (``get_input_grads``). With ``shared_module`` (a bound module
        with initialized parameters on the same device, as
        ``BucketingModule`` binds each bucket against its default one),
        this module holds that module's parameter, gradient and aux
        arrays themselves, not copies: an update through either is seen
        by both. A parameter it lacks or holds at another shape
        raises."""
        if force_rebind:
            self._exec = None
            self.binded = False
        if self.binded:
            self.logger.warning("Already bound, ignoring bind()")
            return
        shared_exec = None
        if shared_module is not None:
            if not (shared_module.binded and
                    shared_module.params_initialized):
                raise MXNetError("shared_module must be bound and have its "
                                 "parameters initialized")
            if shared_module._device != self._device:
                raise MXNetError("shared_module is on %s, this module on %s: "
                                 "arrays are shared on one device only"
                                 % (shared_module._device, self._device))
            shared_exec = shared_module._exec
        self.for_training = for_training
        self.inputs_need_grad = inputs_need_grad
        self._data_shapes = [x if isinstance(x, DataDesc) else DataDesc(*x)
                             for x in data_shapes]
        self._label_shapes = [x if isinstance(x, DataDesc) else DataDesc(*x)
                              for x in label_shapes] if label_shapes else []
        arg_names = self._symbol.list_arguments()
        shape_hints = {d.name: d.shape for d in self._data_shapes}
        shape_hints.update({d.name: d.shape for d in self._label_shapes
                            if d.name in arg_names})
        req = {}
        for n in arg_names:
            if n in self._data_names:
                req[n] = "write" if inputs_need_grad else "null"
            elif n in self._label_names or n in self._state_names or \
                    n in self._fixed_param_names:
                req[n] = "null"
            else:
                req[n] = grad_req if for_training else "null"
        self._grad_req = req
        type_dict = {d.name: d.dtype for d in self._data_shapes +
                     self._label_shapes}
        params = (self._arg_params, self._aux_params) \
            if self.params_initialized else None
        self._exec = self._symbol.simple_bind(
            self._device, grad_req=req, type_dict=type_dict,
            shared_arg_names=self._param_names, shared_exec=shared_exec,
            **shape_hints)
        self.binded = True
        if shared_exec is not None:
            self._arg_params = {n: self._exec.arg_dict[n]
                                for n in self._param_names}
            self._aux_params = {n: self._exec.aux_dict[n]
                                for n in self._aux_names}
            self.params_initialized = True
        elif params is not None:
            self.init_params(arg_params=params[0], aux_params=params[1],
                             force_init=True)

    def reshape(self, data_shapes, label_shapes=None):
        """Bind the graph anew at other input shapes: the new executor
        holds this one's parameter, gradient and aux arrays themselves
        (they keep their shapes); inputs are allocated at the new
        ones."""
        assert self.binded
        self._data_shapes = [x if isinstance(x, DataDesc) else DataDesc(*x)
                             for x in data_shapes]
        if label_shapes is not None:
            self._label_shapes = [x if isinstance(x, DataDesc)
                                  else DataDesc(*x) for x in label_shapes]
        arg_names = self._symbol.list_arguments()
        shapes = {d.name: d.shape for d in self._data_shapes}
        shapes.update({d.name: d.shape for d in self._label_shapes
                       if d.name in arg_names})
        type_dict = {d.name: d.dtype for d in self._data_shapes +
                     self._label_shapes}
        old = self._exec
        self._exec = self._symbol.simple_bind(
            self._device, grad_req=self._grad_req, type_dict=type_dict,
            shared_arg_names=self._param_names, shared_exec=old, **shapes)
        self._exec.keep_node_outputs = old.keep_node_outputs
        self._exec.set_monitor_callback(old._monitor_callback)

    def install_monitor(self, mon):
        """Attach ``mon`` (:class:`..monitor.Monitor`) to the executor."""
        assert self.binded
        mon.install(self._exec)

    # ------------------------------------------------------------ optimizer
    def init_optimizer(self, kvstore="local", optimizer="sgd",
                       optimizer_params=(("learning_rate", 0.01),),
                       force_init=False):
        """Create the optimizer; ``rescale_grad`` defaults to
        ``1 / batch_size``. ``kvstore`` may be ``"local"``, ``"device"``
        or None on one device."""
        assert self.binded and self.params_initialized
        if self.optimizer_initialized and not force_init:
            self.logger.warning("optimizer already initialized, "
                                "ignoring...")
            return
        if kvstore not in ("local", "device", None):
            raise MXNetError("kvstore %r is not ported yet (ROADMAP.md queue "
                             "A9); on one device use 'local', 'device' or "
                             "None" % (kvstore,))
        batch_sizes = {d.shape[0] for d in self._data_shapes if d.shape}
        if len(batch_sizes) > 1:
            raise MXNetError("data inputs disagree on batch size: %s"
                             % [(d.name, d.shape) for d in self._data_shapes])
        batch_size = batch_sizes.pop() if batch_sizes else 1
        rescale_grad = 1.0 / batch_size
        if isinstance(optimizer, str):
            optimizer_params = dict(optimizer_params)
            optimizer_params.setdefault("rescale_grad", rescale_grad)
            optimizer = opt.create(
                optimizer, sym=self.symbol,
                param_idx2name=dict(enumerate(self._param_names)),
                **optimizer_params)
        elif optimizer.rescale_grad != rescale_grad:
            self.logger.warning(
                "Optimizer created manually outside Module but rescale_grad "
                "is not normalized to 1.0/batch_size (%s vs. %s).",
                optimizer.rescale_grad, rescale_grad)
        optimizer.set_lr_mult({})
        optimizer.set_wd_mult({})
        self._optimizer = optimizer
        self._updater = opt.get_updater(optimizer)
        self._param_index = {n: i for i, n in enumerate(self._param_names)}
        self.optimizer_initialized = True
        if self._preload_opt_states is not None:
            self.load_optimizer_states(self._preload_opt_states)
            self._preload_opt_states = None
        self._build_fused_step()

    def _build_fused_step(self) -> None:
        """What the reference settles when it builds its fused step: the
        gradient-accumulation split (N must divide every batch
        dimension) and its loss rescale, the ``grad_accum`` gauge, the
        remat policy's name (the executor's), and, with a scan plan and
        ``MXNET_TPU_GROUP_UPDATE``, the per-layer parameter families
        that update as one group (``fused_update_grouped``,
        ``fused_update_groups``): every member trained, one
        (lr_mult, wd_mult). ``Updater.update_multi`` already runs each
        group of equal (lr, wd, count) as one ``torch._foreach_*``
        sequence, equal to the per-parameter update, so the families
        change no arithmetic."""
        from .. import config as _config
        self._nancheck_mode = _config.get("MXNET_TPU_NANCHECK")
        self._nan_flags = None
        accum = self._grad_accum
        self._accum_scale = 1.0
        if accum > 1:
            for d in (self._data_shapes or []) + (self._label_shapes or []):
                if d.shape and d.shape[0] % accum:
                    raise MXNetError(
                        "grad_accum=%d does not divide the %r batch "
                        "dimension %d" % (accum, d.name, d.shape[0]))
            self._accum_scale = _accum_loss_scale(self._symbol, accum)
            _profiler.set_gauge("grad_accum", accum)
        self._remat_name = self._exec._remat_name
        plan = self._exec._scan_plan
        if plan is None or not _config.get("MXNET_TPU_GROUP_UPDATE"):
            return
        trained = set(self._trained_names())
        o, idx = self._optimizer, self._param_index
        groups = 0
        for names in plan.var_lists.values():
            if len(names) < 2 or any(n not in trained for n in names):
                continue
            mults = {(o._resolve_mult(o.lr_mult, idx[n]),
                      o._resolve_mult(o.wd_mult, idx[n])) for n in names}
            groups += len(mults) == 1
        if groups:
            _profiler.incr_counter("fused_update_grouped")
            _profiler.set_gauge("fused_update_groups", groups)

    def _check_accum_needs_fused(self) -> None:
        if self._grad_accum > 1:
            raise MXNetError(
                "grad_accum > 1 requires the fused train step; this "
                "binding falls back to eager update (kvstore/custom "
                "updater) which cannot microbatch")

    def set_grad_accum(self, n: int) -> None:
        """Microbatch gradient accumulation: ``_fit_step`` splits every
        bound batch into ``n`` equal microbatches, so activation memory
        scales with the microbatch while the optimizer sees the
        full-batch gradient (``fit(grad_accum=n)`` routes here). ``n=1``
        restores the plain step."""
        n = int(n)
        if n < 1:
            raise MXNetError("grad_accum must be >= 1, got %d" % n)
        if n != self._grad_accum:
            self._grad_accum = n
            if self.optimizer_initialized:
                self._build_fused_step()

    def borrow_optimizer(self, shared_module):
        """Take ``shared_module``'s optimizer and updater, its state
        included, keyed by parameter name (``BucketingModule``)."""
        assert shared_module.optimizer_initialized
        missing = [n for n in self._param_names
                   if n not in shared_module._param_index]
        if missing:
            raise MXNetError("borrow_optimizer: the shared module does not "
                             "train %s" % missing)
        self._optimizer = shared_module._optimizer
        self._updater = shared_module._updater
        self._param_index = shared_module._param_index
        self.optimizer_initialized = True

    # ------------------------------------------------------------ compute
    def _load_batch(self, data_batch):
        """Copy the batch's data and labels into the bound inputs (cast
        to their dtype, onto the module's device). A batch the
        device-prefetch stage placed (``_mx_placed``, see
        :meth:`_device_placer`) is already on the device: the compute
        stream waits on its copy's event and copies it device to device
        into the bound input, which the step then reads."""
        ex = self._exec
        pairs = list(zip(self._data_names, data_batch.data or [])) + \
            list(zip(self._label_names, data_batch.label or []))
        placed = getattr(data_batch, "_mx_placed", None)
        ready = getattr(data_batch, "_mx_ready", None)
        with torch.no_grad():
            if ready is not None:
                stream = torch.cuda.current_stream(self._device)
                stream.wait_event(ready)
            for name, arr in pairs:
                dst = ex.arg_dict[name].data
                if placed is not None and name in placed:
                    src = placed[name]
                    if ready is not None:
                        # made on the copy stream, read on this one: the
                        # allocator must not hand its memory out again
                        # before this stream has read it
                        src.record_stream(stream)
                    dst.copy_(src)
                else:
                    dst.copy_(_as_tensor(arr, dst), non_blocking=True)

    # ----------------------------------------------------------- async loop
    def _async_capable(self) -> bool:
        """True when ``fit`` may run the async loop: bound, with an
        optimizer, so ``_fit_step`` is the step. (The reference also
        refuses programs with host callbacks, which deadlock its
        dispatch; a CustomOp's host code here only makes the host wait
        for the card.)"""
        return self._exec is not None and self.optimizer_initialized

    def _step_token(self):
        """The completion token of the step just queued, for
        :class:`.._fused.InflightWindow`: a CUDA event recorded on the
        compute stream after it; None on the CPU, where a step has
        finished when it returns."""
        if self._device.type != "cuda":
            return None
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(self._device))
        return event

    def _device_placer(self):
        """The device-prefetch stage's callable, which ``fit`` attaches
        to a ``PrefetchingIter`` (run in its worker thread) or to a
        loader with ``_mx_set_device_placer``: it puts the batch's data
        and labels on the device ahead of the step that reads them, as
        ``batch._mx_placed`` (name -> tensor of the bound input's dtype)
        and, on the card, ``batch._mx_ready`` (the copy's event).

        On the card each batch goes through a ring of pinned staging
        buffers to an H2D copy on a dedicated stream: a host array is
        cast into the slot's pinned buffer, copied to a new device tensor
        without blocking the host, and an event recorded after the copy.
        A slot is written again only after its previous copy's event has
        completed. On the CPU the placed tensors are host copies."""
        if self._exec is None:
            return None
        ex = self._exec
        names = [n for n in self._data_names + self._label_names
                 if n in ex.arg_dict]
        like = {n: ex.arg_dict[n].data for n in names}
        device = self._device
        if device.type != "cuda":
            def place_host(data_batch):
                arrs = list(data_batch.data or []) + \
                    list(data_batch.label or [])
                pairs = zip(self._data_names + self._label_names, arrs)
                data_batch._mx_placed = {
                    n: _as_tensor(a, like[n]).clone()
                    for n, a in pairs if n in like}
                return data_batch
            return place_host
        from .. import config as _config
        return _H2DStager(device, like, self._data_names, self._label_names,
                          slots=int(_config.get("MXNET_TPU_DEVICE_PREFETCH"))
                          + 1)

    def _update_metric_device(self, eval_metric, labels) -> bool:
        """The metric update of the async loop: the metric sums on the
        device from the bound labels (the batch just loaded) and the
        step's outputs, with no host read. False when the metric cannot
        (``CustomMetric``, ``F1``, ``PearsonCorrelation``, or
        ``MXNET_TPU_DEVICE_METRICS=0``): the caller runs
        :meth:`update_metric` and counts the host sync."""
        if not eval_metric.device_capable():
            return False
        ex = self._exec
        label_names = self._label_names or \
            [d.name for d in self._label_shapes]
        label_dict = {}
        for name, arr in zip(label_names, labels or []):
            bound = ex.arg_dict.get(name)
            label_dict[name] = bound.data if bound is not None else arr
        preds = dict(zip(self._output_names, self.get_outputs()))
        return eval_metric.update_dict_device(label_dict, preds)

    def forward(self, data_batch, is_train=None):
        assert self.binded and self.params_initialized
        if is_train is None:
            is_train = self.for_training
        self._load_batch(data_batch)
        self._exec.forward(is_train=is_train)

    def backward(self, out_grads=None):
        assert self.binded and self.params_initialized
        self._exec.backward(out_grads=out_grads)

    def _trained_names(self) -> List[str]:
        return [n for n in self._param_names
                if self._grad_req.get(n, "null") != "null"]

    def _apply_update(self, names, grads, fit_step=False) -> None:
        """One grouped optimizer update of the parameters ``names``: with
        ``fit_step`` every parameter takes the step's count and rate,
        otherwise each its own count."""
        idx = self._param_index
        kw = {}
        if fit_step:
            opt = self._optimizer
            t = opt.num_update + 1
            kw = {"t": t, "lr": opt.lr_scheduler(t)
                  if opt.lr_scheduler is not None else opt.lr}
        self._updater.update_multi([idx[n] for n in names],
                                   [self._exec.arg_dict[n] for n in names],
                                   grads, **kw)

    def update(self):
        """Apply the gradients in ``grad_dict`` with one fused update."""
        assert self.binded and self.params_initialized \
            and self.optimizer_initialized
        names = self._trained_names()
        self._apply_update(names, [self._exec.grad_dict[n] for n in names])

    def _fit_step(self, data_batch):
        """One training step: forward, backward with ones head
        gradients, and one fused update of every trained parameter
        straight from the gradients (``grad_dict`` is not written); with
        ``set_grad_accum(n)``, n microbatches summed into one update."""
        assert self.binded and self.params_initialized \
            and self.optimizer_initialized
        self._load_batch(data_batch)
        if self._grad_accum > 1:
            names, grads = self._accum_gradients()
        else:
            self._exec.forward(is_train=True)
            names, grads = self._exec.gradients()
            if self.inputs_need_grad:
                with torch.no_grad():
                    for n, g in zip(names, grads):
                        if n in self._data_names:
                            self._exec.grad_dict[n].data.copy_(g)
        params = [(n, g) for n, g in zip(names, grads)
                  if n not in self._data_names]
        self._apply_update([n for n, _ in params], [g for _, g in params],
                           fit_step=True)
        if self._nancheck_mode != "off":
            self._nancheck_accumulate(self._exec.outputs)

    # ------------------------------------------------- non-finite guard
    def _nancheck_accumulate(self, outs) -> None:
        """Per floating output, an "ever went non-finite" flag kept on
        the device and or-ed with this step's outputs (no host read; the
        reference's ``MXNET_TPU_NANCHECK`` guard)."""
        with torch.no_grad():
            hits = [None if not o.data.is_floating_point() else
                    ~torch.isfinite(o.data).all() for o in outs]
            if self._nan_flags is None:
                self._nan_flags = hits
            else:
                self._nan_flags = [
                    h if f is None else f if h is None else f | h
                    for f, h in zip(self._nan_flags, hits)]

    def _nancheck_poll(self) -> Optional[str]:
        """The epoch boundary's one host read of the flags: the name of
        the first output that went non-finite, or None; the flags start
        over for the next epoch."""
        flags, self._nan_flags = self._nan_flags, None
        if flags is None:
            return None
        for i, f in enumerate(flags):
            if f is not None and bool(f):
                names = self._output_names or []
                return names[i] if i < len(names) else "output%d" % i
        return None

    def _accum_gradients(self):
        """The accumulated step's gradients: a forward and a backward
        per equal microbatch of the bound inputs (aux states committed by
        each forward in turn), the first microbatch's gradients the
        buffers the later ones are added into in place, in microbatch
        order, rescaled once; the executor's outputs are set to the
        microbatches' concatenated."""
        ex, n = self._exec, self._grad_accum
        inputs = {name: ex.arg_dict[name].data
                  for name in self._data_names + self._label_names}
        acc, parts = None, []
        for i in range(n):
            micro = {name: t.chunk(n)[i] for name, t in inputs.items()}
            parts.append(ex.forward_inputs(True, micro))
            if acc is None:
                names, grads = ex.gradients()
                # owned buffers: a gradient may come back as a view
                acc = [g if g._base is None and g.is_contiguous()
                       else g.clone(memory_format=torch.contiguous_format)
                       for g in grads]
                del grads
            else:
                # summed in place as each gradient is made
                names, acc = ex.gradients(into=acc)
        if self._accum_scale != 1.0:
            torch._foreach_mul_(acc, self._accum_scale)
        if self.inputs_need_grad:
            with torch.no_grad():
                for name, g in zip(names, acc):
                    if name in self._data_names:
                        ex.grad_dict[name].data.copy_(g)
        ex._outputs = [NDArray(torch.cat([p[k].data for p in parts])
                               if parts[0][k].data.dim() else
                               torch.stack([p[k].data for p in parts]))
                       for k in range(len(parts[0]))]
        _profiler.incr_counter("accum_steps", n)
        return names, acc

    def get_outputs(self, merge_multi_context=True) -> List[NDArray]:
        assert self.binded and self.params_initialized
        return self._exec.outputs

    def get_input_grads(self, merge_multi_context=True) -> List[NDArray]:
        """The gradients of the data inputs (bound with
        ``inputs_need_grad``)."""
        assert self.binded and self.params_initialized \
            and self.inputs_need_grad
        return [self._exec.grad_dict[n] for n in self._data_names]

    def get_states(self, merge_multi_context=True) -> List[NDArray]:
        """The arrays of the state inputs (``state_names``)."""
        assert self.binded and self.params_initialized
        return [self._exec.arg_dict[n] for n in self._state_names]

    def set_states(self, states=None, value=None):
        """Set the state inputs from ``states`` (arrays, in
        ``state_names`` order), or fill each with ``value``."""
        assert self.binded and self.params_initialized
        with torch.no_grad():
            if states is not None:
                for name, val in zip(self._state_names, states):
                    dst = self._exec.arg_dict[name].data
                    dst.copy_(_as_tensor(val, dst))
            else:
                for name in self._state_names:
                    self._exec.arg_dict[name].data.fill_(value)

    def update_metric(self, eval_metric, labels):
        labels = dict(zip(self._label_names or
                          [d.name for d in self._label_shapes], labels))
        preds = dict(zip(self._output_names, self.get_outputs()))
        eval_metric.update_dict(labels, preds)

    # ------------------------------------------------------------ states
    def _named_states(self) -> Dict[str, object]:
        """The optimizer state of every trained parameter by name (made
        now for a parameter not updated yet), on its device."""
        idx = self._param_index
        return {n: self._updater._state(idx[n], self._exec.arg_dict[n])
                for n in self._trained_names()}

    def save_optimizer_states(self, fname):
        """The reference's fused ``.states`` pickle: ``{"fused": {name:
        state as numpy}, "num_update": n}``, written atomically."""
        assert self.optimizer_initialized
        states = {n: opt.state_to_numpy(s)
                  for n, s in self._named_states().items()}
        with atomic_open(fname, "wb") as fout:
            pickle.dump({"fused": states,
                         "num_update": int(self._optimizer.num_update)},
                        fout)

    def load_optimizer_states(self, fname):
        """Load a ``.states`` file of either package: the fused form by
        parameter name (with the update count), or an Updater's pickle
        by parameter index."""
        assert self.optimizer_initialized
        with open(fname, "rb") as fin:
            blob = fin.read()
        payload = opt.load_states_pickle(blob)
        if isinstance(payload, dict) and "fused" in payload:
            unknown = sorted(set(payload["fused"]) - set(self._param_index))
            if unknown:
                raise MXNetError("%s holds states of parameters this module "
                                 "does not have: %s" % (fname, unknown))
            for n, s in payload["fused"].items():
                self._updater.states[self._param_index[n]] = \
                    opt.state_from_numpy(s)
            self._optimizer.num_update = int(payload["num_update"])
        else:
            self._updater.set_states(blob)
        self._named_states()

    # ------------------------------------------------------- checkpoints
    def _checkpoint_snapshot(self):
        """``(tensors, meta)`` of everything exact resume needs, for
        :mod:`..checkpoint`: the parameters and aux states, the
        optimizer's states by parameter name with ``num_update`` (the
        reference's ``"fused"`` kind, which its fused ``Module``
        restores; the per-index update counts ride along), the key chain
        of :mod:`..random` (``rng:global_key``), and torch's own
        generators (``rng:torch:cpu``, ``rng:torch:cuda:<i>``), which the
        reference ignores. Every tensor is cloned on its device, so the
        next step may update the originals in place while the writer
        copies the clones. The caller is at a step boundary."""
        assert self.binded and self.params_initialized
        from .. import random as _random
        ex = self._exec

        def grab(v):
            return (v.data if isinstance(v, NDArray) else v).detach().clone()

        tensors = {}
        for n in self._param_names:
            tensors["arg:" + n] = grab(ex.arg_dict[n])
        for n in self._aux_names:
            tensors["aux:" + n] = grab(ex.aux_dict[n])
        meta = {"param_names": list(self._param_names),
                "aux_names": list(self._aux_names), "world_size": 1}
        step = 0
        if self.optimizer_initialized:
            o = self._optimizer
            step = int(o.num_update)
            meta["optimizer"] = {
                "kind": "fused", "num_update": step,
                "structure": {n: _ckpt_manager.tree_encode(
                    "opt:%s" % n, s, tensors, grab)
                    for n, s in self._named_states().items()},
                "index_update_count": {str(k): int(v) for k, v in
                                       o._index_update_count.items()}}
        meta["step"] = step
        tensors["rng:global_key"] = _ckpt_manager.key_to_array(
            _random.current_key())
        tensors["rng:torch:cpu"] = torch.get_rng_state()
        if torch.cuda.is_initialized():
            for i in range(torch.cuda.device_count()):
                tensors["rng:torch:cuda:%d" % i] = torch.cuda.get_rng_state(i)
        return tensors, meta

    def _checkpoint_restore(self, ckpt):
        """Put a :class:`..checkpoint.Checkpoint`'s optimizer states,
        update counts and torch generators into this bound module with
        its optimizer (``fit`` restores the parameters through
        ``init_params`` and the key chain itself). Reads the reference's
        ``"fused"`` (by name) and ``"updater"`` (by index) kinds."""
        assert self.binded and self.params_initialized \
            and self.optimizer_initialized
        tensors = ckpt.tensors

        def leaf(x):
            return NDArray(x.clone() if isinstance(x, torch.Tensor)
                           else torch.from_numpy(np.array(x)))

        opt_meta = ckpt.meta.get("optimizer") or {}
        kind = opt_meta.get("kind")
        if kind == "fused":
            structure = opt_meta["structure"]
            if set(structure) != set(self._trained_names()):
                raise CheckpointCorrupt(
                    "%s: optimizer states of %s do not match the module's "
                    "trained parameters %s" % (ckpt.path, sorted(structure),
                                               sorted(self._trained_names())))
            states = {self._param_index[n]: _ckpt_manager.tree_decode(
                "opt:%s" % n, s, tensors, leaf)
                for n, s in structure.items()}
        elif kind == "updater":
            states = {int(k) if k.lstrip("-").isdigit() else k:
                      _ckpt_manager.tree_decode("upd:%s" % k, s, tensors, leaf)
                      for k, s in opt_meta["structure"].items()}
        elif kind is not None:
            raise CheckpointError(
                "%s holds optimizer states of kind %r, which a module on "
                "one device does not have (ROADMAP.md queue A9)"
                % (ckpt.path, kind))
        if kind is not None:
            self._updater.states = states
            self._optimizer.num_update = int(opt_meta["num_update"])
            self._optimizer._index_update_count.update(
                {int(k): int(v) for k, v in
                 (opt_meta.get("index_update_count") or {}).items()})
            self._named_states()
        if "rng:torch:cpu" in tensors:
            torch.set_rng_state(torch.as_tensor(tensors["rng:torch:cpu"]))
        if torch.cuda.is_available():
            for i in range(torch.cuda.device_count()):
                state = tensors.get("rng:torch:cuda:%d" % i)
                if state is not None:
                    torch.cuda.set_rng_state(torch.as_tensor(state), i)
