"""The structure-keyed runner cache, its failure classifier, the
in-flight window of ``fit``'s async loop, and the compiled whole-model
optimizer update.

The port's copy of the reference package's ``_fused.py``.

:class:`CompileCache` maps a signature to a runner and counts
``<name>_compile`` (a runner built and stored), ``<name>_cache_hit``
(one reused), ``<name>_compile_failed`` and ``<name>_neg_hit``, with
bounded-retry negative caching. The serving path stores its bound
per-bucket runners there, so "the runner set is bounded by |prompt
buckets| + |decode buckets|" stays a counter assertion.

:class:`FusedUpdater` is the reference's fused trainer step:
``gluon.Trainer.step``, ``Module.update`` and the update of
``Module._fit_step`` run every parameter's update as ONE
``torch.compile``d program (``Optimizer.update_fused``), one program per
structure signature (optimizer class and static attributes, each
parameter's index, shapes, dtypes, device, state structure and
multipliers). The per-step hyperparameters (each parameter's base rate,
``wd``, ``rescale_grad``, an active clipping threshold, the update
counts) reach the program as one float64 vector, an input, so a new
rate, decay, batch size or threshold never recompiles; a new shape, or
clipping switched on or off, is a new signature and a new program.

What the compiler would otherwise do quietly is made loud: the program
traces with ``fullgraph=True`` (a graph break fails the build), every
backend compile is counted (``trainer_step_recompile`` and
``loop_recompile`` count those after an updater's first), and hitting
dynamo's recompile limit raises rather than running the frame eagerly.
Every path that leaves the program to the eager grouped update
(``Updater.update_multi``) counts ``trainer_step_fallback`` and
``trainer_step_fallback_<why>``: the knob off, a swapped updater, an
optimizer that opts out (SGLD), unhashable statics, a negative-cached
signature, a failed build or call.

:class:`StepProgram` is the compiled forward of ``Module._fit_step``
(whose backward AOT autograd builds in the same capture), one per
structure signature in the process-wide :data:`STEP_CACHE`
(``fused_step_compile`` / ``_cache_hit`` / ``_recompile``, and
``fused_step_fallback_<why>`` for each step that runs eagerly).

The program is inductor's on the card and ``aot_eager``'s on the CPU
(:data:`CPU_BACKEND`): the same capture, guards and recompiles without
the code generation, whose C++ builds would add minutes to the CPU test
suite. The weights and states update in place, so each ``NDArray`` and
each state object keeps its identity and its tensor's version counter
moves; a state leaf that shares memory with a weight or another leaf is
copied first (:func:`_dealias_states`), because a compiled program must
not mutate aliased inputs.
"""
from __future__ import annotations

import itertools
import re
import sys
import time
import types
import weakref
from typing import Any, Dict, List, Optional, Tuple

import torch

from . import lockcheck as _lockcheck
from . import profiler as _profiler

__all__ = ["CompileCache", "InflightWindow", "Uncacheable",
           "structural_failure", "op_identity", "fn_token", "static_key",
           "aval_key", "FusedUpdater", "CPU_BACKEND", "STEP_CACHE",
           "StepProgram", "step_fallback", "torch_version"]

_MAX_TRANSIENT_RETRIES = 3


class Uncacheable(Exception):
    """The structure cannot use a cached fast path; the caller must fall
    back to eager execution."""


# torch's wording for an operand geometry the model cannot take
_SHAPE_ERROR = re.compile(
    r"size of tensor|must match the size|cannot be multiplied|"
    r"is invalid for input of size|not broadcastable|shape mismatch|"
    r"shapes? .* (?:cannot|invalid|mismatch)|"
    r"[Ee]xpected .*(?:size|shape|dimension|channels)")


def _chain(exc: BaseException):
    """``exc`` and every exception it was raised from or during."""
    seen = set()
    while exc is not None and id(exc) not in seen:
        seen.add(id(exc))
        yield exc
        exc = exc.__cause__ or exc.__context__


def _is_uncacheable(exc: BaseException) -> bool:
    """True when ``exc`` is, or was raised from or during, an
    :class:`Uncacheable`."""
    return any(isinstance(e, Uncacheable) for e in _chain(exc))


def structural_failure(exc: BaseException) -> bool:
    """Classify a failed first dispatch of one bucket geometry.

    The reference calls a jax tracer error permanent (the function
    cannot be traced at all) and everything else transient, retried up
    to ``_MAX_TRANSIENT_RETRIES`` times. PyTorch traces nothing, so the
    permanent failures here are the ones that no retry of the same
    geometry can mend: :class:`Uncacheable` anywhere in the exception's
    chain, or a ``RuntimeError`` in which torch rejects an operand's
    shape (the model cannot take this padded geometry). Everything else
    is transient: among them ``torch.cuda.OutOfMemoryError``, which the
    allocator may satisfy on the next attempt. A compiled update adds
    dynamo's capture errors (a graph break under ``fullgraph``) to the
    permanent ones."""
    for e in _chain(exc):
        if isinstance(e, Uncacheable):
            return True
    dynamo = sys.modules.get("torch._dynamo.exc")
    if dynamo is not None and isinstance(exc, (dynamo.Unsupported,
                                               dynamo.UserError)):
        # torch.compile cannot capture the function (a graph break
        # under fullgraph): no retry captures it either
        return True
    if isinstance(exc, torch.cuda.OutOfMemoryError):
        return False
    return isinstance(exc, RuntimeError) and \
        _SHAPE_ERROR.search(str(exc)) is not None


class InflightWindow:
    """Bounded in-flight steps for the async fit loop.

    PyTorch queues CUDA work asynchronously: the host can run ahead of
    the card by any number of steps. The window holds one completion
    token per queued step (a ``torch.cuda.Event`` recorded after it, see
    ``Module._step_token``); pushing past ``depth`` waits on the OLDEST
    event, so at most ``depth`` steps are queued ahead of the card while
    its queue stays full (waiting on step ``i - K`` is flow control, not
    a pipeline break: ``K`` steps stay queued behind it). On the CPU a
    step's token is ``None`` and the window holds nothing; ``depth`` 0
    holds nothing either, which is the synchronous loop.
    """

    def __init__(self, depth: int):
        self.depth = int(depth)
        self._fifo: List[Any] = []

    def push(self, token) -> None:
        if token is None or self.depth <= 0:
            return
        self._fifo.append(token)
        if len(self._fifo) > self.depth:
            _profiler.incr_counter("loop_window_wait")
            with _profiler.span("inflight_retire", "step"):
                self._fifo.pop(0).synchronize()

    def drain(self) -> None:
        """Epoch and checkpoint barrier: wait out every queued step."""
        if self._fifo:
            _profiler.incr_counter("loop_window_drain")
            with _profiler.span("inflight_drain", "step"):
                self._fifo[-1].synchronize()
            self._fifo.clear()


class CompileCache:
    """sig -> runner, with FIFO eviction and bounded-retry negative
    caching.

    ``name`` prefixes the profiler counters: ``<name>_compile`` (a runner
    was built and stored), ``<name>_cache_hit`` (a stored runner was
    reused), ``<name>_compile_failed`` (a build attempt raised),
    ``<name>_neg_hit`` (a sig was skipped because it previously failed).
    """

    def __init__(self, name: str, max_entries: int = 128):
        self.name = name
        self.max_entries = max_entries
        self._entries: Dict[Any, Any] = {}
        # sig -> [failure_count, permanent]
        self._failures: Dict[Any, List] = {}
        self._lock = _lockcheck.Lock(name="fused.cache_lock")

    def get(self, sig):
        with self._lock:
            runner = self._entries.get(sig)
        if runner is not None:
            _profiler.incr_counter(self.name + "_cache_hit")
        return runner

    def put(self, sig, runner) -> None:
        with self._lock:
            if sig not in self._entries and \
                    len(self._entries) >= self.max_entries:
                self._entries.pop(next(iter(self._entries)))
            self._entries[sig] = runner
            # a success wipes the failure history for this structure
            self._failures.pop(sig, None)
        _profiler.incr_counter(self.name + "_compile")

    def should_skip(self, sig) -> bool:
        """True when this signature is negative-cached: permanently
        failed, or transiently failed too many times."""
        with self._lock:
            rec = self._failures.get(sig)
            skip = rec is not None and \
                (rec[1] or rec[0] >= _MAX_TRANSIENT_RETRIES)
        if skip:
            _profiler.incr_counter(self.name + "_neg_hit")
        return skip

    def note_success(self, sig) -> None:
        """A cached runner ran successfully: clear the transient failure
        count so isolated hiccups never accumulate into a demotion."""
        with self._lock:
            self._failures.pop(sig, None)

    def mark_failed(self, sig, permanent: bool = False) -> None:
        with self._lock:
            if sig not in self._failures and \
                    len(self._failures) >= self.max_entries:
                self._failures.pop(next(iter(self._failures)))
            rec = self._failures.setdefault(sig, [0, False])
            rec[0] += 1
            rec[1] = rec[1] or permanent
        _profiler.incr_counter(self.name + "_compile_failed")

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()
            self._failures.clear()

    def __len__(self) -> int:
        return len(self._entries)


# ------------------------------------------------------- signature scheme

_fn_tokens: Dict[int, Tuple[int, Any]] = {}
_fn_token_counter = itertools.count()


def fn_token(fn) -> int:
    """A stable, never reused token for a live function object: ``id``
    alone can be recycled after garbage collection, so an id is trusted
    only while a weak reference confirms the same object."""
    key = id(fn)
    ent = _fn_tokens.get(key)
    if ent is not None and ent[1]() is fn:
        return ent[0]
    token = next(_fn_token_counter)
    try:
        ref = weakref.ref(fn, lambda _r, _k=key: _fn_tokens.pop(_k, None))
    except TypeError:
        raise Uncacheable("cannot key compiled program by %r" % (fn,))
    _fn_tokens[key] = (token, ref)
    return token


def op_identity(op):
    """The cache identity of an ``OpDef``: its name for a registry op,
    name and :func:`fn_token` for another closure-backed op; a per-call
    ``_Function_*`` op (each ``autograd.Function`` call builds a fresh
    one) is :class:`Uncacheable`."""
    from .ops.registry import OP_REGISTRY
    if OP_REGISTRY.get(op.name) is op:
        return op.name
    if op.name.startswith("_Function_"):
        raise Uncacheable("per-call Function op %s" % op.name)
    return (op.name, fn_token(op.fn))


def static_key(v):
    """The cache-key form of a static value; it must be collision-free,
    so anything unhashable beyond list / tuple nesting raises
    :class:`Uncacheable` (an array's repr truncates)."""
    if isinstance(v, (list, tuple)):
        return tuple(static_key(x) for x in v)
    try:
        hash(v)
        return v
    except TypeError:
        raise Uncacheable(str(type(v)))


def aval_key(t: torch.Tensor) -> tuple:
    """Shape, dtype and device of a tensor (or an NDArray's tensor)."""
    t = getattr(t, "_data", t)
    return (tuple(t.shape), t.dtype, t.device)


# --------------------------------------------------------- fused updater

# the CPU route's backend: dynamo's capture and AOT autograd's graph run
# eagerly, without inductor's C++ code generation (ROADMAP queue C)
CPU_BACKEND = "aot_eager"
_GPU_BACKEND = "inductor"
_program_ids = itertools.count()


def _state_raw(s):
    """NDArray state tree -> tensor tree (None passes through)."""
    if s is None:
        return None
    if isinstance(s, tuple):
        return tuple(_state_raw(x) for x in s)
    return s._data


def _state_sig(s):
    if s is None:
        return None
    if isinstance(s, tuple):
        return tuple(_state_sig(x) for x in s)
    return aval_key(s)


def _storage(t: torch.Tensor) -> int:
    return t.untyped_storage().data_ptr()


def _dealias_states(weights, states) -> None:
    """Give every state leaf memory of its own before a compiled
    in-place update: a leaf sharing storage with a weight (a custom
    update that binds a state to its weight's tensor, as the reference's
    ``Test`` does) or with an earlier leaf is replaced, in its NDArray,
    by a copy; counts ``trainer_step_dealias_copy``."""
    seen = {_storage(w) for w in weights}

    def visit(s):
        if s is None:
            return
        if isinstance(s, tuple):
            for x in s:
                visit(x)
            return
        key = _storage(s._data)
        if key in seen and s._data.numel():
            _profiler.incr_counter("trainer_step_dealias_copy")
            s._data = s._data.clone()
            key = _storage(s._data)
        seen.add(key)

    for s in states:
        visit(s)


def _hyper_tensor(values: List[float], device: torch.device) -> torch.Tensor:
    """The hyperparameter vector on ``device``: through pinned memory
    without a host wait on the card. The program takes its elements as
    0-d tensors, each an input: an element read at an offset of one
    vector would put the offset into each parameter's kernel, and no
    two kernels would be alike."""
    t = torch.tensor(values, dtype=torch.float64)
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t


def _compile_caches() -> None:
    """Keep inductor's and triton's on-disk caches in the checkout's
    ``build/inductor`` (ignored by git) unless the caller placed them:
    the package writes nothing outside its checkout, and processes of
    one checkout (a supervisor's restarts, a tuner's probes) share the
    code generation of a program they build alike."""
    import os
    from ._build import BUILD_DIR
    root = BUILD_DIR / "inductor"
    os.environ.setdefault("TORCHINDUCTOR_CACHE_DIR", str(root))
    os.environ.setdefault("TRITON_CACHE_DIR", str(root / "triton"))


def _no_silent_eager():
    """Make dynamo raise where it would run a frame eagerly once its
    recompile limit is hit."""
    import torch._dynamo.config as dcfg
    if hasattr(dcfg, "fail_on_recompile_limit_hit"):
        return dcfg.patch(fail_on_recompile_limit_hit=True)
    return dcfg.patch(fail_on_cache_limit_hit=True)


def torch_version() -> Tuple[int, int]:
    """This torch's ``(major, minor)``."""
    major, minor = (int(v) for v in torch.__version__.split(".")[:2])
    return major, minor


def _compile_program(prefix: str, fn, device: torch.device, count):
    """``(backend, compiled)``: ``fn`` under a code object of its own
    named ``<prefix>_<n>``, compiled whole (``fullgraph``, static
    shapes) by inductor on the card and :data:`CPU_BACKEND` on the CPU,
    ``count()`` called at each of the backend's builds. Dynamo keeps its
    cache, its guards and its recompile limit per code object: two
    programs of one function would count as recompiles of each other."""
    backend = _GPU_BACKEND if device.type == "cuda" else CPU_BACKEND
    if backend == "inductor":
        _compile_caches()
    name = "%s_%d" % (prefix, next(_program_ids))
    code = fn.__code__.replace(co_name=name, co_qualname=name)
    fn = types.FunctionType(code, fn.__globals__, name, None, fn.__closure__)
    import torch._dynamo
    compile_backend = torch._dynamo.lookup_backend(backend)

    def counted(gm, example_inputs):
        count()
        return compile_backend(gm, example_inputs)

    return backend, torch.compile(fn, backend=counted, fullgraph=True,
                                  dynamic=False)


class _Program(object):
    """One compiled update: ``opt.update_fused`` over one structure
    (:func:`_compile_program`). ``builds`` counts the backend's compiles
    (1 after the first call; a dynamo recompile adds one)."""

    def __init__(self, opt, indices, clip_on: bool, device: torch.device):
        self.builds = 0

        def step(weights, grads, states, hv):
            opt.update_fused(indices, weights, grads, states, hv, clip_on)

        self.backend, self._fn = _compile_program("trainer_step", step,
                                                  device, self._count)

    def _count(self):
        self.builds += 1

    def __call__(self, weights, grads, states, hv) -> None:
        with _no_silent_eager(), torch.no_grad():
            self._fn(weights, grads, states, hv)


# the compiled training steps' programs, process-wide: two Modules of one
# structure (symbol, shapes, trained set, levers, amp) share one program
STEP_CACHE = CompileCache("fused_step")


class StepProgram(object):
    """One compiled training forward: ``body(args, aux) -> (outputs,
    {aux name: new value})`` captured whole (``fullgraph``), its
    backward built by AOT autograd in the same capture, so
    ``torch.autograd.grad`` on its outputs runs the compiled backward.
    As :class:`_Program`, each program has a code object of its own
    (:func:`_compile_program`) and counts its backend's builds in
    ``builds``; a call raises where dynamo would run the frame
    eagerly."""

    def __init__(self, body, device: torch.device):
        self.builds = 0

        def step(args, aux):
            return body(args, aux)

        self.backend, self._fn = _compile_program("fused_step", step,
                                                  device, self._count)

    def _count(self):
        self.builds += 1

    def __call__(self, args, aux):
        with _no_silent_eager():
            return self._fn(args, aux)


def step_fallback(why: str) -> None:
    """Count one training step the compiled program did not run:
    ``fused_step_fallback`` and ``fused_step_fallback_<why>``."""
    _profiler.incr_counter("fused_step_fallback")
    _profiler.incr_counter("fused_step_fallback_" + why)


class FusedUpdater(object):
    """The compiled whole-model update over a standard ``Updater``.

    :meth:`try_step` is the one gate ``Trainer.step``, ``Module.update``
    and ``Module._fit_step`` share; False sends the caller to the eager
    grouped update. The cache is this updater's, so its programs (which
    hold the optimizer) die with the trainer or module; the counters
    aggregate under ``trainer_step``."""

    def __init__(self, updater, cache: Optional[CompileCache] = None):
        self.updater = updater
        self.cache = cache or CompileCache("trainer_step")
        self._builds = 0

    def try_step(self, updater, items, lr=None, t=None) -> bool:
        """One compiled step of ``items`` (``(index, weight NDArray,
        grad)``), ``lr`` and ``t`` as for ``Updater.update_multi``: True
        when it ran, False (counted) when the caller must run the eager
        update: the knob is off, ``updater`` is not the standard
        ``Updater`` this one wraps, or the compiled step declined."""
        from . import config as _config
        from . import optimizer as _opt
        if not _config.get("MXNET_TPU_FUSED_TRAINER"):
            return self._fallback("knob")
        if type(updater) is not _opt.Updater or self.updater is not updater:
            return self._fallback("updater")
        return self(items, lr=lr, t=t)

    @staticmethod
    def _fallback(why: str) -> bool:
        _profiler.incr_counter("trainer_step_fallback")
        _profiler.incr_counter("trainer_step_fallback_" + why)
        return False

    def __call__(self, items, lr=None, t=None) -> bool:
        if not items:
            return True
        opt = self.updater.optimizer
        if not getattr(opt, "fused_supported", True):
            return self._fallback("opt_out")
        idxs = [i for i, _w, _g in items]
        weights = [w for _i, w, _g in items]
        # states exactly as the eager update makes them (or moves a
        # loaded one to its weight's device), before signing: their
        # structure is part of the signature
        states = [self.updater._state(i, w) for i, w in zip(idxs, weights)]
        grads = [getattr(g, "_data", g) for _i, _w, g in items]
        try:
            sig = self._signature(opt, idxs, weights, grads, states)
        except (Uncacheable, AttributeError, TypeError):
            return self._fallback("uncacheable")
        if self.cache.should_skip(sig):
            return self._fallback("neg_cache")
        counts, base = opt._step_plan(idxs, lr, t)
        w_raw = [w._data for w in weights]
        _dealias_states(w_raw, states)
        s_raw = [_state_raw(s) for s in states]
        hv = _hyper_tensor(opt._fused_vector(idxs, counts, base),
                           w_raw[0].device).unbind(0)
        generic = type(opt)._multi is _optimizer_base()._multi
        from . import autograd as _autograd
        from .obs import compiles as _obs_compiles
        # recording off: a step() inside autograd.record() leaves
        # nothing on the tape
        prev_rec = _autograd.set_recording(False)
        try:
            with _obs_compiles.scope("trainer_step", sig):
                prog = self.cache.get(sig)
                fresh = prog is None
                if fresh:
                    try:
                        if generic:
                            _check_pure(opt, idxs[0], weights[0], grads[0],
                                        states[0], base[0], counts[0])
                        prog = _Program(opt, idxs, opt._clip_active(),
                                        w_raw[0].device)
                    except Exception as e:                 # noqa: BLE001
                        return self._failed(opt, sig, e)
                try:
                    self._run(prog, opt, generic, w_raw, grads, s_raw, hv)
                except Exception as e:                     # noqa: BLE001
                    return self._failed(opt, sig, e)
                if fresh:
                    self.cache.put(sig, prog)
                else:
                    self.cache.note_success(sig)
        finally:
            _autograd.set_recording(prev_rec)
        opt._advance(idxs, counts, t)
        return True

    def _failed(self, opt, sig, exc) -> bool:
        self.cache.mark_failed(sig, permanent=structural_failure(exc))
        if _is_uncacheable(exc):
            # an update() that changes the optimizer (a warm-up counter)
            # changes the signature too: pin the instance to the eager
            # path so later steps do not trace it again
            opt.fused_supported = False
        return self._fallback("failed")

    def _run(self, prog, opt, generic, w_raw, grads, s_raw, hv) -> None:
        """Call the program, count its builds (the compile ring gets the
        call's wall time as the compile's), and for the generic form put
        back the attributes its replay set."""
        snap = _snapshot(opt) if generic else None
        before = prog.builds
        t0 = time.perf_counter()
        try:
            prog(w_raw, grads, s_raw, hv)
        finally:
            if generic:
                _restore(opt, snap)
        built = prog.builds - before
        if not built:
            return
        from .obs import compiles as _obs_compiles
        _obs_compiles.record((time.perf_counter() - t0) * 1e3,
                             source=prog.backend)
        if self._builds:
            _profiler.incr_counter("loop_recompile", built)
        if before:
            _profiler.incr_counter("trainer_step_recompile", built)
        self._builds += built

    @staticmethod
    def _signature(opt, idxs, weights, grads, states):
        per_param = tuple(
            (static_key(i), aval_key(w), aval_key(g), _state_sig(s),
             opt._resolve_mult(opt.lr_mult, i),
             opt._resolve_mult(opt.wd_mult, i))
            for i, w, g, s in zip(idxs, weights, grads, states))
        return (opt._fused_static_key(), per_param)


def _optimizer_base():
    from .optimizer import Optimizer
    return Optimizer


def _snapshot(opt):
    """The optimizer's attributes, and a copy of each dict among them."""
    orig = dict(opt.__dict__)
    return orig, {k: (dict(v) if isinstance(v, dict) else v)
                  for k, v in orig.items()}


def _restore(opt, snap) -> None:
    """Put back what :func:`_snapshot` saw: the same objects, each dict
    with its contents of then."""
    orig, copies = snap
    opt.__dict__.clear()
    opt.__dict__.update(orig)
    for k, v in orig.items():
        if isinstance(v, dict):
            v.clear()
            v.update(copies[k])


def _check_pure(opt, idx, weight, grad, state, base, count) -> None:
    """Run ``opt.update`` once, eagerly, on copies of one parameter's
    tensors, and raise :class:`Uncacheable` if it changed the optimizer
    beyond the per-step attributes (a compiled replay would freeze such
    a change); the optimizer is put back as it was either way."""
    from .ndarray import NDArray

    def copy(s):
        if s is None:
            return None
        if isinstance(s, tuple):
            return tuple(copy(x) for x in s)
        return NDArray(s._data.clone())

    snap = _snapshot(opt)
    try:
        opt._fixed_lr, opt._fixed_t = base, count
        with torch.no_grad():
            opt.update(idx, NDArray(weight._data.clone()),
                       NDArray(grad), copy(state))
        opt._check_update_purity(snap[1])
    finally:
        _restore(opt, snap)
