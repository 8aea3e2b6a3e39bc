"""The per-signature runner cache shared by the serving path, its
failure classifier, and the in-flight window of ``fit``'s async loop.

The port's copy of the reference package's ``_fused.CompileCache``. The
port compiles nothing per signature (PyTorch runs eagerly), so an entry
is the bound per-bucket runner; the counters keep their meaning all the
same: ``<name>_compile`` counts the first dispatch of each signature,
``<name>_cache_hit`` every later one, so "the runner set is bounded by
|prompt buckets| + |decode buckets|" and "steady state adds no entries"
stay counter assertions. A later slice captures one CUDA graph per
decode bucket, and that graph becomes the entry.
"""
from __future__ import annotations

import re
from typing import Any, Dict, List

import torch

from . import lockcheck as _lockcheck
from . import profiler as _profiler

__all__ = ["CompileCache", "InflightWindow", "Uncacheable",
           "structural_failure"]

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
    allocator may satisfy on the next attempt."""
    for e in _chain(exc):
        if isinstance(e, Uncacheable):
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
