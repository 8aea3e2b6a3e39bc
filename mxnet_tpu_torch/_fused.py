"""The per-signature runner cache shared by the serving path.

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

from typing import Any, Dict, List

from . import lockcheck as _lockcheck
from . import profiler as _profiler

__all__ = ["CompileCache"]

_MAX_TRANSIENT_RETRIES = 3


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
