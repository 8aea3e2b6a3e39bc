"""Preallocated KV cache for generative decode.

Counterpart of the reference package's ``serve/kv_cache.py``. The cache
is ONE device-resident block per tensor, allocated at server start —

    K, V: (num_layers, max_slots, n_heads, max_seq, d_head) float32

— so geometry never changes and every decode step writes at per-slot
positions without a block table. What is paged is the accounting: the
host-side :class:`PageLedger` (a copy of the reference's) tracks
per-slot sequence lengths in page-sized chunks, drives the occupancy
gauges, and catches leaks and double-frees loudly.

The prefill and decode programs update ``k`` and ``v`` IN PLACE (the
reference donates the buffers through each jitted call and re-binds the
result; here the tensors are simply written). The reference's int8
mode, its tensor-parallel sharded cache and its hbm-budget audit are
not ported yet.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional

import torch

from .. import lockcheck as _lockcheck
from .. import profiler as _profiler
from ..base import MXNetError
from ..context import DeviceLike, resolve_device

__all__ = ["KVCache", "PageLedger", "max_slots_for"]


def max_slots_for(budget_bytes: int, num_layers: int, n_heads: int,
                  d_head: int, max_seq: int) -> int:
    """Largest ``max_slots`` whose float32 cache fits the budget — the
    capacity-planning inverse of :meth:`KVCache.hbm_bytes`."""
    bytes_slot = 2 * num_layers * n_heads * max_seq * d_head * 4
    return max(0, int(budget_bytes) // bytes_slot)


class PageLedger:
    """Host-side page accounting for the preallocated slot array.

    Invariants (checked by :meth:`check`, raised on violation): every
    slot is free or resident, never both; ``pages_in_use`` equals the
    sum over resident slots of ``ceil(len / page)``; release of a free
    slot (double-free) and growth past ``max_seq`` raise.
    """

    def __init__(self, max_slots: int, max_seq: int, page: int):
        if max_slots < 1:
            raise ValueError("max_slots must be >= 1, got %d" % max_slots)
        if max_seq % page:
            raise ValueError("max_seq %d not a multiple of page %d"
                             % (max_seq, page))
        self.max_slots = int(max_slots)
        self.max_seq = int(max_seq)
        self.page = int(page)
        self.total_pages = self.max_slots * (self.max_seq // self.page)
        self._free: List[int] = list(range(self.max_slots - 1, -1, -1))
        self._len: Dict[int, int] = {}      # resident slot -> seq length
        self._lock = _lockcheck.Lock(name="serve.kv_cache_lock")

    def _pages(self, length: int) -> int:
        return max(1, math.ceil(length / self.page))

    # ------------------------------------------------------------ lifecycle
    def acquire(self, length: int) -> Optional[int]:
        """Claim a free slot for a sequence of ``length`` tokens; None
        when every slot is resident."""
        if not 0 < length <= self.max_seq:
            raise ValueError("sequence length %d outside (0, max_seq=%d]"
                             % (length, self.max_seq))
        with self._lock:
            if not self._free:
                return None
            slot = self._free.pop()
            self._len[slot] = int(length)
            return slot

    def grow(self, slot: int) -> int:
        """One decoded token appended to ``slot``; returns the new
        length. Raises when the slot is not resident or full."""
        with self._lock:
            if slot not in self._len:
                raise MXNetError("kv ledger: grow of non-resident slot %d"
                                 % slot)
            if self._len[slot] >= self.max_seq:
                raise MXNetError("kv ledger: slot %d already at max_seq %d"
                                 % (slot, self.max_seq))
            self._len[slot] += 1
            return self._len[slot]

    def release(self, slot: int) -> int:
        """Free ``slot``'s pages; returns the page count released. A
        release of a non-resident slot is a DOUBLE-FREE and raises."""
        with self._lock:
            if slot not in self._len:
                raise MXNetError(
                    "kv ledger: double-free of slot %d (not resident)"
                    % slot)
            pages = self._pages(self._len.pop(slot))
            self._free.append(slot)
            return pages

    # ------------------------------------------------------------- queries
    @property
    def slots_in_use(self) -> int:
        with self._lock:
            return len(self._len)

    @property
    def pages_in_use(self) -> int:
        with self._lock:
            return sum(self._pages(n) for n in self._len.values())

    def length(self, slot: int) -> int:
        with self._lock:
            return self._len[slot]

    def lengths(self) -> Dict[int, int]:
        with self._lock:
            return dict(self._len)

    def occupancy(self) -> float:
        return self.pages_in_use / self.total_pages

    def check(self) -> None:
        """Invariant audit: slot sets partition, lengths in range."""
        with self._lock:
            free = set(self._free)
            used = set(self._len)
            if free & used:
                raise MXNetError("kv ledger: slots both free and resident: "
                                 "%s" % sorted(free & used))
            if len(free) != len(self._free):
                raise MXNetError("kv ledger: duplicate free slots")
            if free | used != set(range(self.max_slots)):
                raise MXNetError("kv ledger: lost slots: %s"
                                 % sorted(set(range(self.max_slots))
                                          - free - used))
            for slot, n in self._len.items():
                if not 0 < n <= self.max_seq:
                    raise MXNetError("kv ledger: slot %d length %d out of "
                                     "range" % (slot, n))


class KVCache:
    """The device-resident cache tensors + the ledger + the gauges.

    ``device`` defaults to ``cuda:0`` and raises without a GPU; pass
    ``device="cpu"`` to hold the cache on the host.
    """

    def __init__(self, num_layers: int, n_heads: int, d_head: int,
                 max_slots: int, max_seq: int, page: Optional[int] = None,
                 name: str = "serve", device: DeviceLike = None):
        from .. import config as _config
        self.page = int(page if page is not None
                        else _config.get("MXNET_TPU_SERVE_KV_PAGE"))
        self.device = resolve_device(device)
        self.num_layers = int(num_layers)
        self.n_heads = int(n_heads)
        self.d_head = int(d_head)
        self.max_slots = int(max_slots)
        self.max_seq = int(max_seq)
        self.name = name
        self.ledger = PageLedger(self.max_slots, self.max_seq, self.page)
        shape = (self.num_layers, self.max_slots, self.n_heads,
                 self.max_seq, self.d_head)
        self.k = torch.zeros(shape, dtype=torch.float32, device=self.device)
        self.v = torch.zeros(shape, dtype=torch.float32, device=self.device)
        self._update_gauges()

    def hbm_bytes(self) -> int:
        """The reservation's device footprint (K + V)."""
        return sum(t.numel() * t.element_size() for t in (self.k, self.v))

    # ----------------------------------------------------------- lifecycle
    def acquire(self, length: int) -> Optional[int]:
        slot = self.ledger.acquire(length)
        if slot is not None:
            self._update_gauges()
        return slot

    def grow(self, slot: int) -> int:
        n = self.ledger.grow(slot)
        self._update_gauges()
        return n

    def release(self, slot: int) -> int:
        pages = self.ledger.release(slot)
        self._update_gauges()
        return pages

    def _update_gauges(self) -> None:
        _profiler.set_gauge(self.name + "_kv_slots_in_use",
                            self.ledger.slots_in_use)
        _profiler.set_gauge(self.name + "_kv_pages_in_use",
                            self.ledger.pages_in_use)
        _profiler.set_gauge(self.name + "_kv_occupancy",
                            self.ledger.occupancy())
