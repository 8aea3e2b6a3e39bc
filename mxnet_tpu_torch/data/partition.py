"""Deterministic shard partitioning for the streaming data plane.

The whole data plane hangs off one pure function family: given
``(seed, epoch, world_size, rank, num_workers, batch_size)`` and the
dataset's record count, every process in the pod — and every worker
process inside it — derives the SAME answer to "which records make up
batch ``k`` of epoch ``e``, and who decodes it". Nothing is negotiated
at runtime, so determinism, elastic resharding and mid-epoch resume all
reduce to re-evaluating the function with different arguments:

* **ordering** — ``epoch_order(seed, epoch)`` permutes the record ids
  (identity when ``shuffle=False``); the permutation depends only on
  ``(seed, epoch)``, never on worker count or world size.
* **host ownership** — host ``r`` of ``w`` owns the strided slice
  ``order[r::w]`` (the striding ``ImageRecordIter`` already uses for
  ``part_index``/``num_parts``), chopped into consecutive batches of
  ``batch_size`` (the ragged tail is dropped — every rank must step the
  same number of times or the pod's collectives deadlock).
* **worker ownership** — batch ``k`` belongs to worker ``k %
  num_workers``. Worker count therefore re-partitions WHO decodes a
  batch, never WHAT the batch contains or WHEN it is delivered: the
  delivered stream is bit-identical across ``num_workers`` (the
  determinism tests pin {1, 2, 4}).
* **cursor** — a mid-epoch position is just ``(epoch, batches_done)``;
  resuming is re-evaluating the plan at the same ``(seed, epoch)`` and
  starting at batch ``batches_done`` — even with a different worker
  count (the kill/reshard/resume drill's acceptance).

Ordering contract and failure semantics: the reference's
docs/architecture/data_plane.md.
"""
from __future__ import annotations

from typing import List, Sequence

import numpy as np

__all__ = ["epoch_order", "PartitionPlan"]


def epoch_order(num_records: int, seed: int, epoch: int,
                shuffle: bool = True) -> np.ndarray:
    """The epoch's record-id permutation — a pure function of
    ``(seed, epoch)``. PCG64 under an explicit SeedSequence: stable
    across processes and runs, and epochs draw independent streams
    without consuming shared RNG state."""
    if not shuffle:
        return np.arange(num_records, dtype=np.int64)
    rng = np.random.Generator(np.random.PCG64(
        np.random.SeedSequence([int(seed), int(epoch)])))
    return rng.permutation(num_records).astype(np.int64)


class PartitionPlan(object):
    """One epoch's resolved partition for one host: the host-local
    batch list plus the worker-ownership map. Construction is cheap
    (one permutation + one stride) — workers and the facade both
    rebuild it from the scalar parameters instead of shipping arrays.
    """

    def __init__(self, num_records: int, batch_size: int, *, seed: int,
                 epoch: int, rank: int = 0, world_size: int = 1,
                 num_workers: int = 1, shuffle: bool = True):
        if batch_size <= 0:
            raise ValueError("batch_size must be positive, got %d"
                             % batch_size)
        if not (0 <= rank < max(1, world_size)):
            raise ValueError("rank %d outside world of %d"
                             % (rank, world_size))
        self.num_records = int(num_records)
        self.batch_size = int(batch_size)
        self.seed = int(seed)
        self.epoch = int(epoch)
        self.rank = int(rank)
        self.world_size = max(1, int(world_size))
        self.num_workers = max(1, int(num_workers))
        self.shuffle = bool(shuffle)
        order = epoch_order(self.num_records, self.seed, self.epoch,
                            self.shuffle)
        # host-local record sequence: strided so a world change
        # re-partitions without reshuffling what exists
        self.local_order = order[self.rank::self.world_size]
        # drop the ragged tail: every rank must deliver the same batch
        # count or the pod's bulk-synchronous step deadlocks
        self.num_batches = len(self.local_order) // self.batch_size

    # ------------------------------------------------------------ lookups
    def batch_records(self, k: int) -> np.ndarray:
        """Record ids of host-local batch ``k`` (epoch order)."""
        if not (0 <= k < self.num_batches):
            raise IndexError("batch %d outside epoch of %d batches"
                             % (k, self.num_batches))
        lo = k * self.batch_size
        return self.local_order[lo:lo + self.batch_size]

    def worker_of(self, k: int) -> int:
        """Which worker decodes host-local batch ``k``."""
        return k % self.num_workers

    def owned_batches(self, worker: int, start_batch: int = 0
                      ) -> List[int]:
        """Batch indices worker ``worker`` owns from ``start_batch`` on —
        the worker's (disjoint) shard range of the epoch. Respawn-after-
        death replays exactly this list recomputed at the first
        undelivered batch."""
        if not (0 <= worker < self.num_workers):
            raise IndexError("worker %d outside pool of %d"
                             % (worker, self.num_workers))
        first = max(0, int(start_batch))
        return [k for k in range(first, self.num_batches)
                if k % self.num_workers == worker]

    def owned_ranges(self, worker: int, start_batch: int = 0
                     ) -> List[Sequence[int]]:
        """The record-id lists for :meth:`owned_batches` — what the
        worker process actually receives (keys to ``read_idx``)."""
        return [self.batch_records(k).tolist()
                for k in self.owned_batches(worker, start_batch)]

    def describe(self) -> dict:
        return {"num_records": self.num_records,
                "batch_size": self.batch_size, "seed": self.seed,
                "epoch": self.epoch, "rank": self.rank,
                "world_size": self.world_size,
                "num_workers": self.num_workers, "shuffle": self.shuffle,
                "num_batches": self.num_batches}
