"""``data.DataLoader`` — the multi-process streaming loader facade.

A ``DataIter`` over an indexed RecordIO file whose decode runs in
worker PROCESSES owning disjoint shard ranges (``partition.
PartitionPlan``): the facade delivers host batches in deterministic
epoch order regardless of worker count, ``fit`` wraps it in the
device-prefetch stage (``_mx_set_device_placer``: the loader runs the
module's placer on each batch it delivers), and the checkpoint manifest
carries its cursor so a mid-epoch resume — even with a different worker
count — restarts the stream bit-exactly (the reference's
docs/architecture/data_plane.md).

Delivery protocol: batch ``k`` is owned by worker ``k % num_workers``
and every worker emits its owned batches in ascending order, so the
facade pops batch ``k`` from queue ``k % W`` — in-order reassembly with
ZERO reorder buffering in the steady state. A dead worker (``data.
worker`` fault, OOM-killer, a real crash) is detected on the poll path
and respawned over exactly its undelivered range; batches its corpse
left in the old queue are salvaged first, so the replay is exact and
nothing is delivered twice.

Observability (always-on counters/gauges):

* ``data_batches`` / ``data_records`` — delivered volume
* ``data_stall`` — the consumer outran the workers in steady state
  (first fetch of an epoch excluded, mirroring
  ``loop_prefetch_stall``'s cold-queue discipline)
* ``data_worker_respawn`` — dead-worker recoveries
* ``data_batch_poisoned`` — batches dropped by a decode fault
* ``data_queue_depth`` — gauge, decoded batches waiting at last fetch
"""
from __future__ import annotations

import logging
import multiprocessing as mp
import queue as _queue_mod
import time
from typing import Optional

import numpy as np

from .. import config as _config
from .. import profiler as _profiler
from ..base import MXNetError
from ..io.io import DataBatch, DataDesc, DataIter
from .partition import PartitionPlan
from .worker import worker_main

__all__ = ["DataLoader"]

log = logging.getLogger(__name__)

# cursor schema version — bumped if the partition function ever changes
# incompatibly (a resume across versions must fail loudly, not skew)
CURSOR_VERSION = 1


class DataLoader(DataIter):
    """Sharded multi-worker streaming iterator over indexed RecordIO.

    Parameters
    ----------
    rec_path : str
        The ``.rec`` file.
    idx_path : str, optional
        The ``.idx`` sidecar (default: ``rec_path`` with ``.idx``).
    batch_size : int
    transform : callable
        Picklable ``raw_bytes -> (data, label)`` decoder
        (``RawTransform`` / ``ImageTransform`` / custom).
    shuffle : bool
        Per-epoch deterministic shuffle (seeded permutation).
    seed : int
        The determinism root: two loaders with equal
        ``(seed, batch_size, world)`` deliver identical streams.
    num_workers : int, optional
        Worker processes; default ``MXNET_TPU_DATA_WORKERS``. ``0`` =
        decode inline in the consumer thread (also forced by the
        ``MXNET_TPU_DATA_MP=0`` kill switch).
    queue_depth : int, optional
        Decoded batches buffered per worker; default
        ``MXNET_TPU_DATA_QUEUE_DEPTH``.
        A worker that stays alive but delivers nothing for
        ``MXNET_TPU_DATA_TIMEOUT`` seconds ends the epoch with
        ``MXNetError`` (the reference waits forever).
    part : "auto" | (rank, world)
        Host ownership: ``"auto"`` is ``(0, 1)``, one host with one card
        (meshes and pods are a later item of the port); a tuple pins it.
    mesh : None
        The reference resolves ``part="auto"`` against a mesh; the port
        has none yet and raises when one is passed.
    begin_epoch : int
        First epoch's index (shuffle permutation parity on restarts).
    data_name / label_name : str
        Names for ``provide_data`` / ``provide_label``.
    """

    def __init__(self, rec_path: str, idx_path: Optional[str] = None,
                 batch_size: int = 32, transform=None, shuffle: bool = True,
                 seed: int = 0, num_workers: Optional[int] = None,
                 queue_depth: Optional[int] = None, part="auto", mesh=None,
                 begin_epoch: int = 0, data_name: str = "data",
                 label_name: str = "label"):
        super(DataLoader, self).__init__(batch_size=int(batch_size))
        if transform is None:
            raise ValueError(
                "DataLoader needs a transform (data.RawTransform / "
                "ImageTransform or any picklable raw->(data,label) "
                "callable)")
        self.rec_path = rec_path
        self.idx_path = idx_path if idx_path is not None else \
            rec_path.rsplit(".", 1)[0] + ".idx"
        self.transform = transform
        self.shuffle = bool(shuffle)
        self.seed = int(seed)
        if num_workers is None:
            num_workers = int(_config.get("MXNET_TPU_DATA_WORKERS"))
        if not _config.get("MXNET_TPU_DATA_MP"):
            num_workers = 0            # kill switch: inline decode
        self.num_workers = max(0, int(num_workers))
        self.queue_depth = max(1, int(
            _config.get("MXNET_TPU_DATA_QUEUE_DEPTH")
            if queue_depth is None else queue_depth))
        self.timeout_s = float(_config.get("MXNET_TPU_DATA_TIMEOUT"))
        if mesh is not None:
            raise MXNetError("DataLoader(mesh=...) is not ported yet: it "
                             "comes with ROADMAP.md queue A9 (parallelism)")
        if part == "auto":
            self.rank, self.world_size = 0, 1
        else:
            self.rank, self.world_size = int(part[0]), int(part[1])
        self.data_name = data_name
        self.label_name = label_name

        # index keys in file order — the record-id space the partition
        # permutes. Loaded once here; workers reopen their own handles.
        from .. import recordio as _recordio
        self._rec = _recordio.MXIndexedRecordIO(self.idx_path, rec_path,
                                                "r")
        self._keys = list(self._rec.keys)
        if len(self._keys) < self.batch_size * max(1, self.world_size):
            raise MXNetError(
                "DataLoader: %d records in %s cannot fill one batch of "
                "%d on every one of %d hosts"
                % (len(self._keys), rec_path, self.batch_size,
                   max(1, self.world_size)))

        # shapes/dtypes from record 0 (any record — the stream is
        # homogeneous by contract)
        d0, l0 = transform(self._rec.read_idx(self._keys[0]))
        d0, l0 = np.asarray(d0), np.asarray(l0)
        self.provide_data = [DataDesc(data_name,
                                      (self.batch_size,) + d0.shape,
                                      d0.dtype)]
        self.provide_label = [DataDesc(label_name,
                                       (self.batch_size,) + l0.shape,
                                       l0.dtype)]

        # ---------------------------------------------------- epoch state
        self._epoch = int(begin_epoch)
        self._start_batch = 0          # cursor within the epoch
        self._plan: Optional[PartitionPlan] = None
        self._next_batch = 0           # next batch index to deliver
        self._first_fetch = True
        self._cold = set()             # worker queues not yet popped
        self._mp = self.num_workers > 0
        self._procs = []               # per-worker Process
        self._queues = []              # per-worker mp.Queue
        self._done = []                # per-worker clean-exit flag
        self._gen = []                 # per-worker respawn generation
        self._salvaged = {}            # batch_idx -> entry (respawn path)
        self._closed = False
        self._mx_device_placer = None  # fit-attached device placement

    # ------------------------------------------------------------ plumbing
    def _make_plan(self) -> PartitionPlan:
        return PartitionPlan(
            len(self._keys), self.batch_size, seed=self.seed,
            epoch=self._epoch, rank=self.rank,
            world_size=self.world_size,
            num_workers=max(1, self.num_workers), shuffle=self.shuffle)

    def _owned_payload(self, worker: int, start_batch: int):
        """[(batch_idx, [record keys])...] for one worker from a start
        position — the spawn/respawn work list."""
        plan = self._plan
        return [(k, [self._keys[i] for i in plan.batch_records(k)])
                for k in plan.owned_batches(worker, start_batch)]

    def _spawn_worker(self, w: int, start_batch: int) -> None:
        # fork when the platform has it: worker start is milliseconds
        # and faults.install() state is inherited. The workers never
        # touch torch.cuda (file IO, numpy, the native decoder), so the
        # usual fork-after-runtime-init hazards don't apply; spawn
        # platforms re-parse MXNET_TPU_FAULTS from the environment.
        try:
            ctx = mp.get_context("fork")
        except ValueError:
            ctx = mp.get_context()
        q = ctx.Queue(maxsize=self.queue_depth)
        proc = ctx.Process(
            target=worker_main,
            args=(w, self._gen[w], self.rec_path, self.idx_path,
                  self._owned_payload(w, start_batch), self.transform, q),
            daemon=True, name="mx-data-w%d" % w)
        import warnings
        with warnings.catch_warnings():
            # CPython warns that fork in a multi-threaded process may
            # deadlock — the children here run file IO, numpy and the
            # native decoder and never enter torch.cuda, which is the
            # case the warning cannot see
            warnings.filterwarnings(
                "ignore", message=".*fork.*", category=RuntimeWarning)
            warnings.filterwarnings(
                "ignore", message=".*fork.*", category=DeprecationWarning)
            proc.start()
        # the consumer holds no writer: a worker that dies in the middle
        # of a message (a batch is megabytes, written by its queue's
        # feeder thread) then leaves the pipe at end of file instead of a
        # read that waits forever for the rest (see _get)
        q._writer.close()
        self._procs[w] = proc
        self._queues[w] = q
        self._done[w] = False

    def _activate(self) -> None:
        """Lazy epoch start: build the plan and (mp mode) the worker
        pool from the cursor position."""
        self._plan = self._make_plan()
        self._next_batch = self._start_batch
        self._first_fetch = True
        # every worker queue is cold by construction at epoch start:
        # the FIRST pop from each is ramp, not a steady-state bubble
        # (the per-queue generalization of loop_prefetch_stall's
        # first-fetch discipline)
        self._cold = set(range(max(1, self.num_workers)))
        self._salvaged = {}
        if self._mp:
            nw = self.num_workers
            self._procs = [None] * nw
            self._queues = [None] * nw
            self._done = [False] * nw
            self._gen = [0] * nw
            for w in range(nw):
                self._spawn_worker(w, self._start_batch)

    def _teardown(self) -> None:
        """Stop the pool (idempotent). Workers blocked on a full queue
        die on terminate; exited ones just get joined."""
        for proc in self._procs:
            if proc is not None and proc.is_alive():
                proc.terminate()
        for proc in self._procs:
            if proc is not None:
                proc.join(timeout=5.0)
                if proc.is_alive():
                    proc.kill()
                    proc.join(timeout=5.0)
        for q in self._queues:
            if q is not None:
                q.close()
                q.cancel_join_thread()
        self._procs, self._queues, self._done, self._gen = [], [], [], []
        self._plan = None
        self._salvaged = {}
        _profiler.set_gauge("data_queue_depth", 0)

    def _salvage_queue(self, w: int) -> None:
        """Drain a dead worker's queue into the salvage buffer: batches
        its corpse already produced must be delivered, not replayed."""
        q = self._queues[w]
        while True:
            try:
                entry = q.get_nowait()
            except (_queue_mod.Empty, EOFError, OSError):
                break
            if entry[0] in ("data", "error"):
                self._salvaged[entry[1]] = entry
            elif entry[0] == "done":
                self._done[w] = True

    def _respawn(self, w: int) -> None:
        """A worker died mid-epoch (``data.worker`` fault, crash, OOM):
        salvage what it delivered to its queue, then replay its shard
        range from the first undelivered batch."""
        self._salvage_queue(w)
        self._gen[w] += 1
        _profiler.incr_counter("data_worker_respawn")
        first_undelivered = self._next_batch
        while first_undelivered < self._plan.num_batches and \
                (self._plan.worker_of(first_undelivered) != w
                 or first_undelivered in self._salvaged):
            first_undelivered += 1
        log.warning(
            "data: worker %d died (gen %d); respawning over its range "
            "from batch %d", w, self._gen[w], first_undelivered)
        self._spawn_worker(w, first_undelivered)

    def _get(self, w: int, timeout: Optional[float] = None):
        """The next entry of worker ``w``'s queue, or None when it has
        none yet. End of file on the pipe means the worker died, perhaps
        in the middle of a message: it is respawned and None returned."""
        q = self._queues[w]
        try:
            return q.get(timeout=timeout) if timeout else q.get_nowait()
        except _queue_mod.Empty:
            return None
        except (EOFError, OSError):
            if self._done[w]:
                raise MXNetError(
                    "data: worker %d finished but its queue was read "
                    "again (partition drift — file a bug)" % w)
            self._procs[w].join(timeout=5.0)
            self._respawn(w)
            return None

    def _pop(self, k: int):
        """Entry for batch ``k`` from its owner's queue, with stall
        accounting, dead-worker detection, salvage fallback and the
        ``MXNET_TPU_DATA_TIMEOUT`` deadline for a worker that is alive
        but stuck."""
        if k in self._salvaged:
            return self._salvaged.pop(k)
        w = self._plan.worker_of(k)
        entry = self._get(w)
        if entry is None and k not in self._salvaged:
            # the consumer outran the decode pool: a pipeline bubble —
            # except on the first pop from this worker's queue, which
            # is cold by construction at epoch start
            if w not in self._cold:
                _profiler.incr_counter("data_stall")
        deadline = time.monotonic() + self.timeout_s
        while entry is None:
            if k in self._salvaged:
                entry = self._salvaged.pop(k)
                break
            gen = self._gen[w]
            entry = self._get(w, timeout=0.2)
            if entry is not None:
                break
            if self._done[w]:
                raise MXNetError(
                    "data: worker %d finished but batch %d of "
                    "its range was never delivered (partition "
                    "drift — file a bug)" % (w, k))
            proc = self._procs[w]
            if proc is not None and not proc.is_alive():
                self._respawn(w)
            if self._gen[w] != gen:
                # a respawned worker starts its range afresh
                deadline = time.monotonic() + self.timeout_s
            elif time.monotonic() > deadline:
                self._teardown()
                raise MXNetError(
                    "data: worker %d is alive but delivered no batch in "
                    "%.0f s (waiting for batch %d of epoch %d); the pool "
                    "is torn down. Raise MXNET_TPU_DATA_TIMEOUT if one "
                    "batch really takes longer to decode"
                    % (w, self.timeout_s, k, self._epoch))
        self._cold.discard(w)
        q = self._queues[w]
        _profiler.set_gauge("data_queue_depth", q.qsize()
                            if hasattr(q, "qsize") else 0)
        if entry[0] == "done":
            self._done[w] = True
            return self._pop(k)
        return entry

    # ------------------------------------------------------- DataIter API
    def reset(self):
        """Epoch boundary: advance the epoch counter (fresh shuffle
        permutation) and restart the stream at batch 0."""
        self._teardown()
        self._epoch += 1
        self._start_batch = 0

    def next(self):
        if self._closed:
            raise MXNetError("DataLoader used after close()")
        if self._plan is None:
            self._activate()
        plan = self._plan
        while True:
            k = self._next_batch
            if k >= plan.num_batches:
                # epoch exhausted: reap the pool now so no worker
                # outlives the epoch that spawned it
                self._teardown()
                # re-arm the plan lazily for a bare re-iteration
                # without reset() (fit always resets)
                self._plan = None
                self._start_batch = 0
                raise StopIteration
            if self._mp:
                entry = self._pop(k)
            else:
                entry = self._decode_inline(k)
            self._first_fetch = False
            self._next_batch = k + 1
            kind = entry[0]
            if kind == "error":
                _profiler.incr_counter("data_batch_poisoned")
                log.warning(
                    "data: batch %d of epoch %d poisoned by a decode "
                    "fault (%s); continuing with the next batch",
                    k, self._epoch, entry[2])
                continue
            if entry[1] != k:
                raise MXNetError(
                    "data: out-of-order delivery (got batch %r, "
                    "expected %d) — worker ownership drift, file a bug"
                    % (entry[1], k))
            data_arr, label_arr = entry[2], entry[3]
            _profiler.incr_counter("data_batches")
            _profiler.incr_counter("data_records", self.batch_size)
            batch = DataBatch(
                data=[data_arr], label=[label_arr], pad=0, index=None,
                provide_data=self.provide_data,
                provide_label=self.provide_label)
            placer = self._mx_device_placer
            if placer is not None:
                # fit's device-placement stage runs HERE, on the batch
                # the workers just decoded: the module's H2D copy from
                # pinned staging buffers on its copy stream (the host
                # does not wait for it; the queued steps overlap it)
                # instead of a separate prefetch thread that would hand
                # the batch over once more
                placer(batch)
                _profiler.incr_counter("data_device_placed")
            return batch

    def _decode_inline(self, k: int):
        """num_workers=0 / MXNET_TPU_DATA_MP=0: the zero-process
        bisection fallback — same order, same fault semantics, decode
        on the consumer thread."""
        from .. import faults as _faults
        try:
            if _faults.ARMED:
                _faults.fire("data.decode", default_kind="raise")
            datas, labels = [], []
            for i in self._plan.batch_records(k):
                d, lab = self.transform(self._rec.read_idx(self._keys[i]))
                datas.append(d)
                labels.append(lab)
            return ("data", k, np.stack(datas), np.stack(labels))
        except StopIteration:
            raise
        except Exception as exc:                       # noqa: BLE001
            return ("error", k, "%s: %s" % (type(exc).__name__, exc),
                    None)

    # ------------------------------------------------- device placement
    def _mx_set_device_placer(self, placer) -> None:
        """fit() attaches the module's device placer so every delivered
        batch already carries device tensors (``batch._mx_placed``) —
        the loader IS the prefetch stage, no ``PrefetchingIter`` wrapper
        and no extra thread. ``None`` detaches (fit's ``finally``)."""
        self._mx_device_placer = placer

    # ----------------------------------------------- checkpoint integration
    def _mx_cursor(self, epoch: Optional[int] = None,
                   batches_done: Optional[int] = None) -> dict:
        """The manifest's loader cursor: position (supplied by fit — the
        CONSUMED count, not the delivered one, which runs prefetch-depth
        ahead) plus the static parameters that make a resume checkable."""
        return {"version": CURSOR_VERSION,
                "epoch": self._epoch if epoch is None else int(epoch),
                "batches_done": 0 if batches_done is None
                else int(batches_done),
                "seed": self.seed, "batch_size": self.batch_size,
                "num_records": len(self._keys), "shuffle": self.shuffle,
                "world_size": self.world_size, "rank": self.rank,
                "num_workers": self.num_workers}

    def _mx_fast_forward(self, epoch: int, batches_done: int,
                         cursor: Optional[dict] = None) -> None:
        """Cursor resume: position the stream at ``(epoch,
        batches_done)`` WITHOUT decoding the skipped batches — the
        partition is a pure function, so the skip is free. ``cursor``
        (the manifest's, when present) is validated: a resume against a
        different dataset/seed/batch size would silently train on the
        wrong stream; a different worker count or world just
        re-partitions (the elastic path) and is logged."""
        if cursor:
            if int(cursor.get("version", CURSOR_VERSION)) > CURSOR_VERSION:
                raise MXNetError(
                    "data: checkpoint loader cursor version %r is newer "
                    "than this loader (%d)"
                    % (cursor.get("version"), CURSOR_VERSION))
            for field, mine in (("seed", self.seed),
                                ("batch_size", self.batch_size),
                                ("num_records", len(self._keys)),
                                ("shuffle", self.shuffle)):
                theirs = cursor.get(field)
                if theirs is not None and theirs != mine:
                    raise MXNetError(
                        "data: resume cursor mismatch on %s (checkpoint "
                        "%r vs loader %r) — this is not the stream the "
                        "interrupted run was consuming" % (field, theirs,
                                                           mine))
            if cursor.get("num_workers") not in (None, self.num_workers):
                log.info(
                    "data: resuming with %d workers (checkpoint ran "
                    "%s) — shard ranges re-partitioned, stream order "
                    "unchanged", self.num_workers,
                    cursor.get("num_workers"))
            if cursor.get("world_size") not in (None, self.world_size):
                log.warning(
                    "data: resuming on a world of %d (checkpoint ran "
                    "%s) — per-host streams re-stride from this batch "
                    "on", self.world_size, cursor.get("world_size"))
        self._teardown()
        self._epoch = int(epoch)
        self._start_batch = max(0, int(batches_done))

    # ------------------------------------------------------------ lifecycle
    @property
    def epoch(self) -> int:
        return self._epoch

    @property
    def batches_per_epoch(self) -> int:
        plan = self._plan or self._make_plan()
        return plan.num_batches

    def close(self):
        if self._closed:
            return
        self._closed = True
        self._teardown()
        try:
            self._rec.close()
        except Exception:                              # noqa: BLE001
            pass

    def __del__(self):
        try:
            self.close()
        except Exception:                              # noqa: BLE001
            pass
