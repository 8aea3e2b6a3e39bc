"""Checkpoint scheduling: snapshot capture, the background writer, and
exact-resume payloads.

The port's copy of the reference's ``checkpoint/manager.py``. A save has
two phases of very different cost (CheckFreq): the snapshot, on the
training thread at a step boundary, and the serialization (device to
host copy, checksums, npz, fsync), handed to a bounded background writer
thread. The port updates its parameters and optimizer states in place,
so the snapshot clones every tensor on its device (one device copy
each, queued on the stream, no host wait) before the next step writes
them; the writer's host copy is queued on the same stream, behind the
clones and whatever steps the training thread queued before it. The
``ckpt_block_us`` and ``ckpt_write_us`` counters measure the two phases.

``CheckpointManager.save_module`` captures what exact resume needs
(``Module._checkpoint_snapshot``: parameters, aux states, optimizer
states and update counts, the key chain of :mod:`..random`, torch's
generators), the loop position and the metric totals;
:func:`restore_latest` returns a :class:`Checkpoint` that
``Module.fit(resume_from=...)`` replays. The PRNG keys are the numpy
uint32 pairs of :mod:`..random`, the arrays the reference's
``key_to_array`` writes, so ``rng:global_key`` crosses packages.
"""
from __future__ import annotations

import errno as _errno
import logging
import os
import queue as _queue_mod
import threading
import time
from typing import Any, Callable, Dict, Optional

import numpy as np

from .. import lockcheck as _lockcheck
from .. import profiler as _profiler
from . import format as _format
from .format import CheckpointError

__all__ = [
    "CheckpointConfig", "CheckpointManager", "Checkpoint",
    "restore_latest", "restore_global_rng",
    "tree_encode", "tree_decode", "key_to_array", "array_to_key",
]

log = logging.getLogger(__name__)


# -------------------------------------------------- state-tree utilities

def tree_encode(prefix: str, tree, tensors: Dict[str, Any],
                grab: Callable[[Any], Any]):
    """Flatten an optimizer-state tree (None | array | nested tuples)
    into ``tensors`` under dotted keys; returns the JSON-able structure
    that :func:`tree_decode` rebuilds from."""
    if tree is None:
        return None
    if isinstance(tree, tuple):
        return ["tuple", [tree_encode("%s.%d" % (prefix, i), t, tensors,
                                      grab)
                          for i, t in enumerate(tree)]]
    tensors[prefix] = grab(tree)
    return "leaf"


def tree_decode(prefix: str, structure, tensors: Dict[str, Any],
                leaf: Callable[[Any], Any]):
    if structure is None:
        return None
    if structure == "leaf":
        return leaf(tensors[prefix])
    return tuple(tree_decode("%s.%d" % (prefix, i), s, tensors, leaf)
                 for i, s in enumerate(structure[1]))


def key_to_array(key) -> np.ndarray:
    """The raw uint32 words of a key of the chain."""
    return np.asarray(key, dtype=np.uint32).copy()


def array_to_key(arr) -> np.ndarray:
    return np.asarray(arr, dtype=np.uint32).reshape(2).copy()


# ----------------------------------------------------------- the config

class CheckpointConfig(object):
    """Declarative checkpoint policy for ``Module.fit(checkpoint=...)``.

    ``directory`` holds the ``ckpt-<step>`` directories. Saves come at
    the end of every ``period_epochs``-th epoch and, with
    ``every_n_batches``, every N batches mid-epoch. ``keep_last`` (default
    the ``MXNET_TPU_CKPT_KEEP`` knob; 0 keeps all) and ``keep_every``
    bound retention. ``async_save`` (default the ``MXNET_TPU_CKPT_ASYNC``
    knob) hands the write to the background thread; ``queue_depth``
    bounds the snapshots waiting for it (each pins one copy of the
    state). ``save_on_sigterm``: during ``fit`` a SIGTERM finishes the
    batch, saves synchronously and exits with status 143.
    ``verify_on_load`` checks every crc32 on resume; ``store_symbol``
    records the symbol's JSON. ``write_retries`` (default the
    ``MXNET_TPU_CKPT_WRITE_RETRIES`` knob) retries a write that failed
    with EIO, ENOSPC or EINTR, after ``retry_backoff`` seconds, doubled
    per attempt."""

    def __init__(self, directory: str, period_epochs: int = 1,
                 every_n_batches: Optional[int] = None,
                 keep_last: Optional[int] = None,
                 keep_every: Optional[int] = None,
                 async_save: Optional[bool] = None,
                 save_on_sigterm: bool = True,
                 verify_on_load: bool = True,
                 store_symbol: bool = True,
                 queue_depth: int = 2,
                 write_retries: Optional[int] = None,
                 retry_backoff: float = 0.25):
        self.directory = str(directory)
        self.period_epochs = int(period_epochs)
        self.every_n_batches = None if every_n_batches is None \
            else int(every_n_batches)
        self.keep_last = keep_last
        self.keep_every = keep_every
        self.async_save = async_save
        self.save_on_sigterm = bool(save_on_sigterm)
        self.verify_on_load = bool(verify_on_load)
        self.store_symbol = bool(store_symbol)
        self.queue_depth = max(1, int(queue_depth))
        self.write_retries = write_retries
        self.retry_backoff = max(0.0, float(retry_backoff))

    @classmethod
    def coerce(cls, obj) -> "CheckpointConfig":
        if isinstance(obj, cls):
            return obj
        if isinstance(obj, (str, os.PathLike)):
            return cls(os.fspath(obj))
        raise TypeError("checkpoint= accepts a directory path or a "
                        "CheckpointConfig, got %r" % (obj,))

    # knob-backed defaults resolve at use time, not construction time
    def resolved_keep_last(self) -> int:
        if self.keep_last is not None:
            return int(self.keep_last)
        from .. import config as _config
        return int(_config.get("MXNET_TPU_CKPT_KEEP"))

    def resolved_async(self) -> bool:
        if self.async_save is not None:
            return bool(self.async_save)
        from .. import config as _config
        return bool(_config.get("MXNET_TPU_CKPT_ASYNC"))

    def resolved_write_retries(self) -> int:
        if self.write_retries is not None:
            return max(0, int(self.write_retries))
        from .. import config as _config
        return max(0, int(_config.get("MXNET_TPU_CKPT_WRITE_RETRIES")))


# ---------------------------------------------------------- the payload

class Checkpoint(object):
    """A loaded checkpoint: verified host tensors and the manifest, with
    what ``fit(resume_from=...)`` reads."""

    def __init__(self, path: str, tensors: Dict[str, Any],
                 manifest: Dict[str, Any]):
        self.path = path
        self.tensors = tensors
        self.manifest = manifest

    @property
    def step(self) -> int:
        return int(self.manifest.get("step", 0))

    @property
    def meta(self) -> Dict[str, Any]:
        return self.manifest.get("meta", {})

    @property
    def loop(self) -> Dict[str, Any]:
        return self.meta.get("loop") or {}

    @property
    def epoch(self) -> Optional[int]:
        e = self.loop.get("epoch")
        return None if e is None else int(e)

    @property
    def batches_done(self) -> Optional[int]:
        b = self.loop.get("batches_done")
        return None if b is None else int(b)

    @property
    def mid_epoch(self) -> bool:
        return self.batches_done is not None

    @property
    def resume_epoch(self) -> int:
        """The first epoch a resumed run executes: the saved one when the
        save was mid-epoch, the next one otherwise."""
        if self.epoch is None:
            return 0
        return self.epoch if self.mid_epoch else self.epoch + 1

    @property
    def metric_state(self):
        return self.meta.get("metric")

    @property
    def data_cursor(self) -> Optional[dict]:
        """The data loader's cursor saved with this checkpoint
        (``meta["loop"]["data"]``): the position and the stream-identity
        fields (seed, batch size, record count) a resuming
        ``data.DataLoader`` checks before it seeks. None for a checkpoint
        written without a cursor-capable iterator."""
        cur = self.loop.get("data")
        return dict(cur) if cur else None

    def _named(self, prefix: str, names_key: str) -> Dict[str, Any]:
        names = self.meta.get(names_key)
        if names is None:
            names = [k[len(prefix):] for k in self.tensors
                     if k.startswith(prefix)]
        return {n: self.tensors[prefix + n] for n in names
                if prefix + n in self.tensors}

    def arg_params(self) -> Dict[str, Any]:
        return self._named("arg:", "param_names")

    def aux_params(self) -> Dict[str, Any]:
        return self._named("aux:", "aux_names")

    @staticmethod
    def _nd(values):
        import torch
        from ..ndarray import NDArray
        # at the saved dtype, on the host: bind copies them to the device
        return {k: NDArray(v if isinstance(v, torch.Tensor)
                           else torch.from_numpy(np.array(v)))
                for k, v in values.items()}

    def arg_params_nd(self):
        return self._nd(self.arg_params())

    def aux_params_nd(self):
        return self._nd(self.aux_params())


def restore_latest(directory: str, verify: bool = True) -> Checkpoint:
    """The newest valid checkpoint under ``directory`` (corrupt ones are
    skipped with a warning) as a :class:`Checkpoint`."""
    path, tensors, manifest = _format.load_latest(directory, verify=verify)
    return Checkpoint(path, tensors, manifest)


def restore_global_rng(ckpt: Checkpoint) -> None:
    """Reset the key chain of :mod:`..random` to the snapshot's."""
    raw = ckpt.tensors.get("rng:global_key")
    if raw is None:
        return
    from .. import random as _random
    _random.set_key(array_to_key(raw))


# ---------------------------------------------------------- the manager

class CheckpointManager(object):
    """Owns one checkpoint directory: the bounded async writer,
    retention, the SIGTERM hook, and the ``ckpt_*`` counters."""

    def __init__(self, config):
        self.config = CheckpointConfig.coerce(config)
        self._queue: Optional[_queue_mod.Queue] = None
        self._thread: Optional[threading.Thread] = None
        self._last_error: Optional[BaseException] = None
        self._preempt = False
        self._closed = False
        self._lock = _lockcheck.Lock(name="checkpoint.manager_lock")
        self._seq: Optional[int] = None

    @property
    def last_error(self) -> Optional[BaseException]:
        return self._last_error

    @property
    def preempt_requested(self) -> bool:
        return self._preempt

    def request_preempt(self) -> None:
        """Ask the fit loop to checkpoint and exit at the next batch
        boundary (what the SIGTERM hook calls)."""
        self._preempt = True

    def install_sigterm(self) -> Optional[Callable[[], None]]:
        """Install the preemption hook; returns an uninstaller (None when
        it cannot be installed: not the main thread)."""
        import signal

        if threading.current_thread() is not threading.main_thread():
            return None
        prev = signal.getsignal(signal.SIGTERM)

        def _handler(_signum, _frame):
            # set one flag and return: taking a lock here could deadlock
            # against the frame the signal interrupted
            self.request_preempt()

        try:
            signal.signal(signal.SIGTERM, _handler)
        except (ValueError, OSError):
            return None

        def _restore():
            try:
                signal.signal(signal.SIGTERM, prev)
            except (ValueError, OSError, TypeError):
                pass

        return _restore

    def preempt_save(self, module, epoch: Optional[int] = None,
                     batches_done: Optional[int] = None,
                     metric=None, loader_state: Optional[dict] = None
                     ) -> None:
        """The preemption path: drain the pending saves, write the final
        checkpoint synchronously, stop the writer. An earlier async
        failure (already logged and counted) does not stop it."""
        _profiler.incr_counter("ckpt_sigterm")
        bb = _profiler.blackbox()
        if bb is not None:
            # observed-flag context (the training thread), never the
            # signal handler itself
            bb.record("ckpt", "preempt-save", epoch=epoch,
                      batches_done=batches_done)
        self.wait()
        self.save_module(module, epoch=epoch, batches_done=batches_done,
                         metric=metric, loader_state=loader_state,
                         sync=True)
        if self._last_error is not None:
            log.error("preemption save landed, but an earlier async "
                      "checkpoint write had failed: %s", self._last_error)
        self.close(raise_errors=False)

    # ------------------------------------------------------------ saving
    def save_module(self, module, epoch: Optional[int] = None,
                    batches_done: Optional[int] = None, metric=None,
                    loader_state: Optional[dict] = None,
                    sync: Optional[bool] = None) -> int:
        """Snapshot ``module`` with the loop position, the loader's
        cursor (``loader_state``) and the metric totals, and schedule the
        write; returns the checkpoint's step."""
        t0 = time.perf_counter()
        snap = getattr(module, "_checkpoint_snapshot", None)
        if snap is None:
            raise CheckpointError(
                "%s does not implement _checkpoint_snapshot; checkpointing "
                "requires mt.mod.Module" % type(module).__name__)
        # the cheap on-thread phase, visible on the caller's (training)
        # lane next to the step slices
        with _profiler.span("ckpt_snapshot", "ckpt"):
            tensors, meta = snap()
        meta["loop"] = {"epoch": epoch, "batches_done": batches_done}
        if loader_state is not None:
            meta["loop"]["data"] = dict(loader_state)
        if metric is not None:
            state_fn = getattr(metric, "_ckpt_state", None)
            meta["metric"] = state_fn() if state_fn is not None else None
        if self.config.store_symbol and \
                getattr(module, "symbol", None) is not None:
            try:
                meta["symbol"] = module.symbol.tojson()
            except Exception:                              # noqa: BLE001
                pass     # provenance only: never fail a save over it
        step = int(meta.get("step", 0))
        if "optimizer" not in meta:
            # no update count to name the step: a monotonic sequence per
            # directory, or the one-state-per-step rule would drop every
            # save after the first
            if self._seq is None:
                existing = _format.list_checkpoints(self.config.directory)
                self._seq = max([s for s, _ in existing] or [0])
            self._seq = max(self._seq + 1, step)
            step = self._seq
            meta["step"] = step
        bb = _profiler.blackbox()
        if bb is not None:
            bb.record("ckpt", "save", step=step, epoch=epoch,
                      batches_done=batches_done)
        self._submit(step, tensors, meta, t0, sync=sync)
        return step

    def save(self, tensors: Dict[str, Any], meta: Dict[str, Any],
             step: int, sync: Optional[bool] = None) -> None:
        """Save an arbitrary tensor dict (``fit`` uses
        :meth:`save_module`)."""
        self._submit(int(step), dict(tensors), dict(meta),
                     time.perf_counter(), sync=sync)

    def _submit(self, step, tensors, meta, t0, sync=None) -> None:
        if self._closed:
            raise CheckpointError("CheckpointManager is closed")
        use_async = not sync if sync is not None \
            else self.config.resolved_async()
        if use_async:
            q = self._ensure_writer()
            if q.full():
                _profiler.incr_counter("ckpt_backpressure_wait")
            q.put((step, tensors, meta))
            _profiler.set_gauge("ckpt_queue_depth", q.qsize())
            _profiler.incr_counter("ckpt_save_async")
        else:
            self._write_one(step, tensors, meta)
            _profiler.incr_counter("ckpt_save_sync")
        block_us = int((time.perf_counter() - t0) * 1e6)
        _profiler.incr_counter("ckpt_block_us", block_us)
        _profiler.set_gauge("ckpt_last_block_ms", block_us / 1000.0)

    # ------------------------------------------------------------ writer
    def _ensure_writer(self) -> _queue_mod.Queue:
        with self._lock:
            if self._queue is None:
                self._queue = _queue_mod.Queue(
                    maxsize=self.config.queue_depth)
                self._thread = threading.Thread(
                    target=self._writer_loop, name="ckpt-writer",
                    daemon=True)
                self._thread.start()
            return self._queue

    def _writer_loop(self) -> None:
        _profiler.register_thread_lane("ckpt-writer")
        q = self._queue
        while True:
            item = q.get()
            try:
                if item is None:
                    return
                self._write_one(*item)
            except BaseException as exc:                   # noqa: BLE001
                # an async failure must not kill training; it is counted,
                # logged and raised again at close()
                if self._last_error is None:
                    self._last_error = exc
                _profiler.incr_counter("ckpt_write_failed")
                log.error("async checkpoint write failed: %s", exc)
                bb = _profiler.blackbox()
                if bb is not None:
                    bb.record("ckpt", "write-failed",
                              error=str(exc)[:500])
                    bb.flush("ckpt-write-failed")
            finally:
                _profiler.set_gauge("ckpt_queue_depth", q.qsize())
                q.task_done()

    # errors a retry can outlive: a flaky device (EIO), space that GC
    # may have freed (ENOSPC), an interrupted call (EINTR)
    _TRANSIENT_ERRNO = frozenset(
        (_errno.EIO, _errno.ENOSPC, _errno.EINTR))

    def _write_one(self, step, tensors, meta) -> None:
        t0 = time.perf_counter()
        retries = self.config.resolved_write_retries()
        with _profiler.span("ckpt_write", "ckpt"):
            for attempt in range(retries + 1):
                try:
                    path = _format.write_checkpoint(
                        self.config.directory, step, tensors, meta)
                    break
                except OSError as exc:
                    # write_checkpoint removed its .tmp-*: a retry starts
                    # clean
                    if exc.errno not in self._TRANSIENT_ERRNO \
                            or attempt >= retries:
                        raise
                    _profiler.incr_counter("ckpt_write_retry")
                    delay = self.config.retry_backoff * (2 ** attempt)
                    log.warning(
                        "checkpoint write hit transient %s (attempt %d/%d);"
                        " retrying in %.2fs",
                        _errno.errorcode.get(exc.errno, exc.errno),
                        attempt + 1, retries + 1, delay)
                    if delay:
                        time.sleep(delay)
        try:
            nbytes = os.path.getsize(os.path.join(path,
                                                  _format.ARRAYS_NAME))
        except OSError:
            nbytes = 0
        _format.collect_garbage(self.config.directory,
                                self.config.resolved_keep_last(),
                                self.config.keep_every)
        write_us = int((time.perf_counter() - t0) * 1e6)
        _profiler.incr_counter("ckpt_saved")
        _profiler.incr_counter("ckpt_bytes", nbytes)
        _profiler.incr_counter("ckpt_write_us", write_us)
        _profiler.set_gauge("ckpt_last_write_ms", write_us / 1000.0)
        bb = _profiler.blackbox()
        if bb is not None:
            bb.record("ckpt", "committed", step=step,
                      write_ms=round(write_us / 1000.0, 1), bytes=nbytes)

    # --------------------------------------------------------- lifecycle
    def wait(self) -> None:
        """Block until every queued save reached disk."""
        if self._queue is not None:
            self._queue.join()

    def close(self, raise_errors: bool = True) -> None:
        """Drain the queue, stop the writer and (by default) raise the
        first async write failure: a run must not end believing in
        checkpoints that never reached the disk."""
        if not self._closed:
            self._closed = True
            if self._thread is not None:
                self._queue.join()
                self._queue.put(None)
                self._thread.join(timeout=300.0)
        if raise_errors and self._last_error is not None:
            raise CheckpointError(
                "checkpoint write failed: %s" % self._last_error
            ) from self._last_error
