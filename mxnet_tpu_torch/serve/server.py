"""Serving on the port: ``InferenceServer`` and ``GenerativeServer``.

Counterpart of the reference package's ``serve/server.py``.

``InferenceServer`` is the dynamic batcher over one model (a
:class:`~..predictor.Predictor`, a ``Module``, a Gluon ``Block`` or any
callable): concurrent callers ``submit()`` single requests and get
futures; a bounded queue coalesces them into micro-batches under a
``max_batch_size`` / ``max_delay_us`` window; every batch is padded onto
the finite pow2 bucket grid (:mod:`.bucketing`), so the per-bucket
runner set is finite and steady state serving adds no entry; results
are split back per request after one fetch to the host, which is also
the device sync, so recorded latency is real. Per-request deadlines
(``DeadlineExceeded``), admission control (``QueueFull``), graceful
drain on ``close``, and the ``MXNET_TPU_SERVE`` kill switch: with it
off, or after a bucket geometry's batched run failed structurally
(``_fused.structural_failure``), requests run one by one on the same
model and device, each counted (``<name>_eager``, and
``<name>_fallback`` for a failed geometry's).

``GenerativeServer`` is continuous-batching autoregressive decode: the
same scheduler as the reference (iteration-level joins under a prefill
token budget, immediate eviction, TTFT deadlines, load shedding,
graceful drain), the same handle, errors, counters, gauges and
``stats()`` schema, over the port's :class:`~.decode.DecodeEngine` and
:class:`~.kv_cache.KVCache` (f32 or int8) on a torch device.

Observability (:mod:`..obs`): both servers start a Prometheus
``/metrics`` endpoint from their ``metrics_port`` argument or the
``MXNET_TPU_OBS_METRICS_PORT`` knob (a port that cannot be bound leaves
the server up without one, counted as ``<name>_metrics_bind_failed``);
``InferenceServer`` records each request's trace flow through the
``serve_submit`` (the client's lane) → ``serve_coalesce`` →
``serve_launch`` → ``serve_resolve`` spans (the batcher's lane), the
launch under the compile scope of its bucket, whose first bind lands in
the compile ring. Not ported yet: the tensor-parallel cache (A9).
"""
from __future__ import annotations

import collections
import threading
import time
import weakref
from concurrent.futures import Future
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import faults as _faults
from .. import lockcheck as _lockcheck
from .. import ndarray as nd_mod
from .. import profiler as _profiler
from .._fused import CompileCache, structural_failure
from ..base import MXNetError
from ..context import DeviceLike, resolve_device
from .bucketing import BucketSpec
from .stats import DecodeLatencyStats, LatencyStats, monotonic

__all__ = ["InferenceServer", "GenerativeServer", "GenerateHandle",
           "ServeError", "ServerClosed", "QueueFull", "DeadlineExceeded",
           "wrap_model"]

# per-bucket stats table bound; the tail aggregates under "(other)"
_MAX_BUCKET_STATS = 1024


class ServeError(MXNetError):
    """Base class for serving errors."""


class ServerClosed(ServeError):
    """submit after close()."""


class QueueFull(ServeError):
    """Load shed: the admission bound was exceeded (clients should back
    off / retry against another replica)."""


class DeadlineExceeded(ServeError):
    """The request's deadline passed before its batch launched (before
    its prefill, for ``GenerativeServer``)."""


def _start_metrics(server, name: str, metrics_port: Optional[int]) -> None:
    """The opt-in ``/metrics`` endpoint (the argument wins over the
    ``MXNET_TPU_OBS_METRICS_PORT`` knob; a resolved port < 0 is off).
    An observability port must never take the serving path down: a port
    that cannot be bound leaves the server without an endpoint, loudly
    and counted. A finalizer releases the port when an unclosed server
    is collected."""
    from ..obs.http import maybe_start_from_knob
    try:
        metrics = maybe_start_from_knob(metrics_port)
    except OSError as exc:
        import logging
        logging.getLogger(__name__).warning(
            "serve[%s]: /metrics endpoint disabled (%s)", name, exc)
        _profiler.incr_counter(name + "_metrics_bind_failed")
        metrics = None
    server._metrics = metrics
    server.metrics_port = metrics.port if metrics else None
    server._metrics_finalizer = weakref.finalize(
        server, metrics.close) if metrics else None


def _stop_metrics(server) -> None:
    if server._metrics_finalizer is not None:
        server._metrics_finalizer()  # idempotent: detaches after one call
        server._metrics = None


def wrap_model(model) -> Callable:
    """Normalize the served model to ``fn(NDArray batch) -> outputs``.

    Accepts a :class:`~..predictor.Predictor` (single declared input), a
    bound ``Module``, a Gluon ``Block``, or any callable taking an
    NDArray batch. Batch geometry varies per call (the bucket grid):
    the Predictor and Module paths run their executor on the batch in
    place of the bound input (``Executor.forward_inputs``), which they
    leave as it was, so a later direct ``forward`` at the declared
    geometry still returns its own rows.

    Ownership: serving a Predictor/Module hands its executor to the
    server (all server-side calls are serialized by the model lock). Do
    NOT call ``forward``/``set_input`` on it from other threads WHILE it
    is being served — direct use is safe again after ``close()``.
    """
    from ..module.base_module import BaseModule
    from ..module.module import Module
    from ..predictor import Predictor

    if isinstance(model, Predictor):
        names = sorted(model._input_shapes)
        if len(names) != 1:
            raise ValueError(
                "serve: Predictor has inputs %s; the dynamic batcher "
                "coalesces a single request tensor — wrap multi-input "
                "models in a callable" % (names,))
        name = names[0]

        def predictor_fn(x):
            return list(model._exec.forward_inputs(False, {name: x.data}))

        return predictor_fn
    if isinstance(model, Module):
        if len(model._data_names) != 1:
            raise ValueError(
                "serve: Module has inputs %s; the dynamic batcher "
                "coalesces a single request tensor — wrap multi-input "
                "models in a callable" % (model._data_names,))
        name = model._data_names[0]

        def module_fn(x):
            return list(model._exec.forward_inputs(False, {name: x.data}))

        return module_fn
    if isinstance(model, BaseModule):
        from .. import io as io_mod

        def base_module_fn(x):
            model.forward(io_mod.DataBatch(data=[x]), is_train=False)
            return list(model.get_outputs())

        return base_module_fn
    if callable(model):
        return model
    raise TypeError("serve: cannot wrap %r — expected Predictor, Module, "
                    "gluon Block, or callable" % (type(model).__name__,))


def _to_host(out) -> np.ndarray:
    """An NDArray, tensor or array as host numpy (for a model output on
    the card, the fetch is the device sync)."""
    if isinstance(out, nd_mod.NDArray):
        out = out.data
    if isinstance(out, torch.Tensor):
        return out.detach().cpu().numpy()
    return np.asarray(out)


def _resolve(fut: Future, value=None, exc: Optional[BaseException] = None):
    """Complete a future, tolerating caller-side cancel(): a cancelled
    future must never kill the batcher thread."""
    try:
        if exc is not None:
            fut.set_exception(exc)
        else:
            fut.set_result(value)
    except Exception:                                       # noqa: BLE001
        pass


def _serve_loop(server_ref):
    """Batcher thread body. While IDLE it sleeps holding only the
    server's condition variable, never the server itself — so an
    abandoned (un-closed) server is garbage-collectable and the thread
    exits on its next wake. While a batch is pending it holds the server
    normally."""
    while True:
        srv = server_ref()
        if srv is None:
            return
        cond = srv._cond
        queue = srv._queue          # stable identity (mutated in place)
        with cond:
            has_work = bool(queue)
            closed = srv._closed
        if not has_work:
            if closed:
                return
            srv = None              # the idle sleep must not pin the server
            with cond:
                if not queue:       # re-check under the lock: a submit
                    cond.wait(0.05)  # in the gap must not lose its wakeup
            continue
        try:
            batch = srv._take_batch()
            if batch is None:
                return
            if batch:
                srv._run_batch(batch)
        except Exception:                                  # noqa: BLE001
            # the batcher must never die: _run_batch routes errors into
            # the affected futures; an escape is a bug, but killing the
            # worker would turn it into a silent hang for every later
            # request
            pass
        del srv


class _Request:
    __slots__ = ("data", "rows", "batched", "sample_shape", "bucket_key",
                 "future", "t_submit", "deadline", "flow")

    def __init__(self, data, rows, batched, sample_shape, bucket_key,
                 deadline, flow=None):
        self.data = data
        self.rows = rows
        self.batched = batched
        self.sample_shape = sample_shape
        self.bucket_key = bucket_key
        self.future: Future = Future()
        self.t_submit = monotonic()
        self.deadline = deadline
        self.flow = flow    # trace flow id linking submit -> resolve


class InferenceServer:
    """Thread-safe dynamic-batching server over one model.

    Parameters
    ----------
    model : Predictor | Module | Block | callable
        Forward function taking an NDArray batch (leading row axis) and
        returning an NDArray (or tensor) or a list of them with the same
        leading row count. Inference must be row-independent (eval-mode
        nets are): padded rows must not bleed into real ones.
    max_batch_size, max_delay_us, queue_bound : int, optional
        Coalescing row bound, batching window, and admission bound.
        Defaults come from the ``MXNET_TPU_SERVE_*`` knobs.
    buckets : BucketSpec, optional
        Full bucket control (explicit ladders, dynamic seq axis). When
        given, ``max_batch_size`` must be left None — the spec owns it.
    ctx : Context, optional
        Device requests are staged to: the card by default (raises
        without a GPU), the CPU only when asked for.
    name : str
        Prefix for profiler counters/gauges (default ``"serve"``).
    metrics_port : int, optional
        Opt-in Prometheus ``/metrics`` endpoint (:mod:`..obs`): ``None``
        = the ``MXNET_TPU_OBS_METRICS_PORT`` knob, ``-1`` = off, ``0`` =
        an ephemeral port (read ``.metrics_port``), ``>0`` = that port.
    """

    def __init__(self, model, max_batch_size: Optional[int] = None,
                 max_delay_us: Optional[int] = None,
                 queue_bound: Optional[int] = None,
                 buckets: Optional[BucketSpec] = None,
                 ctx: DeviceLike = None,
                 name: str = "serve",
                 metrics_port: Optional[int] = None):
        from .. import config as _config
        if buckets is not None and max_batch_size is not None:
            raise ValueError("pass max_batch_size or buckets, not both")
        if buckets is None:
            buckets = BucketSpec(max_batch_size if max_batch_size is not None
                                 else _config.get("MXNET_TPU_SERVE_MAX_BATCH"))
        self.buckets = buckets
        self.max_delay_s = (max_delay_us if max_delay_us is not None else
                            _config.get("MXNET_TPU_SERVE_MAX_DELAY_US")) * 1e-6
        self.queue_bound = (queue_bound if queue_bound is not None else
                            _config.get("MXNET_TPU_SERVE_QUEUE_BOUND"))
        self.name = name
        self._ctx = resolve_device(ctx)
        self._model = wrap_model(model)
        self._single_output: Optional[bool] = None
        # sig -> padded-dispatch runner; counters ride the shared
        # CompileCache scheme (<name>_compile / _cache_hit / ...), so
        # "zero recompiles after warmup" is a counter assertion. The
        # table holds the WHOLE bucket grid (4x headroom for dtypes)
        grid = self.buckets.executable_bound()
        self.cache = CompileCache(
            name, max_entries=max(4 * grid, 128) if grid else 4096)
        # latency rides the shared histogram registry, so the /metrics
        # exposition renders it without extra wiring
        self.latency = LatencyStats(name=name + "_latency_seconds")
        _start_metrics(self, name, metrics_port)
        # serializes ALL model invocations: Predictor/Module adapters
        # share executor state, so a kill-switch eager call in a caller
        # thread must never interleave with the worker's batched call.
        # allow_sync: _call_model fetches outputs under it by design
        self._model_lock = _lockcheck.Lock(name="serve.model_lock",
                                           allow_sync=True)
        self._lock = _lockcheck.Lock(name="serve.queue_lock")
        self._cond = _lockcheck.Condition(self._lock)
        self._queue: collections.deque = collections.deque()
        self._closed = False
        self._batches = 0
        self._served = 0
        self._padded_rows = 0
        self._per_bucket: Dict[Tuple, Dict[str, int]] = {}
        # the loop holds only a WEAK reference between iterations: a
        # server dropped without close() must be collectable, and its
        # thread exits on the first wake after GC
        self._worker = threading.Thread(
            target=_serve_loop, args=(weakref.ref(self),), daemon=True,
            name="mxnet_tpu_torch.serve[%s]" % name)
        self._worker.start()

    # ------------------------------------------------------------ submit
    def submit(self, data, batched: bool = False,
               timeout: Optional[float] = None) -> Future:
        """Enqueue one request; returns a ``concurrent.futures.Future``.

        ``data`` is one sample (no batch dim) by default; with
        ``batched=True`` its leading axis is rows and the result keeps
        it. The future resolves with host numpy arrays (row views of
        the batch's one fetch). ``timeout`` (seconds) is the request
        deadline: if its batch has not launched by then the future
        fails with :class:`DeadlineExceeded`.

        Raises :class:`QueueFull` (load shed) at the admission bound,
        :class:`ServerClosed` after ``close()``.
        """
        from .. import config as _config
        if _faults.ARMED:
            # an injected submit failure surfaces on THIS request only
            _faults.fire("serve.submit", default_kind="raise")
        x = _to_host(data)
        if batched:
            if x.ndim < 1:
                raise ValueError("batched request needs a leading row axis")
            rows, sample_shape = int(x.shape[0]), tuple(x.shape[1:])
            if rows > self.buckets.max_batch_size:
                raise ValueError(
                    "request of %d rows exceeds max_batch_size %d — split "
                    "it client-side" % (rows, self.buckets.max_batch_size))
        else:
            rows, sample_shape = 1, tuple(x.shape)
        # admission-time shape validation: over-long dynamic axes fail
        # in the caller, not in the batcher thread
        padded_sample = self.buckets.sample_bucket(sample_shape)
        bucket_key = (padded_sample, str(x.dtype))
        deadline = None if timeout is None else monotonic() + timeout

        if self._closed:
            raise ServerClosed("submit() after close()")
        if not _config.get("MXNET_TPU_SERVE"):
            # kill switch: per-request eager forward in the caller
            # thread — no queue, no batching, no bucketing
            return self._eager_future(x, rows, batched)

        fid = _profiler.new_flow() if _profiler.spans_enabled() else None
        req = _Request(x, rows, batched, sample_shape, bucket_key, deadline,
                       flow=fid)
        with _profiler.span("serve_submit", "serve", flow=fid):
            with self._cond:
                if self._closed:
                    raise ServerClosed("submit() after close()")
                if len(self._queue) >= self.queue_bound:
                    _profiler.incr_counter(self.name + "_shed")
                    raise QueueFull("queue depth %d at admission bound %d"
                                    % (len(self._queue), self.queue_bound))
                self._queue.append(req)
                _profiler.set_gauge(self.name + "_queue_depth",
                                    len(self._queue))
                self._cond.notify_all()
        return req.future

    def __call__(self, data, batched: bool = False,
                 timeout: Optional[float] = None):
        """Blocking convenience: ``submit(...).result()``."""
        return self.submit(data, batched=batched, timeout=timeout).result()

    # ------------------------------------------------------------- close
    def close(self, drain: bool = True, timeout: Optional[float] = None):
        """Stop accepting requests. ``drain=True`` (default) serves
        everything already queued before the worker exits; ``False``
        fails queued requests with :class:`ServerClosed`. Idempotent:
        a second close only joins — it must not drop requests a prior
        ``close(drain=True)`` promised to serve."""
        with self._cond:
            already = self._closed
            self._closed = True
            if already:
                drain = True        # first close's promise stands
            if not drain:
                dropped = list(self._queue)
                self._queue.clear()
            else:
                dropped = []
            self._cond.notify_all()
        for req in dropped:
            _resolve(req.future, exc=ServerClosed("server closed"))
        self._worker.join(timeout)
        _stop_metrics(self)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close(drain=not any(exc))
        return False

    # ------------------------------------------------------------- stats
    def stats(self) -> Dict[str, Any]:
        """Point-in-time serving snapshot (thread-safe), the reference's
        schema."""
        with self._lock:
            depth = len(self._queue)
            batches, served = self._batches, self._served
            padded = self._padded_rows
            per_bucket = {
                (key if isinstance(key, str)
                 else "%s/%s" % ("x".join(map(str, key[0])), key[1])):
                dict(rec)
                for key, rec in self._per_bucket.items()}
        dispatched = sum(r["rows"] for r in per_bucket.values())
        return {
            "requests": served,
            "batches": batches,
            "queue_depth": depth,
            "avg_batch_rows": round(dispatched / batches, 3) if batches
            else None,
            "occupancy": round(dispatched / (dispatched + padded), 4)
            if dispatched else None,
            "buckets": per_bucket,
            "compiles": _profiler.get_counter(self.name + "_compile"),
            "cache_hits": _profiler.get_counter(self.name + "_cache_hit"),
            "shed": _profiler.get_counter(self.name + "_shed"),
            "deadline_expired": _profiler.get_counter(
                self.name + "_deadline_expired"),
            "eager_fallback": _profiler.get_counter(self.name + "_eager"),
            "latency": self.latency.snapshot(),
        }

    # ----------------------------------------------------------- batcher
    def _take_batch(self) -> Optional[List[_Request]]:
        """Wait (bounded) for a batch: [] when nothing is ready yet
        (caller re-checks liveness and retries), None when the worker
        should exit (closed and drained)."""
        with self._cond:
            if not self._queue:
                if self._closed:
                    return None
                # bounded wait so _serve_loop can drop its strong ref
                # and re-check server liveness between idle ticks
                self._cond.wait(0.05)
                if not self._queue:
                    return None if self._closed else []
            head = self._queue[0]
            t_co = time.perf_counter() if _profiler.spans_enabled() \
                else None
            window_end = head.t_submit + self.max_delay_s
            while not self._closed:
                now = monotonic()
                if now >= window_end:
                    break
                if self._compatible_rows(head.bucket_key) >= \
                        self.buckets.max_batch_size:
                    break
                # a queued deadline must fire ~when promised, not up to
                # a full batching window late: wake at the earliest of
                # window end / next deadline / the 10 ms arrival tick
                dls = [r.deadline for r in self._queue
                       if r.deadline is not None]
                next_dl = min(dls) if dls else None
                if next_dl is not None and now >= next_dl:
                    break
                tick = window_end - now
                if next_dl is not None:
                    tick = min(tick, next_dl - now)
                self._cond.wait(min(tick, 0.01))
            # pop the head's bucket-mates FIFO, honoring the row bound;
            # other buckets keep their queue positions
            batch, rows, kept = [], 0, []
            now = monotonic()
            expired = []
            for req in self._queue:
                if req.future.cancelled():
                    continue
                if req.deadline is not None and now > req.deadline:
                    expired.append(req)
                    continue
                if req.bucket_key == head.bucket_key and \
                        rows + req.rows <= self.buckets.max_batch_size and \
                        req.future.set_running_or_notify_cancel():
                    batch.append(req)
                    rows += req.rows
                else:
                    kept.append(req)
            # in-place: _serve_loop's idle path holds this deque by
            # identity, so the queue object must never be rebound
            self._queue.clear()
            self._queue.extend(kept)
            _profiler.set_gauge(self.name + "_queue_depth",
                                len(self._queue))
        for req in expired:
            _profiler.incr_counter(self.name + "_deadline_expired")
            _resolve(req.future, exc=DeadlineExceeded(
                "deadline passed %.1f ms before batch launch"
                % ((now - req.deadline) * 1e3)))
        if batch and t_co is not None:
            # the batching window on the batcher's lane, linked to the
            # head request's flow (idle ticks emit nothing)
            _profiler.record_span("serve_coalesce", t_co,
                                  time.perf_counter(), "serve",
                                  flow=batch[0].flow)
        return batch

    def _compatible_rows(self, bucket_key) -> int:
        return sum(r.rows for r in self._queue
                   if r.bucket_key == bucket_key)

    # ---------------------------------------------------------- dispatch
    def _call_model(self, x: nd_mod.NDArray) -> List[np.ndarray]:
        """Run the model and fetch each output to the host ONCE, under
        the model lock: per-request splitting is then zero-copy views,
        and the fetch is the device sync, so recorded latency is real."""
        # the lock-held host sync is the design here: all model
        # invocations serialize on _model_lock (shared executor state),
        # and fetching inside it is what makes recorded latency real
        with torch.no_grad():
            with self._model_lock:  # mx-lint: allow(lock-host-sync)
                outs = self._model(x)
                outs = list(outs) if isinstance(outs, (list, tuple)) \
                    else [outs]
                if self._single_output is None:
                    # one output -> callers get the bare array, not a
                    # 1-list
                    self._single_output = len(outs) == 1
                return [_to_host(o) for o in outs]

    def _assemble(self, batch: List[_Request], bucket_rows: int):
        padded_sample = batch[0].bucket_key[0]
        buf = np.full((bucket_rows,) + padded_sample,
                      self.buckets.pad_value, batch[0].data.dtype)
        r0 = 0
        for req in batch:
            block = req.data if req.batched else req.data[None]
            sl = (slice(r0, r0 + req.rows),) + tuple(
                slice(0, d) for d in req.sample_shape)
            buf[sl] = block
            r0 += req.rows
        return buf, r0

    def _run_batch(self, batch: List[_Request]):
        from ..obs import compiles as _obs_compiles
        rows = sum(r.rows for r in batch)
        try:
            bucket_rows = self.buckets.batch_bucket(rows)
            sig = (batch[0].bucket_key, bucket_rows)
            if self.cache.should_skip(sig):
                # negative-cached geometry: its traffic runs eager
                self._fallback_eager(batch)
                return
            buf, _ = self._assemble(batch, bucket_rows)
            # the cached "runner" is always _call_model: PyTorch runs
            # eagerly, so CompileCache supplies the rest of its contract
            # — first-dispatch/hit counters (the zero-recompile
            # observable), bounded-retry negative caching, and the
            # eager-fallback gate
            runner = self.cache.get(sig)
            fresh = runner is None
            if fresh:
                runner = self._call_model
            try:
                with _profiler.span("serve_launch", "serve",
                                    flow=batch[0].flow) as sp:
                    for req in batch[1:]:
                        sp.mark_flow(req.flow)
                    with _obs_compiles.scope(self.name, sig):
                        t0 = time.perf_counter()
                        outs = runner(nd_mod.array(buf, ctx=self._ctx))
                        if fresh:
                            # the bucket's first bind: its first call
                            # (cuDNN's algorithm choice, library loads)
                            _obs_compiles.record(
                                (time.perf_counter() - t0) * 1e3,
                                source="runner")
            except Exception as exc:                       # noqa: BLE001
                self.cache.mark_failed(sig,
                                       permanent=structural_failure(exc))
                self._fallback_eager(batch)
                return
            if fresh:
                self.cache.put(sig, runner)
            else:
                self.cache.note_success(sig)
        except Exception as exc:                           # noqa: BLE001
            for req in batch:
                _resolve(req.future, exc=exc)
            return
        with self._lock:
            self._batches += 1
            self._served += len(batch)
            self._padded_rows += bucket_rows - rows
            # bounded: client-controlled shape sets must not grow the
            # stats table monotonically — the tail aggregates
            key = sig[0]
            if key not in self._per_bucket and \
                    len(self._per_bucket) >= _MAX_BUCKET_STATS:
                key = "(other)"
            rec = self._per_bucket.setdefault(
                key, {"batches": 0, "requests": 0, "rows": 0})
            rec["batches"] += 1
            rec["requests"] += len(batch)
            rec["rows"] += rows
        _profiler.incr_counter(self.name + "_batches")
        _profiler.incr_counter(self.name + "_requests", len(batch))
        _profiler.set_gauge(self.name + "_batch_occupancy",
                            rows / bucket_rows)
        done = monotonic()
        r0 = 0
        try:
            with _profiler.span("serve_resolve", "serve",
                                flow=batch[0].flow) as sp:
                for req in batch:
                    if req is not batch[0]:
                        sp.mark_flow(req.flow)
                    if self._single_output:
                        res = outs[0][r0:r0 + req.rows] if req.batched \
                            else outs[0][r0]
                    else:
                        res = [o[r0:r0 + req.rows] if req.batched
                               else o[r0] for o in outs]
                    r0 += req.rows
                    self.latency.record(done - req.t_submit)
                    _resolve(req.future, res)
        except Exception as exc:                           # noqa: BLE001
            # row-contract violation (output leading axis != input rows):
            # every future must still resolve, and the geometry is
            # structurally broken, so pin it to the eager path, where
            # the same error surfaces per request
            self.cache.mark_failed(sig, permanent=True)
            for req in batch:
                _resolve(req.future, exc=exc)

    # ------------------------------------------------------ eager paths
    def _eager_one(self, x: np.ndarray, batched: bool):
        nd_in = nd_mod.array(x if batched else x[None], ctx=self._ctx)
        outs = self._call_model(nd_in)
        _profiler.incr_counter(self.name + "_eager")
        if self._single_output:
            return outs[0] if batched else outs[0][0]
        return outs if batched else [o[0] for o in outs]

    def _eager_future(self, x, rows, batched) -> Future:
        fut: Future = Future()
        t0 = monotonic()
        try:
            res = self._eager_one(x, batched)
        except Exception as exc:                           # noqa: BLE001
            fut.set_exception(exc)
            return fut
        self.latency.record(monotonic() - t0)
        with self._lock:
            self._served += 1
        fut.set_result(res)
        return fut

    def _fallback_eager(self, batch: List[_Request]):
        """Per-request eager forwards for a batch whose bucketed
        dispatch is unavailable (failed / negative-cached), each counted
        under ``<name>_fallback`` too."""
        done_extra = 0
        for req in batch:
            # same deadline contract as the healthy path
            if req.deadline is not None and monotonic() > req.deadline:
                _profiler.incr_counter(self.name + "_deadline_expired")
                _resolve(req.future, exc=DeadlineExceeded(
                    "deadline passed before eager-fallback dispatch"))
                continue
            try:
                res = self._eager_one(req.data, req.batched)
            except Exception as exc:                       # noqa: BLE001
                _resolve(req.future, exc=exc)
                continue
            _profiler.incr_counter(self.name + "_fallback")
            self.latency.record(monotonic() - req.t_submit)
            _resolve(req.future, res)
            done_extra += 1
        with self._lock:
            self._served += done_extra


# ===================================================================
# Generative serving: continuous batching over the bucketed KV cache
# ===================================================================


class GenerateHandle:
    """Per-request streaming future: tokens arrive as they are decoded.

    Iterate it for streaming (``for tok in handle: ...`` blocks until
    each next token), or call :meth:`result` for the whole sequence.
    ``on_token`` (if given) is invoked from the scheduler thread per
    token — it must be fast and must not call back into the server.
    """

    def __init__(self, on_token: Optional[Callable[[int], None]] = None):
        self._cond = _lockcheck.Condition(name="serve.stream_cond")
        self._tokens: List[int] = []
        self._done = False
        self._exc: Optional[BaseException] = None
        self._on_token = on_token
        self._cancelled = False

    # ------------------------------------------------- scheduler side
    def _put(self, token: int) -> None:
        with self._cond:
            self._tokens.append(int(token))
            self._cond.notify_all()
        if self._on_token is not None:
            try:
                self._on_token(int(token))
            except Exception:                               # noqa: BLE001
                # a client callback must never kill the scheduler
                pass

    def _finish(self, exc: Optional[BaseException] = None) -> None:
        with self._cond:
            if self._done:
                return
            self._done = True
            self._exc = exc
            self._cond.notify_all()

    # ---------------------------------------------------- caller side
    def cancel(self) -> None:
        """Request eviction at the next step boundary."""
        with self._cond:
            self._cancelled = True

    def done(self) -> bool:
        with self._cond:
            return self._done

    @property
    def exception(self) -> Optional[BaseException]:
        with self._cond:
            return self._exc

    def tokens_so_far(self) -> List[int]:
        with self._cond:
            return list(self._tokens)

    def result(self, timeout: Optional[float] = None) -> List[int]:
        """Block until the sequence finishes; the full token list, or
        raises the sequence's error."""
        deadline = None if timeout is None else monotonic() + timeout
        with self._cond:
            while not self._done:
                left = None if deadline is None else deadline - monotonic()
                if left is not None and left <= 0:
                    raise TimeoutError("generation still running after "
                                       "%.1fs" % timeout)
                self._cond.wait(0.1 if left is None else min(left, 0.1))
            if self._exc is not None:
                raise self._exc
            return list(self._tokens)

    def __iter__(self):
        """Stream tokens in decode order; raises the sequence's error
        (if any) after the last streamed token."""
        i = 0
        while True:
            with self._cond:
                while i >= len(self._tokens) and not self._done:
                    self._cond.wait(0.1)
                if i < len(self._tokens):
                    tok = self._tokens[i]
                else:
                    if self._exc is not None:
                        raise self._exc
                    return
            i += 1
            yield tok


class _GenRequest:
    __slots__ = ("prompt", "max_new_tokens", "eos_id", "temperature",
                 "seed", "deadline", "handle", "t_submit")

    def __init__(self, prompt, max_new_tokens, eos_id, temperature, seed,
                 deadline, handle):
        self.prompt = prompt
        self.max_new_tokens = max_new_tokens
        self.eos_id = eos_id
        self.temperature = temperature
        self.seed = seed
        self.deadline = deadline
        self.handle = handle
        self.t_submit = monotonic()


class _ActiveSeq:
    __slots__ = ("slot", "handle", "pos", "generated", "max_new_tokens",
                 "eos_id", "temperature", "rng", "token", "t_last")

    def __init__(self, slot, handle, pos, max_new_tokens, eos_id,
                 temperature, rng, token):
        self.slot = slot
        self.handle = handle
        self.pos = pos                  # next cache write position
        self.generated = 1              # prefill samples the first token
        self.max_new_tokens = max_new_tokens
        self.eos_id = eos_id
        self.temperature = temperature
        self.rng = rng
        self.token = token              # freshest sampled token
        self.t_last = monotonic()


def _gen_loop(server_ref):
    """Scheduler thread body. Idle waits hold only the condition
    variable, never the server, so an abandoned server is collectable
    and the thread exits on its next wake."""
    while True:
        srv = server_ref()
        if srv is None:
            return
        cond = srv._cond
        with cond:
            busy = bool(srv._active) or bool(srv._waiting)
            closed = srv._closed
        if not busy:
            if closed:
                return
            waiting, active = srv._waiting, srv._active
            srv = None              # the idle sleep must not pin the server
            with cond:
                if not waiting and not active:  # re-check under the lock:
                    cond.wait(0.05)             # a submit in the gap must
            continue                            # not lose its wakeup
        try:
            srv._iteration()
        except Exception:                                   # noqa: BLE001
            # _iteration routes errors into the affected handles; an
            # escape is a bug but must not silently hang every later
            # request by killing the scheduler
            pass
        del srv


class GenerativeServer:
    """Continuous-batching autoregressive decode server.

    New requests join the RUNNING decode batch at step granularity:
    between two decode steps the scheduler admits waiting prompts into
    free KV-cache slots — prefill work per gap is bounded by the
    ``MXNET_TPU_SERVE_PREFILL_TOKENS`` budget so joins cannot starve
    resident sequences' inter-token latency — and finished sequences
    evict immediately, freeing their pages for the next join.

    Parameters
    ----------
    model : Module | (arg_params, aux_params) | dict
        The zoo transformer's parameters (``Module.get_params()``
        naming), as a bound Module, an ``(arg, aux)`` pair, or a dict of
        NDArrays, tensors or numpy arrays (:func:`~.decode
        .extract_params`).
    n_heads : int
        Attention head count (not shape-derivable).
    max_sequences, page, prefill_tokens, queue_bound, seq_buckets :
        optional, defaults from the ``MXNET_TPU_SERVE_*`` knobs.
    int8 : bool, optional
        int8 KV cache with per-page scales (default the
        ``MXNET_TPU_SERVE_KV_INT8`` knob).
    prefill_chunk : int
        Accepted and validated as in the reference; prefill runs the
        flash kernel at every bucket (see :mod:`.decode`).
    metrics_port : int, optional
        Opt-in Prometheus ``/metrics`` endpoint, as for
        :class:`InferenceServer`.
    device : optional
        Where the weights and the cache live: ``cuda:0`` by default
        (raises without a GPU); ``"cpu"`` only when asked for.

    The decode path (kv_cache / decode modules) imports lazily here: a
    process that only uses InferenceServer never pays for it.
    """

    def __init__(self, model, n_heads: int,
                 max_sequences: Optional[int] = None,
                 int8: Optional[bool] = None,
                 page: Optional[int] = None,
                 prefill_tokens: Optional[int] = None,
                 queue_bound: Optional[int] = None,
                 seq_buckets: Optional[List[int]] = None,
                 prefill_chunk: int = 512,
                 name: str = "serve_gen",
                 metrics_port: Optional[int] = None,
                 device: DeviceLike = None):
        from .. import config as _config
        from .bucketing import decode_buckets
        from .decode import (DecodeEngine, config_from_params,
                             extract_params, sample_token)
        from .kv_cache import KVCache
        self.device = resolve_device(device)
        self.name = name
        self._sample_token = sample_token
        tparams = extract_params(model, self.device)
        cfg = config_from_params(tparams, n_heads)
        self.vocab_size = cfg.vocab_size
        self.max_sequences = int(
            max_sequences if max_sequences is not None
            else _config.get("MXNET_TPU_SERVE_MAX_SEQUENCES"))
        self.prefill_tokens = int(
            prefill_tokens if prefill_tokens is not None
            else _config.get("MXNET_TPU_SERVE_PREFILL_TOKENS"))
        self.queue_bound = (queue_bound if queue_bound is not None else
                            _config.get("MXNET_TPU_SERVE_QUEUE_BOUND"))
        spec = _config.get("MXNET_TPU_SERVE_DECODE_BUCKETS")
        if seq_buckets is None and spec:
            pg = int(page if page is not None
                     else _config.get("MXNET_TPU_SERVE_KV_PAGE"))
            seq_buckets = decode_buckets(cfg.max_seq, pg, spec)
        self.cache = KVCache(cfg.num_layers, cfg.n_heads, cfg.d_head,
                             self.max_sequences, cfg.max_seq, page=page,
                             int8=int8, name=name, device=self.device)
        # hbm-budget audit of the reservation at server start: strict
        # analyze mode rejects an over-budget cache, naming it, before
        # the first request lands
        self.hbm_audit = self.cache.audit()
        grid_bound = 4 * (len(seq_buckets) * 2 if seq_buckets else 64)
        self.compile_cache = CompileCache(name,
                                          max_entries=max(grid_bound, 128))
        self.engine = DecodeEngine(tparams, n_heads, self.cache,
                                   self.compile_cache, name=name,
                                   seq_buckets=seq_buckets,
                                   prefill_chunk=prefill_chunk)
        self.latency = DecodeLatencyStats(name=name)
        _start_metrics(self, name, metrics_port)
        self._lock = _lockcheck.Lock(name="serve.gen_lock")
        self._cond = _lockcheck.Condition(self._lock)
        self._waiting: collections.deque = collections.deque()
        self._active: List[_ActiveSeq] = []
        self._closed = False
        self._worker = threading.Thread(
            target=_gen_loop, args=(weakref.ref(self),), daemon=True,
            name="mxnet_tpu_torch.serve.gen[%s]" % name)
        self._worker.start()

    # ------------------------------------------------------------ submit
    def submit_generate(self, prompt, max_new_tokens: int = 32,
                        eos_id: Optional[int] = None,
                        timeout: Optional[float] = None,
                        temperature: float = 0.0,
                        seed: Optional[int] = None,
                        on_token: Optional[Callable[[int], None]] = None
                        ) -> GenerateHandle:
        """Enqueue one prompt for generation; returns a streaming
        :class:`GenerateHandle`.

        ``timeout`` is the TIME-TO-FIRST-TOKEN deadline (queue +
        prefill; once resident a sequence decodes to completion).
        Raises :class:`QueueFull` at the admission bound,
        :class:`ServerClosed` after ``close()``, ``ValueError`` on a
        prompt that is empty, too long, or holds ids outside the
        vocabulary.
        """
        if _faults.ARMED:
            _faults.fire("serve.submit", default_kind="raise")
        prompt = np.asarray(prompt).astype(np.int64).ravel()
        if prompt.size < 1:
            raise ValueError("empty prompt")
        if prompt.size >= self.cache.max_seq:
            raise ValueError(
                "prompt of %d tokens leaves no room to generate under "
                "max_seq %d" % (prompt.size, self.cache.max_seq))
        # an out-of-range id would be a device-side assert on the GPU,
        # which poisons the whole CUDA context: reject it here
        if prompt.min() < 0 or prompt.max() >= self.vocab_size:
            raise ValueError("prompt token ids must lie in [0, %d)"
                             % self.vocab_size)
        if max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        deadline = None if timeout is None else monotonic() + timeout
        handle = GenerateHandle(on_token=on_token)
        req = _GenRequest(prompt, int(max_new_tokens), eos_id,
                          float(temperature), seed, deadline, handle)
        with self._cond:
            if self._closed:
                raise ServerClosed("submit_generate() after close()")
            if len(self._waiting) >= self.queue_bound:
                _profiler.incr_counter(self.name + "_shed")
                raise QueueFull("queue depth %d at admission bound %d"
                                % (len(self._waiting), self.queue_bound))
            self._waiting.append(req)
            _profiler.incr_counter(self.name + "_requests")
            _profiler.set_gauge(self.name + "_waiting",
                                len(self._waiting))
            self._cond.notify_all()
        return handle

    # --------------------------------------------------------- scheduler
    def _snapshot_active(self) -> List[_ActiveSeq]:
        with self._lock:
            return list(self._active)

    def _iteration(self):
        """One continuous-batching step: admit joins under the prefill
        budget, one decode step over every resident sequence, evict the
        finished. Runs only on the scheduler thread."""
        self._admit()
        # cancelled handles evict at step granularity; capacity-exhausted
        # sequences finish (truncated) BEFORE the step: position max_seq
        # does not exist in the cache
        for seq in self._snapshot_active():
            if seq.handle._cancelled or seq.pos >= self.cache.max_seq:
                self._evict(seq, exc=None)
        active = self._snapshot_active()
        if not active:
            return
        if _faults.ARMED:
            try:
                _faults.fire("serve.decode", default_kind="raise")
            except _faults.FaultInjected as exc:
                # an injected decode fault kills ONE sequence's stream
                # with a legible error — the lowest resident slot,
                # deterministically — NEVER the batch
                victim = min(active, key=lambda s: s.slot)
                self._evict(victim, exc=ServeError(
                    "injected fault at serve.decode killed the sequence "
                    "in slot %d (%s); co-resident sequences kept "
                    "decoding" % (victim.slot, exc)))
                active = self._snapshot_active()
                if not active:
                    return
        tokens = np.zeros((self.cache.max_slots,), np.int64)
        pos = np.zeros((self.cache.max_slots,), np.int64)
        mask = np.zeros((self.cache.max_slots,), bool)
        for seq in active:
            tokens[seq.slot] = seq.token
            pos[seq.slot] = seq.pos
            mask[seq.slot] = True
        try:
            logits = self.engine.decode_step(tokens, pos, mask)
        except Exception as exc:                            # noqa: BLE001
            # a real decode failure cannot be attributed to one row —
            # every resident sequence fails legibly and frees its pages
            for seq in active:
                self._evict(seq, exc=ServeError(
                    "decode step failed for resident batch: %r" % (exc,)))
            return
        now = monotonic()
        finished = []
        for seq in active:
            tok = self._sample_token(logits[seq.slot], seq.temperature,
                                     seq.rng)
            self.latency.tpot.record(now - seq.t_last)
            seq.t_last = now
            seq.handle._put(tok)
            self.cache.grow(seq.slot)
            seq.pos += 1
            seq.generated += 1
            seq.token = tok
            _profiler.incr_counter(self.name + "_tokens")
            if self._finished(seq, tok):
                finished.append(seq)
        for seq in finished:
            self._evict(seq, exc=None)
        _profiler.incr_counter(self.name + "_decode_steps")

    @staticmethod
    def _finished(seq: _ActiveSeq, tok: int) -> bool:
        return seq.generated >= seq.max_new_tokens or \
            (seq.eos_id is not None and tok == seq.eos_id)

    def _requeue_front(self, req: _GenRequest) -> None:
        with self._cond:
            self._waiting.appendleft(req)
            _profiler.set_gauge(self.name + "_waiting", len(self._waiting))

    def _admit(self):
        """Join waiting requests into free slots under the prefill token
        budget (bucket-padded accounting — padded work is the cost the
        budget bounds)."""
        budget = self.prefill_tokens
        while True:
            with self._cond:
                if not self._waiting:
                    return
                if self.cache.ledger.slots_in_use >= self.cache.max_slots:
                    return
                req = self._waiting.popleft()
                _profiler.set_gauge(self.name + "_waiting",
                                    len(self._waiting))
            if req.handle._cancelled:
                req.handle._finish()
                continue
            now = monotonic()
            if req.deadline is not None and now > req.deadline:
                _profiler.incr_counter(self.name + "_deadline_expired")
                req.handle._finish(DeadlineExceeded(
                    "TTFT deadline passed %.1f ms before prefill"
                    % ((now - req.deadline) * 1e3)))
                continue
            bucket = self.engine.prompt_bucket(int(req.prompt.size))
            if bucket > budget and budget < self.prefill_tokens:
                # budget spent this gap: requeue at the FRONT (FIFO
                # order survives) and let the decode batch take a step
                self._requeue_front(req)
                return
            slot = self.cache.acquire(int(req.prompt.size))
            if slot is None:
                self._requeue_front(req)
                return
            budget -= bucket
            try:
                logits = self.engine.prefill(req.prompt, slot)
            except Exception as exc:                        # noqa: BLE001
                self.cache.release(slot)
                req.handle._finish(ServeError(
                    "prefill failed: %r" % (exc,)))
                continue
            rng = np.random.default_rng(req.seed) \
                if req.seed is not None else None
            tok = self._sample_token(logits, req.temperature, rng)
            self.latency.ttft.record(monotonic() - req.t_submit)
            seq = _ActiveSeq(slot, req.handle, int(req.prompt.size),
                             req.max_new_tokens, req.eos_id,
                             req.temperature, rng, tok)
            req.handle._put(tok)
            _profiler.incr_counter(self.name + "_tokens")
            if self._finished(seq, tok):
                # finished at its first token: it never joins the batch
                self._evict(seq, exc=None)
                continue
            with self._lock:
                self._active.append(seq)
                _profiler.set_gauge(self.name + "_active_sequences",
                                    len(self._active))
            if budget <= 0:
                return

    # ---------------------------------------------------------- eviction
    def _evict(self, seq: _ActiveSeq, exc: Optional[BaseException]):
        """Remove a sequence from the running batch (if it joined),
        ALWAYS freeing its pages, then resolve its handle."""
        with self._lock:
            if seq in self._active:
                self._active.remove(seq)
            _profiler.set_gauge(self.name + "_active_sequences",
                                len(self._active))
        fault_exc = None
        try:
            if _faults.ARMED:
                _faults.fire("serve.evict", default_kind="raise")
        except _faults.FaultInjected as fe:
            fault_exc = ServeError(
                "injected fault at serve.evict while evicting slot %d "
                "(%s); pages were still freed" % (seq.slot, fe))
        finally:
            self.cache.release(seq.slot)
            _profiler.incr_counter(self.name + "_evicted")
        seq.handle._finish(exc if exc is not None else fault_exc)

    # ------------------------------------------------------------- close
    def close(self, drain: bool = True, timeout: Optional[float] = None):
        """Stop accepting requests. ``drain=True`` (default) decodes
        every waiting AND resident sequence to completion first;
        ``False`` fails waiting requests with :class:`ServerClosed` and
        cancels resident sequences at the next step. Idempotent: a
        second close only joins — it must not drop requests a prior
        ``close(drain=True)`` promised to serve."""
        with self._cond:
            already = self._closed
            self._closed = True
            if already:
                drain = True        # first close's promise stands
            if not drain:
                dropped = list(self._waiting)
                self._waiting.clear()
                for seq in self._active:
                    seq.handle._cancelled = True
            else:
                dropped = []
            self._cond.notify_all()
        for req in dropped:
            req.handle._finish(ServerClosed("server closed"))
        self._worker.join(timeout)
        if not self._worker.is_alive():
            # anything that slipped into the queue after the scheduler
            # exited fails legibly instead of hanging its caller
            with self._cond:
                leftover = list(self._waiting)
                self._waiting.clear()
            for req in leftover:
                req.handle._finish(ServerClosed("server closed"))
        _stop_metrics(self)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close(drain=not any(exc))
        return False

    # ------------------------------------------------------------- stats
    def stats(self) -> Dict[str, Any]:
        """Decode-serving snapshot, the reference's schema."""
        with self._lock:
            active = len(self._active)
            waiting = len(self._waiting)
        led = self.cache.ledger
        return {
            "requests": _profiler.get_counter(self.name + "_requests"),
            "tokens": _profiler.get_counter(self.name + "_tokens"),
            "decode_steps": _profiler.get_counter(
                self.name + "_decode_steps"),
            "active_sequences": active,
            "waiting": waiting,
            "evicted": _profiler.get_counter(self.name + "_evicted"),
            "compiles": _profiler.get_counter(self.name + "_compile"),
            "cache_hits": _profiler.get_counter(self.name + "_cache_hit"),
            "shed": _profiler.get_counter(self.name + "_shed"),
            "deadline_expired": _profiler.get_counter(
                self.name + "_deadline_expired"),
            "executable_bound": self.engine.executable_bound(),
            "kv": {
                "slots_in_use": led.slots_in_use,
                "pages_in_use": led.pages_in_use,
                "total_pages": led.total_pages,
                "occupancy": round(led.occupancy(), 4),
                "max_slots": self.cache.max_slots,
                "page": self.cache.page,
                "int8": self.cache.int8,
                "hbm_bytes": self.cache.hbm_bytes(),
            },
            "buckets": {"prompt": list(self.engine.prompt_buckets),
                        "decode": list(self.engine.seq_buckets)},
            "ttft": self.latency.ttft.snapshot(),
            "tpot": self.latency.tpot.snapshot(),
        }
