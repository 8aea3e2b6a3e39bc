"""``GenerativeServer`` — continuous-batching autoregressive decode.

Counterpart of the generative half of the reference package's
``serve/server.py``: the same scheduler (iteration-level joins under a
prefill token budget, immediate eviction, TTFT deadlines, load
shedding, graceful drain), the same handle, errors, counters, gauges
and ``stats()`` schema, over the port's :class:`~.decode.DecodeEngine`
and :class:`~.kv_cache.KVCache` on a torch device. The batch
``InferenceServer``, the ``/metrics`` endpoint, int8 KV and the
tensor-parallel cache are not ported yet.
"""
from __future__ import annotations

import collections
import threading
import weakref
from typing import Any, Callable, Dict, List, Optional

import numpy as np

from .. import faults as _faults
from .. import lockcheck as _lockcheck
from .. import profiler as _profiler
from .._fused import CompileCache
from ..base import MXNetError
from ..context import DeviceLike, resolve_device
from .stats import DecodeLatencyStats, monotonic

__all__ = ["GenerativeServer", "GenerateHandle", "ServeError",
           "ServerClosed", "QueueFull", "DeadlineExceeded"]


class ServeError(MXNetError):
    """Base class for serving errors."""


class ServerClosed(ServeError):
    """submit after close()."""


class QueueFull(ServeError):
    """Load shed: the admission bound was exceeded (clients should back
    off / retry against another replica)."""


class DeadlineExceeded(ServeError):
    """The request's deadline passed before its prefill."""


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
    params : dict of name -> numpy array
        The zoo-transformer parameters
        (:func:`~.decode.params_from_numpy` naming).
    n_heads : int
        Attention head count (not shape-derivable).
    max_sequences, page, prefill_tokens, queue_bound, seq_buckets :
        optional, defaults from the ``MXNET_TPU_SERVE_*`` knobs.
    device : optional
        Where the weights and the cache live: ``cuda:0`` by default
        (raises without a GPU); ``"cpu"`` only when asked for.
    """

    def __init__(self, params: Dict[str, np.ndarray], n_heads: int,
                 max_sequences: Optional[int] = None,
                 page: Optional[int] = None,
                 prefill_tokens: Optional[int] = None,
                 queue_bound: Optional[int] = None,
                 seq_buckets: Optional[List[int]] = None,
                 name: str = "serve_gen",
                 device: DeviceLike = None):
        from .. import config as _config
        from .bucketing import decode_buckets
        from .decode import (DecodeEngine, config_from_params,
                             params_from_numpy, sample_token)
        from .kv_cache import KVCache
        self.device = resolve_device(device)
        self.name = name
        self._sample_token = sample_token
        tparams = params_from_numpy(params, self.device)
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
                             name=name, device=self.device)
        grid_bound = 4 * (len(seq_buckets) * 2 if seq_buckets else 64)
        self.compile_cache = CompileCache(name,
                                          max_entries=max(grid_bound, 128))
        self.engine = DecodeEngine(tparams, n_heads, self.cache,
                                   self.compile_cache, name=name,
                                   seq_buckets=seq_buckets)
        self.latency = DecodeLatencyStats(name=name)
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
                "int8": False,
                "hbm_bytes": self.cache.hbm_bytes(),
            },
            "buckets": {"prompt": list(self.engine.prompt_buckets),
                        "decode": list(self.engine.seq_buckets)},
            "ttft": self.latency.ttft.snapshot(),
            "tpot": self.latency.tpot.snapshot(),
        }
