"""Fleet gateway: replica supervision, routing/admission, fail-over.

The port's copy of the reference package's ``fleet/gateway.py``. One
gateway process fronts N replica processes (each a ``GenerativeServer``
behind the fleet wire). The division of labor:

* **Supervision** — one supervisor thread per replica slot launches
  ``python -m mxnet_tpu_torch.fleet replica`` with a deterministic model
  spec (carrying this process's TF32 switches, so every replica computes
  as the gateway's process would), waits for its first PING, then
  watches the process. Death means bounded-backoff respawn
  (:func:`mxnet_tpu_torch.elastic.backoff_delay`) under the
  ``MXNET_TPU_FLEET_MAX_RESPAWNS`` budget. A respawn loads its kernel
  libraries from the checkout's build directory: it builds nothing.

* **Routing + admission** — a sequence is STICKY to the replica that
  prefilled it by construction: one GEN stream drives the whole
  generation on one connection, so every decode step lands on the
  replica holding its KV pages (migration happens only through the
  fail-over re-prefill below). New requests go to the least-loaded live
  replica, scored on the replica's heartbeat-reported KV occupancy and
  queue depth plus the gateway's own not-yet-reported assignment count
  (snapshots lag one heartbeat; the local term keeps a burst from
  dog-piling one replica). Admission beyond
  ``MXNET_TPU_FLEET_QUEUE_BOUND`` in-flight requests sheds with
  ``QueueFull``; the client's TTFT deadline rides the GEN payload so
  the replica can expire queued work (deadline propagation).

* **Fail-over** — a mid-stream replica death surfaces as a broken
  stream; a PING probe adjudicates (connection REFUSED = confirmed
  dead, timeout = ambiguous, the ProbeRing rule). The gateway retains
  every request's prompt and delivered-token prefix, re-prefills
  ``prompt + prefix`` on a survivor, and streams from global token
  index ``len(prefix)``. Delivery is at-most-once: a frame is forwarded
  iff its index equals the delivered count, so late or replayed frames
  drop (``fleet_dup_dropped``). Survivor-resident sequences are never
  touched — the victim's sequences arrive as fresh admissions at step
  granularity, the same continuous-batching join any new request makes.
  A replica's clean ``END`` distinguishes ``done`` (contract met, EOS,
  or KV-capacity truncation — a complete result, finished as a bare
  server would finish it) from ``released`` (a draining shutdown let
  go of an unfinished sequence — the remainder re-dispatches).
  Continuations are bit-equal for greedy decode; seeded sampling
  re-derives its seed from the fail-over point (deterministic, but a
  divergent sample path — see ``submit_generate``).

* **Federated obs** — ``/metrics`` merges the gateway's own registry
  with every live replica's ``replica=<r>``-labeled exposition
  (``render_prometheus(labels=)``); replica blackboxes inherit
  ``MXNET_TPU_OBS_BLACKBOX`` with ``MXNET_TPU_POD_RANK=<rank>`` so
  ``python -m mxnet_tpu_torch.obs blackbox`` merges them post-mortem.
"""
from __future__ import annotations

import json
import os
import random as _pyrandom
import subprocess
import sys
import threading
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

from .. import config as _config
from .. import lockcheck as _lockcheck
from .. import profiler as _profiler
from ..base import MXNetError
from ..serve.server import (DeadlineExceeded, GenerateHandle, QueueFull,
                            ServeError, ServerClosed)
from ..serve.stats import DecodeLatencyStats, monotonic
from . import wire as _wire

__all__ = ["Gateway", "merge_prometheus"]


def merge_prometheus(texts: Sequence[str]) -> str:
    """Merge Prometheus expositions into one valid text: the first
    ``# HELP``/``# TYPE`` per metric name wins (the format allows
    metadata once), sample lines concatenate (replica-labeled samples
    are distinct series by construction)."""
    seen_meta = set()
    out: List[str] = []
    for text in texts:
        for line in text.splitlines():
            if line.startswith("# "):
                parts = line.split(" ", 3)
                key = tuple(parts[1:3]) if len(parts) >= 3 else (line,)
                if key in seen_meta:
                    continue
                seen_meta.add(key)
                out.append(line)
            elif line.strip():
                out.append(line)
    return "\n".join(out) + ("\n" if out else "")


class _Replica(object):
    """Gateway-side replica record. All fields are guarded by the
    gateway lock; ``generation`` fences late observations (a stream
    error from generation g must not mark generation g+1 dead)."""

    __slots__ = ("rank", "spec", "supervised", "addr", "proc",
                 "generation", "restarts", "state", "stats", "assigned",
                 "last_seen")

    def __init__(self, rank: int, spec=None, addr=None,
                 supervised: bool = True):
        self.rank = rank
        self.spec = spec
        self.supervised = supervised
        self.addr: Optional[Tuple[str, int]] = addr
        self.proc = None
        self.generation = 0
        self.restarts = 0
        self.state = "starting" if supervised else "live"
        self.stats: Dict[str, Any] = {}
        self.assigned = 0           # gateway streams currently on it
        self.last_seen = 0.0


class _FleetRequest(object):
    __slots__ = ("prompt", "max_new_tokens", "eos_id", "temperature",
                 "seed", "deadline", "handle", "delivered", "t_submit",
                 "t_first", "t_last")

    def __init__(self, prompt, max_new_tokens, eos_id, temperature,
                 seed, deadline, handle):
        self.prompt = prompt
        self.max_new_tokens = max_new_tokens
        self.eos_id = eos_id
        self.temperature = temperature
        self.seed = seed
        self.deadline = deadline
        self.handle = handle
        self.delivered: List[int] = []  # the at-most-once dedup state
        self.t_submit = monotonic()
        self.t_first: Optional[float] = None
        self.t_last = self.t_submit


class Gateway(object):
    """Front N decode replicas; see the module docstring.

    Parameters
    ----------
    spec : dict, optional
        Replica model spec (:func:`~mxnet_tpu_torch.fleet.replica.
        build_from_spec` grammar) — the gateway launches and supervises
        ``replicas`` subprocesses serving it. A transformer spec without
        ``tf32`` gets this process's TF32 switches.
    replicas : int, optional
        Supervised world size; default the ``MXNET_TPU_FLEET_REPLICAS``
        knob (env world discovery).
    addresses : list of (host, port), optional
        Front EXTERNALLY launched replicas instead of supervising own
        subprocesses (liveness then comes from the heartbeat poll
        alone). Mutually exclusive with ``spec``.
    port : int, optional
        Client-facing wire port (0 = ephemeral, read ``.port`` back);
        None = no wire, in-process ``submit_generate()`` only.
    metrics_port : int, optional
        Aggregated ``/metrics`` endpoint port; None = off.

    Requires the ``MXNET_TPU_FLEET`` knob: spawning a replica fleet is
    an explicit deployment decision, never a side effect.
    """

    def __init__(self, spec: Optional[Dict[str, Any]] = None,
                 replicas: Optional[int] = None,
                 addresses: Optional[Sequence[Tuple[str, int]]] = None,
                 name: str = "fleet", port: Optional[int] = 0,
                 metrics_port: Optional[int] = None,
                 queue_bound: Optional[int] = None,
                 stats_period: Optional[float] = None,
                 host: str = "127.0.0.1"):
        if not _config.get("MXNET_TPU_FLEET"):
            raise MXNetError(
                "the serving fleet is opt-in: set MXNET_TPU_FLEET=1 "
                "(or config.set) before constructing a Gateway — it "
                "spawns and supervises replica subprocesses")
        if (spec is None) == (addresses is None):
            raise ValueError("exactly one of spec= (supervised "
                             "subprocess replicas) or addresses= "
                             "(external replicas) is required")
        self.name = name
        self.queue_bound = int(
            queue_bound if queue_bound is not None
            else _config.get("MXNET_TPU_FLEET_QUEUE_BOUND"))
        self._stats_period = float(
            stats_period if stats_period is not None
            else _config.get("MXNET_TPU_FLEET_STATS_PERIOD"))
        self._spawn_timeout = float(
            _config.get("MXNET_TPU_FLEET_SPAWN_TIMEOUT"))
        self._max_respawns = int(
            _config.get("MXNET_TPU_FLEET_MAX_RESPAWNS"))
        self._backoff = float(_config.get("MXNET_TPU_ELASTIC_BACKOFF"))
        self._backoff_max = float(
            _config.get("MXNET_TPU_ELASTIC_BACKOFF_MAX"))
        self.latency = DecodeLatencyStats(name=name)
        self._lock = _lockcheck.Lock(name="fleet.gateway_lock")
        self._cond = _lockcheck.Condition(self._lock)
        self._closed = False        # no NEW submits
        self._closing = False       # tear the world down
        self._inflight = 0
        self._threads: List[threading.Thread] = []
        if addresses is not None:
            self._replicas = [
                _Replica(i, addr=(str(h), int(p)), supervised=False)
                for i, (h, p) in enumerate(addresses)]
        else:
            n = int(replicas if replicas is not None
                    else _config.get("MXNET_TPU_FLEET_REPLICAS"))
            if n < 1:
                raise ValueError("replicas must be >= 1")
            spec = dict(spec)
            if spec.get("kind", "transformer") == "transformer" \
                    and "tf32" not in spec:
                import torch
                spec["tf32"] = {
                    "matmul": torch.backends.cuda.matmul.allow_tf32,
                    "cudnn": torch.backends.cudnn.allow_tf32}
            self._replicas = [_Replica(i, spec=dict(spec))
                              for i in range(n)]
            for rep in self._replicas:
                t = threading.Thread(
                    target=self._supervise, args=(rep,), daemon=True,
                    name="mxnet_tpu_torch.fleet.sup[%d]" % rep.rank)
                t.start()
                self._threads.append(t)
        self._max_attempts = max(4, 2 * len(self._replicas) + 1)
        poller = threading.Thread(target=self._poll_loop, daemon=True,
                                  name="mxnet_tpu_torch.fleet.stats_poll")
        poller.start()
        self._threads.append(poller)
        self._wire = None
        if port is not None:
            self._wire = _wire.ServeWire(self, port=port, host=host,
                                         name="fleet.gateway")
        self.port = self._wire.port if self._wire else None
        self._metrics = None
        if metrics_port is not None and metrics_port >= 0:
            from ..obs.http import MetricsServer
            self._metrics = MetricsServer(port=metrics_port,
                                          render=self.metrics_text)
        self.metrics_port = self._metrics.port if self._metrics else None

    # ------------------------------------------------------- supervision
    def _closing_now(self) -> bool:
        with self._lock:
            return self._closing

    def _live_count(self) -> int:
        with self._lock:
            return sum(1 for r in self._replicas if r.state == "live")

    def _update_live_gauge(self) -> None:
        _profiler.set_gauge(self.name + "_replicas_live",
                            self._live_count())

    def _child_env(self, rep: _Replica,
                   first_spawn: bool) -> Dict[str, str]:
        env = dict(os.environ)
        # the replica must import THIS tree regardless of cwd
        root = os.path.dirname(os.path.dirname(
            os.path.dirname(os.path.abspath(__file__))))
        env["PYTHONPATH"] = root + (
            os.pathsep + env["PYTHONPATH"]
            if env.get("PYTHONPATH") else "")
        # blackbox files land as blackbox-p<rank>.jsonl so the obs
        # merger aligns replicas like pod ranks
        env["MXNET_TPU_POD_RANK"] = str(rep.rank)
        # a replica.die:hostkill must take down the REPLICA process
        # only — never adopt this gateway as a coordinated parent
        env.pop("MXNET_TPU_ELASTIC_COORDINATED", None)
        # faults armed in the gateway process must not leak into every
        # replica; the drill targets ONE rank explicitly:
        #   MXNET_TPU_FLEET_FAULT_REPLICA=<rank>:<fault spec>
        # and only that rank's FIRST spawn arms it — a respawned
        # generation must not re-fire its own killer (the data.worker
        # progress rule)
        env.pop("MXNET_TPU_FAULTS", None)
        target = os.environ.get("MXNET_TPU_FLEET_FAULT_REPLICA")
        if target and first_spawn:
            rank_s, _, fspec = target.partition(":")
            try:
                armed_rank = int(rank_s)
            except ValueError:
                armed_rank = -1
            if armed_rank == rep.rank and fspec:
                env["MXNET_TPU_FAULTS"] = fspec
        return env

    def _supervise(self, rep: _Replica) -> None:
        from .. import elastic as _elastic
        rng = _pyrandom.Random(0x11E7 + rep.rank)
        first = True
        while True:
            with self._lock:
                if self._closing:
                    return
                rep.generation += 1
                rep.state = "starting"
                rep.addr = None
            port = _wire._free_port()
            addr = ("127.0.0.1", port)
            cmd = [sys.executable, "-m", "mxnet_tpu_torch.fleet", "replica",
                   "--port", str(port), "--rank", str(rep.rank),
                   "--model-json", json.dumps(rep.spec)]
            proc = None
            try:
                proc = subprocess.Popen(
                    cmd, env=self._child_env(rep, first_spawn=first))
            except OSError:
                pass
            first = False
            ok = False
            if proc is not None:
                deadline = monotonic() + self._spawn_timeout
                while monotonic() < deadline and not self._closing_now():
                    if proc.poll() is not None:
                        break
                    if _wire.ping(addr, timeout=1.0):
                        ok = True
                        break
                    _elastic_sleep(0.1)
            if ok:
                with self._cond:
                    rep.proc = proc
                    rep.addr = addr
                    rep.state = "live"
                    self._cond.notify_all()
                self._update_live_gauge()
                while not self._closing_now():
                    try:
                        proc.wait(timeout=0.5)
                        break
                    except subprocess.TimeoutExpired:
                        continue
                if self._closing_now():
                    self._shutdown_child(proc, addr)
                    return
                with self._cond:
                    rep.state = "dead"
                    rep.addr = None
                    self._cond.notify_all()
                _profiler.incr_counter(self.name + "_replica_dead")
                self._update_live_gauge()
            elif proc is not None:
                try:
                    proc.kill()
                    proc.wait(timeout=10.0)
                except (OSError, subprocess.TimeoutExpired):
                    pass
                with self._cond:
                    rep.state = "dead"
                    self._cond.notify_all()
            if self._closing_now():
                return
            rep.restarts += 1
            if rep.restarts > self._max_respawns:
                with self._cond:
                    rep.state = "failed"
                    self._cond.notify_all()
                return
            _profiler.incr_counter(self.name + "_respawn")
            delay = _elastic.backoff_delay(
                rep.restarts, self._backoff, self._backoff_max, rng=rng)
            end = monotonic() + delay
            while monotonic() < end:
                if self._closing_now():
                    return
                _elastic_sleep(0.1)

    def _shutdown_child(self, proc, addr) -> None:
        """Graceful replica shutdown ladder: QUIT -> SIGTERM -> SIGKILL,
        every wait bounded (PhaseGuard discipline)."""
        if addr is not None:
            try:
                _wire.request_value(addr, "QUIT", timeout=2.0)
            except OSError:
                pass
        for grace, escalate in ((5.0, proc.terminate), (3.0, proc.kill),
                                (10.0, None)):
            try:
                proc.wait(timeout=grace)
                return
            except subprocess.TimeoutExpired:
                if escalate is not None:
                    try:
                        escalate()
                    except OSError:
                        return

    # --------------------------------------------------------- heartbeat
    def _poll_loop(self) -> None:
        while True:
            with self._lock:
                if self._closing:
                    return
                targets = [(r, r.addr, r.generation)
                           for r in self._replicas if r.addr is not None]
            for rep, addr, gen in targets:
                try:
                    snap = _wire.request_value(
                        addr, "STATS",
                        timeout=max(1.0, self._stats_period))
                except ConnectionRefusedError:
                    # REFUSED is the probe-confirmed death signal; for
                    # supervised replicas the proc.wait() watcher is
                    # authoritative, so only external replicas flip here
                    with self._cond:
                        if rep.generation == gen \
                                and not rep.supervised \
                                and rep.state == "live":
                            rep.state = "dead"
                            self._cond.notify_all()
                    self._update_live_gauge()
                    continue
                except OSError:
                    continue        # ambiguous (timeout): never kill
                with self._cond:
                    if rep.generation == gen:
                        rep.stats = snap
                        rep.last_seen = monotonic()
                        if not rep.supervised and rep.state != "live":
                            rep.state = "live"
                            self._cond.notify_all()
                self._update_live_gauge()
            end = monotonic() + self._stats_period
            while monotonic() < end:
                if self._closing_now():
                    return
                _elastic_sleep(0.05)

    # ------------------------------------------------------------ submit
    def submit_generate(self, prompt, max_new_tokens: int = 32,
                        eos_id: Optional[int] = None,
                        timeout: Optional[float] = None,
                        temperature: float = 0.0,
                        seed: Optional[int] = None,
                        on_token=None) -> GenerateHandle:
        """Same contract as ``GenerativeServer.submit_generate`` — the
        fleet is a drop-in for a single server. ``timeout`` is the TTFT
        deadline and propagates to the serving replica (first-token
        admission only: once a token has been delivered, fail-over
        re-dispatch is not deadline-bounded).

        Determinism across fail-over: greedy decode
        (``temperature=0``) is bit-equal to an uninterrupted stream —
        the survivor re-prefills ``prompt + delivered-prefix`` and
        argmax depends only on the sequence. Seeded sampling
        (``temperature>0`` with ``seed``) is reproducible run-to-run
        but NOT bit-equal across a fail-over: the survivor's RNG
        cannot resume the dead replica's draw stream, so the
        continuation uses a seed derived from (seed, fail-over point)
        — deterministic, but a divergent sample path."""
        if hasattr(prompt, "asnumpy"):
            prompt = prompt.asnumpy()
        if hasattr(prompt, "tolist"):
            prompt = prompt.tolist()
        prompt = [int(t) for t in prompt]
        if not prompt:
            raise ValueError("empty prompt")
        if max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        deadline = None if timeout is None else monotonic() + timeout
        handle = GenerateHandle(on_token=on_token)
        req = _FleetRequest(prompt, int(max_new_tokens), eos_id,
                            float(temperature), seed, deadline, handle)
        with self._cond:
            if self._closed:
                raise ServerClosed("submit_generate() after close()")
            if self._inflight >= self.queue_bound:
                _profiler.incr_counter(self.name + "_shed")
                raise QueueFull(
                    "gateway at admission bound: %d in-flight"
                    % self._inflight)
            self._inflight += 1
            _profiler.set_gauge(self.name + "_inflight", self._inflight)
        _profiler.incr_counter(self.name + "_requests")
        t = threading.Thread(target=self._drive, args=(req,),
                             daemon=True, name="mxnet_tpu_torch.fleet.req")
        t.start()
        return handle

    # ------------------------------------------------------------ driver
    def _finish(self, req: _FleetRequest,
                exc: Optional[BaseException]) -> None:
        with self._cond:
            self._inflight -= 1
            _profiler.set_gauge(self.name + "_inflight", self._inflight)
            self._cond.notify_all()
        req.handle._finish(exc)

    def _pick(self, excluded) -> Optional[_Replica]:
        """Least-loaded live replica (see module docstring for the
        score); fires the ``gateway.route`` fault site. Stickiness
        needs no table: the picked replica serves the whole stream, so
        KV-resident decode never migrates outside fail-over."""
        from .. import faults as _faults
        if _faults.ARMED:
            _faults.fire("gateway.route", default_kind="raise")
        with self._lock:
            cands = [r for r in self._replicas
                     if r.state == "live" and r.addr is not None
                     and r.rank not in excluded]
            if not cands:
                return None

            def score(r):
                st = r.stats or {}
                kv = st.get("kv") or {}
                slots = max(1, int(kv.get("max_slots", 1)))
                return ((r.assigned + int(st.get("waiting", 0)))
                        / float(slots)
                        + float(kv.get("occupancy", 0.0)))

            rep = min(cands, key=lambda r: (score(r), r.rank))
            rep.assigned += 1
            return rep

    def _stream_from(self, rep: _Replica, req: _FleetRequest):
        """One streaming attempt against one replica. None on success,
        else ``(verdict, exc)`` with verdict ``shed`` (retry elsewhere),
        ``died`` (fail-over), or ``fatal`` (surface to the caller)."""
        with self._lock:
            addr, gen = rep.addr, rep.generation
        if addr is None:
            return ("died", ConnectionResetError("replica restarting"))
        remaining = None
        if req.deadline is not None and not req.delivered:
            # the TTFT deadline constrains only the FIRST token (the
            # _drive guard): a fail-over re-dispatch after delivery
            # must not carry the expired deadline into the survivor's
            # admission, which would fail a request whose TTFT was
            # already satisfied
            remaining = max(0.05, req.deadline - monotonic())
        seed = req.seed
        if seed is not None and req.delivered:
            # a survivor's RNG restarts at draw 0, so a seeded
            # temperature>0 continuation cannot replay the dead
            # replica's draw stream; deriving the continuation seed
            # from the fail-over point keeps the re-dispatched stream
            # deterministic (same prefix -> same continuation) instead
            # of silently reusing draws 0..k at the wrong token
            # positions. Greedy decode stays bit-equal either way.
            seed = (int(seed)
                    ^ (0x9E3779B97F4A7C15 * len(req.delivered))) \
                & ((1 << 63) - 1)
        payload = {
            "prompt": req.prompt,
            "prefix": list(req.delivered),
            "start": len(req.delivered),
            "max_new_tokens": req.max_new_tokens - len(req.delivered),
            "eos_id": req.eos_id,
            "temperature": req.temperature,
            "seed": seed,
            "timeout": remaining,
        }

        def on_frame(idx: int, tok: int) -> None:
            if idx == len(req.delivered):
                req.delivered.append(tok)
                now = monotonic()
                if req.t_first is None:
                    req.t_first = now
                    self.latency.ttft.record(now - req.t_submit)
                else:
                    self.latency.tpot.record(now - req.t_last)
                req.t_last = now
                _profiler.incr_counter(self.name + "_tokens")
                req.handle._put(tok)
            else:
                # a frame from a past life of this request (the dying
                # replica raced the fail-over): at-most-once = drop
                _profiler.incr_counter(self.name + "_dup_dropped")

        try:
            end = _wire.stream_generate(addr, payload, on_frame)
            done = (len(req.delivered) >= req.max_new_tokens
                    or (req.eos_id is not None and req.delivered
                        and req.delivered[-1] == req.eos_id))
            if not done and isinstance(end, dict) \
                    and end.get("reason", "released") == "released":
                # the replica let go of an UNfinished sequence (a
                # draining shutdown cancels at a step boundary): the
                # remainder re-dispatches like a death. A short "done"
                # END is a COMPLETE result (KV-capacity truncation) —
                # a bare server finishes such a request, so we do too.
                return ("released", None)
            return None
        except (QueueFull, ServerClosed) as exc:
            return ("shed", exc)
        except DeadlineExceeded as exc:
            return ("fatal", exc)
        except ServeError as exc:
            return ("fatal", exc)
        except OSError as exc:
            self._note_stream_break(rep, gen, addr)
            return ("died", exc)

    def _note_stream_break(self, rep: _Replica, gen: int, addr) -> None:
        """A broken stream is only a SUSPICION; the PING probe
        adjudicates (refused = dead, PONG = alive, timeout/garbage =
        ambiguous — exactly the ProbeRing distinction)."""
        if _wire.probe(addr, timeout=1.0) != "dead":
            return
        with self._cond:
            if rep.generation == gen and rep.state == "live":
                rep.state = "dead"
                self._cond.notify_all()
        self._update_live_gauge()

    def _wait_any_live(self, timeout: float) -> bool:
        deadline = monotonic() + timeout
        with self._cond:
            while True:
                if any(r.state == "live" for r in self._replicas):
                    return True
                if self._closing:
                    return False
                if all(r.state == "failed" for r in self._replicas):
                    return False
                left = deadline - monotonic()
                if left <= 0:
                    return False
                self._cond.wait(min(left, 0.2))

    def _drive(self, req: _FleetRequest) -> None:
        from .. import faults as _faults
        attempts = 0
        excluded: set = set()
        while True:
            if len(req.delivered) >= req.max_new_tokens or (
                    req.eos_id is not None and req.delivered
                    and req.delivered[-1] == req.eos_id):
                self._finish(req, None)     # died at the finish line
                return
            if req.deadline is not None and not req.delivered \
                    and monotonic() > req.deadline:
                _profiler.incr_counter(self.name + "_deadline_expired")
                self._finish(req, DeadlineExceeded(
                    "TTFT deadline expired before any replica answered"))
                return
            try:
                rep = self._pick(excluded)
            except (_faults.FaultInjected, OSError) as exc:
                self._finish(req, ServeError(
                    "injected fault at gateway.route killed this "
                    "request (%s); other requests unaffected" % exc))
                return
            if rep is None:
                if excluded:
                    # every live replica shed us: that IS the answer
                    self._finish(req, QueueFull(
                        "every live replica is at its admission bound"))
                    return
                # a supervised world heals on the respawn clock; an
                # unsupervised (addresses=) world can only revive via
                # the heartbeat, so don't make a caller wait a spawn
                # timeout for peers nobody is restarting
                if any(r.supervised for r in self._replicas):
                    grace = self._spawn_timeout
                else:
                    grace = max(2.0, 4 * self._stats_period)
                if req.deadline is not None and not req.delivered:
                    grace = min(grace, max(0.0,
                                           req.deadline - monotonic()))
                attempts += 1
                if attempts > self._max_attempts \
                        or not self._wait_any_live(grace):
                    self._finish(req, ServeError(
                        "no live replica (world down or respawn budget "
                        "exhausted)"))
                    return
                continue
            try:
                verdict = self._stream_from(rep, req)
            finally:
                with self._lock:
                    rep.assigned -= 1
            if verdict is None:
                # a "done" END: the replica finished the sequence on
                # its own terms — contract met, EOS, or KV-capacity
                # truncation. All are complete results (a bare server
                # finishes a truncated request short too; re-dispatch
                # would re-prefill past max_seq and fail it).
                self._finish(req, None)
                return
            kind, exc = verdict
            if kind == "fatal":
                if isinstance(exc, DeadlineExceeded):
                    _profiler.incr_counter(
                        self.name + "_deadline_expired")
                self._finish(req, exc)
                return
            attempts += 1
            if attempts > self._max_attempts:
                self._finish(req, ServeError(
                    "fail-over budget exhausted after %d attempts "
                    "(last: %s)" % (attempts,
                                    exc if exc is not None
                                    else "replica released the stream")))
                return
            if kind == "shed":
                _profiler.incr_counter(self.name + "_shed")
                excluded.add(rep.rank)
            else:
                # died (transport death) or released (the replica
                # cancelled an unfinished sequence while draining):
                # fail-over the remainder to a survivor
                _profiler.incr_counter(self.name + "_failover")
                excluded = set()    # dead rank is excluded via state

    # ------------------------------------------------------------- stats
    def stats(self) -> Dict[str, Any]:
        with self._lock:
            reps = [{
                "rank": r.rank, "state": r.state,
                "generation": r.generation, "restarts": r.restarts,
                "addr": list(r.addr) if r.addr else None,
                "assigned": r.assigned, "stats": r.stats,
            } for r in self._replicas]
            inflight = self._inflight
        return {
            "name": self.name,
            "live": sum(1 for r in reps if r["state"] == "live"),
            "inflight": inflight,
            "replicas": reps,
            "requests": _profiler.get_counter(self.name + "_requests"),
            "tokens": _profiler.get_counter(self.name + "_tokens"),
            "shed": _profiler.get_counter(self.name + "_shed"),
            "failover": _profiler.get_counter(self.name + "_failover"),
            "dup_dropped": _profiler.get_counter(
                self.name + "_dup_dropped"),
            "respawn": _profiler.get_counter(self.name + "_respawn"),
            "replica_dead": _profiler.get_counter(
                self.name + "_replica_dead"),
            "deadline_expired": _profiler.get_counter(
                self.name + "_deadline_expired"),
            "ttft": self.latency.ttft.snapshot(),
            "tpot": self.latency.tpot.snapshot(),
        }

    def metrics_text(self) -> str:
        """The federated exposition: this process's registry plus every
        live replica's ``replica=<r>``-labeled text."""
        from ..obs.prometheus import render_prometheus
        texts = [render_prometheus()]
        with self._lock:
            targets = [r.addr for r in self._replicas
                       if r.state == "live" and r.addr is not None]
        for addr in targets:
            try:
                texts.append(_wire.request_value(addr, "METRICS",
                                                 timeout=2.0))
            except OSError:
                pass                # a scrape never fails on one corpse
        return merge_prometheus(texts)

    def wait_ready(self, n: Optional[int] = None,
                   timeout: float = 300.0) -> int:
        """Block until ``n`` replicas (default: the whole world) are
        live; returns the live count (may be short on timeout)."""
        want = len(self._replicas) if n is None else int(n)
        deadline = monotonic() + timeout
        with self._cond:
            while True:
                live = sum(1 for r in self._replicas
                           if r.state == "live")
                if live >= want or self._closing:
                    return live
                left = deadline - monotonic()
                if left <= 0:
                    return live
                self._cond.wait(min(left, 0.2))

    # ------------------------------------------------------------- close
    def close(self, drain: bool = True, timeout: float = 60.0) -> None:
        """Stop accepting; ``drain=True`` waits (bounded) for in-flight
        streams, then tears the replica world down gracefully."""
        with self._cond:
            already = self._closed
            self._closed = True
        if drain and not already:
            deadline = monotonic() + timeout
            with self._cond:
                while self._inflight > 0:
                    left = deadline - monotonic()
                    if left <= 0:
                        break
                    self._cond.wait(min(left, 0.2))
        with self._cond:
            self._closing = True
            self._cond.notify_all()
        if self._wire is not None:
            self._wire.stop()
        for t in self._threads:
            t.join(timeout=max(15.0, self._spawn_timeout / 4.0))
        if self._metrics is not None:
            self._metrics.close()
            self._metrics = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close(drain=not any(exc))
        return False


def _elastic_sleep(seconds: float) -> None:
    time.sleep(seconds)
