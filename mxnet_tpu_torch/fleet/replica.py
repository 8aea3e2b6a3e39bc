"""Fleet replica: one decode server behind the fleet wire.

The port's copy of the reference package's ``fleet/replica.py``. A
replica process is a plain :class:`~mxnet_tpu_torch.serve.server.
GenerativeServer` (built from a JSON model spec, deterministic seeded
init so every replica serves bit-identical weights — the fail-over
re-prefill contract requires it) fronted by :class:`~mxnet_tpu_torch.
fleet.wire.ServeWire`. It builds on the current device, the card,
unless the spec names the CPU (the reference builds on ``cpu()``). A
respawn loads the flash-attention kernels from the build directory the
first spawn (or any process of the checkout) built them into: it
records no ``nvcc`` build (``stats()["native_builds"]``).

Also here: :class:`ScriptedDecodeServer`, a stdlib continuous-batching
*simulator* with the same ``submit_generate()/stats()/close()`` surface.
Its decode step is a timed wait, modeling a regime where the device does
the work and the host idles between steps; the fleet unit tests drive
it so they never pay a model build. Its token function is deterministic
and autoregressive (:func:`scripted_token`), so a re-prefilled
continuation is bit-equal to an uninterrupted stream — exactly the
property the fail-over drill asserts.
"""
from __future__ import annotations

import collections
import json
import os
import signal
import threading
import time
from typing import Any, Dict, List, Optional

from .. import lockcheck as _lockcheck
from .. import profiler as _profiler
from ..serve.server import (DeadlineExceeded, GenerateHandle, QueueFull,
                            ServerClosed)
from ..serve.stats import DecodeLatencyStats, monotonic
from .wire import ServeWire

__all__ = ["ScriptedDecodeServer", "ReplicaFront", "build_from_spec",
           "scripted_token", "run_replica"]


def scripted_token(seq: List[int]) -> int:
    """The scripted decoder's next token — a pure autoregressive
    function of the running sequence, so continuing from ``prompt +
    generated-prefix`` on a different replica reproduces the exact
    stream an uninterrupted decode would have produced."""
    return (31 * sum(seq) + 7) % 251


class _ScriptedSeq(object):
    __slots__ = ("handle", "seq", "generated", "max_new_tokens",
                 "eos_id", "t_submit", "t_last")

    def __init__(self, handle, seq, max_new_tokens, eos_id, t_submit):
        self.handle = handle
        self.seq = seq
        self.generated = 0
        self.max_new_tokens = max_new_tokens
        self.eos_id = eos_id
        self.t_submit = t_submit
        self.t_last = monotonic()


class ScriptedDecodeServer(object):
    """Continuous-batching decode simulator (stdlib, no model).

    Faithful to the GenerativeServer scheduler's shape: admissions
    happen between decode steps (paying a per-token prefill cost that
    stalls the whole batch — the TTFT/TPOT tradeoff is real), one step
    advances every resident sequence by one token, finished sequences
    evict at step granularity. The step itself is a timed wait of
    ``step_s`` — simulated device time.
    """

    def __init__(self, slots: int = 4, step_s: float = 0.02,
                 prefill_s_per_token: float = 0.001,
                 queue_bound: int = 256, name: str = "fleet_scripted"):
        self.name = name
        self.max_sequences = int(slots)
        self.step_s = float(step_s)
        self.prefill_s_per_token = float(prefill_s_per_token)
        self.queue_bound = int(queue_bound)
        self.latency = DecodeLatencyStats(name=name)
        self._lock = _lockcheck.Lock(name="fleet.scripted_lock")
        self._cond = _lockcheck.Condition(self._lock)
        self._waiting: collections.deque = collections.deque()
        self._active: List[_ScriptedSeq] = []
        self._closed = False
        self._worker = threading.Thread(
            target=self._loop, daemon=True,
            name="mxnet_tpu_torch.fleet.scripted[%s]" % name)
        self._worker.start()

    # ------------------------------------------------------------ submit
    def submit_generate(self, prompt, max_new_tokens: int = 32,
                        eos_id: Optional[int] = None,
                        timeout: Optional[float] = None,
                        temperature: float = 0.0,
                        seed: Optional[int] = None,
                        on_token=None) -> GenerateHandle:
        prompt = [int(t) for t in prompt]
        if not prompt:
            raise ValueError("empty prompt")
        if max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        deadline = None if timeout is None else monotonic() + timeout
        handle = GenerateHandle(on_token=on_token)
        with self._cond:
            if self._closed:
                raise ServerClosed("submit_generate() after close()")
            if len(self._waiting) >= self.queue_bound:
                _profiler.incr_counter(self.name + "_shed")
                raise QueueFull("queue depth %d at admission bound %d"
                                % (len(self._waiting), self.queue_bound))
            self._waiting.append(
                (prompt, int(max_new_tokens), eos_id, deadline,
                 handle, monotonic()))
            _profiler.incr_counter(self.name + "_requests")
            self._cond.notify_all()
        return handle

    # --------------------------------------------------------- scheduler
    def _loop(self) -> None:
        while True:
            admitted = []
            with self._cond:
                while not self._waiting and not self._active \
                        and not self._closed:
                    self._cond.wait(0.05)
                if self._closed and not self._waiting \
                        and not self._active:
                    return
                while self._waiting \
                        and len(self._active) < self.max_sequences:
                    req = self._waiting.popleft()
                    admitted.append(req)
            prefill_wait = 0.0
            for prompt, max_new, eos_id, deadline, handle, t0 in admitted:
                if deadline is not None and monotonic() > deadline:
                    _profiler.incr_counter(
                        self.name + "_deadline_expired")
                    handle._finish(DeadlineExceeded(
                        "TTFT deadline expired in queue"))
                    continue
                prefill_wait += self.prefill_s_per_token * len(prompt)
                seq = _ScriptedSeq(handle, list(prompt), max_new, eos_id,
                                   t0)
                with self._lock:
                    self._active.append(seq)
            if prefill_wait > 0.0:
                time.sleep(prefill_wait)    # simulated prefill device time
            with self._lock:
                active = list(self._active)
            if not active:
                continue
            time.sleep(self.step_s)         # simulated decode-step time
            for seq in active:
                tok = scripted_token(seq.seq)
                seq.seq.append(tok)
                seq.generated += 1
                now = monotonic()
                if seq.generated == 1:
                    self.latency.ttft.record(now - seq.t_submit)
                else:
                    self.latency.tpot.record(now - seq.t_last)
                seq.t_last = now
                seq.handle._put(tok)
                _profiler.incr_counter(self.name + "_tokens")
                if seq.generated >= seq.max_new_tokens or \
                        (seq.eos_id is not None and tok == seq.eos_id) \
                        or seq.handle._cancelled:
                    with self._lock:
                        self._active.remove(seq)
                    seq.handle._finish(None)

    # ------------------------------------------------------------- stats
    def stats(self) -> Dict[str, Any]:
        with self._lock:
            active = len(self._active)
            waiting = len(self._waiting)
        return {
            "requests": _profiler.get_counter(self.name + "_requests"),
            "tokens": _profiler.get_counter(self.name + "_tokens"),
            "active_sequences": active,
            "waiting": waiting,
            "shed": _profiler.get_counter(self.name + "_shed"),
            "deadline_expired": _profiler.get_counter(
                self.name + "_deadline_expired"),
            "kv": {
                "slots_in_use": active,
                "max_slots": self.max_sequences,
                "occupancy": round(active / float(self.max_sequences), 4),
            },
            "ttft": self.latency.ttft.snapshot(),
            "tpot": self.latency.tpot.snapshot(),
        }

    # ------------------------------------------------------------- close
    def close(self, drain: bool = True,
              timeout: Optional[float] = None) -> None:
        with self._cond:
            self._closed = True
            if not drain:
                dropped = list(self._waiting)
                self._waiting.clear()
                for seq in self._active:
                    seq.handle._cancelled = True
            else:
                dropped = []
            self._cond.notify_all()
        for _p, _m, _e, _d, handle, _t in dropped:
            handle._finish(ServerClosed("server closed"))
        self._worker.join(timeout)


class ReplicaFront(object):
    """What the replica's wire actually fronts: the decode server plus
    the replica-identity surface — rank-labeled Prometheus exposition
    (the gateway's ``/metrics`` federates on the ``replica=<r>`` label)
    and a ``stats()`` superset carrying ``rank`` / ``pid``,
    ``backend_compiles`` (compile records scoped to the server, the
    reference's count: here the serve runners' first calls),
    ``native_builds`` (``nvcc`` / ``g++`` records of this process: 0
    when every kernel library loaded from the build directory) and
    ``kernel_launches`` (the flash-attention wrappers' launch counts in
    this process, by dtype)."""

    def __init__(self, server, rank: int):
        self.server = server
        self.rank = int(rank)

    def submit_generate(self, *args, **kwargs):
        return self.server.submit_generate(*args, **kwargs)

    def stats(self) -> Dict[str, Any]:
        snap = self.server.stats()
        snap["rank"] = self.rank
        snap["pid"] = os.getpid()
        snap.update(self._compile_counts())
        from ..ops.flash_attention import launch_counts
        snap["kernel_launches"] = launch_counts()
        return snap

    def _compile_counts(self) -> Dict[str, int]:
        from ..obs import compiles
        ring = compiles.snapshot()
        name = getattr(self.server, "name", None)
        return {
            "backend_compiles": sum(1 for c in ring
                                    if c.get("scope") == name),
            "native_builds": compiles.native_builds(),
        }

    def metrics_text(self) -> str:
        from ..obs.prometheus import render_prometheus
        return render_prometheus(labels={"replica": str(self.rank)})

    def close(self, *args, **kwargs):
        return self.server.close(*args, **kwargs)


def build_from_spec(spec: Dict[str, Any]):
    """Build the replica's decode server from a JSON-able spec.

    ``{"kind": "transformer", "geo": {...}, "seed": 11, "slots": 4,
    "page": 8, "int8": false, "name": ..., "device": "cpu", "tf32":
    {"matmul": false, "cudnn": false}}`` builds a zoo transformer with
    deterministic seeded init (``np.random.seed(seed)``, then
    ``init.Uniform(0.05)``, as the reference draws: the same spec gives
    the same parameters in either package and on every replica) and
    wraps it in a GenerativeServer on ``device`` (default the current
    device: the card unless a scope says otherwise). ``tf32`` sets
    torch's TF32 switches in this process first (the gateway passes its
    own, so a replica computes as the process that launched it);
    ``{"kind": "scripted", "slots": 4, "step_ms": 20, ...}`` builds the
    device-time simulator.
    """
    kind = spec.get("kind", "transformer")
    name = spec.get("name", "fleet_replica")
    if kind == "scripted":
        return ScriptedDecodeServer(
            slots=int(spec.get("slots", 4)),
            step_s=float(spec.get("step_ms", 20.0)) / 1e3,
            prefill_s_per_token=float(
                spec.get("prefill_ms_per_token", 1.0)) / 1e3,
            queue_bound=int(spec.get("queue_bound", 256)),
            name=name)
    if kind != "transformer":
        raise ValueError("unknown replica spec kind %r" % (kind,))
    import numpy as np
    import torch
    from .. import context as _context
    from .. import initializer as _init
    from ..models import transformer as _transformer
    from ..module import Module
    from ..serve.server import GenerativeServer
    tf32 = spec.get("tf32")
    if tf32 is not None:
        torch.backends.cuda.matmul.allow_tf32 = bool(tf32["matmul"])
        torch.backends.cudnn.allow_tf32 = bool(tf32["cudnn"])
    dev = _context.resolve_device(spec.get("device"))
    geo = dict(spec["geo"])
    net = _transformer.get_symbol(**geo)
    m = Module(net, context=_context.Context(dev))
    s = int(geo["seq_len"])
    # forward-only: the server copies the weights out, so the module
    # needs no gradient buffers
    m.bind(data_shapes=[("data", (1, s))],
           label_shapes=[("softmax_label", (1, s))], for_training=False)
    # initializers draw from global np.random: seeding it makes params
    # bit-identical across replica processes
    np.random.seed(int(spec.get("seed", 11)))
    m.init_params(_init.Uniform(0.05))
    srv = GenerativeServer(
        m, n_heads=int(geo["n_heads"]),
        max_sequences=spec.get("slots"),
        page=spec.get("page"), int8=spec.get("int8"),
        prefill_tokens=spec.get("prefill_tokens"),
        queue_bound=spec.get("queue_bound"),
        name=name, device=dev)
    del m
    if dev.type == "cuda":
        # the module's arrays go back to the driver: four processes
        # share the card
        import gc
        gc.collect()
        torch.cuda.empty_cache()
    return srv


def run_replica(argv: Optional[List[str]] = None) -> int:
    """``python -m mxnet_tpu_torch.fleet replica`` body: build the
    spec'd server, front it with the wire, announce readiness on stdout,
    then park until QUIT, SIGTERM (flag-only handler) or the death of
    the process that launched it (a supervisor killed without cleanup
    must not leave a replica holding the card)."""
    import argparse
    parser = argparse.ArgumentParser(prog="mxnet_tpu_torch.fleet replica")
    parser.add_argument("--port", type=int, default=0)
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--rank", type=int, default=0)
    parser.add_argument("--model-json", default=None)
    parser.add_argument("--model-file", default=None)
    args = parser.parse_args(argv)
    if args.model_json:
        spec = json.loads(args.model_json)
    elif args.model_file:
        with open(args.model_file, "r", encoding="utf-8") as f:
            spec = json.load(f)
    else:
        parser.error("one of --model-json / --model-file is required")
    parent = os.getppid()
    flags = {"stop": False}

    def _on_term(_sig, _frm):       # flag-only: nothing lock-taking
        flags["stop"] = True

    try:
        signal.signal(signal.SIGTERM, _on_term)
    except (ValueError, OSError):
        pass                        # not the main thread (tests)
    server = build_from_spec(spec)
    front = ReplicaFront(server, rank=args.rank)
    wire = ServeWire(front, port=args.port, host=args.host,
                     rank=args.rank, fault_site="replica.die",
                     name="fleet.replica")
    wire.on_quit(lambda: flags.__setitem__("stop", True))
    print(json.dumps({"event": "ready", "rank": args.rank,
                      "port": wire.port, "pid": os.getpid()}),
          flush=True)
    while not flags["stop"] and os.getppid() == parent:
        time.sleep(0.2)
    wire.stop()
    server.close(drain=False, timeout=10.0)
    return 0
