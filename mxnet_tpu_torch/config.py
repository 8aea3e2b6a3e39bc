"""The environment-variable knob layer, for the knobs the port reads.

The port's own copy of the reference package's ``config.py``: the same
``register``/``get``/``set``/``reset``/``on_change`` surface, and the
same names and defaults for the knobs this package reads — the
``MXNET_TPU_SERVE*`` knobs that ``InferenceServer``,
``GenerativeServer`` and ``KVCache`` consult, ``MXNET_TPU_LOCKCHECK`` and ``MXNET_TPU_FAULTS`` read by
the copies of ``lockcheck.py`` and ``faults.py``, and the
``MXNET_TPU_CKPT_*`` knobs of :mod:`.checkpoint`, and the compile
levers the executor and ``Module`` read (``MXNET_TPU_SCAN_LAYERS``,
``MXNET_TPU_REMAT`` with its legacy alias ``MXNET_EXEC_ENABLE_REMAT``,
``MXNET_TPU_GROUP_UPDATE``), and the data plane's and the async fit
loop's (``MXNET_USE_NATIVE_IO``, ``MXNET_CPU_WORKER_NTHREADS``,
``MXNET_PREFETCH_BUFFER``, ``MXNET_TPU_DATA_*``,
``MXNET_TPU_ASYNC_WINDOW``, ``MXNET_TPU_DEVICE_PREFETCH``,
``MXNET_TPU_DEVICE_METRICS``), the compiled update's switch
(``MXNET_TPU_FUSED_TRAINER``), and the analyzer's (the bind-time
check, its HBM budget and the roofline's bandwidth:
``MXNET_TPU_ANALYZE``, ``MXNET_TPU_ANALYZE_HBM_BUDGET``,
``MXNET_TPU_ANALYZE_HBM_GBPS``), and the
observability knobs of :mod:`.profiler` and :mod:`.obs`
(``MXNET_TPU_OBS``, ``MXNET_TPU_OBS_METRICS_PORT``,
``MXNET_TPU_OBS_PEAK_FLOPS``, ``MXNET_TPU_OBS_BLACKBOX`` with its
``_RING`` and ``_FLUSH_SECS``, ``MXNET_PROFILER_AUTOSTART``), and the
serving fleet's (``MXNET_TPU_FLEET`` and its ``_REPLICAS``,
``_STATS_PERIOD``, ``_QUEUE_BOUND``, ``_MAX_RESPAWNS`` and
``_SPAWN_TIMEOUT``, with the respawn backoff
``MXNET_TPU_ELASTIC_BACKOFF`` / ``_MAX``), and the training
supervisor's restart budget (``MXNET_TPU_ELASTIC_MAX_RESTARTS``), the
tuner's (``MXNET_TPU_TUNE`` and its ``_PROBE_SECS``, ``_PROBE_STEPS``,
``_MAX_PROBES`` and ``_STORE``), and two op-level knobs
(``MXNET_TPU_LAYERNORM_TWO_PASS``, ``MXNET_ENGINE_TYPE``). Knobs of
features the port does not have yet arrive with those features.

:func:`describe` lists every knob with its value and where the value
came from; :func:`snapshot_overrides` / :func:`restore_overrides` scope
a caller's :func:`set` calls.
"""
from __future__ import annotations

import os
from typing import Any, Callable, Dict

__all__ = ["get", "set", "reset", "register", "on_change", "KNOBS",
           "describe", "snapshot_overrides", "restore_overrides"]


class _Knob:
    def __init__(self, name: str, typ: Callable, default: Any, doc: str):
        self.name = name
        self.typ = typ
        self.default = default
        self.doc = doc


KNOBS: Dict[str, _Knob] = {}
_overrides: Dict[str, Any] = {}
_listeners: Dict[str, list] = {}


def register(name: str, typ, default, doc: str) -> None:
    KNOBS[name] = _Knob(name, typ, default, doc)


def on_change(name: str, fn: Callable[[Any], None]) -> None:
    """Call ``fn(new_value)`` whenever ``set``/``reset`` changes the knob."""
    KNOBS[name]   # raise on unknown
    _listeners.setdefault(name, []).append(fn)


def _notify(name: str) -> None:
    for fn in _listeners.get(name, ()):
        fn(get(name))


def _parse_bool(v) -> bool:
    if isinstance(v, bool):
        return v
    return str(v).strip().lower() in ("1", "true", "yes", "on")


def _parse_lockcheck(v) -> str:
    s = str(v).strip().lower()
    if s in ("", "0", "off", "false", "no", "none"):
        return "off"
    if s in ("warn", "warning", "1", "on", "true", "yes"):
        return "warn"
    if s == "abort":
        return "abort"
    raise ValueError(
        "MXNET_TPU_LOCKCHECK must be off|warn|abort, got %r" % (v,))


register("MXNET_TPU_FUSED_TRAINER", _parse_bool, True,
         "gluon Trainer.step / Module.update / Module's fit step: run "
         "every parameter's update as one structure-cached compiled "
         "program (torch.compile), and the fit step's forward and "
         "backward as another; 0 = the eager forward, backward and "
         "grouped update")
register("MXNET_TPU_SERVE", _parse_bool, True,
         "serve.InferenceServer: coalesce concurrent requests into "
         "bucket-padded micro-batches served by a finite runner set; "
         "0 = per-request eager forward in the caller thread (no "
         "batching, no bucketing — the debugging/bisection fallback)")
register("MXNET_TPU_SERVE_MAX_BATCH", int, 32,
         "serve: default micro-batch row bound (requests coalesced per "
         "dispatch; the largest batch bucket)")
register("MXNET_TPU_SERVE_MAX_DELAY_US", int, 2000,
         "serve: default batching window — how long the oldest queued "
         "request may wait for co-riders before the batch launches")
register("MXNET_TPU_SERVE_KV_INT8", _parse_bool, False,
         "serve.GenerativeServer: store the decode KV cache as int8 with "
         "per-page f32 scales instead of f32 — the cache reservation "
         "shrinks ~4x (≈2x max resident sequences under a typical "
         "MXNET_TPU_ANALYZE_HBM_BUDGET once scales and slack are paid), "
         "at a documented logits tolerance")
register("MXNET_TPU_SERVE_QUEUE_BOUND", int, 1024,
         "serve: default admission bound; submit_generate() load-sheds "
         "(QueueFull) when this many requests are already queued")
register("MXNET_TPU_SERVE_MAX_SEQUENCES", int, 8,
         "serve.GenerativeServer: default max resident decode sequences "
         "(the KV cache's preallocated slot count; also the decode "
         "batch width). Overridden by the max_sequences argument")
register("MXNET_TPU_SERVE_PREFILL_TOKENS", int, 2048,
         "serve.GenerativeServer: prefill token budget per scheduler "
         "iteration — joins admitted between two decode steps may "
         "prefill at most this many (bucket-padded) prompt tokens")
register("MXNET_TPU_SERVE_DECODE_BUCKETS", str, "",
         "serve.GenerativeServer: explicit comma-separated decode "
         "sequence-length bucket ladder (e.g. '128,256,512'); empty = "
         "powers of two from the page size up to the model's max "
         "sequence length. Every bucket must be a multiple of the KV "
         "page size")
register("MXNET_TPU_SERVE_KV_PAGE", int, 16,
         "serve.GenerativeServer: KV-cache page size in tokens — slot "
         "capacity is accounted page-at-a-time. Must divide every "
         "decode bucket")
def _parse_analyze_mode(v) -> str:
    s = str(v).strip().lower()
    if s in ("", "0", "off", "false", "no", "none"):
        return "off"
    if s in ("warn", "warning", "1", "on", "true", "yes"):
        return "warn"
    if s == "strict":
        return "strict"
    raise ValueError(
        "MXNET_TPU_ANALYZE must be off|warn|strict, got %r" % (v,))


register("MXNET_PROFILER_AUTOSTART", _parse_bool, False,
         "start mt.profiler at import")
register("MXNET_TPU_OBS", _parse_bool, False,
         "mt.obs: record structured spans (per-thread lanes + chrome-trace "
         "flow events linking one batch across prefetch/train/metric/"
         "checkpoint/serve threads) into the profiler event buffer even "
         "while the profiler state is 'stop'; 0 = span() is a shared "
         "no-op (zero allocations)")
register("MXNET_TPU_OBS_METRICS_PORT", int, -1,
         "mt.obs: HTTP /metrics exposition (Prometheus text format) "
         "started by serve.InferenceServer and serve.GenerativeServer: "
         "-1 = off, 0 = ephemeral port (read it back from "
         "server.metrics_port), >0 = fixed port")
register("MXNET_TPU_OBS_PEAK_FLOPS", float, 0.0,
         "mt.obs: override the per-device peak dense FLOP/s used for the "
         "obs_mfu gauge (0 = from the card's name: torch.cuda."
         "get_device_name(); set it on a card the table does not know or "
         "in tests)")
register("MXNET_TPU_OBS_BLACKBOX", str, "",
         "mt.obs flight recorder: directory the bounded in-memory event "
         "ring (span closes, counter deltas, fault fires, checkpoint "
         "phases) is flushed to as blackbox-p<rank>.jsonl — periodically "
         "and at every terminal moment (fault fire, SIGTERM/143, "
         "NANCHECK abort, crash), so a killed process still leaves its "
         "last window on disk. Merge with `python -m mxnet_tpu_torch.obs "
         "blackbox <dir>`. Empty = off (the recorder module is never "
         "imported)")
register("MXNET_TPU_OBS_BLACKBOX_RING", int, 512,
         "mt.obs flight recorder: events kept in the in-memory ring (each "
         "flush rewrites the file with exactly this window, so the "
         "on-disk artifact stays bounded at any run length)")
register("MXNET_TPU_OBS_BLACKBOX_FLUSH_SECS", float, 5.0,
         "mt.obs flight recorder: heartbeat flush period in seconds — a "
         "SIGKILL'd process still leaves a window no older than this on "
         "disk; 0 = event-driven flushes only")
register("MXNET_TPU_ANALYZE", _parse_analyze_mode, "off",
         "run mxnet_tpu_torch.analysis graph passes at Executor/Module "
         "bind (and the serve KV cache's budget audit): off = analyzer "
         "never imported (zero cost), warn = log WARNING+ findings, "
         "strict = raise MXNetError on ERROR findings before the bind "
         "allocates")
register("MXNET_TPU_ANALYZE_HBM_BUDGET", str, "",
         "per-device memory budget for the analysis hbm-budget pass "
         "(bytes, K/M/G/T suffixes: '16G'); when the static peak "
         "estimate (bound buffers + activation high-water) exceeds it "
         "the bind gets an ERROR finding naming the offending arrays — "
         "rejected under MXNET_TPU_ANALYZE=strict; the serve KV cache's "
         "reservation is audited against it too. Empty = no budget")
register("MXNET_TPU_ANALYZE_HBM_GBPS", float, 0.0,
         "HBM bandwidth (GB/s) for the analysis roofline balance point; "
         "0 = from the card's name (analysis.roofline's table: NVIDIA "
         "H100 80GB HBM3); set it on a card the table does not know and "
         "in CPU tests")
register("MXNET_TPU_FLEET", _parse_bool, False,
         "fleet.Gateway: opt-in switch for the multi-replica serving "
         "fleet (mxnet_tpu_torch.fleet). Off = the gateway refuses to "
         "start and the package is never imported by the serve path — "
         "spawning replica subprocesses is an explicit deployment "
         "decision, not a framework default")
register("MXNET_TPU_FLEET_REPLICAS", int, 2,
         "fleet: default replica-world size when Gateway(replicas=) / "
         "python -m mxnet_tpu_torch.fleet serve --replicas is not given")
register("MXNET_TPU_FLEET_STATS_PERIOD", float, 0.5,
         "fleet.Gateway: heartbeat cadence in seconds — each tick "
         "polls every replica's stats() snapshot (queue depth + KV "
         "occupancy feed least-loaded routing) and doubles as the "
         "liveness probe (connection REFUSED marks the replica dead; "
         "a timeout is ambiguous and never kills)")
register("MXNET_TPU_FLEET_QUEUE_BOUND", int, 256,
         "fleet.Gateway: admission bound on gateway-resident in-flight "
         "requests; beyond it submits shed with QueueFull")
register("MXNET_TPU_FLEET_MAX_RESPAWNS", int, 16,
         "fleet: per-replica supervisor respawn budget — a replica "
         "that dies more than this many times is marked failed and "
         "left down (backoff reuses MXNET_TPU_ELASTIC_BACKOFF/_MAX "
         "between attempts)")
register("MXNET_TPU_FLEET_SPAWN_TIMEOUT", float, 240.0,
         "fleet: seconds a freshly spawned replica may take to answer "
         "its first PING (model build + bind + kernel load); past it "
         "the spawn is scored failed and retried under the respawn "
         "budget")
register("MXNET_TPU_ELASTIC_BACKOFF", float, 1.0,
         "supervisors (the fleet's per-replica respawn): base seconds "
         "of the exponential restart backoff (doubles per consecutive "
         "restart, plus up to 25 percent jitter)")
register("MXNET_TPU_ELASTIC_BACKOFF_MAX", float, 60.0,
         "supervisors: backoff ceiling in seconds")
register("MXNET_TPU_ELASTIC_MAX_RESTARTS", int, 10,
         "mt.elastic supervisor: restarts allowed before giving up and "
         "returning the child's exit status (exit 143 and crashes both "
         "count as preemptions)")


def _parse_tune(v) -> str:
    s = str(v).strip().lower()
    if s in ("", "0", "off", "false", "no", "none"):
        return "off"
    if s in ("auto", "on", "true", "yes", "1"):
        return "auto"
    if s == "static":
        return "static"
    raise ValueError(
        "MXNET_TPU_TUNE must be off|auto|static, got %r" % (v,))


register("MXNET_TPU_TUNE", _parse_tune, "off",
         "fit(): self-tuning performance search (mxnet_tpu_torch.tune) — "
         "auto = load the stored TunedConfig for this program "
         "fingerprint or run the static-prune + probe search and apply "
         "the winner's knobs before bind; static = static pruning and "
         "ranking only, no probe subprocesses (deterministic); off = the "
         "tune package is never imported (zero cost)")
register("MXNET_TPU_TUNE_PROBE_SECS", float, 120.0,
         "tune.search: per-probe subprocess deadline in seconds (a "
         "timed-out probe is scored failed and the search keeps its "
         "partial results)")
register("MXNET_TPU_TUNE_PROBE_STEPS", int, 8,
         "tune.search: measured steps per probe run (after the 2 "
         "obs-warmup steps that absorb the first-call costs)")
register("MXNET_TPU_TUNE_MAX_PROBES", int, 4,
         "tune.search: empirical probe budget — statically ranked "
         "candidates probed per search (the default config is always "
         "probed in addition); 0 = static-only ranking")
register("MXNET_TPU_TUNE_STORE", str, "",
         "tune: TunedConfig store directory; empty = the executable "
         "cache's directory (aot.enabled(), none in the port yet), so "
         "no persistence")
register("MXNET_TPU_LAYERNORM_TWO_PASS", _parse_bool, False,
         "LayerNorm: two-pass E[(x-mean)^2] variance instead of the "
         "one-pass E[x^2]-E[x]^2 form — restores precision for "
         "large-offset activations at one extra read of x (read on "
         "every call)")
register("MXNET_ENGINE_TYPE", str, "ThreadedEngine",
         "NaiveEngine = synchronous op dispatch (each imperative op "
         "returns once the card's stream is idle: failures surface at "
         "the op that caused them); ThreadedEngine = CUDA's asynchronous "
         "dispatch")
register("MXNET_TPU_FAULTS", str, "",
         "deterministic fault injection: comma list of "
         "<site>@<nth>[:kind] specs fired at named injection points "
         "(serve.submit, serve.decode, serve.evict, ...). Parsed once "
         "at import by mxnet_tpu_torch.faults; zero-cost when empty. "
         "NEVER set in production")
register("MXNET_TPU_LOCKCHECK", _parse_lockcheck, "off",
         "runtime lock witness: wrap locks created through the "
         "lockcheck funnels to record acquisition order and flag the "
         "first observed lock-order inversion. warn = log, abort = "
         "raise MXNetError before the inversion's blocking acquire; "
         "off = plain threading primitives")

register("MXNET_TPU_CKPT_ASYNC", _parse_bool, True,
         "checkpoint: hand checkpoint serialization (device fetch, "
         "checksums, npz encode, fsync) to the bounded background writer "
         "thread so the step loop resumes after snapshot capture; 0 = "
         "synchronous saves that block the caller for the full write")
register("MXNET_TPU_CKPT_KEEP", int, 5,
         "checkpoint: retention — keep the newest N valid checkpoints "
         "after each save (keep-every-K survivors and the newest valid "
         "checkpoint are always kept); 0 = keep everything")
register("MXNET_TPU_CKPT_WRITE_RETRIES", int, 3,
         "checkpoint: bounded retry of a failed checkpoint write on "
         "TRANSIENT IO errors (EIO/ENOSPC/EINTR) with exponential "
         "backoff before the failure is recorded and re-raised at "
         "close; each retry counts ckpt_write_retry. 0 = fail on the "
         "first error")

register("MXNET_EXEC_ENABLE_REMAT", _parse_bool, False,
         "rematerialize the train step's forward (less device memory, "
         "more FLOPs); an alias of MXNET_TPU_REMAT="
         "dots_with_no_batch_dims_saveable, which an explicit "
         "MXNET_TPU_REMAT overrides")


def _parse_scan_layers(v) -> str:
    s = str(v).strip().lower()
    if s in ("", "0", "off", "false", "no", "none"):
        return "off"
    if s in ("auto", "on", "true", "yes", "1"):
        return "auto"
    if s.isdigit() and int(s) >= 2:
        return s
    raise ValueError(
        "MXNET_TPU_SCAN_LAYERS must be off|auto|<min-repeat >= 2>, "
        "got %r" % (v,))


register("MXNET_TPU_SCAN_LAYERS", _parse_scan_layers, "auto",
         "scan-over-layers: find the repeated homogeneous blocks "
         "(transformer layers) of a bound graph and run them as one "
         "plan, layer by layer (the unit per-block remat wraps); auto = "
         "chains of >= 4 verified-isomorphic blocks, an integer "
         "overrides that minimum, off = no plan")
register("MXNET_TPU_GROUP_UPDATE", _parse_bool, True,
         "with a scan plan bound, count each per-layer parameter family "
         "of uniform lr/wd multipliers as one update group "
         "(fused_update_grouped, fused_update_groups); the update's "
         "arithmetic is the same either way")


def _parse_remat(v) -> str:
    s = str(v).strip()
    low = s.lower()
    if low in ("", "0", "off", "false", "no", "none"):
        return "off"
    if low == "auto":
        return "auto"
    return s   # a policy name, validated at use


register("MXNET_TPU_REMAT", _parse_remat, "off",
         "applied rematerialization for the train step: off = save all "
         "activations, auto = apply the policy the analysis "
         "remat-opportunity pass suggests for this graph, any other "
         "value = a policy name applied as-is (nothing_saveable, "
         "dots_saveable, dots_with_no_batch_dims_saveable, ...)")


register("MXNET_USE_NATIVE_IO", _parse_bool, True,
         "use the C++ data path (native/: RecordIO codec, jpeg/png "
         "decode, threaded augment pipeline), built with g++ against "
         "libjpeg and libpng at first use; a failed build raises. 0 = the "
         "pure-Python/cv2 path")
register("MXNET_CPU_WORKER_NTHREADS", int, 4,
         "decode/augment worker threads in record iterators")
register("MXNET_PREFETCH_BUFFER", int, 4,
         "batches buffered ahead by record iterators")
register("MXNET_TPU_ASYNC_WINDOW", int, 2,
         "fit(): max train steps queued on the card ahead of their "
         "completion (a CUDA event per step; pushing past the window "
         "waits on the oldest); 0 = the synchronous per-batch loop")
register("MXNET_TPU_DEVICE_PREFETCH", int, 2,
         "fit(): batches copied to the card ahead of the step consuming "
         "them (pinned staging buffers, an H2D copy on its own CUDA "
         "stream); 0 = copy each batch on the critical path")
register("MXNET_TPU_DEVICE_METRICS", _parse_bool, True,
         "EvalMetric.update_device: sum (value, count) on the card after "
         "the step, the host read deferred to get()/log boundaries; 0 = "
         "the loop counts a host sync per batch (loop_host_sync)")
def _parse_nancheck(v) -> str:
    s = str(v).strip().lower()
    if s in ("", "0", "off", "false", "no", "none"):
        return "off"
    if s in ("warn", "warning", "1", "on", "true", "yes"):
        return "warn"
    if s == "abort":
        return "abort"
    raise ValueError(
        "MXNET_TPU_NANCHECK must be off|warn|abort, got %r" % (v,))


register("MXNET_TPU_NANCHECK", _parse_nancheck, "off",
         "non-finite step guard: or an isfinite reduction of every "
         "output into flags kept on the device after each fused train "
         "step (no host read; fit reads them at the epoch log boundary "
         "and counts loop_nonfinite when an output went NaN/Inf). warn = "
         "log naming the first non-finite output, abort = raise "
         "MXNetError there; off = nothing is computed")
register("MXNET_TPU_DATA_WORKERS", int, 2,
         "data.DataLoader: default worker PROCESSES decoding disjoint "
         "shard ranges in parallel (overridden by the num_workers "
         "argument); 0 = decode inline in the consumer thread")
register("MXNET_TPU_DATA_QUEUE_DEPTH", int, 4,
         "data.DataLoader: decoded batches buffered per worker process "
         "(the backpressure bound)")
register("MXNET_TPU_DATA_MP", _parse_bool, True,
         "data.DataLoader: multi-process decode kill switch — 0 forces "
         "the inline path regardless of num_workers (same stream order)")


def _parse_timeout(v) -> float:
    t = float(v)
    if not t > 0:
        raise ValueError(
            "MXNET_TPU_DATA_TIMEOUT must be a positive number of seconds, "
            "got %r" % (v,))
    return t


register("MXNET_TPU_DATA_TIMEOUT", _parse_timeout, 300.0,
         "data.DataLoader: seconds the consumer waits for the next batch "
         "from a worker that is alive but delivers nothing (restarted by "
         "a respawn); past it the pool is torn down and next() raises "
         "MXNetError instead of waiting forever")


def get(name: str):
    """Current value: runtime override > environment > default."""
    knob = KNOBS[name]
    if name in _overrides:
        return _overrides[name]
    raw = os.environ.get(name)
    if raw is None:
        return knob.default
    return knob.typ(raw)


def set(name: str, value) -> None:     # noqa: A001 (reference-style name)
    """Runtime override (takes precedence over the environment)."""
    knob = KNOBS[name]
    _overrides[name] = knob.typ(value)
    _notify(name)


def reset(name: str) -> None:
    """Drop a runtime override, reverting to environment/default."""
    _overrides.pop(name, None)
    _notify(name)


_NO_OVERRIDE = object()


def snapshot_overrides(names) -> Dict[str, Any]:
    """Capture the runtime-override state of ``names`` for a later
    :func:`restore_overrides`. A name with no current override is
    recorded as such (its restore is :func:`reset`, not a ``set`` of the
    computed value, so environment changes in between still show
    through)."""
    return {str(n): _overrides.get(n, _NO_OVERRIDE) for n in names}


def restore_overrides(snapshot: Dict[str, Any]) -> None:
    """Undo every :func:`set` made since the matching
    :func:`snapshot_overrides`: re-instate the old override, or drop the
    knob back to environment/default."""
    for name, value in snapshot.items():
        if value is _NO_OVERRIDE:
            reset(name)
        else:
            set(name, value)


def describe() -> str:
    """Human-readable table of every knob, its value and source."""
    lines = []
    for name, knob in sorted(KNOBS.items()):
        src = "override" if name in _overrides else \
            ("env" if name in os.environ else "default")
        lines.append("%-36s %-22r (%s)  %s"
                     % (name, get(name), src, knob.doc))
    return "\n".join(lines)


def _apply_import_knobs() -> None:
    """Knobs that act once at package import."""
    if get("MXNET_PROFILER_AUTOSTART"):
        from . import profiler
        profiler.set_state("run")
