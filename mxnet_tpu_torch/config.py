"""The environment-variable knob layer, for the knobs the port reads.

The port's own copy of the reference package's ``config.py``: the same
``register``/``get``/``set``/``reset``/``on_change`` surface, and the
same names and defaults for the knobs this package reads — the
``MXNET_TPU_SERVE_*`` knobs that ``GenerativeServer`` and ``KVCache``
consult, ``MXNET_TPU_LOCKCHECK`` and ``MXNET_TPU_FAULTS`` read by
the copies of ``lockcheck.py`` and ``faults.py``, and the
``MXNET_TPU_CKPT_*`` knobs of :mod:`.checkpoint`, and the compile
levers the executor and ``Module`` read (``MXNET_TPU_SCAN_LAYERS``,
``MXNET_TPU_REMAT`` with its legacy alias ``MXNET_EXEC_ENABLE_REMAT``,
``MXNET_TPU_GROUP_UPDATE``), and the data plane's and the async fit
loop's (``MXNET_USE_NATIVE_IO``, ``MXNET_CPU_WORKER_NTHREADS``,
``MXNET_PREFETCH_BUFFER``, ``MXNET_TPU_DATA_*``,
``MXNET_TPU_ASYNC_WINDOW``, ``MXNET_TPU_DEVICE_PREFETCH``,
``MXNET_TPU_DEVICE_METRICS``). Knobs of features the
port does not have yet (the batch ``InferenceServer``, int8 KV) arrive
with those features.
"""
from __future__ import annotations

import os
from typing import Any, Callable, Dict

__all__ = ["get", "set", "reset", "register", "on_change", "KNOBS"]


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
