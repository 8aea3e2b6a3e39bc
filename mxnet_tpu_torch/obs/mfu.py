"""Always-on utilization accounting: ``obs_mfu`` / ``obs_flops_per_sec``.

The port's counterpart of the reference package's ``obs/mfu.py``: every
``Module`` with a train step registers a weak collector; ``collect()``
(run by ``mt.obs.report()`` and the Prometheus exposition) measures
completed steps per wall second and multiplies by the static per-step
FLOP count from the :mod:`mxnet_tpu_torch.analysis` cost model (forward
FLOPs x3 for a training step, the same fwd + ~2x-in-bwd convention as
the reference).

The hot loop stays untouched:

* the per-step cost is one counter and, on the second step, one
  ``perf_counter`` read (``Module._fit_step`` keeps them inline); no
  locks, no device syncs;
* rates are measured **between collects**: a collect waits on the last
  step's CUDA event (``Module._step_token``; one wait — it is a
  diagnostic read, a log boundary) and the steps/s is (steps since the
  previous collect) / (wall since the previous collect). Call
  ``report()`` once after warm-up and once after the measured region,
  like a Prometheus ``rate()``. Nothing here calls
  ``torch.cuda.synchronize()``.

Peak FLOP/s resolves from the device kind (``torch.cuda.get_device_name``)
through :data:`PEAK_FLOPS_BY_DEVICE_KIND`, or the
``MXNET_TPU_OBS_PEAK_FLOPS`` override for a kind the table does not
know and for tests. The table keeps the reference's TPU rows beside the
one card the port runs on, so the two can be compared.
"""
from __future__ import annotations

import time
import weakref
from typing import Any, Dict, List, Optional

from .. import config as _config
from .. import lockcheck as _lockcheck
from .. import profiler as _profiler

__all__ = ["peak_flops", "register_executor", "collect",
           "OBS_WARMUP_STEPS", "TRAIN_FLOP_MULTIPLIER",
           "PEAK_FLOPS_BY_DEVICE_KIND"]

# steps skipped before the rate window opens (the warm-up steps)
OBS_WARMUP_STEPS = 2
# training step ~ 3x forward FLOPs (fwd + ~2x in bwd)
TRAIN_FLOP_MULTIPLIER = 3.0

# dense bf16 peak FLOP/s by device kind. An NVIDIA row matches the whole
# name torch.cuda.get_device_name() gives (the H100 SXM5 80 GB: 989.4
# TFLOP/s dense bf16 on its data sheet, rounded as PERF.md uses it);
# another NVIDIA card resolves to None. The TPU rows are the
# reference's (a substring of the jax device_kind).
PEAK_FLOPS_BY_DEVICE_KIND = [
    ("NVIDIA H100 80GB HBM3", 989e12),
    ("v5 lite", 197e12), ("v5e", 197e12), ("v5p", 459e12),
    ("v6", 918e12), ("v4", 275e12), ("v3", 123e12), ("v2", 45e12)]

_reg_lock = _lockcheck.Lock(name="obs.mfu.reg_lock")
# serializes whole collects: two concurrent collectors (report() + a
# /metrics scrape) must not race the read-modify-write of each module's
# rate baseline. The baseline is SHARED across consumers — every collect
# closes and reopens the window, so an interleaved scrape shortens
# (never skews) a report() pair's window.
_collect_lock = _lockcheck.Lock(name="obs.mfu.collect_lock")
_executors: List[weakref.ref] = []


def _device_kind() -> Optional[str]:
    import torch
    if not torch.cuda.is_available():
        return None
    return torch.cuda.get_device_name(0)


def peak_flops(device_kind: Optional[str] = None) -> Optional[float]:
    """Peak dense FLOP/s: the ``MXNET_TPU_OBS_PEAK_FLOPS`` override wins,
    else the device-kind table; None when unknown (MFU is then not
    fabricated)."""
    override = float(_config.get("MXNET_TPU_OBS_PEAK_FLOPS"))
    if override > 0:
        return override
    if device_kind is None:
        try:
            device_kind = _device_kind()
        except Exception:                                  # noqa: BLE001
            return None
    dk = (device_kind or "").strip().lower()
    if not dk:
        return None
    for kind, peak in PEAK_FLOPS_BY_DEVICE_KIND:
        if kind.startswith("NVIDIA "):
            if dk == kind.lower():
                return peak
        elif "nvidia" not in dk and kind in dk:
            return peak
    return None


def register_executor(mod) -> None:
    """Weakly register a Module for collection (called from
    ``Module._build_fused_step``; dead refs are swept on every call)."""
    with _reg_lock:
        _executors[:] = [r for r in _executors
                         if r() is not None and r() is not mod]
        _executors.append(weakref.ref(mod))


def _flops_per_step(mod) -> Optional[float]:
    """Static FLOPs of one train step via the analysis cost model,
    cached on the module (0.0 caches a failed/unavailable analysis so it
    is attempted once, not per collect)."""
    cached = getattr(mod, "_obs_flops_per_step", None)
    if cached is not None:
        return cached or None
    val = 0.0
    try:
        report = mod.analyze()
        cost = report.extras.get("cost", {})
        fwd = float(cost.get("flops") or 0)
        mult = TRAIN_FLOP_MULTIPLIER \
            if getattr(mod, "optimizer_initialized", False) else 1.0
        val = fwd * mult
        mod._obs_cost = {"flops": val,
                         "bytes_moved": float(cost.get("bytes_moved")
                                              or 0) * mult}
    except Exception:                                      # noqa: BLE001
        pass       # partial graphs / custom ops: report without MFU
    mod._obs_flops_per_step = val
    return val or None


def collect() -> List[Dict[str, Any]]:
    """One utilization sample per live registered module; updates the
    ``obs_mfu`` / ``obs_flops_per_sec`` gauges from the busiest one.
    Serialized: see ``_collect_lock`` for the shared-window semantics."""
    with _collect_lock:
        return _collect_locked()


def _collect_locked() -> List[Dict[str, Any]]:
    with _reg_lock:
        refs = list(_executors)
    live = [m for m in (ref() for ref in refs) if m is not None]
    if not live:
        return []
    peak = peak_flops()
    out: List[Dict[str, Any]] = []
    best = None
    for mod in live:
        steps = int(getattr(mod, "_obs_steps", 0))
        rec: Dict[str, Any] = {
            "name": getattr(mod, "_obs_label", type(mod).__name__),
            "steps": steps,
            "flops_per_step": _flops_per_step(mod),
            "steps_per_sec": None,
            "flops_per_sec": None,
            "mfu": None,
            "peak_flops": peak,
            "cost": getattr(mod, "_obs_cost", None),
            "mesh": None,        # one device: meshes are ROADMAP A9
        }
        t0 = getattr(mod, "_obs_t0", None)
        # >= so a collect at EXACTLY the warm-up steps still sets the
        # baseline; dn == 0 then just reports no rate yet
        if steps >= OBS_WARMUP_STEPS and t0 is not None:
            step_token = getattr(mod, "_step_token", None)
            token = step_token() if step_token is not None else None
            if token is not None:
                try:
                    # the window closes on COMPLETED device work: the
                    # last step's CUDA event, not a device-wide sync
                    token.synchronize()  # mx-lint: allow(lock-host-sync)
                except Exception:                          # noqa: BLE001
                    pass
            now = time.perf_counter()
            base = getattr(mod, "_obs_baseline", None) \
                or (OBS_WARMUP_STEPS, t0)
            dn, dt = steps - base[0], now - base[1]
            if dn > 0 and dt > 0:
                rec["steps_per_sec"] = dn / dt
            mod._obs_baseline = (steps, now)
        if rec["steps_per_sec"] and rec["flops_per_step"]:
            fs = rec["steps_per_sec"] * rec["flops_per_step"]
            rec["flops_per_sec"] = fs
            if peak:
                rec["mfu"] = fs / peak
            if best is None or fs > best["flops_per_sec"]:
                best = rec
        out.append(rec)
    if best is not None:
        _profiler.set_gauge("obs_flops_per_sec", best["flops_per_sec"])
        if best["mfu"] is not None:
            _profiler.set_gauge("obs_mfu", best["mfu"])
    return out
