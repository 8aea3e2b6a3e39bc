"""Roofline/utilization pass: why is MFU what it is?

The port of the reference's ``analysis/roofline.py``. ``obs_mfu`` is
always on; this pass attaches the *why*. Two FLOP accountings are
reconciled per program:

* the **analysis cost model** (static, per-node — what ``obs_mfu``
  multiplies by steps/s), and
* the **counted cost** of one run of the program
  (:func:`analyze_executable`). The reference reads XLA's
  ``compiled.cost_analysis()``; the port compiles no program, so it
  runs the function once under a counting dispatch mode instead.

When the two disagree beyond tolerance the model is lying
(``flop-model-drift``), and every MFU number derived from it inherits
the lie. Each program is then classified against the device roofline:
arithmetic intensity (FLOPs / bytes accessed) vs the device balance
point (peak FLOP/s / HBM bandwidth). A memory-bound program's
attainable MFU is ``intensity / balance`` — if measured ``obs_mfu`` is
already there, the gap is the roofline, not scheduling; if measured MFU
is far below attainable, the gap IS scheduling (input stalls, host
syncs) and the async-loop counters are the next place to look.

Peak FLOP/s comes from the one table in :mod:`..obs.mfu`; HBM bandwidth
from :data:`HBM_GBPS_BY_DEVICE_KIND` here, the card's own row only,
matched on the whole name ``torch.cuda.get_device_name()`` gives (the
H100 SXM5 80 GB: 3,350 GB/s on its data sheet, so its balance point is
989e12 / 3.35e12 ≈ 295 FLOP/byte). Another card resolves to None
unless ``MXNET_TPU_ANALYZE_HBM_GBPS`` is set (as on the CPU in tests).
"""
from __future__ import annotations

from typing import Any, Dict, Optional

from .findings import Report, Severity

__all__ = ["classify", "analyze_executable", "explain", "hbm_gbps",
           "count_executable", "device_table_lookup", "flash_flops",
           "HBM_GBPS_BY_DEVICE_KIND", "FLOP_MODEL_DRIFT_TOL"]

# HBM bandwidth (GB/s) by device kind, matched on the whole name — the
# denominator of the balance point. Sibling of
# obs.mfu.PEAK_FLOPS_BY_DEVICE_KIND (peak FLOP/s stays single-sourced
# there).
HBM_GBPS_BY_DEVICE_KIND = [("NVIDIA H100 80GB HBM3", 3350.0)]

# |counted/model - 1| beyond this is a drift finding
FLOP_MODEL_DRIFT_TOL = 0.25

# the flash-attention kernels' ops and their products per live (q, k)
# pair per head-dim element: forward S = QKᵀ, O = PV; dQ recomputes S
# and forms dP and dQ; dK/dV recomputes S and forms dP, dV and dK
_FLASH_OPS = {"flash_attention_fwd": 4, "flash_attention_bwd_dq": 6,
              "flash_attention_bwd_dkv": 8}


def device_table_lookup(table, override_knob: str, default=None,
                        device_kind: Optional[str] = None):
    """The knob-then-device-kind ladder every bandwidth/peak table uses
    (a copy of the reference's): a positive config override wins, else
    the row whose name equals the (probed) ``device_kind``, else
    ``default``."""
    from .. import config as _config
    override = float(_config.get(override_knob))
    if override > 0:
        return override
    if device_kind is None:
        from ..obs import mfu as _mfu
        try:
            device_kind = _mfu._device_kind()
        except Exception:                                   # noqa: BLE001
            device_kind = None
    dk = (device_kind or "").strip().lower()
    for kind, val in table:
        if dk == kind.lower():
            return val
    return default


def hbm_gbps(device_kind: Optional[str] = None) -> Optional[float]:
    """HBM GB/s: the ``MXNET_TPU_ANALYZE_HBM_GBPS`` override wins, else
    the device-kind table; None when unknown (classification is then
    skipped, never fabricated)."""
    return device_table_lookup(HBM_GBPS_BY_DEVICE_KIND,
                               "MXNET_TPU_ANALYZE_HBM_GBPS",
                               default=None, device_kind=device_kind)


def classify(flops: float, bytes_accessed: float,
             device_kind: Optional[str] = None) -> Optional[Dict[str, Any]]:
    """Roofline classification of one program: arithmetic intensity vs
    the device balance point. None when peak/bandwidth are unknown."""
    from ..obs import mfu as _mfu
    peak = _mfu.peak_flops(device_kind)
    bw = hbm_gbps(device_kind)
    if not peak or not bw or not flops or not bytes_accessed:
        return None
    intensity = flops / bytes_accessed
    balance = peak / (bw * 1e9)
    attainable = min(1.0, intensity / balance)
    return {
        "intensity_flops_per_byte": round(intensity, 3),
        "balance_flops_per_byte": round(balance, 3),
        "bound": "compute" if intensity >= balance else "memory",
        "attainable_mfu": round(attainable, 4),
        "peak_flops": peak,
        "hbm_gbps": bw,
    }


def flash_flops(op: str, q_shape, k_shape, causal: bool) -> int:
    """FLOPs of one flash-attention kernel launch (``op`` one of
    ``flash_attention_fwd`` / ``_bwd_dq`` / ``_bwd_dkv``) over (BH, S,
    D) q and (BH, Sk, D) k: products per live (q, k) pair — a causal
    (top-aligned) mask leaves ``sum_i min(i + 1, Sk)`` pairs of S x Sk —
    times D, times BH."""
    bh, s, d = (int(x) for x in q_shape)
    sk = int(k_shape[1])
    pairs = sum(min(i + 1, sk) for i in range(s)) if causal else s * sk
    return _FLASH_OPS[op] * bh * pairs * d


def count_executable(fn, *args, **kwargs) -> Dict[str, Any]:
    """Run ``fn(*args, **kwargs)`` once under a counting dispatch mode
    and return ``{"flops", "bytes", "ops", "flash": {op: {"launches",
    "flops"}}}``.

    Every aten op the run dispatches is counted as it runs: FLOPs by
    ``torch.utils.flop_counter``'s formulas (what ``FlopCounterMode``
    counts: matmuls, convolutions and their backwards, attention) where
    it has one, else one FLOP per element of each floating result (the
    elementwise rule); bytes as the operands and results of each op,
    each read or written once (views move nothing and are skipped).
    That is an **unfused** count: a chain of elementwise ops is counted
    as separate passes over memory, as eager PyTorch runs it. The
    flash-attention kernels (``mxnet_tpu_torch::flash_attention_*``)
    run inside one op each, where no formula can see: each launch is
    counted by :func:`flash_flops` from its shapes, and listed under
    ``flash``. A compiled program's kernels bypass the dispatcher, so
    the run takes the eager forward, backward and optimizer update
    (``MXNET_TPU_FUSED_TRAINER`` off for its duration: it governs the
    compiled fit step and the compiled update), whose ops the mode
    counts."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_leaves
    from torch.utils.flop_counter import flop_registry

    counts: Dict[str, Any] = {"flops": 0, "bytes": 0, "ops": 0,
                              "flash": {}}

    def tensors(tree):
        return [t for t in tree_leaves(tree)
                if isinstance(t, torch.Tensor)]

    class _Counting(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            out = func(*args, **kwargs)
            if func.is_view:
                return out
            ins, outs = tensors((args, kwargs)), tensors(out)
            counts["ops"] += 1
            counts["bytes"] += sum(t.numel() * t.element_size()
                                   for t in ins + outs)
            packet = func._overloadpacket
            name = func._schema.name.split("::", 1)[-1]
            if func.namespace == "mxnet_tpu_torch" and name in _FLASH_OPS:
                q, k = args[0], args[1]
                n = flash_flops(name, q.shape, k.shape, bool(args[-1]))
                rec = counts["flash"].setdefault(name, {"launches": 0,
                                                        "flops": 0})
                rec["launches"] += 1
                rec["flops"] += n
            elif packet in flop_registry:
                n = flop_registry[packet](*args, **kwargs, out_val=out)
            else:
                n = sum(t.numel() for t in outs if t.is_floating_point())
            counts["flops"] += int(n)
            return out

    from .. import config
    knob = ["MXNET_TPU_FUSED_TRAINER"]
    saved = config.snapshot_overrides(knob)
    config.set(knob[0], False)
    try:
        with _Counting():
            fn(*args, **kwargs)
    finally:
        config.restore_overrides(saved)
    return counts


def analyze_executable(fn, *args, model_flops: Optional[float] = None,
                       context: str = "roofline",
                       report: Optional[Report] = None,
                       **kwargs) -> Report:
    """Run ``fn(*args)`` once under :func:`count_executable` and
    reconcile the counted cost with the model.

    ``Report.extras["roofline"]`` keeps the reference's keys:
    ``compiled_flops`` / ``compiled_bytes_accessed`` are the counted
    FLOPs and bytes of the run (unfused: see :func:`count_executable`;
    there is no compiler, so no ``xla_*`` memory keys), the
    classification, and — when ``model_flops`` is given (the analysis
    cost model's count for the same program) — the counted/model
    ``model_ratio``, with a ``flop-model-drift`` WARNING beyond ±25%.
    ``flash`` lists the flash-attention launches and their FLOPs, which
    ``compiled_flops`` includes. ``fn`` runs for real, on whatever
    device its tensors are on."""
    report = report if report is not None else Report(context=context)
    counted = count_executable(fn, *args, **kwargs)
    flops = float(counted["flops"])
    nbytes = float(counted["bytes"])
    roof: Dict[str, Any] = {
        "compiled_flops": flops,
        "compiled_bytes_accessed": nbytes,
        "ops": counted["ops"],
        "flash": counted["flash"],
    }
    cls = classify(flops, nbytes)
    if cls:
        roof.update(cls)
        report.add(
            "roofline", Severity.INFO,
            "%s-bound: intensity %.3g FLOP/byte vs balance %.3g — "
            "attainable MFU %.2f (%.3g GFLOP, %.3g MB accessed)"
            % (cls["bound"], cls["intensity_flops_per_byte"],
               cls["balance_flops_per_byte"], cls["attainable_mfu"],
               flops / 1e9, nbytes / 1e6),
            detail=dict(roof))
    if model_flops:
        ratio = flops / model_flops
        roof["model_flops"] = float(model_flops)
        roof["model_ratio"] = round(ratio, 4)
        if abs(ratio - 1.0) > FLOP_MODEL_DRIFT_TOL and flops:
            report.add(
                "flop-model-drift", Severity.WARNING,
                "analysis FLOP model says %.4g but the counted run says "
                "%.4g (ratio %.2f) — the model is mis-counting this "
                "program's ops and obs_mfu inherits the error; fix the "
                "_node_flops rule for the dominant op"
                % (model_flops, flops, ratio),
                detail={"model_flops": float(model_flops),
                        "compiled_flops": flops, "ratio": ratio})
    report.extras["roofline"] = roof
    return report


def explain(flops: float, bytes_moved: float,
            measured_mfu: Optional[float] = None) -> Optional[Dict[str, Any]]:
    """The ``mt.obs.report()`` reconciliation: classify a program from
    its static cost-model counts and, given the measured ``obs_mfu``,
    say which side of the gap to attack. Returns None when the device
    roofline is unknown."""
    cls = classify(flops, bytes_moved)
    if cls is None:
        return None
    if measured_mfu is not None:
        attainable = cls["attainable_mfu"]
        cls["measured_mfu"] = round(measured_mfu, 4)
        if attainable > 0:
            cls["roofline_fraction"] = round(measured_mfu / attainable, 3)
        if cls["bound"] == "memory" and measured_mfu >= 0.8 * attainable:
            cls["why"] = ("memory-bound at the roofline: measured MFU "
                          "%.2f of attainable %.2f — raise intensity "
                          "(bigger batch / remat / fusion), not "
                          "scheduling" % (measured_mfu, attainable))
        elif measured_mfu < 0.5 * attainable:
            cls["why"] = ("well below the %s roofline (measured %.2f vs "
                          "attainable %.2f) — the gap is scheduling: "
                          "check loop_* counters for input stalls, host "
                          "syncs, recompiles"
                          % (cls["bound"], measured_mfu, attainable))
        else:
            cls["why"] = ("approaching the %s roofline (measured %.2f "
                          "vs attainable %.2f)"
                          % (cls["bound"], measured_mfu, attainable))
    return cls
