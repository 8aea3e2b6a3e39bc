"""Empirical confirmation: short obs-instrumented probe runs.

The port of the reference package's ``tune/probe.py``. Each probe is a
SUBPROCESS (``python -m mxnet_tpu_torch.tune --probe SPEC``) under a
hard deadline: a candidate that wedges or thrashes cannot stall the
search; it times out, scores failed, and the partial results stand. The
child applies the candidate's knobs, runs a real ``fit`` over synthetic
batches shaped exactly like the target program, and reports
``mt.obs.probe_score()``: MFU and steps per second measured from the
obs warm-up boundary (the first steps' one-time costs excluded), and
``loop_recompile``, which must be zero.

Process isolation is the point, not a convenience: a probe binds a
module, sets config knobs and bumps counters, none of which may leak
into the searching process.

The spec names the device, as a fleet replica's spec does: the child
binds on the card unless the spec says ``"device": "cpu"``, and a child
that cannot reach the card fails its probe loudly rather than scoring a
host rate. The spec also carries the searching process's amp policy and
TF32 switches, so the child times the program the parent will train (a
fresh process has torch's default switches).
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time
from typing import Any, Dict, List, Optional

from .. import profiler as _profiler
from .space import Candidate

__all__ = ["make_spec", "run_probe", "run_probe_child", "probe_many"]

# obs opens its rate window after this many steps (obs.mfu contract);
# probes run warmup + measured steps in one epoch
WARMUP_STEPS = 2


def _precision() -> Dict[str, Any]:
    """The searching process's amp policy and TF32 switches."""
    import torch
    from .. import amp
    dt = amp.compute_dtype()
    return {"amp": str(dt).replace("torch.", "") if dt is not None
            else None,
            "tf32": {"matmul": bool(torch.backends.cuda.matmul.allow_tf32),
                     "cudnn": bool(torch.backends.cudnn.allow_tf32)}}


def make_spec(symbol_json: str, data_shapes, label_shapes,
              data_dtypes: Dict[str, str], label_dtypes: Dict[str, str],
              optimizer: str, optimizer_params, candidate: Candidate,
              steps: int, seed: int = 0, device: str = "cuda",
              precision: Optional[Dict[str, Any]] = None
              ) -> Dict[str, Any]:
    """The JSON-serializable probe job description. ``device`` is
    ``"cuda"`` or ``"cpu"``; ``precision`` (default: this process's)
    holds ``amp`` and ``tf32`` as :func:`_precision` gives them."""
    return {
        "symbol": symbol_json,
        "data_shapes": [[str(n), list(s)] for n, s in data_shapes],
        "label_shapes": [[str(n), list(s)]
                         for n, s in (label_shapes or [])],
        "data_dtypes": dict(data_dtypes or {}),
        "label_dtypes": dict(label_dtypes or {}),
        "optimizer": str(optimizer),
        "optimizer_params": dict(optimizer_params or {}),
        "candidate": candidate.to_dict(),
        "steps": int(steps),
        "seed": int(seed),
        "device": "cpu" if str(device).startswith("cpu") else "cuda",
        **(precision if precision is not None else _precision()),
    }


def _synth_arrays(shapes, dtypes, nbatch: int):
    """Synthetic batches: zeros of the bound dtype — index-safe for
    embedding and label inputs, full cost for the arithmetic."""
    import numpy as np
    out = {}
    for name, shape in shapes:
        dt = np.dtype(dtypes.get(name, "float32"))
        full = (int(shape[0]) * nbatch,) + tuple(int(d)
                                                 for d in shape[1:])
        out[name] = np.zeros(full, dtype=dt)
    return out


def device_uniform(scale: float = 0.01, seed: int = 0):
    """An initializer that draws each weight ``U(-scale, scale)`` on its
    own device, from a generator seeded by the seed and the weight's
    name: the same weights in every process on the same card, without a
    host draw and copy of every value (biases, gammas and betas as the
    default initializer sets them)."""
    import hashlib
    import torch
    from ..initializer import Initializer

    class _DeviceUniform(Initializer):
        def _init_weight(self, name, arr):
            t = arr.data
            key = hashlib.sha256(("%d:%s" % (seed, name)).encode()).digest()
            g = torch.Generator(device=t.device).manual_seed(
                int.from_bytes(key[:8], "little") >> 1)
            with torch.no_grad():
                t.uniform_(-scale, scale, generator=g)

    return _DeviceUniform()


def run_probe_child(spec: Dict[str, Any]) -> Dict[str, Any]:
    """Execute one probe in THIS process (the ``--probe`` child entry).
    Returns the score record the parent parses from stdout."""
    import torch
    import mxnet_tpu_torch as mt

    cand = Candidate.from_dict(spec["candidate"])
    if cand.layout is not None:
        raise mt.MXNetError(
            "probe: candidate layout %s needs the parallel layouts of "
            "ROADMAP.md queue A9" % (cand.layout,))
    for knob, val in cand.knobs().items():
        mt.config.set(knob, val)
    # a probe must never recurse into the tuner
    mt.config.set("MXNET_TPU_TUNE", "off")
    tf32 = spec.get("tf32")
    if tf32 is not None:
        torch.backends.cuda.matmul.allow_tf32 = bool(tf32["matmul"])
        torch.backends.cudnn.allow_tf32 = bool(tf32["cudnn"])
    if spec.get("amp"):
        mt.amp.init(spec["amp"])
    ctx = mt.cpu() if spec.get("device") == "cpu" else mt.gpu(0)

    sym = mt.sym.load_json(spec["symbol"])
    data_shapes = [(n, tuple(s)) for n, s in spec["data_shapes"]]
    label_shapes = [(n, tuple(s)) for n, s in spec["label_shapes"]]
    steps = max(1, int(spec["steps"]))
    nbatch = steps + WARMUP_STEPS

    with mt.device_scope("cpu"):
        data = _synth_arrays(data_shapes, spec.get("data_dtypes") or {},
                             nbatch)
        label = _synth_arrays(label_shapes,
                              spec.get("label_dtypes") or {}, nbatch) \
            or None
        label_names = [n for n, _ in label_shapes]
        it = mt.io.NDArrayIter(
            data, label, batch_size=int(data_shapes[0][1][0]),
            label_name=label_names[0] if label_names
            else "softmax_label")

    mt.random.seed(int(spec.get("seed", 0)))
    mod = mt.mod.Module(sym, data_names=[n for n, _ in data_shapes],
                        label_names=label_names, context=ctx)
    t0 = time.perf_counter()
    # Loss is shape-agnostic (sequence outputs) and sums on the device;
    # the weights' values do not move a rate, so they are drawn there
    mod.fit(it, num_epoch=1, optimizer=spec["optimizer"],
            eval_metric=mt.metric.Loss(),
            initializer=device_uniform(seed=int(spec.get("seed", 0))),
            optimizer_params=dict(spec.get("optimizer_params") or {}),
            grad_accum=cand.grad_accum if cand.grad_accum > 1 else None)
    wall = time.perf_counter() - t0
    score = mt.obs.probe_score()
    score["wall_s"] = round(wall, 3)
    score["steps"] = steps
    score["device"] = str(mod._device)
    from ..ops.flash_attention import launch_counts
    score["kernel_launches"] = launch_counts()
    # loop_recompile counts the compiled step's builds and the compiled
    # update's after their first: a candidate that recompiles is refused
    score["ok"] = bool(score.get("steps_per_sec")) \
        and int(score.get("loop_recompile") or 0) == 0
    if not score["ok"] and not score.get("steps_per_sec"):
        score["why"] = "no rate measured (probe too short?)"
    elif not score["ok"]:
        score["why"] = "loop_recompile=%d" % score["loop_recompile"]
    return score


def run_probe(spec: Dict[str, Any],
              deadline_s: float) -> Dict[str, Any]:
    """Launch one probe subprocess and score it. Never raises: a
    timeout, crash or unparseable child yields ``{"ok": False, "why":
    ...}`` and the search moves on (partial results kept)."""
    _profiler.incr_counter("tune_probe")
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env = dict(os.environ)
    # runtime config.set overrides of the store reach the child, which
    # must not inherit an armed tuner
    from .. import config as _config
    val = _config.get("MXNET_TPU_TUNE_STORE")
    if val:
        env["MXNET_TPU_TUNE_STORE"] = str(val)
    env["MXNET_TPU_TUNE"] = ""
    env["PYTHONPATH"] = root + (
        os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
    fd, path = tempfile.mkstemp(prefix="mt-tune-probe-", suffix=".json")
    try:
        with os.fdopen(fd, "w") as f:
            json.dump(spec, f)
        t0 = time.perf_counter()
        try:
            proc = subprocess.run(
                [sys.executable, "-m", "mxnet_tpu_torch.tune", "--probe",
                 path],
                capture_output=True, text=True, env=env,
                timeout=max(1.0, float(deadline_s)))
        except subprocess.TimeoutExpired:
            _profiler.incr_counter("tune_probe_fail")
            return {"ok": False,
                    "why": "deadline (%.0fs) expired" % deadline_s,
                    "wall_s": round(time.perf_counter() - t0, 3)}
        wall = round(time.perf_counter() - t0, 3)
        # the score line first: a failed probe exits nonzero but still
        # reports its structured "why" on the last stdout line
        for line in reversed(proc.stdout.splitlines()):
            if line.startswith("{"):
                try:
                    score = json.loads(line)
                except ValueError:
                    break
                if not score.get("ok"):
                    _profiler.incr_counter("tune_probe_fail")
                score["wall_s"] = wall
                return score
        _profiler.incr_counter("tune_probe_fail")
        return {"ok": False, "wall_s": wall,
                "why": "probe exited %d with no score line: %s"
                       % (proc.returncode,
                          (proc.stderr or "").strip()[-500:])}
    finally:
        try:
            os.unlink(path)
        except OSError:
            pass


def probe_many(specs: List[Dict[str, Any]], deadline_s: float,
               total_deadline_s: Optional[float] = None,
               log=None) -> List[Optional[Dict[str, Any]]]:
    """Run probes one after another (each owns the card for an honest
    rate) under per-probe AND total deadlines; entries past an expired
    total budget are ``None`` (never probed, vs failed)."""
    out: List[Optional[Dict[str, Any]]] = []
    t0 = time.perf_counter()
    for spec in specs:
        if total_deadline_s is not None \
                and time.perf_counter() - t0 > total_deadline_s:
            out.append(None)
            continue
        score = run_probe(spec, deadline_s)
        if log is not None:
            log(spec, score)
        out.append(score)
    return out
