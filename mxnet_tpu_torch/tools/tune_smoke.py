"""The autotuner's drill: the zero-cost gate, a bounded search and the
warm restart from the store.

The port of the reference's ``tools/tune_smoke.py``. Three checks:

1. **zero-cost gate** — with ``MXNET_TPU_TUNE`` unset, a whole ``fit``
   imports no ``mxnet_tpu_torch.tune`` module and bumps no ``tune*``
   counter (a child process);
2. **bounded search** — ``search()`` with probe subprocesses returns
   inside a wall-clock budget, probes the default, and picks a winner
   whose probe score is >= the default's;
3. **warm restart** — process A runs ``fit(tune="auto")`` with a store
   directory: it searches, stores the winner and trains. Process B
   repeats the same program: it loads the stored config
   (``tune_store_hit`` 1, ``tune_probe`` 0), trains under the same
   knobs (``tune_applied`` 1) and builds no native library. (The
   reference's restart also compiles nothing, from its executable
   cache; the port's is ROADMAP.md queue A4d.)

Each ``fit(tune="auto")`` process prints, as its last line, one JSON
record: the ``tune*`` counters, the stored record (every probe's
score: wall seconds, steps/s, ``obs_mfu``, the flash-attention
launches), the applied candidate, the cross-entropy of every batch,
whether the winner's knobs outlived the ``fit``, and its native builds.

Usage::

    python -m mxnet_tpu_torch.tools.tune_smoke [--device cuda|cpu]
        [--net transformer|mlp] [--layers N] [--d-model D] ...

The probes and the fits run on the card unless ``--device cpu`` asks
for the host; they never fall back to it. Exit 0 and ``TUNE-SMOKE-OK``
on success.
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from typing import Any, Dict, List

from .elastic_smoke import (ROOT, SEED, _now, add_model_args, build_net,
                            device_uniform, model_argv, process_start_time,
                            set_precision)

KNOBS = ("MXNET_TPU_REMAT", "MXNET_TPU_SCAN_LAYERS",
         "MXNET_TPU_GROUP_UPDATE", "MXNET_TPU_ASYNC_WINDOW")


def _env(**extra) -> Dict[str, str]:
    env = dict(os.environ)
    for k in list(env):
        if k.startswith("MXNET_TPU_TUNE"):
            env.pop(k)
    env["PYTHONPATH"] = ROOT + (os.pathsep + env["PYTHONPATH"]
                                if env.get("PYTHONPATH") else "")
    env.update(extra)
    return env


def _records(store: str) -> List[str]:
    """The tuned records in ``store`` (not an atomic write's temp)."""
    if not store or not os.path.isdir(store):
        return []
    return sorted(n for n in os.listdir(store)
                  if n.startswith("tune-") and n.endswith(".json"))


def fit_record(opts) -> Dict[str, Any]:
    """One ``fit(tune=opts.tune)`` of the drill's program in this
    process, under this process's tuner knobs; returns its record. It
    sets the drill's arithmetic (``set_precision``: TF32 off, amp)."""
    import numpy as np
    import torch
    import mxnet_tpu_torch as mt
    from mxnet_tpu_torch import config
    from mxnet_tpu_torch.obs import compiles
    from .elastic_smoke import kernel_launches
    set_precision(torch, mt, opts)
    mt.random.seed(SEED)
    sym, x, y = build_net(mt, opts)
    # one batch, repeated: the loss over the epoch must fall
    x = np.concatenate([x[:opts.batch]] * opts.steps)
    y = np.concatenate([y[:opts.batch]] * opts.steps)
    with mt.device_scope("cpu"):
        it = mt.io.NDArrayIter(x, y, batch_size=opts.batch,
                               label_name="softmax_label")
    ctx = mt.cpu() if opts.device == "cpu" else mt.gpu(0)
    mod = mt.mod.Module(sym, context=ctx)
    losses: List[float] = []
    applied: Dict[str, Any] = {}
    label = torch.from_numpy(y[:opts.batch].reshape(-1)).to(
        mod._device, torch.int64)

    def _ce(_param):
        # the knobs the fit trains under (restored when it returns), and
        # the batch's mean cross-entropy from the module's outputs
        if not applied:
            applied.update((k, config.get(k)) for k in KNOBS)
        prob = mod.get_outputs()[0].data
        p = prob.reshape(label.shape[0], -1).gather(1, label[:, None])
        losses.append(float(-torch.log(p.double() + 1e-12).mean()))

    store = config.get("MXNET_TPU_TUNE_STORE")
    t_store = None
    if opts.wait_store:
        # a process restarted while another finishes the search: up,
        # then waiting for the stored record
        deadline = time.monotonic() + opts.wait_store
        while not _records(store):
            if time.monotonic() > deadline:
                raise RuntimeError("no tuned record in %s after %.0f s"
                                   % (store, opts.wait_store))
            time.sleep(0.05)
        t_store = _now()
    before = config.snapshot_overrides(KNOBS)
    builds = compiles.native_builds()
    launches = kernel_launches()
    with mt.profiler.counter_delta() as d:
        t_fit = _now()
        mod.fit(it, num_epoch=1, optimizer="sgd",
                optimizer_params={"learning_rate": opts.lr},
                eval_metric=mt.metric.Loss(), batch_end_callback=_ce,
                initializer=device_uniform(SEED), tune=opts.tune)
        t_end = _now()
    # the record this fit stored or loaded: the store holds this
    # program's only one
    stored = None
    names = _records(store)
    if len(names) == 1:
        with open(os.path.join(store, names[0])) as f:
            stored = json.load(f)
    after = kernel_launches()
    return {
        "counters": {k: v for k, v in d.all().items()
                     if k.startswith("tune")},
        "applied": applied,
        "grad_accum": mod._grad_accum,
        "stored": stored,
        "losses": losses,
        "knobs_restored": config.snapshot_overrides(KNOBS) == before,
        "native_builds": compiles.native_builds() - builds,
        "launches": {k: after[k] - launches[k] for k in after},
        "device": str(mod._device),
        "t_store_seen": t_store, "t_fit": t_fit, "t_end": t_end}


def fit_child(opts) -> int:
    """:func:`fit_record` in a process of its own; prints the record."""
    t_start = process_start_time()
    rec = fit_record(opts)
    rec["t_start"] = t_start
    print(json.dumps(rec, sort_keys=True, default=str), flush=True)
    return 0


_ZERO_CHILD = """
import json, sys
import numpy as np
import mxnet_tpu_torch as mt
net = mt.sym.SoftmaxOutput(mt.sym.FullyConnected(
    mt.sym.Variable("data"), num_hidden=4, name="fc1"), name="softmax")
with mt.device_scope("cpu"):
    it = mt.io.NDArrayIter(np.zeros((16, 8), np.float32),
                           np.zeros((16,), np.float32), batch_size=8)
mod = mt.mod.Module(net, context=mt.cpu() if %(cpu)r else mt.gpu(0))
mod.fit(it, num_epoch=1, optimizer_params={"learning_rate": 0.01})
print(json.dumps({
    "modules": [m for m in sys.modules
                if m.startswith("mxnet_tpu_torch.tune")],
    "counters": {k: v for k, v in mt.profiler.counters().items()
                 if k.startswith("tune") and v}}))
"""


def check_zero_cost(opts) -> List[str]:
    proc = subprocess.run(
        [sys.executable, "-c", _ZERO_CHILD % {"cpu": opts.device == "cpu"}],
        text=True, capture_output=True, env=_env(), cwd=ROOT, timeout=600)
    if proc.returncode != 0:
        return ["zero-cost child failed: %s" % proc.stderr[-2000:]]
    rec = json.loads(proc.stdout.strip().splitlines()[-1])
    bad = []
    if rec["modules"]:
        bad.append("tuner off, yet imported %s" % rec["modules"])
    if rec["counters"]:
        bad.append("tuner off, yet counted %s" % rec["counters"])
    return bad


def check_bounded_search(opts, budget_s: float) -> List[str]:
    import mxnet_tpu_torch as mt
    from mxnet_tpu_torch.tune import search
    sym, x, y = build_net(mt, opts)
    t0 = time.perf_counter()
    cfg = search(sym, [("data", (opts.batch,) + x.shape[1:])],
                 [("softmax_label", (opts.batch,) + y.shape[1:])],
                 optimizer="sgd", mode="auto",
                 probe_steps=opts.probe_steps, max_probes=opts.max_probes,
                 probe_deadline_s=opts.probe_secs, use_store=False,
                 device=opts.device)
    wall = time.perf_counter() - t0
    bad = []
    if wall > budget_s:
        bad.append("search took %.0f s > %.0f s" % (wall, budget_s))
    if cfg.source != "probe" or cfg.baseline is None:
        bad.append("search did not probe the default: source %s"
                   % cfg.source)
    elif (cfg.score.get("steps_per_sec") or 0) < \
            (cfg.baseline.get("steps_per_sec") or 0):
        bad.append("winner %s steps/s < default %s"
                   % (cfg.score.get("steps_per_sec"),
                      cfg.baseline.get("steps_per_sec")))
    print("bounded search: %.1f s, %d probed, winner %s"
          % (wall, cfg.n_probed, cfg.candidate.to_dict()))
    return bad


class FitProcess(object):
    """``fit(tune="auto")`` of the drill's program in a process of its
    own, started at construction, with ``store`` as its store and the
    drill's probe knobs. With ``wait_store`` (seconds) the child comes
    up and then waits for a record in the store before its ``fit``."""

    def __init__(self, opts, store: str, wait_store: float = 0.0):
        env = _env(MXNET_TPU_TUNE_STORE=store,
                   MXNET_TPU_TUNE_MAX_PROBES=str(opts.max_probes),
                   MXNET_TPU_TUNE_PROBE_STEPS=str(opts.probe_steps),
                   MXNET_TPU_TUNE_PROBE_SECS=str(opts.probe_secs))
        self.t0 = time.perf_counter()
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "mxnet_tpu_torch.tools.tune_smoke",
             "--fit-child", "--tune", "auto", "--wait-store",
             repr(float(wait_store))] + model_argv(opts),
            text=True, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            env=env, cwd=ROOT)

    def result(self, timeout: float = 900.0) -> Dict[str, Any]:
        """The child's record (and its ``process_wall_s``)."""
        try:
            stdout, stderr = self.proc.communicate(timeout=timeout)
        finally:
            self.kill()
        if self.proc.returncode != 0:
            raise RuntimeError("tune_smoke child failed (rc %d):\n%s\n%s"
                               % (self.proc.returncode, stdout[-2000:],
                                  stderr[-4000:]))
        for line in reversed(stdout.splitlines()):
            if line.startswith("{"):
                rec = json.loads(line)
                rec["process_wall_s"] = time.perf_counter() - self.t0
                return rec
        raise RuntimeError("tune_smoke child printed no JSON:\n%s"
                           % stdout[-2000:])

    def kill(self) -> None:
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()


def fit_process(opts, store: str, timeout: float = 900.0
                ) -> Dict[str, Any]:
    """:class:`FitProcess` run to its end."""
    return FitProcess(opts, store).result(timeout)


def warm_restart(opts, store: str, timeout: float = 900.0
                 ) -> Dict[str, Any]:
    """Process A (search, store, train) then process B (the same
    program: a store hit). Returns both records."""
    cold = fit_process(opts, store, timeout)
    return {"cold": cold, "warm": fit_process(opts, store, timeout)}


def check_warm_restart(res: Dict[str, Any]) -> List[str]:
    cold, warm = res["cold"], res["warm"]
    c, w = cold["counters"], warm["counters"]
    bad = []
    if c.get("tune_applied") != 1 or c.get("tune_store_write") != 1 \
            or not c.get("tune_probe"):
        bad.append("cold fit counters %s" % c)
    if w.get("tune_store_hit") != 1 or w.get("tune_probe", 0) != 0 \
            or w.get("tune_applied") != 1:
        bad.append("warm fit counters %s" % w)
    if warm["applied"] != cold["applied"] or \
            warm["grad_accum"] != cold["grad_accum"]:
        bad.append("warm fit trained under %s / accum %d, cold under %s / "
                   "%d" % (warm["applied"], warm["grad_accum"],
                           cold["applied"], cold["grad_accum"]))
    if warm["native_builds"]:
        bad.append("warm fit built %d native libraries"
                   % warm["native_builds"])
    for name, rec in (("cold", cold), ("warm", warm)):
        if not rec["knobs_restored"]:
            bad.append("%s fit: the tuned knobs outlived fit" % name)
    return bad


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m mxnet_tpu_torch.tools.tune_smoke",
        description="the autotuner's gates: zero cost when off, a "
                    "bounded search, the warm restart from the store")
    add_model_args(p)
    p.add_argument("--probe-steps", type=int, default=4)
    p.add_argument("--max-probes", type=int, default=1)
    p.add_argument("--probe-secs", type=float, default=120.0)
    p.add_argument("--search-budget", type=float, default=300.0)
    p.add_argument("--fit-child", action="store_true",
                   help=argparse.SUPPRESS)
    p.add_argument("--tune", default="auto", help=argparse.SUPPRESS)
    p.add_argument("--wait-store", type=float, default=0.0,
                   help=argparse.SUPPRESS)
    opts = p.parse_args(argv)
    if opts.fit_child:
        return fit_child(opts)
    import mxnet_tpu_torch as mt
    bad = check_zero_cost(opts)
    with mt.device_scope(opts.device if opts.device == "cpu" else "cuda"):
        bad += check_bounded_search(opts, opts.search_budget)
    store = tempfile.mkdtemp(prefix="tune_smoke_")
    try:
        res = warm_restart(opts, store)
        bad += check_warm_restart(res)
    finally:
        shutil.rmtree(store, ignore_errors=True)
    for msg in bad:
        print("FAILED: %s" % msg)
    if bad:
        return 1
    print("warm restart: cold %.1f s (%d probes, stored) -> warm %.1f s "
          "(store hit)" % (res["cold"]["process_wall_s"],
                           res["cold"]["counters"]["tune_probe"],
                           res["warm"]["process_wall_s"]))
    print("TUNE-SMOKE-OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
