"""The supervised preemption drill: a fit SIGTERMed mid-epoch under
``python -m mxnet_tpu_torch.elastic`` resumes to the uninterrupted run's
parameters, bit for bit.

The port of the reference's ``tools/elastic_smoke.py``, one host's
part (the reference's drill also shrinks the world 8 -> 4 -> 2 devices
between attempts, which needs the pod runtime of ROADMAP.md queue A9):

1. the baseline: the supervisor CLI runs the training child once, with
   no fault; it ends with 0 restarts;
2. the drill: the same command, with ``fit.batch@K:sigterm`` armed on
   attempt 0 only (:data:`ATTEMPT_FAULTS`): the preemption hook lands a
   final synchronous checkpoint and the child exits 143; the supervisor
   restarts it once with ``MXNET_TPU_ELASTIC_RESUMED=1``; the child
   finds the checkpoint (``elastic.resume_dir``) and resumes;
3. every parameter's sha256 after the drill equals the baseline's; the
   fault marker (``MXNET_TPU_FAULTS_TOUCH``) holds exactly one fire; the
   supervisors never created a CUDA context.

The two supervised runs go side by side. Each child prints, as its last
line, one JSON record: its attempt, the steps it trained, the sha256 of
every parameter and its launches of the flash-attention kernels (and
appends the record to ``--out``).

Usage::

    python -m mxnet_tpu_torch.tools.elastic_smoke [--device cuda|cpu]
        [--net transformer|mlp] [--layers N] [--d-model D] ...

The training runs on the card unless ``--device cpu`` asks for the
host; it never falls back to the host. Exit 0 and ``ELASTIC-DRILL-OK``
on success.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from typing import Any, Dict, List

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
SEED = 5
# the attempts a drill arms its fault on: the preemption lands on the
# first attempt only, so the restarted one runs to completion
ATTEMPT_FAULTS = (0,)
EXIT_PREFIX = "ELASTIC-SUPERVISOR-EXIT"


def add_model_args(p: argparse.ArgumentParser) -> None:
    """The model, geometry and device flags the drills share."""
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    p.add_argument("--net", choices=("transformer", "mlp"),
                   default="transformer")
    p.add_argument("--layers", type=int, default=2)
    p.add_argument("--d-model", type=int, default=2048)
    p.add_argument("--heads", type=int, default=16)
    p.add_argument("--d-ff", type=int, default=8192)
    p.add_argument("--seq", type=int, default=1024)
    p.add_argument("--vocab", type=int, default=32000)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--steps", type=int, default=6,
                   help="batches of the one epoch")
    p.add_argument("--lr", type=float, default=0.01)
    p.add_argument("--amp", choices=("bfloat16", "off"), default="bfloat16")


def model_argv(opts) -> List[str]:
    """``opts`` back as the command-line flags of :func:`add_model_args`."""
    return ["--device", opts.device, "--net", opts.net,
            "--layers", str(opts.layers), "--d-model", str(opts.d_model),
            "--heads", str(opts.heads), "--d-ff", str(opts.d_ff),
            "--seq", str(opts.seq), "--vocab", str(opts.vocab),
            "--batch", str(opts.batch), "--steps", str(opts.steps),
            "--lr", repr(opts.lr), "--amp", opts.amp]


def build_net(mt, opts):
    """``(symbol, data, label)``: the LM (flash attention) over token ids
    drawn from a seed, or a two-layer MLP over uniform features. The
    symbol is named by a fresh ``NameManager``, so its JSON (the tuner's
    store key) is the same in every process, whatever it built before."""
    import numpy as np
    rng = np.random.RandomState(SEED)
    n = opts.batch * opts.steps
    with mt.name.NameManager():
        if opts.net == "transformer":
            from ..models import transformer
            sym = transformer.get_symbol(opts.vocab, opts.layers,
                                         opts.d_model, opts.heads,
                                         opts.d_ff, opts.seq,
                                         attention="flash")
        else:
            d = mt.sym.Variable("data")
            h = mt.sym.FullyConnected(d, num_hidden=opts.d_model,
                                      name="fc1")
            h = mt.sym.Activation(h, act_type="relu")
            h = mt.sym.FullyConnected(h, num_hidden=8, name="fc2")
            sym = mt.sym.SoftmaxOutput(h, name="softmax")
    if opts.net == "transformer":
        x = rng.randint(0, opts.vocab, (n, opts.seq)).astype(np.float32)
        y = rng.randint(0, opts.vocab, (n, opts.seq)).astype(np.float32)
    else:
        x = rng.uniform(-1, 1, (n, 16)).astype(np.float32)
        y = rng.randint(0, 8, (n,)).astype(np.float32)
    return sym, x, y


def set_precision(torch, mt, opts) -> Dict[str, bool]:
    """The same arithmetic in every process: TF32 off (a fresh process
    has torch's defaults, which leave cuDNN in TF32), cuDNN
    deterministic, and the amp policy of ``--amp``."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    if opts.amp != "off":
        mt.amp.init(opts.amp)
    return {"matmul": False, "cudnn": False}


def param_digests(mod) -> Dict[str, str]:
    """The sha256 of every parameter and aux state's bytes."""
    args, aux = mod.get_params()
    out = {}
    for name, arr in sorted(dict(args, **aux).items()):
        out[name] = hashlib.sha256(
            arr.data.detach().cpu().contiguous().numpy().tobytes()
        ).hexdigest()
    return out


def kernel_launches() -> Dict[str, int]:
    """This process's launches of K1 bf16, K2 and K3 (all dtypes of the
    backward kernels)."""
    from ..ops.flash_attention import launch_counts
    n = launch_counts()
    return {"K1_bf16": n["flash_attention_fwd"]["bf16"],
            "K2": sum(n["flash_attention_bwd_dq"].values()),
            "K3": sum(n["flash_attention_bwd_dkv"].values())}


def device_uniform(seed):
    """The weights drawn on the card from ``seed``
    (:func:`mxnet_tpu_torch.tune.probe.device_uniform`)."""
    from ..tune.probe import device_uniform as _draw
    return _draw(seed=seed)


def _now() -> float:
    """Seconds since the host booted: one clock for every process on the
    host (the records of several processes are compared), the clock of
    :func:`process_start_time`."""
    return time.clock_gettime(time.CLOCK_BOOTTIME)


def process_start_time() -> float:
    """This process's start on :func:`_now`'s clock (Linux's
    ``/proc/self/stat``), or now where that cannot be read."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        return ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return _now()


def child(opts) -> int:
    """One supervised attempt: resume from ``--ckpt`` if it holds a
    valid checkpoint, train to the end of the epoch (or until the armed
    preemption), print and append this attempt's record."""
    t_start = process_start_time()
    import torch
    import mxnet_tpu_torch as mt
    from mxnet_tpu_torch import elastic, faults
    attempt = int(os.environ.get("MXNET_TPU_ELASTIC_ATTEMPT", "0"))
    if opts.fault and attempt in ATTEMPT_FAULTS:
        faults.install(opts.fault)
    tf32 = set_precision(torch, mt, opts)
    mt.random.seed(SEED)
    sym, x, y = build_net(mt, opts)
    with mt.device_scope("cpu"):
        it = mt.io.NDArrayIter(x, y, batch_size=opts.batch,
                               label_name="softmax_label")
    ctx = mt.cpu() if opts.device == "cpu" else mt.gpu(0)
    # preemption saves only: no periodic write of the whole state
    cfg = mt.checkpoint.CheckpointConfig(opts.ckpt, period_epochs=1 << 30)
    resume = elastic.resume_dir(opts.ckpt)
    steps = []

    def _count(_param):
        steps.append(_now())

    mod = mt.mod.Module(sym, context=ctx)
    rc = 0
    t_fit = _now()
    try:
        mod.fit(it, num_epoch=1, optimizer="sgd",
                optimizer_params={"learning_rate": opts.lr,
                                  "momentum": 0.9},
                eval_metric=mt.metric.Loss(), checkpoint=cfg,
                resume_from=resume, batch_end_callback=_count,
                initializer=device_uniform(seed=SEED))
    except SystemExit as exc:
        rc = exc.code if isinstance(exc.code, int) else 1
    if opts.device == "cuda":
        torch.cuda.synchronize()
    rec: Dict[str, Any] = {
        "attempt": attempt,
        "resumed": resume is not None,
        "env_resumed": os.environ.get("MXNET_TPU_ELASTIC_RESUMED"),
        "rc": rc, "steps": len(steps), "device": str(mod._device),
        "tf32": tf32, "launches": kernel_launches(),
        "digests": param_digests(mod),
        "t_start": t_start, "t_fit": t_fit,
        "t_first_step": steps[0] if steps else None, "t_end": _now()}
    line = json.dumps(rec, sort_keys=True)
    with open(opts.out, "a") as f:
        f.write(line + "\n")
    print(line, flush=True)
    return rc


def supervised_command(opts, ckpt: str, out: str, fault: str = "",
                       max_restarts: int = 2) -> List[str]:
    """The CLI command that supervises one training child."""
    cmd = [sys.executable, "-m", "mxnet_tpu_torch.elastic",
           "--max-restarts", str(max_restarts), "--backoff", "0.1",
           "--backoff-max", "0.2", "--",
           sys.executable, "-m", "mxnet_tpu_torch.tools.elastic_smoke",
           "--child", "--ckpt", ckpt, "--out", out] + model_argv(opts)
    if fault:
        cmd += ["--fault", fault]
    return cmd


def _exit_record(stdout: str) -> Dict[str, Any]:
    """The supervisor's ``ELASTIC-SUPERVISOR-EXIT`` line, parsed."""
    for line in reversed(stdout.splitlines()):
        if line.startswith(EXIT_PREFIX):
            fields = dict(kv.split("=", 1) for kv in line.split()[1:])
            return {"rc": int(fields["rc"]),
                    "restarts": int(fields["restarts"]),
                    "cuda_initialized": fields["cuda_initialized"] == "True"}
    return {}


def _records(path: str) -> List[Dict[str, Any]]:
    if not os.path.exists(path):
        return []
    with open(path) as f:
        return [json.loads(ln) for ln in f if ln.strip()]


def drill_env(work: str) -> Dict[str, str]:
    """The supervisors' environment: no fault armed, the checkout on the
    path, one cuBLAS workspace layout in every child."""
    os.makedirs(work, exist_ok=True)
    env = dict(os.environ)
    for k in ("MXNET_TPU_FAULTS", "MXNET_TPU_CKPT_TEST_CRASH",
              "MXNET_TPU_FAULTS_TOUCH", "MXNET_TPU_ELASTIC_ATTEMPT",
              "MXNET_TPU_ELASTIC_RESUMED"):
        env.pop(k, None)
    env["PYTHONPATH"] = ROOT + (os.pathsep + env["PYTHONPATH"]
                                if env.get("PYTHONPATH") else "")
    env["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
    return env


class SupervisedRun(object):
    """One training child under the supervisor CLI, started at
    construction: ``"baseline"`` with no fault, ``"drill"`` with
    ``fit.batch@<fault_at>:sigterm`` armed on attempt 0 and the fault
    marker at ``<work>/drill.touch``."""

    def __init__(self, opts, work: str, name: str):
        env = drill_env(work)
        fault = ""
        self.marker = os.path.join(work, name + ".touch")
        if name == "drill":
            fault = "fit.batch@%d:sigterm" % opts.fault_at
            env["MXNET_TPU_FAULTS_TOUCH"] = self.marker
        self.out = os.path.join(work, name + ".jsonl")
        self.t0 = time.perf_counter()
        self.proc = subprocess.Popen(
            supervised_command(opts, os.path.join(work, "ckpt_" + name),
                               self.out, fault=fault),
            env=env, cwd=ROOT, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True)

    def result(self, timeout: float = 600.0) -> Dict[str, Any]:
        """Wait for the supervisor; what it and each attempt reported,
        the fault marker's lines and the seconds since the start."""
        try:
            stdout, stderr = self.proc.communicate(timeout=timeout)
        finally:
            self.kill()
        marker = []
        if os.path.exists(self.marker):
            with open(self.marker) as f:
                marker = [ln.strip() for ln in f if ln.strip()]
        return {"rc": self.proc.returncode,
                "supervisor": _exit_record(stdout),
                "attempts": _records(self.out), "marker": marker,
                "wall_s": time.perf_counter() - self.t0,
                "stderr_tail": stderr[-3000:]}

    def kill(self, grace: float = 60.0) -> None:
        """Stop the run: SIGTERM, which the supervisor forwards to its
        child (a preemption: the child saves and exits), then SIGKILL
        after ``grace`` seconds."""
        if self.proc.poll() is None:
            self.proc.terminate()
            try:
                self.proc.wait(grace)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                self.proc.wait()


def drill(opts, work: str, timeout: float = 600.0) -> Dict[str, Any]:
    """Run the baseline and the preempted run side by side."""
    t0 = time.perf_counter()
    runs = [SupervisedRun(opts, work, name)
            for name in ("baseline", "drill")]
    try:
        out = {name: r.result(timeout)
               for name, r in zip(("baseline", "drill"), runs)}
    finally:
        for r in runs:
            r.kill()
    out["marker"] = out["drill"]["marker"]
    out["wall_s"] = time.perf_counter() - t0
    return out


def check(res: Dict[str, Any], opts) -> List[str]:
    """The drill's failures (empty when every check holds)."""
    bad = []
    for name, restarts in (("baseline", 0), ("drill", 1)):
        r = res[name]
        sup = r["supervisor"]
        if r["rc"] != 0 or sup.get("rc") != 0:
            bad.append("%s: exit %s, supervisor %s; %s"
                       % (name, r["rc"], sup, r["stderr_tail"]))
            continue
        if sup["restarts"] != restarts:
            bad.append("%s: %d restarts, want %d"
                       % (name, sup["restarts"], restarts))
        if sup["cuda_initialized"]:
            bad.append("%s: the supervisor created a CUDA context" % name)
        if len(r["attempts"]) != restarts + 1:
            bad.append("%s: %d attempt records"
                       % (name, len(r["attempts"])))
    if bad:
        return bad
    base = res["baseline"]["attempts"][-1]
    first, last = res["drill"]["attempts"]
    if base["steps"] != opts.steps:
        bad.append("baseline trained %d steps" % base["steps"])
    if (first["rc"], first["steps"], first["resumed"]) != \
            (143, opts.fault_at, False):
        bad.append("attempt 0: rc %s after %d steps (resumed %s), want "
                   "143 after %d" % (first["rc"], first["steps"],
                                     first["resumed"], opts.fault_at))
    if not last["resumed"] or last["env_resumed"] != "1" or \
            last["steps"] != opts.steps - opts.fault_at:
        bad.append("attempt 1: resumed %s (env %s), %d steps"
                   % (last["resumed"], last["env_resumed"], last["steps"]))
    differ = sorted(k for k in base["digests"]
                    if base["digests"][k] != last["digests"].get(k))
    if differ or set(base["digests"]) != set(last["digests"]):
        bad.append("%d of %d parameters part from the baseline's: %s"
                   % (len(differ), len(base["digests"]), differ[:5]))
    want = ["fit.batch@%d:sigterm" % opts.fault_at]
    if res["marker"] != want:
        bad.append("fault marker %s, want %s" % (res["marker"], want))
    return bad


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m mxnet_tpu_torch.tools.elastic_smoke",
        description="supervised preemption drill: SIGTERM a fit, resume "
                    "it under the supervisor, compare with the "
                    "uninterrupted run bit for bit")
    add_model_args(p)
    p.add_argument("--fault-at", type=int, default=3,
                   help="the batch whose start delivers the SIGTERM")
    p.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    p.add_argument("--ckpt", help=argparse.SUPPRESS)
    p.add_argument("--out", help=argparse.SUPPRESS)
    p.add_argument("--fault", default="", help=argparse.SUPPRESS)
    opts = p.parse_args(argv)
    if opts.child:
        return child(opts)
    work = tempfile.mkdtemp(prefix="elastic_smoke_")
    try:
        res = drill(opts, work)
        bad = check(res, opts)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    for msg in bad:
        print("FAILED: %s" % msg)
    if bad:
        return 1
    print("kill -> resume parity: %d parameters bit for bit after a "
          "SIGTERM at batch %d of %d (%.1f s)"
          % (len(res["baseline"]["attempts"][-1]["digests"]),
             opts.fault_at, opts.steps, res["wall_s"]))
    print("ELASTIC-DRILL-OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
