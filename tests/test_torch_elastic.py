"""The port's single-host supervisor (``mxnet_tpu_torch.elastic``), held
against the JAX package's, and the phase-22 rehearsal of
``chip_smoke.py``.

* **supervisor**: the same child scripts (they import neither package)
  under both packages' ``Supervisor`` give the same return codes,
  restart counts and per-attempt ``MXNET_TPU_ELASTIC_*`` environments;
  a SIGTERM during the backoff, between attempts and while a child runs
  stops the restarts (exit 143); the CLI, its exit record and its
  refusal of the pod runtime's options (ROADMAP A9); the supervisor
  never creates a CUDA context.
* **resume_dir** / **probe_world** / ``backoff_delay``.
* **phase 22** of ``chip_smoke.py`` on the CPU at 2 layers of width 32.
"""
import json
import os
import signal
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

import chip_smoke
import mxnet_tpu_torch as mt
from mxnet_tpu import elastic as jelastic
from mxnet_tpu_torch import elastic
from mxnet_tpu_torch.checkpoint import write_checkpoint

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

@pytest.fixture(autouse=True)
def _small_children(monkeypatch):
    """Child processes keep torch's intra-op pool small too (C20)."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")


# a child that fails with ``rc`` until its ``succeed_on``-th run and
# records each attempt's supervisor environment
_OK_AFTER = r"""
import json, os, sys
log = %(log)r
n = 0
if os.path.exists(log):
    n = len(open(log).read().splitlines())
with open(log, "a") as f:
    f.write(json.dumps({
        "attempt": os.environ.get("MXNET_TPU_ELASTIC_ATTEMPT"),
        "resumed": os.environ.get("MXNET_TPU_ELASTIC_RESUMED")}) + "\n")
sys.exit(0 if n + 1 >= %(succeed_on)d else %(rc)d)
"""


def _script(path: Path, body: str) -> str:
    path.write_text(body)
    return str(path)


def _attempts(log):
    with open(log) as f:
        return [json.loads(ln) for ln in f]


@pytest.fixture
def no_probe(monkeypatch):
    """Both supervisors' device probe (a throwaway process each attempt)
    answers 1 without starting one."""
    monkeypatch.setattr(elastic, "probe_world", lambda env=None: 1)
    monkeypatch.setattr(jelastic, "probe_world", lambda env=None: 1)


def _both(tmp_path, body_args, **kw):
    out = {}
    for name, mod in (("port", elastic), ("ref", jelastic)):
        d = tmp_path / name
        d.mkdir()
        log = str(d / "attempts.jsonl")
        child = _script(d / "child.py", _OK_AFTER % dict(body_args, log=log))
        sup = mod.Supervisor([child], backoff=0.01, backoff_max=0.02,
                             jitter_seed=0, **kw)
        rc = sup.run()
        out[name] = (rc, sup.restarts, _attempts(log))
    return out


@pytest.mark.parametrize("succeed_on,rc,max_restarts", [
    (3, 143, 5),          # preempted twice, then done
    (2, 17, 3),           # a crash also restarts
    (1, 9, 3),            # a clean child never restarts
    (99, 9, 2),           # the budget runs out: the child's status
    (99, 143, 0),         # no restarts allowed
])
def test_supervisors_agree(tmp_path, no_probe, succeed_on, rc,
                           max_restarts):
    got = _both(tmp_path, {"succeed_on": succeed_on, "rc": rc},
                max_restarts=max_restarts)
    assert got["port"] == got["ref"]
    want_runs = min(succeed_on, max_restarts + 1)
    rc_, restarts, attempts = got["port"]
    assert restarts == want_runs - 1
    assert rc_ == (0 if succeed_on <= max_restarts + 1 else rc)
    assert attempts == [{"attempt": str(i),
                         "resumed": "1" if i else None}
                        for i in range(want_runs)]


def test_supervisor_env_and_on_attempt(tmp_path, no_probe):
    seen = []
    log = str(tmp_path / "a.jsonl")
    child = _script(tmp_path / "c.py",
                    _OK_AFTER % {"log": log, "succeed_on": 2, "rc": 143})
    sup = elastic.Supervisor(
        [child], backoff=0.01, env={"PATH": os.environ.get("PATH", ""),
                                    "MY_KEY": "x"},
        on_attempt=lambda i, env: seen.append((i, env["MY_KEY"],
                                               env.get(
                                                   "MXNET_TPU_ELASTIC_RESUMED"))))
    assert sup.run() == 0
    assert seen == [(0, "x", None), (1, "x", "1")]


def test_backoff_sleep_is_cut_by_termination(tmp_path):
    child = _script(tmp_path / "c.py", "import sys; sys.exit(0)\n")
    for mod in (elastic, jelastic):
        sup = mod.Supervisor([child], backoff=0.01)
        threading.Timer(0.1, lambda: setattr(sup, "_terminated",
                                             True)).start()
        t0 = time.monotonic()
        sup._backoff_sleep(30.0)
        assert time.monotonic() - t0 < 5.0


def test_sigterm_between_attempts_spawns_nothing(tmp_path, no_probe):
    marker = tmp_path / "ran"
    child = _script(tmp_path / "c.py",
                    "import pathlib, sys\npathlib.Path(%r).touch()\n"
                    "sys.exit(0)\n" % str(marker))
    for mod in (elastic, jelastic):
        sup = mod.Supervisor([child], max_restarts=3, backoff=0.01)
        sup._terminated = True
        assert sup.run() == 143
        assert not marker.exists()


_SLEEPER = r"""
import os, signal, sys, time
marker = %(marker)r
attempt = os.environ["MXNET_TPU_ELASTIC_ATTEMPT"]
def on_term(*_):
    open(marker, "a").write("sigterm@%%s\n" %% attempt)
    sys.exit(143)
signal.signal(signal.SIGTERM, on_term)
open(marker, "a").write("start@%%s\n" %% attempt)
if %(die_first)r and attempt == "0":
    sys.exit(143)
time.sleep(60)
"""


def _wait_for(path, text, timeout=60):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if os.path.exists(path) and text in open(path).read():
            return True
        time.sleep(0.05)
    return False


@pytest.mark.parametrize("pkg", ["mxnet_tpu_torch", "mxnet_tpu"])
def test_cli_forwards_sigterm_to_the_child(tmp_path, pkg):
    """A SIGTERM to the supervisor reaches the running child, which
    exits 143; the supervisor does not restart it and exits 143."""
    marker = str(tmp_path / "marker")
    child = _script(tmp_path / "c.py", _SLEEPER % {"marker": marker,
                                                   "die_first": False})
    proc = subprocess.Popen(
        [sys.executable, "-m", pkg + ".elastic", "--max-restarts", "3",
         "--backoff", "0.01", "--", child], cwd=REPO,
        env={**os.environ, "PYTHONPATH": REPO, "JAX_PLATFORMS": "cpu"},
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        assert _wait_for(marker, "start@0")
        proc.send_signal(signal.SIGTERM)
        out, err = proc.communicate(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
    assert proc.returncode == 143, out + err
    assert open(marker).read().splitlines() == ["start@0", "sigterm@0"]


def test_cli_sigterm_during_backoff_stops_the_restarts(tmp_path):
    marker = str(tmp_path / "marker")
    child = _script(tmp_path / "c.py", _SLEEPER % {"marker": marker,
                                                   "die_first": True})
    proc = subprocess.Popen(
        [sys.executable, "-m", "mxnet_tpu_torch.elastic", "--max-restarts",
         "3", "--backoff", "30", "--backoff-max", "30", "--", child],
        cwd=REPO, env={**os.environ, "PYTHONPATH": REPO},
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        assert _wait_for(marker, "start@0")
        time.sleep(3.0)         # attempt 0 has exited; the backoff sleeps
        t0 = time.monotonic()
        proc.send_signal(signal.SIGTERM)
        out, err = proc.communicate(timeout=30)
    finally:
        if proc.poll() is None:
            proc.kill()
    assert time.monotonic() - t0 < 10
    assert proc.returncode == 143, out + err
    assert open(marker).read().splitlines() == ["start@0"]
    assert "ELASTIC-SUPERVISOR-EXIT rc=143 restarts=1 " \
           "cuda_initialized=False" in out


def test_cli_restarts_and_never_initializes_cuda(tmp_path):
    """The CLI under a torch whose CUDA initialization raises, with no
    visible device: the supervisor and one restart run, and its exit
    record says it never created a CUDA context."""
    log = str(tmp_path / "a.jsonl")
    child = _script(tmp_path / "c.py",
                    _OK_AFTER % {"log": log, "succeed_on": 2, "rc": 143})
    boot = ("import runpy, sys, torch, torch.cuda\n"
            "def _no_cuda(*a, **k):\n"
            "    raise SystemExit('the supervisor initialized CUDA')\n"
            "torch.cuda._lazy_init = _no_cuda\n"
            "sys.argv = ['elastic', '--max-restarts', '2', '--backoff',\n"
            "            '0.01', '--', %r]\n"
            "runpy.run_module('mxnet_tpu_torch.elastic',\n"
            "                 run_name='__main__')\n" % child)
    proc = subprocess.run(
        [sys.executable, "-c", boot], capture_output=True, text=True,
        timeout=120, cwd=REPO,
        env={**os.environ, "PYTHONPATH": REPO, "CUDA_VISIBLE_DEVICES": ""})
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.splitlines()[-1] == \
        "ELASTIC-SUPERVISOR-EXIT rc=0 restarts=1 cuda_initialized=False"
    assert [a["attempt"] for a in _attempts(log)] == ["0", "1"]


@pytest.mark.parametrize("flag", [["--world-schedule", "8,4"],
                                  ["--coordinated"]])
def test_cli_refuses_the_pod_options_naming_a9(tmp_path, flag):
    child = _script(tmp_path / "c.py", "import sys; sys.exit(0)\n")
    assert elastic.main(flag + ["--", child]) == 2


def test_importing_the_supervisor_leaves_cuda_alone():
    code = ("import torch, mxnet_tpu_torch.elastic as e\n"
            "import mxnet_tpu_torch\n"
            "s = e.Supervisor(['true'])\n"
            "print(torch.cuda.is_initialized())\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=REPO,
                         env={**os.environ, "PYTHONPATH": REPO})
    assert out.stdout.strip() == "False", out.stderr


def test_resume_dir_requires_a_valid_checkpoint(tmp_path):
    assert elastic.resume_dir(str(tmp_path)) is None
    write_checkpoint(str(tmp_path), 1, {"w": np.ones(4, np.float32)})
    assert elastic.resume_dir(str(tmp_path)) == str(tmp_path)
    arrays = os.path.join(str(tmp_path), "ckpt-0000000001", "arrays.npz")
    with open(arrays, "ab") as f:
        f.write(b"x")                  # size mismatch fails probe_valid
    assert elastic.resume_dir(str(tmp_path)) is None
    # and the reference reads the port's checkpoints the same way
    assert jelastic.resume_dir(str(tmp_path)) is None


def test_probe_world_counts_cuda_devices_in_a_subprocess(tmp_path):
    assert elastic.probe_world() == torch.cuda.device_count()
    # a probe that fails answers None
    (tmp_path / "torch.py").write_text("raise ImportError('no torch')\n")
    assert elastic.probe_world(
        env={**os.environ, "PYTHONPATH": str(tmp_path)}) is None


@pytest.mark.parametrize("restarts,backoff,cap", [(1, 1.0, 60.0),
                                                  (4, 0.5, 60.0),
                                                  (9, 1.0, 20.0)])
def test_backoff_delay_is_the_references(restarts, backoff, cap):
    import inspect
    import random
    from mxnet_tpu_torch.fleet import gateway
    assert elastic.backoff_delay(restarts, backoff, cap) == \
        jelastic.backoff_delay(restarts, backoff, cap)
    assert elastic.backoff_delay(restarts, backoff, cap,
                                 rng=random.Random(3)) == \
        jelastic.backoff_delay(restarts, backoff, cap, rng=random.Random(3))
    # the fleet's per-replica supervisors respawn on this formula
    assert "_elastic.backoff_delay(" in inspect.getsource(gateway)


# ------------------------------------------------------------ phase 22

@pytest.fixture
def small_phase22(monkeypatch, tmp_path):
    """Phase 22 on the CPU at 2 layers of width 32; returns the logged
    lines. The drills' child processes run the real wrappers, which
    launch nothing on the host, so their launch checks and the stream
    query stand aside; a peak FLOP/s gives the host probes an MFU."""
    for name, value in (("DEVICE", "cpu"), ("VOCAB", 64), ("D_MODEL", 32),
                        ("HEADS", 2), ("D_FF", 64), ("MAX_SEQ", 16),
                        ("TRAIN_BATCH", 4), ("NAIVE_SHAPE", (64, 64)),
                        ("ROOT", tmp_path)):
        monkeypatch.setattr(chip_smoke, name, value)
    monkeypatch.setattr(mt, "gpu", lambda i=0: mt.cpu())
    monkeypatch.setattr(chip_smoke, "check_attempt_launches",
                        lambda *a: None)
    monkeypatch.setattr(chip_smoke, "check_probe_launches", lambda *a: None)
    monkeypatch.setattr(chip_smoke, "stream_idle", lambda torch: True)
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    monkeypatch.setenv("MXNET_TPU_OBS_PEAK_FLOPS", "1e12")
    for k in ("MXNET_TPU_FAULTS", "MXNET_TPU_TUNE", "MXNET_TPU_TUNE_STORE"):
        monkeypatch.delenv(k, raising=False)
    lines = []
    monkeypatch.setattr(chip_smoke, "log", lambda *a: lines.append(a[0]))
    yield lines


def test_phase22_rehearsal_on_cpu(small_phase22):
    """The whole of phase 22 at a small width: every check passes and
    each part logs its readings."""
    r = chip_smoke.elastic_tune_phase(torch, np)
    a = r["22a"]
    assert a["supervisors"] == {
        "baseline": {"rc": 0, "restarts": 0, "cuda_initialized": False},
        "drill": {"rc": 0, "restarts": 1, "cuda_initialized": False}}
    assert a["marker"] == ["fit.batch@%d:sigterm"
                           % chip_smoke.ELASTIC_FAULT_AT]
    b = r["22b"]
    assert len(b["probes"]) == 1 + chip_smoke.TUNE_MAX_PROBES
    assert all(p["obs_mfu"] > 0 for p in b["probes"])
    assert b["losses"][-1] < b["losses"][0]
    c = r["22c"]
    assert c["two_pass_err"] < c["one_pass_err"]
    for prefix in ("22a supervised preemption", "22b fit(tune=",
                   "22c LayerNorm", "22 supervisor, faults and tuner"):
        assert any(ln.startswith(prefix) for ln in small_phase22), prefix
    assert not list((chip_smoke.ROOT / "build").iterdir())


def test_phase22_catches_parted_digests(monkeypatch):
    """22a's check fails when the resumed run's parameters part from
    the baseline's, or the marker holds another fire."""
    from mxnet_tpu_torch.tools import elastic_smoke
    opts = chip_smoke.phase22_opts(chip_smoke.ELASTIC_STEPS)
    sup = {"rc": 0, "restarts": 0, "cuda_initialized": False}
    rec = {"steps": opts.steps, "digests": {"w": "a", "b": "c"},
           "rc": 0, "resumed": False, "env_resumed": None}
    res = {"baseline": {"rc": 0, "supervisor": sup, "attempts": [rec]},
           "drill": {"rc": 0, "supervisor": dict(sup, restarts=1),
                     "attempts": [dict(rec, rc=143, steps=opts.fault_at),
                                  dict(rec, resumed=True, env_resumed="1",
                                       steps=opts.steps - opts.fault_at,
                                       digests={"w": "a", "b": "x"})]},
           "marker": ["fit.batch@%d:sigterm" % opts.fault_at]}
    bad = elastic_smoke.check(res, opts)
    assert len(bad) == 1 and "1 of 2 parameters" in bad[0]
    res["drill"]["attempts"][1]["digests"] = {"w": "a", "b": "c"}
    assert elastic_smoke.check(res, opts) == []
    res["marker"] = res["marker"] * 2
    assert "fault marker" in elastic_smoke.check(res, opts)[0]
