"""The port's flight recorder (``mxnet_tpu_torch.obs.blackbox``) and its
post-mortem CLI against the reference's ``tests/test_blackbox.py``.

The recorder's contract is that the telemetry survives the process, so
most cases are subprocess drills — a SIGTERM preemption, an uncaught
crash, a SIGKILL with only the periodic heartbeat to save the window,
and the zero-import gate of a plain fit — each under its own timeout.
The file format is the reference's: a recorder directory written by
either package gets the same verdict and merged timeline from both
packages' CLIs.
"""
import ast
import io
import json
import os
import signal
import subprocess
import sys
import time
from contextlib import redirect_stdout
from pathlib import Path

import numpy as np
import pytest
import torch

import mxnet_tpu_torch as mt
from mxnet_tpu_torch import config as cfg
from mxnet_tpu_torch import faults
from mxnet_tpu_torch import profiler as _profiler

# test files run side by side in parallel workers: each keeps torch's
# intra-op pool small
torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def recorder(tmp_path):
    """Arm the recorder at tmp_path (no periodic thread); tear it down
    fully so the span listener never leaks into other tests."""
    from mxnet_tpu_torch.obs import blackbox
    snap = cfg.snapshot_overrides(["MXNET_TPU_OBS_BLACKBOX",
                                   "MXNET_TPU_OBS_BLACKBOX_FLUSH_SECS",
                                   "MXNET_TPU_OBS_BLACKBOX_RING"])
    cfg.set("MXNET_TPU_OBS_BLACKBOX", str(tmp_path))
    cfg.set("MXNET_TPU_OBS_BLACKBOX_FLUSH_SECS", "0")
    try:
        yield blackbox
    finally:
        blackbox.reset()
        cfg.restore_overrides(snap)
        faults.clear()


def _read(path):
    lines = [ln for ln in open(path).read().splitlines() if ln.strip()]
    header = json.loads(lines[0])
    events = [json.loads(ln) for ln in lines[1:]]
    return header, events


def _env(**extra):
    env = {**os.environ, "PYTHONPATH": REPO, **extra}
    for k in ("MXNET_TPU_FAULTS", "MXNET_TPU_OBS"):
        if k not in extra:
            env.pop(k, None)
    return env


def test_ring_is_bounded_and_flush_is_complete(recorder, tmp_path):
    cfg.set("MXNET_TPU_OBS_BLACKBOX_RING", 64)
    for i in range(200):
        recorder.record("test", "ev%d" % i, i=i)
    with _profiler.span("bb_span", "test"):
        pass
    _profiler.incr_counter("bb_unit_counter", 3)
    path = recorder.flush("unit")
    header, events = _read(path)
    assert header["blackbox"] == 1
    assert header["flush_reason"] == "unit"
    assert header["rank"] == 0 and header["role"] == "proc"
    assert "wall_base" in header and "clock_offset_s" in header
    assert header["fingerprint"]["torch"] == torch.__version__
    assert len(events) <= 64
    names = [e["name"] for e in events if e["kind"] == "test"]
    assert "ev199" in names and "ev0" not in names
    assert any(e["kind"] == "span" and e["name"] == "bb_span"
               for e in events)
    delta = [e for e in events if e["kind"] == "counters"][-1]
    assert delta["data"].get("bb_unit_counter") == 3
    ts = [e["t"] for e in events]
    assert ts == sorted(ts)


def test_fault_fire_records_and_flushes(recorder, tmp_path):
    faults.install("bb.site@1:raise")
    with pytest.raises(faults.FaultInjected):
        faults.fire("bb.site")
    path = recorder.path()
    assert path is not None and os.path.exists(path)
    header, events = _read(path)
    assert header["flush_reason"] == "fault:bb.site@1:raise"
    fault_evs = [e for e in events if e["kind"] == "fault"]
    assert fault_evs and fault_evs[-1]["name"] == "bb.site"
    assert fault_evs[-1]["data"] == {"arrival": 1, "kind": "raise"}
    assert "bb.site@1:raise" in header["faults_armed"]


def test_slow_fault_records_without_flushing(recorder, tmp_path,
                                             monkeypatch):
    monkeypatch.setenv("MXNET_TPU_FAULTS_SLOW_SECS", "0.01")
    faults.install("bb.site:slow")
    t0 = time.perf_counter()
    faults.fire("bb.site")
    assert time.perf_counter() - t0 >= 0.01
    assert not os.path.exists(recorder.path())
    path = recorder.flush("check")
    _h, events = _read(path)
    assert any(e["kind"] == "fault" and e["data"]["kind"] == "slow"
               for e in events)


def test_fit_notes_epochs_and_checkpoint_phases(recorder, tmp_path):
    """In-process: an armed fit notes each epoch end with its metrics
    and every checkpoint save and commit, and span closes reach the
    ring with obs off."""
    x = np.random.RandomState(0).uniform(-1, 1, (32, 8)).astype("float32")
    y = np.zeros((32, 1), "float32")
    net = mt.sym.LinearRegressionOutput(
        mt.sym.FullyConnected(mt.sym.Variable("data"), num_hidden=1),
        mt.sym.Variable("label"))
    mod = mt.mod.Module(net, context=mt.cpu(), data_names=("data",),
                        label_names=("label",))
    with mt.cpu():
        it = mt.io.NDArrayIter({"data": x}, {"label": y}, batch_size=8)
    mod.fit(it, num_epoch=2, eval_metric="mse", optimizer="sgd",
            checkpoint=mt.checkpoint.CheckpointConfig(
                str(tmp_path / "ck"), every_n_batches=2))
    _h, events = _read(recorder.flush("unit"))
    kinds = [(e["kind"], e["name"]) for e in events]
    assert kinds.count(("epoch", "end")) == 2
    assert ("ckpt", "save") in kinds and ("ckpt", "committed") in kinds
    ends = [e for e in events if e["kind"] == "epoch"]
    assert set(ends[-1]["data"]["metrics"]) == {"mse"}
    spans = {e["name"] for e in events if e["kind"] == "span"}
    assert {"fused_step_dispatch", "metric_update", "metric_sync",
            "ckpt_snapshot", "ckpt_write"} <= spans


def test_knob_off_is_zero_import_and_zero_cost():
    """A plain fit never imports the recorder, and the flush counter
    stays 0 (a fresh interpreter, immune to other tests' imports)."""
    code = """
import sys
import numpy as np
import mxnet_tpu_torch as mt
X = np.random.RandomState(0).uniform(-1, 1, (32, 8)).astype("float32")
Y = np.zeros((32, 1), "float32")
with mt.cpu():
    it = mt.io.NDArrayIter({"data": X}, {"label": Y}, batch_size=8)
net = mt.sym.LinearRegressionOutput(
    mt.sym.FullyConnected(mt.sym.Variable("data"), num_hidden=1),
    mt.sym.Variable("label"))
mod = mt.mod.Module(net, context=mt.cpu(), data_names=("data",),
                    label_names=("label",))
mod.fit(it, num_epoch=1, eval_metric="mse", optimizer="sgd")
assert "mxnet_tpu_torch.obs.blackbox" not in sys.modules
from mxnet_tpu_torch import profiler
assert profiler.get_counter("obs_blackbox_flush") == 0
assert profiler.get_counter("obs_spans") == 0
print("ZERO-IMPORT-OK")
"""
    env = _env()
    env.pop("MXNET_TPU_OBS_BLACKBOX", None)
    proc = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                          capture_output=True, text=True, timeout=50)
    assert proc.returncode == 0, (proc.stdout[-2000:], proc.stderr[-2000:])
    assert "ZERO-IMPORT-OK" in proc.stdout


def test_sigterm_preemption_leaves_window(tmp_path):
    """The SIGTERM/143 protocol flushes the window from the training
    thread: the file carries the preempt event, the checkpoint's
    preempt-save phase, and the armed fault spec."""
    bbdir = str(tmp_path / "bb")
    code = """
import numpy as np
import mxnet_tpu_torch as mt
X = np.random.RandomState(0).uniform(-1, 1, (64, 8)).astype("float32")
Y = np.zeros((64, 1), "float32")
with mt.cpu():
    it = mt.io.NDArrayIter({"data": X}, {"label": Y}, batch_size=8)
net = mt.sym.LinearRegressionOutput(
    mt.sym.FullyConnected(mt.sym.Variable("data"), num_hidden=1),
    mt.sym.Variable("label"))
mod = mt.mod.Module(net, context=mt.cpu(), data_names=("data",),
                    label_names=("label",))
mod.fit(it, num_epoch=4, eval_metric="mse", optimizer="sgd",
        checkpoint=mt.checkpoint.CheckpointConfig(%r, every_n_batches=2))
"""
    env = _env(MXNET_TPU_OBS_BLACKBOX=bbdir,
               MXNET_TPU_OBS_BLACKBOX_FLUSH_SECS="0",
               MXNET_TPU_FAULTS="fit.batch@5:sigterm")
    proc = subprocess.run(
        [sys.executable, "-c", code % str(tmp_path / "ckpts")],
        env=env, cwd=REPO, capture_output=True, text=True, timeout=50)
    assert proc.returncode == 143, (proc.returncode, proc.stderr[-3000:])
    header, events = _read(os.path.join(bbdir, "blackbox-p0.jsonl"))
    kinds = {(e["kind"], e["name"]) for e in events}
    assert ("preempt", "sigterm") in kinds, sorted(kinds)
    assert ("ckpt", "preempt-save") in kinds, sorted(kinds)
    assert ("ckpt", "save") in kinds
    assert ("fault", "fit.batch") in kinds
    # the sigterm flush, then the interpreter's exit flush over it
    assert header["flush_reason"] == "exit"
    assert "fit.batch@5:sigterm" in header["faults_armed"]


def test_crash_excepthook_flushes(tmp_path):
    bbdir = str(tmp_path)
    code = """
import mxnet_tpu_torch as mt
from mxnet_tpu_torch.obs import blackbox
blackbox.record("unit", "before-crash")
raise RuntimeError("boom for the recorder")
"""
    env = _env(MXNET_TPU_OBS_BLACKBOX=bbdir,
               MXNET_TPU_OBS_BLACKBOX_FLUSH_SECS="0")
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          cwd=REPO, capture_output=True, text=True,
                          timeout=50)
    assert proc.returncode == 1
    assert "boom for the recorder" in proc.stderr   # the hook chains on
    _header, events = _read(os.path.join(bbdir, "blackbox-p0.jsonl"))
    crash = [e for e in events if e["kind"] == "crash"]
    assert crash and "boom for the recorder" in crash[-1]["data"]["message"]
    assert any(e["kind"] == "unit" for e in events)


def test_periodic_heartbeat_survives_sigkill(tmp_path):
    """No flush call ever runs, yet the last periodic window is on
    disk; the port's CLI then names rank 0 dead."""
    bbdir = str(tmp_path)
    code = """
import time
import mxnet_tpu_torch as mt
from mxnet_tpu_torch.obs import blackbox
blackbox.record("unit", "pre-kill", n=1)
print("ARMED", flush=True)
time.sleep(60)
"""
    env = _env(MXNET_TPU_OBS_BLACKBOX=bbdir,
               MXNET_TPU_OBS_BLACKBOX_FLUSH_SECS="0.2")
    proc = subprocess.Popen([sys.executable, "-c", code], env=env,
                            cwd=REPO, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    path = os.path.join(bbdir, "blackbox-p0.jsonl")
    try:
        deadline = time.monotonic() + 40
        while time.monotonic() < deadline and not os.path.exists(path):
            time.sleep(0.1)
        time.sleep(0.5)      # let at least one periodic flush land
        assert os.path.exists(path), proc.communicate(timeout=5)
    finally:
        proc.kill()
        proc.communicate(timeout=10)
    assert proc.returncode == -signal.SIGKILL
    header, events = _read(path)
    assert header["flush_reason"] == "periodic"
    assert any(e["kind"] == "unit" and e["name"] == "pre-kill"
               for e in events)
    verdict = _verdict_of(_port_main, bbdir)[0]
    assert verdict["dead"] == [0] and verdict["first_dead"] == 0


# ----------------------------------------------------- merge CLI


def _write_rank_file(path, rank, role, reason, events, offset=0.0,
                     armed=()):
    header = {"blackbox": 1, "rank": rank, "role": role,
              "flush_reason": reason, "clock_offset_s": offset,
              "faults_armed": list(armed), "gen": 0,
              "wall_base": 100.0, "perf_base": 0.0}
    with open(path, "w") as f:
        f.write(json.dumps(header) + "\n")
        for ev in events:
            f.write(json.dumps(ev) + "\n")


def _synthetic_pod(tmp_path):
    d = str(tmp_path)
    _write_rank_file(
        os.path.join(d, "blackbox-p1.jsonl"), 1, "child",
        "fault:host.die@12:hostkill",
        [{"s": 1, "t": 114.0, "kind": "span", "name": "step",
          "cat": "step", "dur_ms": 4.0},
         {"s": 2, "t": 115.0, "kind": "fault", "name": "host.die",
          "data": {"arrival": 12, "kind": "hostkill"}}],
        offset=5.0, armed=["host.die@12:hostkill"])
    _write_rank_file(
        os.path.join(d, "blackbox-p0.jsonl"), 0, "child", "exit",
        [{"s": 1, "t": 100.0, "kind": "epoch", "name": "end"}])
    _write_rank_file(
        os.path.join(d, "blackbox-p0-coord.jsonl"), 0, "coord", "exit",
        [{"s": 1, "t": 120.0, "kind": "pod", "name": "dead-hosts",
          "data": {"ranks": [1]}},
         {"s": 2, "t": 125.0, "kind": "pod", "name": "failover",
          "data": {"leader": 0, "addr": "127.0.0.1:1"}}])
    return d


def _port_main(argv):
    from mxnet_tpu_torch.obs.__main__ import main
    return main(argv)


def _ref_main(argv):
    from mxnet_tpu.obs.__main__ import main
    return main(argv)


def _verdict_of(main, d):
    """(verdict, merged timeline) of ``main blackbox d``."""
    buf = io.StringIO()
    with redirect_stdout(buf):
        assert main(["blackbox", d]) == 0
    line = [ln for ln in buf.getvalue().splitlines()
            if ln.startswith("POD-BLACKBOX-VERDICT ")][0]
    with open(os.path.join(d, "pod-timeline.json")) as f:
        merged = json.load(f)
    return json.loads(line.split(" ", 1)[1]), merged


def test_cli_verdict_names_first_dead_and_aligns_clocks(tmp_path):
    d = _synthetic_pod(tmp_path)
    verdict, _ = _verdict_of(_port_main, d)
    assert verdict["first_dead"] == 1
    assert verdict["dead"] == [1] and verdict["survivors"] == [0]
    assert verdict["last_event"]["t"] == pytest.approx(110.0)
    assert verdict["last_fault"]["site"] == "host.die"
    assert verdict["armed_faults"] == ["host.die@12:hostkill"]
    view = verdict["survivor_views"]["0"]
    assert [e["name"] for e in view] == ["dead-hosts", "failover"]
    assert verdict["failovers"][0]["t"] > verdict["last_event"]["t"]


def test_cli_merged_timeline_is_valid_chrome_trace(tmp_path):
    d = _synthetic_pod(tmp_path)
    with open(os.path.join(d, "profile-p0.json"), "w") as f:
        json.dump({"traceEvents": [
            {"name": "op", "ph": "X", "ts": 0.0, "dur": 5.0,
             "pid": 0, "tid": 1}]}, f)
    path = os.path.join(d, "blackbox-p0.jsonl")
    lines = open(path).read().splitlines()
    header = json.loads(lines[0])
    header["trace0_wall"] = 118.0
    with open(path, "w") as f:
        f.write("\n".join([json.dumps(header)] + lines[1:]) + "\n")
    _, merged = _verdict_of(_port_main, d)
    events = merged["traceEvents"]
    assert events and isinstance(events, list)
    pids = {e.get("pid") for e in events if e.get("ph") != "M"}
    assert pids >= {0, 1}
    names = {e["args"]["name"] for e in events
             if e.get("name") == "process_name"}
    assert names == {"rank 0", "rank 1"}
    ops = [e for e in events if e.get("name") == "op"]
    assert ops and ops[0]["pid"] == 0
    assert ops[0]["ts"] == pytest.approx(18e6)
    spans = [e for e in events if e.get("name") == "span:step"]
    assert spans and spans[0]["ph"] == "X" and spans[0]["dur"] > 0


def test_cli_all_clean_pod(tmp_path):
    _write_rank_file(os.path.join(str(tmp_path), "blackbox-p0.jsonl"),
                     0, "child", "exit",
                     [{"s": 1, "t": 10.0, "kind": "epoch", "name": "end"}])
    verdict, _ = _verdict_of(_port_main, str(tmp_path))
    assert verdict["first_dead"] is None and verdict["dead"] == []


def test_cli_empty_dir_fails_legibly(tmp_path, capsys):
    assert _port_main(["blackbox", str(tmp_path)]) == 2
    assert "no blackbox" in capsys.readouterr().out


def test_cli_runs_as_a_module(tmp_path):
    d = _synthetic_pod(tmp_path)
    res = subprocess.run([sys.executable, "-m", "mxnet_tpu_torch.obs",
                          "blackbox", d], env=_env(), cwd=REPO,
                         capture_output=True, text=True, timeout=50)
    assert res.returncode == 0, res.stderr[-2000:]
    assert "first dead: rank 1" in res.stdout
    assert "POD-BLACKBOX-VERDICT" in res.stdout


def test_both_clis_agree_on_a_port_directory(recorder, tmp_path):
    recorder.record("epoch", "end", epoch=0, batches=4)
    with _profiler.span("fused_step_dispatch", "step"):
        pass
    recorder.record("fault", "fit.batch", arrival=3, kind="sigkill")
    recorder.flush("fault:fit.batch@3:sigkill")
    got = _verdict_of(_port_main, str(tmp_path))
    want = _verdict_of(_ref_main, str(tmp_path))
    assert got == want
    assert got[0]["dead"] == [0] and got[0]["last_fault"]["site"] == \
        "fit.batch"


def test_both_clis_agree_on_a_reference_directory(tmp_path):
    import mxnet_tpu as mx
    from mxnet_tpu.obs import blackbox as jbb
    mx.config.set("MXNET_TPU_OBS_BLACKBOX", str(tmp_path))
    mx.config.set("MXNET_TPU_OBS_BLACKBOX_FLUSH_SECS", "0")
    try:
        jbb.record("epoch", "end", epoch=0, batches=4)
        jbb.record("fault", "fit.batch", arrival=3, kind="sigkill")
        jbb.flush("fault:fit.batch@3:sigkill")
    finally:
        jbb.reset()
        mx.config.reset("MXNET_TPU_OBS_BLACKBOX")
        mx.config.reset("MXNET_TPU_OBS_BLACKBOX_FLUSH_SECS")
    got = _verdict_of(_port_main, str(tmp_path))
    want = _verdict_of(_ref_main, str(tmp_path))
    assert got == want and got[0]["first_dead"] == 0
    (tmp_path / "pod").mkdir()
    d = _synthetic_pod(tmp_path / "pod")
    assert _verdict_of(_port_main, d) == _verdict_of(_ref_main, d)


def test_recorder_registers_no_signal_handler():
    """The recorder and its CLI neither register a signal handler nor
    import ``signal``: the preemption flush runs on the training thread
    when the flag the handler set is observed."""
    obs = Path(REPO) / "mxnet_tpu_torch" / "obs"
    for name in ("blackbox.py", "__main__.py"):
        tree = ast.parse((obs / name).read_text())
        for node in ast.walk(tree):
            if isinstance(node, (ast.Import, ast.ImportFrom)):
                mods = [a.name for a in node.names] + \
                    [getattr(node, "module", None) or ""]
                assert "signal" not in mods, name
            if isinstance(node, ast.Attribute):
                assert node.attr not in ("signal", "setitimer"), name
