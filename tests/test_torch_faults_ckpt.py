"""The port's fault injector (``mxnet_tpu_torch.faults``) and its
checkpoint reader's fault sites, held against the JAX package.

* **grammar**: the same spec strings give the same parsed specs, the
  same arrival counting and the same errors in both packages; the
  legacy ``MXNET_TPU_CKPT_TEST_CRASH`` alias, ``armed_or_env``, the
  ``MXNET_TPU_FAULTS_TOUCH`` marker; the pod runtime's sites and kind
  are refused naming ROADMAP A9.
* **corrupt checkpoints**: a bit flip in the manifest and a truncated
  arrays file fall back to the previous checkpoint; rot in every
  candidate raises not-found (the reference's drills, on the port).
* **kill and resume**: a ``fit.batch@13`` kill, SIGTERM (exit 143) and
  SIGKILL, resumes to the port's uninterrupted run bit for bit, which
  lies within 1e-6 of the reference's uninterrupted run from the same
  numpy-drawn weights.
"""
import errno
import os
import signal
import subprocess
import sys

import numpy as np
import pytest
import torch

import mxnet_tpu as mx
import mxnet_tpu_torch as mt
from mxnet_tpu import faults as jfaults
from mxnet_tpu_torch import faults, profiler
from mxnet_tpu_torch.checkpoint import (CheckpointNotFound, list_checkpoints,
                                        load_latest, write_checkpoint)

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _small_children(monkeypatch):
    """Child processes keep torch's intra-op pool small too (C20)."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")


@pytest.fixture(autouse=True)
def _disarm():
    faults.clear()
    jfaults.clear()
    yield
    faults.clear()
    jfaults.clear()


# ------------------------------------------------------------ the grammar

SPECS = ("x.site@2:raise", "y.site:eio", "z.site@1",
         "ckpt.arrays_write@1:eio,ckpt.arrays_write@2:enospc",
         "fit.batch@12:sigterm", "ckpt.read_manifest@1:bitflip",
         "ckpt.read_arrays:truncate", "serve.decode@3:eintr",
         " a.b@4:RAISE , c.d:slow ", "w.site@1:wedge")


@pytest.mark.parametrize("spec", SPECS)
def test_specs_parse_alike(spec):
    faults.install(spec)
    jfaults.install(spec)
    assert faults.active_specs() == jfaults.active_specs()
    assert faults.ARMED and jfaults.ARMED


@pytest.mark.parametrize("spec", ("a.b@1:frobnicate", "a.b@0:eio",
                                  "@1:eio", "a.b@x:eio", "a.b@-2"))
def test_bad_specs_raise_alike_and_arm_nothing(spec):
    for pkg in (faults, jfaults):
        with pytest.raises(ValueError):
            pkg.install(spec)
        assert not pkg.ARMED


@pytest.mark.parametrize("spec,site,fires", [
    ("x.site@2:raise", "x.site", [False, True, False, False]),
    ("x.site:raise", "x.site", [True, True, True]),
    ("x.site@3:raise,x.site@1:raise", "x.site", [True, False, True, False]),
    ("x.site@1:raise", "y.site", [False, False]),
])
def test_arrival_counting_alike(spec, site, fires):
    for pkg in (faults, jfaults):
        pkg.install(spec)
        got = []
        for _ in fires:
            try:
                pkg.fire(site)
                got.append(False)
            except pkg.FaultInjected:
                got.append(True)
        assert got == fires, pkg.__name__


@pytest.mark.parametrize("kind,code", [("eio", errno.EIO),
                                       ("enospc", errno.ENOSPC),
                                       ("eintr", errno.EINTR)])
def test_errno_kinds_and_default_kind_alike(kind, code):
    for pkg in (faults, jfaults):
        pkg.install("z.site@1")
        with pytest.raises(OSError) as ei:
            pkg.fire("z.site", default_kind=kind)
        assert ei.value.errno == code
        pkg.install("z.site:%s" % kind)
        with pytest.raises(OSError) as ei:
            pkg.fire("z.site", path="/some/file")
        assert ei.value.errno == code and ei.value.filename == "/some/file"


@pytest.mark.parametrize("spec", ("host.die@1", "leader.die@2:hostkill",
                                  "dist.kv:raise", "ckpt.after_record@1",
                                  "fit.batch@1:coordsvc"))
def test_pod_sites_and_kinds_are_refused_naming_a9(spec):
    jfaults.install(spec)           # the reference arms them
    with pytest.raises(ValueError, match="A9"):
        faults.install(spec)
    assert not faults.ARMED


def test_bitflip_and_truncate_corrupt_the_sites_file(tmp_path):
    data = bytes(range(64))
    for kind in ("bitflip", "truncate"):
        outs = []
        for pkg in (faults, jfaults):
            path = tmp_path / ("%s-%s" % (kind, pkg.__name__))
            path.write_bytes(data)
            pkg.install("r.site@1:%s" % kind)
            pkg.fire("r.site", path=str(path))
            outs.append(path.read_bytes())
            pkg.install("r.site@1:%s" % kind)
            with pytest.raises(pkg.FaultInjected, match="no file"):
                pkg.fire("r.site")
        assert outs[0] == outs[1] != data
    assert len(outs[0]) == 32


def test_marker_records_each_fire_before_it_acts(tmp_path, monkeypatch):
    marker = tmp_path / "touch"
    monkeypatch.setenv(faults.MARKER_ENV, str(marker))
    faults.install("m.site@2:raise,n.site:eio")
    faults.fire("m.site")
    with pytest.raises(faults.FaultInjected):
        faults.fire("m.site")
    with pytest.raises(OSError):
        faults.fire("n.site")
    assert marker.read_text().splitlines() == ["m.site@2:raise",
                                               "n.site@1:eio"]


def test_disarmed_is_silent_and_counterless():
    assert not faults.ARMED
    before = profiler.get_counter("fault_injected")
    faults.fire("ckpt.arrays_write")
    assert profiler.get_counter("fault_injected") == before


def test_armed_or_env_notices_the_environment_and_clear_is_final(
        monkeypatch):
    monkeypatch.setattr(faults, "_env_disarmed", False)
    monkeypatch.setenv(faults.ENV, "q.site@1:raise")
    assert faults.armed_or_env() and faults.ARMED
    with pytest.raises(faults.FaultInjected):
        faults.fire("q.site")
    faults.clear()
    assert not faults.armed_or_env() and not faults.ARMED
    monkeypatch.setenv(jfaults.ENV, "q.site@1:raise")
    jfaults.clear()
    assert not jfaults.armed_or_env()


def test_legacy_alias_parses_as_the_reference_does(monkeypatch):
    monkeypatch.setenv(faults.LEGACY_ENV, "after_arrays@2")
    monkeypatch.delenv(faults.ENV, raising=False)
    assert [repr(s) for s in faults._parse_env()] == \
        [repr(s) for s in jfaults._parse_env()] == \
        ["ckpt.after_arrays@2:sigkill"]


def test_config_set_routes_through_install():
    from mxnet_tpu_torch import config as cfg
    cfg.set("MXNET_TPU_FAULTS", "q.site@1:raise")
    try:
        assert faults.ARMED
        with pytest.raises(faults.FaultInjected):
            faults.fire("q.site")
        cfg.set("MXNET_TPU_FAULTS", "")
        assert not faults.ARMED
    finally:
        cfg.reset("MXNET_TPU_FAULTS")


def test_legacy_ckpt_crash_env_sigkills_the_writer(tmp_path):
    """``MXNET_TPU_CKPT_TEST_CRASH=after_arrays@2`` kills the second
    save after its arrays landed: only the first survives."""
    child = (
        "import numpy as np\n"
        "from mxnet_tpu_torch.checkpoint import write_checkpoint\n"
        "write_checkpoint(%r, 1, {'x': np.ones(4, np.float32)})\n"
        "write_checkpoint(%r, 2, {'x': np.ones(4, np.float32)})\n"
        "print('SECOND-SAVE-LANDED')\n" % (str(tmp_path), str(tmp_path)))
    proc = subprocess.run(
        [sys.executable, "-c", child], capture_output=True, text=True,
        timeout=120, cwd=REPO,
        env={**os.environ, "PYTHONPATH": REPO,
             "MXNET_TPU_CKPT_TEST_CRASH": "after_arrays@2"})
    assert proc.returncode == -signal.SIGKILL, proc.stdout + proc.stderr
    assert "SECOND-SAVE-LANDED" not in proc.stdout
    assert [s for s, _ in list_checkpoints(str(tmp_path))] == [1]


# ------------------------------------------------- read-side bit-rot drill

def test_manifest_bitflip_falls_back_to_previous(tmp_path):
    write_checkpoint(str(tmp_path), 1, {"w": np.full(8, 1.0, np.float32)})
    write_checkpoint(str(tmp_path), 2, {"w": np.full(8, 2.0, np.float32)})
    before = profiler.get_counter("ckpt_load_fallback")
    faults.install("ckpt.read_manifest@1:bitflip")
    path, tensors, _m = load_latest(str(tmp_path))
    assert path.endswith("ckpt-0000000001")
    assert tensors["w"][0] == 1.0
    assert profiler.get_counter("ckpt_load_fallback") - before == 1


def test_arrays_truncation_falls_back_to_previous(tmp_path):
    write_checkpoint(str(tmp_path), 1, {"w": np.full(64, 1.0, np.float32)})
    write_checkpoint(str(tmp_path), 2, {"w": np.full(64, 2.0, np.float32)})
    faults.install("ckpt.read_arrays@1:truncate")
    path, tensors, _m = load_latest(str(tmp_path))
    assert path.endswith("ckpt-0000000001")
    assert tensors["w"][0] == 1.0


@pytest.mark.parametrize("spec", ("ckpt.read_arrays:bitflip",
                                  "ckpt.read_manifest:truncate"))
def test_all_candidates_rotted_raises_not_found(tmp_path, spec):
    write_checkpoint(str(tmp_path), 1, {"w": np.ones(64, np.float32)})
    write_checkpoint(str(tmp_path), 2, {"w": np.ones(64, np.float32)})
    faults.install(spec)                 # every arrival
    with pytest.raises(CheckpointNotFound):
        load_latest(str(tmp_path))


def test_the_same_rot_falls_back_alike_in_both_packages(tmp_path):
    """The reference's reader meets the port's corruption of the same
    file the same way: each falls back from step 2 to step 1."""
    from mxnet_tpu.checkpoint import load_latest as jload_latest
    for pkg, load, sub in ((faults, load_latest, "port"),
                           (jfaults, jload_latest, "ref")):
        base = str(tmp_path / sub)
        for step in (1, 2):
            write_checkpoint(base, step,
                             {"w": np.full(64, float(step), np.float32)})
        pkg.install("ckpt.read_manifest@1:bitflip")
        path, tensors, _m = load(base)
        assert path.endswith("ckpt-0000000001")
        assert float(np.asarray(tensors["w"])[0]) == 1.0


# -------------------------------------------- kill-kind fit drills

def _weights():
    rng = np.random.RandomState(1)
    return {"fc1_weight": rng.uniform(-0.3, 0.3, (8, 16)).astype(np.float32),
            "fc1_bias": rng.uniform(-0.1, 0.1, (8,)).astype(np.float32)}


def _data():
    rng = np.random.RandomState(0)
    return (rng.uniform(-1, 1, (64, 16)).astype(np.float32),
            rng.randint(0, 8, (64,)).astype(np.float32))


_KILL_CHILD = r"""
import numpy as np
import mxnet_tpu_torch as mt
rng = np.random.RandomState(1)
w = {"fc1_weight": rng.uniform(-0.3, 0.3, (8, 16)).astype(np.float32),
     "fc1_bias": rng.uniform(-0.1, 0.1, (8,)).astype(np.float32)}
rng = np.random.RandomState(0)
X = rng.uniform(-1, 1, (64, 16)).astype(np.float32)
Y = rng.randint(0, 8, (64,)).astype(np.float32)
mt.random.seed(7)
sym = mt.sym.SoftmaxOutput(
    mt.sym.FullyConnected(mt.sym.Variable("data"), num_hidden=8,
                          name="fc1"), name="softmax")
with mt.device_scope("cpu"):
    it = mt.io.NDArrayIter(X, Y, batch_size=8)
    args = {k: mt.nd.array(v) for k, v in w.items()}
mod = mt.mod.Module(sym, context=mt.cpu())
cfg = mt.checkpoint.CheckpointConfig(%(base)r, every_n_batches=2,
                                     period_epochs=1)
mod.fit(it, num_epoch=4, optimizer="sgd",
        optimizer_params={"learning_rate": 0.1}, checkpoint=cfg,
        arg_params=args)
print("FINISHED-WITHOUT-FAULT")
"""


def _port_fit(resume):
    X, Y = _data()
    mt.random.seed(7)
    sym = mt.sym.SoftmaxOutput(
        mt.sym.FullyConnected(mt.sym.Variable("data"), num_hidden=8,
                              name="fc1"), name="softmax")
    with mt.device_scope("cpu"):
        it = mt.io.NDArrayIter(X, Y, batch_size=8)
        args = {k: mt.nd.array(v) for k, v in _weights().items()}
    mod = mt.mod.Module(sym, context=mt.cpu())
    mod.fit(it, num_epoch=4, optimizer="sgd",
            optimizer_params={"learning_rate": 0.1}, resume_from=resume,
            arg_params=args)
    arg, _aux = mod.get_params()
    return {k: v.asnumpy().copy() for k, v in arg.items()}


@pytest.fixture(scope="module")
def uninterrupted():
    """The port's uninterrupted run, and the reference's from the same
    numpy-drawn weights."""
    X, Y = _data()
    mx.random.seed(7)
    sym = mx.sym.SoftmaxOutput(
        mx.sym.FullyConnected(mx.sym.Variable("data"), num_hidden=8,
                              name="fc1"), name="softmax")
    mod = mx.mod.Module(sym, context=mx.cpu())
    mod.fit(mx.io.NDArrayIter(X, Y, batch_size=8), num_epoch=4,
            optimizer="sgd", optimizer_params={"learning_rate": 0.1},
            arg_params={k: mx.nd.array(v) for k, v in _weights().items()})
    ref = {k: v.asnumpy().copy() for k, v in mod.get_params()[0].items()}
    return _port_fit(None), ref


@pytest.mark.parametrize("kind,expect_rc", [
    ("sigterm", 143),                 # preemption notice: clean save+143
    ("sigkill", -signal.SIGKILL),     # hard kill between batches
])
def test_fit_batch_kill_then_resume_matches_uninterrupted(
        tmp_path, uninterrupted, kind, expect_rc):
    base = str(tmp_path)
    proc = subprocess.run(
        [sys.executable, "-c", _KILL_CHILD % {"base": base}],
        capture_output=True, text=True, timeout=240, cwd=REPO,
        env={**os.environ, "PYTHONPATH": REPO, "OMP_NUM_THREADS": "1",
             "MXNET_TPU_FAULTS": "fit.batch@13:%s" % kind})
    assert proc.returncode == expect_rc, proc.stdout + proc.stderr
    assert "FINISHED-WITHOUT-FAULT" not in proc.stdout
    assert list_checkpoints(base), "no checkpoint survived the kill"
    resumed = _port_fit(base)
    port, ref = uninterrupted
    assert set(resumed) == set(port) == set(ref)
    for k in sorted(port):
        np.testing.assert_array_equal(resumed[k], port[k], err_msg=k)
        np.testing.assert_allclose(port[k], ref[k], rtol=0, atol=1e-6,
                                   err_msg=k)
