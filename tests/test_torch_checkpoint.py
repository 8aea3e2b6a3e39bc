"""The port's checkpoint subsystem: crash safety, verification,
retention, the async writer and preemption.

The port of the reference's ``tests/test_checkpoint.py`` cases for
``checkpoint/{atomic,format,manager}.py``: atomic writes, a ``kill -9``
at each point of the write protocol (subprocesses, the port's
fault-injection sites), bit flips and truncation caught at load with a
fall back to the newest valid checkpoint, retention that never deletes
the only valid one, the async writer's errors, blocking share and
backpressure, transient-error retries, and SIGTERM during ``fit``
(a subprocess of a few seconds: it saves, exits 143, and the
checkpoint resumes into the uninterrupted run's weights exactly).
Checkpoints also cross packages here at the format level: bfloat16
without ``ml_dtypes``, and a sharded save of the reference reassembled
on the host.
"""
import json
import os
import signal
import subprocess
import sys

import numpy as np
import pytest
import torch

import mxnet_tpu_torch as mt
from mxnet_tpu_torch import profiler
from mxnet_tpu_torch.checkpoint import (CheckpointConfig, CheckpointCorrupt,
                                        CheckpointError, CheckpointManager,
                                        CheckpointNotFound, atomic_open,
                                        collect_garbage, list_checkpoints,
                                        load_latest, probe_valid,
                                        read_checkpoint, restore_latest,
                                        write_checkpoint)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BATCH, NSAMP, FEAT, NCLS = 8, 64, 16, 8


def _tensors(step=1):
    rng = np.random.RandomState(step)
    return {"w": rng.normal(size=(32, 16)).astype(np.float32),
            "b": rng.normal(size=(16,)).astype(np.float32)}


def _assert_equal(w0, w1):
    assert set(w0) == set(w1)
    for k in sorted(w0):
        np.testing.assert_array_equal(np.asarray(w0[k]), np.asarray(w1[k]),
                                      err_msg=k)


def _mlp():
    data = mt.sym.Variable("data")
    fc1 = mt.sym.FullyConnected(data, num_hidden=12, name="fc1")
    act = mt.sym.Activation(fc1, act_type="relu", name="relu1")
    fc2 = mt.sym.FullyConnected(act, num_hidden=NCLS, name="fc2")
    return mt.sym.SoftmaxOutput(fc2, name="softmax")


def _fit(epochs, resume=None):
    rng = np.random.RandomState(0)
    x = rng.uniform(-1, 1, (NSAMP, FEAT)).astype(np.float32)
    y = rng.randint(0, NCLS, (NSAMP,)).astype(np.float32)
    r42 = np.random.RandomState(42)
    init = {"fc1_weight": r42.uniform(-0.1, 0.1, (12, FEAT)),
            "fc1_bias": r42.uniform(-0.1, 0.1, (12,)),
            "fc2_weight": r42.uniform(-0.1, 0.1, (NCLS, 12)),
            "fc2_bias": r42.uniform(-0.1, 0.1, (NCLS,))}
    mt.random.seed(7)
    mod = mt.mod.Module(_mlp(), context=mt.cpu())
    mod.fit(mt.io.NDArrayIter(x, y, batch_size=BATCH), num_epoch=epochs,
            optimizer="sgd", optimizer_params={"learning_rate": 0.1},
            arg_params=None if resume else
            {k: v.astype(np.float32) for k, v in init.items()},
            resume_from=resume)
    return {k: v.asnumpy() for k, v in mod.get_params()[0].items()}


# ----------------------------------------------------------- atomic writes

def test_atomic_open_replaces_only_on_success(tmp_path):
    p = str(tmp_path / "f.bin")
    with atomic_open(p, "wb") as f:
        f.write(b"first")
    with pytest.raises(RuntimeError):
        with atomic_open(p, "wb") as f:
            f.write(b"torn-half-")
            raise RuntimeError("crash mid-write")
    assert open(p, "rb").read() == b"first"
    assert os.listdir(str(tmp_path)) == ["f.bin"]
    with pytest.raises(ValueError):
        with atomic_open(p, "r+b"):
            pass


def test_atomic_open_reaps_dead_writer_temps_and_honors_umask(tmp_path):
    target = str(tmp_path / "x.bin")
    stale = str(tmp_path / ".x.bin.tmp-999999999-abcd")
    open(stale, "wb").write(b"orphan")
    with atomic_open(target, "wb") as f:
        f.write(b"data")
    assert not os.path.exists(stale)
    umask = os.umask(0)
    os.umask(umask)
    assert (os.stat(target).st_mode & 0o777) == (0o666 & ~umask)


# --------------------------------------------------------- format + verify

def test_write_read_roundtrip_and_meta(tmp_path):
    base = str(tmp_path)
    t = _tensors()
    t["t"] = torch.arange(6, dtype=torch.float64).reshape(2, 3)
    write_checkpoint(base, 7, t, meta={"loop": {"epoch": 2,
                                                "batches_done": 5}})
    path, tensors, manifest = load_latest(base)
    assert path.endswith("ckpt-0000000007")
    assert tensors["t"].dtype == np.float64
    _assert_equal(tensors, {k: np.asarray(v) for k, v in t.items()})
    assert manifest["meta"]["loop"]["batches_done"] == 5


def test_corruption_detected_and_fallback_to_previous(tmp_path):
    base = str(tmp_path)
    write_checkpoint(base, 1, _tensors(1))
    p2 = write_checkpoint(base, 2, _tensors(2))
    arrays = os.path.join(p2, "arrays.npz")
    blob = bytearray(open(arrays, "rb").read())
    blob[len(blob) // 2] ^= 0xFF
    open(arrays, "wb").write(bytes(blob))
    with pytest.raises(CheckpointCorrupt):
        read_checkpoint(p2)
    before = profiler.get_counter("ckpt_load_fallback")
    path, tensors, _ = load_latest(base)
    assert path.endswith("ckpt-0000000001")
    _assert_equal(tensors, _tensors(1))
    assert profiler.get_counter("ckpt_load_fallback") == before + 1


def test_manifest_tamper_and_truncation_rejected(tmp_path):
    base = str(tmp_path)
    p = write_checkpoint(base, 1, _tensors())
    man_path = os.path.join(p, "manifest.json")
    man = json.load(open(man_path))
    man["arrays"]["w"]["shape"] = [1, 1]
    json.dump(man, open(man_path, "w"))
    with pytest.raises(CheckpointCorrupt):
        read_checkpoint(p)
    open(man_path, "w").write("{half a manif")
    with pytest.raises(CheckpointCorrupt):
        read_checkpoint(p)
    assert not probe_valid(p)
    with pytest.raises(CheckpointNotFound):
        load_latest(base)


def test_truncated_arrays_and_corrupt_tensor_table(tmp_path):
    base = str(tmp_path)
    p1 = write_checkpoint(base, 1, _tensors(1))
    arrays = os.path.join(p1, "arrays.npz")
    blob = open(arrays, "rb").read()
    open(arrays, "wb").write(blob[:len(blob) // 2])
    assert not probe_valid(p1)
    p2 = write_checkpoint(base, 2, _tensors(2))
    man_path = os.path.join(p2, "manifest.json")
    man = json.load(open(man_path))
    man["tensors"]["w"]["key"] = "nonexistent"
    json.dump(man, open(man_path, "w"))
    with pytest.raises(CheckpointCorrupt):
        read_checkpoint(p2)
    with pytest.raises(CheckpointNotFound):
        load_latest(base)


def test_rewrite_replaces_invalid_existing_step(tmp_path):
    base = str(tmp_path)
    p = write_checkpoint(base, 1, _tensors(1))
    write_checkpoint(base, 1, _tensors(2))        # skipped: valid exists
    _assert_equal(read_checkpoint(p)[0], _tensors(1))
    open(os.path.join(p, "manifest.json"), "w").write("{")
    write_checkpoint(base, 1, _tensors(3))        # replaces the corpse
    _assert_equal(read_checkpoint(p)[0], _tensors(3))


def test_resume_payload_preserves_dtype(tmp_path):
    """f64, f16 and bf16 parameters come back at their saved precision."""
    base = str(tmp_path)
    bf = torch.tensor([1.5, -2.25, 3.0e-3], dtype=torch.bfloat16)
    t = {"arg:w64": np.arange(4, dtype=np.float64),
         "arg:w16": np.ones((3,), dtype=np.float16), "arg:wbf": bf}
    write_checkpoint(base, 1, t, meta={"param_names": ["w64", "w16",
                                                       "wbf"]})
    args = restore_latest(base).arg_params_nd()
    assert args["w64"].dtype == np.float64
    assert args["w16"].dtype == np.float16
    assert args["wbf"].data.dtype == torch.bfloat16
    assert torch.equal(args["wbf"].data, bf)
    np.testing.assert_array_equal(args["w64"].asnumpy(), t["arg:w64"])


def test_bfloat16_reads_in_the_reference(tmp_path):
    """A bfloat16 tensor the port wrote (no ml_dtypes) reads in the
    reference as bfloat16 under the manifest's dtype string, with the
    same bits; the reference's crc32 cannot view a bfloat16 buffer, so
    it reads it with verify=False."""
    import mxnet_tpu.checkpoint as ref_ckpt
    bf = torch.randn(5, 3).to(torch.bfloat16)
    p = write_checkpoint(str(tmp_path), 1, {"x": bf, "y": np.ones(2)})
    man = json.load(open(os.path.join(p, "manifest.json")))
    assert man["arrays"]["x"]["dtype"] == "bfloat16"
    tensors, _ = ref_ckpt.read_checkpoint(p, verify=False)
    assert str(tensors["x"].dtype) == "bfloat16"
    np.testing.assert_array_equal(
        tensors["x"].view(np.uint16),
        bf.view(torch.int16).numpy().view(np.uint16))


def test_sharded_reference_save_reassembles(tmp_path):
    """A mesh-bound reference save (one npz entry per shard) loads in
    the port as full host arrays."""
    import jax
    from jax.sharding import Mesh, NamedSharding, PartitionSpec
    import mxnet_tpu.checkpoint as ref_ckpt
    devs = np.array(jax.devices()[:4])
    if devs.size < 4:
        pytest.skip("needs 4 virtual devices (tests/conftest.py)")
    mesh = Mesh(devs.reshape(2, 2), ("x", "y"))
    full = np.arange(8 * 6, dtype=np.float32).reshape(8, 6)
    arr = jax.device_put(full, NamedSharding(mesh, PartitionSpec("x", None)))
    p = ref_ckpt.write_checkpoint(str(tmp_path), 1, {"w": arr})
    man = json.load(open(os.path.join(p, "manifest.json")))
    assert man["tensors"]["w"]["kind"] == "sharded"
    tensors, _ = read_checkpoint(p)
    np.testing.assert_array_equal(tensors["w"], full)
    with pytest.raises(CheckpointError, match="A9"):
        read_checkpoint(p, mesh=object())


def test_no_optimizer_saves_are_not_deduped(tmp_path):
    class _FakeMod:
        def __init__(self):
            self.v = 0

        def _checkpoint_snapshot(self):
            self.v += 1
            return {"w": np.full((2,), self.v, np.float32)}, {"step": 0}

    mgr = CheckpointManager(CheckpointConfig(str(tmp_path),
                                             async_save=False))
    fm = _FakeMod()
    s1 = mgr.save_module(fm, epoch=0)
    s2 = mgr.save_module(fm, epoch=1)
    assert s2 > s1
    assert len(list_checkpoints(str(tmp_path))) == 2
    assert load_latest(str(tmp_path))[1]["w"][0] == 2
    mgr.close()


# ------------------------------------------------- SIGKILL fault injection

_CRASH_CHILD = r"""
import os, sys
sys.path.insert(0, %(repo)r)
import numpy as np
from mxnet_tpu_torch import faults
from mxnet_tpu_torch.checkpoint import write_checkpoint
base = %(base)r
t = {"w": np.random.RandomState(0).normal(size=(64, 32)).astype(np.float32)}
write_checkpoint(base, 1, t)
faults.install("ckpt.%(point)s@1")
write_checkpoint(base, 2, t)
print("NOT-REACHED")
"""


@pytest.mark.parametrize("point", ["after_arrays", "after_manifest",
                                   "before_rename"])
def test_sigkill_mid_write_never_loses_previous(tmp_path, point):
    base = str(tmp_path)
    proc = subprocess.run(
        [sys.executable, "-c",
         _CRASH_CHILD % {"repo": REPO, "base": base, "point": point}],
        capture_output=True, text=True, timeout=120,
        env={**os.environ, "PYTHONPATH": "", "MXNET_TPU_FAULTS": ""})
    assert proc.returncode == -signal.SIGKILL, proc.stdout + proc.stderr
    assert "NOT-REACHED" not in proc.stdout
    assert [s for s, _ in list_checkpoints(base)] == [1]
    path, tensors, _ = load_latest(base)
    assert path.endswith("ckpt-0000000001")
    assert tensors["w"].shape == (64, 32)
    assert [n for n in os.listdir(base) if n.startswith(".tmp-")]
    collect_garbage(base, keep_last=5)
    assert not [n for n in os.listdir(base) if n.startswith(".tmp-")]


# ------------------------------------------------------------ retention GC

def test_gc_keep_last_and_keep_every(tmp_path):
    base = str(tmp_path)
    for s in range(1, 11):
        write_checkpoint(base, s, _tensors(s))
    assert collect_garbage(base, keep_last=2, keep_every=4) == 6
    assert [s for s, _ in list_checkpoints(base)] == [4, 8, 9, 10]


def test_gc_never_deletes_only_valid_checkpoint(tmp_path):
    base = str(tmp_path)
    p1 = write_checkpoint(base, 1, _tensors(1))
    write_checkpoint(base, 2, _tensors(2))
    p3 = write_checkpoint(base, 3, _tensors(3))
    open(os.path.join(p3, "arrays.npz"), "wb").write(b"junk")
    open(os.path.join(p1, "manifest.json"), "w").write("{")
    collect_garbage(base, keep_last=1)
    assert {s for s, _ in list_checkpoints(base)} == {1, 2, 3}
    assert load_latest(base)[0].endswith("ckpt-0000000002")


def test_gc_disabled_and_knob_defaults(tmp_path):
    base = str(tmp_path)
    for s in range(1, 4):
        write_checkpoint(base, s, _tensors(s))
    assert collect_garbage(base, keep_last=0) == 0
    assert len(list_checkpoints(base)) == 3
    c = CheckpointConfig(base)
    assert c.resolved_keep_last() == mt.config.get("MXNET_TPU_CKPT_KEEP")
    assert c.resolved_async() == mt.config.get("MXNET_TPU_CKPT_ASYNC")
    assert CheckpointConfig.coerce(tmp_path).directory == base


# --------------------------------------------------------- manager lifecycle

def test_async_write_error_surfaces_at_close(tmp_path):
    blocker = str(tmp_path / "blocker")
    open(blocker, "w").write("a file where the base dir must go")
    mgr = CheckpointManager(CheckpointConfig(
        os.path.join(blocker, "sub"), async_save=True))
    before = profiler.get_counter("ckpt_write_failed")
    mgr.save({"w": np.ones((4,), np.float32)}, {}, step=1)
    with pytest.raises(CheckpointError):
        mgr.close()
    assert profiler.get_counter("ckpt_write_failed") == before + 1


def test_sync_save_and_transient_error_retry(tmp_path):
    """A save that meets EIO before its first byte is retried (counted
    ``ckpt_write_retry``) and lands."""
    mgr = CheckpointManager(CheckpointConfig(str(tmp_path),
                                             async_save=False,
                                             retry_backoff=0.0))
    before = profiler.get_counter("ckpt_write_retry")
    mt.faults.install("ckpt.arrays_write@1")
    try:
        mgr.save({"w": np.ones((4,), np.float32)}, {"k": 1}, step=5)
    finally:
        mt.faults.clear()
    mgr.close()
    assert profiler.get_counter("ckpt_write_retry") == before + 1
    assert [s for s, _ in list_checkpoints(str(tmp_path))] == [5]


def test_async_blocking_is_fraction_of_write_time(tmp_path):
    mgr = CheckpointManager(CheckpointConfig(str(tmp_path), async_save=True,
                                             keep_last=0))
    rng = np.random.RandomState(0)
    tensors = {"w%d" % i: rng.normal(size=(256, 256)).astype(np.float32)
               for i in range(8)}
    b0 = profiler.get_counter("ckpt_block_us")
    w0 = profiler.get_counter("ckpt_write_us")
    for step in range(1, 6):
        mgr.save(dict(tensors), {}, step=step)
        mgr.wait()
    mgr.close()
    block = profiler.get_counter("ckpt_block_us") - b0
    write = profiler.get_counter("ckpt_write_us") - w0
    assert write > 0 and block < 0.25 * write, (block, write)


def test_async_backpressure_bounds_queue(tmp_path):
    mgr = CheckpointManager(CheckpointConfig(str(tmp_path), async_save=True,
                                             keep_last=0, queue_depth=1))
    tensors = {"w": np.random.RandomState(0).normal(
        size=(512, 512)).astype(np.float32)}
    before = profiler.get_counter("ckpt_backpressure_wait")
    for step in range(1, 7):
        mgr.save(dict(tensors), {}, step=step)
    mgr.wait()
    mgr.close()
    assert profiler.get_counter("ckpt_backpressure_wait") > before
    assert [s for s, _ in list_checkpoints(str(tmp_path))] == \
        list(range(1, 7))


def test_preempt_save_survives_stale_async_error(tmp_path):
    class _FakeMod:
        def _checkpoint_snapshot(self):
            return {"w": np.zeros((2,), np.float32)}, {"step": 1}

    mgr = CheckpointManager(CheckpointConfig(str(tmp_path)))
    mgr._last_error = RuntimeError("earlier async write failed")
    mgr.preempt_save(_FakeMod(), epoch=0)
    assert [s for s, _ in list_checkpoints(str(tmp_path))] == [1]


def test_resume_from_empty_directory_raises(tmp_path):
    with pytest.raises(CheckpointNotFound):
        _fit(1, resume=str(tmp_path))


# ------------------------------------------------------ SIGTERM preemption

_SIGTERM_CHILD = r"""
import os, signal, sys
sys.path.insert(0, %(repo)r)
sys.path.insert(0, %(tests)r)
import numpy as np
import mxnet_tpu_torch as mt
from test_torch_checkpoint import NCLS, NSAMP, FEAT, BATCH, _mlp
rng = np.random.RandomState(0)
x = rng.uniform(-1, 1, (NSAMP, FEAT)).astype(np.float32)
y = rng.randint(0, NCLS, (NSAMP,)).astype(np.float32)
r42 = np.random.RandomState(42)
init = {"fc1_weight": r42.uniform(-0.1, 0.1, (12, FEAT)),
        "fc1_bias": r42.uniform(-0.1, 0.1, (12,)),
        "fc2_weight": r42.uniform(-0.1, 0.1, (NCLS, 12)),
        "fc2_bias": r42.uniform(-0.1, 0.1, (NCLS,))}
mt.random.seed(7)
calls = [0]
def cb(param):
    calls[0] += 1
    if calls[0] == 10:        # the preemption notice, mid-epoch 1
        os.kill(os.getpid(), signal.SIGTERM)
mod = mt.mod.Module(_mlp(), context=mt.cpu())
mod.fit(mt.io.NDArrayIter(x, y, batch_size=BATCH), num_epoch=50,
        optimizer="sgd", optimizer_params={"learning_rate": 0.1},
        arg_params={k: v.astype(np.float32) for k, v in init.items()},
        checkpoint=mt.checkpoint.CheckpointConfig(%(base)r),
        batch_end_callback=cb)
print("FINISHED-WITHOUT-PREEMPT")
"""


def test_sigterm_preemption_saves_and_exits_143(tmp_path):
    base = str(tmp_path)
    proc = subprocess.run(
        [sys.executable, "-c", _SIGTERM_CHILD % {
            "repo": REPO, "tests": os.path.join(REPO, "tests"),
            "base": base}],
        capture_output=True, text=True, timeout=120,
        env={**os.environ, "PYTHONPATH": ""})
    assert proc.returncode == 143, proc.stdout + proc.stderr
    assert "FINISHED-WITHOUT-PREEMPT" not in proc.stdout
    ckpt = restore_latest(base)
    assert ckpt.mid_epoch and ckpt.epoch == 1 and ckpt.batches_done == 2
    _assert_equal(_fit(3, resume=base), _fit(3))
