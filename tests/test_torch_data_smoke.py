"""CPU rehearsal of ``chip_smoke.py``'s phase 16 (the data plane and the
async fit loop).

Phase 16 runs on the H100; here its functions run on the CPU at a small
size, with the CUDA events stood in for by the host clock (as
``tests/test_torch_wgmma_support.py`` rehearses the earlier phases):
48 records of 72 x 72-96 pixels, batches of 6 at 64x64, ResNet-18 (7x7
stem) with 10 classes, and for 16d batches of 4 over 4 batches an epoch.
Every check of the phase runs and ends the run on failure; the bf16
step-1 cross-entropy of 8 images is held to 5e-2 (as the ResNet
rehearsal holds it), and the learning rate is 0.01 (lr 0.1 at so small
a batch does not make the loss fall in 8 steps).

A rehearsal forks loader workers while prefetch threads run, so each one
runs in a process group of its own under ``DEADLINE_S``: past it the
whole group is killed and the test fails, and no hang outlives its test.
It keeps to about one core beside the suite's other workers: one torch
thread and one cv2 thread, ``ImageRecordIter`` on one thread, and loader
worker counts 1 and 2 in 16b. The module's tests share one rehearsal;
each reading of the phase is a case of its own.
"""
import json
import os
import signal
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import chip_smoke

TESTS = Path(__file__).resolve().parent
DEADLINE_S = 240

SMALL = (("DEVICE", "cpu"), ("RESNET_LAYERS", 18), ("RESNET_CLASSES", 10),
         ("RESNET_IMAGE", 64), ("RESNET_CE_TOL", 5e-2), ("DATA_RECORDS", 48),
         ("DATA_SHORT", 72), ("DATA_LONG", (72, 96)), ("DATA_BATCH", 6),
         ("DATA_THREADS", 1), ("DATA_MAX_THREADS", 1),
         ("DATA_PIPE_BATCHES", 4), ("DATA_WORKERS", (1, 2)),
         ("DATA_LOADER_BATCHES", 4), ("IMAGENET_WARM", 2),
         ("IMAGENET_PROFILED", 5), ("DATA_PARITY_STEPS", 2),
         ("DATA_RESUME_BATCH", 4), ("DATA_RESUME_BATCHES", 4),
         ("DATA_RESUME_AT", 2), ("DATA_FAULT", "data.worker@2:sigkill"),
         ("IMAGENET_LR", 0.01))


def _small():
    """The small size on the CPU, in this process (a child of the test):
    the constants above, the card's calls stood in for, and the log
    kept in the returned list."""
    import mxnet_tpu_torch as mt
    from test_torch_wgmma_support import _Event
    for name, value in SMALL:
        setattr(chip_smoke, name, value)
    mt.gpu = lambda i=0: mt.cpu()
    torch.cuda.Event = _Event
    for fn in ("synchronize", "empty_cache", "reset_peak_memory_stats"):
        setattr(torch.cuda, fn, lambda *a: None)
    for flag in (torch.backends.cudnn, torch.backends.cuda.matmul):
        flag.allow_tf32 = False
    lines = []
    chip_smoke.log = lambda *a: lines.append(a[0])
    return lines


def _rehearsal(tmp):
    chip_smoke.ROOT = tmp
    out = chip_smoke.data_phase(torch, np)
    return {"fit": sorted(out["fit"]),
            "loader": sorted(out["pipeline"]["loader"]),
            "left": (tmp / "build" / "phase16").exists()}


def _no_seek(tmp):
    import mxnet_tpu_torch as mt
    from mxnet_tpu_torch.data import DataLoader
    out = tmp / "p16"
    out.mkdir()
    mt.config.set("MXNET_USE_NATIVE_IO", False)
    rec = chip_smoke.records_phase(np, out)
    DataLoader._mx_fast_forward = lambda self, *a, **k: None
    try:
        chip_smoke.resume_phase(torch, np, mt, rec, out)
    except chip_smoke.SmokeFailure as exc:
        return {"failure": str(exc)}
    return {"failure": None}


CASES = {"rehearsal": _rehearsal, "no_seek": _no_seek}


def _child(case, tmp, result):
    """The subprocess's body: one case at the small size, its log lines
    and what it returned written to ``result`` as JSON."""
    import cv2
    torch.set_num_threads(1)
    cv2.setNumThreads(1)
    lines = _small()
    out = CASES[case](Path(tmp))
    Path(result).write_text(json.dumps({"lines": lines, "out": out}))


def _isolated(case, tmp_path):
    """Run ``case`` in a new process group under DEADLINE_S; kill the
    group (loader workers included) when it ends or times out. The group
    stays in the suite's session: where the kernel schedules by session
    (autogroup), a new session would weigh as much as the whole suite."""
    result = tmp_path / "result.json"
    code = ("import sys; sys.path[:0] = sys.argv[1:3]; "
            "import test_torch_data_smoke as t; t._child(*sys.argv[3:])")
    proc = subprocess.Popen(
        [sys.executable, "-c", code, str(TESTS), str(TESTS.parent), case,
         str(tmp_path), str(result)], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, process_group=0)
    try:
        _, err = proc.communicate(timeout=DEADLINE_S)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        _, err = proc.communicate()
        pytest.fail("the %s rehearsal did not end in %d s; its process "
                    "group was killed\n%s" % (case, DEADLINE_S, err[-4000:]))
    finally:
        try:
            os.killpg(proc.pid, signal.SIGKILL)
        except ProcessLookupError:
            pass
    assert proc.returncode == 0, err[-4000:]
    return json.loads(result.read_text())


@pytest.fixture(scope="module")
def rehearsal(tmp_path_factory):
    """Phase 16 rehearsed once for the module's tests."""
    return _isolated("rehearsal", tmp_path_factory.mktemp("phase16"))


def test_data_phase_rehearsal_on_cpu(rehearsal):
    """16a-16d end to end: the records read back, the pipeline's first
    batch is the oracle's, the loader's batches agree across worker
    counts, fit from records passes every check (step-1 loss, window
    parity, loop_host_sync 0, loop_prefetch_placed = steps, device
    accuracy = host count) in bf16 and f32, and the resume with another
    worker count and the run with killed workers end bit for bit on the
    uninterrupted weights."""
    lines, out = rehearsal["lines"], rehearsal["out"]
    assert out["fit"] == ["bf16", "f32"]
    assert out["loader"] == [0, 1, 2]
    for head in ("16 host probe", "16 route (fixed in chip_smoke.py",
                 "16a records: 48 JPEG records", "16b first batch against",
                 "16b DataLoader's first 3 batches, 0 workers against 1: "
                 "bit-identical",
                 "16b DataLoader's first 3 batches, 2 workers against 1: "
                 "bit-identical",
                 "16c bf16: ResNet-18 (7x7 stem) through Module.fit",
                 "16c f32: step-1 cross-entropy",
                 "16c windows 2 and 0 over 2 steps",
                 "16d DataLoader resume", "16d data.worker@2:sigkill: "):
        assert any(ln.startswith(head) for ln in lines), head
    assert not out["left"]


# each reading of the phase, and what it must say: the phase's checks
# end the run, so a reading that is there says that its check held
READINGS = (
    ("16 host probe: ", r'"native": ".+".*"nproc": \d+'),
    ("16 route (fixed in chip_smoke.py", r"encoded by cv2 .* decoded by cv2 "
     r"\(MXNET_USE_NATIVE_IO=0\)"),
    ("16a records: 48 JPEG records", r"read back byte for byte .*, 0 differ"),
    ("16b ImageRecordIter (cv2 route), 1 threads, batch 6",
     r"[\d.]+ img/s over 4 batches"),
    ("16b first batch against the numpy oracle",
     r"max \|diff\| 0 \(limit 0\), labels equal"),
    ("16b DataLoader's first 3 batches, 0 workers against 1",
     r"bit-identical$"),
    ("16b DataLoader's first 3 batches, 2 workers against 1",
     r"bit-identical$"),
    ("16c bf16: ResNet-18 (7x7 stem) through Module.fit",
     r'"loop_host_sync": 0, .*"loop_prefetch_stall": 0, '
     r'"loop_prefetch_placed": 8,'),
    ("16c f32: ResNet-18 (7x7 stem) through Module.fit",
     r'"loop_host_sync": 0, .*"loop_prefetch_stall": 0, '
     r'"loop_prefetch_placed": 8,'),
    ("16c bf16: step-1 cross-entropy",
     r"tolerance 0.05\); device accuracy (\d+) / 48, host count over the "
     r"fetched outputs \1$"),
    ("16c f32: step-1 cross-entropy",
     r"tolerance 0.001\); device accuracy (\d+) / 48, host count over the "
     r"fetched outputs \1$"),
    ("16c windows 2 and 0 over 2 steps", r"0 of \d+ arrays differ, bit for "
     r"bit$"),
    ("16d DataLoader resume: ResNet-18 batch 4",
     r'"batches_done": 2, .*"num_workers": 2, .*resumed with 4 workers: 2 '
     r"steps in [\d.]+ s, 0 of \d+ arrays differ"),
    ("16d data.worker@2:sigkill: ", r"[1-9]\d* worker respawns; 0 of \d+ "
     r"arrays differ"),
)


@pytest.mark.parametrize("head,says", READINGS, ids=[
    "host probe", "route", "16a records", "16b ImageRecordIter",
    "16b numpy oracle", "16b loader 0 against 1", "16b loader 2 against 1",
    "16c bf16 counters", "16c f32 counters", "16c bf16 step-1 loss",
    "16c f32 step-1 loss", "16c windows", "16d resume", "16d killed workers"])
def test_phase16_reading(rehearsal, head, says):
    """One reading of the rehearsed phase, logged once, saying what its
    check requires."""
    import re
    found = [ln for ln in rehearsal["lines"] if ln.startswith(head)]
    assert len(found) == 1, (head, found)
    assert re.search(says, found[0]), found[0]


def test_resume_check_catches_a_loader_that_does_not_seek(tmp_path):
    """A fast-forward that does nothing replays the consumed batches:
    16d's bit-for-bit check ends the run."""
    failure = _isolated("no_seek", tmp_path)["out"]["failure"]
    assert failure is not None and failure.startswith("16d"), failure


def test_route_is_fixed_and_named(tmp_path, monkeypatch):
    lines = []
    monkeypatch.setattr(chip_smoke, "log", lambda *a: lines.append(a[0]))
    probe = chip_smoke.host_probe(tmp_path)
    assert probe["nproc"] >= 1 and "native" in probe
    assert chip_smoke.DATA_ENCODER == chip_smoke.DATA_DECODER == "cv2"
    monkeypatch.setattr(chip_smoke, "DATA_DECODER", "no_such_decoder")
    with pytest.raises(chip_smoke.SmokeFailure, match="does not import"):
        chip_smoke.host_probe(tmp_path)
    assert sum("16 route" in ln for ln in lines) == 2
