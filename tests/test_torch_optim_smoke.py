"""``chip_smoke.py``'s optimizer and checkpoint phase (phase 11)
rehearsed on the CPU.

At a small width, with the kernel wrappers counting around the plain
attention versions and the CUDA-only calls stood in for: (a) every
optimizer x variant, grouped against per-parameter; (b) the LM through
``Module.fit`` with Adam, the schedule, the composite metric and an
async checkpoint, held to the plain forward with each attention kernel
once per layer per step; (c) the resume check (restored state bit for
bit, the resumed run on the uninterrupted run's weights); (d) the Gluon
DCGAN with its Trainers' state round trip. Then the checks end the run
when the port is broken: a grouped update that drifts from the
per-parameter one, a checkpoint that restores another update count.
"""
import numpy as np
import pytest
import torch

import chip_smoke
import mxnet_tpu_torch as mt
from mxnet_tpu_torch.ops import flash_attention as fa


class _Event:
    """A CUDA event stand-in on the host clock."""

    def __init__(self, enable_timing=False):
        self.t = None

    def record(self):
        import time
        self.t = time.perf_counter()

    def elapsed_time(self, end):
        return (end.t - self.t) * 1e3


def _plain_dkv(q, k, v, do, lse, delta, scale, causal):
    p = torch.exp(fa._scores(q, k, scale, causal) - lse[..., None])
    dof = do.float()
    ds = p * (dof @ v.float().transpose(-1, -2) - delta[..., None]) * scale
    return ((ds.transpose(-1, -2) @ q.float()).to(k.dtype),
            (p.transpose(-1, -2) @ dof).to(v.dtype))


def _plain_dq(q, k, v, do, lse, delta, scale, causal):
    p = torch.exp(fa._scores(q, k, scale, causal) - lse[..., None])
    ds = p * (do.float() @ v.float().transpose(-1, -2)
              - delta[..., None]) * scale
    return (ds @ k.float()).to(q.dtype)


def _counting(plain):
    def wrapper(*args):
        key = "bf16" if args[0].dtype == torch.bfloat16 else "f32"
        wrapper.launches[key] += 1
        return plain(*args)
    wrapper.launches = {"f32": 0, "bf16": 0}
    return wrapper


@pytest.fixture
def small(monkeypatch, tmp_path):
    for name, value in (("DEVICE", "cpu"), ("VOCAB", 64), ("LAYERS", 2),
                        ("D_MODEL", 32), ("HEADS", 2), ("D_FF", 64),
                        ("MAX_SEQ", 16), ("TRAIN_BATCH", 2),
                        ("RESUME_LAYERS", 1), ("ROOT", tmp_path),
                        ("DCGAN_NZ", 8), ("DCGAN_NGF", 4),
                        ("DCGAN_NDF", 4), ("DCGAN_BATCH", 4),
                        ("CE_TOL", 1e-2)):
        monkeypatch.setattr(chip_smoke, name, value)
    monkeypatch.setattr(mt, "gpu", lambda i=0: mt.cpu())
    monkeypatch.setattr(torch.cuda, "Event", _Event)
    for fn in ("synchronize", "empty_cache", "reset_peak_memory_stats"):
        monkeypatch.setattr(torch.cuda, fn, lambda *a: None)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated", lambda *a: 0)
    monkeypatch.setattr(fa, "_dispatch", lambda q, what: True)
    monkeypatch.setattr(fa, "flash_attention_fwd",
                        _counting(fa.flash_attention_reference))
    monkeypatch.setattr(fa, "flash_attention_bwd_dq", _counting(_plain_dq))
    monkeypatch.setattr(fa, "flash_attention_bwd_dkv", _counting(_plain_dkv))
    lines = []
    monkeypatch.setattr(chip_smoke, "log", lambda *a: lines.append(a[0]))
    return lines


def test_optimizer_check_rehearsal(small):
    chip_smoke.optimizer_check(torch)
    assert any(ln.startswith("optimizers: 52 cases") for ln in small)


def test_optimizer_check_catches_a_drifting_grouped_update(small,
                                                           monkeypatch):
    """A grouped update that counts one step ahead (Adam's bias
    correction reads the count) fails the check."""
    real = mt.optimizer.Optimizer.update_multi

    def ahead(self, indices, *args, **kw):
        for i in indices:
            self._index_update_count[i] = \
                self._index_update_count.get(i, self.begin_num_update) + 1
        return real(self, indices, *args, **kw)

    monkeypatch.setattr(mt.optimizer.Optimizer, "update_multi", ahead)
    with pytest.raises(chip_smoke.SmokeFailure, match="optimizer adam"):
        chip_smoke.optimizer_check(torch)


def test_adam_lm_rehearsal(small):
    """(b) and (c): the LM through fit with Adam, then the resume check
    (bit for bit on the CPU); the attention kernels ran once per layer
    per step, and the checkpoint directories are gone after."""
    mt.amp.init("bfloat16")
    try:
        run = chip_smoke.adam_lm(torch, np, {
            "flash_attention_fwd_bf16": fa.flash_attention_fwd,
            "flash_attention_bwd_dq": fa.flash_attention_bwd_dq,
            "flash_attention_bwd_dkv": fa.flash_attention_bwd_dkv})
        chip_smoke.check_training("adam", run, "bf16", 989e12, "bf16")
        steps = 1 + chip_smoke.ADAM_WARM + chip_smoke.ADAM_TIMED + 1
        assert all(n["bf16"] == steps * 2 for n in run["launches"].values())
        assert run["ckpt"]["ckpt_saved"] == 1
        chip_smoke.resume_check(torch, np)
    finally:
        mt.amp.off()
    assert "resume: the resumed run's final weights equal the " \
        "uninterrupted run's bit for bit" in small
    assert not (chip_smoke.ROOT / "build" / "phase11_resume").exists()
    assert not (chip_smoke.ROOT / "build" / "phase11_lm_ckpt").exists()


def test_resume_check_catches_a_wrong_count(small, monkeypatch):
    real = mt.mod.Module._checkpoint_restore

    def off_by_one(self, ckpt):
        real(self, ckpt)
        self._optimizer.num_update += 1

    monkeypatch.setattr(mt.mod.Module, "_checkpoint_restore", off_by_one)
    with pytest.raises(chip_smoke.SmokeFailure, match="num_update"):
        chip_smoke.resume_check(torch, np)


def test_dcgan_rehearsal(small):
    chip_smoke.dcgan_check(torch, np)
    assert any("bit for bit" in ln and ln.startswith("dcgan: save_states")
               for ln in small)
