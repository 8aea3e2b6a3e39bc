"""CPU rehearsal of ``chip_smoke.py``'s phase 15 (the compile levers).

Phase 15 runs on the H100; here its functions run on the CPU at small
sizes, with the CUDA-only calls (events, memory statistics) stood in for
and counting wrappers around the plain attention versions (as
``tests/test_torch_wgmma_support.py`` rehearses the earlier phases):
ResNet-18 (v2, s2d stem) at 64x64 for 15a, the zoo LM at 4 layers of
width 32 for 15b. The CPU has no device memory statistics, so the 15b
check of the drop in peak memory against ``est_peak_saving`` cannot be
rehearsed (``tests/test_torch_remat.py`` holds the estimate to the
saved bytes it predicts); every other check runs at the card's limits
but the bf16 step-1 cross-entropy of 8 images (5e-2, as the ResNet
rehearsal holds it).
"""
import numpy as np
import pytest
import torch

import chip_smoke
from mxnet_tpu_torch.ops import flash_attention as fa
from test_torch_wgmma_support import _Event, _counting, _plain_dkv, _plain_dq

# test files run side by side in parallel workers: each keeps torch's
# intra-op pool small
torch.set_num_threads(2)


@pytest.fixture
def small_levers(monkeypatch):
    import mxnet_tpu_torch as mt
    for name, value in (("DEVICE", "cpu"), ("RESNET_LAYERS", 18),
                        ("RESNET_CLASSES", 10), ("RESNET_BATCH", 4),
                        ("RESNET_IMAGE", 64), ("RESNET_CE_TOL", 5e-2),
                        ("LEVERS_RESNET_BATCH", 8), ("LEVERS_TIMED", 2),
                        ("VOCAB", 64), ("LAYERS", 4), ("D_MODEL", 32),
                        ("HEADS", 2), ("D_FF", 64), ("MAX_SEQ", 16),
                        ("TRAIN_BATCH", 4),
                        ("LEVERS_SAVING_RTOL", float("inf")),
                        # what auto resolves to at these small sizes (the
                        # card's constants are the full configurations')
                        ("LEVERS_RESNET_POLICY",
                         "auto:dots_with_no_batch_dims_saveable"),
                        ("LEVERS_LM_POLICY",
                         "auto:dots_with_no_batch_dims_saveable")):
        monkeypatch.setattr(chip_smoke, name, value)
    monkeypatch.setattr(mt, "gpu", lambda i=0: mt.cpu())
    monkeypatch.setattr(torch.cuda, "Event", _Event)
    for fn in ("synchronize", "empty_cache", "reset_peak_memory_stats"):
        monkeypatch.setattr(torch.cuda, fn, lambda *a: None)
    monkeypatch.setattr(chip_smoke, "peak_memory", lambda *a: 0)
    monkeypatch.setattr(fa, "_dispatch", lambda q, what: True)
    monkeypatch.setattr(fa, "flash_attention_fwd",
                        _counting(fa.flash_attention_reference))
    monkeypatch.setattr(fa, "flash_attention_bwd_dq", _counting(_plain_dq))
    monkeypatch.setattr(fa, "flash_attention_bwd_dkv", _counting(_plain_dkv))
    for flag in (torch.backends.cudnn, torch.backends.cuda.matmul):
        monkeypatch.setattr(flag, "allow_tf32", False)
    # phase 15 runs the eager step, as chip_smoke.main runs phases 1-22
    # (the compiled step and update are phase 23's)
    monkeypatch.setenv("MXNET_TPU_FUSED_TRAINER", "0")
    lines = []
    monkeypatch.setattr(chip_smoke, "log", lambda *a: lines.append(a[0]))
    return lines


def test_levers_resnet_rehearsal_on_cpu(small_levers):
    """15a: auto resolves the reference's policy (whole forward, no
    plan: BatchNorm sits in every block), grad_accum 2 counts 2
    microbatches a step, the step-1 loss agrees with the plain forward,
    the loss falls and remat on and off end on the same weights."""
    lines = small_levers
    readings = chip_smoke.levers_resnet(torch, np)
    assert set(readings["peak_gb"]) == {"plain", "accum", "accum_remat",
                                        "plain_4"}
    for head in ("15a resnet_remat_accum: remat auto:dots_with_no_batch",
                 "15a grad_accum only: remat off", "15a peak memory",
                 "15a loss per step"):
        assert any(ln.startswith(head) for ln in lines), head


def test_levers_lm_rehearsal_on_cpu(small_levers):
    """15b: the plan holds every layer and its step is the unrolled one
    bit for bit; per-block remat with grad_accum 2 launches the forward
    attention kernel twice per layer per microbatch (the recompute) and
    the backward ones once, and ends on grad_accum 2's weights."""
    lines = small_levers
    kernels = {n: {} for n in ("flash_attention_fwd_bf16",
                               "flash_attention_bwd_dq",
                               "flash_attention_bwd_dkv")}
    readings = chip_smoke.levers_lm(torch, np, kernels, {"step_ms": 1.0})
    per_step = chip_smoke.LEVERS_STEPS * chip_smoke.LEVERS_ACCUM * 4
    assert kernels["flash_attention_fwd_bf16"]["remat_accum_launches"] == \
        2 * per_step
    assert kernels["flash_attention_bwd_dq"]["remat_accum_launches"] == \
        per_step
    assert readings["est_peak_saving_gb"] > 0
    assert any(ln.startswith("15b scan plan: scan_layers 4") for ln in lines)
    assert any(ln.startswith("15b remat + grad_accum 2: policy "
                             "auto:dots_with_no_batch") for ln in lines)


def test_levers_lm_ends_on_a_missing_recompute(small_levers, monkeypatch):
    """A remat that saved the attention output (no recompute launch)
    fails 15b's launch check."""
    from mxnet_tpu_torch import remat
    monkeypatch.setattr(remat.Policy, "wrap", lambda self, fn: fn)
    kernels = {n: {} for n in ("flash_attention_fwd_bf16",
                               "flash_attention_bwd_dq",
                               "flash_attention_bwd_dkv")}
    with pytest.raises(chip_smoke.SmokeFailure, match="launches"):
        chip_smoke.levers_lm(torch, np, kernels, {"step_ms": 1.0})
