"""``chip_smoke.py``'s phase 12 (the op library and the symbolic zoo nets)
rehearsed on the CPU.

With the device set to the CPU, small sizes (AlexNet at batch 2 and 67x67,
its smallest side, 10 classes; benchmark_score's AlexNet and Inception-BN
at batch 2; 10^5 sampler draws), the flash-attention wrappers replaced by
counting stand-ins (which must not run) and the CUDA-only calls stood in
for: (a) the op sweep runs every case, the "card" against the CPU (here
both the CPU), and the out-of-range check; (b) the samplers; (c) AlexNet
through ``Module.fit`` in amp bf16 and f32 against its plain forward; (d)
the scoring of the networks. Then the checks end the run when the port is
broken: a sweep case that differs or loses a NaN, an LRN off its formula,
a sampler off its distribution, an attention launch in an AlexNet step,
a card forward that parts from the CPU's. The amp bf16 cross-entropy of
2 images moves by bf16 roundings that the card's 128 images average
down, so it is held to 5e-2 here; every other limit is the card's.
"""
import inspect

import numpy as np
import pytest
import torch

import chip_smoke
import mxnet_tpu_torch as mt
from mxnet_tpu_torch.ops import OP_REGISTRY, get_op
from mxnet_tpu_torch.ops import flash_attention as fa

# test files run side by side in parallel workers: each keeps torch's
# intra-op pool small
torch.set_num_threads(2)


class _Event:
    """A CUDA event stand-in on the host clock."""

    def __init__(self, enable_timing=False):
        self.t = None

    def record(self):
        import time
        self.t = time.perf_counter()

    def elapsed_time(self, end):
        return (end.t - self.t) * 1e3


def _never(*args):
    raise AssertionError("an attention kernel ran in phase 12")


def _stand_in():
    fn = lambda *a: _never(*a)  # noqa: E731
    fn.launches = {"f32": 0, "bf16": 0}
    return fn


@pytest.fixture
def small(monkeypatch):
    for name, value in (("DEVICE", "cpu"), ("ALEX_BATCH", 2),
                        ("ALEX_IMAGE", 67), ("ALEX_CLASSES", 10),
                        ("ALEX_WARM", 0), ("ALEX_TIMED", 1),
                        ("ALEX_F32_WARM", 0), ("ALEX_F32_TIMED", 1),
                        ("ALEX_CE_TOL", 5e-2),
                        ("SCORE_NETS", ("alexnet", "inception-bn")),
                        ("SCORE_BATCH", 2), ("SCORE_WARM", 1),
                        ("SCORE_TIMED", 1), ("SAMPLER_DRAWS", 100000)):
        monkeypatch.setattr(chip_smoke, name, value)
    monkeypatch.setattr(mt, "gpu", lambda i=0: mt.cpu())
    monkeypatch.setattr(torch.cuda, "Event", _Event)
    for fn in ("synchronize", "empty_cache", "reset_peak_memory_stats"):
        monkeypatch.setattr(torch.cuda, fn, lambda *a: None)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated", lambda *a: 0)
    for name in ("flash_attention_fwd", "flash_attention_bwd_dq",
                 "flash_attention_bwd_dkv"):
        monkeypatch.setattr(fa, name, _stand_in())
    for flag in (torch.backends.cudnn, torch.backends.cuda.matmul):
        monkeypatch.setattr(flag, "allow_tf32", False)
    lines = []
    monkeypatch.setattr(chip_smoke, "log", lambda *a: lines.append(a[0]))
    return lines


def _patched(monkeypatch, name, fn):
    """Replace op ``name``'s function (keeping its signature, which the
    executor reads)."""
    op = get_op(name)
    fn.__signature__ = inspect.signature(op.fn)
    monkeypatch.setattr(op, "fn", fn)


def test_zoo_phase_rehearsal_on_cpu(small):
    lines = small
    chip_smoke.zoo_phase(torch, np)
    sweep = [ln for ln in lines if ln.startswith("op sweep: ")]
    assert len(sweep) == 1
    assert any(ln.startswith("out of range on cpu: pick [0, 5, -1] -> "
                             "[0.0, nan, 11.0]") for ln in lines)
    assert sum(ln.startswith("sampler _") for ln in lines) == 7 + 2
    assert any(ln.startswith("shuffle: arange(100000)") for ln in lines)
    for what in ("alexnet: ", "alexnet f32: "):
        for head in ("AlexNet, batch 2", "loss per step",
                     "inference forward of the initial weights"):
            assert any(ln.startswith(what + head) for ln in lines), head
    assert any(ln.startswith("alexnet device time by kind") for ln in lines)
    for net in ("alexnet", "inception-bn"):
        assert any(ln.startswith("score %s: " % net) for ln in lines)


def test_fit_loop_timing_rehearsal_on_cpu(small):
    """``--pairs-of CHECKOUT fit-loop``'s readings: AlexNet through the
    package's fit in amp bf16 and f32, a step time and an idle share
    each."""
    out = chip_smoke.fit_loop_timing(torch, np)
    assert set(out) == {"bf16", "f32"}
    for r in out.values():
        assert r["step_ms"] > 0 and r["idle"] <= 1.0
    for what in ("alexnet ", "alexnet f32 "):
        assert any(ln.startswith(what + "device time by kind")
                   for ln in small), what


def test_every_op_of_the_library_has_a_sweep_case():
    """12a covers each canonical op of the port's ops package but the
    samplers, FlashAttention and the structured families (vision,
    detection, contrib: phase 13a), some more than once."""
    cases = chip_smoke.op_cases(np)
    names = {name for _, name, _, _ in cases}
    want = {op.name for op in OP_REGISTRY.values()
            if op.__module__.startswith("mxnet_tpu_torch.ops.") and
            op.__module__.rsplit(".", 1)[-1] not in chip_smoke.STRUCTURED
            and not op.is_random} - {"FlashAttention"}
    assert names == want
    assert len(cases) > len(names)


def test_op_sweep_ends_on_a_differing_case(small, monkeypatch):
    """A case whose result on the card differs from the CPU's (here: the
    first of the two calls) ends the run."""
    right = get_op("LRN").fn
    calls = []

    def drifting(data, **kw):
        calls.append(1)
        out = right(data, **kw)
        return out * (1 + 1e-4) if len(calls) % 2 else out
    _patched(monkeypatch, "LRN", drifting)
    with pytest.raises(chip_smoke.SmokeFailure, match="op sweep LRN: output"):
        chip_smoke.op_sweep(torch, np, device="cpu")


def test_op_sweep_ends_on_a_lost_nan(small, monkeypatch):
    """The C9 case: pick clamping its index on one side (the repaired
    fault) ends the run."""
    right = get_op("pick").fn
    calls = []

    def clamping(data, index, **kw):
        calls.append(1)
        if len(calls) % 2:
            index = index.clamp(0, data.shape[-1] - 1)
        return right(data, index, **kw)
    _patched(monkeypatch, "pick", clamping)
    with pytest.raises(chip_smoke.SmokeFailure,
                       match="op sweep pick out of range"):
        chip_smoke.op_sweep(torch, np, device="cpu")


def test_alexnet_ends_on_an_lrn_off_its_formula(small, monkeypatch):
    """LRN that skips its normalization (the identity) moves the f32
    logits off the plain forward's."""
    _patched(monkeypatch, "LRN", lambda data, **kw: data * 1.0)
    run = chip_smoke.train_alexnet(torch, np, {}, 0, 1, "alexnet f32")
    with pytest.raises(chip_smoke.SmokeFailure, match="logits"):
        chip_smoke.check_alexnet("alexnet f32", run, "f32",
                                 chip_smoke.PEAK_FP32_FLOPS, "f32")


def test_alexnet_checks_end_the_run(small):
    """One f32 run passes its checks; the same readings with an
    attention launch, or with Dropout keeping 0.6, end the run."""
    run = chip_smoke.train_alexnet(torch, np, {}, 0, 1, "alexnet f32")
    chip_smoke.check_alexnet("alexnet f32", run, "f32",
                             chip_smoke.PEAK_FP32_FLOPS, "f32")
    for change, match in (
            ({"launches": {"flash_attention_fwd": {"f32": 1, "bf16": 0}}},
             "flash-attention"),
            ({"kept": 0.6}, "Dropout kept")):
        with pytest.raises(chip_smoke.SmokeFailure, match=match):
            chip_smoke.check_alexnet("alexnet f32", dict(run, **change),
                                     "f32", chip_smoke.PEAK_FP32_FLOPS,
                                     "f32")


def test_sampler_check_ends_on_a_wrong_distribution(small, monkeypatch):
    right = get_op("_random_exponential").fn

    def off(lam=1.0, shape=(), dtype="float32", _device=None):
        return right(lam=lam * 1.02, shape=shape, dtype=dtype,
                     _device=_device)
    _patched(monkeypatch, "_random_exponential", off)
    name, attrs, dist, discrete = [c for c in chip_smoke.sampler_cases()
                                   if c[0] == "_random_exponential"][0]
    mt.random.seed(0)
    with pytest.raises(chip_smoke.SmokeFailure, match="_random_exponential"):
        chip_smoke.sampler_check(torch, np, name, attrs, dist, discrete,
                                 200000, device="cpu")


def test_score_ends_on_a_card_forward_off_the_cpus(small, monkeypatch):
    """The first forward of a network (the "card" one) drifting from
    the CPU's ends the run (calls on meta tensors infer shapes)."""
    right = get_op("FullyConnected").fn
    calls = []

    def drifting(*args, **kw):
        out = right(*args, **kw)
        if out.device.type == "meta":
            return out
        calls.append(1)
        return out * (1 + 1e-3) if len(calls) == 1 else out
    _patched(monkeypatch, "FullyConnected", drifting)
    monkeypatch.setattr(chip_smoke, "SCORE_NETS", ("alexnet",))
    with pytest.raises(chip_smoke.SmokeFailure, match="score alexnet"):
        chip_smoke.score_phase(torch, np)


def test_net_macs_of_the_perf_table_nets():
    """The GMAC an image that phase 12's MFU and PERF.md's table use,
    counted from the layer shapes (convolutions and dense layers)."""
    got = {}
    for net in ("alexnet", "vgg-16", "inception-bn", "inception-v3",
                "resnet-50"):
        sym, side = chip_smoke.score_symbol(mt, net)
        got[net] = chip_smoke.net_macs(mt, sym, (1, 3, side, side))
    # AlexNet by hand at 224: conv1 54²·96·363, conv2 26²·256·2400, conv3
    # 12²·384·2304, conv4 12²·384·3456, conv5 12²·256·3456, fc 6400·4096
    # + 4096² + 4096·1000
    alex = (54 * 54 * 96 * 363 + 26 * 26 * 256 * 2400 +
            12 * 12 * 384 * 2304 + 12 * 12 * 384 * 3456 +
            12 * 12 * 256 * 3456 + 6400 * 4096 + 4096 * 4096 + 4096 * 1000)
    assert got["alexnet"] == alex
    assert 15.4e9 < got["vgg-16"] < 15.6e9
    assert 3.8e9 < got["resnet-50"] < 4.2e9
