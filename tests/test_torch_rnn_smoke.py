"""``chip_smoke.py``'s recurrent phase (phase 10) rehearsed on the CPU.

At a small width: the fused op against the script's plain per-step
recurrence (torch's CPU RNN standing for cuDNN's), the word LM through
Gluon (tied decoder, truncated BPTT, ``clip_global_norm``), the
bucketing LM through ``BucketingModule.fit`` with its identity, falling
perplexity and fused-cell checks, and each phase's log lines. Then the
checks end the run when the port is broken: a bucket that copies the
default bucket's weights instead of sharing them, a fused op whose gate
order is wrong, a fused cell packed with two gates exchanged, a word LM
that drops its tie or packs its input and recurrent weights in each
other's place. Every limit is the card's.
"""
import numpy as np
import pytest
import torch

import chip_smoke
import mxnet_tpu_torch as mt
from mxnet_tpu_torch.ops import rnn_op


class _Event:
    """A CUDA event stand-in on the host clock."""

    def __init__(self, enable_timing=False):
        self.t = None

    def record(self):
        import time
        self.t = time.perf_counter()

    def elapsed_time(self, end):
        return (end.t - self.t) * 1e3


@pytest.fixture
def small_rnn(monkeypatch):
    for name, value in (("DEVICE", "cpu"), ("WORD_VOCAB", 50),
                        ("WORD_WIDTH", 16), ("WORD_BATCH", 4),
                        ("WORD_BPTT", 5), ("WORD_WARM", 1),
                        ("WORD_TIMED", 2), ("BUCKET_VOCAB", 50),
                        ("BUCKET_WIDTH", 8), ("BUCKET_BATCH", 4),
                        ("BUCKETS", (3, 5, 7)), ("BUCKET_TIMED", 1),
                        ("RNN_CASES", ((12, ("lstm", "gru", "rnn_tanh")),)),
                        ("RNN_DEVICE_OPS", ("aten::lstm", "aten::gru",
                                            "aten::rnn_tanh"))):
        monkeypatch.setattr(chip_smoke, name, value)
    monkeypatch.setattr(mt, "gpu", lambda i=0: mt.cpu())
    monkeypatch.setattr(torch.cuda, "Event", _Event)
    for fn in ("synchronize", "empty_cache", "reset_peak_memory_stats"):
        monkeypatch.setattr(torch.cuda, fn, lambda *a: None)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated", lambda *a: 0)
    for flag in (torch.backends.cudnn, torch.backends.cuda.matmul):
        monkeypatch.setattr(flag, "allow_tf32", False)
    lines = []
    monkeypatch.setattr(chip_smoke, "log", lambda *a: lines.append(a[0]))
    return lines


def test_rnn_phase_rehearsal_on_cpu(small_rnn):
    lines = small_rnn
    chip_smoke.rnn_phase(torch, np)
    assert sum(ln.startswith("rnn op ") and "without the guard" not in ln
               for ln in lines) == 6
    assert any(ln.startswith("rnn op: 6 cases within") for ln in lines)
    for what in ("word lm f32: ", "word lm bf16: "):
        for head in ("word LM (tied", "loss per step",
                     "step-1 cross-entropy (dropout off, "):
            assert any(ln.startswith(what + head) for ln in lines), \
                what + head
    assert any(ln.startswith("word lm f32 device time by kind")
               for ln in lines)
    assert any(ln.startswith("bucket: lstm_bucketing LM") for ln in lines)
    for key in (3, 5, 7):
        assert any(ln.startswith("bucket %d: " % key) for ln in lines)
    assert any(ln.startswith("bucket 7: FusedRNNCell forward against")
               for ln in lines)
    assert any(ln.startswith("rnn op lstm H 12 without the guard around "
                             "its backward (cuDNN's TF32 switch True)")
               for ln in lines)
    for what in ("word lm f32: ", "word lm bf16: "):
        assert any(ln.startswith(what + "step-1 logits and final states")
                   for ln in lines)
    # the phase leaves cuDNN's switch as it found it
    assert not torch.backends.cudnn.allow_tf32


def test_bucket_phase_ends_on_a_copied_weight(small_rnn, monkeypatch):
    """A bucket bound with copies of the default bucket's parameters
    (the design the shared-module check exists to refuse) ends the
    run."""
    bind = mt.mod.Module.bind

    def copying_bind(self, *args, shared_module=None, **kw):
        bind(self, *args, **kw)
        if shared_module is not None:
            self.set_params(*shared_module.get_params())
    monkeypatch.setattr(mt.mod.Module, "bind", copying_bind)
    with pytest.raises(chip_smoke.SmokeFailure, match="does not hold the "
                       "default bucket's parameter tensors"):
        chip_smoke.bucket_phase(torch, np, {})


def test_fused_op_check_ends_on_a_wrong_gate_order(small_rnn, monkeypatch):
    layer = rnn_op._layer

    def swapped(mode, x, h0, c0, flat, bidir, train):
        # f and i gates exchanged in every W_x
        flat = list(flat)
        for k in range(0, len(flat), 4):
            w = flat[k]
            q = w.shape[0] // 4
            flat[k] = torch.cat([w[q:2 * q], w[:q], w[2 * q:]])
        return layer(mode, x, h0, c0, flat, bidir, train)
    monkeypatch.setattr(rnn_op, "_layer", swapped)
    monkeypatch.setattr(chip_smoke, "RNN_CASES", ((12, ("lstm",)),))
    with pytest.raises(chip_smoke.SmokeFailure, match="disagrees with the "
                       "plain recurrence"):
        chip_smoke.fused_op_check(torch)


def test_word_lm_ends_on_an_untied_decoder(small_rnn, monkeypatch):
    make = chip_smoke.word_lm

    def untied(mt_, gluon):
        model = make(mt_, gluon)
        model.decoder = gluon.nn.Dense(chip_smoke.WORD_VOCAB,
                                       in_units=chip_smoke.WORD_WIDTH)
        return model
    monkeypatch.setattr(chip_smoke, "word_lm", untied)
    with pytest.raises(chip_smoke.SmokeFailure, match="does not hold the "
                       "embedding's weight"):
        chip_smoke.train_word_lm(torch, np, {}, 0, 1, "word lm f32")


def test_bucket_phase_ends_on_swapped_gates_in_pack_weights(small_rnn,
                                                            monkeypatch):
    """A FusedRNNCell whose pack_weights exchanges the input and forget
    gates' weights: its logits differ from the unrolled cells'."""
    pack = mt.rnn.FusedRNNCell.pack_weights

    def swapped(self, args):
        args = dict(args)
        for key in [k for k in args if "_i_" in k]:
            other = key.replace("_i_", "_f_")
            args[key], args[other] = args[other], args[key]
        return pack(self, args)
    monkeypatch.setattr(mt.rnn.FusedRNNCell, "pack_weights", swapped)
    with pytest.raises(chip_smoke.SmokeFailure, match="the fused cell's "
                       "forward differs"):
        chip_smoke.bucket_phase(torch, np, {})


def test_word_lm_ends_on_swapped_i2h_h2h(small_rnn, monkeypatch):
    """A Gluon LSTM that packs each layer's h2h weight where its i2h
    weight goes (and back): the step-1 logits and states leave the plain
    forward's."""
    from mxnet_tpu_torch.gluon.rnn import rnn_layer
    packed = rnn_layer._RNNLayer._packed_params

    def swapped(self):
        saved = self._rnn_params
        self._rnn_params = [(q[1], q[0], *q[2:]) for q in saved]
        try:
            return packed(self)
        finally:
            self._rnn_params = saved
    monkeypatch.setattr(rnn_layer._RNNLayer, "_packed_params", swapped)
    with pytest.raises(chip_smoke.SmokeFailure, match="the step-1 forward "
                       "disagrees with the plain f32 forward"):
        run = chip_smoke.train_word_lm(torch, np, {}, 0, 1, "word lm f32")
        chip_smoke.check_word_lm("word lm f32", run, chip_smoke.WORD_CE_TOL,
                                 chip_smoke.RNN_RTOL, 1.0, "f32")
