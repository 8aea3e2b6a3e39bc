#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``mxnet_tpu_torch``) on one NVIDIA GPU.

Run from the root of a checkout, on a machine with one H100:

    python3 chip_smoke.py

``python3 chip_smoke.py --pairs-of CHECKOUT WHAT`` times only a part of
another checkout's package with this script's code, for a before/after
pair on one card: ``f32-backward`` its float32 dQ and dK/dV kernels (as
phase 5 times this one's), ``rtc`` its ``relu``, ``scale_add`` and
``split`` user kernels against torch's calls (as phase 7 pairs this
one's).

Phases, each fatal on failure (exit code 1, no result line):

1. card: ``nvidia-smi`` name and power limit, ``torch`` device name;
2. build: every CUDA source under ``mxnet_tpu_torch/csrc`` and the five
   user-kernel sources of ``mxnet_tpu_torch/rtc_examples.py`` (through
   ``rtc.CudaModule``) with ``nvcc``, all started together, with the
   compiler's register and shared-memory report. The three kernels on
   ``wgmma`` + TMA (the bf16 forward, dQ and dK/dV at head dims 64 and
   128) must spill nothing, and their SASS (``cuobjdump -sass``) must
   hold HGMMA and UTMALDG instructions; the three float32 kernels
   (forward, dQ and dK/dV, 3xTF32 on ``mma.sync``) must spill nothing
   and hold HMMA instructions, at every head dim; without
   ``cuobjdump`` the log says so;
3. kernels: the float32 forward (K1 f32, the serving path's) against
   its plain PyTorch version on the card at the shapes that path gives
   it, then, with the float32 dQ and dK/dV kernels (K2 f32, K3 f32),
   over a sweep of head dims 16-256, BH 1 and 16, S in {1, 65, 200,
   1000, 1024}, S != Sk both ways, causal and not, each case fatal;
   then timed at every prompt bucket of the burst (BH 16, D 128, causal)
   as the median of 5 windows of 20 launches with their spread and the
   host's µs per call, and by the profiler's kernel time, beside
   ``scaled_dot_product_attention`` timed alike, its plain version and
   its bound;
4. slice: ``GenerativeServer`` at the full width of the zoo transformer
   LM as ``bench.py`` trains it (12 layers, d_model 2048, 16 heads,
   d_ff 8192, vocab 32000, max_seq 1024), weights drawn from a seed,
   8 slots; 8 greedy prompts of 17 to 900 tokens submitted at once, 32
   new tokens each. The kernel launch counters are zeroed just before
   this cold burst and read just after; every kernel must have run. The
   same burst then runs warm, and once more under ``torch.profiler`` for
   the device's busy share and kernel time by name, and the burst's
   K1 f32 kernel time beside phase 3's bucket times weighted by the
   burst's launches. Last, prefill and
   decode logits are held against an independent plain forward of the
   same weights. The server is closed and its memory freed after this
   phase;
5. training kernels: the forward kernel with bfloat16 input and the dQ
   and dK/dV backward kernels against their plain versions at the shape
   the training step gives them (batch 8 x 16 heads, S 1024, D 128,
   causal; bfloat16 and float32), plus a ragged length and a non-causal
   case; an edge sweep of the bf16 forward, dQ and dK/dV kernels (S 1,
   65, 1000, 1024, S != Sk both ways, causal and not, D 16, 32 and 256
   on ``mma.sync``, 64 and 128 on ``wgmma``, BH 1 and 128), each case
   fatal; a head-dim sweep through ``flash_attention`` and autograd at
   D 48, 80 and 96 (zero-padded) and 256, f32 and bf16, BH 1 and 16, S
   65 and 1024, causal and not, against the plain versions at the real
   D (and D 320 must raise naming ROADMAP B7); then each kernel timed
   as the median of 5 windows of 20 launches, with the windows' spread
   and the host's µs per call, beside its plain version,
   ``scaled_dot_product_attention`` (forward, and backward for the two
   backward kernels together, timed alike), its bound, its TFLOP/s and
   its share of the bound: the bf16 kernels, then K2 f32 and K3 f32 in
   float32 (their bound on 3xTF32 and on FMAs), then the six D 256
   instances at BH 16;
6. train: ``Module`` on the same model at ``bench.py``'s training
   configuration (batch 8, T 1024, ``attention="flash"``, amp bfloat16,
   Xavier weights from a numpy seed, SGD lr 0.01) on one fixed random
   batch: the first step (bind included) timed, two warm steps, ten
   steps between CUDA events, then one step under ``torch.profiler``.
   The counters are zeroed before the first step and read after the
   thirteenth: each attention kernel must have run once per layer per
   step. The step-1 cross-entropy is held against an independent plain
   float32 forward of the same initial weights, and the loss must fall.
   Then the same with amp off (the reference's default; cuBLAS without
   TF32): the first step, one warm, five timed, one profiled; each f32
   attention kernel (K1 f32, K2 f32, K3 f32) must have run once per
   layer per step and no bf16 one;
7. rtc: the user-kernel tier. Each of the five kernels of
   ``rtc_examples`` (``scale_add``, ``relu``, ``split``,
   ``softmax_rows``, ``softmax_ce_grad``) against its plain version on
   the card and timed beside it, one library call and its bound, and
   ``scale_add`` once more from a thread torch never used. Then the
   counted path: ``scale_add`` through ``UserKernel.__call__``,
   ``relu`` through ``nd.<op>`` and ``sym.<op>`` + ``simple_bind`` +
   ``forward``, ``split`` (two outputs) through both, each equal to its
   plain version; and a ``CustomOp`` loss head on ``softmax_rows`` /
   ``softmax_ce_grad`` under ``FullyConnected(num_hidden=32000)`` (the
   zoo LM's output projection) trained by ``Module._fit_step`` on one
   fixed (8192, 2048) float32 batch: 13 steps, the step-1
   cross-entropy held against an independent plain float32 forward, the
   loss falling, and every kernel's launches equal to what the path
   implies;
8. resnet: ``Module`` on the zoo's ResNet-50 (v2, s2d stem, 1000
   classes) at ``bench.py``'s ResNet configuration (batch 128,
   3x224x224, amp bfloat16, Xavier(gaussian, in, 2) from seed 0, SGD lr
   0.05, momentum 0.9, wd 1e-4) on one fixed ``RandomState(0)`` batch:
   the first step, 2 warm, 12 between CUDA events, 1 under
   ``torch.profiler`` (device time by kind: conv forward and backward,
   BatchNorm, elementwise, pooling, optimizer; the idle share). The
   step-1 cross-entropy is held to 2e-2 nats of a plain float32 forward
   (``torch.nn.functional``, the 7x7/2 stem on the same weight, TF32
   off), the moving statistics step 1 commits to that forward's batch
   statistics blended by the momentum, the loss must fall, the module
   must hold the reference's 157 arg and 102 aux arrays, and no
   flash-attention kernel may launch (the counters are zeroed before
   the first step). Then the same in float32 (amp off, the reference's
   default): the first step, 1 warm, 5 timed; cross-entropy within
   1e-3 nats. This slice adds no kernel: convolutions run on cuDNN,
   BatchNorm on torch's kernels;
9. gluon: the imperative API. A HybridBlock calling
   ``F.FlashAttention(q, k, v, causal=True)`` at B 2, H 4, S 512, D 128
   runs under ``autograd.record()`` and ``backward()`` in bf16 and f32:
   K1, K2 and K3 must each launch once, the output and gradients match
   the plain versions. ``nn.Conv2DTranspose`` at a DCGAN generator's
   shape (batch 64, 512 -> 256 channels, kernel 4, stride 2, 8x8 ->
   16x16) against a plain f32 ``conv_transpose2d``, forward and
   backward. Then ``gluon.model_zoo.vision.get_model("resnet50_v1")``,
   hybridized, Xavier(gaussian, in, 2) from ``derive_numpy_rng`` after
   ``mt.random.seed(0)``, trained as the reference's Gluon example does
   (``autograd.record()``, ``backward()``, ``Trainer.step``; SGD lr
   0.05, momentum 0.9, wd 1e-4, ``SoftmaxCrossEntropyLoss``) on the
   ResNet phase's batch: amp bf16 (first step, 2 warm, 10 timed, 1
   profiled, then 11 un-hybridized, 10 of them timed) and f32 (1, 1, 5,
   1, then 1 + 5 un-hybridized). The step-1 loss and running
   statistics are held to ``plain_resnet_v1`` (the ResNet phase's
   limits), the parameter count to resnet50_v1's, the loss must fall,
   no attention kernel may launch, and in f32 one eager step and one
   hybridized step from the initial parameters must agree;
10. rnn: the fused RNN op against a plain per-step recurrence, the
    upstream Gluon word LM (tied 10,000 x 1500, 2 LSTM layers) in f32
    and amp bf16, and the upstream bucketing LM through
    ``BucketingModule`` over six buckets;
11. optimizers and checkpoints: (a) every optimizer of
    ``tests/test_fused_trainer.py`` under its four variants, the grouped
    (foreach) update against the per-parameter one over 3 steps on the
    LM's parameter shapes (2048², 2048 x 8192, 32000 x 2048 and a bias),
    each case fatal; (b) the LM of phase 6 in amp bf16 through
    ``Module.fit`` with Adam (lr 1e-4, wd 1e-4, clip 1.0),
    ``FactorScheduler(4, 0.5)``, ``CompositeEvalMetric([CrossEntropy(),
    Perplexity(None)])`` and an async ``CheckpointConfig``: 1 + 2 + 10
    steps + 1 profiled, beside phase 6's SGD step (step ms, tok/s, MFU,
    peak memory, the optimizer's device time), the step-1 loss held to
    the plain forward, each attention kernel once per layer per step,
    the epoch's checkpoint landed; (c) resume at the full width and 2 of
    the 12 layers: an uninterrupted fit of 2 epochs x 2 batches with a
    checkpoint each epoch, the first epoch's checkpoint restored bit for
    bit (parameters, Adam states, count, rate), and a fresh
    ``fit(resume_from=...)`` ending on the uninterrupted run's weights
    (bit for bit, or no further than a second uninterrupted run, naming
    the op that is not deterministic), with the checkpoint's bytes and
    its write, blocking and verified-read seconds; (d) the upstream
    Gluon DCGAN (nz 100, ngf 64, ndf 64, 64x64x3, batch 64, two Adam
    Trainers) for 5 steps with finite losses, then ``save_states`` /
    ``load_states`` into fresh Trainers continuing bit for bit for 2
    steps.

The second-to-last line is the kernel table as one JSON object; the
last is ``{"ok": true, "device": {...}}``. Without a GPU, or run from a
directory that holds nothing else of the repository, it exits non-zero.
"""
from __future__ import annotations

import gc
import json
import math
import subprocess
import sys
import threading
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# H100 SXM data-sheet peaks (dense), for the bound of each kernel
PEAK_FP32_FLOPS = 67e12
PEAK_TF32_FLOPS = 495e12
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES_PER_S = 3.35e12

# the zoo transformer at bench.py's training width
VOCAB, LAYERS, D_MODEL, HEADS, D_FF, MAX_SEQ = 32000, 12, 2048, 16, 8192, 1024
SLOTS, PAGE, NEW_TOKENS = 8, 16, 32
PROMPT_LENS = (17, 64, 130, 250, 400, 555, 700, 900)
SEED = 0
DEVICE = "cuda:0"

KERNEL_ATOL = 1e-4     # f32 kernel vs f32 plain version: rounding only
                       # (3xTF32 drops ~2^-21 of each term)
LOGITS_ATOL = 1e-3     # f32 served logits vs a plain forward: 12 layers
                       # of f32 sums in another order; logits are O(1)
# bf16 kernel outputs vs the plain version of the same bf16 inputs. The
# kernels round P (and dS) to bf16 as tensor-core operands, as the TPU
# kernels do; the plain versions keep them in f32 (the plain forward
# rounds P too); both round the result to bf16, whose step is 2^-8 to
# 2^-7 of a value. Three limits, all enforced:
# - each element: |err| <= 2^-6 |ref| + 0.1 rms(ref): two to four
#   bf16 steps of the value, plus room for the rounding of P and dS
#   (about 2^-9 of each term of a sum). Measured on the H100 at the
#   training shape: up to 0.055 rms(ref) beyond 2^-6 |ref|; 0.1
#   rms(ref) is about 0.012 there, where the median |ref| is 0.03-0.05;
# - the whole tensor: ||err|| / ||ref|| <= 1e-2 (measured 2.5e-3 to
#   2.9e-3), which an output wrong over most of its elements fails;
# - the largest error: <= 2e-2 max|ref| (measured: one bf16 step).
BF16_ELEM_RTOL = 2.0 ** -6
BF16_ELEM_RMS = 0.1
BF16_NORM_RTOL = 1e-2
BF16_MAX_RTOL = 2e-2

# the training phase: bench.py's transformer configuration
TRAIN_BATCH, TRAIN_LR = 8, 0.01
TRAIN_WARM, TRAIN_TIMED = 2, 10
# the f32 training phase (amp off): ~1 s a step, so fewer steps
TRAIN_F32_WARM, TRAIN_F32_TIMED = 1, 5
# step-1 loss (amp bf16) vs a plain f32 forward of the same weights:
# measured 1.9e-6 apart on the H100; a near-uniform output would read
# ln 32000 = 10.373, 0.059 from the expected 10.432
CE_TOL = 1e-3

# the rtc phase: the training step's hidden state (batch 8 x T 1024 rows
# of d_model), its d_ff activation, and the LM head at full vocabulary
RTC_STEPS_WARM, RTC_STEPS_TIMED = 3, 10
# scale_add, relu, split and softmax_ce_grad round once in f32, as their
# plain versions do: equal, or within 1e-6 max|ref|
RTC_EXACT_RTOL = 1e-6
# softmax_rows sums 32000 exponentials in another order than its plain
# version (per-thread running sums merged by shuffles, against torch's
# reduction) and rescales them: a few f32 roundings of each value
RTC_SOFTMAX_RTOL = 1e-5

# the ResNet phases: bench.py's ResNet section (ResNet-50 v2, s2d stem,
# 1000 classes, batch 128, 3x224x224, Xavier(gaussian, in, 2), SGD lr
# 0.05, momentum 0.9, wd 1e-4); 24.534 GFLOP per image per training
# step by bench.py's accounting (3 x 2 x 4.089 GMAC forward)
RESNET_LAYERS, RESNET_CLASSES, RESNET_BATCH, RESNET_IMAGE = 50, 1000, 128, 224
RESNET_LR, RESNET_MOMENTUM, RESNET_WD = 0.05, 0.9, 1e-4
RESNET_FLOPS_PER_IMG = 2 * 4.089e9 * 3
RESNET_EPS = 2e-5
RESNET_WARM, RESNET_TIMED = 2, 12
RESNET_F32_WARM, RESNET_F32_TIMED = 1, 5
# step-1 cross-entropy against the plain f32 forward: amp rounds every
# conv's operands and output to bf16 (53 layers); f32 sums in another
# order (and the s2d stem against the 7x7 one)
RESNET_CE_TOL = 2e-2
RESNET_F32_CE_TOL = 1e-3
# each BatchNorm's batch statistics as the committed moving ones imply
# them, (new - momentum*old) / (1 - momentum), against the plain f32
# forward's: the mean within STATS_RTOL*std + STATS_ATOL, the variance
# within STATS_RTOL*var + STATS_ATOL (STATS_ATOL covers the f32 blend's
# own rounding, ~2e-6 once divided by 1 - momentum). Under amp every
# conv rounds its operands and output to bf16 (2^-8), so the port's
# activations part from the f32 forward's by a few percent in the last
# stage, and their statistics with them (a ResNet-18 at 64x64, batch 4,
# on the CPU: up to 9% of a variance); f32 only sums in another order.
# A wrong blend fails either by far: left uncommitted, the implied
# statistics are the initial 0 and 1; with torch's momentum (the weight
# of the new value) they are 9·batch − 8·old.
RESNET_STATS_RTOL = 0.25
RESNET_F32_STATS_RTOL = 1e-3
RESNET_STATS_ATOL = 1e-5

# the Gluon phase: resnet50_v1 from the zoo at the ResNet phase's batch,
# learning rate, momentum and weight decay (the reference's Gluon
# example); the same cross-entropy and statistics limits as the ResNet
# phase. Gluon's BatchNorm eps is 1e-5.
GLUON_TIMED = 10
GLUON_EPS = 1e-5
# resnet50_v1's parameter values: 25,575,912 with a gradient (its
# bottlenecks' 1x1 convolutions carry biases) and 53,120 running
# statistics
GLUON_RESNET50_V1_VALUES = 25575912 + 53120
# one eager step against one hybridized step, f32, from the same
# parameters: the same ops on the same inputs. cuDNN's default f32
# weight gradients sum with atomics (two calls measured 8.8e-5 of a
# weight gradient's max apart), so both steps take its deterministic
# algorithms. A convolution bias that a BatchNorm follows has no
# gradient in exact arithmetic (two calls measured 2.02 of its own max
# |value| apart): its difference is scaled by its weight's gradient
GLUON_EAGER_RTOL = 1e-5
# the tape check of the attention kernels, and the DCGAN generator's
# Conv2DTranspose (batch, in channels, out channels, input side)
TAPE_ATTENTION_SHAPE = (2, 4, 512, 128)
DECONV_SHAPE = (64, 512, 256, 8)
# a plain f32 conv_transpose2d against cuDNN's f32 one (TF32 off): sums
# of 512 x 4 products (d data: 256 x 4) in another order
DECONV_RTOL = 1e-5
# phase 10, the recurrent family. The word LM: the upstream Gluon example
# (example/gluon/word_language_model) at its README's largest run: a tied
# 10,000 x 1500 embedding and decoder, 2 LSTM layers of 1500, dropout
# 0.65, batch 32 x bptt 35, gradients clipped to 0.2 x bptt x batch, SGD
# lr 1.0 (momentum 0, wd 0); tokens drawn from RandomState(0)
WORD_VOCAB, WORD_WIDTH, WORD_LAYERS = 10000, 1500, 2
WORD_BATCH, WORD_BPTT, WORD_DROPOUT = 32, 35, 0.65
WORD_LR, WORD_CLIP = 1.0, 0.2
WORD_WARM, WORD_TIMED = 2, 10
# step-1 cross-entropy (dropout off) against a plain f32 forward of the
# same weights: two LSTM layers and a 1500-wide decoder in f32, summed in
# another order
WORD_CE_TOL = 1e-3
# the same under amp bf16: every product's operands and result rounded
# to bf16 (2^-8), the logits' cross-entropy taken in f32
WORD_BF16_CE_TOL = 1e-2
# the step-1 logits and final LSTM states (dropout off) held elementwise
# to the plain f32 forward's, each within a share of max|ref|: RNN_RTOL
# in f32, as the fused op's check; under amp bf16, where the operands of
# every product and the states are rounded to bf16, WORD_BF16_RTOL, 3x
# the largest reading on an H100 (5.84e-3, the logits)
WORD_BF16_RTOL = 2e-2
# the bucketing LM: upstream example/rnn/lstm_bucketing.py's defaults (2
# LSTM layers of 200, embedding 200, batch 32, buckets 10-60, SGD lr 0.01,
# momentum 0, wd 1e-5, Xavier(in, 2.34)); sentences over 10,000 words,
# BUCKET_BATCHES batches a bucket in the epoch
BUCKET_VOCAB, BUCKET_WIDTH, BUCKET_LAYERS, BUCKET_BATCH = 10000, 200, 2, 32
BUCKETS = (10, 20, 30, 40, 50, 60)
BUCKET_BATCHES = 2
BUCKET_LR, BUCKET_WD = 0.01, 1e-5
BUCKET_TIMED = 2
# the fused op (cuDNN's RNN, f32, TF32 off) against a plain per-step
# recurrence, and the fused cell against the unrolled one: output,
# states and gradients within RNN_RTOL * max(1, max|ref|). f32 sums of
# up to 3000 products per gate and 35 steps of recurrence, in another
# order
RNN_RTOL = 1e-4
RNN_CASES = ((1500, ("lstm", "gru", "rnn_tanh")), (200, ("lstm", "gru")))
# the aten ops cuDNN's RNN runs under; the op must reach one on the card
RNN_DEVICE_OPS = ("aten::_cudnn_rnn",)
# phase 11, optimizers and checkpoints. (a) every optimizer of
# tests/test_fused_trainer.py under its four variants: the grouped
# (foreach) update against the per-parameter one over 3 steps, each
# weight and state within OPT_RTOL * max(1, max|ref|) (the same f32
# formulas in another order; 1e-5 is that of the CPU parity tests)
OPT_CASES = (("sgd", {}), ("sgd", {"momentum": 0.9}),
             ("nag", {"momentum": 0.9}), ("adam", {}), ("adagrad", {}),
             ("rmsprop", {}), ("rmsprop", {"centered": True}),
             ("adadelta", {}), ("ftrl", {}), ("adamax", {}), ("nadam", {}),
             ("dcasgd", {"momentum": 0.9}), ("test", {}))
OPT_VARIANTS = ({}, {"clip_gradient": 0.05}, {"clip_gradient": -1.0},
                {"wd": 0.01})
OPT_STEPS = 3
OPT_RTOL = 1e-5
# (b) the LM through Module.fit with Adam: lr 1e-4, wd 1e-4, clip 1.0,
# FactorScheduler(step=4, factor=0.5), 1 + 2 + 10 steps + 1 profiled
ADAM_PARAMS = {"learning_rate": 1e-4, "wd": 1e-4, "clip_gradient": 1.0}
ADAM_SCHED = (4, 0.5)
ADAM_WARM, ADAM_TIMED = 2, 10
# (c) resume at the full width and 2 of the 12 layers: 2 epochs of 2
# batches, a checkpoint each epoch
RESUME_LAYERS, RESUME_EPOCHS, RESUME_BATCHES = 2, 2, 2
# (d) the upstream Gluon DCGAN (example/gluon/dcgan.py) at its widths
DCGAN_NZ, DCGAN_NGF, DCGAN_NDF, DCGAN_SIZE, DCGAN_BATCH = 100, 64, 64, 64, 64
DCGAN_LR, DCGAN_BETA1 = 2e-4, 0.5
DCGAN_STEPS, DCGAN_CONTINUE = 5, 2


class SmokeFailure(Exception):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def log(*args) -> None:
    print(*args, flush=True)


# ------------------------------------------------------------- phases

def card_phase(torch):
    check(torch.cuda.is_available(), "torch.cuda.is_available() is False")
    smi = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    check(smi.returncode == 0, "nvidia-smi failed: %s" % smi.stderr)
    log(smi.stdout.strip())
    log("torch %s cuda %s device %s" % (torch.__version__, torch.version.cuda,
                                        torch.cuda.get_device_name(0)))
    # full float32 everywhere: the port's path and the plain versions
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def build_phase():
    """Every nvcc started together: the csrc libraries, and the user
    kernels through rtc.CudaModule (one thread each; a later CudaModule
    of the same source finds its cubin built)."""
    from concurrent.futures import ThreadPoolExecutor
    from mxnet_tpu_torch import _build, rtc, rtc_examples
    sources = sorted(p.name for p in _build.CSRC.glob("*.cu"))
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(rtc_examples.SOURCES)) as pool:
        futures = {name: pool.submit(rtc.CudaModule, src)
                   for name, src in rtc_examples.SOURCES.items()}
        _build.build(sources)
        modules = {name: f.result() for name, f in futures.items()}
    log("build: %d source(s) %s and %d rtc module(s) %s in %.2f s"
        % (len(sources), sources, len(modules), sorted(modules),
           time.perf_counter() - t0))
    for s in sources:
        log(_build.build_log(s).strip())
    for name, module in modules.items():
        log("rtc %s (%s): %s" % (name, module.cubin.name,
                                 module.build_log.strip()))
    wgmma_report(_build)


# the kernels on wgmma + TMA: record name -> (source, mangled-name part);
# their SASS must hold HGMMA (wgmma) and UTMALDG (TMA load) instructions
WGMMA_KERNELS = {
    "flash_attention_fwd_bf16": ("flash_attention_fwd.cu",
                                 "fa_fwd_bf16_wgmma"),
    "flash_attention_bwd_dq": ("flash_attention_bwd.cu",
                               "fa_bwd_dq_bf16_wgmma"),
    "flash_attention_bwd_dkv": ("flash_attention_bwd.cu",
                                "fa_bwd_dkv_bf16_wgmma"),
}
# the kernels on mma.sync tensor cores: their SASS must hold HMMA
MMA_KERNELS = {
    "flash_attention_fwd": ("flash_attention_fwd.cu", "fa_fwd_f32_tf32x3"),
    "flash_attention_bwd_dq_f32": ("flash_attention_bwd.cu",
                                   "fa_bwd_dq_f32_tf32x3"),
    "flash_attention_bwd_dkv_f32": ("flash_attention_bwd.cu",
                                    "fa_bwd_dkv_f32_tf32x3"),
}
BUILD_REPORT = {}


def wgmma_report(_build):
    """ptxas registers and spills of the tensor-core kernels, and the
    count of the instructions each must hold in its SASS (HGMMA and
    UTMALDG for the wgmma kernels, HMMA for the mma.sync ones); fatal if
    one spills or lacks one of them."""
    tool = _build.cuobjdump()
    groups = [(WGMMA_KERNELS, ("HGMMA", "UTMALDG")), (MMA_KERNELS, ("HMMA",))]
    for table, opcodes in groups:
        for record, (source, part) in table.items():
            tensor_core_report(_build, tool, record, source, part, opcodes)


def tensor_core_report(_build, tool, record, source, part, opcodes):
    res = {n: r for n, r in _build.ptxas_resources(
        _build.build_log(source)).items() if part in n}
    check(res, "no ptxas report for %s in %s" % (part, source))
    if tool is None:             # the toolkit may lack cuobjdump
        log("sass %s: not counted (no cuobjdump in the toolkit)" % part)
        sass = None
    else:                        # a failing cuobjdump raises
        sass = {n: c for n, c in _build.sass_counts(
            source, opcodes).items() if part in n}
    build_log = _build.build_log(source).splitlines()
    for name, r in sorted(res.items()):
        spills = r.get("spill_stores", 0) + r.get("spill_loads", 0)
        counts = None if sass is None else sass.get(name)
        # ptxas C7514: it serialised the kernel's wgmma instructions
        r["serialized"] = any("C7514" in ln and name in ln
                              for ln in build_log)
        log("ptxas %s: %s registers, %s bytes stack, %d bytes spilled%s; "
            "sass %s" % (name, r.get("registers"), r.get("stack"),
                         spills, ", wgmma SERIALIZED (C7514)"
                         if r["serialized"] else "", counts))
        check(spills == 0, "%s spills %d bytes" % (name, spills))
        if sass is not None:
            check(counts and all(counts[op] > 0 for op in opcodes),
                  "%s: SASS counts %s (%s expected)"
                  % (name, counts, " and ".join(opcodes)))
    BUILD_REPORT[record] = {
        "ptxas": {n: res[n] for n in sorted(res)},
        "sass": sass}


def timing(torch, fn, iters: int = 20, windows: int = 5,
           warm: int = 3) -> dict:
    """Device ms per call as the median of ``windows`` windows of
    ``iters`` calls between CUDA events (after ``warm`` calls), with the
    windows' spread, and the host's µs per call over the same windows
    (the time the calls took to return). Where the host's time per call
    comes within 10% of the device's, the device waited on the host and
    the windows timed the host: ``host_bound`` says so."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    dev, host = [], []
    for _ in range(windows):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        t1 = time.perf_counter()
        end.record()
        torch.cuda.synchronize()
        dev.append(start.elapsed_time(end) / iters)
        host.append((t1 - t0) / iters * 1e6)
    dev.sort()
    host.sort()
    ms = dev[len(dev) // 2]
    host_us = host[len(host) // 2]
    return {"ms": ms, "lo": dev[0], "hi": dev[-1], "host_us": host_us,
            "host_bound": host_us / 1e3 >= 0.9 * ms}


def time_ms(torch, fn, iters: int = 20) -> float:
    return timing(torch, fn, iters)["ms"]


def kernel_ms(torch, fn, iters: int = 20, attempts: int = 3) -> float:
    """Device ms per call from a torch.profiler trace of ``iters``
    calls: each kernel's mean duration times its launches per call, so
    the card's time on the call whatever the host's gaps between
    launches.

    CUPTI's traces lose kernel records now and then: on the H100 a
    trace late in the run held 18 records of a one-kernel call's 20 (so
    summing the records read the call up to a tenth short), and one
    held none at all. Means per kernel do not depend on how many
    records came through; launches per call are the records over
    ``iters``, rounded (a kernel seen less than once per two calls adds
    its recorded time over ``iters``). A trace with no device time is
    taken again, up to ``attempts`` times; if every one is empty, the
    time is read between CUDA events around ``iters`` back-to-back calls
    instead (an upper bound: it holds the host's gaps too), and the log
    says so. The result is never 0."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    for _ in range(attempts):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        rows = [e for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA
                and e.count and e.self_device_time_total > 0]
        if not rows:
            log("kernel_ms: a trace of %d calls held no device time; taken "
                "again" % iters)
            continue
        us = 0.0
        for e in rows:
            per_call = round(e.count / iters)
            us += (e.self_device_time_total / e.count * per_call if per_call
                   else e.self_device_time_total / iters)
        n = sum(e.count for e in rows)
        if n % iters:
            log("kernel_ms: %d kernel records for %d calls; means per "
                "kernel used" % (n, iters))
        return us / 1e3
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / iters
    log("kernel_ms: %d profiler traces held no device time; CUDA events "
        "instead: %.4f ms per call" % (attempts, ms))
    check(ms > 0, "CUDA events timed %d calls at 0 ms" % iters)
    return ms


def spread(t: dict) -> str:
    return "%.4f ms (%.4f-%.4f over 5 windows; host %.1f us/call%s)" % (
        t["ms"], t["lo"], t["hi"], t["host_us"],
        ", HOST-BOUND" if t["host_bound"] else "")


def prompt_buckets():
    """The prefill bucket of each prompt of the burst: the server's
    ladder (powers of two from the page up to MAX_SEQ), first rung that
    holds the prompt."""
    from mxnet_tpu_torch.serve.bucketing import decode_buckets
    ladder = decode_buckets(MAX_SEQ, PAGE)
    return [next(b for b in ladder if n <= b) for n in PROMPT_LENS]


# the float32 sweep of K1 f32, K2 f32 and K3 f32: (S, Sk) pairs, ragged
# and crossed
F32_SWEEP_LENGTHS = ((1, 1), (65, 65), (200, 200), (1000, 1000),
                     (1024, 1024), (512, 1024), (1024, 512))
F32_SWEEP_HEADS = (1, HEADS)
F32_SWEEP_DIMS = (16, 32, 64, 128, 256)


def f32_sweep(torch):
    """K1 f32, K2 f32 and K3 f32 against their plain versions over every
    head dim (16-256), BH 1 and 16, S in {1, 65, 200, 1000, 1024}, S !=
    Sk both ways, causal and not: o, lse, dq, dk and dv each within
    KERNEL_ATOL max(1, max|ref|). Where dQ and dK are zero in exact
    arithmetic (S = 1 causal, Sk = 1) both sides are held to
    ZERO_GRAD_ATOL instead. Each case is fatal on failure. Returns the
    largest error of each kernel, {"fwd": .., "dq": .., "dkv": ..}."""
    from mxnet_tpu_torch.ops import flash_attention as fa
    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(SEED + 6)
    worst = {"fwd": 0.0, "dq": 0.0, "dkv": 0.0}
    n = 0
    t0 = time.perf_counter()
    for d in F32_SWEEP_DIMS:
        for bh in F32_SWEEP_HEADS:
            for s, sk in F32_SWEEP_LENGTHS:
                for causal in (True, False):
                    q, do = (torch.randn((bh, s, d), generator=gen,
                                         device=dev) for _ in range(2))
                    k, v = (torch.randn((bh, sk, d), generator=gen,
                                        device=dev) for _ in range(2))
                    scale = d ** -0.5
                    o, lse = fa.flash_attention_fwd(q, k, v, scale, causal)
                    delta = (do * o).sum(-1)
                    dq = fa.flash_attention_bwd_dq(q, k, v, do, lse, delta,
                                                   scale, causal)
                    dk, dv = fa.flash_attention_bwd_dkv(
                        q, k, v, do, lse, delta, scale, causal)
                    o_r, lse_r = fa.flash_attention_reference(
                        q, k, v, scale, causal)
                    dq_r, dk_r, dv_r = fa.flash_attention_backward_reference(
                        q, k, v, o, lse, do, scale, causal)
                    torch.cuda.synchronize()
                    zero = sk == 1 or (causal and s == 1)
                    errs = {}
                    for nm, got, want in (("o", o, o_r), ("lse", lse, lse_r),
                                          ("dq", dq, dq_r), ("dk", dk, dk_r),
                                          ("dv", dv, dv_r)):
                        if zero and nm in ("dq", "dk"):
                            # both sides hold only rounding: each near 0
                            errs[nm] = (max(got.abs().max().item(),
                                            want.abs().max().item()),
                                        ZERO_GRAD_ATOL)
                        else:
                            errs[nm] = ((got - want).abs().max().item(),
                                        KERNEL_ATOL * max(
                                            1.0, want.abs().max().item()))
                    case = "d=%d bh=%d s=%d sk=%d causal=%s" % (
                        d, bh, s, sk, causal)
                    log("  f32 sweep %s: %s%s" % (case, "; ".join(
                        "%s %.3g (limit %.3g)" % (nm, e, lim)
                        for nm, (e, lim) in errs.items()),
                        "; dq and dk zero in exact arithmetic" if zero
                        else ""))
                    bad = [nm for nm, (e, lim) in errs.items() if e > lim]
                    check(not bad, "f32 sweep %s: %s disagree with the plain "
                          "versions: %s" % (case, bad, errs))
                    for what, names in (("fwd", ("o", "lse")), ("dq", ("dq",)),
                                        ("dkv", ("dk", "dv"))):
                        worst[what] = max([worst[what]] + [
                            errs[nm][0] for nm in names
                            if not (zero and nm in ("dq", "dk"))])
                    n += 1
                    del q, k, v, do, o, lse, delta, dq, dk, dv, o_r, lse_r
                    del dq_r, dk_r, dv_r
    log("f32 sweep: %d cases of K1 f32, K2 f32 and K3 f32 within %g max(1, "
        "max|ref|) in %.1f s" % (n, KERNEL_ATOL, time.perf_counter() - t0))
    return worst


def kernel_phase(torch):
    """K1 f32 against its plain version at the prefill shapes (16 heads,
    d 128, every prompt bucket the slice phase uses plus a length that
    is no tile multiple), then over the f32 sweep; then timed at every
    bucket of the burst beside scaled_dot_product_attention, each side
    as window medians (timing) and kernel time (kernel_ms)."""
    import torch.nn.functional as F
    from mxnet_tpu_torch.ops.flash_attention import (
        flash_attention_fwd, flash_attention_reference)
    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    bh, d = HEADS, D_MODEL // HEADS
    scale = d ** -0.5
    worst = 0.0
    for s, causal in ((16, True), (128, True), (200, True), (512, True),
                      (1024, True), (512, False)):
        q, k, v = (torch.randn((bh, s, d), generator=gen, device=dev)
                   for _ in range(3))
        o, lse = flash_attention_fwd(q, k, v, scale, causal)
        o_r, lse_r = flash_attention_reference(q, k, v, scale, causal)
        torch.cuda.synchronize()
        err = max((o - o_r).abs().max().item(),
                  (lse - lse_r).abs().max().item())
        log("flash_attention_fwd bh=%d s=%d d=%d causal=%s max_abs_err=%.3g"
            % (bh, s, d, causal, err))
        check(err <= KERNEL_ATOL, "flash_attention_fwd disagrees with its "
              "plain version at s=%d: %g" % (s, err))
        worst = max(worst, err)
    swept = f32_sweep(torch)
    worst = max(worst, swept["fwd"])

    # every bucket of the burst, K1 f32 and SDPA f32 alike
    buckets = prompt_buckets()
    timed = {}
    for s in sorted(set(buckets)):
        q, k, v = (torch.randn((bh, s, d), generator=gen, device=dev)
                   for _ in range(3))
        calls = {"kernel": lambda: flash_attention_fwd(q, k, v, scale, True),
                 "library": lambda: F.scaled_dot_product_attention(
                     q[None], k[None], v[None], is_causal=True,
                     scale=scale)}
        timed[s] = {w: dict(timing(torch, fn), device_ms=kernel_ms(torch, fn))
                    for w, fn in calls.items()}
        bound_ms, bound_by, fma_ms, flops, _ = f32_attention_bounds(
            "fwd", bh, s, s, d, True)
        timed[s]["bound_ms"], timed[s]["bound_by"] = bound_ms, bound_by
        timed[s]["fma_bound_ms"] = fma_ms
        kt, lt = timed[s]["kernel"], timed[s]["library"]
        log("flash_attention_fwd f32 bh=%d s=%d d=%d causal (3xTF32 "
            "mma.sync): kernel %s, kernel time %.4f ms = %.1f TFLOP/s; "
            "library (sdpa f32) %s, kernel time %.4f ms; bound_ms=%.4f (%s, "
            "3 x flops at 495 TFLOP/s TF32 against bytes at 3.35 TB/s); "
            "f32 FMA bound %.4f ms" % (
                bh, s, d, spread(kt), kt["device_ms"],
                flops / kt["device_ms"] / 1e9, spread(lt), lt["device_ms"],
                bound_ms, bound_by, timed[s]["fma_bound_ms"]))
        del q, k, v
    # the burst's K1 f32 time by these readings: each prompt's bucket,
    # once per layer
    weighted = {w: LAYERS * sum(timed[b][w]["device_ms"] for b in buckets)
                for w in ("kernel", "library")}
    log("flash_attention_fwd f32 over the burst's buckets %s x %d layers: "
        "kernel time %.4f ms (sdpa f32 %.4f ms)"
        % (buckets, LAYERS, weighted["kernel"], weighted["library"]))

    s = MAX_SEQ
    q, k, v = (torch.randn((bh, s, d), generator=gen, device=dev)
               for _ in range(3))
    plain_ms = time_ms(
        torch, lambda: flash_attention_reference(q, k, v, scale, True))
    kt, lt = timed[s]["kernel"], timed[s]["library"]
    bound_ms, bound_by, _, flops, _ = f32_attention_bounds("fwd", bh, s, s, d,
                                                           True)
    log("flash_attention_fwd bh=%d s=%d d=%d causal: kernel_ms=%.4f "
        "reference_ms=%.4f library_ms=%.4f (sdpa) bound_ms=%.4f (%s at "
        "3xTF32; f32 FMA bound %.4f ms), %.1f%% of the bound"
        % (bh, s, d, kt["ms"], plain_ms, lt["ms"], bound_ms, bound_by,
           timed[s]["fma_bound_ms"], 100 * bound_ms / kt["device_ms"]))
    del q, k, v
    return {"flash_attention_fwd": {
        "name": "flash_attention_fwd", "route": "cuda",
        "source": "mxnet_tpu_torch/csrc/flash_attention_fwd.cu",
        "replaces": "mxnet_tpu/ops/pallas/flash_attention.py:45",
        "tpu_kernel": "ops/pallas/flash_attention.py:_fa_kernel",
        "design": "3xTF32 on mma.sync",
        "max_abs_err": worst, "ms": kt["ms"],
        "ms_spread": [kt["lo"], kt["hi"]], "device_ms": kt["device_ms"],
        "host_us": kt["host_us"], "host_bound": kt["host_bound"],
        "tflops": flops / kt["device_ms"] / 1e9,
        "bound_share": bound_ms / kt["device_ms"],
        "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
        "bound_peak": "3 x flops at 495 TFLOP/s TF32; bytes at 3.35 TB/s",
        "fma_bound_ms": timed[s]["fma_bound_ms"],
        "library_ms": lt["ms"], "library_spread": [lt["lo"], lt["hi"]],
        "library_device_ms": lt["device_ms"],
        "library_host_us": lt["host_us"],
        "library_host_bound": lt["host_bound"],
        "buckets": {str(b): {"device_ms": timed[b]["kernel"]["device_ms"],
                             "ms": timed[b]["kernel"]["ms"],
                             "library_device_ms":
                                 timed[b]["library"]["device_ms"],
                             "bound_ms": timed[b]["bound_ms"]}
                    for b in sorted(timed)},
        "burst_buckets": buckets,
        "burst_weighted_device_ms": weighted["kernel"],
        "burst_weighted_library_device_ms": weighted["library"]},
        # the sweep's K2 f32 and K3 f32 errors, completed by
        # train_kernel_phase
        "flash_attention_bwd_dq_f32": {"max_abs_err": swept["dq"]},
        "flash_attention_bwd_dkv_f32": {"max_abs_err": swept["dkv"]}}


def seeded_params(np, seed: int):
    from mxnet_tpu_torch.models.transformer import param_shapes
    rng = np.random.default_rng(seed)
    params = {}
    for name, shape in param_shapes(VOCAB, LAYERS, D_MODEL, HEADS, D_FF,
                                    MAX_SEQ).items():
        if name.endswith("_gamma"):
            params[name] = np.ones(shape, np.float32)
        elif name.endswith(("_beta", "_bias")):
            params[name] = np.zeros(shape, np.float32)
        else:
            params[name] = rng.standard_normal(shape, np.float32) * 0.02
    return params


def plain_logits(torch, params, tokens):
    """Last-position logits of the zoo transformer's training graph
    (dense attention with its -1e9 causal bias), written from the
    Symbol and independent of the served path."""
    import torch.nn.functional as F
    p = params
    t = len(tokens)
    d = D_MODEL // HEADS
    x = p["tok_embed_weight"][torch.tensor(tokens, device=DEVICE)] \
        + p["pos_embed_weight"][:t]
    bias = torch.triu(torch.full((t, t), -1e9, device=DEVICE), 1)
    for i in range(LAYERS):
        pf = "layer%d_" % i
        h = F.layer_norm(x, (D_MODEL,), p[pf + "ln1_gamma"],
                         p[pf + "ln1_beta"], 1e-5)
        qkv = F.linear(h, p[pf + "att_qkv_weight"], p[pf + "att_qkv_bias"])
        q, k, v = qkv.view(t, 3, HEADS, d).permute(1, 2, 0, 3)
        att = torch.softmax(q @ k.transpose(-1, -2) * d ** -0.5 + bias, -1)
        ctx = (att @ v).transpose(0, 1).reshape(t, D_MODEL)
        x = x + F.linear(ctx, p[pf + "att_proj_weight"],
                         p[pf + "att_proj_bias"])
        h = F.layer_norm(x, (D_MODEL,), p[pf + "ln2_gamma"],
                         p[pf + "ln2_beta"], 1e-5)
        h = torch.relu(F.linear(h, p[pf + "ff1_weight"], p[pf + "ff1_bias"]))
        x = x + F.linear(h, p[pf + "ff2_weight"], p[pf + "ff2_bias"])
    x = F.layer_norm(x[-1:], (D_MODEL,), p["final_ln_gamma"],
                     p["final_ln_beta"], 1e-5)
    return F.linear(x, p["lm_head_weight"], p["lm_head_bias"])[0]


def burst(srv, prompts):
    """Submit every prompt at once (greedy) and wait for all of them;
    the latency histograms are reset first, so stats() describe this
    burst alone."""
    srv.latency.reset()
    t0 = time.perf_counter()
    handles = [srv.submit_generate(pr, max_new_tokens=NEW_TOKENS)
               for pr in prompts]
    outs = [h.result(timeout=600) for h in handles]
    return outs, time.perf_counter() - t0


def report(what, srv, outs, wall):
    st = srv.stats()
    tokens = sum(len(t) for t in outs)
    log("slice %s: %d requests, %d tokens in %.3f s = %.1f tok/s; ttft p50 "
        "%.3f ms p95 %.3f ms; tpot p50 %.3f ms p95 %.3f ms"
        % (what, len(outs), tokens, wall, tokens / wall, st["ttft"]["p50_ms"],
           st["ttft"]["p95_ms"], st["tpot"]["p50_ms"], st["tpot"]["p95_ms"]))


def device_breakdown(torch, prof, wall, what="slice"):
    """Kernel time by name from a torch.profiler trace, and the device's
    busy share of the window's wall time; returns the CUDA rows and the
    busy time in ms. A scheduled trace's ProfilerStep span lies on the
    device's timeline too, over the kernels it holds: it is left out."""
    rows = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and not e.key.startswith("ProfilerStep")]
    busy_us = sum(e.self_device_time_total for e in rows)
    log("%s profiled: device busy %.3f ms of %.3f ms wall (%.1f%%), "
        "idle share %.3f" % (what, busy_us / 1e3, wall * 1e3,
                             100 * busy_us / 1e3 / (wall * 1e3),
                             1 - busy_us / 1e3 / (wall * 1e3)))
    for e in sorted(rows, key=lambda e: -e.self_device_time_total)[:8]:
        log("  %8.3f ms %5d x %s" % (e.self_device_time_total / 1e3,
                                     e.count, e.key[:90]))
    return rows, busy_us / 1e3


def slice_phase(torch, np, kernels):
    from torch.profiler import ProfilerActivity, profile
    from mxnet_tpu_torch.ops.flash_attention import flash_attention_fwd
    from mxnet_tpu_torch.serve import GenerativeServer
    t0 = time.perf_counter()
    params = seeded_params(np, SEED)
    log("weights: %d params drawn in %.1f s"
        % (sum(a.size for a in params.values()), time.perf_counter() - t0))
    torch.cuda.reset_peak_memory_stats()
    srv = GenerativeServer(params, n_heads=HEADS, max_sequences=SLOTS,
                           page=PAGE, name="smoke", device=DEVICE)
    del params
    rng = np.random.default_rng(SEED + 1)
    prompts = [rng.integers(0, VOCAB, n) for n in PROMPT_LENS]
    try:
        # the main path, once, from a cold server: the counted run
        flash_attention_fwd.launches = {"f32": 0, "bf16": 0}
        outs, wall = burst(srv, prompts)
        counts = dict(flash_attention_fwd.launches)
        launches = {"flash_attention_fwd": counts["f32"]}
        torch.cuda.synchronize()
        st = srv.stats()
        report("cold", srv, outs, wall)
        # the same burst again, every runner and library handle warm,
        # then once more under the profiler for the device breakdown
        warm, wall = burst(srv, prompts)
        report("warm", srv, warm, wall)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            _, wall = burst(srv, prompts)
            torch.cuda.synchronize()
        rows, _ = device_breakdown(torch, prof, wall)
        served = [srv.engine.prompt_bucket(len(pr)) for pr in prompts]
    finally:
        srv.close()
    # K1 f32 in the profiled burst against phase 3's bucket times
    k1 = [e for e in rows if "fa_fwd_f32" in e.key]
    k1_ms = sum(e.self_device_time_total for e in k1) / 1e3
    entry = kernels["flash_attention_fwd"]
    check(served == entry["burst_buckets"], "the server's prompt buckets %s "
          "are not the timed ones %s" % (served, entry["burst_buckets"]))
    entry["burst_device_ms"] = k1_ms
    log("slice: K1 f32 in the profiled burst: %.4f ms of kernel time in %d "
        "launches; phase 3's bucket times x the burst's launches: %.4f ms "
        "(sdpa f32 there: %.4f ms)" % (
            k1_ms, sum(e.count for e in k1),
            entry["burst_weighted_device_ms"],
            entry["burst_weighted_library_device_ms"]))
    for pr, toks in zip(prompts, outs):
        check(len(toks) == NEW_TOKENS and all(0 <= t < VOCAB for t in toks),
              "prompt of %d tokens gave %r" % (len(pr), toks))
    prefills = len(prompts)
    check(counts["bf16"] == 0, "the f32 serving path launched the bf16 "
          "forward kernel %d times" % counts["bf16"])
    check(launches["flash_attention_fwd"] == prefills * LAYERS,
          "flash kernel launched %d times for %d prefills x %d layers"
          % (launches["flash_attention_fwd"], prefills, LAYERS))
    check(st["decode_steps"] > 0, "no decode step ran")
    check(st["compiles"] + st["cache_hits"] == prefills + st["decode_steps"],
          "runner dispatches %d != prefills %d + decode steps %d"
          % (st["compiles"] + st["cache_hits"], prefills,
             st["decode_steps"]))
    check(st["compiles"] <= st["executable_bound"], "runner set unbounded")
    for name, n in launches.items():
        check(n > 0, "kernel %s never ran on the main path" % name)
        kernels[name]["launches"] = n
    log("slice: decode steps %d; runners %d (bound %d); peak memory %.3f GB;"
        " kv cache %.3f GB; warm burst repeats the cold tokens for %d of %d "
        "prompts" % (st["decode_steps"], st["compiles"],
                     st["executable_bound"],
                     torch.cuda.max_memory_allocated() / 1e9,
                     st["kv"]["hbm_bytes"] / 1e9,
                     sum(a == b for a, b in zip(outs, warm)), len(outs)))

    # the served logits against an independent plain forward, for a
    # short and a long prompt: prefill, then one decode step
    eng, cache = srv.engine, srv.cache
    worst = 0.0
    for pr in (prompts[0], prompts[-1]):
        pr = [int(t) for t in pr]
        slot = cache.acquire(len(pr))
        got = torch.from_numpy(eng.prefill(np.array(pr), slot)).to(DEVICE)
        want = plain_logits(torch, eng.params, pr)
        err_p = (got - want).abs().max().item()
        tok = int(want.argmax())
        tokens_ = np.zeros(SLOTS, np.int64)
        pos = np.zeros(SLOTS, np.int64)
        active = np.zeros(SLOTS, bool)
        tokens_[slot], pos[slot], active[slot] = tok, len(pr), True
        got = torch.from_numpy(
            eng.decode_step(tokens_, pos, active)[slot]).to(DEVICE)
        want = plain_logits(torch, eng.params, pr + [tok])
        err_d = (got - want).abs().max().item()
        cache.release(slot)
        log("slice: prompt %d tokens: prefill logits max_abs_err %.3g, "
            "decode logits max_abs_err %.3g" % (len(pr), err_p, err_d))
        worst = max(worst, err_p, err_d)
    torch.cuda.synchronize()
    check(worst <= LOGITS_ATOL,
          "served logits disagree with the plain forward: %g" % worst)
    # free the server's weights and cache before the training phase
    del eng, cache, srv
    gc.collect()
    torch.cuda.empty_cache()


def live_pairs(s: int, sk: int, causal: bool) -> int:
    """(q, k) pairs a causal (top-aligned) or full attention computes."""
    if not causal:
        return s * sk
    return sum(min(i + 1, sk) for i in range(s))


def attention_bound(what, bh, s, sk, d, causal, itemsize):
    """Least time for one flash-attention kernel over these shapes: the
    larger of its operations at the bf16 tensor-core peak (f32 inputs:
    the f32 FMA peak) and its bytes (each input read once, each output
    written once) at the memory rate. Returns (ms, bound_by, flops,
    bytes)."""
    pairs = bh * live_pairs(s, sk, causal)
    q_rows, k_rows = bh * s * d, bh * sk * d
    if what == "fwd":        # S = QK^T, O = PV; reads q k v, writes o lse
        flops = 4.0 * d * pairs
        nbytes = itemsize * (2 * q_rows + 2 * k_rows) + 4.0 * bh * s
    elif what == "dq":       # S, dP, dQ; reads q k v do lse delta, writes dq
        flops = 6.0 * d * pairs
        nbytes = itemsize * (3 * q_rows + 2 * k_rows) + 8.0 * bh * s
    else:                    # S, dP, dV, dK; writes dk dv
        flops = 8.0 * d * pairs
        nbytes = itemsize * (2 * q_rows + 4 * k_rows) + 8.0 * bh * s
    peak = PEAK_BF16_FLOPS if itemsize == 2 else PEAK_FP32_FLOPS
    t_ops, t_bytes = flops / peak, nbytes / PEAK_BYTES_PER_S
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes", flops, nbytes)


def f32_attention_bounds(what, bh, s, sk, d, causal):
    """The f32 kernel's bounds: on its 3xTF32 route (three tf32 products
    per product, so 3 x flops at 495 TFLOP/s) and on float32 FMAs (flops
    at 67 TFLOP/s), each against the bytes at 3.35 TB/s. Returns
    (ms, bound_by, fma_ms, flops, bytes)."""
    fma_ms, _, flops, nbytes = attention_bound(what, bh, s, sk, d, causal, 4)
    t_ops, t_bytes = 3 * flops / PEAK_TF32_FLOPS, nbytes / PEAK_BYTES_PER_S
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes", fma_ms, flops,
            nbytes)


def f32_backward_timing(torch):
    """K2 f32 and K3 f32 at the training step's attention shape (batch 8
    x 16 heads, S 1024, D 128, causal, float32), each as window medians
    (timing) and kernel time (kernel_ms), beside SDPA f32's backward (dQ,
    dK and dV together, timed alike), the plain backward and both
    bounds. Returns {"dq": ..., "dkv": ..., "library": ...,
    "plain_ms": ...}."""
    import torch.nn.functional as F
    from mxnet_tpu_torch.ops import flash_attention as fa
    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(SEED + 7)
    bh, s, d = TRAIN_BATCH * HEADS, MAX_SEQ, D_MODEL // HEADS
    scale = d ** -0.5
    q, k, v, do = (torch.randn((bh, s, d), generator=gen, device=dev)
                   for _ in range(4))
    o, lse = fa.flash_attention_fwd(q, k, v, scale, True)
    delta = (do * o).sum(-1)
    calls = {
        "dq": lambda: fa.flash_attention_bwd_dq(q, k, v, do, lse, delta,
                                                scale, True),
        "dkv": lambda: fa.flash_attention_bwd_dkv(q, k, v, do, lse, delta,
                                                  scale, True)}
    t = {w: dict(timing(torch, fn), device_ms=kernel_ms(torch, fn))
         for w, fn in calls.items()}
    shape4 = (TRAIN_BATCH, HEADS, s, d)
    q4, k4, v4 = (x.view(shape4).detach().requires_grad_(True)
                  for x in (q, k, v))
    out4 = F.scaled_dot_product_attention(q4, k4, v4, is_causal=True,
                                          scale=scale)
    do4 = do.view(shape4)

    def library():
        return torch.autograd.grad(out4, (q4, k4, v4), do4,
                                   retain_graph=True)
    t["library"] = dict(timing(torch, library),
                        device_ms=kernel_ms(torch, library))
    t["plain_ms"] = time_ms(torch, lambda: fa.flash_attention_backward_reference(
        q, k, v, o, lse, do, scale, True), iters=5)
    lt = t["library"]
    for what in ("dq", "dkv"):
        bound_ms, bound_by, fma_ms, flops, nbytes = f32_attention_bounds(
            what, bh, s, s, d, True)
        t[what].update(bound_ms=bound_ms, bound_by=bound_by, fma_ms=fma_ms,
                       flops=flops, bytes=nbytes)
        kt = t[what]
        log("%s f32 bh=%d s=%d d=%d causal: kernel %s, kernel time %.4f ms "
            "= %.1f TFLOP/s, %.1f%% of the bound; plain_ms=%.4f (plain "
            "backward, dQ dK dV); library (sdpa f32 backward, dQ dK dV) %s, "
            "kernel time %.4f ms; bound_ms=%.4f (%s: 3 x %.1f GFLOP at 495 "
            "TFLOP/s TF32 = %.4f ms, %.1f MB at 3.35 TB/s = %.4f ms); f32 FMA "
            "bound %.4f ms" % (
                "flash_attention_bwd_" + what, bh, s, d, spread(kt),
                kt["device_ms"], flops / kt["device_ms"] / 1e9,
                100 * bound_ms / kt["device_ms"], t["plain_ms"], spread(lt),
                lt["device_ms"], bound_ms, bound_by, flops / 1e9,
                3 * flops / PEAK_TF32_FLOPS * 1e3, nbytes / 1e6,
                nbytes / PEAK_BYTES_PER_S * 1e3, fma_ms))
    del q, k, v, do, o, lse, delta, q4, k4, v4, out4, do4
    gc.collect()
    torch.cuda.empty_cache()
    return t


def bf16_compare(got, want):
    """A bf16 kernel output against its plain version by the three
    limits above: returns the readings and whether all three hold."""
    want = want.float()
    diff = (got.float() - want).abs()
    err = diff.max().item()
    top = want.abs().max().item()
    rms = want.pow(2).mean().sqrt().item()
    # the share of rms(ref) by which an element's error passes 2^-6 |ref|,
    # and the error's norm against the output's
    excess = (diff - BF16_ELEM_RTOL * want.abs()).flatten()
    at = int(excess.argmax())
    r = {"err": err, "top": top, "rms": rms,
         "over": excess[at].item() / max(rms, 1e-30),
         "rel": diff.norm().item() / max(want.norm().item(), 1e-30),
         "at_ref": want.flatten()[at].abs().item(),
         "at_err": diff.flatten()[at].item()}
    r["ok"] = (err <= BF16_MAX_RTOL * top and r["rel"] <= BF16_NORM_RTOL
               and r["over"] <= BF16_ELEM_RMS)
    return r


# the edge sweep of the bf16 forward, dQ and dK/dV kernels: (S, Sk)
# pairs, ragged and crossed; D 16, 32 and 256 take the mma.sync kernels,
# D 64 and 128 the wgmma ones
SWEEP_LENGTHS = ((1, 1), (65, 65), (1000, 1000), (1024, 1024), (512, 1024),
                 (1024, 512))
SWEEP_HEADS = (1, TRAIN_BATCH * HEADS)
SWEEP_DIMS = (16, 32, 64, 128, 256)
# dK and dQ are zero in exact arithmetic where every live q row sees a
# single key (S = 1 causal, or Sk = 1): softmax has no gradient with
# respect to its only key, so that key's dP - delta vanishes. Both sides
# then hold only the rounding of dP - delta, two f32 sums of the same
# products (readings on the H100: 0 to 1.3e-6, either side), so the
# relative limits have no scale there: both are held to zero within this
# bound instead
ZERO_GRAD_ATOL = 1e-5


def edge_sweep(torch):
    """K1 bf16, K2 and K3 against their plain versions under the bf16
    limits (and lse within 1e-4 max(1, max|ref|)) over S in {1, 65,
    1000, 1024}, S != Sk both ways (top-aligned), causal and not, D 16,
    32 and 256 (the mma.sync kernels), 64 and 128 (the wgmma kernels),
    BH 1 and 128: the ragged and crossed edges that TMA's zero fill
    meets. Each case is fatal on failure."""
    from mxnet_tpu_torch.ops import flash_attention as fa
    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(SEED + 5)
    worst = {"fwd": 0.0, "dq": 0.0, "dkv": 0.0}
    n = 0
    t0 = time.perf_counter()
    for d in SWEEP_DIMS:
        for bh in SWEEP_HEADS:
            for s, sk in SWEEP_LENGTHS:
                for causal in (True, False):
                    q, do = (torch.randn((bh, s, d), generator=gen,
                                         device=dev).bfloat16()
                             for _ in range(2))
                    k, v = (torch.randn((bh, sk, d), generator=gen,
                                        device=dev).bfloat16()
                            for _ in range(2))
                    scale = d ** -0.5
                    o, lse = fa.flash_attention_fwd(q, k, v, scale, causal)
                    delta = (do.float() * o.float()).sum(-1)
                    dq = fa.flash_attention_bwd_dq(
                        q, k, v, do, lse, delta, scale, causal)
                    dk, dv = fa.flash_attention_bwd_dkv(
                        q, k, v, do, lse, delta, scale, causal)
                    o_r, lse_r = fa.flash_attention_reference(q, k, v, scale,
                                                              causal)
                    dq_r, dk_r, dv_r = fa.flash_attention_backward_reference(
                        q, k, v, o, lse, do, scale, causal)
                    torch.cuda.synchronize()
                    res = {name: bf16_compare(got, want) for name, got, want
                           in (("o", o, o_r), ("dq", dq, dq_r),
                               ("dk", dk, dk_r), ("dv", dv, dv_r))}
                    case = "d=%d bh=%d s=%d sk=%d causal=%s" % (
                        d, bh, s, sk, causal)
                    if sk == 1 or (causal and s == 1):
                        tops = {nm: (got.float().abs().max().item(),
                                     res.pop(nm)["top"])
                                for nm, got in (("dq", dq), ("dk", dk))}
                        log("  sweep %s: dq and dk are zero in exact "
                            "arithmetic: %s (limit %g)" % (case, "; ".join(
                                "%s kernel max %.3g, plain max %.3g"
                                % (nm, a, b) for nm, (a, b) in tops.items()),
                                ZERO_GRAD_ATOL))
                        check(max(max(ab) for ab in tops.values())
                              <= ZERO_GRAD_ATOL,
                              "edge sweep %s: dq or dk not zero" % case)
                    lse_err = (lse - lse_r).abs().max().item()
                    lse_lim = KERNEL_ATOL * max(1.0, lse_r.abs().max().item())
                    log("  sweep %s: %s; lse %.3g (limit %.3g)" % (
                        case, "; ".join(
                            "%s max %.3g/%.3g norm %.2e elem %.3f" % (
                                nm, r["err"], r["top"], r["rel"], r["over"])
                            for nm, r in res.items()), lse_err, lse_lim))
                    bad = [nm for nm, r in res.items() if not r["ok"]]
                    check(not bad and lse_err <= lse_lim,
                          "edge sweep %s: %s disagree with the plain versions"
                          " (lse err %g)" % (case, bad or "none", lse_err))
                    worst["fwd"] = max(worst["fwd"], res["o"]["err"], lse_err)
                    if "dq" in res:
                        worst["dq"] = max(worst["dq"], res["dq"]["err"])
                    worst["dkv"] = max(worst["dkv"], res["dv"]["err"],
                                       res.get("dk", res["dv"])["err"])
                    n += 1
                    del q, k, v, do, o, lse, delta, dq, dk, dv, o_r, lse_r
                    del dq_r, dk_r, dv_r
    log("edge sweep: %d cases of K1 bf16, K2 and K3 within the bf16 limits "
        "in %.1f s" % (n, time.perf_counter() - t0))
    gc.collect()
    torch.cuda.empty_cache()
    return worst


# the head-dim sweep: dims that flash_attention pads (48 -> 64, 80 and 96
# -> 128) and D 256, through the public function and autograd
HEAD_DIM_SWEEP_DIMS = (48, 80, 96, 256)
HEAD_DIM_SWEEP_HEADS = (1, HEADS)
HEAD_DIM_SWEEP_LENGTHS = (65, 1024)


def head_dim_sweep(torch):
    """flash_attention and its autograd backward at head dims 48, 80 and
    96 (zero-padded to 64 and 128 by the wrapper) and 256, BH 1 and 16, S
    65 and 1024, causal and not, float32 and bfloat16, against the plain
    versions at the real D: f32 within KERNEL_ATOL max(1, max|ref|),
    bf16 under the three bf16 limits. A head dim above 256 must raise
    ValueError naming ROADMAP B7. Each case is fatal on failure. Returns
    the largest errors, {"f32": {...}, "bf16": {...}} by kernel."""
    from mxnet_tpu_torch.ops import flash_attention as fa
    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(SEED + 8)
    worst = {dt: {"fwd": 0.0, "dq": 0.0, "dkv": 0.0}
             for dt in ("f32", "bf16")}
    n = 0
    t0 = time.perf_counter()
    for d in HEAD_DIM_SWEEP_DIMS:
        for bh in HEAD_DIM_SWEEP_HEADS:
            for s in HEAD_DIM_SWEEP_LENGTHS:
                for causal in (True, False):
                    for dtype in (torch.float32, torch.bfloat16):
                        q, k, v, do = (torch.randn(
                            (1, bh, s, d), generator=gen, device=dev).to(dtype)
                            for _ in range(4))
                        leaves = [t.clone().requires_grad_(True)
                                  for t in (q, k, v)]
                        o = fa.flash_attention(*leaves, causal=causal)
                        dq, dk, dv = torch.autograd.grad(o, leaves, do)
                        scale = d ** -0.5
                        q3, k3, v3, do3 = (t[0] for t in (q, k, v, do))
                        o_r, lse_r = fa.flash_attention_reference(
                            q3, k3, v3, scale, causal)
                        refs = fa.flash_attention_backward_reference(
                            q3, k3, v3, o[0].detach(), lse_r, do3, scale,
                            causal)
                        torch.cuda.synchronize()
                        case = "d=%d bh=%d s=%d causal=%s %s" % (
                            d, bh, s, causal, str(dtype).split(".")[-1])
                        outs = (("o", o[0].detach(), o_r), ("dq", dq[0], refs[0]),
                                ("dk", dk[0], refs[1]), ("dv", dv[0], refs[2]))
                        if dtype == torch.float32:
                            errs = {nm: ((got - want).abs().max().item(),
                                         KERNEL_ATOL * max(
                                             1.0, want.abs().max().item()))
                                    for nm, got, want in outs}
                            log("  head-dim sweep %s: %s" % (case, "; ".join(
                                "%s %.3g (limit %.3g)" % (nm, e, lim)
                                for nm, (e, lim) in errs.items())))
                            bad = [nm for nm, (e, lim) in errs.items()
                                   if e > lim]
                            err = {nm: e for nm, (e, _) in errs.items()}
                        else:
                            res = {nm: bf16_compare(got, want)
                                   for nm, got, want in outs}
                            log("  head-dim sweep %s: %s" % (case, "; ".join(
                                "%s max %.3g/%.3g norm %.2e elem %.3f" % (
                                    nm, r["err"], r["top"], r["rel"],
                                    r["over"]) for nm, r in res.items())))
                            bad = [nm for nm, r in res.items() if not r["ok"]]
                            err = {nm: r["err"] for nm, r in res.items()}
                        check(not bad, "head-dim sweep %s: %s disagree with "
                              "the plain versions at the real head dim"
                              % (case, bad))
                        w = worst["f32" if dtype == torch.float32 else "bf16"]
                        w["fwd"] = max(w["fwd"], err["o"])
                        w["dq"] = max(w["dq"], err["dq"])
                        w["dkv"] = max(w["dkv"], err["dk"], err["dv"])
                        n += 1
                        del q, k, v, do, leaves, o, dq, dk, dv, o_r, lse_r
                        del refs, q3, k3, v3, do3
    big = torch.zeros((1, 1, 8, 320), device=dev)
    try:
        fa.flash_attention(big, big, big)
    except ValueError as exc:
        check("B7" in str(exc), "D 320 raised without naming ROADMAP B7: "
              "%s" % exc)
        log("head-dim sweep: D 320 raises ValueError: %s" % exc)
    else:
        raise SmokeFailure("flash_attention took head dim 320")
    log("head-dim sweep: %d cases through flash_attention and autograd at D "
        "%s in %.1f s" % (n, HEAD_DIM_SWEEP_DIMS, time.perf_counter() - t0))
    gc.collect()
    torch.cuda.empty_cache()
    return worst


def d256_timing(torch):
    """The six D 256 instances (forward, dQ, dK/dV in float32 on 3xTF32
    and in bfloat16 on mma.sync) timed at BH 16, S 1024, causal, as
    window medians and kernel time, beside their bounds. Returns
    {"f32": {what: ms}, "bf16": {what: ms}} of kernel times."""
    from mxnet_tpu_torch.ops import flash_attention as fa
    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(SEED + 9)
    bh, s, d = HEADS, MAX_SEQ, 256
    scale = d ** -0.5
    out = {}
    for dtype, tag in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
        q, k, v, do = (torch.randn((bh, s, d), generator=gen,
                                   device=dev).to(dtype) for _ in range(4))
        o, lse = fa.flash_attention_fwd(q, k, v, scale, True)
        delta = (do.float() * o.float()).sum(-1)
        calls = {
            "fwd": lambda: fa.flash_attention_fwd(q, k, v, scale, True),
            "dq": lambda: fa.flash_attention_bwd_dq(q, k, v, do, lse, delta,
                                                    scale, True),
            "dkv": lambda: fa.flash_attention_bwd_dkv(q, k, v, do, lse,
                                                      delta, scale, True)}
        out[tag] = {}
        for what, fn in calls.items():
            t = timing(torch, fn)
            dev_ms = kernel_ms(torch, fn)
            if tag == "f32":
                bound_ms, bound_by, _, flops, _ = f32_attention_bounds(
                    what, bh, s, s, d, True)
            else:
                bound_ms, bound_by, flops, _ = attention_bound(
                    what, bh, s, s, d, True, 2)
            log("d256 %s %s bh=%d s=%d causal (%s): %s, kernel time %.4f ms "
                "= %.1f TFLOP/s; bound_ms=%.4f (%s)" % (
                    what, tag, bh, s, "3xTF32 mma.sync" if tag == "f32"
                    else "mma.sync", spread(t), dev_ms,
                    flops / dev_ms / 1e9, bound_ms, bound_by))
            out[tag][what] = dev_ms
        del q, k, v, do, o, lse, delta
    gc.collect()
    torch.cuda.empty_cache()
    return out


def train_kernel_phase(torch, kernels):
    """K1 (bf16 input), K2 and K3 against their plain versions at the
    training step's attention shape (batch 8 x 16 heads, S 1024, D 128,
    causal) in bf16 and f32, a ragged length and a non-causal case; the
    edge sweep of the bf16 kernels (K1 bf16, K2, K3); the head-dim sweep
    through flash_attention; then each kernel timed at that shape beside
    its plain version, scaled_dot_product_attention and its bound (the
    bf16 kernels, then K2 f32 and K3 f32), and the D 256 instances."""
    import torch.nn.functional as F
    from mxnet_tpu_torch.ops import flash_attention as fa
    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(SEED + 2)
    bh, d = TRAIN_BATCH * HEADS, D_MODEL // HEADS
    scale = d ** -0.5
    worst = {"fwd": 0.0, "dq": 0.0, "dkv": 0.0}
    f32_worst = {"fwd": 0.0, "dq": 0.0, "dkv": 0.0}

    def draw(s, dtype):
        return [torch.randn((bh, s, d), generator=gen, device=dev).to(dtype)
                for _ in range(4)]

    for s, causal, dtype in ((MAX_SEQ, True, torch.bfloat16),
                             (MAX_SEQ, True, torch.float32),
                             (MAX_SEQ - 24, True, torch.bfloat16),
                             (MAX_SEQ, False, torch.bfloat16)):
        q, k, v, do = draw(s, dtype)
        o, lse = fa.flash_attention_fwd(q, k, v, scale, causal)
        delta = (do.float() * o.float()).sum(-1)
        dq = fa.flash_attention_bwd_dq(q, k, v, do, lse, delta, scale,
                                       causal)
        dk, dv = fa.flash_attention_bwd_dkv(q, k, v, do, lse, delta, scale,
                                            causal)
        o_r, lse_r = fa.flash_attention_reference(q, k, v, scale, causal)
        refs = fa.flash_attention_backward_reference(q, k, v, o, lse, do,
                                                     scale, causal)
        torch.cuda.synchronize()
        bf16 = dtype == torch.bfloat16
        errs, bad = {}, []
        for name, got, want in (("o", o, o_r), ("dq", dq, refs[0]),
                                ("dk", dk, refs[1]), ("dv", dv, refs[2])):
            if not bf16:
                err = (got - want).abs().max().item()
                errs[name] = err
                if err > KERNEL_ATOL * max(1.0, want.abs().max().item()):
                    bad.append("%s max %g" % (name, err))
                continue
            r = bf16_compare(got, want)
            errs[name] = r["err"]
            log("  %s bf16 s=%d causal=%s: max_abs_err %.4g of max|ref| "
                "%.4g (limit %.4g); ||err||/||ref|| %.4g (limit %g); "
                "element excess %.4g rms(ref) (limit %g) at |ref| %.4g "
                "|err| %.4g; rms(ref) %.4g" % (
                    name, s, causal, r["err"], r["top"],
                    BF16_MAX_RTOL * r["top"], r["rel"], BF16_NORM_RTOL,
                    r["over"], BF16_ELEM_RMS, r["at_ref"], r["at_err"],
                    r["rms"]))
            if not r["ok"]:
                bad.append("%s max %g norm %g element %g" % (
                    name, r["err"], r["rel"], r["over"]))
        check(not bad, "kernel outputs disagree with their plain versions at "
              "s=%d causal=%s %s: %s" % (s, causal, dtype, "; ".join(bad)))
        lse_err = (lse - lse_r).abs().max().item()
        check(lse_err <= KERNEL_ATOL * max(1.0, lse_r.abs().max().item()),
              "lse disagrees at s=%d causal=%s %s: %g" % (s, causal, dtype,
                                                         lse_err))
        log("train kernels bh=%d s=%d d=%d causal=%s %s: max_abs_err o %.3g "
            "lse %.3g dq %.3g dk %.3g dv %.3g" % (
                bh, s, d, causal, str(dtype).split(".")[-1], errs["o"],
                lse_err, errs["dq"], errs["dk"], errs["dv"]))
        w = worst if bf16 else f32_worst
        w["fwd"] = max(w["fwd"], errs["o"], lse_err)
        w["dq"] = max(w["dq"], errs["dq"])
        w["dkv"] = max(w["dkv"], errs["dk"], errs["dv"])
        del q, k, v, do, o, lse, delta, dq, dk, dv, o_r, lse_r, refs

    swept = edge_sweep(torch)
    dims = head_dim_sweep(torch)
    for what in worst:
        worst[what] = max(worst[what], swept[what], dims["bf16"][what])
        f32_worst[what] = max(f32_worst[what], dims["f32"][what])

    # times at the training shape, bf16, causal
    s = MAX_SEQ
    q, k, v, do = draw(s, torch.bfloat16)
    o, lse = fa.flash_attention_fwd(q, k, v, scale, True)
    delta = (do.float() * o.float()).sum(-1)
    kernel_calls = {
        "fwd": lambda: fa.flash_attention_fwd(q, k, v, scale, True),
        "dq": lambda: fa.flash_attention_bwd_dq(q, k, v, do, lse, delta,
                                                scale, True),
        "dkv": lambda: fa.flash_attention_bwd_dkv(q, k, v, do, lse, delta,
                                                  scale, True),
    }
    t = {w: timing(torch, fn) for w, fn in kernel_calls.items()}
    plain_fwd = time_ms(torch, lambda: fa.flash_attention_reference(
        q, k, v, scale, True), iters=5)
    plain_bwd = time_ms(torch, lambda: fa.flash_attention_backward_reference(
        q, k, v, o, lse, do, scale, True), iters=5)
    shape4 = (TRAIN_BATCH, HEADS, s, d)
    q4, k4, v4 = (t_.view(shape4).detach().requires_grad_(True)
                  for t_ in (q, k, v))
    out4 = F.scaled_dot_product_attention(q4, k4, v4, is_causal=True,
                                          scale=scale)
    do4 = do.view(shape4)
    calls = {
        "fwd": lambda: F.scaled_dot_product_attention(
            q4, k4, v4, is_causal=True, scale=scale),
        "bwd": lambda: torch.autograd.grad(out4, (q4, k4, v4), do4,
                                           retain_graph=True)}
    # ms and library_ms are both window medians (CUDA events); the
    # library's windows may time the host (autograd's backward), so both
    # sides also get their kernels' own durations (device_ms and
    # library_device_ms, from the profiler), which rank them
    lib = {w: dict(timing(torch, fn), device_ms=kernel_ms(torch, fn))
           for w, fn in calls.items()}
    for w in t:
        t[w]["device_ms"] = kernel_ms(torch, kernel_calls[w])
    plain = {"fwd": plain_fwd, "dq": plain_bwd, "dkv": plain_bwd}
    library = {"fwd": lib["fwd"], "dq": lib["bwd"], "dkv": lib["bwd"]}
    meta = {
        "fwd": ("flash_attention_fwd_bf16", "flash_attention_fwd.cu", 45,
                "_fa_kernel", "wgmma + TMA"),
        "dq": ("flash_attention_bwd_dq", "flash_attention_bwd.cu", 136,
               "_fa_bwd_dq_kernel", "wgmma + TMA"),
        "dkv": ("flash_attention_bwd_dkv", "flash_attention_bwd.cu", 186,
                "_fa_bwd_dkv_kernel", "wgmma + TMA"),
    }
    for what, (name, source, line, tpu, design) in meta.items():
        bound_ms, bound_by, flops, nbytes = attention_bound(
            what, bh, s, s, d, True, 2)
        ms = t[what]["ms"]
        lib_ms = library[what]["device_ms"]   # the library's kernel time
        log("%s bh=%d s=%d d=%d causal bf16 (%s): kernel %s, kernel time "
            "%.4f ms = %.1f TFLOP/s, %.1f%% of the bound; plain_ms=%.4f%s; "
            "library (sdpa %s) %s, kernel time %.4f ms; bound_ms=%.4f (%s: "
            "%.1f GFLOP at 989 TFLOP/s bf16 = %.4f ms, %.1f MB at 3.35 TB/s "
            "= %.4f ms)" % (
                name, bh, s, d, design, spread(t[what]),
                t[what]["device_ms"], flops / ms / 1e9, 100 * bound_ms / ms,
                plain[what],
                "" if what == "fwd" else " (plain backward, dQ dK dV)",
                "forward" if what == "fwd" else "backward, dQ dK dV",
                spread(library[what]), lib_ms, bound_ms, bound_by,
                flops / 1e9, flops / PEAK_BF16_FLOPS * 1e3, nbytes / 1e6,
                nbytes / PEAK_BYTES_PER_S * 1e3))
        kernels[name] = {
            "name": name, "route": "cuda",
            "source": "mxnet_tpu_torch/csrc/" + source,
            "replaces": "mxnet_tpu/ops/pallas/flash_attention.py:%d" % line,
            "tpu_kernel": "ops/pallas/flash_attention.py:" + tpu,
            "design": design,
            "max_abs_err": worst[what], "ms": ms,
            "ms_spread": [t[what]["lo"], t[what]["hi"]],
            "device_ms": t[what]["device_ms"],
            "host_us": t[what]["host_us"],
            "host_bound": t[what]["host_bound"],
            "tflops": flops / ms / 1e9, "bound_share": bound_ms / ms,
            "plain_ms": plain[what], "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": library[what]["ms"],
            "library_spread": [library[what]["lo"], library[what]["hi"]],
            "library_device_ms": lib_ms,
            "library_host_us": library[what]["host_us"],
            "library_host_bound": library[what]["host_bound"]}
        if name in BUILD_REPORT:
            kernels[name]["build"] = BUILD_REPORT[name]
    del q, k, v, do, o, lse, delta, q4, k4, v4, out4, do4
    gc.collect()
    torch.cuda.empty_cache()

    # K2 f32 and K3 f32 (3xTF32 on mma.sync) at the same shape in float32
    ft = f32_backward_timing(torch)
    d256 = d256_timing(torch)
    kernels["flash_attention_fwd"]["max_abs_err"] = max(
        kernels["flash_attention_fwd"]["max_abs_err"], f32_worst["fwd"])
    kernels["flash_attention_fwd"]["d256_device_ms"] = d256["f32"]["fwd"]
    kernels["flash_attention_fwd_bf16"]["d256_device_ms"] = d256["bf16"]["fwd"]
    lt = ft["library"]
    for what, line in (("dq", 136), ("dkv", 186)):
        name = "flash_attention_bwd_%s_f32" % what
        kt = ft[what]
        kernels["flash_attention_bwd_" + what]["d256_device_ms"] = \
            d256["bf16"][what]
        kernels[name].update({
            "name": name, "route": "cuda",
            "source": "mxnet_tpu_torch/csrc/flash_attention_bwd.cu",
            "replaces": "mxnet_tpu/ops/pallas/flash_attention.py:%d" % line,
            "tpu_kernel": "ops/pallas/flash_attention.py:" + (
                "_fa_bwd_dq_kernel" if what == "dq" else
                "_fa_bwd_dkv_kernel"),
            "design": "3xTF32 on mma.sync",
            "max_abs_err": max(kernels[name]["max_abs_err"],
                               f32_worst[what]),
            "ms": kt["ms"], "ms_spread": [kt["lo"], kt["hi"]],
            "device_ms": kt["device_ms"], "host_us": kt["host_us"],
            "host_bound": kt["host_bound"],
            "tflops": kt["flops"] / kt["device_ms"] / 1e9,
            "bound_share": kt["bound_ms"] / kt["device_ms"],
            "plain_ms": ft["plain_ms"], "bound_ms": kt["bound_ms"],
            "bound_by": kt["bound_by"],
            "bound_peak": "3 x flops at 495 TFLOP/s TF32; bytes at 3.35 TB/s",
            "fma_bound_ms": kt["fma_ms"],
            "library_ms": lt["ms"], "library_spread": [lt["lo"], lt["hi"]],
            "library_device_ms": lt["device_ms"],
            "library_host_us": lt["host_us"],
            "library_host_bound": lt["host_bound"],
            "d256_device_ms": d256["f32"][what]})
        if name in BUILD_REPORT:
            kernels[name]["build"] = BUILD_REPORT[name]


def plain_train_loss(torch, p, x, y):
    """Mean cross-entropy of the zoo transformer's training graph on one
    batch, in plain float32 PyTorch (dense attention with its -1e9
    causal bias), written from the Symbol and independent of the port's
    Module, ops and kernels."""
    import torch.nn.functional as F
    n, t = x.shape
    d = D_MODEL // HEADS
    h = p["tok_embed_weight"][x.long()] + p["pos_embed_weight"][:t]
    bias = torch.triu(torch.full((t, t), -1e9, device=x.device), 1)
    for i in range(LAYERS):
        pf = "layer%d_" % i
        a = F.layer_norm(h, (D_MODEL,), p[pf + "ln1_gamma"],
                         p[pf + "ln1_beta"], 1e-5)
        qkv = F.linear(a, p[pf + "att_qkv_weight"], p[pf + "att_qkv_bias"])
        q, k, v = qkv.view(n, t, 3, HEADS, d).permute(2, 0, 3, 1, 4)
        att = torch.softmax(q @ k.transpose(-1, -2) * d ** -0.5 + bias, -1)
        ctx = (att @ v).transpose(1, 2).reshape(n, t, D_MODEL)
        del q, k, v, att, qkv
        h = h + F.linear(ctx, p[pf + "att_proj_weight"],
                         p[pf + "att_proj_bias"])
        a = F.layer_norm(h, (D_MODEL,), p[pf + "ln2_gamma"],
                         p[pf + "ln2_beta"], 1e-5)
        a = torch.relu(F.linear(a, p[pf + "ff1_weight"], p[pf + "ff1_bias"]))
        h = h + F.linear(a, p[pf + "ff2_weight"], p[pf + "ff2_bias"])
    h = F.layer_norm(h, (D_MODEL,), p["final_ln_gamma"], p["final_ln_beta"],
                     1e-5)
    logits = F.linear(h, p["lm_head_weight"], p["lm_head_bias"])
    return F.cross_entropy(logits.view(-1, VOCAB), y.view(-1).long())


def kernel_kind(name: str) -> str:
    """A coarse class of a CUDA kernel, by its name."""
    if "fa_fwd" in name or "fa_bwd" in name:
        return "attention kernels"
    low = name.lower()
    if any(w in low for w in ("gemm", "nvjet", "xmma", "cutlass")):
        return "matmul (cuBLAS)"
    if "reduce" in low:
        return "reductions"
    if "softmax" in low:
        return "softmax"
    if any(w in low for w in ("foreach", "multi_tensor")):
        return "optimizer (foreach)"
    if any(w in low for w in ("elementwise", "copy", "fill")):
        return "elementwise / copy"
    if any(w in low for w in ("index", "scatter", "gather", "embedding")):
        return "gather / scatter"
    return "other"


def train_lm(torch, np, counters, warm, timed):
    """Module on the zoo LM at bench.py's training configuration (batch
    8, T 1024, attention="flash", Xavier weights from numpy seed 0, SGD
    lr 0.01) on one fixed random batch, under whatever amp state the
    caller set: the first step (bind included) timed, ``warm`` steps,
    ``timed`` steps between CUDA events, then one step under
    torch.profiler. The kernel wrappers' ``counters`` are zeroed just
    before the first step and read after the last timed one. Returns the
    readings, the step-1 cross-entropy of an independent plain float32
    forward of the same initial weights among them."""
    from torch.profiler import ProfilerActivity, profile
    import mxnet_tpu_torch as mt
    from mxnet_tpu_torch.models import transformer
    B, T = TRAIN_BATCH, MAX_SEQ
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    sym = transformer.get_symbol(VOCAB, LAYERS, D_MODEL, HEADS, D_FF, T,
                                 attention="flash")
    mod = mt.mod.Module(sym, context=mt.gpu(0))
    mod.bind(data_shapes=[("data", (B, T))],
             label_shapes=[("softmax_label", (B, T))])
    mod.init_params(mt.init.Xavier().set_rng(np.random.default_rng(SEED)))
    mod.init_optimizer(optimizer="sgd",
                       optimizer_params={"learning_rate": TRAIN_LR})
    torch.cuda.synchronize()
    bind_s = time.perf_counter() - t0
    # bench.py's batch: one fixed random batch, ids as float32
    rng = np.random.RandomState(0)
    x = rng.randint(0, VOCAB, (B, T)).astype(np.float32)
    y = rng.randint(0, VOCAB, (B, T)).astype(np.float32)
    dev = torch.device(DEVICE)
    db = mt.io.DataBatch(data=[mt.nd.array(x, ctx=dev)],
                         label=[mt.nd.array(y, ctx=dev)])
    y_flat = torch.from_numpy(y).to(dev).long().view(-1, 1)
    with torch.no_grad():
        params = {n: a.data for n, a in mod.get_params()[0].items()}
        want = plain_train_loss(torch, params, torch.from_numpy(x).to(dev),
                                torch.from_numpy(y).to(dev)).item()
        del params
    torch.cuda.empty_cache()

    def step():
        mod._fit_step(db)
        out = mod.get_outputs()[0].data
        # this step's cross-entropy, on the card: read after the run
        return -(out.gather(1, y_flat) + 1e-12).log().mean()

    # the main path: counters zeroed just before, read just after
    for fn in counters.values():
        fn.launches = {"f32": 0, "bf16": 0}
    t0 = time.perf_counter()
    losses = [step()]
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    for _ in range(warm):
        losses.append(step())
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(timed):
        losses.append(step())
    end.record()
    torch.cuda.synchronize()
    step_ms = start.elapsed_time(end) / timed
    launches = {n: dict(fn.launches) for n, fn in counters.items()}
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    rows, busy_ms = device_breakdown(torch, prof, wall, "train step")
    by_kind = {}
    for e in rows:
        kind = kernel_kind(e.key)
        by_kind[kind] = by_kind.get(kind, 0.0) + \
            e.self_device_time_total / 1e3
    log("train step device time by kind: " + ", ".join(
        "%s %.3f ms" % kv for kv in sorted(by_kind.items(),
                                           key=lambda kv: -kv[1])))
    attention = {e.key: (e.self_device_time_total / 1e3, e.count)
                 for e in rows if kernel_kind(e.key) == "attention kernels"}
    log("train step attention kernels: " + ", ".join(
        "%s %.3f ms in %d launches" % (name[:60], ms, n)
        for name, (ms, n) in sorted(attention.items(),
                                    key=lambda kv: -kv[1][0])))
    losses = [float(v) for v in torch.stack(losses).cpu()]
    torch.cuda.synchronize()
    del mod, db
    gc.collect()
    torch.cuda.empty_cache()
    return {"losses": losses, "want": want, "step_ms": step_ms,
            "bind_s": bind_s, "first_s": first_s, "timed": timed,
            "launches": launches,
            "peak_gb": peak_gb, "busy_ms": busy_ms,
            "att_ms": by_kind.get("attention kernels", 0.0),
            "by_kind": by_kind}


def check_training(what, run, dtype, peak_flops, peak_name):
    """Log a training run's readings and hold it to the path: finite
    losses that fall, the step-1 cross-entropy within CE_TOL of the
    plain forward's, and each kernel launched once per layer per step
    with inputs of ``dtype`` ("f32" or "bf16") only."""
    from mxnet_tpu_torch.models import transformer
    B, T = TRAIN_BATCH, MAX_SEQ
    losses, want, launches = run["losses"], run["want"], run["launches"]
    n_steps = len(losses)
    n_params = transformer.param_count(VOCAB, LAYERS, D_MODEL, HEADS, D_FF,
                                       T)
    n_embed = VOCAB * D_MODEL + T * D_MODEL
    flops_per_tok = 6 * (n_params - n_embed) + 12 * LAYERS * D_MODEL * T
    tok_s = B * T / (run["step_ms"] / 1e3)
    log("%s: bind %.3f s, first step %.3f s; step %.3f ms (%d steps between "
        "CUDA events) = %.1f tok/s; MFU %.4f of %.0f TFLOP/s %s (%.4g TFLOP "
        "per step by bench.py's accounting); peak memory %.3f GB; attention "
        "kernels %.3f ms of %.3f ms device time (%.1f%%)"
        % (what, run["bind_s"], run["first_s"], run["step_ms"], run["timed"],
           tok_s, tok_s * flops_per_tok / peak_flops, peak_flops / 1e12,
           peak_name, flops_per_tok * B * T / 1e12, run["peak_gb"],
           run["att_ms"], run["busy_ms"],
           100 * run["att_ms"] / max(run["busy_ms"], 1e-9)))
    log("%s: loss per step %s" % (what, " ".join("%.6f" % v for v in losses)))
    log("%s: step-1 cross-entropy %.6f, plain f32 forward %.6f (|diff| %.3g, "
        "tolerance %g); launches %s over %d steps x %d layers"
        % (what, losses[0], want, abs(losses[0] - want), CE_TOL, launches,
           n_steps, LAYERS))
    check(all(math.isfinite(v) for v in losses), "%s: non-finite loss %s"
          % (what, losses))
    check(losses[-1] < losses[0], "%s: loss did not fall: %s"
          % (what, losses))
    check(abs(losses[0] - want) <= CE_TOL, "%s: step-1 loss %g vs plain "
          "forward %g" % (what, losses[0], want))
    other = "bf16" if dtype == "f32" else "f32"
    for name, n in launches.items():
        check(n[dtype] == n_steps * LAYERS and n[other] == 0,
              "%s: kernel %s launched %s times in %d steps x %d layers (%s "
              "only expected)" % (what, name, n, n_steps, LAYERS, dtype))


def train_phase(torch, np, kernels):
    """Training in amp bf16: the bf16 forward, dQ and dK/dV kernels.
    Returns the run's readings (phase 11 sets its Adam step beside
    them)."""
    import mxnet_tpu_torch as mt
    from mxnet_tpu_torch.ops import flash_attention as fa
    counters = {"flash_attention_fwd_bf16": fa.flash_attention_fwd,
                "flash_attention_bwd_dq": fa.flash_attention_bwd_dq,
                "flash_attention_bwd_dkv": fa.flash_attention_bwd_dkv}
    mt.amp.init("bfloat16")
    try:
        run = train_lm(torch, np, counters, TRAIN_WARM, TRAIN_TIMED)
    finally:
        mt.amp.off()
    # amp bf16 reaches attention: the bf16 kernels ran, the f32 ones not
    check_training("train", run, "bf16", PEAK_BF16_FLOPS, "bf16")
    for name, n in run["launches"].items():
        kernels[name]["launches"] = n["bf16"]
    return run


def train_f32_phase(torch, np, kernels):
    """Training with amp off (the reference's default): the f32 forward,
    dQ and dK/dV kernels (3xTF32), cuBLAS in full float32 (TF32 off, as
    card_phase set it)."""
    from mxnet_tpu_torch.ops import flash_attention as fa
    counters = {"flash_attention_fwd": fa.flash_attention_fwd,
                "flash_attention_bwd_dq_f32": fa.flash_attention_bwd_dq,
                "flash_attention_bwd_dkv_f32": fa.flash_attention_bwd_dkv}
    check(not torch.backends.cuda.matmul.allow_tf32,
          "cuBLAS may use TF32: the f32 step would not be float32")
    run = train_lm(torch, np, counters, TRAIN_F32_WARM, TRAIN_F32_TIMED)
    check_training("train f32", run, "f32", PEAK_FP32_FLOPS, "f32")
    kernels["flash_attention_fwd"]["train_f32_launches"] = \
        run["launches"]["flash_attention_fwd"]["f32"]
    for name in ("flash_attention_bwd_dq_f32", "flash_attention_bwd_dkv_f32"):
        kernels[name]["launches"] = run["launches"][name]["f32"]
    kernels["flash_attention_fwd"]["train_f32_step_ms"] = run["step_ms"]


def rtc_kernels():
    """The five user kernels at the main path's shapes."""
    from mxnet_tpu_torch import rtc_examples as ex
    rows = TRAIN_BATCH * MAX_SEQ
    return {
        "scale_add": ex.scale_add((rows, D_MODEL)),
        "relu": ex.relu((rows, D_FF)),
        "split": ex.split((rows, D_MODEL)),
        "softmax_rows": ex.softmax_rows(rows, VOCAB),
        "softmax_ce_grad": ex.softmax_ce_grad(rows, VOCAB),
    }


def rtc_check_and_time(torch, kerns):
    """Each kernel against its plain version on the same inputs, then
    timed beside it, one library call and its bound (the bytes of each
    input read once and each output written once, or its operations at
    the f32 peak). These launches are not the counted path."""
    import torch.nn.functional as F
    from mxnet_tpu_torch import rtc_examples as ex
    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(SEED + 3)
    rows = TRAIN_BATCH * MAX_SEQ

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    h, a = randn(rows, D_MODEL), randn(rows, D_MODEL)
    act = randn(rows, D_FF)
    logits = randn(rows, VOCAB)
    p = ex.softmax_rows_plain(logits)
    labels = torch.randint(0, VOCAB, (rows,), generator=gen,
                           device=dev).float()
    cases = {
        # name: (inputs, plain, library call, its description, flop/elem)
        "scale_add": ((h, a), ex.scale_add_plain,
                      lambda: torch.add(a, h, alpha=2),
                      "torch.add(y, x, alpha=2)", 2),
        "relu": ((act,), ex.relu_plain, lambda: torch.relu(act),
                 "torch.relu", 1),
        "split": ((h,), ex.split_plain,
                  lambda: (torch.mul(h, 2), torch.add(h, 1)),
                  "torch.mul + torch.add (two calls)", 2),
        "softmax_rows": ((logits,), ex.softmax_rows_plain,
                         lambda: torch.softmax(logits, dim=1),
                         "torch.softmax(dim=1)", 5),
        "softmax_ce_grad": ((p, labels), ex.softmax_ce_grad_plain,
                            lambda: p - F.one_hot(labels.long(), VOCAB),
                            "p - F.one_hot (two calls)", 1),
    }
    table = {}
    for name, (ins, plain, library, lib_desc, flop_per) in cases.items():
        kern = kerns[name]
        got = kern.run(ins)
        want = plain(*ins)
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        torch.cuda.synchronize()
        err = max((g - w).abs().max().item() for g, w in zip(got, want))
        top = max(w.abs().max().item() for w in want)
        rtol = RTC_SOFTMAX_RTOL if name == "softmax_rows" else RTC_EXACT_RTOL
        log("rtc %s %s: max_abs_err %.4g of max|ref| %.4g (limit %.3g)"
            % (name, "x".join(map(str, ins[0].shape)), err, top, rtol * top))
        check(err <= rtol * top, "rtc kernel %s disagrees with its plain "
              "version: %g > %g" % (name, err, rtol * top))
        nbytes = sum(t.numel() * t.element_size() for t in ins + got)
        flops = flop_per * got[0].numel()
        t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, flops / PEAK_FP32_FLOPS
        del got, want
        ms = time_ms(torch, lambda: kern.run(ins))
        plain_ms = time_ms(torch, lambda: plain(*ins))
        library_ms = time_ms(torch, library)
        bound_ms = max(t_bytes, t_ops) * 1e3
        bound_by = "bytes" if t_bytes >= t_ops else "operations"
        log("rtc %s: kernel_ms=%.4f plain_ms=%.4f library_ms=%.4f (%s) "
            "bound_ms=%.4f (%s: %.1f MB at 3.35 TB/s; %.2f GFLOP at 67 "
            "TFLOP/s f32 = %.4f ms); %.0f GB/s, %.1f%% of the bound"
            % (name, ms, plain_ms, library_ms, lib_desc, bound_ms, bound_by,
               nbytes / 1e6, flops / 1e9, t_ops * 1e3, nbytes / ms / 1e6,
               100 * bound_ms / ms))
        table[name] = {
            "name": "rtc_" + name, "route": "cuda",
            "source": "mxnet_tpu_torch/rtc_examples.py",
            "replaces": "mxnet_tpu/rtc.py:96",
            "tpu_kernel": "rtc.py:PallasKernel._build",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms, "library": lib_desc}
    # a thread torch never used (a server's worker): the launch must make
    # torch's context current there first (_cuda_driver.make_current)
    box = {}
    worker = threading.Thread(target=lambda: box.update(
        out=kerns["scale_add"].run((h, a))))
    worker.start()
    worker.join()
    check("out" in box, "rtc scale_add failed on a new thread")
    log("rtc scale_add on a thread torch never used: max_abs_err %.3g"
        % rtc_equal("scale_add on a new thread", box["out"],
                    ex.scale_add_plain(h, a)))
    del h, a, act, logits, p, labels, box
    gc.collect()
    torch.cuda.empty_cache()
    return table


RTC_PAIRS = 10         # alternating kernel / library windows (ROADMAP B6f)
# ROADMAP B6f's first design for relu / scale_add, a second arm of
# ``--pairs-of CHECKOUT rtc`` beside the checkout's kernels: a loop over
# the blocks the card holds at once (its SMs x 8 blocks of 256 threads,
# which __launch_bounds__(256, 8) makes fit in 32 registers), four
# float4 loads in flight per thread before its stores (relu four of x,
# scale_add two of x and two of y), all loads and stores streaming
B6F_STREAM_SOURCE = r"""
#define UNROLL 4
#define UNROLL2 2
__device__ __forceinline__ float relu1(float v) { return v < 0.f ? 0.f : v; }
__device__ __forceinline__ float4 relu4(float4 a) {
  return make_float4(relu1(a.x), relu1(a.y), relu1(a.z), relu1(a.w));
}
__device__ __forceinline__ float4 scale_add4(float4 a, float4 b) {
  return make_float4(2.f * a.x + b.x, 2.f * a.y + b.y, 2.f * a.z + b.z,
                     2.f * a.w + b.w);
}
// n a multiple of 4, pointers 16-byte aligned (the pairs' inputs)
extern "C" __global__ void __launch_bounds__(256, 8)
relu_stream(const float* __restrict__ x, float* __restrict__ o,
            long long n) {
  const float4* x4 = reinterpret_cast<const float4*>(x);
  float4* o4 = reinterpret_cast<float4*>(o);
  const long long n4 = n >> 2, stride = (long long)gridDim.x * blockDim.x;
  long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  for (; i + (UNROLL - 1) * stride < n4; i += UNROLL * stride) {
    float4 v[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) v[u] = __ldcs(x4 + i + u * stride);
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) __stcs(o4 + i + u * stride, relu4(v[u]));
  }
  for (; i < n4; i += stride) __stcs(o4 + i, relu4(__ldcs(x4 + i)));
}
extern "C" __global__ void __launch_bounds__(256, 8)
scale_add_stream(const float* __restrict__ x, const float* __restrict__ y,
                 float* __restrict__ o, long long n) {
  const float4* x4 = reinterpret_cast<const float4*>(x);
  const float4* y4 = reinterpret_cast<const float4*>(y);
  float4* o4 = reinterpret_cast<float4*>(o);
  const long long n4 = n >> 2, stride = (long long)gridDim.x * blockDim.x;
  long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  for (; i + (UNROLL2 - 1) * stride < n4; i += UNROLL2 * stride) {
    float4 a[UNROLL2], b[UNROLL2];
#pragma unroll
    for (int u = 0; u < UNROLL2; ++u) {
      a[u] = __ldcs(x4 + i + u * stride);
      b[u] = __ldcs(y4 + i + u * stride);
    }
#pragma unroll
    for (int u = 0; u < UNROLL2; ++u)
      __stcs(o4 + i + u * stride, scale_add4(a[u], b[u]));
  }
  for (; i < n4; i += stride)
    __stcs(o4 + i, scale_add4(__ldcs(x4 + i), __ldcs(y4 + i)));
}
"""


def rtc_pairs(torch, kerns):
    """Each kernel of ``kerns`` (``relu`` at 8192 x 8192, ``scale_add``
    or ``split`` at 8192 x 2048, by its name up to a comma) against
    ``torch.relu`` / ``torch.add`` / ``torch.mul`` + ``torch.add`` in
    RTC_PAIRS rounds, each a window of 20 launches of
    every kernel of the op and then one of the library call, between
    CUDA events: the medians, each round's difference and its range.
    A kernel loses to the library call beyond the spread when every
    round's difference is positive. These launches are not the counted
    path."""
    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(SEED + 4)
    rows = TRAIN_BATCH * MAX_SEQ
    act = torch.randn((rows, D_FF), generator=gen, device=dev)
    h = torch.randn((rows, D_MODEL), generator=gen, device=dev)
    a = torch.randn((rows, D_MODEL), generator=gen, device=dev)
    ops = {"relu": ((act,), lambda: torch.relu(act), "torch.relu"),
           "scale_add": ((h, a), lambda: torch.add(a, h, alpha=2),
                         "torch.add(y, x, alpha=2)"),
           "split": ((h,), lambda: (torch.mul(h, 2), torch.add(h, 1)),
                     "torch.mul + torch.add")}
    out = {}
    for op, (ins, lib, lib_desc) in ops.items():
        arms = {name: kern for name, kern in kerns.items()
                if name.split(",")[0] == op}
        ks = {name: [] for name in arms}
        ls = []
        for _ in range(RTC_PAIRS):
            for name, kern in arms.items():
                ks[name].append(timing(torch, lambda: kern.run(ins),
                                       windows=1)["ms"])
            ls.append(timing(torch, lib, windows=1)["ms"])
        l_med = sorted(ls)[len(ls) // 2]
        for name, times in ks.items():
            diffs = sorted(k - v for k, v in zip(times, ls))
            k_med = sorted(times)[len(times) // 2]
            loses = diffs[0] > 0
            log("rtc pairs %s: kernel median %.4f ms (%.4f-%.4f), %s %.4f "
                "ms (%.4f-%.4f) over %d alternating windows of 20; kernel - "
                "library per pair: median %+.4f ms, range %+.4f..%+.4f; %s"
                % (name, k_med, min(times), max(times), lib_desc, l_med,
                   min(ls), max(ls), RTC_PAIRS, diffs[len(diffs) // 2],
                   diffs[0], diffs[-1], "the kernel loses in every pair"
                   if loses else "within the pairs' spread or faster"))
            out[name] = {"ms": k_med, "library_ms": l_med,
                         "diff_ms": diffs[len(diffs) // 2],
                         "diff_lo": diffs[0], "diff_hi": diffs[-1],
                         "loses": loses}
    del act, h, a
    return out


def b6f_stream_kernels(torch):
    """:data:`B6F_STREAM_SOURCE`'s two kernels at the pairs' shapes, each
    first held to its plain version, with the compiler's report."""
    from mxnet_tpu_torch import rtc
    from mxnet_tpu_torch import rtc_examples as ex
    dev = torch.device(DEVICE)
    grid = (torch.cuda.get_device_properties(dev).multi_processor_count
            * 8,)
    rows = TRAIN_BATCH * MAX_SEQ
    kerns = {}
    for op, width, sig, plain in (
            ("relu", D_FF, "const float* x, float* o, long long n",
             ex.relu_plain),
            ("scale_add", D_MODEL,
             "const float* x, const float* y, float* o, long long n",
             ex.scale_add_plain)):
        shape = (rows, width)
        kern = rtc.UserKernel(
            B6F_STREAM_SOURCE, op + "_stream", sig,
            (shape, torch.float32), grid=grid, block=(256,),
            scalars=(rows * width,), plain=plain)
        ins = [torch.randn(shape, device=dev)
               for _ in range(2 if op == "scale_add" else 1)]
        rtc_equal(op + " (B6f streaming design)", kern.run(ins),
                  plain(*ins))
        kerns[op + ", B6f streaming design"] = kern
    log("B6f streaming design: grid %d x 256; %s" % (grid[0], " ".join(
        ln.strip() for ln in kern.kernel.module.build_log.splitlines()
        if "registers" in ln or "spill" in ln)))
    return kerns


def rtc_equal(name, got, want):
    err = (got - want).abs().max().item()
    top = want.abs().max().item()
    check(err <= RTC_EXACT_RTOL * top, "%s: max_abs_err %g > %g"
          % (name, err, RTC_EXACT_RTOL * top))
    return err


def rtc_paths(torch, kerns):
    """The counted path's first part: each kernel through the entry
    points a user calls, each result held against its plain version."""
    import mxnet_tpu_torch as mt
    from mxnet_tpu_torch import rtc_examples as ex
    dev = torch.device(DEVICE)
    rng = torch.Generator(device=dev).manual_seed(SEED + 4)
    rows = TRAIN_BATCH * MAX_SEQ
    x = torch.randn((rows, D_MODEL), generator=rng, device=dev)
    y = torch.randn((rows, D_MODEL), generator=rng, device=dev)
    act = torch.randn((rows, D_FF), generator=rng, device=dev)
    errs = {}
    out = kerns["scale_add"](mt.nd.NDArray(x), mt.nd.NDArray(y))
    errs["scale_add UserKernel()"] = rtc_equal(
        "scale_add", out.data, ex.scale_add_plain(x, y))
    want = ex.relu_plain(act)
    out = mt.nd.smoke_rtc_relu(mt.nd.array(act, ctx=dev))
    errs["relu nd"] = rtc_equal("relu via nd", out.data, want)
    s = mt.sym.smoke_rtc_relu(mt.sym.Variable("data"))
    exe = s.simple_bind(ctx=dev, grad_req="null", data=(rows, D_FF))
    exe.arg_dict["data"][:] = act
    errs["relu sym"] = rtc_equal("relu via sym", exe.forward()[0].data,
                                 want)
    del exe, out, want
    wa, wb = ex.split_plain(x)
    a, b = mt.nd.smoke_rtc_split(mt.nd.NDArray(x))
    errs["split nd"] = max(rtc_equal("split[0] via nd", a.data, wa),
                           rtc_equal("split[1] via nd", b.data, wb))
    s = mt.sym.smoke_rtc_split(mt.sym.Variable("data"))
    check(len(s.list_outputs()) == 2, "split symbol lists %s"
          % s.list_outputs())
    exe = s.simple_bind(ctx=dev, grad_req="null", data=(rows, D_MODEL))
    exe.arg_dict["data"][:] = x
    outs = exe.forward()
    check(len(outs) == 2, "split executor returned %d outputs" % len(outs))
    errs["split sym"] = max(rtc_equal("split[0] via sym", outs[0].data, wa),
                            rtc_equal("split[1] via sym", outs[1].data, wb))
    torch.cuda.synchronize()
    log("rtc paths: max_abs_err %s; split symbol outputs %s"
        % (", ".join("%s %.3g" % kv for kv in errs.items()),
           s.list_outputs()))
    del x, y, act, a, b, wa, wb, exe, outs


def rtc_train(torch, np, kerns):
    """The counted path's second part: the CustomOp head on the two row
    kernels under a 32000-wide FullyConnected, trained by Module for
    13 steps. The launch counters are read after the 13th step; two more
    steps then run under the profiler, the second traced. Returns the
    readings."""
    import torch.nn.functional as F
    from torch.profiler import ProfilerActivity, profile
    import mxnet_tpu_torch as mt
    rows = TRAIN_BATCH * MAX_SEQ
    dev = torch.device(DEVICE)
    data, label = mt.sym.Variable("data"), mt.sym.Variable("label")
    head = mt.sym.FullyConnected(data, num_hidden=VOCAB, name="head")
    net = mt.sym.Custom(head, label, op_type="smoke_rtc_softmax_loss",
                        name="loss")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    mod = mt.mod.Module(net, context=dev, data_names=["data"],
                        label_names=["label"])
    mod.bind(data_shapes=[("data", (rows, D_MODEL))],
             label_shapes=[("label", (rows,))])
    mod.init_params(mt.init.Xavier().set_rng(np.random.default_rng(SEED)))
    mod.init_optimizer(optimizer="sgd",
                       optimizer_params={"learning_rate": TRAIN_LR})
    torch.cuda.synchronize()
    bind_s = time.perf_counter() - t0
    rng = np.random.RandomState(0)
    x = rng.randn(rows, D_MODEL).astype(np.float32)
    y = rng.randint(0, VOCAB, rows).astype(np.float32)
    db = mt.io.DataBatch(data=[mt.nd.array(x, ctx=dev)],
                         label=[mt.nd.array(y, ctx=dev)])
    y_idx = torch.from_numpy(y).to(dev).long().view(-1, 1)
    with torch.no_grad():
        params = {n: a.data for n, a in mod.get_params()[0].items()}
        logits = F.linear(torch.from_numpy(x).to(dev), params["head_weight"],
                          params["head_bias"])
        want = F.cross_entropy(logits, y_idx.view(-1)).item()
        del params, logits

    def step():
        mod._fit_step(db)
        p = mod.get_outputs()[0].data
        return -(p.gather(1, y_idx) + 1e-12).log().mean()

    t0 = time.perf_counter()
    losses = [step()]
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    for _ in range(RTC_STEPS_WARM - 1):
        losses.append(step())
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(RTC_STEPS_TIMED):
        losses.append(step())
    end.record()
    torch.cuda.synchronize()
    step_ms = start.elapsed_time(end) / RTC_STEPS_TIMED
    launches = {name: kern.launches for name, kern in kerns.items()}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    # a warm-up step under the profiler first: traced alone, the step
    # lost its first ~20 ms of device activity (one of its two GEMMs),
    # which the step's CUDA events counted
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=torch.profiler.schedule(wait=0, warmup=1, active=1,
                                                  repeat=1)) as prof:
        step()
        torch.cuda.synchronize()
        prof.step()
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        prof.step()
    device_breakdown(torch, prof, wall, "rtc head step")
    return {"losses": [float(v) for v in torch.stack(losses).cpu()],
            "want": want, "step_ms": step_ms, "bind_s": bind_s,
            "first_s": first_s, "launches": launches, "peak_gb": peak_gb}


def rtc_phase(torch, np, kernels):
    import mxnet_tpu_torch as mt
    from mxnet_tpu_torch import rtc_examples as ex
    gc.collect()
    torch.cuda.empty_cache()
    kerns = rtc_kernels()
    kerns["relu"].register("smoke_rtc_relu")
    kerns["split"].register("smoke_rtc_split")
    mt.operator.register("smoke_rtc_softmax_loss")(ex.softmax_loss_prop(
        kerns["softmax_rows"], kerns["softmax_ce_grad"]))
    table = rtc_check_and_time(torch, kerns)
    for name, pair in rtc_pairs(torch, {k: kerns[k] for k in (
            "relu", "scale_add", "split")}).items():
        table[name].update(pair_ms=pair["ms"],
                           pair_library_ms=pair["library_ms"],
                           pair_diff_ms=[pair["diff_lo"], pair["diff_hi"]])

    # the main path: counters zeroed just before, read just after
    for kern in kerns.values():
        kern.launches = 0
    rtc_paths(torch, kerns)
    run = rtc_train(torch, np, kerns)
    gc.collect()
    torch.cuda.empty_cache()
    losses, want, launches = run["losses"], run["want"], run["launches"]
    n_steps = len(losses)
    rows = TRAIN_BATCH * MAX_SEQ
    # the forward and the weight-gradient GEMMs: the data takes no
    # gradient (Module binds its inputs with grad_req "null")
    flops = 4.0 * rows * D_MODEL * VOCAB
    log("rtc train: head FullyConnected(%d) + CustomOp on softmax_rows / "
        "softmax_ce_grad, batch (%d, %d) f32: bind %.3f s, first step %.3f "
        "s, step %.3f ms (%d steps between CUDA events; %.1f TFLOP/s of "
        "the head's two f32 GEMMs, %.4g TFLOP); peak memory %.3f GB"
        % (VOCAB, rows, D_MODEL, run["bind_s"], run["first_s"],
           run["step_ms"], RTC_STEPS_TIMED,
           flops / (run["step_ms"] / 1e3) / 1e12, flops / 1e12,
           run["peak_gb"]))
    log("rtc train: loss per step %s" % " ".join("%.6f" % v for v in losses))
    log("rtc train: step-1 cross-entropy %.6f, plain f32 forward %.6f "
        "(|diff| %.3g, tolerance %g); launches %s over %d steps"
        % (losses[0], want, abs(losses[0] - want), CE_TOL, launches,
           n_steps))
    check(all(math.isfinite(v) for v in losses), "non-finite loss %s"
          % losses)
    check(losses[-1] < losses[0], "rtc head loss did not fall: %s" % losses)
    check(abs(losses[0] - want) <= CE_TOL, "rtc head step-1 loss %g vs "
          "plain forward %g" % (losses[0], want))
    # scale_add once through UserKernel(); relu and split once through
    # nd and once through sym; the head's two kernels once per step
    expected = {"scale_add": 1, "relu": 2, "split": 2,
                "softmax_rows": n_steps, "softmax_ce_grad": n_steps}
    check(launches == expected, "rtc launches %s, the path implies %s"
          % (launches, expected))
    for name, entry in table.items():
        entry["launches"] = launches[name]
        kernels[entry["name"]] = entry


def resnet_units(layers):
    """Units per stage and whether they are bottlenecks, as the zoo's
    imagenet ResNet builds them (50 layers on the card, 18 in the CPU
    rehearsal)."""
    return {18: ([2, 2, 2, 2], False), 50: ([3, 4, 6, 3], True)}[layers]


def plain_resnet(torch, p, x, y):
    """The zoo's ResNet v2 training forward (imagenet stem) in plain
    float32 torch.nn.functional, written from models/resnet.py and
    independent of the port's ops and Module: the 7x7/2 stem convolves
    ``conv0_weight`` directly (the port runs its s2d rewrite), and every
    BatchNorm normalises with the batch statistics (biased variance).
    Returns the mean cross-entropy and each BatchNorm's (mean, var)."""
    import torch.nn.functional as F
    stats = {}

    def bn(h, name, fix_gamma=False):
        var, mean = torch.var_mean(h, dim=(0, 2, 3), unbiased=False)
        stats[name] = (mean, var)
        g = torch.ones_like(mean) if fix_gamma else p[name + "_gamma"]
        scale = (g * torch.rsqrt(var + RESNET_EPS)).view(1, -1, 1, 1)
        return (h - mean.view(1, -1, 1, 1)) * scale + \
            p[name + "_beta"].view(1, -1, 1, 1)

    def conv(h, name, stride=1, pad=0):
        return F.conv2d(h, p[name + "_weight"], stride=stride, padding=pad)

    units, bottleneck = resnet_units(RESNET_LAYERS)
    h = bn(x, "bn_data", fix_gamma=True)
    h = conv(h, "conv0", 2, 3)
    h = F.max_pool2d(torch.relu(bn(h, "bn0")), 3, 2, 1)
    for i, n in enumerate(units):
        for j in range(n):
            name = "stage%d_unit%d" % (i + 1, j + 1)
            stride = 2 if i > 0 and j == 0 else 1
            act = torch.relu(bn(h, name + "_bn1"))
            if bottleneck:
                b = torch.relu(bn(conv(act, name + "_conv1"), name + "_bn2"))
                b = torch.relu(bn(conv(b, name + "_conv2", stride, 1),
                                  name + "_bn3"))
                b = conv(b, name + "_conv3")
            else:
                b = torch.relu(bn(conv(act, name + "_conv1", stride, 1),
                                  name + "_bn2"))
                b = conv(b, name + "_conv2", 1, 1)
            h = b + (h if j > 0 else conv(act, name + "_sc", stride))
    h = torch.relu(bn(h, "bn1")).mean(dim=(2, 3))
    logits = F.linear(h, p["fc1_weight"], p["fc1_bias"])
    return F.cross_entropy(logits, y.long()), stats


def resnet_kind(op: str) -> str:
    """The class of an operator's device time in the ResNet step, by the
    name of the (innermost) aten op that launched the kernels."""
    low = op.lower()
    if "convolution_backward" in low or "conv_backward" in low:
        return "conv backward"
    if "conv" in low:
        return "conv forward"
    if "batch_norm" in low:
        return "BatchNorm"
    if "pool" in low:
        return "pooling"
    if "_foreach" in low:
        return "optimizer"
    if any(w in low for w in ("::mm", "addmm", "matmul", "linear")):
        return "fc (cuBLAS)"
    return "elementwise"


def resnet_breakdown(torch, prof, wall, what, kind_of=resnet_kind):
    """Device time by kind (``kind_of``; for ResNet conv forward, conv
    backward, BatchNorm, elementwise, pooling, optimizer, fc): each
    kernel counted under the innermost aten op that launched it; and the
    idle share."""
    rows, busy_ms = device_breakdown(torch, prof, wall, what)
    by_kind = {}
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CPU and \
                e.key.startswith("aten::") and e.self_device_time_total:
            kind = kind_of(e.key)
            by_kind[kind] = by_kind.get(kind, 0.0) + \
                e.self_device_time_total / 1e3
    unattributed = busy_ms - sum(by_kind.values())
    log("%s device time by kind: %s; not under an aten op %.3f ms"
        % (what, ", ".join("%s %.3f ms (%.1f%%)"
                           % (k, v, 100 * v / max(busy_ms, 1e-9))
                           for k, v in sorted(by_kind.items(),
                                              key=lambda kv: -kv[1])),
           unattributed))
    return by_kind, busy_ms


def train_resnet(torch, np, counters, warm, timed, what):
    """Module on the zoo's ResNet at bench.py's configuration, under
    whatever amp state the caller set, on one fixed RandomState(0)
    batch: the first step (bind included) timed, ``warm`` steps,
    ``timed`` steps between CUDA events, then one under torch.profiler.
    The flash-attention ``counters`` are zeroed just before the first
    step and read after the last timed one. Returns the readings, with
    the plain f32 forward's step-1 cross-entropy and batch statistics,
    the initial and the step-1 moving statistics."""
    from torch.profiler import ProfilerActivity, profile
    import mxnet_tpu_torch as mt
    from mxnet_tpu_torch.models import resnet
    B, S = RESNET_BATCH, RESNET_IMAGE
    dev = torch.device(DEVICE)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    sym = resnet.get_symbol(num_classes=RESNET_CLASSES,
                            num_layers=RESNET_LAYERS, stem="s2d",
                            image_shape="3,%d,%d" % (S, S))
    mod = mt.mod.Module(sym, context=mt.gpu(0))
    mod.bind(data_shapes=[("data", (B, 3, S, S))],
             label_shapes=[("softmax_label", (B,))])
    mod.init_params(mt.init.Xavier(rnd_type="gaussian", factor_type="in",
                                   magnitude=2).set_rng(
                                       np.random.default_rng(SEED)))
    mod.init_optimizer(optimizer="sgd", optimizer_params={
        "learning_rate": RESNET_LR, "momentum": RESNET_MOMENTUM,
        "wd": RESNET_WD})
    torch.cuda.synchronize()
    bind_s = time.perf_counter() - t0
    args, aux = mod.get_params()
    n_args, n_aux = len(args), len(aux)
    aux0 = {n: a.data.clone() for n, a in aux.items()}
    rng = np.random.RandomState(0)
    x = rng.uniform(-1, 1, (B, 3, S, S)).astype(np.float32)
    y = rng.randint(0, RESNET_CLASSES, (B,)).astype(np.float32)
    db = mt.io.DataBatch(data=[mt.nd.array(x, ctx=dev)],
                         label=[mt.nd.array(y, ctx=dev)])
    y_col = torch.from_numpy(y).to(dev).long().view(-1, 1)
    with torch.no_grad():
        ce, stats = plain_resnet(torch, {n: a.data for n, a in args.items()},
                                 torch.from_numpy(x).to(dev),
                                 torch.from_numpy(y).to(dev))
        want = ce.item()
        stats = {n: (m.double().cpu().numpy(), v.double().cpu().numpy())
                 for n, (m, v) in stats.items()}
    del args
    torch.cuda.empty_cache()

    def step():
        mod._fit_step(db)
        out = mod.get_outputs()[0].data
        return -(out.gather(1, y_col) + 1e-12).log().mean()

    # the main path: counters zeroed just before, read just after
    for fn in counters.values():
        fn.launches = {"f32": 0, "bf16": 0}
    t0 = time.perf_counter()
    losses = [step()]
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    aux1 = {n: a.data.double().cpu().numpy()
            for n, a in mod.get_params()[1].items()}
    for _ in range(warm):
        losses.append(step())
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(timed):
        losses.append(step())
    end.record()
    torch.cuda.synchronize()
    step_ms = start.elapsed_time(end) / timed
    launches = {n: dict(fn.launches) for n, fn in counters.items()}
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    by_kind, busy_ms = resnet_breakdown(torch, prof, wall, what)
    losses = [float(v) for v in torch.stack(losses).cpu()]
    del mod, db
    gc.collect()
    torch.cuda.empty_cache()
    return {"losses": losses, "want": want, "stats": stats,
            "aux0": {n: a.double().cpu().numpy() for n, a in aux0.items()},
            "aux1": aux1, "n_args": n_args, "n_aux": n_aux,
            "step_ms": step_ms, "bind_s": bind_s, "first_s": first_s,
            "timed": timed, "launches": launches, "peak_gb": peak_gb,
            "busy_ms": busy_ms, "wall_ms": wall * 1e3, "by_kind": by_kind}


def check_resnet_stats(np, what, run, rtol):
    """The moving statistics committed by step 1 against the plain
    forward's batch statistics blended by the momentum, every channel
    of every BatchNorm: the mean within ``rtol`` of the batch's standard
    deviation, the variance within ``rtol`` of itself, each plus
    RESNET_STATS_ATOL."""
    m = RESNET_MOMENTUM
    worst, worst_rel, where = 0.0, 0.0, None
    for name, (mean, var) in run["stats"].items():
        implied = {}
        for stat in ("moving_mean", "moving_var"):
            key = "%s_%s" % (name, stat)
            check(key in run["aux1"], "%s: no aux state %s" % (what, key))
            implied[stat] = (run["aux1"][key] -
                             m * run["aux0"][key]) / (1 - m)
        for got, want, scale in ((implied["moving_mean"], mean,
                                  np.sqrt(var)),
                                 (implied["moving_var"], var, var)):
            err = np.abs(got - want)
            ratio = float((err / (rtol * scale + RESNET_STATS_ATOL)).max())
            if ratio > worst:
                worst, where = ratio, name
            worst_rel = max(worst_rel, float((err / (scale + 1e-12)).max()))
    log("%s: step-1 moving statistics of %d BatchNorms against the plain "
        "forward's batch statistics blended by momentum %g: largest error "
        "%.3g of the batch std / var; %.3g of the tolerance (rtol %g, atol "
        "%g; at %s)" % (what, len(run["stats"]), m, worst_rel, worst, rtol,
                        RESNET_STATS_ATOL, where))
    check(worst <= 1.0, "%s: moving statistics of %s off by %.3g of the "
          "tolerance (rtol %g of the batch std / var, atol %g)"
          % (what, where, worst, rtol, RESNET_STATS_ATOL))


def check_resnet(np, what, run, ce_tol, stats_rtol, peak_flops,
                 peak_name):
    """Log a ResNet run's readings and hold it to the path: finite
    losses that fall, the step-1 cross-entropy within ``ce_tol`` of the
    plain forward's, the moving statistics, the reference's parameter
    count, and no flash-attention launch."""
    losses, want = run["losses"], run["want"]
    img_s = RESNET_BATCH / (run["step_ms"] / 1e3)
    log("%s: ResNet-%d v2 s2d, batch %d, %dx%d: bind %.3f s, first step "
        "%.3f s; step %.3f ms (%d steps between CUDA events) = %.1f img/s; "
        "MFU %.4f of %.0f TFLOP/s %s (%.3f GFLOP per image by bench.py's "
        "accounting); peak memory %.3f GB; device busy %.3f of %.3f ms "
        "profiled (idle share %.3f); %d arg and %d aux arrays"
        % (what, RESNET_LAYERS, RESNET_BATCH, RESNET_IMAGE, RESNET_IMAGE,
           run["bind_s"], run["first_s"], run["step_ms"], run["timed"],
           img_s, img_s * RESNET_FLOPS_PER_IMG / peak_flops,
           peak_flops / 1e12, peak_name, RESNET_FLOPS_PER_IMG / 1e9,
           run["peak_gb"], run["busy_ms"], run["wall_ms"],
           1 - run["busy_ms"] / max(run["wall_ms"], 1e-9), run["n_args"],
           run["n_aux"]))
    log("%s: loss per step %s" % (what, " ".join("%.6f" % v for v in losses)))
    log("%s: step-1 cross-entropy %.6f, plain f32 forward (7x7 stem) %.6f "
        "(|diff| %.3g, tolerance %g); flash-attention launches %s"
        % (what, losses[0], want, abs(losses[0] - want), ce_tol,
           run["launches"]))
    check(all(math.isfinite(v) for v in losses), "%s: non-finite loss %s"
          % (what, losses))
    check(losses[-1] < losses[0], "%s: loss did not fall: %s"
          % (what, losses))
    check(abs(losses[0] - want) <= ce_tol, "%s: step-1 loss %g vs plain "
          "forward %g" % (what, losses[0], want))
    check_resnet_stats(np, what, run, stats_rtol)
    if RESNET_LAYERS == 50:
        check((run["n_args"], run["n_aux"]) == (157, 102),
              "%s: %d arg and %d aux arrays, the reference has 157 and 102"
              % (what, run["n_args"], run["n_aux"]))
    for name, n in run["launches"].items():
        check(n == {"f32": 0, "bf16": 0}, "%s: flash-attention kernel %s "
              "launched %s times in a ResNet step" % (what, name, n))


def resnet_phase(torch, np):
    """ResNet-50 through Module at bench.py's configuration: amp bf16,
    then amp off (the reference's default) with f32 convolutions in full
    float32 (TF32 off in cuDNN and cuBLAS)."""
    import mxnet_tpu_torch as mt
    from mxnet_tpu_torch.ops import flash_attention as fa
    counters = {"flash_attention_fwd": fa.flash_attention_fwd,
                "flash_attention_bwd_dq": fa.flash_attention_bwd_dq,
                "flash_attention_bwd_dkv": fa.flash_attention_bwd_dkv}
    check(not torch.backends.cudnn.allow_tf32 and
          not torch.backends.cuda.matmul.allow_tf32,
          "TF32 is allowed: the plain forward would not be float32")
    mt.amp.init("bfloat16")
    try:
        run = train_resnet(torch, np, counters, RESNET_WARM, RESNET_TIMED,
                           "resnet")
    finally:
        mt.amp.off()
    check_resnet(np, "resnet", run, RESNET_CE_TOL, RESNET_STATS_RTOL,
                 PEAK_BF16_FLOPS, "bf16")
    run = train_resnet(torch, np, counters, RESNET_F32_WARM,
                       RESNET_F32_TIMED, "resnet f32")
    check_resnet(np, "resnet f32", run, RESNET_F32_CE_TOL,
                 RESNET_F32_STATS_RTOL, PEAK_FP32_FLOPS, "f32")


# ----------------------------------------------------- the Gluon slice

def tape_attention_check(torch, np):
    """The imperative tape drives the attention kernels: a HybridBlock
    calling ``F.FlashAttention(q, k, v, causal=True)`` at B 2, H 4, S
    512, D 128, under ``autograd.record()`` and ``backward()``, in bf16
    and f32. K1, K2 and K3 must each launch once per pass (in the input
    dtype), the output must match ``flash_attention_reference`` and the
    gradients ``flash_attention_backward_reference`` (bf16: the BF16_*
    limits; f32: KERNEL_ATOL max(1, max|ref|))."""
    import mxnet_tpu_torch as mt
    from mxnet_tpu_torch import autograd, gluon
    from mxnet_tpu_torch.ops import flash_attention as fa
    counters = {"flash_attention_fwd": fa.flash_attention_fwd,
                "flash_attention_bwd_dq": fa.flash_attention_bwd_dq,
                "flash_attention_bwd_dkv": fa.flash_attention_bwd_dkv}

    class Attention(gluon.HybridBlock):
        def hybrid_forward(self, F, q, k, v):
            return F.FlashAttention(q, k, v, causal=True)

    block = Attention(prefix="tape_attention_")
    block.hybridize()
    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(SEED + 11)
    B, H, S, D = TAPE_ATTENTION_SHAPE
    for dtype, key in ((torch.bfloat16, "bf16"), (torch.float32, "f32")):
        q, k, v, do = (torch.randn((B, H, S, D), generator=gen, device=dev)
                       .to(dtype) for _ in range(4))
        arrays = [mt.nd.NDArray(t.clone()) for t in (q, k, v)]
        for a in arrays:
            a.attach_grad()
        before = {n: dict(fn.launches) for n, fn in counters.items()}
        with autograd.record():
            out = block(*arrays)
        out.backward(mt.nd.NDArray(do))
        torch.cuda.synchronize()
        rose = {n: {s: fn.launches[s] - before[n][s] for s in fn.launches}
                for n, fn in counters.items()}
        want_rose = {s: int(s == key) for s in ("f32", "bf16")}
        check(all(r == want_rose for r in rose.values()),
              "tape attention %s: launches rose by %s, one of each kernel "
              "expected" % (key, rose))
        flat = [t.reshape(B * H, S, D) for t in (q, k, v, do)]
        scale = D ** -0.5
        o_r, lse_r = fa.flash_attention_reference(*flat[:3], scale, True)
        grads_r = fa.flash_attention_backward_reference(
            *flat[:3], o_r, lse_r, flat[3], scale, True)
        pairs = [("o", out.data, o_r)] + [
            (nm, a.grad.data, g) for nm, a, g in zip(("dq", "dk", "dv"),
                                                     arrays, grads_r)]
        for nm, got, want in pairs:
            got = got.reshape(want.shape)
            if key == "bf16":
                r = bf16_compare(got, want)
                log("tape attention bf16 %s: max err %.3g (max|ref| %.3g), "
                    "norm ratio %.3g, element excess %.3g rms"
                    % (nm, r["err"], r["top"], r["rel"], r["over"]))
                check(r["ok"], "tape attention bf16 %s disagrees with the "
                      "plain version: %s" % (nm, r))
            else:
                err = (got - want).abs().max().item()
                lim = KERNEL_ATOL * max(1.0, want.abs().max().item())
                log("tape attention f32 %s: max err %.3g (limit %.3g)"
                    % (nm, err, lim))
                check(err <= lim, "tape attention f32 %s: error %.3g over "
                      "%.3g" % (nm, err, lim))
        log("tape attention %s: B %d H %d S %d D %d causal under "
            "autograd.record(): launches %s" % (key, B, H, S, D, rose))
        del q, k, v, do, arrays, out, flat, o_r, lse_r, grads_r, pairs
    torch.cuda.empty_cache()


def deconvolution_check(torch, np):
    """``nn.Conv2DTranspose`` at a DCGAN generator's shape (batch 64,
    512 -> 256 channels, kernel 4, stride 2, pad 1, 8x8 -> 16x16), one
    forward and backward on the card (cuDNN, through ``Deconvolution``),
    against a plain f32 ``conv_transpose2d`` of the same weight with
    TF32 off: output and input / weight / bias gradients within
    DECONV_RTOL of each one's largest magnitude."""
    import torch.nn.functional as F
    import mxnet_tpu_torch as mt
    from mxnet_tpu_torch import autograd, gluon
    dev = torch.device(DEVICE)
    N, CIN, COUT, HW = DECONV_SHAPE
    layer = gluon.nn.Conv2DTranspose(COUT, 4, strides=2, padding=1,
                                     in_channels=CIN, prefix="dcgan_g_")
    layer.initialize(mt.init.Normal(0.02).set_rng(
        np.random.default_rng(SEED + 12)), ctx=mt.gpu(0))
    gen = torch.Generator(device=dev).manual_seed(SEED + 13)
    x, head = (torch.randn(s, generator=gen, device=dev)
               for s in ((N, CIN, HW, HW), (N, COUT, 2 * HW, 2 * HW)))
    xa = mt.nd.NDArray(x.clone())
    xa.attach_grad()
    with autograd.record():
        out = layer(xa)
    out.backward(mt.nd.NDArray(head))
    w = layer.weight.data().data.detach().clone().requires_grad_(True)
    b = layer.bias.data().data.detach().clone().requires_grad_(True)
    xr = x.clone().requires_grad_(True)
    ref = F.conv_transpose2d(xr, w, b, stride=2, padding=1)
    ref.backward(head)
    torch.cuda.synchronize()
    for nm, got, want in (("output", out.data, ref),
                          ("d data", xa.grad.data, xr.grad),
                          ("d weight", layer.weight.grad().data, w.grad),
                          ("d bias", layer.bias.grad().data, b.grad)):
        err = (got - want).abs().max().item()
        lim = DECONV_RTOL * want.abs().max().item()
        log("deconvolution %s: max err %.3g (limit %.3g)" % (nm, err, lim))
        check(tuple(got.shape) == tuple(want.shape) and err <= lim,
              "Conv2DTranspose %s %s vs plain %s: error %.3g over %.3g"
              % (nm, tuple(got.shape), tuple(want.shape), err, lim))
    t = timing(torch, lambda: layer(xa))
    log("deconvolution: Conv2DTranspose(%d -> %d, 4, 2, 1) on %dx%dx%dx%d "
        "forward %.4f ms (window medians, spread %s)"
        % (CIN, COUT, N, CIN, HW, HW, t["ms"], spread(t)))
    del layer, x, head, xa, out, w, b, xr, ref
    torch.cuda.empty_cache()


def plain_resnet_v1(torch, net, x, y):
    """The zoo's ResNet v1 training forward (``BottleneckV1`` at 50
    layers, ``BasicBlockV1`` at 18; 7x7/2 stem and 3x3/2 max pool) in plain float32 torch.nn.functional,
    written from ``gluon/model_zoo/vision/resnet.py`` and independent of
    the port's ops and dispatch: it reads only the parameter tensors,
    walking the blocks in the order the zoo builds them. Every BatchNorm
    normalises with the batch statistics (biased variance). Returns the
    mean cross-entropy, each BatchNorm's (mean, var) by block name, and
    the multiply-adds per image of the convolutions and the dense
    layer."""
    import torch.nn.functional as F
    stats = {}
    macs = [0]

    def val(p):
        return None if p is None else p.data().data

    def bn(h, blk):
        var, mean = torch.var_mean(h, dim=(0, 2, 3), unbiased=False)
        stats[blk.name] = (mean, var)
        scale = (val(blk.gamma) * torch.rsqrt(var + GLUON_EPS)).view(
            1, -1, 1, 1)
        return (h - mean.view(1, -1, 1, 1)) * scale + \
            val(blk.beta).view(1, -1, 1, 1)

    def conv(h, blk, stride, pad):
        w = val(blk.weight)
        out = F.conv2d(h, w, val(blk.bias), stride=stride, padding=pad)
        macs[0] += out[0].numel() * w[0].numel()
        return out

    feats = net.features._children
    h = torch.relu(bn(conv(x, feats[0], 2, 3), feats[1]))
    h = F.max_pool2d(h, 3, 2, 1)
    for i, stage in enumerate(feats[4:8]):
        for j, unit in enumerate(stage._children):
            stride = 2 if i > 0 and j == 0 else 1
            body = unit.body._children
            if len(body) == 8:      # BottleneckV1: 1x1/s, 3x3, 1x1
                b = torch.relu(bn(conv(h, body[0], stride, 0), body[1]))
                b = torch.relu(bn(conv(b, body[3], 1, 1), body[4]))
                b = bn(conv(b, body[6], 1, 0), body[7])
            else:                   # BasicBlockV1: 3x3/s, 3x3
                b = torch.relu(bn(conv(h, body[0], stride, 1), body[1]))
                b = bn(conv(b, body[3], 1, 1), body[4])
            if unit.downsample is not None:
                ds = unit.downsample._children
                h = bn(conv(h, ds[0], stride, 0), ds[1])
            h = torch.relu(b + h)
    h = h.mean(dim=(2, 3))
    w = val(net.output.weight)
    macs[0] += w.numel()
    logits = F.linear(h, w, val(net.output.bias))
    return F.cross_entropy(logits, y.long()), stats, macs[0]


def train_gluon(torch, np, counters, warm, timed, what, eager_check):
    """Gluon's ResNet-50 v1 (``vision.get_model("resnet50_v1")``,
    hybridized) on one fixed RandomState(0) batch, as the reference's
    Gluon example trains it: ``autograd.record()`` around the loss,
    ``backward()``, ``Trainer.step``. Setup (construction, the seeded
    initializer, deferred init by ``infer_shape``) is timed, then the
    first step, ``warm`` steps, ``timed`` steps between CUDA events, one
    under torch.profiler, then one and ``timed`` more un-hybridized.
    The flash-attention ``counters`` are zeroed just before the first
    step and read after the last timed one. With ``eager_check``, one
    step hybridized and one un-hybridized, each from the initial
    parameters with cuDNN's deterministic algorithms (its default f32
    weight gradients sum with atomics, in another order each call), are
    held against each other: the loss and every gradient."""
    from torch.profiler import ProfilerActivity, profile
    import mxnet_tpu_torch as mt
    from mxnet_tpu_torch import autograd, gluon
    B, S = RESNET_BATCH, RESNET_IMAGE
    dev = torch.device(DEVICE)
    rng = np.random.RandomState(0)
    x_np = rng.uniform(-1, 1, (B, 3, S, S)).astype(np.float32)
    y_np = rng.randint(0, RESNET_CLASSES, (B,)).astype(np.float32)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    mt.random.seed(SEED)
    net = gluon.model_zoo.vision.get_model("resnet%d_v1" % RESNET_LAYERS,
                                           classes=RESNET_CLASSES)
    net.initialize(mt.init.Xavier(rnd_type="gaussian", factor_type="in",
                                  magnitude=2).set_rng(
                                      mt.random.derive_numpy_rng(
                                          "gluon_resnet50_v1")),
                   ctx=mt.gpu(0))
    net.hybridize()
    x = mt.nd.array(x_np, ctx=dev)
    y = mt.nd.array(y_np, ctx=dev)
    net.infer_shape(x)
    trainer = gluon.Trainer(net.collect_params(), "sgd", {
        "learning_rate": RESNET_LR, "momentum": RESNET_MOMENTUM,
        "wd": RESNET_WD})
    loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    params = net.collect_params()
    n_values = sum(p.data().size for p in params.values())
    n_trained = sum(p.data().size for p in params.values()
                    if p.grad_req != "null")
    init = {n: p.data().data.detach().clone() for n, p in params.items()}
    with torch.no_grad():
        ce, stats, macs = plain_resnet_v1(torch, net, x.data, y.data)
        want = ce.item()
        stats = {n: (m.double().cpu().numpy(), v.double().cpu().numpy())
                 for n, (m, v) in stats.items()}
    bns = [b for b in _blocks(net) if isinstance(b, gluon.nn.BatchNorm)]

    def aux(p_of):
        out = {}
        for blk in bns:
            out[blk.name + "_moving_mean"] = p_of(blk.running_mean)
            out[blk.name + "_moving_var"] = p_of(blk.running_var)
        return out

    aux0 = aux(lambda p: p.data().data.double().cpu().numpy())

    def step():
        with autograd.record():
            loss = loss_fn(net(x), y)
        loss.backward()
        trainer.step(B)
        return loss.data.detach().mean()

    for fn in counters.values():
        fn.launches = {"f32": 0, "bf16": 0}
    t0 = time.perf_counter()
    losses = [step()]
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    aux1 = aux(lambda p: p.data().data.double().cpu().numpy())

    def timed_steps():
        """``timed`` steps between CUDA events: (ms a step, each step's
        ms)."""
        events = [torch.cuda.Event(enable_timing=True)
                  for _ in range(timed + 1)]
        events[0].record()
        for ev in events[1:]:
            losses.append(step())
            ev.record()
        torch.cuda.synchronize()
        return (events[0].elapsed_time(events[-1]) / timed,
                [a.elapsed_time(b) for a, b in zip(events, events[1:])])

    for _ in range(warm):
        losses.append(step())
    torch.cuda.synchronize()
    step_ms, per_step = timed_steps()
    launches = {n: dict(fn.launches) for n, fn in counters.items()}
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        losses.append(step())
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    by_kind, busy_ms = resnet_breakdown(torch, prof, wall, what)
    # the same steps with the net un-hybridized (training goes on)
    net.hybridize(False)
    losses.append(step())
    eager_ms, eager_per_step = timed_steps()
    net.hybridize()
    losses = [float(v) for v in torch.stack(losses).cpu()]
    eager = None
    if eager_check:
        runs = []
        prev = torch.backends.cudnn.deterministic
        torch.backends.cudnn.deterministic = True
        try:
            for hybrid in (True, False):
                for n, p in params.items():
                    p.set_data(mt.nd.NDArray(init[n]))
                net.hybridize(hybrid)
                with autograd.record():
                    loss = loss_fn(net(x), y)
                loss.backward()
                runs.append((loss.data.mean().item(),
                             {n: p.grad().data.detach().clone()
                              for n, p in params.items()
                              if p.grad_req != "null"}))
        finally:
            torch.backends.cudnn.deterministic = prev
        torch.cuda.synchronize()
        (h_loss, hyb), (e_loss, eag) = runs
        worst, where = 0.0, None
        for n, g in hyb.items():
            e = eag[n]
            top = g.abs().max()
            if n.endswith("_bias") and "conv" in n:
                # a BatchNorm follows every v1 convolution: its bias has
                # no gradient in exact arithmetic, both sides hold only
                # rounding; scaled by its weight's gradient instead
                top = hyb[n[:-len("bias")] + "weight"].abs().max()
            r = ((e - g).abs().max() / top.clamp(min=1e-30)).item()
            if r > worst:
                worst, where = r, n
        eager = {"loss": e_loss, "hybrid_loss": h_loss, "worst": worst,
                 "where": where}
        del runs, hyb, eag
    del net, trainer, x, y, init, params
    gc.collect()
    torch.cuda.empty_cache()
    return {"losses": losses, "want": want, "stats": stats, "aux0": aux0,
            "aux1": aux1, "n_values": n_values, "n_trained": n_trained,
            "macs": macs,
            "step_ms": step_ms, "per_step": per_step, "eager_ms": eager_ms,
            "eager_per_step": eager_per_step, "setup_s": setup_s,
            "first_s": first_s, "timed": timed, "launches": launches,
            "peak_gb": peak_gb, "busy_ms": busy_ms, "wall_ms": wall * 1e3,
            "by_kind": by_kind, "eager": eager}


def _blocks(block):
    """Every block under ``block``, itself first, in construction
    order."""
    out = [block]
    for child in block._children:
        out.extend(_blocks(child))
    return out


def check_gluon(np, what, run, ce_tol, stats_rtol, peak_flops, peak_name):
    """Log a Gluon ResNet-50 v1 run's readings and hold it to the path:
    finite losses that fall, the step-1 cross-entropy within ``ce_tol``
    of the plain forward's, the running statistics, the eager step
    (when taken) within GLUON_EAGER_RTOL, and no flash-attention
    launch."""
    losses, want = run["losses"], run["want"]
    img_s = RESNET_BATCH / (run["step_ms"] / 1e3)
    flops = 3 * 2 * run["macs"]
    per = sorted(run["per_step"])
    log("%s: Gluon resnet%d_v1 (hybridized), batch %d, %dx%d, %d parameter "
        "values (%d with a gradient): setup %.3f s (construction, initializer, deferred init), "
        "first step %.3f s; step %.3f ms (%d steps between CUDA events; "
        "per step min %.3f median %.3f max %.3f) = %.1f img/s; MFU %.4f of "
        "%.0f TFLOP/s %s (%.3f GFLOP per image: 3 x 2 x %.4g multiply-adds "
        "counted from the layer shapes); peak memory %.3f GB; device busy "
        "%.3f of %.3f ms profiled (idle share %.3f)"
        % (what, RESNET_LAYERS, RESNET_BATCH, RESNET_IMAGE, RESNET_IMAGE,
           run["n_values"], run["n_trained"], run["setup_s"], run["first_s"], run["step_ms"], run["timed"],
           per[0], per[len(per) // 2], per[-1], img_s,
           img_s * flops / peak_flops, peak_flops / 1e12, peak_name,
           flops / 1e9, run["macs"], run["peak_gb"], run["busy_ms"],
           run["wall_ms"], 1 - run["busy_ms"] / max(run["wall_ms"], 1e-9)))
    eper = sorted(run["eager_per_step"])
    log("%s: the same net un-hybridized: step %.3f ms (%d steps between "
        "CUDA events; per step min %.3f median %.3f max %.3f) = %.1f img/s; "
        "hybridized / eager %.4f"
        % (what, run["eager_ms"], run["timed"], eper[0],
           eper[len(eper) // 2], eper[-1],
           RESNET_BATCH / (run["eager_ms"] / 1e3),
           run["step_ms"] / run["eager_ms"]))
    log("%s: loss per step %s" % (what, " ".join("%.6f" % v for v in losses)))
    log("%s: step-1 cross-entropy %.6f, plain f32 forward %.6f (|diff| "
        "%.3g, tolerance %g); flash-attention launches %s"
        % (what, losses[0], want, abs(losses[0] - want), ce_tol,
           run["launches"]))
    check(all(math.isfinite(v) for v in losses), "%s: non-finite loss %s"
          % (what, losses))
    check(losses[-1] < losses[0], "%s: loss did not fall: %s"
          % (what, losses))
    check(abs(losses[0] - want) <= ce_tol, "%s: step-1 loss %g vs plain "
          "forward %g" % (what, losses[0], want))
    check_resnet_stats(np, what, run, stats_rtol)
    if RESNET_LAYERS == 50:
        check(run["n_values"] == GLUON_RESNET50_V1_VALUES,
              "%s: %d parameter values, resnet50_v1 has %d"
              % (what, run["n_values"], GLUON_RESNET50_V1_VALUES))
    for name, n in run["launches"].items():
        check(n == {"f32": 0, "bf16": 0}, "%s: flash-attention kernel %s "
              "launched %s times in a ResNet step" % (what, name, n))
    eager = run["eager"]
    if eager is not None:
        dl = abs(eager["loss"] - eager["hybrid_loss"])
        log("%s: from the initial parameters, cuDNN deterministic: one "
            "eager step loss %.6f, one hybridized %.6f (|diff| %.3g; the "
            "timed run's step 1 %.6f); largest gradient difference %.3g "
            "of that gradient's max |value| (of its weight gradient's for "
            "a conv bias, zero in exact arithmetic; at %s; limit %g)"
            % (what, eager["loss"], eager["hybrid_loss"], dl, losses[0],
               eager["worst"], eager["where"], GLUON_EAGER_RTOL))
        check(dl <= GLUON_EAGER_RTOL * max(1.0, abs(eager["loss"])) and
              eager["worst"] <= GLUON_EAGER_RTOL,
              "%s: the eager step differs from the hybridized one: loss "
              "%.6f vs %.6f, gradient %.3g at %s"
              % (what, eager["loss"], eager["hybrid_loss"], eager["worst"],
                 eager["where"]))


def gluon_phase(torch, np):
    """The imperative API on the card: the tape drives the attention
    kernels, Conv2DTranspose at a DCGAN shape, then Gluon's ResNet-50
    v1 at the reference Gluon example's configuration, amp bf16 and then
    f32 (TF32 off) with the eager-vs-hybridized check."""
    import mxnet_tpu_torch as mt
    from mxnet_tpu_torch.ops import flash_attention as fa
    t0 = time.perf_counter()
    tape_attention_check(torch, np)
    deconvolution_check(torch, np)
    counters = {"flash_attention_fwd": fa.flash_attention_fwd,
                "flash_attention_bwd_dq": fa.flash_attention_bwd_dq,
                "flash_attention_bwd_dkv": fa.flash_attention_bwd_dkv}
    check(not torch.backends.cudnn.allow_tf32 and
          not torch.backends.cuda.matmul.allow_tf32 and
          not torch.backends.cudnn.benchmark,
          "TF32 or cudnn.benchmark is on: the checks need f32 convolutions "
          "and the same algorithms in both steps")
    mt.amp.init("bfloat16")
    try:
        run = train_gluon(torch, np, counters, RESNET_WARM, GLUON_TIMED,
                          "gluon", False)
    finally:
        mt.amp.off()
    check_gluon(np, "gluon", run, RESNET_CE_TOL, RESNET_STATS_RTOL,
                PEAK_BF16_FLOPS, "bf16")
    run = train_gluon(torch, np, counters, RESNET_F32_WARM,
                      RESNET_F32_TIMED, "gluon f32", True)
    check_gluon(np, "gluon f32", run, RESNET_F32_CE_TOL,
                RESNET_F32_STATS_RTOL, PEAK_FP32_FLOPS, "f32")
    log("gluon phase: %.1f s" % (time.perf_counter() - t0))


# ------------------------------------------------------------ phase 10

def plain_rnn(torch, mode, x, weights, h0, c0, bidir):
    """An independent per-step recurrence with the fused op's semantics,
    f32: ``weights`` holds (W_x, W_h, b_x, b_h) per layer and direction;
    gate orders LSTM i, f, g, o and GRU r, z, n with n = tanh(x_n + r *
    (W_hn h + b_hn)); the reverse direction runs from the last step.
    Returns (output, h_N, c_N or None)."""
    dirs = 2 if bidir else 1
    layers = len(weights) // dirs
    T = x.shape[0]
    inp, hs, cs = x, [], []
    for layer in range(layers):
        outs = []
        for d in range(dirs):
            k = layer * dirs + d
            wx, wh, bx, bh = weights[k]
            h, c = h0[k], (c0[k] if mode == "lstm" else None)
            gxs = inp @ wx.t() + bx          # every step's input term
            ys = [None] * T
            for t in (range(T) if d == 0 else reversed(range(T))):
                gx = gxs[t]
                gh = h @ wh.t() + bh
                if mode == "lstm":
                    i, f, g, o = (gx + gh).chunk(4, dim=1)
                    c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
                    h = torch.sigmoid(o) * torch.tanh(c)
                elif mode == "gru":
                    xr, xz, xn = gx.chunk(3, dim=1)
                    hr, hz, hn = gh.chunk(3, dim=1)
                    r = torch.sigmoid(xr + hr)
                    z = torch.sigmoid(xz + hz)
                    h = (1 - z) * torch.tanh(xn + r * hn) + z * h
                else:
                    pre = gx + gh
                    h = torch.tanh(pre) if mode == "rnn_tanh" \
                        else torch.relu(pre)
                ys[t] = h
            outs.append(torch.stack(ys))
            hs.append(h)
            cs.append(c)
        inp = torch.cat(outs, dim=2)
    return (inp, torch.stack(hs),
            torch.stack(cs) if mode == "lstm" else None)


def packed_weights(params, mode, layers, width, hidden, bidir):
    """The packed vector sliced in its documented order: every layer's
    and direction's W_x (G*H, in) and W_h (G*H, H), then every b_x, b_h
    (G*H): a list of (W_x, W_h, b_x, b_h) per layer and direction."""
    G = {"lstm": 4, "gru": 3, "rnn_tanh": 1, "rnn_relu": 1}[mode] * hidden
    dirs = 2 if bidir else 1
    off, mats = 0, []
    for layer in range(layers):
        cols = width if layer == 0 else hidden * dirs
        for _ in range(dirs):
            wx = params[off:off + G * cols].view(G, cols)
            off += G * cols
            wh = params[off:off + G * hidden].view(G, hidden)
            off += G * hidden
            mats.append((wx, wh))
    out = []
    for wx, wh in mats:
        out.append((wx, wh, params[off:off + G], params[off + G:off + 2 * G]))
        off += 2 * G
    check(off == params.numel(), "packed vector of %d values, layout needs "
          "%d" % (params.numel(), off))
    return out


def rnn_err(got, want):
    """max |got - want| over max(1, max |want|)."""
    return ((got.double() - want.double()).abs().max() /
            max(1.0, want.double().abs().max().item())).item()


def rel_err(got, want):
    """max |got - want| over max |want|: for values far below 1 (logits,
    states), where :func:`rnn_err`'s floor of 1 would hide a wrong
    model."""
    return ((got.double() - want.double()).abs().max() /
            want.double().abs().max().clamp_min(1e-30)).item()


def ran_under(prof):
    """Whether one of RNN_DEVICE_OPS appears among the profiled ops."""
    return any(e.key in RNN_DEVICE_OPS for e in prof.key_averages())


def fused_op_check(torch):
    """The fused RNN op (``ops/rnn_op.py``: cuDNN's RNN, f32; cuDNN's
    TF32 switch is on, torch's default, so the op's own guard must keep
    its forward and backward in f32) against :func:`plain_rnn` at the
    path's shapes: T 35, N 32, 2 layers,
    input = hidden = 1500 (LSTM, GRU, rnn_tanh) and 200 (LSTM, GRU), one
    and two directions: the output, h_N, c_N and the gradients of the
    data, the packed vector and the initial states, each within RNN_RTOL
    of the plain version's largest value. The op must run under
    one of RNN_DEVICE_OPS. Then, logged only, one LSTM case with the
    guard around the forward alone (autograd's backward outside it, as
    the op ran before the guard covered its backward): what TF32 in
    cuDNN's backward gives at this shape. Then, under amp bf16, whether
    cuDNN takes the op in bf16 (logged: it decides the word LM's bf16
    run)."""
    from torch.profiler import ProfilerActivity, profile
    import mxnet_tpu_torch as mt
    from mxnet_tpu_torch.ops.rnn_op import rnn, rnn_param_size
    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(SEED + 5)
    T, N, L = WORD_BPTT, WORD_BATCH, WORD_LAYERS
    t0 = time.perf_counter()
    worst = 0.0
    n_cases = 0
    unguarded_case = None       # the first one-direction LSTM case
    for hidden, modes in RNN_CASES:
        for mode in modes:
            for bidir in (False, True):
                t_case = time.perf_counter()
                dirs = 2 if bidir else 1
                size = rnn_param_size(L, hidden, hidden, mode, bidir)
                scale = 1.0 / math.sqrt(hidden)
                x = torch.rand((T, N, hidden), generator=gen, device=dev) \
                    * 2 - 1
                params = (torch.rand((size,), generator=gen, device=dev)
                          * 2 - 1) * scale
                h0 = torch.randn((L * dirs, N, hidden), generator=gen,
                                 device=dev) * 0.5
                c0 = torch.randn((L * dirs, N, hidden), generator=gen,
                                 device=dev) * 0.5
                ins = [x, params, h0] + ([c0] if mode == "lstm" else [])
                leaves = [t.clone().requires_grad_(True) for t in ins]
                with profile(activities=[ProfilerActivity.CPU]) as prof:
                    outs = rnn.fn(*leaves, state_size=hidden, num_layers=L,
                                  mode=mode, bidirectional=bidir,
                                  state_outputs=True, _is_train=True)
                check(ran_under(prof), "RNN %s %d bidir=%s did not run "
                      "under %s" % (mode, hidden, bidir, RNN_DEVICE_OPS))
                heads = [torch.randn(o.shape, generator=gen, device=dev)
                         for o in outs]
                grads = torch.autograd.grad(outs, leaves, heads)
                pleaves = [t.clone().requires_grad_(True) for t in ins]
                weights = packed_weights(pleaves[1], mode, L, hidden,
                                         hidden, bidir)
                pout, ph, pc = plain_rnn(
                    torch, mode, pleaves[0], weights, pleaves[2],
                    pleaves[3] if mode == "lstm" else None, bidir)
                pouts = [pout, ph] + ([pc] if mode == "lstm" else [])
                pgrads = torch.autograd.grad(pouts, pleaves, heads)
                errs = {}
                for name, g, w in zip(("output", "h_N", "c_N"), outs, pouts):
                    errs[name] = rnn_err(g.detach(), w.detach())
                for name, g, w in zip(("d data", "d parameters", "d h0",
                                       "d c0"), grads, pgrads):
                    errs[name] = rnn_err(g, w)
                bad = {k: v for k, v in errs.items() if v > RNN_RTOL}
                log("rnn op %s H %d %s: %s (%.2f s)" % (
                    mode, hidden, "bidirectional" if bidir else
                    "one direction", " ".join("%s %.2e" % kv
                                              for kv in errs.items()),
                    time.perf_counter() - t_case))
                check(not bad, "the fused RNN op (%s, H %d, bidirectional "
                      "%s) disagrees with the plain recurrence: %s (limit "
                      "%g of max(1, max|ref|))" % (mode, hidden, bidir, bad,
                                                   RNN_RTOL))
                worst = max(worst, max(errs.values()))
                n_cases += 1
                if (mode, bidir) == ("lstm", False) and \
                        unguarded_case is None:
                    unguarded_case = (ins, heads, pouts, pgrads)
                del leaves, pleaves, outs, grads, pouts, pgrads, weights
    unguarded_backward(torch, *unguarded_case)
    del unguarded_case
    # bf16: does cuDNN take it? (amp casts data, parameters and states)
    H = WORD_WIDTH
    size = rnn_param_size(L, H, H, "lstm")
    x = torch.rand((T, N, H), generator=gen, device=dev) * 2 - 1
    params = (torch.rand((size,), generator=gen, device=dev) * 2 - 1) / \
        math.sqrt(H)
    zeros = torch.zeros((L, N, H), device=dev)
    mt.amp.init("bfloat16")
    try:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            out = rnn.fn(x, params, zeros, zeros, state_size=H,
                         num_layers=L, mode="lstm")
            torch.cuda.synchronize()
    finally:
        mt.amp.off()
    bf16_cudnn = ran_under(prof) and out.dtype == torch.bfloat16
    want, _, _ = plain_rnn(torch, "lstm", x, packed_weights(
        params, "lstm", L, H, H, False), zeros, zeros, False)
    log("rnn op: %d cases within %g (worst %.2e) in %.1f s; amp bf16 LSTM "
        "H %d: output %s, under %s: %s, %.3g from the f32 plain recurrence"
        % (n_cases, RNN_RTOL, worst, time.perf_counter() - t0, H, out.dtype,
           RNN_DEVICE_OPS, ran_under(prof),
           rnn_err(out.float(), want)))
    del x, params, zeros, out, want
    gc.collect()
    torch.cuda.empty_cache()
    return bf16_cudnn


def unguarded_backward(torch, ins, heads, pouts, pgrads):
    """The 2-layer LSTM case of :func:`fused_op_check` with the precision
    guard around the forward only, autograd's backward (cuDNN's) run
    outside it with the global TF32 switch as it stands: its errors
    against the plain recurrence, logged."""
    from mxnet_tpu_torch import amp
    from mxnet_tpu_torch.ops import rnn_op
    x, params, h0, c0 = [t.clone().requires_grad_(True) for t in ins]
    T, N, H = x.shape
    L = h0.shape[0]
    weights, biases = rnn_op.rnn_unpack_params(params, L, H, H, "lstm")
    inp, hs, cs = x, [], []
    with amp.conv_precision(torch.float32):
        for k in range(L):
            inp, h, c = rnn_op._fused("lstm", inp, h0[k:k + 1], c0[k:k + 1],
                                      [*weights[k], *biases[k]], False, True)
            hs.append(h)
            cs.append(c)
    outs = [inp, torch.cat(hs), torch.cat(cs)]
    grads = torch.autograd.grad(outs, [x, params, h0, c0], heads)
    errs = {"output": rnn_err(outs[0].detach(), pouts[0].detach()),
            "d data": rnn_err(grads[0], pgrads[0]),
            "d parameters": rnn_err(grads[1], pgrads[1])}
    log("rnn op lstm H %d without the guard around its backward (cuDNN's "
        "TF32 switch %s): %s (the check's limit %g; logged only)"
        % (H, torch.backends.cudnn.allow_tf32,
           " ".join("%s %.2e" % kv for kv in errs.items()), RNN_RTOL))


def rnn_kind(op: str) -> str:
    """The class of an operator's device time in the recurrent steps, by
    the innermost aten op that launched the kernels."""
    low = op.lower()
    if "_cudnn_rnn_backward" in low:
        return "RNN backward"
    if "_cudnn_rnn" in low or any(m in low for m in (
            "::lstm", "::gru", "::rnn_tanh", "::rnn_relu")):
        return "RNN forward"
    if "_foreach" in low:
        return "optimizer"
    if any(w in low for w in ("::mm", "addmm", "matmul", "linear", "bmm")):
        return "GEMM (cuBLAS)"
    if "embedding" in low:
        return "embedding"
    return "elementwise"


def word_lm(mt, gluon):
    """The upstream example's model: embedding, dropout, a 2-layer LSTM
    with dropout between its layers, dropout, and a decoder that holds
    the embedding's weight (``params=encoder.params``)."""

    class RNNModel(gluon.Block):
        def __init__(self, **kw):
            super().__init__(**kw)
            with self.name_scope():
                self.drop = gluon.nn.Dropout(WORD_DROPOUT)
                self.encoder = gluon.nn.Embedding(
                    WORD_VOCAB, WORD_WIDTH,
                    weight_initializer=mt.init.Uniform(0.1).set_rng(
                        mt.random.derive_numpy_rng("word_lm_encoder")))
                self.rnn = gluon.rnn.LSTM(WORD_WIDTH, WORD_LAYERS,
                                          dropout=WORD_DROPOUT,
                                          input_size=WORD_WIDTH)
                self.decoder = gluon.nn.Dense(WORD_VOCAB,
                                              in_units=WORD_WIDTH,
                                              params=self.encoder.params)

        def forward(self, inputs, hidden):
            emb = self.drop(self.encoder(inputs))
            output, hidden = self.rnn(emb, hidden)
            output = self.drop(output)
            return self.decoder(output.reshape((-1, WORD_WIDTH))), hidden

    return RNNModel(prefix="wordlm_")


def plain_word_lm(torch, model, x):
    """An independent f32 forward of the word LM's weights with dropout
    off and zero initial states: the embedding rows, :func:`plain_rnn`
    per layer, the tied decoder. Returns the logits and the final h and
    c of every layer."""
    p = {n[len("wordlm_"):]: q.data().data.detach().float()
         for n, q in model.collect_params().items()}
    weight = p["embedding0_weight"]
    emb = weight[x.long()]
    layers = [tuple(p["lstm0_l%d_%s" % (k, part)] for part in (
        "i2h_weight", "h2h_weight", "i2h_bias", "h2h_bias"))
        for k in range(WORD_LAYERS)]
    zeros = torch.zeros((WORD_LAYERS, x.shape[1], WORD_WIDTH),
                        device=x.device)
    out, h, c = plain_rnn(torch, "lstm", emb, layers, zeros, zeros, False)
    logits = out.reshape(-1, WORD_WIDTH) @ weight.t() + \
        p["embedding0_bias"]
    return logits, h, c


def train_word_lm(torch, np, counters, warm, timed, what):
    """The word LM as the repo's twin (``examples/word_language_model.py``)
    trains it: truncated BPTT over consecutive segments of one token
    stream, ``detach`` of the carried states, ``autograd.record()``,
    ``backward()``, ``clip_global_norm(grads, clip x bptt x batch)`` and
    ``Trainer.step(bptt x batch)``. Step 1 runs with dropout off (its
    loss is held to :func:`plain_word_lm`), the others in training mode:
    ``warm`` steps, ``timed`` between CUDA events, one under
    torch.profiler. After them the first segment's dropout-off loss
    from zero states must be lower than step 1's."""
    from torch.profiler import ProfilerActivity, profile
    import mxnet_tpu_torch as mt
    from mxnet_tpu_torch import autograd, gluon
    dev = torch.device(DEVICE)
    B, T = WORD_BATCH, WORD_BPTT
    n_steps = 1 + warm + timed + 1
    tokens = np.random.RandomState(0).randint(
        0, WORD_VOCAB, (T * n_steps + 1, B)).astype(np.float32)
    stream = mt.nd.array(tokens, ctx=dev)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    mt.random.seed(SEED)
    model = word_lm(mt, gluon)
    model.initialize(mt.init.Xavier().set_rng(
        mt.random.derive_numpy_rng("word_lm")), ctx=mt.gpu(0))
    params = model.collect_params()
    trainer = gluon.Trainer(params, "sgd", {"learning_rate": WORD_LR,
                                            "momentum": 0, "wd": 0})
    loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    check(model.decoder.weight is model.encoder.weight,
          "%s: the decoder does not hold the embedding's weight" % what)
    n_values = sum(q.data().size for q in params.values())
    seg = [(stream[i * T:(i + 1) * T], stream[i * T + 1:(i + 1) * T + 1])
           for i in range(n_steps)]
    with torch.no_grad():
        ref = plain_word_lm(torch, model, seg[0][0].data)
        want = torch.nn.functional.cross_entropy(
            ref[0], seg[0][1].data.reshape(-1).long()).item()
    state = {"hidden": model.rnn.begin_state(batch_size=B, ctx=dev)}

    def f32_ce(out, y):
        # the cross-entropy of the model's logits taken in f32: under amp
        # the loss itself is bf16 (as in the reference), 2^-4 apart at 9
        return torch.nn.functional.cross_entropy(
            out.data.detach().float(), y.data.reshape(-1).long()).item()

    def step(i, train=True):
        x, y = seg[i]
        hidden = [h.detach() for h in state["hidden"]]
        with autograd.record(train_mode=train):
            out, state["hidden"] = model(x, hidden)
            loss = loss_fn(out, y.reshape((-1,)))
        loss.backward()
        grads = [q.grad() for q in params.values() if q.grad_req != "null"]
        gluon.utils.clip_global_norm(grads, WORD_CLIP * T * B)
        trainer.step(T * B)
        state["out"] = out
        return loss.data.detach().float().mean()

    for fn in counters.values():
        fn.launches = {"f32": 0, "bf16": 0}
    t0 = time.perf_counter()
    losses = [step(0, train=False)]
    out = state.pop("out")
    first = f32_ce(out, seg[0][1])
    step1 = {name: rel_err(got.data.detach().float(), want_t)
             for name, got, want_t in zip(("logits", "h_N", "c_N"),
                                          [out, *state["hidden"]], ref)}
    del out, ref
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    for i in range(warm):
        losses.append(step(1 + i))
    torch.cuda.synchronize()
    events = [torch.cuda.Event(enable_timing=True) for _ in range(timed + 1)]
    events[0].record()
    for i, ev in enumerate(events[1:]):
        losses.append(step(1 + warm + i))
        ev.record()
    torch.cuda.synchronize()
    per_step = [a.elapsed_time(b) for a, b in zip(events, events[1:])]
    launches = {n: dict(fn.launches) for n, fn in counters.items()}
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        losses.append(step(n_steps - 1))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    _, busy_ms = resnet_breakdown(torch, prof, wall, what, rnn_kind)
    with autograd.predict_mode():
        out, _ = model(seg[0][0], model.rnn.begin_state(batch_size=B,
                                                        ctx=dev))
    after = f32_ce(out, seg[0][1])
    losses = [float(v) for v in torch.stack(losses).cpu()]
    del model, trainer, params, seg, stream, state
    gc.collect()
    torch.cuda.empty_cache()
    # per token: each LSTM layer 2 x 4H(I + H), the decoder 2 x H x V;
    # forward and backward 3x
    flops = 3 * B * T * (WORD_LAYERS * 2 * 4 * WORD_WIDTH * 2 * WORD_WIDTH
                         + 2 * WORD_WIDTH * WORD_VOCAB)
    return {"losses": losses, "want": want, "first": first, "after": after,
            "step1": step1, "per_step": per_step, "setup_s": setup_s, "first_s": first_s,
            "launches": launches, "peak_gb": peak_gb, "busy_ms": busy_ms,
            "wall_ms": wall * 1e3, "flops": flops,
            "n_values": n_values, "timed": timed}


def check_word_lm(what, run, ce_tol, rtol, peak_flops, peak_name):
    losses, per = run["losses"], sorted(run["per_step"])
    step_ms = per[len(per) // 2]
    tok_s = WORD_BATCH * WORD_BPTT / (step_ms / 1e3)
    log("%s: word LM (tied %dx%d, %d LSTM layers, dropout %g), batch %d x "
        "bptt %d, %d parameter values: setup %.3f s, first step %.3f s; "
        "step %.3f ms (median of %d steps between CUDA events; min %.3f "
        "max %.3f) = %.0f tok/s; MFU %.4f of %.0f TFLOP/s %s (%.1f GFLOP "
        "a step counted from the shapes); peak memory %.3f GB; device busy "
        "%.3f of %.3f ms profiled (idle share %.3f)"
        % (what, WORD_VOCAB, WORD_WIDTH, WORD_LAYERS, WORD_DROPOUT,
           WORD_BATCH, WORD_BPTT, run["n_values"], run["setup_s"],
           run["first_s"], step_ms, run["timed"], per[0], per[-1], tok_s,
           tok_s / (WORD_BATCH * WORD_BPTT) * run["flops"] / peak_flops,
           peak_flops / 1e12, peak_name, run["flops"] / 1e9, run["peak_gb"],
           run["busy_ms"], run["wall_ms"],
           1 - run["busy_ms"] / max(run["wall_ms"], 1e-9)))
    log("%s: loss per step %s" % (what, " ".join("%.6f" % v
                                                 for v in losses)))
    first = run["first"]
    log("%s: step-1 cross-entropy (dropout off, the logits' in f32) %.6f, "
        "plain f32 forward %.6f (|diff| %.3g, tolerance %g); the first "
        "segment after the steps %.6f; flash-attention launches %s"
        % (what, first, run["want"], abs(first - run["want"]), ce_tol,
           run["after"], run["launches"]))
    check(all(math.isfinite(v) for v in losses), "%s: non-finite loss %s"
          % (what, losses))
    log("%s: step-1 logits and final states (dropout off) against the "
        "plain f32 forward: %s of max|ref| (limit %g)"
        % (what, " ".join("%s %.2e" % kv for kv in run["step1"].items()),
           rtol))
    check(abs(first - run["want"]) <= ce_tol, "%s: step-1 loss %g vs "
          "plain forward %g" % (what, first, run["want"]))
    bad = {k: v for k, v in run["step1"].items() if not v <= rtol}
    check(not bad, "%s: the step-1 forward disagrees with the plain f32 "
          "forward: %s (limit %g of max|ref|)" % (what, bad, rtol))
    check(run["after"] < first, "%s: the loss did not fall: %g after the "
          "steps, %g at step 1" % (what, run["after"], first))
    for name, n in run["launches"].items():
        check(n == {"f32": 0, "bf16": 0}, "%s: flash-attention kernel %s "
              "launched %s times in a recurrent step" % (what, name, n))


def bucket_sentences(np):
    """Sentences over BUCKET_VOCAB words (ids 1.., 0 is padding) at
    lengths that fill every bucket with BUCKET_BATCHES batches: for each
    bucket, lengths from just above the one below up to its own."""
    rng = np.random.RandomState(SEED)
    out, lo = [], 1
    for b in BUCKETS:
        for _ in range(BUCKET_BATCHES * BUCKET_BATCH):
            n = int(rng.randint(lo, b + 1))
            out.append([int(t) for t in rng.randint(1, BUCKET_VOCAB, n)])
        lo = b + 1
    return out


def bucket_sym_gen(mt, fused=False, head=True):
    """The upstream lstm_bucketing.py graph per bucket length: embedding,
    a stack of LSTMCells unrolled (or one FusedRNNCell with the same
    parameters), the decoder, SoftmaxOutput ignoring padding (with
    ``head`` off, the graph ends at the decoder's logits)."""
    if fused:
        cell = mt.rnn.FusedRNNCell(BUCKET_WIDTH, num_layers=BUCKET_LAYERS,
                                   mode="lstm", prefix="lstm_")
    else:
        cell = mt.rnn.SequentialRNNCell()
        for i in range(BUCKET_LAYERS):
            cell.add(mt.rnn.LSTMCell(num_hidden=BUCKET_WIDTH,
                                     prefix="lstm_l%d_" % i))

    def sym_gen(seq_len):
        data = mt.sym.Variable("data")
        label = mt.sym.Variable("softmax_label")
        embed = mt.sym.Embedding(data, input_dim=BUCKET_VOCAB,
                                 output_dim=BUCKET_WIDTH, name="embed")
        cell.reset()
        outputs, _ = cell.unroll(seq_len, inputs=embed, merge_outputs=True)
        pred = mt.sym.Reshape(outputs, shape=(-1, BUCKET_WIDTH))
        pred = mt.sym.FullyConnected(pred, num_hidden=BUCKET_VOCAB,
                                     name="pred")
        if not head:
            return pred, ("data",), ()
        lab = mt.sym.Reshape(label, shape=(-1,))
        pred = mt.sym.SoftmaxOutput(pred, lab, use_ignore=True,
                                    ignore_label=0, normalization="valid",
                                    name="softmax")
        return pred, ("data",), ("softmax_label",)

    return cell, sym_gen


def bucket_phase(torch, np, counters):
    """The bucketing LM: ``BucketingModule.fit`` for one epoch over a
    seeded ``BucketSentenceIter`` (BUCKET_BATCHES batches in each of the
    six buckets, the unrolled LSTMCell stack), then per bucket
    BUCKET_TIMED steps between CUDA events and the host's time per step,
    one profiled step at the largest bucket, and the same weights
    through FusedRNNCell (``unpack_weights`` / ``pack_weights``),
    forward only, against the unrolled graph. Every bucket's module must
    hold the default bucket's parameter tensors (by identity and
    ``data_ptr``); the perplexity over the epoch's batches after the
    epoch must be finite and below what they gave before it (the first
    batch's too)."""
    from torch.profiler import ProfilerActivity, profile
    import mxnet_tpu_torch as mt
    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    ctx = mt.gpu(0)
    it = mt.rnn.BucketSentenceIter(bucket_sentences(np), BUCKET_BATCH,
                                   buckets=list(BUCKETS), invalid_label=0,
                                   seed=SEED)
    stack, sym_gen = bucket_sym_gen(mt)
    mod = mt.mod.BucketingModule(sym_gen,
                                 default_bucket_key=it.default_bucket_key,
                                 context=ctx)
    mt.random.seed(SEED)
    init = mt.init.Xavier(factor_type="in", magnitude=2.34).set_rng(
        mt.random.derive_numpy_rng("lstm_bucketing"))
    batches = list(it)
    it.reset()

    def perplexity(mod, some):
        metric = mt.metric.Perplexity(ignore_label=0)
        for b in some:
            mod.forward(b, is_train=False)
            mod.update_metric(metric, b.label)
        return metric.get()[1]

    mod.bind(data_shapes=it.provide_data, label_shapes=it.provide_label)
    mod.init_params(init)
    first_before = perplexity(mod, batches[:1])
    before = perplexity(mod, batches)
    for fn in counters.values():
        fn.launches = {"f32": 0, "bf16": 0}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mod.fit(it, eval_metric=mt.metric.Perplexity(ignore_label=0),
            optimizer="sgd", optimizer_params={
                "learning_rate": BUCKET_LR, "momentum": 0.0,
                "wd": BUCKET_WD},
            num_epoch=1)
    torch.cuda.synchronize()
    epoch_s = time.perf_counter() - t0
    after = perplexity(mod, batches)
    first_after = perplexity(mod, batches[:1])
    launches = {n: dict(fn.launches) for n, fn in counters.items()}
    default = mod._buckets[it.default_bucket_key]
    names = default._param_names
    shared = {k: all(m._exec.arg_dict[n] is default._exec.arg_dict[n] and
                     m._exec.arg_dict[n].data.data_ptr() ==
                     default._exec.arg_dict[n].data.data_ptr()
                     for n in names)
              for k, m in mod._buckets.items()}
    n_ops = {k: sum(n["op"] != "null" for n in json.loads(
        m.symbol.tojson())["nodes"]) for k, m in mod._buckets.items()}
    log("bucket: lstm_bucketing LM (%d LSTMCell layers of %d, embedding "
        "%d, vocab %d), batch %d, buckets %s: one fit epoch of %d batches "
        "in %.3f s (binds included); perplexity over the epoch's batches "
        "%.3f before, %.3f after; the first batch %.3f before, %.3f after; "
        "parameters shared by identity and data_ptr in buckets %s"
        % (BUCKET_LAYERS, BUCKET_WIDTH, BUCKET_WIDTH, BUCKET_VOCAB,
           BUCKET_BATCH, list(BUCKETS), len(batches), epoch_s, before,
           after, first_before, first_after, shared))
    check(sorted(mod._buckets) == sorted(BUCKETS), "bucket: modules for "
          "%s, the epoch has %s" % (sorted(mod._buckets), list(BUCKETS)))
    check(all(shared.values()), "bucket: a bucket's module does not hold "
          "the default bucket's parameter tensors: %s" % shared)
    check(all(m._updater is default._updater
              for m in mod._buckets.values()),
          "bucket: the buckets do not share one optimizer state")
    check(math.isfinite(after) and after < before and
          first_after < first_before,
          "bucket: perplexity %g (first batch %g) after the epoch, %g (%g) "
          "before it" % (after, first_after, before, first_before))
    for name, n in launches.items():
        check(n == {"f32": 0, "bf16": 0}, "bucket: flash-attention kernel "
              "%s launched %s times" % (name, n))
    # per bucket: device ms a step between CUDA events, host µs to issue
    # it (the unrolled graph runs op by op from Python)
    by_key = {b.bucket_key: b for b in batches}
    # per token: each LSTM layer 2 x 4H(in + H), the decoder 2 x H x V;
    # forward and backward 3x (padding tokens counted)
    flops_token = 3 * (BUCKET_LAYERS * 2 * 4 * BUCKET_WIDTH * 2 *
                       BUCKET_WIDTH + 2 * BUCKET_WIDTH * BUCKET_VOCAB)
    for key in BUCKETS:      # every bucket ran in the epoch: warm
        t = timing(torch, lambda: mod._fit_step(by_key[key]),
                   iters=BUCKET_TIMED, windows=1, warm=0)
        tok_s = BUCKET_BATCH * key / (t["ms"] / 1e3)
        log("bucket %d: %.3f ms a step (%d steps between CUDA events) = "
            "%.0f tok/s, MFU %.5f of 67 TFLOP/s f32 (%.2f GFLOP a step); "
            "host %.1f ms to issue one (%.0f%% of it; %d graph nodes)"
            % (key, t["ms"], BUCKET_TIMED, tok_s,
               tok_s * flops_token / PEAK_FP32_FLOPS,
               BUCKET_BATCH * key * flops_token / 1e9, t["host_us"] / 1e3,
               100 * t["host_us"] / 1e3 / t["ms"], n_ops[key]))
    big = by_key[max(BUCKETS)]
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        mod._fit_step(big)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    resnet_breakdown(torch, prof, wall, "bucket %d" % max(BUCKETS),
                     rnn_kind)
    # the same weights through FusedRNNCell, forward only, to the
    # decoder's logits (the softmax's 1e-4 probabilities would hide a
    # wrong cell)
    args, _ = mod.get_params()
    args = {k: v for k, v in args.items() if "begin_state" not in k}
    _, logits_gen = bucket_sym_gen(mt, head=False)
    fused, fused_gen = bucket_sym_gen(mt, fused=True, head=False)
    packed = fused.pack_weights(stack.unpack_weights(args))
    outs = {}
    for name, gen, values in (("unrolled", logits_gen, args),
                              ("fused", fused_gen, packed)):
        sym, data_names, label_names = gen(big.bucket_key)
        m = mt.mod.Module(sym, data_names, label_names, context=ctx)
        m.bind(data_shapes=big.provide_data, for_training=False)
        m.init_params(mt.init.Zero())
        m.set_params(values, {}, allow_missing=True)
        m.forward(big, is_train=False)
        outs[name] = m.get_outputs()[0].data
        torch.cuda.synchronize()
        t = timing(torch, lambda: m.forward(big, is_train=False),
                   iters=BUCKET_TIMED, windows=1, warm=0)
        log("bucket %d %s forward: %.3f ms (host %.1f ms)"
            % (big.bucket_key, name, t["ms"], t["host_us"] / 1e3))
    err = rel_err(outs["fused"], outs["unrolled"])
    log("bucket %d: FusedRNNCell forward against the unrolled LSTMCells, "
        "the same weights (zero begin states): logits within %.2e of "
        "max|ref| %.4g (limit %g)" % (big.bucket_key, err,
                                     outs["unrolled"].abs().max().item(),
                                     RNN_RTOL))
    check(err <= RNN_RTOL, "bucket: the fused cell's forward differs from "
          "the unrolled one by %g" % err)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    del mod, outs, args, packed, batches, by_key, big
    gc.collect()
    torch.cuda.empty_cache()
    log("bucket phase: %.1f s; peak memory %.3f GB"
        % (time.perf_counter() - t_phase, peak_gb))


def rnn_phase(torch, np):
    """The recurrent family on the card: the fused op against its plain
    recurrence, the word LM through Gluon (f32; amp bf16 too when cuDNN
    takes the op in bf16) and the bucketing LM through BucketingModule,
    with cuDNN's TF32 switch as torch leaves it (on)."""
    t0 = time.perf_counter()
    check(not torch.backends.cuda.matmul.allow_tf32,
          "cuBLAS TF32 is on: the plain recurrences need f32 products")
    # cuDNN's TF32 switch at torch's default (on), as a user has it: the
    # op's own guard must keep the f32 recurrence f32
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        rnn_checks(torch, np)
    finally:
        torch.backends.cudnn.allow_tf32 = prev
    log("rnn phase: %.1f s" % (time.perf_counter() - t0))


def rnn_checks(torch, np):
    """The checks and runs of :func:`rnn_phase`."""
    import mxnet_tpu_torch as mt
    from mxnet_tpu_torch.ops import flash_attention as fa
    bf16_cudnn = fused_op_check(torch)
    counters = {"flash_attention_fwd": fa.flash_attention_fwd,
                "flash_attention_bwd_dq": fa.flash_attention_bwd_dq,
                "flash_attention_bwd_dkv": fa.flash_attention_bwd_dkv}
    run = train_word_lm(torch, np, counters, WORD_WARM, WORD_TIMED,
                        "word lm f32")
    check_word_lm("word lm f32", run, WORD_CE_TOL, RNN_RTOL,
                  PEAK_FP32_FLOPS, "f32")
    log("word lm: amp bf16 %s" % ("not run: cuDNN did not take the op in "
                                  "bf16" if not bf16_cudnn else "runs"))
    if bf16_cudnn:
        mt.amp.init("bfloat16")
        try:
            run = train_word_lm(torch, np, counters, 1, 5, "word lm bf16")
        finally:
            mt.amp.off()
        check_word_lm("word lm bf16", run, WORD_BF16_CE_TOL,
                      WORD_BF16_RTOL, PEAK_BF16_FLOPS, "bf16")
    bucket_phase(torch, np, counters)


# ------------------------------------------------ phase 11: optimizers

def opt_shapes():
    """(a)'s parameter shapes: the LM's d_model², d_model x d_ff, its
    embedding and a bias."""
    return ((D_MODEL, D_MODEL), (D_MODEL, D_FF), (VOCAB, D_MODEL),
            (D_MODEL,))


def optimizer_check(torch):
    """(a) Every optimizer of ``tests/test_fused_trainer.py`` under its
    four variants, on the card: the grouped ``update_multi`` (foreach)
    against the per-parameter ``update`` over OPT_STEPS steps from the
    same weights and gradients, every weight and state leaf within
    OPT_RTOL * max(1, max|ref|). Each case is fatal."""
    import mxnet_tpu_torch as mt
    t0 = time.perf_counter()
    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(SEED + 11)
    shapes = opt_shapes()
    names = {i: "p%d_%s" % (i, "bias" if len(s) == 1 else "weight")
             for i, s in enumerate(shapes)}
    w0 = [torch.randn(s, generator=gen, device=dev) for s in shapes]
    grads = [[torch.randn(s, generator=gen, device=dev) for s in shapes]
             for _ in range(OPT_STEPS)]

    def leaves(state):
        if state is None:
            return []
        if isinstance(state, tuple):
            return [x for s in state for x in leaves(s)]
        return [state.data]

    worst = {}
    for name, kw in OPT_CASES:
        for variant in OPT_VARIANTS:
            args = dict(kw, learning_rate=0.1, rescale_grad=0.5,
                        param_idx2name=names, **variant)
            updaters = []
            for _ in range(2):
                o = mt.optimizer.create(name, **args)
                o.set_wd_mult({})
                updaters.append(mt.optimizer.get_updater(o))
            per = [mt.nd.NDArray(w.clone()) for w in w0]
            grouped = [mt.nd.NDArray(w.clone()) for w in w0]
            for gs in grads:
                for i, g in enumerate(gs):
                    updaters[0](i, mt.nd.NDArray(g), per[i])
                updaters[1].update_multi(list(range(len(gs))), grouped, gs)
            torch.cuda.synchronize()
            case = "%s %s %s" % (name, kw or "", variant or "plain")
            err = 0.0
            for i in range(len(shapes)):
                pairs = [(per[i].data, grouped[i].data)] + list(zip(
                    leaves(updaters[0].states[i]),
                    leaves(updaters[1].states[i])))
                for a, b in pairs:
                    top = max(1.0, a.abs().max().item())
                    err = max(err, (a - b).abs().max().item() / top)
            check(err <= OPT_RTOL, "optimizer %s: grouped update %.3g of "
                  "max(1, max|ref|) from the per-parameter one (limit %g)"
                  % (case, err, OPT_RTOL))
            worst[case] = err
            del per, grouped, updaters
    del w0, grads
    gc.collect()
    torch.cuda.empty_cache()
    log("optimizers: %d cases (%d optimizers x %d variants) on %s, %d "
        "steps each: grouped (foreach) = per-parameter within %g of "
        "max(1, max|ref|); worst %.3g (%s); %.1f s"
        % (len(worst), len(OPT_CASES), len(OPT_VARIANTS),
           " + ".join("x".join(map(str, s)) for s in shapes), OPT_STEPS,
           OPT_RTOL, max(worst.values()), max(worst, key=worst.get),
           time.perf_counter() - t0))


class RepeatIter(object):
    """One batch ``n`` times an epoch, as a DataIter for ``fit``."""

    def __init__(self, batch, n, data_shape, label_shape):
        self.batch, self.n, self.i = batch, n, 0
        self.provide_data = [("data", data_shape)]
        self.provide_label = [("softmax_label", label_shape)]

    def __iter__(self):
        return self

    def __next__(self):
        if self.i >= self.n:
            raise StopIteration
        self.i += 1
        return self.batch

    next = __next__

    def reset(self):
        self.i = 0


def check_disk(path, need: int, what: str) -> None:
    import shutil
    free = shutil.disk_usage(path).free
    log("%s: %.2f GB free beside %s, %.2f GB needed"
        % (what, free / 1e9, path, need / 1e9))
    check(free >= need, "%s needs %d bytes of disk, %d free under %s"
          % (what, need, free, path))


def ckpt_counters():
    from mxnet_tpu_torch import profiler as mprof
    return {k: mprof.get_counter(k) for k in (
        "ckpt_block_us", "ckpt_write_us", "ckpt_bytes", "ckpt_saved")}


def ckpt_delta(before):
    after = ckpt_counters()
    return {k: after[k] - before[k] for k in after}


def adam_fit_args(mt):
    """fit's optimizer, schedule and metric of phase 11."""
    return dict(
        optimizer="adam",
        optimizer_params=dict(ADAM_PARAMS,
                              lr_scheduler=mt.lr_scheduler.FactorScheduler(
                                  *ADAM_SCHED)),
        eval_metric=mt.metric.CompositeEvalMetric(
            [mt.metric.CrossEntropy(), mt.metric.Perplexity(None)]))


def adam_lm(torch, np, counters):
    """(b) The LM at bench.py's configuration (amp bf16 set by the
    caller) through ``Module.fit`` with Adam, the FactorScheduler, the
    composite metric and an async ``CheckpointConfig``, on one fixed
    batch: 1 + ADAM_WARM + ADAM_TIMED steps and one under
    torch.profiler, read from the batch-end callback; then the epoch's
    checkpoint. Returns train_lm's readings."""
    import shutil
    from torch.profiler import ProfilerActivity, profile
    import mxnet_tpu_torch as mt
    from mxnet_tpu_torch.models import transformer
    B, T = TRAIN_BATCH, MAX_SEQ
    steps = 1 + ADAM_WARM + ADAM_TIMED + 1
    n_params = transformer.param_count(VOCAB, LAYERS, D_MODEL, HEADS, D_FF, T)
    ckpt_dir = ROOT / "build" / "phase11_lm_ckpt"
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    ckpt_dir.mkdir(parents=True)
    check_disk(ckpt_dir, int(1.1 * 3 * 4 * n_params), "LM Adam checkpoint")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    sym = transformer.get_symbol(VOCAB, LAYERS, D_MODEL, HEADS, D_FF, T,
                                 attention="flash")
    mod = mt.mod.Module(sym, context=mt.gpu(0))
    mod.bind(data_shapes=[("data", (B, T))],
             label_shapes=[("softmax_label", (B, T))])
    mod.init_params(mt.init.Xavier().set_rng(np.random.default_rng(SEED)))
    torch.cuda.synchronize()
    bind_s = time.perf_counter() - t0
    rng = np.random.RandomState(0)
    x = rng.randint(0, VOCAB, (B, T)).astype(np.float32)
    y = rng.randint(0, VOCAB, (B, T)).astype(np.float32)
    dev = torch.device(DEVICE)
    db = mt.io.DataBatch(data=[mt.nd.array(x, ctx=dev)],
                         label=[mt.nd.array(y, ctx=dev)])
    y_flat = torch.from_numpy(y).to(dev).long().view(-1, 1)
    with torch.no_grad():
        params = {n: a.data for n, a in mod.get_params()[0].items()}
        want = plain_train_loss(torch, params, torch.from_numpy(x).to(dev),
                                torch.from_numpy(y).to(dev)).item()
        del params
    torch.cuda.empty_cache()
    losses = []
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    st = {}

    def on_batch(param):
        out = mod.get_outputs()[0].data
        losses.append(-(out.gather(1, y_flat) + 1e-12).log().mean())
        done = param.nbatch + 1
        if done == 1:
            torch.cuda.synchronize()
            st["first_s"] = time.perf_counter() - st["t0"]
        if done == 1 + ADAM_WARM:
            start.record()
        if done == steps - 1:
            end.record()
            torch.cuda.synchronize()
            prof.start()
            st["t_prof"] = time.perf_counter()
        if done == steps:
            torch.cuda.synchronize()
            st["wall"] = time.perf_counter() - st["t_prof"]
            prof.stop()

    fit_args = adam_fit_args(mt)
    # the main path: counters zeroed just before, read just after
    for fn in counters.values():
        fn.launches = {"f32": 0, "bf16": 0}
    c0 = ckpt_counters()
    st["t0"] = time.perf_counter()
    mod.fit(RepeatIter(db, steps, (B, T), (B, T)), num_epoch=1,
            batch_end_callback=on_batch,
            checkpoint=mt.checkpoint.CheckpointConfig(
                str(ckpt_dir), period_epochs=1, async_save=True,
                keep_last=0), **fit_args)
    fit_s = time.perf_counter() - st["t0"]
    launches = {n: dict(fn.launches) for n, fn in counters.items()}
    ck = ckpt_delta(c0)
    step_ms = start.elapsed_time(end) / ADAM_TIMED
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    rows, busy_ms = device_breakdown(torch, prof, st["wall"], "adam step")
    by_kind = {}
    for e in rows:
        kind = kernel_kind(e.key)
        by_kind[kind] = by_kind.get(kind, 0.0) + \
            e.self_device_time_total / 1e3
    log("adam step device time by kind: " + ", ".join(
        "%s %.3f ms" % kv for kv in sorted(by_kind.items(),
                                           key=lambda kv: -kv[1])))
    names, values = fit_args["eval_metric"].get()
    log("adam fit: %d steps in %.3f s, metrics %s" % (
        steps, fit_s, dict(zip(names, values))))
    check(all(math.isfinite(v) for v in values), "non-finite metric %s"
          % values)
    check(abs(math.log(values[1]) - values[0]) <= 1e-3, "perplexity %g is "
          "not exp of the cross-entropy %g" % (values[1], values[0]))
    ckpts = mt.checkpoint.list_checkpoints(str(ckpt_dir))
    check([s for s, _ in ckpts] == [steps] and
          mt.checkpoint.probe_valid(ckpts[0][1]),
          "the epoch's checkpoint did not land: %s" % ckpts)
    log("adam fit checkpoint (%d layers, weights + mean + var): %d bytes; "
        "fit blocked %.3f s on it, the writer took %.3f s"
        % (LAYERS, ck["ckpt_bytes"], ck["ckpt_block_us"] / 1e6,
           ck["ckpt_write_us"] / 1e6))
    check(ck["ckpt_saved"] == 1, "checkpoints written: %d" % ck["ckpt_saved"])
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    losses = [float(v) for v in torch.stack(losses).cpu()]
    del mod, db
    gc.collect()
    torch.cuda.empty_cache()
    return {"losses": losses, "want": want, "step_ms": step_ms,
            "bind_s": bind_s, "first_s": st["first_s"], "timed": ADAM_TIMED,
            "launches": launches, "peak_gb": peak_gb, "busy_ms": busy_ms,
            "att_ms": by_kind.get("attention kernels", 0.0),
            "opt_ms": by_kind.get("optimizer (foreach)", 0.0),
            "by_kind": by_kind, "ckpt": ck}


def param_dist(a, b) -> float:
    return max((a[n] - b[n]).abs().max().item() for n in a)


def resume_check(torch, np):
    """(c) Resume at the full width and RESUME_LAYERS of the 12 layers
    (amp bf16 set by the caller): an uninterrupted fit of RESUME_EPOCHS
    epochs of RESUME_BATCHES batches with an async checkpoint each
    epoch; the first epoch's checkpoint restored into a fresh module
    must hold the saved parameters, Adam states, count and rate bit for
    bit, and a fresh ``fit(resume_from=...)`` must end on the
    uninterrupted run's weights (bit for bit, or, where an op on the
    path is not deterministic, no further than a second uninterrupted
    run)."""
    import shutil
    import warnings
    import mxnet_tpu_torch as mt
    from mxnet_tpu_torch.models import transformer
    t_phase = time.perf_counter()
    B, T = TRAIN_BATCH, MAX_SEQ
    n_params = transformer.param_count(VOCAB, RESUME_LAYERS, D_MODEL, HEADS,
                                       D_FF, T)
    full = transformer.param_count(VOCAB, LAYERS, D_MODEL, HEADS, D_FF, T)
    log("resume: full width, %d of %d layers (cut from the depth only): "
        "%.1fM parameters, an Adam checkpoint %.2f GB (weights, mean, var; "
        "the full depth would be %.2f GB a save)"
        % (RESUME_LAYERS, LAYERS, n_params / 1e6, 12 * n_params / 1e9,
           12 * full / 1e9))
    base = ROOT / "build" / "phase11_resume"
    shutil.rmtree(base, ignore_errors=True)
    base.mkdir(parents=True)
    check_disk(base, int(1.1 * 12 * n_params * RESUME_EPOCHS), "resume")
    rng = np.random.RandomState(1)
    x = rng.randint(0, VOCAB, (RESUME_BATCHES * B, T)).astype(np.float32)
    y = rng.randint(0, VOCAB, (RESUME_BATCHES * B, T)).astype(np.float32)
    sym = transformer.get_symbol(VOCAB, RESUME_LAYERS, D_MODEL, HEADS, D_FF,
                                 T, attention="flash")
    probe = mt.mod.Module(sym, context=mt.gpu(0))
    probe.bind(data_shapes=[("data", (B, T))],
               label_shapes=[("softmax_label", (B, T))])
    probe.init_params(mt.init.Xavier().set_rng(
        np.random.default_rng(SEED + 1)))
    init = {n: mt.nd.NDArray(a.data.clone())
            for n, a in probe.get_params()[0].items()}
    del probe
    saved = {}

    def run(ckpt=None, resume=None, keep=None):
        mt.random.seed(SEED)
        mod = mt.mod.Module(sym, context=mt.gpu(0))
        cbs = []
        if keep is not None:
            def remember(param):
                o = mod._optimizer
                keep.setdefault("lr", {})[o.num_update] = \
                    o.lr_scheduler(o.num_update)
                if param.epoch == 0 and param.nbatch == RESUME_BATCHES - 1:
                    keep["params"] = {n: a.data.clone() for n, a in
                                      mod.get_params()[0].items()}
                    keep["states"] = {n: tuple(s.data.clone() for s in st)
                                      for n, st in
                                      mod._named_states().items()}
                    keep["num_update"] = o.num_update
            cbs.append(remember)
        mod.fit(mt.io.NDArrayIter(x, y, batch_size=B),
                num_epoch=RESUME_EPOCHS, batch_end_callback=cbs,
                arg_params=None if resume else init, checkpoint=ckpt,
                resume_from=resume, **adam_fit_args(mt))
        return mod, {n: a.data.clone() for n, a in
                     mod.get_params()[0].items()}

    c0 = ckpt_counters()
    t0 = time.perf_counter()
    mod_a, final_a = run(ckpt=mt.checkpoint.CheckpointConfig(
        str(base), period_epochs=1, async_save=True, keep_last=0),
        keep=saved)
    fit_s = time.perf_counter() - t0
    ck = ckpt_delta(c0)
    ckpts = mt.checkpoint.list_checkpoints(str(base))
    check([s for s, _ in ckpts] ==
          [RESUME_BATCHES * (e + 1) for e in range(RESUME_EPOCHS)],
          "resume: checkpoints %s" % ckpts)
    del mod_a
    gc.collect()
    torch.cuda.empty_cache()
    # resume from the first epoch's checkpoint: the later ones go
    for _, path in ckpts[1:]:
        shutil.rmtree(path)
    first = ckpts[0][1]
    nbytes = sum(f.stat().st_size for f in Path(first).iterdir())
    t0 = time.perf_counter()
    ckpt = mt.checkpoint.restore_latest(str(base))
    read_s = time.perf_counter() - t0
    log("resume checkpoint: %d bytes (%d saves); fit blocked %.3f s a save, "
        "the writer took %.3f s a save (fit %.3f s in all); the verified "
        "read (crc32 of every array) %.3f s"
        % (nbytes, ck["ckpt_saved"], ck["ckpt_block_us"] / 1e6 /
           ck["ckpt_saved"], ck["ckpt_write_us"] / 1e6 / ck["ckpt_saved"],
           fit_s, read_s))
    # the restored state against the saved one, bit for bit
    mod_r = mt.mod.Module(sym, context=mt.gpu(0))
    mod_r.bind(data_shapes=[("data", (B, T))],
               label_shapes=[("softmax_label", (B, T))])
    mod_r.init_params(arg_params=ckpt.arg_params_nd())
    fit_args = adam_fit_args(mt)
    mod_r.init_optimizer(optimizer=fit_args["optimizer"],
                         optimizer_params=fit_args["optimizer_params"])
    mod_r._checkpoint_restore(ckpt)
    o = mod_r._optimizer
    bad = [n for n, a in mod_r.get_params()[0].items()
           if not torch.equal(a.data, saved["params"][n])]
    bad += [n for n, st in mod_r._named_states().items()
            for a, b in zip(st, saved["states"][n])
            if not torch.equal(a.data, b)]
    next_lr = o.lr_scheduler(o.num_update + 1)
    check(not bad, "resume: restored arrays differ from the saved: %s"
          % bad[:5])
    check(o.num_update == saved["num_update"] == RESUME_BATCHES,
          "resume: num_update %d, saved %d" % (o.num_update,
                                               saved["num_update"]))
    check(next_lr == saved["lr"][o.num_update + 1], "resume: rate %r, the "
          "uninterrupted run's %r" % (next_lr, saved["lr"][o.num_update + 1]))
    log("resume: %d parameters and %d Adam states restored bit for bit, "
        "num_update %d, next rate %g as the uninterrupted run's"
        % (len(saved["params"]), 2 * len(saved["states"]), o.num_update,
           next_lr))
    del mod_r, ckpt, saved
    gc.collect()
    torch.cuda.empty_cache()
    mod_c, final_c = run(resume=str(base))
    check(mod_c._optimizer.num_update == RESUME_BATCHES * RESUME_EPOCHS,
          "resumed run ended at count %d" % mod_c._optimizer.num_update)
    del mod_c
    d_resume = param_dist(final_c, final_a)
    if d_resume == 0.0:
        log("resume: the resumed run's final weights equal the "
            "uninterrupted run's bit for bit")
    else:
        _, final_d = run()
        d_second = param_dist(final_d, final_a)
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.use_deterministic_algorithms(True, warn_only=True)
            try:
                run()
            finally:
                torch.use_deterministic_algorithms(False)
        ops = sorted({str(w.message).split("\n")[0][:160] for w in caught
                      if "deterministic" in str(w.message)})
        log("resume: final weights %.3g (max |diff|) from the uninterrupted "
            "run's; a second uninterrupted run %.3g; not deterministic on "
            "this path: %s" % (d_resume, d_second, ops or "none named"))
        check(d_second > 0 and d_resume <= d_second, "resume: the resumed "
              "run is %.3g from the uninterrupted one, a second "
              "uninterrupted run %.3g" % (d_resume, d_second))
    shutil.rmtree(base, ignore_errors=True)
    del final_a, final_c, init
    gc.collect()
    torch.cuda.empty_cache()
    log("resume phase: %.1f s" % (time.perf_counter() - t_phase))


def dcgan_nets(mt):
    """The upstream Gluon DCGAN's generator and discriminator
    (example/gluon/dcgan.py) at DCGAN_NGF / DCGAN_NDF."""
    nn = mt.gluon.nn
    ngf, ndf = DCGAN_NGF, DCGAN_NDF
    g = nn.HybridSequential(prefix="smoke_g_")
    with g.name_scope():
        for i, (ch, k, s, p) in enumerate([(ngf * 8, 4, 1, 0),
                                           (ngf * 4, 4, 2, 1),
                                           (ngf * 2, 4, 2, 1),
                                           (ngf, 4, 2, 1)]):
            g.add(nn.Conv2DTranspose(ch, k, s, p, use_bias=False))
            g.add(nn.BatchNorm())
            g.add(nn.Activation("relu"))
        g.add(nn.Conv2DTranspose(3, 4, 2, 1, use_bias=False))
        g.add(nn.Activation("tanh"))
    d = nn.HybridSequential(prefix="smoke_d_")
    with d.name_scope():
        d.add(nn.Conv2D(ndf, 4, 2, 1, use_bias=False))
        d.add(nn.LeakyReLU(0.2))
        for ch in (ndf * 2, ndf * 4, ndf * 8):
            d.add(nn.Conv2D(ch, 4, 2, 1, use_bias=False))
            d.add(nn.BatchNorm())
            d.add(nn.LeakyReLU(0.2))
        d.add(nn.Conv2D(1, 4, 1, 0, use_bias=False))
    return g, d


def dcgan_check(torch, np):
    """(d) The upstream Gluon DCGAN at its widths (nz 100, ngf 64, ndf
    64, 64x64x3, batch 64) on seeded uniform images in [-1, 1] (the
    dataset is not in the repository), two ``Trainer("adam", lr 2e-4,
    beta1 0.5)``: DCGAN_STEPS alternating D/G steps with finite losses,
    the ms a step; then both Trainers' ``save_states``, DCGAN_CONTINUE
    more steps, and the same steps again from the saved parameters with
    fresh Trainers that ``load_states`` (``begin_num_update`` at the
    saved count: the file holds no counts): equal bit for bit (cuDNN's
    deterministic algorithms for these steps)."""
    import shutil
    import mxnet_tpu_torch as mt
    from mxnet_tpu_torch import autograd, gluon
    t_phase = time.perf_counter()
    dev = torch.device(DEVICE)
    B, nz, S = DCGAN_BATCH, DCGAN_NZ, DCGAN_SIZE
    rng = np.random.RandomState(SEED + 5)
    images = mt.nd.array(rng.uniform(-1, 1, (B, 3, S, S)).astype(np.float32),
                         ctx=dev)
    steps = DCGAN_STEPS + DCGAN_CONTINUE
    noise = [mt.nd.array(rng.normal(0, 1, (B, nz, 1, 1)).astype(np.float32),
                         ctx=dev) for _ in range(steps)]
    real = mt.nd.array(np.ones((B,), np.float32), ctx=dev)
    fake_label = mt.nd.array(np.zeros((B,), np.float32), ctx=dev)
    net_g, net_d = dcgan_nets(mt)
    init = mt.init.Normal(0.02).set_rng(np.random.default_rng(SEED + 6))
    net_g.initialize(init, ctx=mt.gpu(0))
    net_d.initialize(init, ctx=mt.gpu(0))
    opt = {"learning_rate": DCGAN_LR, "beta1": DCGAN_BETA1}
    trainers = [gluon.Trainer(net_d.collect_params(), "adam", dict(opt)),
                gluon.Trainer(net_g.collect_params(), "adam", dict(opt))]
    loss_fn = gluon.loss.SigmoidBinaryCrossEntropyLoss()

    def step(k, tr_d, tr_g):
        with autograd.record():
            out = net_d(images).reshape((-1, 1))
            err_real = loss_fn(out, real)
            fake = net_g(noise[k])
            out = net_d(fake.detach()).reshape((-1, 1))
            err_d = err_real + loss_fn(out, fake_label)
        err_d.backward()
        tr_d.step(B)
        with autograd.record():
            fake = net_g(noise[k])
            out = net_d(fake).reshape((-1, 1))
            err_g = loss_fn(out, real)
        err_g.backward()
        tr_g.step(B)
        return err_d.data.detach().mean(), err_g.data.detach().mean()

    events = [torch.cuda.Event(enable_timing=True)
              for _ in range(DCGAN_STEPS + 1)]
    losses = []
    events[0].record()
    for k in range(DCGAN_STEPS):
        losses.append(step(k, *trainers))
        events[k + 1].record()
    torch.cuda.synchronize()
    per_step = [a.elapsed_time(b) for a, b in zip(events, events[1:])]
    losses = [(float(d), float(g)) for d, g in losses]
    log("dcgan (nz %d, ngf %d, ndf %d, %dx%dx3, batch %d, Adam lr %g beta1 "
        "%g): ms a step (D then G) %s (the first holds deferred init); "
        "losses D/G %s" % (nz, DCGAN_NGF, DCGAN_NDF, S, S, B, DCGAN_LR,
                           DCGAN_BETA1, " ".join("%.3f" % t for t in per_step),
                           " ".join("%.4f/%.4f" % dg for dg in losses)))
    check(all(math.isfinite(v) for dg in losses for v in dg),
          "dcgan: non-finite loss %s" % losses)
    params = list(net_d.collect_params().values()) + \
        list(net_g.collect_params().values())
    base = ROOT / "build" / "phase11_dcgan"
    shutil.rmtree(base, ignore_errors=True)
    base.mkdir(parents=True)
    files = [str(base / "d.states"), str(base / "g.states")]
    prev = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        snap = [p.data().data.clone() for p in params]
        for tr, f in zip(trainers, files):
            tr.save_states(f)
        for k in range(DCGAN_STEPS, steps):
            step(k, *trainers)
        want = [p.data().data.clone() for p in params]
        for p, v in zip(params, snap):
            p.set_data(mt.nd.NDArray(v.clone()))
        fresh = [gluon.Trainer(net.collect_params(), "adam", dict(
            opt, begin_num_update=DCGAN_STEPS)) for net in (net_d, net_g)]
        for tr, f in zip(fresh, files):
            tr.load_states(f)
        for k in range(DCGAN_STEPS, steps):
            step(k, *fresh)
        bad = [p.name for p, w in zip(params, want)
               if not torch.equal(p.data().data, w)]
    finally:
        torch.backends.cudnn.deterministic = prev
    nbytes = sum(Path(f).stat().st_size for f in files)
    check(not bad, "dcgan: %d arrays differ after load_states: %s"
          % (len(bad), bad[:5]))
    log("dcgan: save_states of both Trainers (%d bytes), then %d steps: "
        "fresh Trainers after load_states end on the same %d arrays bit "
        "for bit; %.1f s" % (nbytes, DCGAN_CONTINUE, len(params),
                             time.perf_counter() - t_phase))
    shutil.rmtree(base, ignore_errors=True)
    del net_g, net_d, trainers, params, snap, want
    gc.collect()
    torch.cuda.empty_cache()


def optim_phase(torch, np, sgd):
    """Phase 11: (a) every optimizer on the card, (b) the LM with Adam
    through fit beside phase 6's SGD step ``sgd``, (c) resume, (d) the
    Gluon DCGAN."""
    import mxnet_tpu_torch as mt
    from mxnet_tpu_torch.models import transformer
    from mxnet_tpu_torch.ops import flash_attention as fa
    t0 = time.perf_counter()
    optimizer_check(torch)
    counters = {"flash_attention_fwd_bf16": fa.flash_attention_fwd,
                "flash_attention_bwd_dq": fa.flash_attention_bwd_dq,
                "flash_attention_bwd_dkv": fa.flash_attention_bwd_dkv}
    mt.amp.init("bfloat16")
    try:
        run = adam_lm(torch, np, counters)
        check_training("adam", run, "bf16", PEAK_BF16_FLOPS, "bf16")
        n_params = transformer.param_count(VOCAB, LAYERS, D_MODEL, HEADS,
                                           D_FF, MAX_SEQ)
        n_embed = VOCAB * D_MODEL + MAX_SEQ * D_MODEL
        flops = (6 * (n_params - n_embed) + 12 * LAYERS * D_MODEL * MAX_SEQ) \
            * TRAIN_BATCH * MAX_SEQ
        for what, r in (("sgd (phase 6)", sgd), ("adam", run)):
            tok_s = TRAIN_BATCH * MAX_SEQ / (r["step_ms"] / 1e3)
            log("%s: step %.3f ms, %.1f tok/s, MFU %.4f of 989 TFLOP/s bf16, "
                "peak memory %.3f GB, optimizer (foreach) %.3f ms of %.3f ms "
                "device time in the profiled step"
                % (what, r["step_ms"], tok_s,
                   flops / (r["step_ms"] / 1e3) / PEAK_BF16_FLOPS,
                   r["peak_gb"], r["by_kind"].get("optimizer (foreach)", 0.0),
                   r["busy_ms"]))
        resume_check(torch, np)
    finally:
        mt.amp.off()
    dcgan_check(torch, np)
    log("optimizer phase: %.1f s" % (time.perf_counter() - t0))

PAIRS_OF = ("f32-backward", "rtc")


def pairs_of(checkout: str, what: str) -> int:
    """``--pairs-of CHECKOUT WHAT``: one timing of another checkout's
    package (the parent commit's, say), built here and run by this
    script's code on this card, for a before/after pair in one call.
    ``f32-backward`` times the f32 dQ and dK/dV kernels
    (:func:`f32_backward_timing`); ``rtc`` pairs ``relu``,
    ``scale_add`` and ``split``, and :data:`B6F_STREAM_SOURCE`'s
    versions of the first two, with torch's calls (:func:`rtc_pairs`). Prints the readings as one
    JSON line."""
    if what not in PAIRS_OF:
        print("chip_smoke: --pairs-of CHECKOUT WHAT, WHAT one of %s"
              % (PAIRS_OF,), file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(checkout).resolve()))
    import torch
    import mxnet_tpu_torch
    log("package %s" % mxnet_tpu_torch.__file__)
    try:
        card_phase(torch)
        if what == "f32-backward":
            readings = f32_backward_timing(torch)
        else:
            from mxnet_tpu_torch import rtc_examples as ex
            rows = TRAIN_BATCH * MAX_SEQ
            readings = rtc_pairs(torch, {
                "relu": ex.relu((rows, D_FF)),
                "scale_add": ex.scale_add((rows, D_MODEL)),
                "split": ex.split((rows, D_MODEL)),
                **b6f_stream_kernels(torch)})
    except SmokeFailure as exc:
        print("chip_smoke: FAILED: %s" % exc, file=sys.stderr)
        return 1
    log(json.dumps(readings))
    return 0


def main() -> int:
    if len(sys.argv) == 4 and sys.argv[1] == "--pairs-of":
        return pairs_of(sys.argv[2], sys.argv[3])
    if not (ROOT / "mxnet_tpu_torch" / "csrc").is_dir():
        print("chip_smoke: run from a checkout of the repository "
              "(mxnet_tpu_torch/ not found beside this script)",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import numpy as np
    import torch
    try:
        card_phase(torch)
        build_phase()
        kernels = kernel_phase(torch)
        slice_phase(torch, np, kernels)
        train_kernel_phase(torch, kernels)
        sgd = train_phase(torch, np, kernels)
        train_f32_phase(torch, np, kernels)
        rtc_phase(torch, np, kernels)
        resnet_phase(torch, np)
        gluon_phase(torch, np)
        rnn_phase(torch, np)
        optim_phase(torch, np, sgd)
        torch.cuda.synchronize()
    except SmokeFailure as exc:
        print("chip_smoke: FAILED: %s" % exc, file=sys.stderr)
        return 1
    log(json.dumps({"kernels": list(kernels.values())}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
