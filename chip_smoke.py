#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``mxnet_tpu_torch``) on one NVIDIA GPU.

Run from the root of a checkout, on a machine with one H100:

    python3 chip_smoke.py

Phases, each fatal on failure (exit code 1, no result line):

1. card: ``nvidia-smi`` name and power limit, ``torch`` device name;
2. build: every CUDA source under ``mxnet_tpu_torch/csrc`` with
   ``nvcc`` (all started together), with the compiler's register and
   shared-memory report;
3. kernels: each kernel of the serving path against its plain PyTorch
   version on the card, at the shapes that path gives it, and timed
   beside that plain version, one library call and its bound;
4. slice: ``GenerativeServer`` at the full width of the zoo transformer
   LM as ``bench.py`` trains it (12 layers, d_model 2048, 16 heads,
   d_ff 8192, vocab 32000, max_seq 1024), weights drawn from a seed,
   8 slots; 8 greedy prompts of 17 to 900 tokens submitted at once, 32
   new tokens each. The kernel launch counters are zeroed just before
   this cold burst and read just after; every kernel must have run. The
   same burst then runs warm, and once more under ``torch.profiler`` for
   the device's busy share and kernel time by name. Last, prefill and
   decode logits are held against an independent plain forward of the
   same weights.

The second-to-last line is the kernel table as one JSON object; the
last is ``{"ok": true, "device": {...}}``. Without a GPU, or run from a
directory that holds nothing else of the repository, it exits non-zero.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# H100 SXM data-sheet peaks (dense), for the bound of each kernel
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12

# the zoo transformer at bench.py's training width
VOCAB, LAYERS, D_MODEL, HEADS, D_FF, MAX_SEQ = 32000, 12, 2048, 16, 8192, 1024
SLOTS, PAGE, NEW_TOKENS = 8, 16, 32
PROMPT_LENS = (17, 64, 130, 250, 400, 555, 700, 900)
SEED = 0
DEVICE = "cuda:0"

KERNEL_ATOL = 1e-4     # f32 kernel vs f32 plain version: rounding only
LOGITS_ATOL = 1e-3     # f32 served logits vs a plain forward: 12 layers
                       # of f32 sums in another order; logits are O(1)


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
    from mxnet_tpu_torch import _build
    sources = sorted(p.name for p in _build.CSRC.glob("*.cu"))
    t0 = time.perf_counter()
    _build.build(sources)
    log("build: %d source(s) %s in %.2f s"
        % (len(sources), sources, time.perf_counter() - t0))
    for s in sources:
        log(_build.build_log(s).strip())


def time_ms(torch, fn, iters: int = 20) -> float:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def flash_bound(bh: int, s: int, d: int):
    """Least time for causal attention over (bh, s, d) f32: the
    s(s+1)/2 live (q, k) pairs cost 2d flops in Q K^T and 2d in P V;
    q, k, v are read once, o and lse written once."""
    flops = 4.0 * d * bh * s * (s + 1) / 2
    nbytes = 4.0 * (4 * bh * s * d + bh * s)
    t_ops, t_bytes = flops / PEAK_FP32_FLOPS, nbytes / PEAK_BYTES_PER_S
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def kernel_phase(torch):
    """K1 against its plain version at the prefill shapes: 16 heads,
    d 128, every prompt bucket the slice phase uses plus a length that
    is no tile multiple (ragged q and k edges)."""
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

    s = MAX_SEQ
    q, k, v = (torch.randn((bh, s, d), generator=gen, device=dev)
               for _ in range(3))
    ms = time_ms(torch, lambda: flash_attention_fwd(q, k, v, scale, True))
    plain_ms = time_ms(
        torch, lambda: flash_attention_reference(q, k, v, scale, True))
    library_ms = time_ms(torch, lambda: F.scaled_dot_product_attention(
        q[None], k[None], v[None], is_causal=True, scale=scale))
    bound_ms, bound_by = flash_bound(bh, s, d)
    log("flash_attention_fwd bh=%d s=%d d=%d causal: kernel_ms=%.4f "
        "reference_ms=%.4f library_ms=%.4f (sdpa) bound_ms=%.4f (%s)"
        % (bh, s, d, ms, plain_ms, library_ms, bound_ms, bound_by))
    return {"flash_attention_fwd": {
        "name": "flash_attention_fwd", "route": "cuda",
        "source": "mxnet_tpu_torch/csrc/flash_attention_fwd.cu",
        "replaces": "mxnet_tpu/ops/pallas/flash_attention.py:45",
        "tpu_kernel": "ops/pallas/flash_attention.py:_fa_kernel",
        "max_abs_err": worst, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": library_ms}}


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


def device_breakdown(torch, prof, wall):
    """Kernel time by name from a torch.profiler trace, and the device's
    busy share of the burst's wall time."""
    rows = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in rows)
    log("slice profiled: device busy %.3f ms of %.3f ms wall (%.1f%%), "
        "idle share %.3f" % (busy_us / 1e3, wall * 1e3,
                             100 * busy_us / 1e3 / (wall * 1e3),
                             1 - busy_us / 1e3 / (wall * 1e3)))
    for e in sorted(rows, key=lambda e: -e.self_device_time_total)[:8]:
        log("  %8.3f ms %5d x %s" % (e.self_device_time_total / 1e3,
                                     e.count, e.key[:90]))


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
        flash_attention_fwd.launches = 0
        outs, wall = burst(srv, prompts)
        launches = {"flash_attention_fwd": flash_attention_fwd.launches}
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
        device_breakdown(torch, prof, wall)
    finally:
        srv.close()
    for pr, toks in zip(prompts, outs):
        check(len(toks) == NEW_TOKENS and all(0 <= t < VOCAB for t in toks),
              "prompt of %d tokens gave %r" % (len(pr), toks))
    prefills = len(prompts)
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


def main() -> int:
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
