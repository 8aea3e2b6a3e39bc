"""The port's generative serving path against the reference's.

Weights come from a reference ``Module`` (the zoo transformer, vocab
128, 2 layers, d_model 32, 2 heads, seq 16, page 4) and cross to the
port through ``extract_params``. Prefill and decode logits are held
against the reference ``DecodeEngine`` (dense prefill attention, and the
chunked path with ``prefill_chunk=4``) at atol 1e-4 in f32, the
tolerance the reference's own decode tests hold its engine to against
its training forward; greedy tokens from both ``GenerativeServer``s
must be identical. The scheduler tests mirror the reference's
(oracle: ``tests/test_serve_decode.py``; its two tensor-parallel cases
are ROADMAP A9's).

int8 KV: the codes and scales that prefill (``_quantize_pages``) and
decode (requantize-on-write) leave in the cache equal the reference's
on the same K/V, code for code; teacher-forced on the f32 server's
greedy tokens, every int8 decode step's softmax lies within 5e-2 of the
f32 cache's (the reference's documented tolerance), and greedy tokens
equal the reference's int8 server's.
"""
import os
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

import mxnet_tpu as mx
import mxnet_tpu_torch as mt
from mxnet_tpu._fused import CompileCache as JaxCompileCache
from mxnet_tpu.serve import GenerativeServer as JaxGenerativeServer
from mxnet_tpu.serve.decode import DecodeEngine as JaxDecodeEngine
from mxnet_tpu.serve.decode import extract_params
from mxnet_tpu.serve.kv_cache import KVCache as JaxKVCache
from mxnet_tpu_torch import faults
from mxnet_tpu_torch._fused import CompileCache
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.models import transformer as port_transformer
from mxnet_tpu_torch.serve import (DeadlineExceeded, GenerativeServer,
                                   QueueFull, ServeError, ServerClosed)
from mxnet_tpu_torch.serve.decode import DecodeEngine, _quantize_pages
from mxnet_tpu_torch.serve.decode import extract_params as t_extract
from mxnet_tpu_torch.serve.kv_cache import KVCache

# test files run side by side in parallel workers: each keeps torch's
# intra-op pool small
torch.set_num_threads(2)

VOCAB, LAYERS, DMODEL, HEADS, SEQ, PAGE = 128, 2, 32, 2, 16, 4
ATOL = 1e-4


@pytest.fixture(scope="module")
def module():
    from mxnet_tpu.models import transformer
    net = transformer.get_symbol(vocab_size=VOCAB, num_layers=LAYERS,
                                 d_model=DMODEL, n_heads=HEADS, seq_len=SEQ)
    mod = mx.mod.Module(net, context=mx.cpu())
    mod.bind(data_shapes=[("data", (1, SEQ))],
             label_shapes=[("softmax_label", (1, SEQ))])
    mx.random.seed(11)
    mod.init_params(mx.init.Uniform(0.05))
    return mod


@pytest.fixture(scope="module")
def np_params(module):
    arg, aux = module.get_params()
    out = {k: v.asnumpy() for k, v in arg.items()}
    out.update({k: v.asnumpy() for k, v in (aux or {}).items()})
    return out


def _server(np_params, **kw):
    kw.setdefault("max_sequences", 4)
    kw.setdefault("page", PAGE)
    return GenerativeServer(np_params, n_heads=HEADS, device="cpu", **kw)


def _engines(module, np_params, name, prefill_chunk=512, slots=3,
             int8=False):
    jcache = JaxKVCache(LAYERS, HEADS, DMODEL // HEADS, slots, SEQ,
                        page=PAGE, int8=int8, name="j" + name)
    jeng = JaxDecodeEngine(extract_params(module), HEADS, jcache,
                           JaxCompileCache("j" + name), name="j" + name,
                           prefill_chunk=prefill_chunk)
    cache = KVCache(LAYERS, HEADS, DMODEL // HEADS, slots, SEQ, page=PAGE,
                    int8=int8, name="t" + name, device="cpu")
    eng = DecodeEngine(t_extract(np_params, "cpu"), HEADS, cache,
                       CompileCache("t" + name), name="t" + name)
    return jeng, eng


def test_param_shapes_match_reference_symbol(module, np_params):
    shapes = port_transformer.param_shapes(VOCAB, LAYERS, DMODEL, HEADS,
                                           seq_len=SEQ)
    assert {k: tuple(v.shape) for k, v in np_params.items()} == \
        dict(shapes)
    from mxnet_tpu.models import transformer
    n = sum(int(np.prod(s)) for s in shapes.values())
    assert n == port_transformer.param_count(VOCAB, LAYERS, DMODEL,
                                             HEADS, seq_len=SEQ) == \
        transformer.param_count(VOCAB, LAYERS, DMODEL, HEADS, seq_len=SEQ)


@pytest.mark.parametrize("prefill_chunk", [512, 4])
def test_prefill_logits_match_reference_every_bucket(module, np_params,
                                                     prefill_chunk):
    """Every prompt bucket (4, 8, 16), against the reference's dense
    prefill attention (chunk 512) and its chunked path (chunk 4, taken
    by buckets 8 and 16)."""
    jeng, eng = _engines(module, np_params, "pf%d" % prefill_chunk,
                         prefill_chunk=prefill_chunk)
    assert eng.prompt_buckets == jeng.prompt_buckets == [4, 8, 16]
    rng = np.random.default_rng(3)
    for n in (1, 3, 4, 5, 8, 11, 15):
        prompt = rng.integers(0, VOCAB, n)
        slot = eng.cache.acquire(n)
        assert slot == jeng.cache.acquire(n)
        got = eng.prefill(prompt, slot)
        want = jeng.prefill(prompt, slot)
        np.testing.assert_allclose(got, want, atol=ATOL)
        # the whole bucket block, padding included, went into the slot
        t_b = eng.prompt_bucket(n)
        np.testing.assert_allclose(
            eng.cache.k[:, slot, :, :t_b].numpy(),
            np.asarray(jeng.cache.k)[:, slot, :, :t_b], atol=ATOL)
        eng.cache.release(slot)
        jeng.cache.release(slot)
    assert eng.compile_cache.name == "tpf%d" % prefill_chunk
    assert len(eng.compile_cache) == 3       # one runner per bucket


def test_decode_steps_match_reference_mixed_active(module, np_params):
    """Eight decode steps over three slots whose active set changes
    (one sequence, then a join, then the first one finishing)."""
    jeng, eng = _engines(module, np_params, "dec")
    slots, seqs = {}, {}

    def join(prompt):
        slot = eng.cache.acquire(len(prompt))
        assert slot == jeng.cache.acquire(len(prompt))
        got = eng.prefill(np.array(prompt), slot)
        want = jeng.prefill(np.array(prompt), slot)
        np.testing.assert_allclose(got, want, atol=ATOL)
        seqs[slot] = list(prompt) + [int(np.argmax(want))]
        return slot

    a = join([3, 11, 7, 2, 9])
    schedule = ["a", "a", "join", "ab", "ab", "ab", "free", "b", "b"]
    steps = 0
    for what in schedule:
        if what == "join":
            slots["b"] = join([5, 1])
            continue
        if what == "free":
            eng.cache.release(a)
            jeng.cache.release(a)
            del seqs[a]
            continue
        live = [a] if what == "a" else \
            ([a, slots["b"]] if what == "ab" else [slots["b"]])
        tok = np.zeros((3,), np.int32)
        pos = np.zeros((3,), np.int32)
        act = np.zeros((3,), bool)
        for s in live:
            tok[s], pos[s], act[s] = seqs[s][-1], len(seqs[s]) - 1, True
        got = eng.decode_step(tok, pos, act)
        want = jeng.decode_step(tok, pos, act)
        np.testing.assert_allclose(got[act], want[act], atol=ATOL)
        assert (got[~act] == -1e30).all()
        for s in live:
            eng.cache.grow(s)
            jeng.cache.grow(s)
            seqs[s].append(int(np.argmax(want[s])))
        steps += 1
    assert steps >= 6


def test_greedy_tokens_match_reference_server(module, np_params):
    """Four concurrent greedy prompts: identical tokens from both
    servers."""
    prompts = ([3, 1, 4], [1, 5], [9, 2, 6, 5, 3, 5, 8], [7])
    ref = JaxGenerativeServer(module, n_heads=HEADS, max_sequences=4,
                              page=PAGE, int8=False, name="jgreedy")
    try:
        hs = [ref.submit_generate(p, max_new_tokens=8) for p in prompts]
        want = [h.result(timeout=240) for h in hs]
    finally:
        ref.close()
    srv = _server(np_params, name="tgreedy")
    try:
        hs = [srv.submit_generate(p, max_new_tokens=8) for p in prompts]
        got = [h.result(timeout=240) for h in hs]
    finally:
        srv.close()
    assert got == want
    assert all(len(t) == 8 for t in got)


def test_greedy_generation_composition_invariant(np_params):
    srv = _server(np_params, name="talone")
    try:
        solo = {p: srv.submit_generate(list(p), max_new_tokens=6)
                .result(timeout=120)
                for p in ((3, 1, 4), (1, 5), (9, 2, 6, 5))}
    finally:
        srv.close()
    srv = _server(np_params, name="ttogether")
    try:
        handles = {p: srv.submit_generate(list(p), max_new_tokens=6)
                   for p in solo}
        together = {p: h.result(timeout=120) for p, h in handles.items()}
        st = srv.stats()
    finally:
        srv.close()
    assert solo == together
    assert st["compiles"] <= st["executable_bound"]
    assert st["kv"]["slots_in_use"] == 0


def test_eos_stops_generation(np_params):
    srv = _server(np_params, name="teos")
    try:
        free = srv.submit_generate([7, 3], max_new_tokens=10)\
            .result(timeout=120)
        eos = free[2]
        toks = srv.submit_generate([7, 3], max_new_tokens=10,
                                   eos_id=eos).result(timeout=120)
        assert toks == free[:free.index(eos) + 1]
    finally:
        srv.close()


def test_capacity_truncation(np_params):
    srv = _server(np_params, name="ttrunc")
    try:
        toks = srv.submit_generate([1] * (SEQ - 2), max_new_tokens=50)\
            .result(timeout=120)
        assert 1 <= len(toks) <= SEQ
        assert srv.stats()["kv"]["slots_in_use"] == 0
    finally:
        srv.close()


def test_fault_decode_kills_one_sequence_not_batch(np_params):
    """serve.decode@1 kills ONE sequence's stream with a legible error;
    the co-resident sequence decodes to completion."""
    srv = _server(np_params, name="tfdec")
    try:
        for _ in range(10):
            a = srv.submit_generate([1, 2, 3], max_new_tokens=12)
            while not a.tokens_so_far():
                time.sleep(0.001)
            b = srv.submit_generate([4, 5], max_new_tokens=10)
            while not b.tokens_so_far():
                time.sleep(0.0005)
            if not a.done():
                break
            b.result(timeout=120)      # drain the attempt and retry
        else:
            raise AssertionError("never caught a and b co-resident")
        faults.install("serve.decode@1")
        try:
            outcomes = []
            for h in (a, b):
                try:
                    outcomes.append(("ok", len(h.result(timeout=120))))
                except ServeError as exc:
                    assert "serve.decode" in str(exc)
                    outcomes.append(("killed", None))
        finally:
            faults.clear()
        assert [k for k, _ in outcomes].count("killed") == 1
        assert srv.stats()["kv"]["slots_in_use"] == 0
        # the server still serves after the drill
        assert len(srv.submit_generate([3], max_new_tokens=2)
                   .result(timeout=120)) == 2
    finally:
        faults.clear()
        srv.close()


def test_fault_evict_fails_handle_but_frees_pages(np_params):
    srv = _server(np_params, name="tfevt")
    try:
        faults.install("serve.evict@1")
        try:
            h = srv.submit_generate([1, 2], max_new_tokens=2)
            with pytest.raises(ServeError, match="serve.evict"):
                h.result(timeout=120)
            assert "pages were still freed" in str(h.exception)
        finally:
            faults.clear()
        st = srv.stats()
        assert st["kv"]["slots_in_use"] == 0
        assert st["kv"]["pages_in_use"] == 0
    finally:
        faults.clear()
        srv.close()


def test_stats_schema_matches_reference(module, np_params):
    ref = JaxGenerativeServer(module, n_heads=HEADS, max_sequences=2,
                              page=PAGE, int8=False, name="jschema")
    try:
        ref.submit_generate([1, 2], max_new_tokens=3).result(timeout=240)
        want = ref.stats()
    finally:
        ref.close()
    srv = _server(np_params, max_sequences=2, name="tschema")
    try:
        srv.submit_generate([1, 2], max_new_tokens=3).result(timeout=120)
        got = srv.stats()
    finally:
        srv.close()
    assert set(got) == set(want)
    assert set(got["kv"]) == set(want["kv"])
    assert got["kv"]["hbm_bytes"] == want["kv"]["hbm_bytes"]
    assert got["buckets"] == want["buckets"]
    assert got["tokens"] == want["tokens"] == 3


def test_bad_prompts_rejected(np_params):
    srv = _server(np_params, name="tbad")
    try:
        for bad in ([], [VOCAB], [-1, 2], [1] * SEQ):
            with pytest.raises(ValueError):
                srv.submit_generate(bad, max_new_tokens=2)
    finally:
        srv.close()


def test_no_device_without_gpu_raises(np_params, monkeypatch):
    """Entry points default to cuda:0 and never fall back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(MXNetError, match="no CUDA device"):
        GenerativeServer(np_params, n_heads=HEADS)
    with pytest.raises(MXNetError, match="no CUDA device"):
        t_extract(np_params)


def test_server_lock_order_under_witness(np_params):
    """With the lock witness on, the server's locks are witnessed and a
    burst of requests records no lock-order inversion; an ABBA pair is
    caught before its blocking acquire."""
    from mxnet_tpu_torch import config, lockcheck, profiler
    config.set("MXNET_TPU_LOCKCHECK", "abort")
    try:
        lockcheck.reset_order_graph()
        before = profiler.get_counter("lockcheck_inversion")
        srv = _server(np_params, name="twitness")
        try:
            hs = [srv.submit_generate([1 + i, 2], max_new_tokens=4)
                  for i in range(3)]
            assert all(len(h.result(timeout=120)) == 4 for h in hs)
        finally:
            srv.close()
        assert isinstance(srv._lock, lockcheck._WitnessLock)
        assert profiler.get_counter("lockcheck_inversion") == before
        a, b = lockcheck.Lock(name="t.a"), lockcheck.Lock(name="t.b")
        with a:
            with b:
                pass
        with pytest.raises(MXNetError, match="inversion"):
            with b:
                with a:
                    pass
        assert profiler.get_counter("lockcheck_inversion") == before + 1
    finally:
        config.reset("MXNET_TPU_LOCKCHECK")
        lockcheck.reset_order_graph()


# ------------------------------------------------------------------ int8

def _softmax(x):
    e = np.exp(x - x.max(axis=-1, keepdims=True))
    return e / e.sum(axis=-1, keepdims=True)


def test_quantize_pages_matches_reference():
    """One symmetric scale per (head, page), codes rounded half to even:
    the reference's ``_quantize_pages`` on the same K/V, code for code
    (halves included: values on exact .5 code boundaries)."""
    from mxnet_tpu.serve.decode import _quantize_pages as jax_quantize
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 32, 8)).astype(np.float32)
    x[0, 0, 0] = 127.0                      # page (0, 0): scale exactly 1
    x[0, 1, :4] = [0.5, 1.5, -2.5, 3.5]     # ties to even
    x[1, 8:16] = 0.0                        # an all-zero page: scale 1e-8
    q, sc = _quantize_pages(torch.from_numpy(x), 8)
    jq, jsc = jax_quantize(x, 8)
    assert q.dtype == torch.int8 and tuple(sc.shape) == (3, 4)
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(sc.numpy(), np.asarray(jsc))
    assert q.numpy()[0, 1, :4].tolist() == [0, 2, -2, 4]


def _int8_run(jeng, eng, seqs_in, step_hook=None, steps=7, leave_at=4):
    """Prefill ``seqs_in`` into both engines, then ``steps`` decode steps
    over every resident slot (one sequence leaving at ``leave_at``):
    yields (what, port logits, reference logits, active mask) after
    each call. ``step_hook()`` runs before every call."""
    seqs = {}
    for prompt in seqs_in:
        slot = eng.cache.acquire(len(prompt))
        assert slot == jeng.cache.acquire(len(prompt))
        if step_hook:
            step_hook()
        got = eng.prefill(np.array(prompt), slot)
        want = jeng.prefill(np.array(prompt), slot)
        seqs[slot] = list(prompt) + [int(np.argmax(want))]
        yield "prefill of %r" % (prompt,), got, want, None
    for step in range(steps):
        if step == leave_at:                # one sequence leaves
            gone = min(seqs)
            eng.cache.release(gone)
            jeng.cache.release(gone)
            del seqs[gone]
        tok = np.zeros((3,), np.int32)
        pos = np.zeros((3,), np.int32)
        act = np.zeros((3,), bool)
        for s_, seq in seqs.items():
            tok[s_], pos[s_], act[s_] = seq[-1], len(seq) - 1, True
        if step_hook:
            step_hook()
        got = eng.decode_step(tok, pos, act)
        want = jeng.decode_step(tok, pos, act)
        yield "decode step %d" % step, got, want, act
        for s_ in seqs:
            eng.cache.grow(s_)
            jeng.cache.grow(s_)
            seqs[s_].append(int(np.argmax(want[s_])))


def test_int8_cache_codes_match_reference(np_params):
    """The same K/V into both caches: every layer's QKV weight zeroed,
    so K and V are the QKV bias exactly, in both packages; a fresh bias
    is drawn before every prefill and decode step. The reference's
    programs run eagerly (``jax.disable_jit``: jitted, XLA multiplies
    by 1/127 where the reference divides, C13). Prefill of two prompts
    (``_quantize_pages``), then decode steps that enter pages and grow
    within them (requantize-on-write), a slot leaving: after every call
    the port's int8 codes and scales equal the reference's exactly."""
    import jax
    import jax.numpy as jnp
    zeroed = dict(np_params)
    for li in range(LAYERS):
        zeroed["layer%d_att_qkv_weight" % li] = np.zeros_like(
            np_params["layer%d_att_qkv_weight" % li])
    jcache = JaxKVCache(LAYERS, HEADS, DMODEL // HEADS, 3, SEQ, page=PAGE,
                        int8=True, name="ji8same")
    jeng = JaxDecodeEngine(extract_params(zeroed), HEADS, jcache,
                           JaxCompileCache("ji8same"), name="ji8same")
    cache = KVCache(LAYERS, HEADS, DMODEL // HEADS, 3, SEQ, page=PAGE,
                    int8=True, name="ti8same", device="cpu")
    eng = DecodeEngine(t_extract(zeroed, "cpu"), HEADS, cache,
                       CompileCache("ti8same"), name="ti8same")
    rng = np.random.default_rng(5)

    def new_bias():
        for li in range(LAYERS):
            name = "layer%d_att_qkv_bias" % li
            b = (rng.standard_normal(3 * DMODEL) *
                 rng.uniform(0.1, 3.0)).astype(np.float32)
            jeng.params[name] = jnp.asarray(b)
            eng.params[name] = torch.from_numpy(b)

    with jax.disable_jit():
        for what, got, want, act in _int8_run(
                jeng, eng, ([3, 11, 7, 2, 9], [5, 1, 4]), new_bias):
            for t, j in zip(eng.cache.state(), jeng.cache.state()):
                np.testing.assert_array_equal(t.numpy(), np.asarray(j),
                                              err_msg=what)
            np.testing.assert_allclose(
                got if act is None else got[act],
                want if act is None else want[act], atol=ATOL)
    assert eng.cache.k.dtype == torch.int8
    assert (eng.cache.k_scale != 1).any()


def test_int8_engine_tracks_reference_within_one_level(module, np_params):
    """The real weights: K/V come out of each package's own forward (f32
    roundings apart) and the reference's programs are jitted, so codes
    may differ by one level and scales by a rounding; logits agree at
    atol 1e-4."""
    jeng, eng = _engines(module, np_params, "i8near", int8=True)
    differ = 0
    for what, got, want, act in _int8_run(jeng, eng,
                                          ([3, 11, 7, 2, 9], [5, 1, 4])):
        np.testing.assert_allclose(got if act is None else got[act],
                                   want if act is None else want[act],
                                   atol=ATOL, err_msg=what)
        state, jstate = eng.cache.state(), jeng.cache.state()
        for t, j in zip(state[:2], jstate[:2]):
            gap = np.abs(t.numpy().astype(np.int16) -
                         np.asarray(j).astype(np.int16))
            assert gap.max() <= 1, what
            differ += int((gap > 0).sum())
        for t, j in zip(state[2:], jstate[2:]):
            np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-6,
                                       err_msg=what)
    assert differ < 0.01 * eng.cache.k.numel()


def test_int8_kv_matches_f32_within_tolerance(module, np_params):
    """Teacher-forced on the f32 server's greedy tokens, every int8
    decode step's softmax lies within 5e-2 of the f32 cache's; greedy
    tokens of the int8 server equal the f32 server's and the reference's
    int8 server's."""
    prompt = [3, 11, 7]
    out = {}
    for int8 in (False, True):
        srv = _server(np_params, int8=int8, name="tq%d" % int8)
        try:
            out[int8] = srv.submit_generate(prompt, max_new_tokens=8)\
                .result(timeout=120)
            assert srv.stats()["kv"]["int8"] is int8
        finally:
            srv.close()
    ref = JaxGenerativeServer(module, n_heads=HEADS, max_sequences=4,
                              page=PAGE, int8=True, name="jq1")
    try:
        want = ref.submit_generate(prompt, max_new_tokens=8)\
            .result(timeout=240)
    finally:
        ref.close()
    assert out[False] == out[True] == want
    engines = {}
    for int8 in (False, True):
        cache = KVCache(LAYERS, HEADS, DMODEL // HEADS, 1, SEQ, page=PAGE,
                        int8=int8, name="ttf%d" % int8, device="cpu")
        engines[int8] = DecodeEngine(t_extract(np_params, "cpu"),
                                     HEADS, cache,
                                     CompileCache("ttf%d" % int8))
    seq = list(prompt)
    worst = 0.0
    probs = {k: _softmax(e.prefill(np.array(seq), 0))
             for k, e in engines.items()}
    worst = max(worst, np.abs(probs[True] - probs[False]).max())
    for tok in out[False][:-1]:
        seq.append(tok)
        for k, e in engines.items():
            logits = e.decode_step(np.array([tok]), np.array([len(seq) - 1]),
                                   np.array([True]))
            probs[k] = _softmax(logits[0])
        worst = max(worst, np.abs(probs[True] - probs[False]).max())
    assert worst < 5e-2, worst


def test_generative_server_takes_module_pair_and_dict(module, np_params):
    """``GenerativeServer`` takes a port Module, an ``(arg, aux)`` pair
    or a dict (of NDArrays, tensors or numpy arrays), as the
    reference's does: the same tokens from each."""
    net = port_transformer.get_symbol(vocab_size=VOCAB, num_layers=LAYERS,
                                      d_model=DMODEL, n_heads=HEADS,
                                      seq_len=SEQ)
    mod = mt.mod.Module(net, context=mt.cpu())
    mod.bind(data_shapes=[("data", (1, SEQ))],
             label_shapes=[("softmax_label", (1, SEQ))])
    mod.init_params(arg_params={k: mt.nd.array(v, ctx=mt.cpu())
                                for k, v in np_params.items()})
    arg, aux = mod.get_params()
    sources = {"numpy": np_params, "module": mod, "pair": (arg, aux),
               "ndarrays": dict(arg),
               "tensors": {k: torch.from_numpy(v)
                           for k, v in np_params.items()}}
    got = {}
    for what, src in sources.items():
        srv = _server(src, name="tsrc_" + what)
        try:
            got[what] = srv.submit_generate([3, 1, 4], max_new_tokens=5)\
                .result(timeout=120)
        finally:
            srv.close()
    assert len(set(map(tuple, got.values()))) == 1, got
    params = t_extract(mod, "cpu")
    assert set(params) == set(np_params)
    assert all(p.dtype == torch.float32 for p in params.values())
    # a copy: the served weights do not move with the module's
    before = params["lm_head_bias"].clone()
    mod._exec.arg_dict["lm_head_bias"][:] = 1.0
    assert torch.equal(params["lm_head_bias"], before)


@pytest.mark.parametrize("chunk", [0, -4, 2.5])
def test_prefill_chunk_validated(np_params, chunk):
    with pytest.raises(ValueError, match="prefill_chunk"):
        _server(np_params, name="tchunk", prefill_chunk=chunk)


def test_prefill_chunk_changes_nothing(np_params):
    """The flash kernel's block loop is the online softmax at every
    bucket, so a chunk of 4 gives the same tokens and logits as 512."""
    toks = {}
    for chunk in (512, 4):
        srv = _server(np_params, name="tchunk%d" % chunk,
                      prefill_chunk=chunk)
        try:
            assert srv.engine.prefill_chunk == chunk
            toks[chunk] = srv.submit_generate([9, 2, 6, 5, 3, 5, 8, 1, 2],
                                              max_new_tokens=4)\
                .result(timeout=120)
        finally:
            srv.close()
    assert toks[512] == toks[4]


def test_hbm_audit_at_server_start(module, np_params):
    """``hbm_audit`` is the cache's audit at start; ``stats()["kv"]``
    carries ``int8`` and ``hbm_bytes`` with the scale planes counted,
    equal to the reference's int8 server's."""
    srv = _server(np_params, int8=True, max_sequences=2, name="taudit")
    try:
        assert srv.hbm_audit == {"budget_bytes": 0, "fits": True,
                                 "reserved_bytes": srv.cache.hbm_bytes()}
        kv = srv.stats()["kv"]
    finally:
        srv.close()
    ref = JaxGenerativeServer(module, n_heads=HEADS, max_sequences=2,
                              page=PAGE, int8=True, name="jaudit")
    try:
        want = ref.stats()["kv"]
        assert ref.hbm_audit["reserved_bytes"] == kv["hbm_bytes"]
    finally:
        ref.close()
    assert kv["int8"] is True and kv["hbm_bytes"] == want["hbm_bytes"]
    scale_bytes = 2 * LAYERS * 2 * HEADS * (SEQ // PAGE) * 4
    assert kv["hbm_bytes"] == 2 * LAYERS * 2 * HEADS * SEQ * \
        (DMODEL // HEADS) + scale_bytes


# ------------------------------------------------------- scheduler behavior

def test_streaming_iterator_and_callback(np_params):
    srv = _server(np_params, name="tstream")
    try:
        got = []
        h = srv.submit_generate([2, 4], max_new_tokens=5,
                                on_token=got.append)
        streamed = list(h)
        assert len(streamed) == 5
        assert h.result(timeout=10) == streamed
        assert got == streamed            # callback saw every token
        assert h.done()
    finally:
        srv.close()


def test_join_mid_flight_and_zero_steady_state_recompiles(np_params):
    srv = _server(np_params, name="tjoinflight")
    try:
        first = srv.submit_generate([1, 2, 3], max_new_tokens=12)
        deadline = time.monotonic() + 60
        while not first.tokens_so_far() and time.monotonic() < deadline:
            time.sleep(0.01)
        joiners = [srv.submit_generate([5 + i], max_new_tokens=12)
                   for i in range(2)]
        for h in [first] + joiners:
            assert len(h.result(timeout=120)) == 12
        warm = profiler_counter("tjoinflight_compile")
        assert warm <= srv.engine.executable_bound()
        wave = [srv.submit_generate([i + 1, i + 2], max_new_tokens=9)
                for i in range(4)]
        for h in wave:
            assert len(h.result(timeout=120)) == 9
        assert profiler_counter("tjoinflight_compile") == warm
        st = srv.stats()
        assert st["compiles"] <= st["executable_bound"]
        assert st["kv"]["slots_in_use"] == 0
        assert st["tokens"] >= 3 * 12 + 4 * 9
        assert st["ttft"] and st["tpot"]
    finally:
        srv.close()


def profiler_counter(name):
    from mxnet_tpu_torch import profiler
    return profiler.get_counter(name)


def _wait(pred, what, limit=60):
    deadline = time.monotonic() + limit
    while not pred():
        assert time.monotonic() < deadline, "timed out waiting: " + what
        time.sleep(0.005)


def test_deadline_and_queue_full(np_params):
    """The single slot is held while the scheduler streams long_run's
    first token (its callback waits on ``gate``: a step of this model
    takes a few ms, so polling for residency would race it), so later
    submits queue: one expires before its prefill, and the next ones
    meet the admission bound."""
    gate = threading.Event()
    srv = _server(np_params, max_sequences=1, queue_bound=1, name="tshed")
    try:
        long_run = srv.submit_generate([1, 2], max_new_tokens=12,
                                       on_token=lambda tok: gate.wait(60))
        _wait(lambda: bool(long_run.tokens_so_far()), "first token")
        expired = srv.submit_generate([3], max_new_tokens=2, timeout=0.0)
        with pytest.raises(QueueFull):
            for _ in range(50):
                srv.submit_generate([4], max_new_tokens=2)
        gate.set()
        with pytest.raises(DeadlineExceeded):
            expired.result(timeout=120)
        assert profiler_counter("tshed_shed") >= 1
        assert profiler_counter("tshed_deadline_expired") >= 1
        assert len(long_run.result(timeout=120)) == 12
    finally:
        srv.close()


def test_submit_after_close_raises(np_params):
    srv = _server(np_params, name="tclosed")
    srv.close()
    with pytest.raises(ServerClosed):
        srv.submit_generate([1], max_new_tokens=1)


def test_close_drains_waiting_requests(np_params):
    srv = _server(np_params, max_sequences=1, queue_bound=8, name="tdrain")
    handles = [srv.submit_generate([i + 1], max_new_tokens=3)
               for i in range(3)]
    srv.close(drain=True, timeout=120)
    for h in handles:
        assert len(h.result(timeout=10)) == 3


def test_submit_mid_drain_rejected_promptly(np_params):
    srv = _server(np_params, max_sequences=1, queue_bound=8,
                  name="tmiddrain")
    inflight = srv.submit_generate([1, 2], max_new_tokens=10)
    _wait(lambda: bool(inflight.tokens_so_far()), "first token")
    closer = threading.Thread(target=lambda: srv.close(drain=True,
                                                       timeout=120))
    closer.start()
    _wait(lambda: srv._closed, "close")
    t0 = time.time()
    with pytest.raises(ServerClosed):
        srv.submit_generate([9], max_new_tokens=2)
    assert time.time() - t0 < 1.0
    assert len(inflight.result(timeout=120)) == 10
    closer.join(timeout=120)
    assert not closer.is_alive()


def test_second_close_cannot_revoke_drain_promise(np_params):
    srv = _server(np_params, max_sequences=1, queue_bound=8, name="treclose")
    slow = srv.submit_generate([3, 5], max_new_tokens=10)
    queued = srv.submit_generate([4], max_new_tokens=3)
    _wait(lambda: bool(slow.tokens_so_far()), "first token")
    closer = threading.Thread(target=lambda: srv.close(drain=True,
                                                       timeout=120))
    closer.start()
    _wait(lambda: srv._closed, "close")
    srv.close(drain=False, timeout=120)   # must behave as drain=True
    assert len(slow.result(timeout=120)) == 10
    assert len(queued.result(timeout=120)) == 3
    closer.join(timeout=120)
    assert not closer.is_alive()


def test_batch_server_stats_schema_unchanged():
    """The InferenceServer's stats() keys equal the reference's."""
    from mxnet_tpu import serve as jax_serve
    from mxnet_tpu_torch import serve as port_serve
    xs = np.zeros((4,), np.float32)
    with port_serve.InferenceServer(lambda x: x * 2, max_batch_size=4,
                                    name="tpin", ctx=mt.cpu()) as srv:
        srv.submit(xs).result(timeout=120)
        st = srv.stats()
    with jax_serve.InferenceServer(lambda x: x * 2, max_batch_size=4,
                                   name="jpin") as jsrv:
        jsrv.submit(xs).result(timeout=120)
        want = jsrv.stats()
    assert set(st) == set(want)
    for k in ("requests", "batches", "avg_batch_rows", "buckets",
              "compiles", "cache_hits"):
        assert k in st, k


def test_zero_cost_import_gate():
    """Importing mxnet_tpu_torch (or its serve package) does not import
    the decode path; reaching for KVCache loads it."""
    code = (
        "import sys\n"
        "import mxnet_tpu_torch as mt\n"
        "import mxnet_tpu_torch.serve\n"
        "assert mt.serve is mxnet_tpu_torch.serve\n"
        "bad = [m for m in sys.modules\n"
        "       if m in ('mxnet_tpu_torch.serve.decode',\n"
        "                'mxnet_tpu_torch.serve.kv_cache')]\n"
        "assert not bad, bad\n"
        "from mxnet_tpu_torch.serve import KVCache\n"
        "assert 'mxnet_tpu_torch.serve.kv_cache' in sys.modules\n"
        "assert 'mxnet_tpu_torch.serve.decode' not in sys.modules\n"
        "print('GATE-OK')\n")
    out = subprocess.run([sys.executable, "-c", code], env=dict(os.environ),
                         capture_output=True, text=True, timeout=240)
    assert "GATE-OK" in out.stdout, out.stdout + out.stderr
