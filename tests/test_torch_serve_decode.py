"""The port's generative serving path against the reference's.

Weights come from a reference ``Module`` (the zoo transformer, vocab
128, 2 layers, d_model 32, 2 heads, seq 16, page 4) and cross to the
port through ``params_from_numpy``. Prefill and decode logits are held
against the reference ``DecodeEngine`` (dense prefill attention, and the
chunked path with ``prefill_chunk=4``) at atol 1e-4 in f32, the
tolerance the reference's own decode tests hold its engine to against
its training forward; greedy tokens from both ``GenerativeServer``s
must be identical. The scheduler tests mirror the reference's.
"""
import time

import numpy as np
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu._fused import CompileCache as JaxCompileCache
from mxnet_tpu.serve import GenerativeServer as JaxGenerativeServer
from mxnet_tpu.serve.decode import DecodeEngine as JaxDecodeEngine
from mxnet_tpu.serve.decode import extract_params
from mxnet_tpu.serve.kv_cache import KVCache as JaxKVCache
from mxnet_tpu_torch import faults
from mxnet_tpu_torch._fused import CompileCache
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.models import transformer as port_transformer
from mxnet_tpu_torch.serve import GenerativeServer, ServeError
from mxnet_tpu_torch.serve.decode import DecodeEngine, params_from_numpy
from mxnet_tpu_torch.serve.kv_cache import KVCache

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


def _engines(module, np_params, name, prefill_chunk=512, slots=3):
    jcache = JaxKVCache(LAYERS, HEADS, DMODEL // HEADS, slots, SEQ,
                        page=PAGE, int8=False, name="j" + name)
    jeng = JaxDecodeEngine(extract_params(module), HEADS, jcache,
                           JaxCompileCache("j" + name), name="j" + name,
                           prefill_chunk=prefill_chunk)
    cache = KVCache(LAYERS, HEADS, DMODEL // HEADS, slots, SEQ, page=PAGE,
                    name="t" + name, device="cpu")
    eng = DecodeEngine(params_from_numpy(np_params, "cpu"), HEADS, cache,
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
        params_from_numpy(np_params)


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
