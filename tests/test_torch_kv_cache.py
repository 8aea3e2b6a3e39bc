"""The port's KV cache and page ledger against the reference's.

The ledger runs the randomized join/decode/finish interleavings of the
reference's own property test, in lockstep with the reference ledger
and a host-side oracle; the cache's gauges track its ledger exactly,
and ``hbm_bytes`` / ``max_slots_for`` invert each other and agree with
the reference's float32 cache.
"""
import numpy as np
import pytest
import torch

from mxnet_tpu.serve import kv_cache as jax_kv
from mxnet_tpu_torch import profiler
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.serve.kv_cache import KVCache, PageLedger, max_slots_for


def test_ledger_property_matches_reference_ledger():
    """Same seeded interleavings as the reference's property test: both
    ledgers give the same slot and page answers at every step, and both
    match ceil(len/page) accounting after every step."""
    rng = np.random.RandomState(7)
    for _ in range(20):
        max_slots = int(rng.randint(1, 9))
        page = int(rng.choice([2, 4, 8]))
        max_seq = page * int(rng.randint(1, 9))
        led = PageLedger(max_slots, max_seq, page)
        ref = jax_kv.PageLedger(max_slots, max_seq, page)
        model = {}                        # slot -> length (the oracle)
        for _ in range(200):
            op = rng.randint(3)
            if op == 0:                   # join
                n = int(rng.randint(1, max_seq + 1))
                slot = led.acquire(n)
                assert slot == ref.acquire(n)
                if len(model) == max_slots:
                    assert slot is None
                else:
                    assert slot is not None and slot not in model
                    model[slot] = n
            elif op == 1 and model:       # decode one token somewhere
                slot = int(rng.choice(sorted(model)))
                if model[slot] >= max_seq:
                    with pytest.raises(MXNetError):
                        led.grow(slot)
                else:
                    model[slot] += 1
                    assert led.grow(slot) == model[slot] == ref.grow(slot)
            elif op == 2 and model:       # finish
                slot = int(rng.choice(sorted(model)))
                expect = max(1, -(-model.pop(slot) // page))
                assert led.release(slot) == expect == ref.release(slot)
            led.check()
            assert led.slots_in_use == len(model) == ref.slots_in_use
            assert led.pages_in_use == ref.pages_in_use == sum(
                max(1, -(-n // page)) for n in model.values())
            assert led.lengths() == ref.lengths()


def test_ledger_double_free_and_bounds_raise():
    led = PageLedger(max_slots=1, max_seq=8, page=4)
    with pytest.raises(ValueError):
        led.acquire(0)
    s = led.acquire(8)
    assert led.acquire(1) is None
    with pytest.raises(MXNetError, match="max_seq"):
        led.grow(s)
    led.release(s)
    with pytest.raises(MXNetError, match="double-free"):
        led.release(s)


def test_cache_gauges_match_ledger_exactly():
    cache = KVCache(num_layers=1, n_heads=2, d_head=4, max_slots=3,
                    max_seq=8, page=4, name="tgauge", device="cpu")
    rng = np.random.RandomState(3)
    live = []
    for _ in range(60):
        if live and rng.rand() < 0.4:
            cache.release(live.pop(rng.randint(len(live))))
        else:
            s = cache.acquire(int(rng.randint(1, 9)))
            if s is None:
                if live:
                    cache.release(live.pop())
            else:
                live.append(s)
        assert profiler.get_gauge("tgauge_kv_slots_in_use") == \
            cache.ledger.slots_in_use
        assert profiler.get_gauge("tgauge_kv_pages_in_use") == \
            cache.ledger.pages_in_use
        assert abs(profiler.get_gauge("tgauge_kv_occupancy")
                   - cache.ledger.occupancy()) < 1e-12


def test_max_slots_for_inverts_hbm_bytes():
    geo = dict(num_layers=2, n_heads=2, d_head=8, max_seq=32)
    budget = 600_000
    slots = max_slots_for(budget, **geo)
    assert slots == jax_kv.max_slots_for(budget, page=8, **geo)
    cache = KVCache(max_slots=slots, page=8, name="tcap", device="cpu",
                    **geo)
    assert cache.hbm_bytes() <= budget
    bigger = KVCache(max_slots=slots + 1, page=8, name="tcap2",
                     device="cpu", **geo)
    assert bigger.hbm_bytes() > budget
    ref = jax_kv.KVCache(max_slots=slots, page=8, int8=False, name="jcap",
                         **geo)
    assert cache.hbm_bytes() == ref.hbm_bytes()
    assert cache.k.shape == ref.k.shape and cache.k.dtype == torch.float32


def test_cache_without_gpu_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(MXNetError, match="no CUDA device"):
        KVCache(1, 2, 4, 2, 8, page=4)
