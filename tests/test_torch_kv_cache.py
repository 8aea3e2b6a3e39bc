"""The port's KV cache and page ledger against the reference's.

The ledger runs the randomized join/decode/finish interleavings of the
reference's own property test, in lockstep with the reference ledger
and a host-side oracle; the cache's gauges track its ledger exactly,
and ``hbm_bytes`` / ``max_slots_for`` invert each other and agree with
the reference's cache, f32 and int8 (oracle: ``tests/test_kv_cache.py``).
The budget audit (``KVCache.audit``) runs in ``off`` / ``warn`` /
``strict`` as the reference's does, with the analysis package never
imported under ``off``.
"""
import logging
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from mxnet_tpu import config as jax_cfg
from mxnet_tpu.analysis import memory_passes as jax_mem
from mxnet_tpu.serve import kv_cache as jax_kv
from mxnet_tpu_torch import config as cfg
from mxnet_tpu_torch import profiler
from mxnet_tpu_torch.analysis import memory_passes
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.serve.kv_cache import KVCache, PageLedger, max_slots_for

# test files run side by side in parallel workers: each keeps torch's
# intra-op pool small
torch.set_num_threads(2)


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


def test_ledger_basic_lifecycle():
    led = PageLedger(max_slots=4, max_seq=16, page=4)
    ref = jax_kv.PageLedger(max_slots=4, max_seq=16, page=4)
    assert led.total_pages == ref.total_pages == 16
    s = led.acquire(5)
    assert s == ref.acquire(5)
    assert led.pages_in_use == 2          # ceil(5/4)
    for _ in range(3):
        led.grow(s)
    assert led.pages_in_use == 2          # 8 tokens still 2 pages
    led.grow(s)
    assert led.pages_in_use == 3          # 9th token opens page 3
    assert led.release(s) == 3
    assert led.slots_in_use == 0 and led.pages_in_use == 0
    led.check()


@pytest.mark.parametrize("int8", [False, True])
def test_int8_layout_and_bytes_match_reference(int8):
    """The int8 cache keeps int8 K/V and f32 scale planes (L, slots, H,
    max_seq / page) at 1; ``state()`` is four tensors; ``hbm_bytes``
    counts the scales and equals the reference's, and ``max_slots_for``
    is its inverse, as the reference's."""
    geo = dict(num_layers=2, n_heads=2, d_head=8, max_seq=32, page=8)
    budget = 600_000
    slots = max_slots_for(budget, int8=int8, **geo)
    assert slots == jax_kv.max_slots_for(budget, int8=int8, **geo) >= 1
    cache = KVCache(max_slots=slots, int8=int8, name="tcap8",
                    device="cpu", **geo)
    ref = jax_kv.KVCache(max_slots=slots, int8=int8, name="jcap8", **geo)
    assert cache.hbm_bytes() == ref.hbm_bytes() <= budget
    assert KVCache(max_slots=slots + 1, int8=int8, name="tcap8b",
                   device="cpu", **geo).hbm_bytes() > budget
    state, rstate = cache.state(), ref.state()
    assert len(state) == len(rstate) == (4 if int8 else 2)
    for t, r in zip(state, rstate):
        assert tuple(t.shape) == tuple(r.shape)
        assert str(t.dtype).replace("torch.", "") == str(r.dtype)
        np.testing.assert_array_equal(t.numpy(), np.asarray(r))
    assert cache.int8 is int8
    cache.set_state(tuple(t.clone() for t in state))
    assert cache.k.data_ptr() != state[0].data_ptr()
    assert cache.device_bytes() == cache.hbm_bytes()


def test_int8_knob_default():
    cfg.set("MXNET_TPU_SERVE_KV_INT8", True)
    try:
        assert KVCache(1, 2, 4, 2, 8, page=4, name="tknob",
                       device="cpu").k.dtype == torch.int8
    finally:
        cfg.reset("MXNET_TPU_SERVE_KV_INT8")
    assert KVCache(1, 2, 4, 2, 8, page=4, name="tknob",
                   device="cpu").k.dtype == torch.float32


def test_int8_doubles_resident_sequences():
    geo = dict(num_layers=2, n_heads=4, d_head=16, max_seq=64, page=16)
    budget = 4 * 1024 * 1024
    f32_slots = max_slots_for(budget, int8=False, **geo)
    i8_slots = max_slots_for(budget, int8=True, **geo)
    assert f32_slots >= 1
    assert i8_slots >= 2 * f32_slots
    assert (f32_slots, i8_slots) == (
        jax_kv.max_slots_for(budget, int8=False, **geo),
        jax_kv.max_slots_for(budget, int8=True, **geo))


@pytest.mark.parametrize("spec", ["16G", "16GB", "512MiB", "1.5T", "1K",
                                  "2048", "", None, "3m"])
def test_parse_bytes_matches_reference(spec):
    assert memory_passes.parse_bytes(spec) == jax_mem.parse_bytes(spec)


@pytest.mark.parametrize("spec", ["lots", "-1G"])
def test_parse_bytes_rejects_as_reference(spec):
    with pytest.raises(ValueError):
        jax_mem.parse_bytes(spec)
    with pytest.raises(ValueError):
        memory_passes.parse_bytes(spec)


def test_audit_zero_cost_when_analyze_off():
    code = (
        "import sys\n"
        "import mxnet_tpu_torch  # noqa: F401\n"
        "from mxnet_tpu_torch.serve.kv_cache import KVCache\n"
        "c = KVCache(1, 2, 4, 2, 8, page=4, int8=True, name='zc',\n"
        "            device='cpu')\n"
        "out = c.audit()\n"
        "assert out == {'budget_bytes': 0, 'fits': True,\n"
        "               'reserved_bytes': c.hbm_bytes()}, out\n"
        "assert not any(m.startswith('mxnet_tpu_torch.analysis')\n"
        "               for m in sys.modules), 'analysis imported'\n"
        "print('ZC-OK')\n")
    env = dict(os.environ)
    env["MXNET_TPU_ANALYZE"] = "off"
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=240)
    assert "ZC-OK" in out.stdout, out.stdout + out.stderr


def _analyze(monkeypatch, mode, budget):
    monkeypatch.setenv("MXNET_TPU_ANALYZE", mode)
    monkeypatch.setenv("MXNET_TPU_ANALYZE_HBM_BUDGET", budget)
    for c in (cfg, jax_cfg):
        c.reset("MXNET_TPU_ANALYZE")
        c.reset("MXNET_TPU_ANALYZE_HBM_BUDGET")


def test_audit_strict_rejects_naming_reservation(monkeypatch):
    _analyze(monkeypatch, "strict", "1K")
    geo = dict(num_layers=2, n_heads=2, d_head=8, max_slots=4, max_seq=32,
               page=8, int8=False, name="trej")
    cache = KVCache(device="cpu", **geo)
    with pytest.raises(MXNetError) as err:
        cache.audit()
    msg = str(err.value)
    assert "hbm-budget" in msg
    assert "trej_kv_cache" in msg             # the reservation is NAMED
    assert "MXNET_TPU_SERVE_KV_INT8" in msg   # and the remedy offered
    from mxnet_tpu.base import MXNetError as JaxError
    with pytest.raises(JaxError) as jerr:
        jax_kv.KVCache(**geo).audit()
    assert str(err.value) == str(jerr.value)


def test_audit_warn_fits_under_big_budget(monkeypatch, caplog):
    _analyze(monkeypatch, "warn", "1G")
    geo = dict(num_layers=1, n_heads=2, d_head=4, max_slots=2, max_seq=8,
               page=4, int8=True, name="tfits")
    cache = KVCache(device="cpu", **geo)
    out = cache.audit()
    assert out == jax_kv.KVCache(**geo).audit()
    assert out["fits"] is True
    assert out["reserved_bytes"] == cache.hbm_bytes()
    # over budget under warn: a warning naming it, and fits False
    _analyze(monkeypatch, "warn", "100")
    with caplog.at_level(logging.WARNING):
        out = cache.audit()
    assert out["fits"] is False and out["budget_bytes"] == 100
    assert "tfits_kv_cache" in caplog.text
