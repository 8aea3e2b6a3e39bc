"""The port's lock witness (``mxnet_tpu_torch.lockcheck`` /
``MXNET_TPU_LOCKCHECK``) on every scenario of the reference's
``tests/test_lockcheck.py``.

A real two-thread ABBA inversion is provoked and must be flagged online
(warn counts and logs, abort raises BEFORE the blocking acquire),
held-lock host syncs are caught at the NDArray sync points
(``note_sync``), a lock made with ``allow_sync=True`` is exempt, and the
off path is proven in a subprocess to build no wrapper and move no
``lockcheck_*`` counter. The same scenarios run against the reference
package where the two packages share them (the inversion and held-sync
counts), so both witnesses are held to one behaviour.
"""
import os
import subprocess
import sys
import textwrap
import threading
import time

import numpy as np
import pytest
import torch

import mxnet_tpu_torch as mt
from mxnet_tpu_torch import config, lockcheck, profiler
from mxnet_tpu_torch.base import MXNetError

# test files run side by side in parallel workers: each keeps torch's
# intra-op pool small
torch.set_num_threads(2)

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
CPU = mt.cpu()


@pytest.fixture()
def witness_mode(request):
    mode = getattr(request, "param", "warn")
    config.set("MXNET_TPU_LOCKCHECK", mode)
    lockcheck.reset_order_graph()
    yield mode
    config.reset("MXNET_TPU_LOCKCHECK")
    lockcheck.reset_order_graph()


def run_in_thread(fn):
    exc = []

    def body():
        try:
            fn()
        except BaseException as e:                         # noqa: BLE001
            exc.append(e)

    t = threading.Thread(target=body)
    t.start()
    t.join(timeout=30)
    assert not t.is_alive(), "witness thread hung"
    return exc


def _nest(outer, inner):
    with outer:
        with inner:
            pass


# ============================================================ inversion


def test_abba_inversion_warn_counts(witness_mode):
    a = lockcheck.Lock(name="A")
    b = lockcheck.Lock(name="B")
    with profiler.counter_delta() as d:
        run_in_thread(lambda: _nest(a, b))
        run_in_thread(lambda: _nest(b, a))
        assert d.get("lockcheck_inversion") == 1, d.all()
        # the pair is flagged once, not once per re-observation
        run_in_thread(lambda: _nest(b, a))
        assert d.get("lockcheck_inversion") == 1, d.all()


@pytest.mark.parametrize("witness_mode", ["abort"], indirect=True)
def test_abba_inversion_abort_raises(witness_mode):
    a = lockcheck.Lock(name="A")
    b = lockcheck.Lock(name="B")
    with profiler.counter_delta() as d:
        assert run_in_thread(lambda: _nest(a, b)) == []
        exc = run_in_thread(lambda: _nest(b, a))
        assert len(exc) == 1 and isinstance(exc[0], MXNetError), exc
        assert "inversion" in str(exc[0])
        assert "while holding lock[B]" in str(exc[0])
        assert "while holding lock[A]" in str(exc[0])
        assert d.get("lockcheck_inversion") == 1, d.all()


def test_consistent_order_is_silent(witness_mode):
    a = lockcheck.Lock(name="A")
    b = lockcheck.Lock(name="B")
    with profiler.counter_delta() as d:
        for _ in range(3):
            run_in_thread(lambda: _nest(a, b))
        assert d.get("lockcheck_inversion") == 0, d.all()


def test_rlock_reentry_is_not_an_inversion(witness_mode):
    r = lockcheck.RLock(name="R")
    other = lockcheck.Lock(name="O")
    with profiler.counter_delta() as d:
        with r:
            with other:
                with r:          # reentrant re-acquire while holding O
                    pass
        assert d.get("lockcheck_inversion") == 0, d.all()


def test_trylock_records_no_edges(witness_mode):
    a = lockcheck.Lock(name="A")
    b = lockcheck.Lock(name="B")

    def t1():
        with a:
            assert b.acquire(False)
            b.release()

    def t2():
        with b:
            assert a.acquire(False)
            a.release()

    with profiler.counter_delta() as d:
        run_in_thread(t1)
        run_in_thread(t2)
        assert d.get("lockcheck_inversion") == 0, d.all()


def test_condition_wait_notify_through_funnel(witness_mode):
    cond = lockcheck.Condition(name="C")
    done = []

    def waiter():
        with cond:
            cond.wait(timeout=10)
            done.append(True)

    t = threading.Thread(target=waiter)
    t.start()
    time.sleep(0.2)
    with cond:
        cond.notify_all()
    t.join(timeout=10)
    assert done == [True]
    with profiler.counter_delta() as d:
        with cond:
            pass
        assert d.get("lockcheck_inversion") == 0, d.all()


def test_condition_sharing_witnessed_lock(witness_mode):
    lock = lockcheck.Lock(name="shared")
    cond = lockcheck.Condition(lock)
    assert isinstance(lock, lockcheck._WitnessLock)
    with cond:
        cond.notify_all()
    assert not lock.locked()


# ============================================================ held sync


def test_held_sync_counts_and_warns(witness_mode):
    x = mt.nd.array(np.zeros(3), ctx=CPU)
    guard = lockcheck.Lock(name="guard")
    with profiler.counter_delta() as d:
        with guard:
            x.asnumpy()
        assert d.get("lockcheck_held_sync") == 1, d.all()
        with guard:
            x.asnumpy()          # same (site, sync) pair: once
        assert d.get("lockcheck_held_sync") == 1, d.all()
        with guard:
            x.wait_to_read()     # another sync point: its own pair
        assert d.get("lockcheck_held_sync") == 2, d.all()


def test_allow_sync_lock_is_exempt(witness_mode):
    x = mt.nd.array(np.zeros(3), ctx=CPU)
    ok = lockcheck.Lock(name="justified", allow_sync=True)
    with profiler.counter_delta() as d:
        with ok:
            x.asnumpy()
            x.wait_to_read()
            x[0:1].asscalar()
        assert d.get("lockcheck_held_sync") == 0, d.all()


@pytest.mark.parametrize("witness_mode", ["abort"], indirect=True)
def test_held_sync_abort_raises(witness_mode):
    x = mt.nd.array(np.zeros(3), ctx=CPU)
    guard = lockcheck.Lock(name="guard2")
    with pytest.raises(MXNetError, match="host sync"):
        with guard:
            x.asnumpy()


def test_unlocked_sync_is_silent(witness_mode):
    x = mt.nd.array(np.zeros(3), ctx=CPU)
    with profiler.counter_delta() as d:
        x.asnumpy()
        x.wait_to_read()
        assert d.get("lockcheck_held_sync") == 0, d.all()


def test_held_sync_counts_like_the_reference(witness_mode):
    """The same scenario through both packages' witnesses: a plain lock
    held over two syncs of one kind and one of another, an allow_sync
    lock over all three — equal counter deltas."""
    import mxnet_tpu as mx
    from mxnet_tpu import config as jcfg
    from mxnet_tpu import lockcheck as jlc
    from mxnet_tpu import profiler as jprof

    def scenario(pkg, lc, prof, arr):
        plain = lc.Lock(name="parity.plain")
        allowed = lc.Lock(name="parity.allowed", allow_sync=True)
        with prof.counter_delta() as d:
            with plain:
                arr.asnumpy()
                arr.asnumpy()
                arr.wait_to_read()
            with allowed:
                arr.asnumpy()
                arr.wait_to_read()
            return d.get("lockcheck_held_sync")

    jcfg.set("MXNET_TPU_LOCKCHECK", "warn")
    jlc.reset_order_graph()
    try:
        ref = scenario(mx, jlc, jprof, mx.nd.array(np.zeros(3)))
    finally:
        jcfg.reset("MXNET_TPU_LOCKCHECK")
        jlc.reset_order_graph()
    got = scenario(mt, lockcheck, profiler,
                   mt.nd.array(np.zeros(3), ctx=CPU))
    assert got == ref == 2


# ============================================================= zero cost


def test_lockcheck_off_is_zero_cost():
    """Knob off (default): the funnels return PLAIN threading
    primitives, and sync points record nothing — in a fresh
    interpreter."""
    prog = textwrap.dedent("""
        import sys, threading
        sys.path.insert(0, %r)
        import numpy as np
        import mxnet_tpu_torch as mt
        from mxnet_tpu_torch import lockcheck, profiler

        l = lockcheck.Lock(name="x")
        r = lockcheck.RLock()
        c = lockcheck.Condition()
        assert type(l) is type(threading.Lock()), type(l)
        assert type(r) is type(threading.RLock()), type(r)
        assert type(c) is threading.Condition, type(c)

        x = mt.nd.array(np.arange(8.0), ctx=mt.cpu())
        with l:
            x.asnumpy()
            x.wait_to_read()
        bad = [k for k in profiler.counters() if k.startswith("lockcheck")]
        assert not bad, bad
        print("LOCKCHECK_ZERO_COST_OK")
    """) % (REPO,)
    env = dict(os.environ, PYTHONPATH="")
    env.pop("MXNET_TPU_LOCKCHECK", None)
    res = subprocess.run([sys.executable, "-c", prog], env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert "LOCKCHECK_ZERO_COST_OK" in res.stdout


def test_mode_flip_affects_new_locks(witness_mode):
    assert lockcheck.mode() == "warn"
    config.set("MXNET_TPU_LOCKCHECK", "off")
    try:
        plain = lockcheck.Lock()
        assert type(plain) is type(threading.Lock())
    finally:
        config.set("MXNET_TPU_LOCKCHECK", "warn")
