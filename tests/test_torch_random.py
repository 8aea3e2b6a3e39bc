"""The port's key chain (``mxnet_tpu_torch.random``) against the
reference's (``mxnet_tpu.random``, on jax's threefry).

The port computes jax's threefry2x32 key chain in numpy, so that
``fit``'s default initializer, which draws from
``derive_numpy_rng("fit_default_init")``, starts a seeded port fit from
the reference's initial weights. Keys are uint32 words and draws come
from the same numpy generator: everything here is compared for exact
equality.
"""
import jax
import numpy as np
import pytest

import mxnet_tpu as mx
import mxnet_tpu.random as ref_random
import mxnet_tpu_torch as mt
from mxnet_tpu_torch import random as port_random

SEEDS = [0, 7, 12345, 2 ** 31 - 1, -3]


def _words(key):
    return np.asarray(jax.random.key_data(key)).astype(np.uint32)


@pytest.fixture(autouse=True)
def _restore_keys():
    """Both chains are process state: leave them as they were."""
    ref_key, port_key = ref_random.current_key(), port_random.current_key()
    yield
    ref_random.set_key(ref_key)
    port_random.set_key(port_key)


@pytest.mark.parametrize("seed", SEEDS)
def test_prng_key_split_and_fold_in_match_jax(seed):
    """PRNGKey, split into 2 and 5, fold_in, and a chain of them, word
    for word."""
    jk, pk = jax.random.PRNGKey(seed), port_random.prng_key(seed)
    assert np.array_equal(_words(jk), pk)
    for num in (2, 5):
        assert np.array_equal(np.asarray(jax.random.split(jk, num)),
                              port_random.split(pk, num))
    for data in (0, 1, 0x7FFFFFFF, 0xFFFFFFFF):
        assert np.array_equal(np.asarray(jax.random.fold_in(jk, data)),
                              port_random.fold_in(pk, data))
    for step in range(6):
        jk = jax.random.split(jk)[step % 2]
        pk = port_random.split(pk)[step % 2]
        jk = jax.random.fold_in(jk, 1000 + step)
        pk = port_random.fold_in(pk, 1000 + step)
        assert np.array_equal(_words(jk), pk)


@pytest.mark.parametrize("seed", SEEDS)
def test_seeded_key_chain_matches_the_reference(seed):
    """After seed(s), next_key and current_key follow the reference's
    chain bit for bit, and set_key restores a captured key."""
    ref_random.seed(seed)
    port_random.seed(seed)
    assert np.array_equal(_words(ref_random.current_key()),
                          port_random.current_key())
    for _ in range(4):
        assert np.array_equal(_words(ref_random.next_key()),
                              port_random.next_key())
    saved = port_random.current_key()
    port_random.next_key()
    port_random.set_key(saved)
    assert np.array_equal(port_random.current_key(), saved)
    assert np.array_equal(_words(ref_random.next_key()),
                          port_random.next_key())


@pytest.mark.parametrize("tag", ["", "fit_default_init", "dropout"])
def test_derive_numpy_rng_draws_equal_the_reference(tag):
    for seed in (0, 42):
        ref_random.seed(seed)
        port_random.seed(seed)
        for _ in range(2):
            want = ref_random.derive_numpy_rng(tag).uniform(size=16)
            got = port_random.derive_numpy_rng(tag).uniform(size=16)
            assert np.array_equal(got, want)


def test_state_is_per_thread():
    """Each thread has its own key (seeded 0 until seeded), as in the
    reference."""
    import threading
    port_random.seed(5)
    seen = {}
    worker = threading.Thread(
        target=lambda: seen.update(key=port_random.current_key()))
    worker.start()
    worker.join(timeout=30)
    assert not worker.is_alive()
    assert np.array_equal(seen["key"], port_random.prng_key(0))
    assert np.array_equal(port_random.current_key(), port_random.prng_key(5))


def _mlp(S):
    data = S.sym.Variable("data")
    h = S.sym.FullyConnected(data, num_hidden=16, name="fc1")
    h = S.sym.Activation(h, act_type="relu", name="relu1")
    h = S.sym.FullyConnected(h, num_hidden=4, name="fc2")
    return S.sym.SoftmaxOutput(h, name="softmax")


def _batch():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((8, 10)).astype(np.float32)
    return x, (np.arange(8) % 4).astype(np.float32)


def _port_fit_init(seed):
    """A port fit of no epochs: bind and the default initializer only."""
    mt.random.seed(seed)
    x, y = _batch()
    mod = mt.mod.Module(_mlp(mt), context=mt.cpu())
    mod.fit(mt.io.NDArrayIter(x, y, batch_size=4), num_epoch=0,
            eval_metric="ce")
    return {k: v.data.numpy() for k, v in mod.get_params()[0].items()}


def test_seeded_fits_start_from_the_reference_weights():
    """Two port fits after the same seed start from identical weights,
    and those are the reference fit's, exactly; another seed draws
    others."""
    mx.random.seed(11)
    x, y = _batch()
    ref = mx.mod.Module(_mlp(mx), context=mx.cpu())
    ref.fit(mx.io.NDArrayIter(x, y, batch_size=4), num_epoch=0,
            eval_metric="ce")
    want = {k: v.asnumpy() for k, v in ref.get_params()[0].items()}
    first, second = _port_fit_init(11), _port_fit_init(11)
    assert sorted(first) == sorted(want)
    for name in want:
        assert np.array_equal(first[name], second[name])
        assert np.array_equal(first[name], want[name])
    assert np.abs(want["fc1_weight"]).max() > 0      # drawn, not filled
    other = _port_fit_init(12)
    assert not np.array_equal(other["fc1_weight"], first["fc1_weight"])
