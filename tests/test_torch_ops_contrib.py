"""The contrib ops of the port against the reference's
(``mxnet_tpu/ops/contrib.py``): the fork's Stochastic Activation Pruning,
``quantize``, ``dequantize``, ``count_sketch``, ``fft`` and ``ifft``;
``MoE`` raises, naming ROADMAP A9.

The deterministic ops run through ``check_op`` (forward and gradients,
1e-5 / 1e-4 of max(1, max|ref|)) at ``tests/test_op_sweep.py``'s inputs
and more. SAP draws from each package's own generator, so the two agree
in distribution: over 200 draws of a (16, 20) activation at k = 10,
each element's kept share in each package lies within 6 binomial
deviations of ``1 - (1 - p)^k`` and within 6 deviations of the other
package's; a kept value is ``act / (1 - (1 - p)^k)`` in both (the same
f32 formula, within 1e-6 of itself); each row's mean sum lies within 6
standard errors of its activations' sum (unbiased); a zero-probability
column is never kept. Where the draw is forced (one-hot ``prob`` rows,
any k) the two packages agree exactly, gradients included: ``grad *
mask`` into ``act`` and zeros into ``prob``.
"""
import numpy as np
import pytest
import torch

import jax

import mxnet_tpu as mx
import mxnet_tpu_torch as mt
from mxnet_tpu_torch.base import MXNetError
from test_torch_ops_parity import check_op, run_both, sweep_case

SAP = "stochastic_activation_pruning"
ROWS, COLS, FRAC = 16, 20, 0.5
DRAWS = 200
SIGMAS = 6.0


@pytest.mark.parametrize("name", ["quantize", "dequantize", "count_sketch",
                                  "fft", "ifft"])
def test_sweep(name):
    inputs, attrs = sweep_case(name)
    check_op(name, inputs, attrs)


@pytest.mark.parametrize("out_type", ["uint8", "int8"])
def test_quantize_half_way_and_clipped(out_type):
    """Values half way between two levels round to even, and values
    outside the range clip, as ``jnp.round`` / ``jnp.clip`` do."""
    lo, hi = np.float32([-1.0]), np.float32([1.0])
    step = 2.0 / (255.0 if out_type == "uint8" else 254.0)
    base = -1.0 if out_type == "uint8" else 0.0
    x = np.array([base + 0.5 * step, base + 1.5 * step, base + 2.5 * step,
                  -3.0, 3.0, 0.25], np.float32)
    ref, port = check_op("quantize", [x, lo, hi], {"out_type": out_type})
    np.testing.assert_array_equal(port["outs"][0], ref["outs"][0])
    check_op("dequantize", [port["outs"][0], lo, hi])


def test_count_sketch_drops_buckets_outside():
    rng = np.random.default_rng(0)
    h = np.array([0, 3, 5, -1, -6, 2, 1, 4], np.float32)
    s = np.sign(rng.standard_normal(8)).astype(np.float32)
    check_op("count_sketch", [rng.standard_normal((3, 8)).astype(np.float32),
                              h, s], {"out_dim": 5})


def test_fft_round_trip():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 3, 8)).astype(np.float32)
    ref, port = check_op("fft", [x])
    _, back = run_both("ifft", [port["outs"][0]])
    np.testing.assert_allclose(back["outs"][0], 8 * x, atol=1e-4)


def test_moe_raises_naming_a9():
    with mt.device_scope("cpu"):
        x = mt.nd.zeros((2, 4))
        for fn in (mt.nd.MoE, mt.contrib.nd.MoE):
            with pytest.raises(MXNetError, match="A9"):
                fn(x, x, x, x)


# ---------------------------------------------------------------------- SAP

def _sap_inputs(seed):
    rng = np.random.default_rng(seed)
    act = (rng.uniform(0.5, 2.0, (ROWS, COLS)) *
           rng.choice([-1, 1], (ROWS, COLS))).astype(np.float32)
    w = rng.uniform(0.0, 1.0, (ROWS, COLS))
    w[:, :3] = 0.0                      # zero-probability columns
    w[0, 3:] = 0.0
    w[0, 3] = 1.0                       # a row with one column: forced
    prob = (w / w.sum(1, keepdims=True)).astype(np.float32)
    return act, prob


def _draws_ref(act, prob):
    """The reference's draws, eager as its own tests run the op (under
    ``jax.jit`` XLA rounds the rescale differently, by up to 5e-6)."""
    fn = mx.ops.get_op(SAP).fn
    keys = jax.random.split(jax.random.PRNGKey(7), DRAWS)
    return np.stack([np.asarray(fn(act, prob, frac=FRAC, _rng=k))
                     for k in keys])


def _draws_port(act, prob):
    mt.random.seed(7)
    fn = mt.ops.get_op(SAP).fn
    a, p = torch.from_numpy(act), torch.from_numpy(prob)
    return np.stack([fn(a, p, frac=FRAC).numpy() for _ in range(DRAWS)])


@pytest.fixture(scope="module")
def sap_draws():
    act, prob = _sap_inputs(3)
    return act, prob, _draws_ref(act, prob), _draws_port(act, prob)


def _q(prob, k):
    return 1.0 - (1.0 - prob.astype(np.float64)) ** k


def test_sap_kept_share(sap_draws):
    act, prob, ref, port = sap_draws
    k = max(int(FRAC * COLS), 1)
    q = _q(prob, k)
    sd = np.sqrt(DRAWS * q * (1 - q))
    for outs in (ref, port):
        kept = (outs != 0).sum(0)
        assert np.all(np.abs(kept - DRAWS * q) <= SIGMAS * sd + 1)
    diff = np.abs((port != 0).sum(0) - (ref != 0).sum(0))
    assert np.all(diff <= SIGMAS * np.sqrt(2) * sd + 1)


def _f32_weight(prob, k):
    """``1 / (1 - (1 - p)^k)`` in float32, the power by repeated
    squaring (``lax.integer_pow``'s order)."""
    acc, x = None, (np.float32(1) - prob).astype(np.float32)
    while k > 0:
        if k & 1:
            acc = x if acc is None else acc * x
        k >>= 1
        if k > 0:
            x = x * x
    return np.float32(1) / (np.float32(1) - acc)


def test_sap_rescale(sap_draws):
    act, prob, ref, port = sap_draws
    want = act * _f32_weight(prob, max(int(FRAC * COLS), 1))
    for outs in (ref, port):
        kept = outs != 0
        np.testing.assert_allclose(outs[kept],
                                   np.broadcast_to(want, outs.shape)[kept],
                                   rtol=1e-6)
    both = (ref != 0) & (port != 0)
    np.testing.assert_array_equal(port[both], ref[both])


def test_sap_unbiased(sap_draws):
    act, prob, ref, port = sap_draws
    k = max(int(FRAC * COLS), 1)
    q = _q(prob, k)
    live = prob > 0
    se = np.sqrt((np.where(live, act.astype(np.float64) ** 2 * (1 - q)
                           / np.where(live, q, 1.0), 0.0)).sum(1) / DRAWS)
    target = np.where(live, act, 0.0).sum(1)
    for outs in (ref, port):
        dev = np.abs(outs.astype(np.float64).sum(2).mean(0) - target)
        assert np.all(dev <= SIGMAS * np.maximum(se, 1e-6))


def test_sap_zero_probability_columns(sap_draws):
    act, prob, ref, port = sap_draws
    for outs in (ref, port):
        assert not np.any(outs[:, prob == 0])
        assert np.all(outs[:, 0, 3] == act[0, 3])        # forced, weight 1


@pytest.mark.parametrize("frac", [0.5, 0.01])
def test_sap_forced_draw_is_exact(frac):
    """One-hot ``prob`` rows force every draw (``frac`` 0.01 gives k =
    1): both packages keep exactly the hot column at weight 1, and the
    gradients (the mask into ``act``, zeros into ``prob``) agree."""
    rng = np.random.default_rng(5)
    act = rng.standard_normal((4, 3, 6)).astype(np.float32)
    prob = np.zeros((4, 18), np.float32)
    prob[np.arange(4), [0, 5, 11, 17]] = 1.0
    ref, port = run_both(SAP, [act, prob.reshape(4, 3, 6)], {"frac": frac},
                         ref_attrs={"_rng": jax.random.PRNGKey(0)})
    np.testing.assert_array_equal(port["outs"][0], ref["outs"][0])
    for g, w in zip(port["grads"], ref["grads"]):
        np.testing.assert_array_equal(g, w)
    assert np.count_nonzero(port["outs"][0]) == 4


def test_sap_aliases_and_symbol():
    for name in ("StochasticActivationPruning", "sap"):
        assert mt.ops.get_op(name) is mt.ops.get_op(SAP)
    s = mt.sym.sap(mt.sym.Variable("act"), mt.sym.Variable("prob"), frac=0.5)
    assert s.list_arguments() == ["act", "prob"]
    _, out, _ = s.infer_shape(act=(4, 6), prob=(4, 6))
    assert out == [(4, 6)]
