"""The samplers of the port (``ops/random_op.py``), by distribution.

The port draws from torch's generators seeded from ``mt.random``'s key
chain, the reference from jax's threefry keys, so the two packages agree
in distribution and never bit for bit. Each sampler runs through
``chip_smoke.sampler_check`` (phase 12b's check, here on the CPU at
2·10^5 draws after ``mt.random.seed(0)``, so the test is deterministic):
mean and variance within 6 standard errors of the distribution's own,
a KS test (continuous) or a χ² test (discrete) at p ≥ 1e-6. The
reference's own draws pass the same check, so both packages sample the
same distribution. Then ``_sample_multinomial`` (χ² per row,
``get_prob``), ``shuffle`` (a permutation), the ``nd.random`` and
``sym.random`` names, shape inference without drawing (``meta_fn``), a
seeded run repeating itself, and the samplers staying off the tape.
"""
import numpy as np
import pytest
import torch

import jax

import chip_smoke
import mxnet_tpu as mx
import mxnet_tpu_torch as mt
from mxnet_tpu.ops import get_op as ref_op
from mxnet_tpu_torch.ops import get_op

N = 200000
CASES = chip_smoke.sampler_cases()


@pytest.fixture
def quiet(monkeypatch):
    lines = []
    monkeypatch.setattr(chip_smoke, "log", lambda *a: lines.append(a[0]))
    return lines


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_sampler_distribution(quiet, case):
    name, attrs, dist, discrete = case
    mt.random.seed(0)
    chip_smoke.sampler_check(torch, np, name, attrs, dist, discrete, N,
                             device="cpu")
    assert quiet[-1].startswith("sampler %s" % name)


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_the_reference_samples_the_same_distribution(quiet, monkeypatch,
                                                     case):
    """The reference's draws pass the same check: the two packages sample
    one distribution."""
    name, attrs, dist, discrete = case

    def ref_fn(shape=(), _device=None, **kw):
        out = ref_op(name).fn(shape=shape, _rng=jax.random.PRNGKey(0), **kw)
        return torch.from_numpy(np.asarray(out))
    monkeypatch.setattr(get_op(name), "fn", ref_fn)
    chip_smoke.sampler_check(torch, np, name, attrs, dist, discrete, N,
                             device="cpu")


def test_multinomial_and_shuffle(quiet):
    mt.random.seed(0)
    chip_smoke.multinomial_check(torch, np, N, device="cpu")
    assert any(ln.startswith("shuffle: arange") for ln in quiet)


@pytest.mark.parametrize("shape, want", [((), (3,)), (4, (3, 4)),
                                         ((2, 3), (3, 6))])
def test_multinomial_shapes(shape, want):
    probs = torch.full((3, 5), 0.2)
    mt.random.seed(1)
    ids = get_op("_sample_multinomial").fn(probs, shape=shape)
    assert tuple(ids.shape) == want and ids.dtype == torch.int32
    assert int(ids.min()) >= 0 and int(ids.max()) <= 4


def test_sampler_names_in_nd_and_sym():
    with mt.device_scope("cpu"):
        for short, full in mt.nd.RANDOM_NAMES.items():
            assert getattr(mt.nd.random, short).__name__ == \
                get_op(full).name
        mt.random.seed(2)
        u = mt.nd.random.uniform(low=2.0, high=3.0, shape=(4, 5))
        assert u.shape == (4, 5) and 2.0 <= u.asnumpy().min()
        for alias in ("uniform", "random_uniform", "_sample_uniform"):
            assert get_op(alias) is get_op("_random_uniform")
        s = mt.sym.random.normal(loc=1.0, shape=(3, 2), name="noise") + \
            mt.sym.Variable("x")
        assert s.infer_shape(x=(3, 2))[1] == [(3, 2)]
        ex = s.simple_bind(mt.cpu(), x=(3, 2))
        assert np.isfinite(ex.forward()[0].asnumpy()).all()


def test_a_seeded_run_repeats_itself():
    draws = []
    for _ in range(2):
        mt.random.seed(7)
        with mt.device_scope("cpu"):
            draws.append([mt.nd.random.normal(shape=(5,)).asnumpy(),
                          mt.nd.random.poisson(lam=3.0, shape=(5,))
                          .asnumpy()])
    for a, b in zip(*draws):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name", ["_random_uniform", "_random_gamma",
                                  "_random_poisson", "_sample_multinomial",
                                  "shuffle"])
def test_samplers_are_not_recorded(name):
    """Under ``record()`` a sampler's result has no graph in either
    package: a marked input reaches no head through it."""
    for pkg, kw in ((mx, {}), (mt, {"ctx": mt.cpu()})):
        x = pkg.nd.array(np.full((2, 3), 0.25, np.float32), **kw)
        x.attach_grad()
        with pkg.autograd.record():
            if name in ("_sample_multinomial", "shuffle"):
                out = getattr(pkg.nd, name)(x)
            else:
                out = getattr(pkg.nd, name)(shape=(2, 3), **kw) * 1.0
        if pkg is mt:
            assert not out.data.requires_grad
        with pytest.raises(ValueError):
            out.astype("float32").sum().backward()
