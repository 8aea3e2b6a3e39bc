"""The port's initializer dispatch on the reference's aux and upsampling
names (``mxnet_tpu/initializer.py`` ``Initializer.__call__``).

``*moving_mean``, ``*moving_inv_var`` and ``*moving_avg`` are set to 0,
``*moving_var`` to 1, and ``*upsampling`` to a bilinear kernel; the
other names keep their dispatch. Every value is a float32 constant or a
fixed formula evaluated in numpy on both sides, so the outputs are
compared for exact equality.
"""
import numpy as np
import pytest

import mxnet_tpu as mx
import mxnet_tpu_torch as mt
import torch

# test files run side by side in parallel workers: each keeps torch's
# intra-op pool small
torch.set_num_threads(2)

CASES = [
    ("bn0_moving_mean", (8,)),
    ("bn0_moving_var", (8,)),
    ("bn0_moving_inv_var", (8,)),
    ("stats_moving_avg", (3, 5)),
    ("up0_upsampling", (1, 1, 4, 4)),
    ("up1_upsampling", (2, 3, 5, 6)),
]


def _ref(init, name, shape):
    arr = mx.nd.zeros(shape) + 7.0     # every element must be written
    init(mx.init.InitDesc(name), arr)
    return arr.asnumpy()


def _port(init, name, shape):
    arr = mt.nd.zeros(shape, ctx=mt.cpu())
    arr[:] = 7.0
    init(mt.init.InitDesc(name), arr)
    return arr.data.numpy()


@pytest.mark.parametrize("name, shape", CASES,
                         ids=[c[0] for c in CASES])
@pytest.mark.parametrize("kind", ["uniform", "xavier"])
def test_aux_and_upsampling_names_match_the_reference(name, shape, kind):
    make = {"uniform": lambda S: S.init.Uniform(0.1),
            "xavier": lambda S: S.init.Xavier()}[kind]
    want = _ref(make(mx), name, shape)
    got = _port(make(mt), name, shape)
    assert got.dtype == want.dtype == np.float32
    assert np.array_equal(got, want)


def test_bilinear_kernel_values():
    """The (1, 1, 4, 4) kernel: f = 2, c = 0.625, so each axis runs
    0.25, 0.75, 0.75, 0.25 and the kernel is their outer product."""
    got = _port(mt.init.Uniform(), "up_upsampling", (1, 1, 4, 4))
    axis = np.array([0.25, 0.75, 0.75, 0.25], np.float32)
    assert np.array_equal(got[0, 0], np.outer(axis, axis))


def test_moving_stats_fill_values():
    init = mt.init.Uniform()
    assert (_port(init, "a_moving_var", (4,)) == 1.0).all()
    for name in ("a_moving_mean", "a_moving_inv_var", "a_moving_avg"):
        assert (_port(init, name, (4,)) == 0.0).all()


def test_unknown_name_still_raises_in_both():
    with pytest.raises(ValueError, match="Unknown initialization pattern"):
        _ref(mx.init.Uniform(), "bn0_running_thing", (2,))
    with pytest.raises(ValueError, match="Unknown initialization pattern"):
        _port(mt.init.Uniform(), "bn0_running_thing", (2,))
