"""The port's ResNet (``models/resnet.py``) trains as the reference's
does.

* The port's s2d stem equals its 7x7/2 stem on the same (F, 3, 7, 7)
  weight (``tests/test_resnet_stem.py`` again, on the port).
* ``list_arguments``, ``list_auxiliary_states``, ``list_outputs`` and
  ``infer_shape`` equal the reference's (ResNet-18 at 64x64, v1 and v2,
  both imagenet stems, and a cifar net; ResNet-50 at 224x224 binds
  through ``Module`` with 157 arg and 102 aux arrays), and the JSON
  either package writes loads in the other.
* From the same numpy-seeded Xavier(gaussian, in, 2) arg and aux
  params, three ``_fit_step``\\ s (SGD lr 0.05, momentum 0.9, wd 1e-4,
  batch 4, f32) in both packages. Tolerances:

  - the step-1 outputs and the moving statistics it commits depend on
    the forward alone: atol 1e-5 (measured 7.3e-7 and 1.1e-6; the
    step-1 outputs of the 8 seeds below, up to 1.2e-6);
  - later steps depend on gradients, and the net's two kinks (ReLU at 0
    and max pooling's argmax) make those of two correct f32
    implementations part: an activation within an f32 rounding of a
    kink (a few among the million of a step) goes one way in one
    package and the other way in the other, moving a weight's gradient
    by up to ~1%. Over 8 seeds, after three steps, 4 trajectories parted
    by up to 1.8e-2 (parameters), 4.4e-2 (moving statistics) and
    1.5e-2 (softmax outputs), the others stayed within 1e-6; held to
    1e-1;
  - the same net with its kinks smoothed (``relu`` -> ``softrelu``,
    the max pool -> avg) follows the reference within 1e-5 over the
    three steps (measured 8e-7 outputs, 4e-7 parameters, 3.6e-6 moving
    statistics over the same 8 seeds): that is the check of the
    gradients, the optimizer and the commits.
* One amp bf16 step from the same params: the cross-entropy within 2e-2
  nats of the reference's (both round conv operands and activations to
  bf16, and the reference's convolutions on the CPU may accumulate bf16
  products in bf16, as its ``amp.py`` says of backends other than the
  TPU; measured 5.4e-3 to 8.7e-3 over 4 batches).
* One ``fit`` epoch over an ``NDArrayIter`` (the smoothed net) ends at
  the reference's parameters and moving statistics (1e-5) and hands
  both to the epoch-end callback.

The reference side costs a JAX compile per Module, so the runs are
module-scoped fixtures shared between the tests.
"""
import contextlib
import json

import numpy as np
import pytest

import mxnet_tpu as mx
from mxnet_tpu.models import resnet as jax_resnet
import mxnet_tpu_torch as mt
from mxnet_tpu_torch.models import resnet as port_resnet

STEP1_ATOL = 1e-5
KINK_ATOL = 1e-1
SMOOTH_ATOL = 1e-5
AMP_CE_TOL = 2e-2
N, H = 4, 64
KW = dict(num_layers=18, image_shape="3,%d,%d" % (H, H), stem="s2d",
          num_classes=10)
SHAPES = dict(data_shapes=[("data", (N, 3, H, H))],
              label_shapes=[("softmax_label", (N,))])
OPT = {"learning_rate": 0.05, "momentum": 0.9, "wd": 1e-4}
SEED = 0


class _Smoothed:
    """A ``sym`` namespace whose ``relu`` is ``softrelu`` and whose
    ``pool0`` averages: the ResNet builder over it gives the same net
    with no kink."""

    def __init__(self, sym):
        self._sym = sym

    def __getattr__(self, name):
        return getattr(self._sym, name)

    def Activation(self, **kw):
        return self._sym.Activation(**dict(kw, act_type="softrelu"))

    def Pooling(self, **kw):
        if kw.get("name") == "pool0":
            kw["pool_type"] = "avg"
        return self._sym.Pooling(**kw)


@contextlib.contextmanager
def _smoothed():
    saved = jax_resnet.sym, port_resnet.sym
    jax_resnet.sym, port_resnet.sym = _Smoothed(mx.sym), _Smoothed(mt.sym)
    try:
        yield
    finally:
        jax_resnet.sym, port_resnet.sym = saved


def _symbols(smooth):
    with _smoothed() if smooth else contextlib.nullcontext():
        return jax_resnet.get_symbol(**KW), port_resnet.get_symbol(**KW)


def _initial_params(psym):
    """Xavier(gaussian, in, 2) from a numpy seed, as bench.py initialises
    ResNet; the aux states as the initializer sets them (0 and 1)."""
    pm = mt.mod.Module(psym, context=mt.cpu())
    pm.bind(**SHAPES)
    pm.init_params(mt.init.Xavier(rnd_type="gaussian", factor_type="in",
                                  magnitude=2).set_rng(
                                      np.random.default_rng(SEED)))
    args, aux = pm.get_params()
    return ({k: v.asnumpy() for k, v in args.items()},
            {k: v.asnumpy() for k, v in aux.items()})


def _modules(jsym, psym, args, aux):
    jm = mx.mod.Module(jsym, context=mx.cpu())
    jm.bind(**SHAPES)
    jm.set_params({k: mx.nd.array(v) for k, v in args.items()},
                  {k: mx.nd.array(v) for k, v in aux.items()})
    jm.init_optimizer(optimizer="sgd", optimizer_params=OPT)
    pm = mt.mod.Module(psym, context=mt.cpu())
    pm.bind(**SHAPES)
    pm.set_params(args, aux)
    pm.init_optimizer(optimizer="sgd", optimizer_params=OPT)
    return jm, pm


def _batches(n, seed=SEED):
    rng = np.random.RandomState(seed)
    return [(rng.uniform(-1, 1, (N, 3, H, H)).astype(np.float32),
             rng.randint(0, 10, (N,)).astype(np.float32)) for _ in range(n)]


def _numpy_params(module):
    args, aux = module.get_params()
    return ({k: v.asnumpy() for k, v in args.items()},
            {k: v.asnumpy() for k, v in aux.items()})


def _run(smooth):
    """Three _fit_steps in both packages; the outputs of every step and
    the params after step 1 and after step 3."""
    jsym, psym = _symbols(smooth)
    args, aux = _initial_params(psym)
    jm, pm = _modules(jsym, psym, args, aux)
    rec = {"j_out": [], "p_out": []}
    for i, (x, y) in enumerate(_batches(3)):
        jm._fit_step(mx.io.DataBatch([mx.nd.array(x)], [mx.nd.array(y)]))
        pm._fit_step(mt.io.DataBatch([mt.nd.array(x, ctx=mt.cpu())],
                                     [mt.nd.array(y, ctx=mt.cpu())]))
        rec["j_out"].append(jm.get_outputs()[0].asnumpy())
        rec["p_out"].append(pm.get_outputs()[0].asnumpy())
        if i == 0:
            rec["j_step1"], rec["p_step1"] = _numpy_params(jm), \
                _numpy_params(pm)
    rec["j_end"], rec["p_end"] = _numpy_params(jm), _numpy_params(pm)
    rec["aux0"] = aux
    return rec


@pytest.fixture(scope="module")
def real_run():
    return _run(smooth=False)


@pytest.fixture(scope="module")
def smooth_run():
    return _run(smooth=True)


def _assert_params(got, want, atol, only=None):
    for part, (g, w) in enumerate(zip(got, want)):
        assert sorted(g) == sorted(w)
        for name in w:
            if only is None or only == part:
                np.testing.assert_allclose(g[name], w[name], atol=atol,
                                           err_msg=name)


# ------------------------------------------------------------ the graph

def test_s2d_stem_matches_7x7_stem():
    rng = np.random.RandomState(0)
    x = rng.randn(2, 3, 64, 64).astype(np.float32)
    w = (rng.randn(8, 3, 7, 7) * 0.05).astype(np.float32)
    data = mt.sym.Variable("data")
    direct = mt.sym.Convolution(data=data, num_filter=8, kernel=(7, 7),
                                stride=(2, 2), pad=(3, 3), no_bias=True,
                                name="conv0")
    s2d = port_resnet._stem_s2d(data, 8, 64)
    cpu = mt.cpu()

    def run(sym):
        feed = {"data": mt.nd.array(x, ctx=cpu),
                "conv0_weight": mt.nd.array(w, ctx=cpu)}
        return sym.bind(cpu, feed).forward()[0].asnumpy()

    a, b = run(direct), run(s2d)
    assert a.shape == b.shape == (2, 8, 32, 32)
    np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-4)
    shapes, _, _ = s2d.infer_shape(data=x.shape)
    assert dict(zip(s2d.list_arguments(), shapes))["conv0_weight"] == \
        (8, 3, 7, 7)


@pytest.mark.parametrize("kw", [
    dict(KW), dict(KW, stem="7x7"), dict(KW, version=1),
    dict(num_layers=20, image_shape="3,28,28", num_classes=10)],
    ids=["v2_s2d", "v2_7x7", "v1_7x7", "cifar20"])
def test_lists_and_shapes_match_reference(kw):
    js, ps = jax_resnet.get_symbol(**kw), port_resnet.get_symbol(**kw)
    assert ps.list_arguments() == js.list_arguments()
    assert ps.list_auxiliary_states() == js.list_auxiliary_states()
    assert ps.list_outputs() == js.list_outputs() == ["softmax_output"]
    h = int(kw["image_shape"].split(",")[1])
    shapes = dict(data=(N, 3, h, h), softmax_label=(N,))
    want = js.infer_shape(**shapes)
    got = ps.infer_shape(**shapes)
    for g, w in zip(got, want):
        assert g == [tuple(s) for s in w]


@pytest.mark.parametrize("direction", ["reference_to_port",
                                       "port_to_reference"])
def test_json_loads_in_the_other_package(direction):
    js, ps = jax_resnet.get_symbol(**KW), port_resnet.get_symbol(**KW)
    if direction == "reference_to_port":
        loaded, want = mt.sym.load_json(js.tojson()), js
    else:
        loaded, want = mx.sym.load_json(ps.tojson()), ps
    assert loaded.list_arguments() == want.list_arguments()
    assert loaded.list_auxiliary_states() == want.list_auxiliary_states()
    shapes = dict(data=(N, 3, H, H), softmax_label=(N,))
    assert [tuple(s) for s in loaded.infer_shape(**shapes)[2]] == \
        [tuple(s) for s in want.infer_shape(**shapes)[2]]
    # the auto-created aux states are not written, as in the reference,
    # and the loaded graph writes the file it was read from
    assert "moving_mean" not in ps.tojson()
    assert json.loads(loaded.tojson()) == json.loads(want.tojson())


def test_resnet50_params_have_the_reference_names_and_shapes():
    kw = dict(num_layers=50, stem="s2d", image_shape="3,224,224")
    js, ps = jax_resnet.get_symbol(**kw), port_resnet.get_symbol(**kw)
    shapes = dict(data=(1, 3, 224, 224), softmax_label=(1,))
    ja, _, jx = js.infer_shape(**shapes)
    want_args = dict(zip(js.list_arguments(), map(tuple, ja)))
    want_aux = dict(zip(js.list_auxiliary_states(), map(tuple, jx)))
    mod = mt.mod.Module(ps, context=mt.cpu())
    mod.bind(data_shapes=[("data", (1, 3, 224, 224))],
             label_shapes=[("softmax_label", (1,))], for_training=False)
    mod.init_params(mt.init.Xavier(rnd_type="gaussian", factor_type="in",
                                   magnitude=2))
    args, aux = mod.get_params()
    assert len(args) == 157 and len(aux) == 102
    assert {k: v.shape for k, v in args.items()} == {
        k: s for k, s in want_args.items()
        if k not in ("data", "softmax_label")}
    assert {k: v.shape for k, v in aux.items()} == want_aux
    assert args["conv0_weight"].shape == (64, 3, 7, 7)


# ------------------------------------------------------------ training

def test_step1_outputs_and_moving_stats_match_reference(real_run):
    """The forward alone decides these: equal to f32 rounding."""
    np.testing.assert_allclose(real_run["p_out"][0], real_run["j_out"][0],
                               atol=STEP1_ATOL)
    _assert_params(real_run["p_step1"], real_run["j_step1"], STEP1_ATOL,
                   only=1)
    # the stats moved: momentum 0.9 blends in a tenth of the batch's
    moved = [n for n, v in real_run["p_step1"][1].items()
             if not np.allclose(v, real_run["aux0"][n])]
    assert len(moved) == len(real_run["aux0"])


def test_three_fit_steps_stay_within_the_kink_bound(real_run):
    for got, want in zip(real_run["p_out"], real_run["j_out"]):
        np.testing.assert_allclose(got, want, atol=KINK_ATOL)
    _assert_params(real_run["p_end"], real_run["j_end"], KINK_ATOL)


def test_three_fit_steps_of_the_smoothed_net_match_reference(smooth_run):
    for got, want in zip(smooth_run["p_out"], smooth_run["j_out"]):
        np.testing.assert_allclose(got, want, atol=SMOOTH_ATOL)
    _assert_params(smooth_run["p_step1"], smooth_run["j_step1"],
                   SMOOTH_ATOL)
    _assert_params(smooth_run["p_end"], smooth_run["j_end"], SMOOTH_ATOL)
    # fix_gamma: bn_data's gamma has no gradient, but wd shrinks it
    gamma = smooth_run["p_end"][0]["bn_data_gamma"]
    assert (gamma < 1.0).all() and (gamma > 0.999).all()


def _ce(probs, y):
    p = probs[np.arange(probs.shape[0]), y.astype(np.int64)]
    return float(-np.log(p + 1e-12).mean())


def test_amp_bf16_step_cross_entropy_matches_reference():
    jsym, psym = _symbols(smooth=False)
    args, aux = _initial_params(psym)
    (x, y), = _batches(1, seed=SEED + 1)
    try:
        mx.amp.init("bfloat16")
        mt.amp.init("bfloat16")
        jm, pm = _modules(jsym, psym, args, aux)
        jm._fit_step(mx.io.DataBatch([mx.nd.array(x)], [mx.nd.array(y)]))
        pm._fit_step(mt.io.DataBatch([mt.nd.array(x, ctx=mt.cpu())],
                                     [mt.nd.array(y, ctx=mt.cpu())]))
    finally:
        mx.amp.off()
        mt.amp.off()
    got = pm.get_outputs()[0].asnumpy()
    want = jm.get_outputs()[0].asnumpy()
    assert got.dtype == np.float32
    assert abs(_ce(got, y) - _ce(want, y)) < AMP_CE_TOL
    p_args, p_aux = pm.get_params()
    for arr in list(p_args.values()) + list(p_aux.values()):
        assert arr.dtype == np.float32       # f32 master weights and stats


def test_fit_epoch_over_ndarray_iter_matches_reference():
    jsym, psym = _symbols(smooth=True)
    args, aux = _initial_params(psym)
    batches = _batches(3, seed=SEED + 2)
    x = np.concatenate([b[0] for b in batches])
    y = np.concatenate([b[1] for b in batches])
    jm = mx.mod.Module(jsym, context=mx.cpu())
    jm.fit(mx.io.NDArrayIter(x, y, batch_size=N), num_epoch=1,
           optimizer="sgd", optimizer_params=OPT,
           arg_params={k: mx.nd.array(v) for k, v in args.items()},
           aux_params={k: mx.nd.array(v) for k, v in aux.items()})
    pm = mt.mod.Module(psym, context=mt.cpu())
    ends = []
    pm.fit(mt.io.NDArrayIter(x, y, batch_size=N), num_epoch=1,
           optimizer="sgd", optimizer_params=OPT, arg_params=args,
           aux_params=aux,
           epoch_end_callback=lambda e, s, a, b: ends.append((a, b)))
    _assert_params(_numpy_params(pm), _numpy_params(jm), SMOOTH_ATOL)
    (end_args, end_aux), = ends
    assert sorted(end_aux) == sorted(aux) and sorted(end_args) == \
        sorted(args)
