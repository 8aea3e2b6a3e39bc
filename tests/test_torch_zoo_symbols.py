"""The symbolic zoo nets of the port (``models/{alexnet,vgg,inception,
lenet,mlp}.py``) against the reference's.

* Each net's arguments, aux states, outputs, inferred shapes and JSON
  equal the reference's (both built under a fresh ``NameManager``, so
  the auto-named nodes count from 0 in each), at the size its perf
  table runs (224, Inception-v3 299), and the JSON either package writes
  loads in the other.
* AlexNet (here) and Inception-BN (``test_torch_zoo_inception.py``, which
  uses this file's helpers): from the same numpy-seeded
  ``Xavier(magnitude=2)`` parameters, three ``_fit_step``\\ s in both
  packages (SGD lr 0.01, momentum 0.9, wd 1e-4, batch 4, f32, 10
  classes). AlexNet runs at the smallest input side at which every
  pooling keeps a pixel, 67 (conv1's 15x15 map pools to 7, 3 and 1).
  The nets' Dropout layers run at p 0 here, through a copy of each
  package's symbol with ``p`` set to 0 in its JSON (these tests only:
  the draws of the two packages differ by design,
  ``test_torch_ops_random.py``). Tolerances are those of
  ``tests/test_torch_resnet.py``: step 1's outputs, and the moving
  statistics it commits, within 1e-5; after that the ReLU kinks and
  max-pool ties let two correct f32 trajectories part, held to 1e-1;
  and the same net with its kinks smoothed (``relu`` -> ``softrelu``,
  max pooling -> average) within 1e-5 over the three steps, the check
  of the gradients, the optimizer and the commits.
"""
import json

import numpy as np
import pytest

import mxnet_tpu as mx
from mxnet_tpu.models import alexnet as ref_alexnet
from mxnet_tpu.models import inception as ref_inception
from mxnet_tpu.models import lenet as ref_lenet
from mxnet_tpu.models import mlp as ref_mlp
from mxnet_tpu.models import vgg as ref_vgg
import mxnet_tpu_torch as mt
from mxnet_tpu_torch.models import alexnet, inception, lenet, mlp, vgg

STEP1_ATOL = 1e-5
KINK_ATOL = 1e-1
N, CLASSES, SEED = 4, 10, 0
OPT = {"learning_rate": 0.01, "momentum": 0.9, "wd": 1e-4}

NETS = {
    "alexnet": (ref_alexnet, alexnet, {}, (3, 224, 224)),
    "vgg-16": (ref_vgg, vgg, {"num_layers": 16}, (3, 224, 224)),
    "vgg-11-bn": (ref_vgg, vgg, {"num_layers": 11, "batch_norm": True},
                  (3, 224, 224)),
    "inception-bn": (ref_inception, inception, {"version": "bn"},
                     (3, 224, 224)),
    "inception-v3": (ref_inception, inception, {"version": "v3"},
                     (3, 299, 299)),
    "lenet": (ref_lenet, lenet, {"num_classes": 10}, (1, 28, 28)),
    "mlp": (ref_mlp, mlp, {"num_classes": 10}, (1, 28, 28)),
}


def _symbols(net, **extra):
    ref_mod, port_mod, kw, _ = NETS[net]
    kw = dict(kw, **extra)
    with mx.name.NameManager():
        js = ref_mod.get_symbol(**kw)
    with mt.sym.NameManager():
        ps = port_mod.get_symbol(**kw)
    return js, ps


@pytest.mark.parametrize("net", sorted(NETS))
def test_names_shapes_and_json_match_reference(net):
    js, ps = _symbols(net)
    assert ps.list_arguments() == js.list_arguments()
    assert ps.list_auxiliary_states() == js.list_auxiliary_states()
    assert ps.list_outputs() == js.list_outputs() == ["softmax_output"]
    shapes = {"data": (2,) + NETS[net][3], "softmax_label": (2,)}
    for got, want in zip(ps.infer_shape(**shapes), js.infer_shape(**shapes)):
        assert got == [tuple(s) for s in want]
    assert json.loads(ps.tojson()) == json.loads(js.tojson())


@pytest.mark.parametrize("net", ["alexnet", "inception-bn"])
def test_json_loads_in_the_other_package(net):
    js, ps = _symbols(net)
    for loaded, want in ((mt.sym.load_json(js.tojson()), js),
                         (mx.sym.load_json(ps.tojson()), ps)):
        assert loaded.list_arguments() == want.list_arguments()
        assert loaded.list_auxiliary_states() == \
            want.list_auxiliary_states()
        assert json.loads(loaded.tojson()) == json.loads(want.tojson())


def test_alexnet_has_the_published_parameter_count():
    _, ps = _symbols("alexnet")
    args, _, _ = ps.infer_shape(data=(1, 3, 224, 224), softmax_label=(1,))
    n = sum(int(np.prod(s)) for name, s in zip(ps.list_arguments(), args)
            if name not in ("data", "softmax_label"))
    assert n == 50844008


# ------------------------------------------------------------ training

def edit_symbol(pkg, sym, smooth=False):
    """A copy of ``sym`` with every Dropout's p set to 0 and, with
    ``smooth``, its kinks smoothed: ``relu`` -> ``softrelu``, max pooling
    -> average."""
    g = json.loads(sym.tojson())
    for node in g["nodes"]:
        if node["op"] == "Dropout":
            node["param"]["p"] = "0.0"
        if smooth and node["op"] == "Activation":
            node["param"]["act_type"] = "softrelu"
        if smooth and node["op"] == "Pooling" and \
                node["param"].get("pool_type") == "max":
            node["param"]["pool_type"] = "avg"
    return pkg.sym.load_json(json.dumps(g))


def fit_run(net, side, smooth=False):
    """Three _fit_steps in both packages from the same parameters: the
    outputs of every step, the parameters and aux states after step 1
    and after step 3."""
    js, ps = _symbols(net, num_classes=CLASSES)
    js, ps = edit_symbol(mx, js, smooth), edit_symbol(mt, ps, smooth)
    shapes = dict(data_shapes=[("data", (N, 3, side, side))],
                  label_shapes=[("softmax_label", (N,))])
    init = mt.mod.Module(ps, context=mt.cpu())
    init.bind(**shapes)
    init.init_params(mt.init.Xavier(magnitude=2).set_rng(
        np.random.default_rng(SEED)))
    args, aux = ({k: v.asnumpy() for k, v in d.items()}
                 for d in init.get_params())
    jm = mx.mod.Module(js, context=mx.cpu())
    jm.bind(**shapes)
    jm.set_params({k: mx.nd.array(v) for k, v in args.items()},
                  {k: mx.nd.array(v) for k, v in aux.items()})
    jm.init_optimizer(optimizer="sgd", optimizer_params=OPT)
    pm = mt.mod.Module(ps, context=mt.cpu())
    pm.bind(**shapes)
    pm.set_params(args, aux)
    pm.init_optimizer(optimizer="sgd", optimizer_params=OPT)
    rng = np.random.RandomState(SEED)
    rec = {"j_out": [], "p_out": [], "aux0": aux}

    def params(m):
        return tuple({k: v.asnumpy() for k, v in d.items()}
                     for d in m.get_params())
    for i in range(3):
        x = rng.uniform(-1, 1, (N, 3, side, side)).astype(np.float32)
        y = rng.randint(0, CLASSES, (N,)).astype(np.float32)
        jm._fit_step(mx.io.DataBatch([mx.nd.array(x)], [mx.nd.array(y)]))
        pm._fit_step(mt.io.DataBatch([mt.nd.array(x, ctx=mt.cpu())],
                                     [mt.nd.array(y, ctx=mt.cpu())]))
        rec["j_out"].append(jm.get_outputs()[0].asnumpy())
        rec["p_out"].append(pm.get_outputs()[0].asnumpy())
        if i == 0:
            rec["j_step1"], rec["p_step1"] = params(jm), params(pm)
    rec["j_end"], rec["p_end"] = params(jm), params(pm)
    return rec


def assert_params(got, want, atol, only=None):
    for part, (g, w) in enumerate(zip(got, want)):
        assert sorted(g) == sorted(w)
        if only is not None and part != only:
            continue
        for name in w:
            np.testing.assert_allclose(g[name], w[name], atol=atol,
                                       err_msg=name)


def assert_step1(run):
    """Step 1's outputs and committed moving statistics: the forward
    alone decides them."""
    np.testing.assert_allclose(run["p_out"][0], run["j_out"][0],
                               atol=STEP1_ATOL)
    assert_params(run["p_step1"], run["j_step1"], STEP1_ATOL, only=1)


def assert_three_steps(run, atol):
    for got, want in zip(run["p_out"], run["j_out"]):
        np.testing.assert_allclose(got, want, atol=atol)
    assert_params(run["p_end"], run["j_end"], atol)
    # the weights moved
    assert any(not np.allclose(run["p_end"][0][k], v)
               for k, v in run["p_step1"][0].items())


@pytest.fixture(scope="module")
def alexnet_run():
    return fit_run("alexnet", 67)


@pytest.fixture(scope="module")
def alexnet_smooth_run():
    return fit_run("alexnet", 67, smooth=True)


def test_alexnet_step1_outputs_match_reference(alexnet_run):
    assert_step1(alexnet_run)


def test_alexnet_three_fit_steps_stay_within_the_kink_bound(alexnet_run):
    assert_three_steps(alexnet_run, KINK_ATOL)


def test_alexnet_three_fit_steps_of_the_smoothed_net(alexnet_smooth_run):
    assert_three_steps(alexnet_smooth_run, STEP1_ATOL)


def test_the_copy_without_dropout_is_the_only_change():
    _, ps = _symbols("alexnet")
    g = json.loads(ps.tojson())
    h = json.loads(edit_symbol(mt, ps).tojson())
    differ = [a["name"] for a, b in zip(g["nodes"], h["nodes"]) if a != b]
    assert differ == ["drop1", "drop2"]
