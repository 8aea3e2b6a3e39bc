"""The port's vision model zoo (``gluon.model_zoo.vision``) against the
reference's.

* Every ``get_model`` name builds in both packages with the same
  parameter names and declared shapes (a constructor sweep without a
  forward: the large nets are only built); ``pretrained=True`` raises,
  an unknown name raises.
* ``resnet18_v1`` (batch 4 x 3 x 64 x 64, 10 classes, Xavier(gaussian,
  in, 2) from a numpy seed, hybridized): from the same initial weights
  (drawn in the same order: equal to the bit), step 1's loss, every
  gradient and the running statistics within 1e-5 of max(1, each
  array's largest magnitude). Smaller inputs leave 1x1 maps with batch
  statistics over 2 values in the last stage, where both packages
  amplify rounding past 1e-5 (batch 2 at 32x32: gradients 1e-3 apart,
  and the reference's hybridized and eager paths disagree as much).
* Three ``Trainer`` steps (SGD lr 0.05, momentum 0.9, wd 1e-4) of the
  same net with its kinks smoothed (``softrelu`` for every ReLU, average
  for the max pool) stay within 1e-5 of the reference's; the real net is
  held at 1e-1 after three steps, the bound ``test_torch_resnet.py``
  sets for ReLU kinks and max-pool ties.
* ``squeezenet1_1`` (``Concat`` in every fire module, ``ceil_mode``
  pooling; 64x64) matches at step 1, recorded in predict mode so its
  Dropout is the identity in both packages.
* One amp bf16 step of ``resnet18_v1``: the mean cross-entropy within
  2e-2 nats of the reference's (PR 7's bf16 limit).
* Hybridized equals eager in the port.
* ``save_params`` in one package loads through the other's
  ``get_model(name, pretrained=path)``, both directions.

The reference's runs are module-scoped fixtures shared by the tests.
"""
import contextlib
import types

import numpy as np
import pytest

import mxnet_tpu as mx
import mxnet_tpu_torch as mt

N, H, CLASSES = 4, 64, 10
TOL = 1e-5
KINK_TOL = 1e-1
AMP_CE_TOL = 2e-2


def _scope(pkg):
    return mt.device_scope("cpu") if pkg is mt else contextlib.nullcontext()


def _close(got, want, tol, what=""):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(1.0, float(np.abs(want).max(initial=0.0)))
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale,
                               err_msg=what)


def _batch(seed=0, n=N, h=H):
    rng = np.random.RandomState(seed)
    return (rng.uniform(-1, 1, (n, 3, h, h)).astype(np.float32),
            rng.randint(0, CLASSES, (n,)).astype(np.float32))


def _smooth(pkg, net):
    """Every ReLU to softrelu and every max pool to average, in the
    blocks and in BasicBlockV1's residual activation."""
    def walk(b):
        yield b
        for c in b._children:
            yield from walk(c)
    for b in walk(net):
        if isinstance(b, pkg.gluon.nn.Activation):
            b._act_type = "softrelu"
        if getattr(b, "_kwargs", {}).get("pool_type") == "max":
            b._kwargs["pool_type"] = "avg"
        if type(b).__name__ == "BasicBlockV1":
            def hybrid_forward(self, F, x):
                residual = x
                x = self.body(x)
                if self.downsample:
                    residual = self.downsample(residual)
                return F.Activation(x + residual, act_type="softrelu")
            b.hybrid_forward = types.MethodType(hybrid_forward, b)


def _train(pkg, name, steps, smooth=False, hybrid=True, amp=False,
           train_mode=True, h=H):
    """``steps`` Trainer steps of zoo net ``name`` from seeded Xavier
    weights; returns the per-step losses (numpy), the step-1 gradients
    and running statistics, and the final parameters."""
    x, y = _batch(h=h)
    with _scope(pkg):
        net = pkg.gluon.model_zoo.vision.get_model(name, classes=CLASSES,
                                                   prefix="zoo_")
        if smooth:
            _smooth(pkg, net)
        net.initialize(pkg.init.Xavier(rnd_type="gaussian", factor_type="in",
                                       magnitude=2).set_rng(
                                           np.random.default_rng(0)),
                       ctx=pkg.cpu())
        if hybrid:
            net.hybridize()
        X, Y = pkg.nd.array(x, ctx=pkg.cpu()), pkg.nd.array(y, ctx=pkg.cpu())
        loss_fn = pkg.gluon.loss.SoftmaxCrossEntropyLoss()
        trainer = pkg.gluon.Trainer(net.collect_params(), "sgd", {
            "learning_rate": 0.05, "momentum": 0.9, "wd": 1e-4})
        params = net.collect_params()
        out = {"losses": []}
        if amp:
            pkg.amp.init("bfloat16")
        try:
            for i in range(steps):
                with pkg.autograd.record(train_mode=train_mode):
                    loss = loss_fn(net(X), Y)
                loss.backward()
                if i == 0:
                    out["init"] = None
                    out["grads"] = {k: p.grad().asnumpy()
                                    for k, p in params.items()
                                    if p.grad_req != "null"}
                    out["stats"] = {k: p.data().asnumpy()
                                    for k, p in params.items()
                                    if p.grad_req == "null"}
                trainer.step(N)
                out["losses"].append(loss.asnumpy().astype(np.float32))
        finally:
            if amp:
                pkg.amp.off()
        out["params"] = {k: p.data().asnumpy() for k, p in params.items()}
        return out


@pytest.fixture(scope="module")
def real_runs():
    return {pkg.__name__: _train(pkg, "resnet18_v1", 3) for pkg in
            (mx, mt)}


@pytest.fixture(scope="module")
def smooth_runs():
    return {pkg.__name__: _train(pkg, "resnet18_v1", 3, smooth=True)
            for pkg in (mx, mt)}


# ------------------------------------------------------------- sweep

def _declared(pkg, name):
    with _scope(pkg):
        net = pkg.gluon.model_zoo.vision.get_model(name, prefix="sweep_")
        return [(k, tuple(p.shape) if p.shape is not None else None,
                 p.grad_req) for k, p in net.collect_params().items()]


def _model_names():
    return sorted(mx.gluon.model_zoo.vision._models)


def test_the_zoo_has_the_reference_names():
    assert sorted(mt.gluon.model_zoo.vision._models) == _model_names()


@pytest.mark.parametrize("name", _model_names())
def test_constructor_matches_reference(name):
    assert _declared(mt, name) == _declared(mx, name)


def test_get_model_errors():
    with mt.device_scope("cpu"):
        with pytest.raises(ValueError):
            mt.gluon.model_zoo.vision.get_model("not_a_model")
        with pytest.raises(ValueError):
            mt.gluon.model_zoo.vision.get_model("resnet18_v1",
                                                pretrained=True)


# ------------------------------------------------------------- training

def test_resnet18_v1_step1_matches_reference(real_runs):
    want, got = real_runs["mxnet_tpu"], real_runs["mxnet_tpu_torch"]
    _close(got["losses"][0], want["losses"][0], TOL, "step-1 loss")
    assert list(got["grads"]) == list(want["grads"])
    for k in want["grads"]:
        _close(got["grads"][k], want["grads"][k], TOL, k)
    assert list(got["stats"]) == list(want["stats"]) and got["stats"]
    for k in want["stats"]:
        _close(got["stats"][k], want["stats"][k], TOL, k)


def test_resnet18_v1_three_steps_within_the_kink_bound(real_runs):
    want, got = real_runs["mxnet_tpu"], real_runs["mxnet_tpu_torch"]
    for a, b in zip(got["losses"], want["losses"]):
        _close(a, b, KINK_TOL, "loss")
    for k in want["params"]:
        _close(got["params"][k], want["params"][k], KINK_TOL, k)


def test_smoothed_resnet18_v1_three_steps_match_reference(smooth_runs):
    want, got = smooth_runs["mxnet_tpu"], smooth_runs["mxnet_tpu_torch"]
    for a, b in zip(got["losses"], want["losses"]):
        _close(a, b, TOL, "loss")
    for k in want["grads"]:
        _close(got["grads"][k], want["grads"][k], TOL, k)
    assert list(got["params"]) == list(want["params"])
    for k in want["params"]:
        _close(got["params"][k], want["params"][k], TOL, k)


def test_squeezenet1_1_step1_matches_reference():
    runs = [_train(pkg, "squeezenet1_1", 1, train_mode=False)
            for pkg in (mx, mt)]
    want, got = runs
    _close(got["losses"][0], want["losses"][0], TOL, "loss")
    for k in want["grads"]:
        _close(got["grads"][k], want["grads"][k], TOL, k)
    for k in want["params"]:
        _close(got["params"][k], want["params"][k], TOL, k)


def test_amp_bf16_step1_cross_entropy_matches_reference():
    runs = [_train(pkg, "resnet18_v1", 1, amp=True) for pkg in (mx, mt)]
    want, got = (float(np.mean(r["losses"][0])) for r in runs)
    assert abs(got - want) < AMP_CE_TOL, (got, want)


def test_hybridized_equals_eager_in_the_port():
    runs = [_train(mt, "resnet18_v1", 1, hybrid=h) for h in (False, True)]
    eager, hybrid = runs
    _close(hybrid["losses"][0], eager["losses"][0], TOL, "loss")
    for k in eager["grads"]:
        _close(hybrid["grads"][k], eager["grads"][k], TOL, k)
    for k in eager["stats"]:
        _close(hybrid["stats"][k], eager["stats"][k], TOL, k)


@pytest.mark.parametrize("direction", ["reference_to_port",
                                       "port_to_reference"])
def test_pretrained_path_loads_in_the_other_package(tmp_path, direction):
    src, dst = (mx, mt) if direction == "reference_to_port" else (mt, mx)
    fname = str(tmp_path / "squeezenet.params")
    x, _ = _batch(1, n=2)
    outs = []
    with _scope(src):
        net = src.gluon.model_zoo.vision.get_model("squeezenet1_1",
                                                   classes=CLASSES)
        net.initialize(src.init.Xavier(), ctx=src.cpu())
        outs.append(net(src.nd.array(x, ctx=src.cpu())).asnumpy())
        net.save_params(fname)
    with _scope(dst):
        # another instance counter: loaded by the names' common suffix
        dst.gluon.model_zoo.vision.get_model("squeezenet1_1")
        net2 = dst.gluon.model_zoo.vision.get_model(
            "squeezenet1_1", classes=CLASSES, pretrained=fname)
        outs.append(net2(dst.nd.array(x, ctx=dst.cpu())).asnumpy())
    _close(outs[1], outs[0], 1e-5)
