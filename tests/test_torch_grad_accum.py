"""Gradient accumulation (``Module.set_grad_accum``, ``fit(grad_accum=)``)
held to the reference's.

The cases of the reference's ``TestGradAccum``
(``tests/test_compile_time.py``), each fed to both packages from the same
numpy-drawn weights and data: an accumulated step equals the plain
full-batch step (within 1e-7 inside each package: the microbatch
gradients are summed in another order), and the two packages' runs agree
within 1e-6 (the same f32 formulas, summed in another order); BatchNorm
normalizes each microbatch by its own statistics and advances the moving
ones microbatch by microbatch; the loss heads' normalization decides the
rescale, and what cannot be rescaled raises in both; ``accum_steps``
counts N microbatches a step. Last, the zoo LM (2 layers, flash
attention) through ``fit(grad_accum=2)`` in both packages, within 1e-5
(``tests/test_torch_module_fit.py``'s limit).
"""
import numpy as np
import pytest

import mxnet_tpu as mx
from mxnet_tpu.base import MXNetError as RefError
from mxnet_tpu.models import transformer as jax_transformer
import mxnet_tpu_torch as mt
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.models import transformer as port_transformer
import torch

# test files run side by side in parallel workers: each keeps torch's
# intra-op pool small
torch.set_num_threads(2)

PKGS = {"ref": mx, "port": mt}


def _mlp(pkg, normalization="null"):
    sym = pkg.sym
    net = sym.FullyConnected(sym.Variable("data"), num_hidden=16,
                             name="fc1")
    net = sym.Activation(net, act_type="relu")
    net = sym.FullyConnected(net, num_hidden=4, name="fc2")
    return sym.SoftmaxOutput(net, sym.Variable("softmax_label"),
                             name="softmax", normalization=normalization)


def _bn_stem(pkg):
    sym = pkg.sym
    net = sym.Convolution(sym.Variable("data"), num_filter=4,
                          kernel=(3, 3), pad=(1, 1), name="conv0")
    net = sym.BatchNorm(net, name="bn0")
    net = sym.Activation(net, act_type="relu")
    net = sym.FullyConnected(net, num_hidden=4, name="fc")
    return sym.SoftmaxOutput(net, sym.Variable("softmax_label"),
                             name="softmax")


def _data(n=64, d=8, classes=4, seed=0):
    rs = np.random.RandomState(seed)
    X = rs.uniform(-1, 1, (n, d)).astype(np.float32)
    Y = rs.randint(0, classes, (n,)).astype(np.float32)
    return X, Y


def _init(net, shapes, seed=11):
    """Uniform(-0.1, 0.1) weights for every parameter, from a seed, in
    list_arguments order (shapes from the reference's infer_shape)."""
    args, _, _ = net.infer_shape(**shapes)
    rs = np.random.RandomState(seed)
    return {n: rs.uniform(-0.1, 0.1, s).astype(np.float32)
            for n, s in zip(net.list_arguments(), args) if n not in shapes}


def _fit(pkg, net, X, Y, init, batch=32, accum=None, epochs=2,
         opt_params=None, **fit_kw):
    ctx = pkg.cpu()
    it = pkg.io.NDArrayIter(X, Y, batch_size=batch,
                            label_name="softmax_label")
    mod = pkg.mod.Module(net, context=ctx)
    mod.fit(it, num_epoch=epochs,
            arg_params={k: pkg.nd.array(v, ctx=ctx) for k, v in init.items()},
            optimizer_params=opt_params or {"learning_rate": 0.1},
            grad_accum=accum, **fit_kw)
    arg, aux = mod.get_params()
    return ({n: v.asnumpy() for n, v in arg.items()},
            {n: v.asnumpy() for n, v in aux.items()})


def _close(got, want, atol, what):
    assert sorted(got) == sorted(want)
    for n in want:
        np.testing.assert_allclose(got[n], want[n], rtol=0, atol=atol,
                                   err_msg="%s: %s" % (what, n))


@pytest.mark.parametrize("normalization,seed", [("null", 0), ("batch", 3)])
def test_accumulated_step_is_the_full_batch_step(normalization, seed):
    """'null' heads sum per-sample gradients (scale 1), 'batch' heads
    average microbatch means (scale 1/N): accum 4 equals accum 1 in each
    package, and the packages agree."""
    X, Y = _data(seed=seed)
    runs = {}
    for key, pkg in PKGS.items():
        net = _mlp(pkg, normalization)
        init = _init(_mlp(mx, normalization),
                     {"data": (32, 8), "softmax_label": (32,)})
        p1, _ = _fit(pkg, net, X, Y, init)
        with pkg.profiler.counter_delta() as d:
            p4, _ = _fit(pkg, net, X, Y, init, accum=4)
        assert d.get("accum_steps") == 4 * 4   # 2 epochs x 2 batches x 4
        _close(p4, p1, 1e-7, key)
        runs[key] = (p1, p4)
    _close(runs["port"][0], runs["ref"][0], 1e-6, "accum 1")
    _close(runs["port"][1], runs["ref"][1], 1e-6, "accum 4")


def test_accum_one_is_the_plain_step():
    X, Y = _data(seed=9)
    init = _init(_mlp(mx), {"data": (32, 8), "softmax_label": (32,)})
    p_none, _ = _fit(mt, _mlp(mt), X, Y, init)
    p_one, _ = _fit(mt, _mlp(mt), X, Y, init, accum=1)
    for n in p_none:
        np.testing.assert_array_equal(p_none[n], p_one[n])


def test_bn_stem_matches_sequential_microbatches():
    """Each microbatch normalizes with its own statistics and advances
    the moving statistics in turn: the port's accumulated step equals two
    executor passes at the microbatch size, their gradients summed and
    applied by hand (the reference's own oracle, at its limits), and
    equals the reference's accumulated step."""
    B, C, H = 8, 3, 6
    rs = np.random.RandomState(0)
    X = rs.uniform(-1, 1, (B, C, H, H)).astype(np.float32)
    Y = rs.randint(0, 4, (B,)).astype(np.float32)
    init = _init(_bn_stem(mx), {"data": (B, C, H, H), "softmax_label": (B,)})
    lr = 0.1
    got = {}
    for key, pkg in PKGS.items():
        got[key] = _fit(pkg, _bn_stem(pkg), X, Y, init, batch=B, epochs=1,
                        accum=2, opt_params={"learning_rate": lr, "wd": 0.0})

    ex = _bn_stem(mt).simple_bind(mt.cpu(), grad_req="write",
                                  data=(B // 2, C, H, H),
                                  softmax_label=(B // 2,))
    for n, v in init.items():
        ex.arg_dict[n][:] = v
    for n, a in ex.aux_dict.items():
        a[:] = np.ones(a.shape, np.float32) if "var" in n else \
            np.zeros(a.shape, np.float32)
    grads = {n: 0.0 for n in init}
    for k in range(2):
        ex.arg_dict["data"][:] = X[k * B // 2:(k + 1) * B // 2]
        ex.arg_dict["softmax_label"][:] = Y[k * B // 2:(k + 1) * B // 2]
        ex.forward(is_train=True)
        ex.backward()
        for n in grads:
            grads[n] = grads[n] + ex.grad_dict[n].asnumpy()
    want = {n: v - lr * (1.0 / B) * grads[n] for n, v in init.items()}
    _close(got["port"][0], want, 2e-6, "arg")
    _close(got["port"][1], {n: a.asnumpy() for n, a in ex.aux_dict.items()},
           1e-6, "aux")
    _close(got["port"][0], got["ref"][0], 1e-6, "arg vs reference")
    _close(got["port"][1], got["ref"][1], 1e-6, "aux vs reference")


@pytest.mark.parametrize("case", ["valid", "mixed", "indivisible"])
def test_what_cannot_accumulate_raises_in_both(case):
    X, Y = _data()
    for key, pkg in PKGS.items():
        err = RefError if key == "ref" else MXNetError
        accum, match = 4, "valid"
        if case == "valid":
            net = _mlp(pkg, "valid")
        elif case == "mixed":
            sym = pkg.sym
            data = sym.Variable("data")
            fc = sym.FullyConnected(data, num_hidden=4, name="fc1")
            net = sym.Group([
                sym.SoftmaxOutput(fc, sym.Variable("softmax_label"),
                                  name="softmax", normalization="batch"),
                sym.LinearRegressionOutput(
                    sym.FullyConnected(data, num_hidden=1, name="fc2"),
                    sym.Variable("reg_label"), name="reg")])
            match = "mix"
        else:
            net, accum, match = _mlp(pkg), 3, "does not divide"
        init = _init(_mlp(mx) if case != "mixed" else net,
                     {"data": (32, 8), "softmax_label": (32,)}
                     if case != "mixed" else
                     {"data": (32, 8), "softmax_label": (32,),
                      "reg_label": (32, 1)})
        if case == "mixed":
            mod = pkg.mod.Module(net, context=pkg.cpu(),
                                 label_names=("softmax_label", "reg_label"))
            mod.bind(data_shapes=[("data", (32, 8))],
                     label_shapes=[("softmax_label", (32,)),
                                   ("reg_label", (32, 1))])
            mod.init_params(arg_params={k: pkg.nd.array(v, ctx=pkg.cpu())
                                        for k, v in init.items()})
            mod.set_grad_accum(accum)
            with pytest.raises(err, match=match):
                mod.init_optimizer(optimizer="sgd")
            continue
        with pytest.raises(err, match=match):
            _fit(pkg, net, X, Y, init, accum=accum)


def test_monitor_path_refuses_accumulation():
    """``fit(monitor=)`` runs the unfused step, which cannot microbatch."""
    X, Y = _data()
    init = _init(_mlp(mx), {"data": (32, 8), "softmax_label": (32,)})
    with pytest.raises(MXNetError, match="requires the fused train step"):
        _fit(mt, _mlp(mt), X, Y, init, accum=2, epochs=1,
             monitor=mt.monitor.Monitor(1))


def test_set_grad_accum_rejects_zero_and_sets_the_gauge():
    mod = mt.mod.Module(_mlp(mt), context=mt.cpu())
    with pytest.raises(MXNetError, match=">= 1"):
        mod.set_grad_accum(0)
    mod.bind(data_shapes=[("data", (32, 8))],
             label_shapes=[("softmax_label", (32,))])
    mod.init_params(mt.init.Xavier())
    mod.init_optimizer()
    mod.set_grad_accum(4)
    assert mt.profiler.get_gauge("grad_accum") == 4


def test_two_layer_lm_grad_accum_matches_reference():
    """The zoo LM (2 layers, flash attention, normalization 'batch')
    through ``fit(grad_accum=2)`` over two batches in both packages, from
    the same weights."""
    V, T, N = 64, 16, 4
    kw = dict(vocab_size=V, num_layers=2, d_model=32, n_heads=2, seq_len=T,
              attention="flash")
    rng = np.random.default_rng(5)
    x = rng.integers(0, V, (2 * N, T)).astype(np.float32)
    y = rng.integers(0, V, (2 * N, T)).astype(np.float32)
    init = _init(jax_transformer.get_symbol(**kw),
                 {"data": (N, T), "softmax_label": (N, T)})
    opt = {"learning_rate": 0.1, "momentum": 0.9}
    got = {}
    for key, pkg, model in (("ref", mx, jax_transformer),
                            ("port", mt, port_transformer)):
        mod = pkg.mod.Module(model.get_symbol(**kw), context=pkg.cpu())
        with pkg.profiler.counter_delta() as d:
            mod.fit(pkg.io.NDArrayIter(x, y, batch_size=N), num_epoch=1,
                    eval_metric="ce", optimizer="sgd", optimizer_params=opt,
                    arg_params={k: pkg.nd.array(v, ctx=pkg.cpu())
                                for k, v in init.items()}, grad_accum=2)
        assert d.get("accum_steps") == 4
        got[key] = {n: v.asnumpy() for n, v in mod.get_params()[0].items()}
    _close(got["port"], got["ref"], 1e-5, "LM")
