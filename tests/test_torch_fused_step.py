"""The port's compiled training step (``Module._fit_step`` through
``Module._step_program``: one ``torch.compile`` forward per structure,
its backward built by AOT autograd, then the compiled update) against
the eager route and against the reference's fused step
(``mxnet_tpu/module/module.py`` ``_build_fused_step``).

The oracles of the reference's own tests, each fed to both packages
from the same numpy weights and batches: the compiled step against
``forward_backward`` + ``update`` at the reference's bounds
(``tests/test_module.py``: rtol 2e-5 / atol 2e-6 for SGD with momentum,
1e-5 / 1e-6 for adam, nadam, rmsprop and adagrad), and against the
reference's fused step at the same bounds; a learning-rate schedule
compiles nothing; the scan plan's fit equals the unrolled one
(``tests/test_scan_layers.py``, 5e-8; here the plan's layers run as one
region the capture compiles once, on a torch whose region takes them);
the ``fused_step`` record of the
compile ring (``tests/test_obs.py``); ``loop_recompile`` 0 in the async
loop (``tests/test_async_fit.py``); gradient accumulation and applied
remat through the compiled step (``tests/test_compile_time.py``'s
``TestGradAccum`` and ``TestRemat``, 1e-7); the remat parity of
``tests/test_group_update.py`` (1e-6 / 1e-7).

Then the port's own routes: the zoo LM (2 layers, flash attention) fit
3 steps in both packages (1e-5, ``tests/test_torch_module_fit.py``'s
limit); one build per structure, one more after a shape change, one
program shared by two Modules of one structure; every counted way out
(``fused_step_fallback_<knob|rng|host|monitor|group2ctx|failed|
neg_cache|unchecked>``), each step of which is the eager route's bit for
bit; the table of the ops whose training pass applies an autograd
Function (``module._FUNCTION_OPS``) whole; and the departures of ROADMAP
queue C: two programs where the reference has one,
``MXNET_TPU_FUSED_TRAINER`` reaching the forward and backward, a graph
that draws random numbers running eagerly, and before torch 2.13 a
graph holding a Function no card run has checked running eagerly.

Each test counts with ``counter_delta``. Programs live in one
process-wide cache, so a test that counts a build uses a structure (a
hidden width) no other test of this file binds.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu.models import transformer as jax_transformer
import mxnet_tpu_torch as mt
from mxnet_tpu_torch import _fused, config as cfg, profiler
from mxnet_tpu_torch.models import transformer as port_transformer

# test files run side by side in parallel workers: each keeps torch's
# intra-op pool small
torch.set_num_threads(2)

PKGS = {"ref": mx, "port": mt}
STEP = ("fused_step_compile", "fused_step_cache_hit",
        "fused_step_recompile", "fused_step_fallback", "loop_recompile")


@pytest.fixture(autouse=True)
def _on_the_host():
    with mt.cpu():
        yield


def _mlp(pkg, hidden=16, classes=2, act="tanh", normalization="null"):
    sym = pkg.sym
    net = sym.FullyConnected(sym.Variable("data"), num_hidden=hidden,
                             name="fc1")
    net = sym.Activation(net, act_type=act, name="act1")
    net = sym.FullyConnected(net, num_hidden=classes, name="fc2")
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


def _xor(n, seed):
    rng = np.random.RandomState(seed)
    x = rng.uniform(-1, 1, (n, 2)).astype(np.float32)
    return x, ((x[:, 0] * x[:, 1]) > 0).astype(np.float32)


def _init(net, shapes, seed=11, scale=0.1):
    """Uniform weights for every parameter from a seed (shapes from the
    reference's ``infer_shape``)."""
    args, _, _ = net.infer_shape(**shapes)
    rs = np.random.RandomState(seed)
    return {n: rs.uniform(-scale, scale, s).astype(np.float32)
            for n, s in zip(net.list_arguments(), args) if n not in shapes}


def _module(pkg, net, x, y, init, optimizer="sgd", opt_params=None,
            **bind_kw):
    mod = pkg.mod.Module(net, context=pkg.cpu())
    mod.bind(data_shapes=[("data", x.shape)],
             label_shapes=[("softmax_label", y.shape)], **bind_kw)
    mod.init_params(arg_params={k: pkg.nd.array(v, ctx=pkg.cpu())
                                for k, v in init.items()},
                    aux_params=None, allow_missing=True)
    mod.init_optimizer(optimizer=optimizer,
                       optimizer_params=opt_params or
                       {"learning_rate": 0.1})
    return mod


def _batch(pkg, x, y):
    return pkg.io.DataBatch(data=[pkg.nd.array(x, ctx=pkg.cpu())],
                            label=[pkg.nd.array(y, ctx=pkg.cpu())])


def _params(mod):
    arg, aux = mod.get_params()
    out = {n: v.asnumpy() for n, v in arg.items()}
    out.update({n: v.asnumpy() for n, v in aux.items()})
    return out


def _close(got, want, what, rtol=0.0, atol=0.0):
    assert sorted(got) == sorted(want)
    for n in want:
        np.testing.assert_allclose(got[n], want[n], rtol=rtol, atol=atol,
                                   err_msg="%s: %s" % (what, n))


def _delta(d):
    return {k: d.get(k) for k in STEP}


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
    return _params(mod)


# -------------------------------------------- the reference's oracles

# (optimizer, its parameters, rtol, atol): tests/test_module.py:82
# (SGD with momentum) and :218 (the stateful four), as cases of one test
ORACLES = [
    ("sgd", {"learning_rate": 0.1, "momentum": 0.9}, 2e-5, 2e-6),
    ("adam", {"learning_rate": 0.01}, 1e-5, 1e-6),
    ("nadam", {"learning_rate": 0.01}, 1e-5, 1e-6),
    ("rmsprop", {"learning_rate": 0.01}, 1e-5, 1e-6),
    ("adagrad", {"learning_rate": 0.01}, 1e-5, 1e-6),
]


@pytest.mark.parametrize("name,params,rtol,atol", ORACLES,
                         ids=[o[0] for o in ORACLES])
def test_compiled_step_matches_eager_route_and_reference(name, params,
                                                         rtol, atol):
    """Three compiled steps against ``forward_backward`` + ``update``
    in the port and against the reference's fused step, at the
    reference's bound between its fused and eager steps; the steps ran
    compiled (one build of this structure in the process at most, the
    rest hits, nothing eager)."""
    x, y = _xor(32, seed=3)
    init = _init(_mlp(mx), {"data": x.shape, "softmax_label": y.shape})
    eager = _module(mt, _mlp(mt), x, y, init, name, params)
    comp = _module(mt, _mlp(mt), x, y, init, name, params)
    ref = _module(mx, _mlp(mx), x, y, init, name, params)
    with profiler.counter_delta() as d:
        for _ in range(3):
            eager.forward_backward(_batch(mt, x, y))
            eager.update()
            comp._fit_step(_batch(mt, x, y))
            ref._fit_step(_batch(mx, x, y))
    got = _delta(d)
    assert got["fused_step_compile"] + got["fused_step_cache_hit"] == 3
    assert got["fused_step_fallback"] == 0 and got["loop_recompile"] == 0
    _close(_params(comp), _params(eager), "compiled vs eager", rtol, atol)
    _close(_params(comp), _params(ref), "compiled vs reference", rtol, atol)


def test_lr_schedule_compiles_nothing():
    """tests/test_module.py:248: a schedule halving the rate every step
    builds one step program and one update program, reused by the
    later steps."""
    x, y = _xor(32, seed=0)
    init = _init(_mlp(mx, hidden=17), {"data": x.shape,
                                      "softmax_label": y.shape})
    sched = mt.lr_scheduler.FactorScheduler(step=1, factor=0.5)
    mod = _module(mt, _mlp(mt, hidden=17), x, y, init, "sgd",
                  {"learning_rate": 0.4, "lr_scheduler": sched})
    with profiler.counter_delta() as d:
        for _ in range(3):
            mod._fit_step(_batch(mt, x, y))
    assert _delta(d) == {"fused_step_compile": 1, "fused_step_cache_hit": 2,
                         "fused_step_recompile": 0, "fused_step_fallback": 0,
                         "loop_recompile": 0}
    assert d.get("trainer_step_compile") == 1


V, T, B = 64, 8, 2


@pytest.fixture(scope="module")
def tf_fixture():
    """tests/test_scan_layers.py's fixture: the 4-layer zoo LM, weights
    Uniform(-0.05, 0.05) from a seed, 8 sequences of 8 tokens."""
    net = jax_transformer.get_symbol(vocab_size=V, num_layers=4,
                                     d_model=32, n_heads=2, seq_len=T)
    shapes = {"data": (B, T), "softmax_label": (B, T)}
    init = _init(net, shapes, seed=5, scale=0.05)
    X = np.random.RandomState(0).randint(0, V, (8, T)).astype(np.float32)
    Y = np.random.RandomState(1).randint(0, V, (8, T)).astype(np.float32)
    # one symbol object for every fit: another from get_symbol gets
    # other generated names, so another program key
    port = port_transformer.get_symbol(vocab_size=V, num_layers=4,
                                       d_model=32, n_heads=2, seq_len=T)
    return X, Y, init, port


def _tf_fit(scan_mode, X, Y, init, net, epochs=2):
    cfg.set("MXNET_TPU_SCAN_LAYERS", scan_mode)
    try:
        return _fit(mt, net, X, Y, init, batch=B, epochs=epochs,
                    opt_params={"learning_rate": 0.05},
                    eval_metric=mt.metric.Loss())
    finally:
        cfg.reset("MXNET_TPU_SCAN_LAYERS")


def test_scan_plan_fit_parity_and_counters(tf_fixture):
    """tests/test_scan_layers.py:213: the fit with the plan (its layers
    one region of the capture) equals the unrolled fit within 5e-8,
    with no recompile; both compiled."""
    X, Y, init, net = tf_fixture
    counts = []
    for mode in ("off", "2"):
        with profiler.counter_delta() as d:
            params = _tf_fit(mode, X, Y, init, net)
        counts.append(dict(_delta(d), scan_applied=d.get("scan_applied")))
        if mode == "off":
            p_off = params
    assert counts[1]["scan_applied"] >= 1
    for got in counts:
        assert got["loop_recompile"] == 0
        assert got["fused_step_fallback"] == 0
        assert got["fused_step_compile"] + got["fused_step_cache_hit"] == 8
    _close(params, p_off, "scan vs unrolled", atol=5e-8)


def test_scan_grads_reach_every_layer(tf_fixture):
    """tests/test_scan_layers.py:226: after an epoch through the
    compiled region, every layer's parameters moved."""
    X, Y, init, net = tf_fixture
    p_on = _tf_fit("2", X, Y, init, net, epochs=1)
    for n, v in init.items():
        assert np.abs(p_on[n] - v).max() > 0, \
            "%s never updated under the plan" % n


def test_remat_per_layer_inside_the_region(tf_fixture):
    """A selective remat policy on the plan's layers goes inside the
    capture around the layers' region: the fit compiles once and equals
    the compiled fit without remat within 5e-8 (TestRemat's oracle)."""
    X, Y, init, net = tf_fixture
    plain = _tf_fit("2", X, Y, init, net, epochs=1)
    cfg.set("MXNET_TPU_REMAT", "dots_with_no_batch_dims_saveable")
    try:
        with profiler.counter_delta() as d:
            comp = _tf_fit("2", X, Y, init, net, epochs=1)
        got = dict(_delta(d), remat_applied=d.get("remat_applied"))
    finally:
        cfg.reset("MXNET_TPU_REMAT")
    assert got["remat_applied"] >= 1 and got["fused_step_fallback"] == 0
    assert got["fused_step_compile"] + got["fused_step_cache_hit"] == 4
    _close(comp, plain, "remat vs plain, compiled", atol=5e-8)


def test_fused_step_record_in_the_compile_ring():
    """tests/test_obs.py:434: the step's build lands in the compile
    ring under the ``fused_step`` scope with the module's signature,
    from the CPU's backend."""
    x = np.random.RandomState(0).rand(9, 6).astype(np.float32)
    y = np.zeros((9,), np.float32)
    init = _init(_mlp(mx, hidden=5), {"data": x.shape,
                                     "softmax_label": y.shape})
    mod = _module(mt, _mlp(mt, hidden=5), x, y, init)
    n0 = len(mt.obs.compiles.snapshot())
    with profiler.counter_delta() as d:
        mod._fit_step(_batch(mt, x, y))
    assert d.get("fused_step_compile") == 1
    assert d.get("obs_compile_count") >= 1
    recs = [r for r in mt.obs.compiles.snapshot()[n0:]
            if r["scope"] == "fused_step"]
    assert recs, "no fused_step compile record in the ring"
    assert {r["source"] for r in recs} == {_fused.CPU_BACKEND}
    r = recs[0]
    assert r["signature"] == repr(mod._obs_sig)
    assert r["bind_ms"] >= r["compile_ms"] > 0


@pytest.mark.parametrize("net,shape,window,epochs", [
    ("mlp", (16, 8), 2, 3), ("stem", (8, 3, 6, 6), 4, 4)],
    ids=["mlp_window2", "bn_stem_window4"])
def test_async_loop_compiles_once(net, shape, window, epochs):
    """tests/test_async_fit.py:152 and :601: the async loop's steps are
    the compiled program's, no recompile, and the windowed loop equals
    the synchronous one bit for bit."""
    rs = np.random.RandomState(7)
    X = rs.uniform(-1, 1, (shape[0] * 4,) + shape[1:]).astype(np.float32)
    Y = rs.randint(0, 4, (shape[0] * 4,)).astype(np.float32)
    sym = (lambda p: _mlp(p, classes=4, act="relu")) if net == "mlp" \
        else _bn_stem
    init = _init(sym(mx), {"data": shape, "softmax_label": shape[:1]})
    runs = []
    for depth in (window, 0):
        cfg.set("MXNET_TPU_ASYNC_WINDOW", depth)
        try:
            with profiler.counter_delta() as d:
                runs.append(_fit(mt, sym(mt), X, Y, init, batch=shape[0],
                                 epochs=epochs))
        finally:
            cfg.reset("MXNET_TPU_ASYNC_WINDOW")
        assert d.get("loop_recompile") == 0
        assert d.get("loop_host_sync") == 0
        assert d.get("fused_step_fallback") == 0
    _close(runs[0], runs[1], "window %d vs 0" % window)


# ------------------------------------ TestGradAccum through the program

def _accum_data(n=64, d=8, classes=4, seed=0):
    rs = np.random.RandomState(seed)
    return (rs.uniform(-1, 1, (n, d)).astype(np.float32),
            rs.randint(0, classes, (n,)).astype(np.float32))


@pytest.mark.parametrize("normalization,seed", [("null", 0), ("batch", 3)])
def test_grad_accum_through_the_program(normalization, seed):
    """TestGradAccum's parity cases: accum 4 equals accum 1 within 1e-7,
    each microbatch a call of the compiled program (keyed by the
    microbatch's shapes), and equals the reference's accumulated fit
    within 1e-6."""
    X, Y = _accum_data(seed=seed)
    init = _init(_mlp(mx, classes=4, act="relu",
                      normalization=normalization),
                 {"data": (32, 8), "softmax_label": (32,)})
    p1 = _fit(mt, _mlp(mt, classes=4, act="relu",
                       normalization=normalization), X, Y, init)
    with profiler.counter_delta() as d:
        p4 = _fit(mt, _mlp(mt, classes=4, act="relu",
                           normalization=normalization), X, Y, init,
                  accum=4)
    assert d.get("accum_steps") == 4 * 4
    assert d.get("fused_step_fallback") == 0
    assert d.get("loop_recompile") == 0
    assert d.get("fused_step_compile") + d.get("fused_step_cache_hit") == 4
    _close(p4, p1, "accum 4 vs 1", atol=1e-7)
    ref = _fit(mx, _mlp(mx, classes=4, act="relu",
                        normalization=normalization), X, Y, init, accum=4)
    _close(p4, ref, "port vs reference", atol=1e-6)


def test_grad_accum_bn_stem_sequential_microbatches():
    """TestGradAccum's BatchNorm case: two compiled microbatch calls,
    each normalizing by its own statistics and advancing the moving
    ones, equal two executor passes whose gradients are summed and
    applied by hand (2e-6, aux 1e-6)."""
    Bn, C, H = 8, 3, 6
    rs = np.random.RandomState(0)
    X = rs.uniform(-1, 1, (Bn, C, H, H)).astype(np.float32)
    Y = rs.randint(0, 4, (Bn,)).astype(np.float32)
    init = _init(_bn_stem(mx), {"data": X.shape, "softmax_label": Y.shape})
    lr = 0.1
    with profiler.counter_delta() as d:
        got = _fit(mt, _bn_stem(mt), X, Y, init, batch=Bn, epochs=1,
                   accum=2, opt_params={"learning_rate": lr, "wd": 0.0})
    assert d.get("fused_step_fallback") == 0
    ex = _bn_stem(mt).simple_bind(mt.cpu(), grad_req="write",
                                  data=(Bn // 2, C, H, H),
                                  softmax_label=(Bn // 2,))
    for n, v in init.items():
        ex.arg_dict[n][:] = v
    for n, a in ex.aux_dict.items():
        a[:] = np.ones(a.shape, np.float32) if "var" in n else \
            np.zeros(a.shape, np.float32)
    grads = {n: 0.0 for n in init}
    for k in range(2):
        ex.arg_dict["data"][:] = X[k * Bn // 2:(k + 1) * Bn // 2]
        ex.arg_dict["softmax_label"][:] = Y[k * Bn // 2:(k + 1) * Bn // 2]
        ex.forward(is_train=True)
        ex.backward()
        for n in grads:
            grads[n] = grads[n] + ex.grad_dict[n].asnumpy()
    for n, v in init.items():
        np.testing.assert_allclose(got[n], v - lr / Bn * grads[n], rtol=0,
                                   atol=2e-6, err_msg=n)
    for n in ex.aux_dict:
        np.testing.assert_allclose(got[n], ex.aux_dict[n].asnumpy(),
                                   rtol=0, atol=1e-6, err_msg=n)


# ---------------------------------------- TestRemat through the program

@pytest.mark.parametrize("knob,value", [
    ("MXNET_TPU_REMAT", "dots_with_no_batch_dims_saveable"),
    ("MXNET_TPU_REMAT", "nothing_saveable"),
    ("MXNET_EXEC_ENABLE_REMAT", "1")])
def test_remat_through_the_program(knob, value):
    """TestRemat: a named policy (selective or plain) and the legacy
    knob apply inside the capture (``remat_applied``), the steps run
    compiled, and the parameters equal the plain fit's within 1e-7."""
    X, Y = _accum_data(n=64, seed=13)
    init = _init(_mlp(mx, classes=4, act="relu"),
                 {"data": (32, 8), "softmax_label": (32,)})
    plain = _fit(mt, _mlp(mt, classes=4, act="relu"), X, Y, init)
    cfg.set(knob, value)
    try:
        with profiler.counter_delta() as d:
            remat = _fit(mt, _mlp(mt, classes=4, act="relu"), X, Y, init)
    finally:
        cfg.reset(knob)
    assert d.get("remat_applied") >= 1
    assert d.get("fused_step_fallback") == 0
    assert d.get("fused_step_compile") + d.get("fused_step_cache_hit") == 4
    _close(remat, plain, "remat vs plain", atol=1e-7)


def test_remat_step_matches_eager_update():
    """tests/test_group_update.py:223: under a selective policy the
    compiled step trains the step ``forward_backward`` + ``update``
    does (1e-6 / 1e-7)."""
    rs = np.random.RandomState(1)
    x = rs.uniform(-1, 1, (8, 32)).astype(np.float32)
    y = rs.randint(0, 10, (8,)).astype(np.float32)
    init = _init(_mlp(mx, hidden=64, classes=10, act="relu"),
                 {"data": x.shape, "softmax_label": y.shape}, seed=6,
                 scale=0.07)
    opt = {"learning_rate": 0.1, "rescale_grad": 1.0 / 8}
    cfg.set("MXNET_TPU_REMAT", "dots_with_no_batch_dims_saveable")
    try:
        fused = _module(mt, _mlp(mt, hidden=64, classes=10, act="relu"),
                        x, y, init, "sgd", opt)
        eager = _module(mt, _mlp(mt, hidden=64, classes=10, act="relu"),
                        x, y, init, "sgd", opt)
        with profiler.counter_delta() as d:
            fused._fit_step(_batch(mt, x, y))
        eager.forward_backward(_batch(mt, x, y))
        eager.update()
    finally:
        cfg.reset("MXNET_TPU_REMAT")
    assert d.get("fused_step_fallback") == 0
    _close(_params(fused), _params(eager), "fused vs eager", rtol=1e-6,
           atol=1e-7)


# ------------------------------------------------ the port's own routes

LM = dict(vocab_size=64, num_layers=2, d_model=32, n_heads=2, seq_len=64,
          attention="flash")


def test_flash_lm_fit_matches_reference():
    """The zoo LM (2 layers, flash attention: K1-K3's plain versions as
    opaque custom-op nodes of the capture on the CPU) fit 3 steps with
    Adam in both packages from the same numpy weights and batches: the
    parameters within 1e-5 (tests/test_torch_module_fit.py's limit), the
    port's steps compiled."""
    N = 4
    shapes = {"data": (N, 64), "softmax_label": (N, 64)}
    init = _init(jax_transformer.get_symbol(**LM), shapes, seed=2,
                 scale=0.05)
    rng = np.random.default_rng(0)
    batches = [(rng.integers(0, 64, (N, 64)).astype(np.float32),
                rng.integers(0, 64, (N, 64)).astype(np.float32))
               for _ in range(3)]
    opt = {"learning_rate": 1e-3}
    port = _module(mt, port_transformer.get_symbol(**LM), *batches[0],
                   init, "adam", opt)
    ref = _module(mx, jax_transformer.get_symbol(**LM), *batches[0], init,
                  "adam", opt)
    with profiler.counter_delta() as d:
        for x, y in batches:
            port._fit_step(_batch(mt, x, y))
            ref._fit_step(_batch(mx, x, y))
            np.testing.assert_allclose(port.get_outputs()[0].asnumpy(),
                                       ref.get_outputs()[0].asnumpy(),
                                       atol=1e-5)
    assert d.get("fused_step_fallback") == 0
    assert d.get("fused_step_compile") + d.get("fused_step_cache_hit") == 3
    _close(_params(port), _params(ref), "port vs reference", atol=1e-5)


def test_shape_change_builds_once_more_and_modules_share_programs():
    """One build per structure: a second Module of the same structure
    reuses the first one's program (a hit, no build); a reshape to
    another batch builds one more program, which the Module counts as a
    recompile of its loop (``loop_recompile``), as the reference's jit
    cache growth is; back at the first shape, a hit."""
    x, y = _xor(16, seed=1)
    x8, y8 = x[:8], y[:8]
    init = _init(_mlp(mx, hidden=9), {"data": x.shape,
                                     "softmax_label": y.shape})
    first = _module(mt, _mlp(mt, hidden=9), x, y, init)
    with profiler.counter_delta() as d:
        first._fit_step(_batch(mt, x, y))
    assert _delta(d)["fused_step_compile"] == 1
    second = _module(mt, _mlp(mt, hidden=9), x, y, init)
    with profiler.counter_delta() as d:
        second._fit_step(_batch(mt, x, y))
    assert _delta(d) == {"fused_step_compile": 0, "fused_step_cache_hit": 1,
                         "fused_step_recompile": 0, "fused_step_fallback": 0,
                         "loop_recompile": 0}
    _close(_params(second), _params(first), "shared program")
    with profiler.counter_delta() as d:
        second.reshape(data_shapes=[("data", x8.shape)],
                       label_shapes=[("softmax_label", y8.shape)])
        second._fit_step(_batch(mt, x8, y8))
        second.reshape(data_shapes=[("data", x.shape)],
                       label_shapes=[("softmax_label", y.shape)])
        second._fit_step(_batch(mt, x, y))
    assert _delta(d) == {"fused_step_compile": 1, "fused_step_cache_hit": 1,
                         "fused_step_recompile": 0, "fused_step_fallback": 0,
                         "loop_recompile": 1}


def _knob_off(fn):
    cfg.set("MXNET_TPU_FUSED_TRAINER", False)
    try:
        return fn()
    finally:
        cfg.reset("MXNET_TPU_FUSED_TRAINER")


def _steps(mod, x, y, n=2):
    for _ in range(n):
        mod._fit_step(_batch(mt, x, y))
    return _params(mod)


def test_knob_off_is_the_eager_step_and_update():
    """Departure: ``MXNET_TPU_FUSED_TRAINER=0`` turns off the compiled
    forward and backward as well as the compiled update (the
    reference's knob covers ``FusedUpdater`` only, and its fused step
    has no switch): each step counts both fallbacks, and the parameters
    are the eager route's (``forward_backward`` + the eager ``update``)
    bit for bit."""
    x, y = _xor(32, seed=4)
    init = _init(_mlp(mx), {"data": x.shape, "softmax_label": y.shape})
    mod = _module(mt, _mlp(mt), x, y, init)
    with profiler.counter_delta() as d:
        got = _knob_off(lambda: _steps(mod, x, y))
    assert d.get("fused_step_fallback_knob") == 2
    assert d.get("trainer_step_fallback_knob") == 2
    assert d.get("fused_step_compile") == 0 and \
        d.get("fused_step_cache_hit") == 0

    def eager():
        m = _module(mt, _mlp(mt), x, y, init)
        for _ in range(2):
            m.forward_backward(_batch(mt, x, y))
            m.update()
        return _params(m)

    _close(got, _knob_off(eager), "knob off vs eager route")


def test_two_programs_per_step():
    """Departure: the step is two compiled programs where the
    reference's is one jitted program, the forward/backward
    (``fused_step_*``) and the update (``trainer_step_*``), each built
    once and reused."""
    x, y = _xor(32, seed=5)
    init = _init(_mlp(mx, hidden=11), {"data": x.shape,
                                      "softmax_label": y.shape})
    mod = _module(mt, _mlp(mt, hidden=11), x, y, init, "adam",
                  {"learning_rate": 0.01})
    with profiler.counter_delta() as d:
        _steps(mod, x, y, 3)
    assert (d.get("fused_step_compile"), d.get("fused_step_cache_hit")) \
        == (1, 2)
    assert (d.get("trainer_step_compile"), d.get("trainer_step_cache_hit")) \
        == (1, 2)


def _eager_twin(net_fn, x, y, init, n=2, setup=None):
    """The same steps through ``forward_backward`` + ``update`` (the
    eager forward and backward, the same compiled update), from the
    same weights."""
    m = _module(mt, net_fn(), x, y, init)
    if setup is not None:
        setup(m)
    for _ in range(n):
        m.forward_backward(_batch(mt, x, y))
        m.update()
    return _params(m)


def _dropout_net(pkg):
    sym = pkg.sym
    net = sym.FullyConnected(sym.Variable("data"), num_hidden=16,
                             name="fc1")
    net = sym.Dropout(net, p=0.5, name="drop")
    net = sym.FullyConnected(net, num_hidden=2, name="fc2")
    return sym.SoftmaxOutput(net, sym.Variable("softmax_label"),
                             name="softmax")


def test_rng_graph_runs_eagerly():
    """Departure: a graph that draws (Dropout with p > 0) runs the eager
    forward and backward, counted ``fused_step_fallback_rng`` (the
    reference folds a key per step into its jitted program); its steps
    draw the eager route's masks, so a seeded fit equals the knob-off
    fit bit for bit. Dropout with p = 0 draws nothing and compiles."""
    x, y = _xor(32, seed=6)
    init = _init(_dropout_net(mx), {"data": x.shape,
                                    "softmax_label": y.shape})
    mt.random.seed(3)
    mod = _module(mt, _dropout_net(mt), x, y, init)
    with profiler.counter_delta() as d:
        got = _steps(mod, x, y)
    assert d.get("fused_step_fallback_rng") == 2
    assert d.get("fused_step_compile") == 0

    def seeded(m):
        mt.random.seed(3)

    _close(got, _eager_twin(lambda: _dropout_net(mt), x, y, init,
                            setup=seeded), "rng decline vs eager")
    net = mt.sym.SoftmaxOutput(mt.sym.Dropout(
        mt.sym.FullyConnected(mt.sym.Variable("data"), num_hidden=3,
                              name="fc1"), p=0.0, name="drop0"),
        mt.sym.Variable("softmax_label"), name="softmax")
    init0 = _init(mx.sym.SoftmaxOutput(mx.sym.FullyConnected(
        mx.sym.Variable("data"), num_hidden=3, name="fc1"),
        mx.sym.Variable("softmax_label"), name="softmax"),
        {"data": x.shape, "softmax_label": y.shape})
    mod = _module(mt, net, x, y, init0)
    with profiler.counter_delta() as d:
        _steps(mod, x, y, 1)
    assert d.get("fused_step_fallback") == 0


class _HostSquare(mt.operator.CustomOp):
    def forward(self, is_train, req, in_data, out_data, aux):
        self.assign(out_data[0], req[0], in_data[0] * in_data[0])

    def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
        self.assign(in_grad[0], req[0], 2 * in_data[0] * out_grad[0])


@mt.operator.register("fused_step_host_square")
class _HostSquareProp(mt.operator.CustomOpProp):
    def create_operator(self, ctx, shapes, dtypes):
        return _HostSquare()


def _custom_net():
    sym = mt.sym
    net = sym.FullyConnected(sym.Variable("data"), num_hidden=16,
                             name="fc1")
    net = sym.Custom(net, op_type="fused_step_host_square", name="sq")
    net = sym.FullyConnected(net, num_hidden=2, name="fc2")
    return sym.SoftmaxOutput(net, sym.Variable("softmax_label"),
                             name="softmax")


def _monitored(m):
    mon = mt.monitor.Monitor(1, pattern=".*")
    m.install_monitor(mon)
    mon.tic()


@pytest.mark.parametrize("why", ["host", "monitor"])
def test_declines_are_counted_and_eager(why):
    """A host op (a ``Custom`` op: its Prop is looked up by name when it
    runs, and may run host code) and the monitor's tap on every node's
    outputs run the eager step, counted; each equals the knob-off
    route bit for bit."""
    x, y = _xor(32, seed=8)
    if why == "host":
        net_fn, setup = _custom_net, None
    else:
        net_fn, setup = (lambda: _mlp(mt, hidden=13)), _monitored
    init = _init(mx.sym.FullyConnected(
        mx.sym.FullyConnected(mx.sym.Variable("data"), num_hidden=16
                              if why == "host" else 13, name="fc1"),
        num_hidden=2, name="fc2"), {"data": x.shape})
    mod = _module(mt, net_fn(), x, y, init)
    if setup is not None:
        setup(mod)
    with profiler.counter_delta() as d:
        got = _steps(mod, x, y)
    assert d.get("fused_step_fallback_" + why) == 2
    assert d.get("fused_step_compile") == 0
    _close(got, _eager_twin(net_fn, x, y, init, setup=setup),
           why + " decline vs eager")


def test_group2ctx_declines():
    """``group2ctx`` placement runs the eager step (each node on its
    group's device), counted ``fused_step_fallback_group2ctx``."""
    sym = mt.sym
    with mt.AttrScope(ctx_group="dev1"):
        h = sym.FullyConnected(sym.Variable("data"), num_hidden=6,
                               name="fc1")
    with mt.AttrScope(ctx_group="dev2"):
        net = sym.SoftmaxOutput(sym.FullyConnected(h, num_hidden=2,
                                                   name="fc2"),
                                sym.Variable("softmax_label"),
                                name="softmax")
    x, y = _xor(8, seed=2)
    mod = mt.mod.Module(net, context=mt.cpu())
    mod.bind(data_shapes=[("data", x.shape)],
             label_shapes=[("softmax_label", y.shape)])
    mod.init_params(mt.init.Xavier())
    mod.init_optimizer(optimizer="sgd")
    # Module binds one device; the executor a placed bind makes stands in
    mod._exec = net.simple_bind(mt.cpu(), grad_req=mod._grad_req,
                                group2ctx={"dev1": mt.cpu(),
                                           "dev2": mt.cpu()},
                                data=x.shape, softmax_label=y.shape)
    for n in mod._param_names:
        mod._exec.arg_dict[n]._data = mod._arg_params[n].data
    with profiler.counter_delta() as d:
        mod._fit_step(_batch(mt, x, y))
    assert d.get("fused_step_fallback_group2ctx") == 1
    assert np.isfinite(mod.get_outputs()[0].asnumpy()).all()


def _graph_break_op(data):
    # Python the capture cannot take whole: a graph break
    torch._dynamo.graph_break()
    return data * 2.0


def test_failed_capture_is_counted_then_negative_cached():
    """A graph the capture cannot take whole (an op with a graph break,
    which ``fullgraph`` refuses) fails its build once,
    counted ``fused_step_fallback_failed``, and runs eagerly; the
    structure is then negative-cached (``fused_step_fallback_neg_cache``,
    no second attempt). Each step equals the knob-off route's."""
    from mxnet_tpu_torch.ops.registry import OP_REGISTRY, register
    if "_fused_step_graph_break" not in OP_REGISTRY:
        register("_fused_step_graph_break")(_graph_break_op)
    sym = mt.sym

    def net_fn():
        h = sym.FullyConnected(sym.Variable("data"), num_hidden=7,
                               name="fc1")
        h = sym._fused_step_graph_break(h, name="brk")
        return sym.SoftmaxOutput(sym.FullyConnected(h, num_hidden=2,
                                                    name="fc2"),
                                 sym.Variable("softmax_label"),
                                 name="softmax")

    x, y = _xor(32, seed=9)
    init = _init(mx.sym.FullyConnected(mx.sym.FullyConnected(
        mx.sym.Variable("data"), num_hidden=7, name="fc1"), num_hidden=2,
        name="fc2"), {"data": x.shape})
    mod = _module(mt, net_fn(), x, y, init)
    with profiler.counter_delta() as d:
        got = _steps(mod, x, y, 3)
    assert d.get("fused_step_fallback_failed") == 1
    assert d.get("fused_step_fallback_neg_cache") == 2
    assert d.get("fused_step_compile_failed") == 1
    assert d.get("fused_step_compile") == 0
    _close(got, _eager_twin(net_fn, x, y, init, n=3), "failed vs eager")


def test_roofline_counting_run_takes_the_eager_step():
    """The analyzer's counting run (a dispatch mode, which a compiled
    program's kernels bypass) runs the step eagerly: the knob is off for
    its duration, so the forward, backward and update ops are counted
    and the step program is not used."""
    from mxnet_tpu_torch.analysis import roofline
    x, y = _xor(32, seed=10)
    init = _init(_mlp(mx, hidden=12), {"data": x.shape,
                                      "softmax_label": y.shape})
    mod = _module(mt, _mlp(mt, hidden=12), x, y, init)
    with profiler.counter_delta() as d:
        counts = roofline.count_executable(mod._fit_step, _batch(mt, x, y))
    assert d.get("fused_step_fallback_knob") == 1
    assert d.get("fused_step_compile") == 0
    # the two FullyConnected products (2 FLOPs a multiply-add), forward
    # and the two of the backward, at least
    assert counts["flops"] >= 3 * 2 * 32 * (2 * 12 + 12 * 2)


def _uncacheable(self):
    raise _fused.Uncacheable("a structure no key can hold")


def test_uncacheable_structure_owns_its_program_and_recompiles_loudly(
        monkeypatch):
    """A structure that cannot be keyed builds a program of its own
    (counted ``fused_step_compile``, then hits); a new shape recompiles
    that program (``fused_step_recompile``, ``loop_recompile``); past
    dynamo's recompile limit the step fails over to the eager route,
    counted ``fused_step_fallback_failed``, never silently."""
    import torch._dynamo.config as dcfg
    monkeypatch.setattr(mt.mod.Module, "_step_signature", _uncacheable)
    x, y = _xor(16, seed=12)
    init = _init(_mlp(mx, hidden=14), {"data": x.shape,
                                      "softmax_label": y.shape})

    def reshaped(mod, n):
        mod.reshape(data_shapes=[("data", (n, 2))],
                    label_shapes=[("softmax_label", (n,))])
        mod._fit_step(_batch(mt, x[:n], y[:n]))

    mod = _module(mt, _mlp(mt, hidden=14), x, y, init)
    with profiler.counter_delta() as d:
        _steps(mod, x, y)
        reshaped(mod, 8)
    assert _delta(d) == {"fused_step_compile": 1, "fused_step_cache_hit": 2,
                         "fused_step_recompile": 1, "fused_step_fallback": 0,
                         "loop_recompile": 1}
    limit = "recompile_limit" if hasattr(dcfg, "recompile_limit") \
        else "cache_size_limit"
    mod = _module(mt, _mlp(mt, hidden=14), x, y, init)
    with dcfg.patch(**{limit: 1}), profiler.counter_delta() as d:
        _steps(mod, x, y, 1)
        reshaped(mod, 8)
        reshaped(mod, 4)
    assert d.get("fused_step_compile") == 1
    assert d.get("fused_step_fallback_failed") == 2
    assert np.isfinite(mod.get_outputs()[0].asnumpy()).all()


def test_nothing_to_differentiate_declines_to_the_eager_error():
    """A Module whose parameters are all fixed and whose inputs ask no
    gradient has nothing to differentiate: the step declines, counted
    ``fused_step_fallback_nograd``, and the eager route raises as it
    always has."""
    from mxnet_tpu_torch.base import MXNetError
    x, y = _xor(8, seed=13)
    net = _mlp(mt, hidden=15)
    mod = mt.mod.Module(net, context=mt.cpu(),
                        fixed_param_names=["fc1_weight", "fc1_bias",
                                           "fc2_weight", "fc2_bias"])
    mod.bind(data_shapes=[("data", x.shape)],
             label_shapes=[("softmax_label", y.shape)])
    mod.init_params(mt.init.Xavier())
    mod.init_optimizer(optimizer="sgd")
    with profiler.counter_delta() as d:
        with pytest.raises(MXNetError, match="backward called without"):
            mod._fit_step(_batch(mt, x, y))
    assert d.get("fused_step_fallback_nograd") == 1


def test_the_probe_refuses_a_step_that_recompiles(monkeypatch):
    """A tuner probe whose fit builds a second step program mid-run (a
    knob its key holds flipped at the fourth step) scores not ok,
    naming ``loop_recompile``, which now counts the step's builds."""
    from mxnet_tpu_torch.tune import probe
    from mxnet_tpu_torch.tune.space import Candidate
    data = mt.sym.Variable("data")
    net = mt.sym.FullyConnected(data, num_hidden=5, name="fc")
    net = mt.sym.LinearRegressionOutput(net, name="lro")
    spec = probe.make_spec(net.tojson(), [("data", (4, 3))],
                           [("lro_label", (4, 5))], {}, {}, "sgd",
                           {"learning_rate": 0.01}, Candidate(), steps=6,
                           device="cpu")
    real = mt.mod.Module._compiled_gradients
    calls = []

    def flip(self):
        calls.append(1)
        if len(calls) == 4:
            cfg.set("MXNET_TPU_LAYERNORM_TWO_PASS", True)
        return real(self)

    snap = cfg.snapshot_overrides(list(cfg.KNOBS))
    # a probe child reads its process's counters whole: zeroed here, as
    # in a process of its own
    profiler.reset_counters()
    try:
        with profiler.counter_delta() as clean:
            first = probe.run_probe_child(dict(spec))
            assert first["ok"] is True, first
        assert clean.get("loop_recompile") == 0
        monkeypatch.setattr(mt.mod.Module, "_compiled_gradients", flip)
        with profiler.counter_delta() as d:
            score = probe.run_probe_child(dict(spec))
    finally:
        cfg.restore_overrides(snap)
    assert d.get("fused_step_compile") == 1
    assert d.get("loop_recompile") == 1
    assert score["ok"] is False and "loop_recompile" in score["why"]


def test_compiled_layernorm_is_the_formula():
    """Departure: inside a capture LayerNorm is its formula (AOT
    autograd derives the backward), where the eager op runs the
    reference's analytic backward; the two agree to f32 rounding (1e-5
    of each gradient's largest value), f32 and bf16 data."""
    from mxnet_tpu_torch.ops import nn as nnops
    rng = np.random.RandomState(0)
    for dtype in (torch.float32, torch.bfloat16):
        x = torch.tensor(rng.randn(4, 16, 64) * 3 + 1, dtype=dtype)
        gam = torch.tensor(rng.randn(64), dtype=torch.float32)
        bet = torch.tensor(rng.randn(64), dtype=torch.float32)
        head = torch.tensor(rng.randn(4, 16, 64), dtype=dtype)

        def run(fn):
            leaves = [t.detach().requires_grad_(True) for t in (x, gam, bet)]
            out = fn(*leaves)
            return [out.float()] + [g.float() for g in torch.autograd.grad(
                out, leaves, head)]

        torch._dynamo.reset()
        compiled = torch.compile(lambda d, a, b: nnops.layer_norm(d, a, b),
                                 backend=_fused.CPU_BACKEND, fullgraph=True)
        got, want = run(compiled), run(lambda d, a, b:
                                       nnops.layer_norm(d, a, b))
        tol = 1e-5 if dtype == torch.float32 else 1e-2
        for g, w in zip(got, want):
            assert float((g - w).abs().max()) <= \
                tol * max(1.0, float(w.abs().max()))


def _svm_net(pkg, hidden):
    sym = pkg.sym
    net = sym.FullyConnected(sym.Variable("data"), num_hidden=hidden,
                             name="fc1")
    net = sym.FullyConnected(sym.Activation(net, act_type="tanh"),
                             num_hidden=2, name="fc2")
    return sym.SVMOutput(net, sym.Variable("softmax_label"), name="svm")


@pytest.mark.parametrize("version,hidden", [((2, 11), 19), ((2, 13), 21)])
def test_unchecked_function_declines_before_torch_2_13(monkeypatch, version,
                                                       hidden):
    """Departure: before torch 2.13 (the card's 2.11 dropped the backward
    of LayerNorm's autograd Function inside a capture, cause unknown) a
    graph holding an op whose Function no card run holds compiled against
    eager (SVMOutput's) runs the eager step, counted
    ``fused_step_fallback_unchecked``, bit for bit the eager route's; from
    2.13 on it compiles. Convolution, BatchNorm and SoftmaxOutput, which
    phase 23 holds on the card, compile on either."""
    monkeypatch.setattr(_fused, "torch_version", lambda: version)
    x, y = _xor(32, seed=14)
    init = _init(_svm_net(mx, hidden), {"data": x.shape,
                                        "softmax_label": y.shape})
    mod = _module(mt, _svm_net(mt, hidden), x, y, init)
    with profiler.counter_delta() as d:
        got = _steps(mod, x, y)
    if version < (2, 13):
        assert d.get("fused_step_fallback_unchecked") == 2
        assert d.get("fused_step_compile") == 0
        _close(got, _eager_twin(lambda: _svm_net(mt, hidden), x, y, init),
               "unchecked decline vs eager")
    else:
        assert d.get("fused_step_fallback") == 0
        assert d.get("fused_step_compile") == 1
    rng = np.random.RandomState(15)
    xs = rng.uniform(-1, 1, (4, 3, 6, 6)).astype(np.float32)
    ys = np.array([0, 1, 2, 3], np.float32)
    stem = _bn_stem(mt)
    mod = _module(mt, stem, xs, ys, {})
    with profiler.counter_delta() as d:
        mod._fit_step(_batch(mt, xs, ys))
    assert d.get("fused_step_fallback") == 0


def _autograd_functions():
    """Every ``torch.autograd.Function`` class of the port, by name."""
    import ast
    from pathlib import Path
    root = Path(mt.__file__).parent
    found = set()
    for path in root.rglob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.ClassDef) and any(
                    ast.unparse(b).endswith("autograd.Function")
                    for b in node.bases):
                found.add(node.name)
    return found


def _function_inputs(name):
    """Small inputs and attributes for one op of ``_FUNCTION_OPS``."""
    rng = np.random.RandomState(16)

    def t(*shape, lo=-1.0, hi=1.0):
        return torch.tensor(rng.uniform(lo, hi, shape).astype(np.float32))

    label3 = torch.tensor([0.0, 2.0, 1.0])
    return {
        "Convolution": ([t(1, 2, 5, 5), t(3, 2, 3, 3)],
                        {"kernel": (3, 3), "num_filter": 3,
                         "no_bias": True}),
        "Deconvolution": ([t(1, 2, 4, 4), t(2, 3, 3, 3)],
                          {"kernel": (3, 3), "num_filter": 3}),
        "LayerNorm": ([t(2, 8), t(8), t(8)], {}),
        "SoftmaxOutput": ([t(3, 4), label3], {}),
        "FlashAttention": ([t(1, 1, 8, 16), t(1, 1, 8, 16),
                            t(1, 1, 8, 16)], {}),
        "LinearRegressionOutput": ([t(3, 4), t(3, 4)], {}),
        "MAERegressionOutput": ([t(3, 4), t(3, 4)], {}),
        "LogisticRegressionOutput": ([t(3, 4), t(3, 4, lo=0.0)], {}),
        "MakeLoss": ([t(3, 4)], {}),
        "SVMOutput": ([t(3, 4), label3], {}),
        "IdentityAttachKLSparseReg": ([t(3, 4, lo=0.1, hi=0.9),
                                       t(4, lo=0.1, hi=0.9)], {}),
        "RNN": ([t(3, 2, 4), t(3 * 5 * (4 + 5) + 2 * 3 * 5), t(1, 2, 5)],
                {"state_size": 5, "mode": "gru", "_is_train": True}),
        "CTCLoss": ([t(4, 2, 5), torch.tensor([[1.0, 3.0], [2.0, 0.0]])],
                    {}),
    }[name]


def test_every_autograd_function_is_classified():
    """The compiled step's table of Function ops
    (``module._FUNCTION_OPS``) is whole: every autograd Function of the
    port is a graph op's there or one that never enters a capture (the
    host ``Custom`` op's two, which decline as ``host``, and the
    imperative ``autograd.Function`` bridge); each op of the table applies
    its Function in an eager training pass (its autograd node's forward
    class), and the ops phase 23 holds on the card are in the table."""
    from mxnet_tpu_torch.module import module as modmod
    from mxnet_tpu_torch.ops.registry import OP_REGISTRY
    table = modmod._FUNCTION_OPS
    assert _autograd_functions() == set(table.values()) | {
        "_TracedCustom", "_HostCustom", "_FunctionBridge"}
    assert modmod._CARD_CHECKED <= set(table)
    for name, fn_name in table.items():
        op = OP_REGISTRY[name]
        assert op.name == name
        inputs, attrs = _function_inputs(name)
        leaves = [a.requires_grad_(True) for a in inputs
                  if a.is_floating_point()]
        outs = op.fn(*inputs, **attrs)
        outs = outs if isinstance(outs, tuple) else (outs,)
        seen, stack = set(), [o.grad_fn for o in outs if o.grad_fn]
        while stack:
            node = stack.pop()
            cls = getattr(node, "_forward_cls", None)
            if cls is not None:
                seen.add(cls.__name__)
            stack.extend(n for n, _ in node.next_functions if n is not None)
        assert fn_name in seen, (name, seen)
        assert leaves
