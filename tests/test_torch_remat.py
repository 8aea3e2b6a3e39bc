"""Applied rematerialization (``MXNET_TPU_REMAT``) and the
``remat-opportunity`` analysis, held to the reference's.

* ``auto`` resolves to the policy the reference's analyzer picks, from
  the same ranked candidate list (node, op, bytes, recompute FLOPs, live
  span, shapes), on the small transformer, the MLP, AlexNet, ResNet-50
  at ``bench.py``'s shapes (batch 256, 3 x 224 x 224; f32 and amp bf16)
  and the LM at ``bench.py``'s width: the analysis is static (per-node
  shapes and dtypes on meta tensors), nothing is executed. The
  constants ``chip_smoke.py``'s phase 15 checks on the card are derived
  here.
* every predicate policy trains bit for bit as remat off does, per
  block (with the scan plan) and over the whole forward (without),
  and as the reference's does under the same policy (1e-6);
* Dropout under remat recomputes the masks it drew: the gradients are
  those of the unwrapped run, and the key chain ends where the
  unwrapped run leaves it;
* BatchNorm's moving statistics are committed once;
* a bad name raises naming the valid ones, jax's policy factories raise
  where the reference fails, the legacy knob means
  ``dots_with_no_batch_dims_saveable`` and loses to an explicit one;
* the calibrated ``est_peak_saving`` is within 25% of the drop in saved
  bytes measured over the whole graph (the reference's round-trip
  criterion), and a plain analysis calibrates nothing.
"""
import numpy as np
import pytest
import torch

import chip_smoke
import mxnet_tpu as mx
from mxnet_tpu import remat as ref_remat
from mxnet_tpu.analysis import analyze_symbol as ref_analyze
import mxnet_tpu_torch as mt
from mxnet_tpu_torch import config, remat
from mxnet_tpu_torch.analysis import analyze_symbol
from mxnet_tpu_torch.base import MXNetError

# test files run side by side in parallel workers: each keeps torch's
# intra-op pool small
torch.set_num_threads(2)

POLICIES = remat.POLICY_NAMES


def _models(pkg):
    if pkg is mx:
        from mxnet_tpu.models import alexnet, resnet, transformer
    else:
        from mxnet_tpu_torch.models import alexnet, resnet, transformer
    return alexnet, resnet, transformer


def _mlp(pkg, dropout=False):
    sym = pkg.sym
    net = sym.FullyConnected(sym.Variable("data"), num_hidden=16,
                             name="fc1")
    net = sym.Activation(net, act_type="relu")
    if dropout:
        net = sym.Dropout(net, p=0.5)
    net = sym.FullyConnected(net, num_hidden=4, name="fc2")
    return sym.SoftmaxOutput(net, sym.Variable("softmax_label"),
                             name="softmax")


def _small_tf(pkg, layers=2, attention="dense"):
    return _models(pkg)[2].get_symbol(vocab_size=128, num_layers=layers,
                                      d_model=32, n_heads=2, seq_len=16,
                                      attention=attention)


MLP_SHAPES = {"data": (32, 8), "softmax_label": (32,)}
TF_SHAPES = {"data": (2, 16), "softmax_label": (2, 16)}
CASES = {
    "small_transformer": (lambda pkg: _small_tf(pkg), TF_SHAPES, False),
    # at the training batch (32) nothing is worth a finding (< 4 KB):
    # no suggestion in either package
    "mlp": (_mlp, MLP_SHAPES, False),
    "mlp_batch_512": (_mlp, {"data": (512, 8), "softmax_label": (512,)},
                      False),
    "alexnet": (lambda pkg: _models(pkg)[0].get_symbol(num_classes=1000),
                {"data": (128, 3, 224, 224), "softmax_label": (128,)},
                False),
    "resnet50": (lambda pkg: _models(pkg)[1].get_symbol(
        num_classes=1000, num_layers=50, stem="s2d",
        image_shape="3,224,224"),
        {"data": (256, 3, 224, 224), "softmax_label": (256,)}, False),
    "resnet50_amp": (lambda pkg: _models(pkg)[1].get_symbol(
        num_classes=1000, num_layers=50, stem="s2d",
        image_shape="3,224,224"),
        {"data": (256, 3, 224, 224), "softmax_label": (256,)}, True),
    "lm_bench_amp": (lambda pkg: _models(pkg)[2].get_symbol(
        vocab_size=32000, num_layers=12, d_model=2048, n_heads=16,
        seq_len=1024, attention="flash"),
        {"data": (8, 1024), "softmax_label": (8, 1024)}, True),
    "lm_bench_micro_amp": (lambda pkg: _models(pkg)[2].get_symbol(
        vocab_size=32000, num_layers=12, d_model=2048, n_heads=16,
        seq_len=1024, attention="flash"),
        {"data": (4, 1024), "softmax_label": (4, 1024)}, True),
}


def _remat_extras(pkg, case):
    build, shapes, amp = CASES[case]
    analyze = ref_analyze if pkg is mx else analyze_symbol
    # fresh name counters: auto-named nodes (relu0, ...) must not depend
    # on what this process built before
    with pkg.name.NameManager():
        net = build(pkg)
    if amp:
        pkg.amp.init("bfloat16")
    try:
        report = analyze(net, input_shapes=shapes, calibrate_remat=False)
    finally:
        if amp:
            pkg.amp.off()
    return report.extras.get("remat")


@pytest.mark.parametrize("case", sorted(CASES))
def test_auto_suggestion_and_candidates_equal_reference(case):
    ref, got = _remat_extras(mx, case), _remat_extras(mt, case)
    if ref is None:
        assert got is None and case == "mlp"
        return
    keys = ("node", "op", "bytes", "recompute_flops", "flops_per_byte",
            "live_span", "shape")
    assert [tuple(c[k] for k in keys) for c in got["candidates"]] == \
        [tuple(c[k] for k in keys) for c in ref["candidates"]]
    for k in ("policy", "wrap", "est_bytes_saved"):
        assert got["suggestion"][k] == ref["suggestion"][k], k
    assert "est_peak_saving" not in got["suggestion"]


@pytest.mark.parametrize("case,constant", [
    ("resnet50_amp", "LEVERS_RESNET_POLICY"),
    ("lm_bench_amp", "LEVERS_LM_POLICY")])
def test_auto_resolves_the_smoke_constants(case, constant):
    """MXNET_TPU_REMAT=auto resolves to ``auto:<the reference's pick>``
    in both packages at the configurations phase 15 runs, which
    ``chip_smoke.py`` carries as constants."""
    build, shapes, _ = CASES[case]
    names = []
    for pkg, res in ((mx, ref_remat.resolve_policy),
                     (mt, remat.resolve_policy)):
        pkg.config.set("MXNET_TPU_REMAT", "auto")
        pkg.amp.init("bfloat16")
        try:
            names.append(res(build(pkg), input_shapes=shapes)[1])
        finally:
            pkg.amp.off()
            pkg.config.reset("MXNET_TPU_REMAT")
    assert names[0] == names[1] == getattr(chip_smoke, constant)


# ------------------------------------------------------------ training

def _data(seed=13, n=64):
    rs = np.random.RandomState(seed)
    return (rs.uniform(-1, 1, (n, 8)).astype(np.float32),
            rs.randint(0, 4, (n,)).astype(np.float32))


def _init(net, shapes, seed=11):
    args, _, _ = net.infer_shape(**shapes)
    rs = np.random.RandomState(seed)
    return {n: rs.uniform(-0.1, 0.1, s).astype(np.float32)
            for n, s in zip(net.list_arguments(), args) if n not in shapes}


def _fit(pkg, net, init, policy="off", epochs=2):
    X, Y = _data()
    pkg.config.set("MXNET_TPU_REMAT", policy)
    try:
        mod = pkg.mod.Module(net, context=pkg.cpu())
        with pkg.profiler.counter_delta() as d:
            mod.fit(pkg.io.NDArrayIter(X, Y, batch_size=32,
                                       label_name="softmax_label"),
                    num_epoch=epochs,
                    arg_params={k: pkg.nd.array(v, ctx=pkg.cpu())
                                for k, v in init.items()},
                    optimizer_params={"learning_rate": 0.1})
    finally:
        pkg.config.reset("MXNET_TPU_REMAT")
    return {n: v.asnumpy() for n, v in mod.get_params()[0].items()}, \
        d.get("remat_applied"), mod


@pytest.mark.parametrize("policy", POLICIES)
def test_named_policy_whole_forward_trains_as_remat_off(policy):
    """Without a plan (the MLP) the whole forward is wrapped: the same
    weights as remat off, bit for bit, and the reference's under the same
    policy within 1e-6."""
    init = _init(_mlp(mx), MLP_SHAPES)
    plain, applied0, _ = _fit(mt, _mlp(mt), init)
    got, applied, mod = _fit(mt, _mlp(mt), init, policy)
    want, _, _ = _fit(mx, _mlp(mx), init, policy)
    assert (applied0, applied) == (0, 1)
    assert mod._remat_name == policy and mod._exec._scan_plan is None
    for n in plain:
        np.testing.assert_array_equal(got[n], plain[n], err_msg=n)
        np.testing.assert_allclose(got[n], want[n], rtol=0, atol=1e-6,
                                   err_msg=n)


def _tf_grads(policy, attention, seed=1):
    net = _small_tf(mt, 4, attention)
    config.set("MXNET_TPU_REMAT", policy)
    try:
        with mt.profiler.counter_delta() as d:
            ex = net.simple_bind(mt.cpu(), data=(2, 16),
                                 softmax_label=(2, 16))
    finally:
        config.reset("MXNET_TPU_REMAT")
    rs = np.random.RandomState(seed)
    for n, a in ex.arg_dict.items():
        a[:] = rs.randint(0, 128, a.shape).astype(np.float32) \
            if n in ("data", "softmax_label") else \
            rs.uniform(-0.1, 0.1, a.shape).astype(np.float32)
    out = ex.forward(is_train=True)[0].asnumpy()
    ex.backward()
    return ex, d.get("remat_applied"), out, \
        {n: g.asnumpy() for n, g in ex.grad_dict.items()}


@pytest.mark.parametrize("attention", ["dense", "flash"])
@pytest.mark.parametrize("policy", POLICIES)
def test_named_policy_per_block_gradients_bit_identical(policy, attention):
    """With the plan (4 layers) each block is wrapped: outputs and every
    gradient equal remat off's."""
    _, _, out0, g0 = _tf_grads("off", attention)
    ex, applied, out, g = _tf_grads(policy, attention)
    assert ex._scan_plan is not None and applied == 1
    assert ex._remat is None and ex._scan_plan.body_wrapper is not None
    np.testing.assert_array_equal(out, out0)
    for n in g0:
        np.testing.assert_array_equal(g[n], g0[n], err_msg=n)


@pytest.mark.parametrize("plan", [True, False])
@pytest.mark.parametrize("policy", ["nothing_saveable", "dots_saveable"])
def test_dropout_recomputes_its_masks(policy, plan):
    """Dropout in every block (the plan: per-block wrap) or in an MLP
    (whole-forward wrap): the recompute replays the key chain, so the
    gradients are those of the unwrapped run, and the chain ends where
    the unwrapped run leaves it."""
    if plan:
        x = mt.sym.Variable("data")
        for i in range(4):
            x = mt.sym.FullyConnected(x, num_hidden=16, name="blk%d_fc" % i)
            x = mt.sym.Activation(x, act_type="relu")
            x = mt.sym.Dropout(x, p=0.5)
        net, shapes = x, {"data": (8, 16)}
    else:
        net, shapes = _mlp(mt, dropout=True), {"data": (8, 8),
                                                "softmax_label": (8,)}
    runs = []
    for mode in ("off", policy):
        config.set("MXNET_TPU_REMAT", mode)
        try:
            ex = net.simple_bind(mt.cpu(), **shapes)
        finally:
            config.reset("MXNET_TPU_REMAT")
        assert (ex._scan_plan is not None) == plan
        rs = np.random.RandomState(2)
        for n, a in ex.arg_dict.items():
            a[:] = rs.randint(0, 4, a.shape).astype(np.float32) \
                if n == "softmax_label" else \
                rs.uniform(-1, 1, a.shape).astype(np.float32)
        mt.random.seed(5)
        out = ex.forward(is_train=True)[0].asnumpy()
        ex.backward()
        runs.append((out, {n: g.asnumpy() for n, g in ex.grad_dict.items()},
                     mt.random.current_key().copy()))
    (o0, g0, k0), (o1, g1, k1) = runs
    np.testing.assert_array_equal(o1, o0)
    np.testing.assert_array_equal(k1, k0)
    for n in g0:
        np.testing.assert_array_equal(g1[n], g0[n], err_msg=n)
    assert any((g != 0).any() for g in g0.values())


def test_batchnorm_moving_statistics_committed_once():
    """Whole-forward remat recomputes BatchNorm in the backward; the
    moving statistics are those of one commit, as without remat."""
    sym = mt.sym
    net = sym.Convolution(sym.Variable("data"), num_filter=4, kernel=(3, 3),
                          pad=(1, 1), name="conv0")
    net = sym.BatchNorm(net, name="bn0")
    net = sym.Activation(net, act_type="relu")
    net = sym.FullyConnected(net, num_hidden=4, name="fc")
    net = sym.SoftmaxOutput(net, sym.Variable("softmax_label"),
                            name="softmax")
    rs = np.random.RandomState(0)
    X = rs.uniform(-1, 1, (8, 3, 6, 6)).astype(np.float32)
    Y = rs.randint(0, 4, (8,)).astype(np.float32)
    init = _init(net, {"data": (8, 3, 6, 6), "softmax_label": (8,)})
    got = []
    for policy in ("off", "nothing_saveable", "dots_saveable"):
        config.set("MXNET_TPU_REMAT", policy)
        try:
            mod = mt.mod.Module(net, context=mt.cpu())
            mod.fit(mt.io.NDArrayIter(X, Y, batch_size=8), num_epoch=1,
                    arg_params=init, optimizer_params={"learning_rate": 0.1})
        finally:
            config.reset("MXNET_TPU_REMAT")
        assert mod._remat_name == policy
        got.append({n: v.asnumpy() for d in mod.get_params()
                    for n, v in d.items()})
    for other in got[1:]:
        for n in got[0]:
            np.testing.assert_array_equal(other[n], got[0][n], err_msg=n)
    # one commit: moving_mean = 0.9 * 0 + 0.1 * batch mean, not blended
    # twice (0.19 * batch mean)
    assert np.abs(got[0]["bn0_moving_mean"]).max() > 0


# ---------------------------------------------------------- knob values

def test_bad_policy_name_raises_naming_valid_ones():
    init = _init(_mlp(mx), MLP_SHAPES)
    with pytest.raises(MXNetError, match="nothing_saveable"):
        _fit(mt, _mlp(mt), init, "no_such_policy")


@pytest.mark.parametrize("name", ["offload_dot_with_no_batch_dims",
                                  "save_and_offload_only_these_names",
                                  "save_any_names_but_these",
                                  "save_anything_except_these_names",
                                  "save_from_both_policies",
                                  "save_only_these_names"])
def test_policy_factories_fail_in_both(name):
    """jax's policy factories are no policies: the reference fails at
    its first step (a TypeError from jax), the port at bind."""
    init = _init(_mlp(mx), MLP_SHAPES)
    with pytest.raises(TypeError):
        _fit(mx, _mlp(mx), init, name, epochs=1)
    with pytest.raises(MXNetError, match="factory"):
        _fit(mt, _mlp(mt), init, name, epochs=1)


@pytest.mark.parametrize("explicit", [None, "nothing_saveable"])
def test_legacy_knob(explicit):
    init = _init(_mlp(mx), MLP_SHAPES)
    config.set("MXNET_EXEC_ENABLE_REMAT", "1")
    try:
        _, applied, mod = _fit(mt, _mlp(mt), init, explicit or "off",
                               epochs=1)
    finally:
        config.reset("MXNET_EXEC_ENABLE_REMAT")
    assert applied == 1
    assert mod._remat_name == (explicit or
                               "dots_with_no_batch_dims_saveable")


def test_auto_with_nothing_to_remat_wraps_nothing():
    net = mt.sym.FullyConnected(mt.sym.Variable("data"), num_hidden=4,
                                name="fc")
    config.set("MXNET_TPU_REMAT", "auto")
    try:
        assert remat.resolve_policy(net, {"data": (2, 4)}) == (None, "off")
    finally:
        config.reset("MXNET_TPU_REMAT")


# -------------------------------------------------------- calibration

def _retained(ex, monkeypatch):
    """Bytes a training forward of ``ex`` leaves for its backward: the
    distinct storages autograd packs outside the checkpoints, those each
    checkpoint holds as its inputs, and those a selective policy keeps;
    the bound arguments' storages are not counted."""
    import torch.utils.checkpoint as ckpt
    skip = {a.data.untyped_storage().data_ptr()
            for a in ex.arg_dict.values()}
    seen = {}

    def note(t):
        if isinstance(t, torch.Tensor):
            st = t.untyped_storage()
            if st.data_ptr() not in skip:
                seen[st.data_ptr()] = st.nbytes()

    real_ckpt = ckpt.checkpoint
    real_sac = ckpt.create_selective_checkpoint_contexts
    caches = []

    def counting_ckpt(fn, *args, **kw):
        for a in args:
            note(a)
        return real_ckpt(fn, *args, **kw)

    def counting_sac(policy_fn, *a, **kw):
        fwd, rec = real_sac(policy_fn, *a, **kw)
        caches.append(fwd.storage)
        return fwd, rec

    monkeypatch.setattr(ckpt, "checkpoint", counting_ckpt)
    monkeypatch.setattr(ckpt, "create_selective_checkpoint_contexts",
                        counting_sac)

    def pack(t):
        note(t)
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        ex.forward(is_train=True)
    for cache in caches:
        for outs in cache.values():
            # one entry per call of the op: a list, or a dict by call index
            for wrapped in (outs.values() if isinstance(outs, dict)
                            else outs):
                for t in torch.utils._pytree.tree_leaves(wrapped):
                    note(getattr(t, "val", t))
    monkeypatch.undo()
    return sum(seen.values())


@pytest.mark.parametrize("policy", ["auto", "dots_saveable"])
def test_calibrated_saving_within_25pct_of_measured(policy, monkeypatch):
    """The suggestion's ``est_peak_saving`` (one block, plain against the
    policy, times the depth) against the drop in retained bytes of the
    whole graph's training forward, plan bound, remat off against per
    block (the reference's round trip, within 25%). A plain analysis
    does not calibrate."""
    net = _small_tf(mt)
    name = policy
    if policy == "auto":
        name = analyze_symbol(net, input_shapes=TF_SHAPES).extras[
            "remat"]["suggestion"]["policy"]
    report = analyze_symbol(net, input_shapes=TF_SHAPES,
                            calibrate_remat=True, device="cpu")
    assert "est_peak_saving" not in analyze_symbol(
        net, input_shapes=TF_SHAPES).extras["remat"]["suggestion"]
    from mxnet_tpu_torch.analysis import memory_passes
    ctx_report = report.extras["remat"]["suggestion"]
    predicted = ctx_report["est_peak_saving"] if policy == "auto" else None
    if predicted is None:
        from mxnet_tpu_torch.analysis.graph_passes import GraphContext
        ctx = GraphContext(net, TF_SHAPES, device="cpu")
        ctx.calibrate_remat = True
        analyze_symbol(net, input_shapes=TF_SHAPES)   # shapes only
        from mxnet_tpu_torch.analysis.graph_passes import check_shapes
        from mxnet_tpu_torch.analysis.findings import Report
        check_shapes(ctx, Report())
        predicted = memory_passes._predict_block_savings(ctx, name)
    assert predicted > 0

    measured = []
    for mode in ("off", name):
        config.set("MXNET_TPU_SCAN_LAYERS", "2")
        config.set("MXNET_TPU_REMAT", mode)
        try:
            ex = net.simple_bind(mt.cpu(), data=(2, 16),
                                 softmax_label=(2, 16))
        finally:
            config.reset("MXNET_TPU_SCAN_LAYERS")
            config.reset("MXNET_TPU_REMAT")
        assert ex._scan_plan is not None
        rs = np.random.RandomState(0)
        for n, a in ex.arg_dict.items():
            a[:] = rs.randint(0, 128, a.shape).astype(np.float32) \
                if n in ("data", "softmax_label") else \
                rs.uniform(-0.1, 0.1, a.shape).astype(np.float32)
        measured.append(_retained(ex, monkeypatch))
    drop = measured[0] - measured[1]
    assert drop > 0
    assert abs(drop - predicted) <= 0.25 * predicted, \
        "predicted %d vs measured %d" % (predicted, drop)
