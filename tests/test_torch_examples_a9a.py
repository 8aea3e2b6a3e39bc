"""The single-card examples of ``mxnet_tpu_torch/examples/`` against
the reference's ``examples/``, and ``chip_smoke.py`` phase 18 rehearsed
on the CPU.

For each of the eleven examples the reference's data generator and the
port's copy agree bit for bit, the symbols serialize alike, and from the
reference's initial parameters the step-1 loss (or outputs) and every
gradient agree within 1e-5 of max(1, max|ref|) and three steps of the
example's optimizer stay in step. Where the reference builds its net or
loss inside ``main`` (``autoencoder``, ``adversary_fgsm``,
``neural_style``, ``actor_critic``, ``dqn``), the port's builder is
given the reference package (``build_net(mx)``), so both nets come from
one description. ``cnn_text_classification`` is compared with its
dropout at 0: the two packages draw other masks.

The rehearsal runs phase 18 on the CPU at small sizes (the "card" being
the CPU, CUDA-only calls stood in for, the examples' gates off: they
hold at the examples' defaults, which ``chip_smoke.py`` runs on the
card); then the checks end the run when the port is broken.
"""
import importlib
import os
import sys

import numpy as np
import pytest
import torch

import mxnet_tpu as mx
import mxnet_tpu_torch as mt
import chip_smoke as cs
from mxnet_tpu.models import resnet as ref_resnet
from mxnet_tpu_torch.examples import common

# test files run side by side in parallel workers: each keeps torch's
# intra-op pool small
torch.set_num_threads(2)

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "examples"))
NAMES = cs.A9A_EXAMPLES
REF = {n: importlib.import_module(n) for n in NAMES}
PORT = {n: importlib.import_module("mxnet_tpu_torch.examples." + n)
        for n in NAMES}
RTOL = 1e-5
GATE = common.gate


@pytest.fixture(autouse=True)
def _on_cpu():
    with mt.cpu():
        yield


def _close(got, want, what, rtol=RTOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    scale = max(1.0, float(np.abs(want).max(initial=0.0)))
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol * scale,
                               err_msg=what)


def _equal(got, want):
    for g, w in zip(got if isinstance(got, tuple) else (got,),
                    want if isinstance(want, tuple) else (want,)):
        np.testing.assert_array_equal(g, w)


# ------------------------------------------------------------ generators

def _cartpole_run(env_cls):
    env = env_cls(3)
    states, rng = [np.append(env.reset(), [0, 0])], np.random.RandomState(8)
    for _ in range(60):
        s, r, done = env.step(int(rng.randint(2)))
        states.append(np.append(s, [r, done]))
        if done:
            states.append(np.append(env.reset(), [0, 0]))
    return np.stack(states)


@pytest.mark.parametrize("name,call", [
    ("train_mnist", lambda m: m.synth_mnist(300, seed=7)),
    ("train_cifar10", lambda m: m.synth_cifar(100, seed=11)),
    ("svm_mnist", lambda m: m.synth_digits(200, seed=1)),
    ("adversary_fgsm", lambda m: m.synth_digits(200, seed=2)),
    ("cnn_text_classification", lambda m: m.synth_corpus(120)),
    ("autoencoder", lambda m: m.synth_data(100)),
    ("super_resolution", lambda m: (
        m.make_images(8, 32), m.downscale(m.make_images(8, 32), 2),
        m.nearest_upscale(m.make_images(4, 16), 2))),
    ("neural_style", lambda m: m.make_images(48)),
    ("actor_critic", lambda m: _cartpole_run(m.CartPole)),
    ("dqn", lambda m: (_cartpole_run(m.CartPole), np.array([
        m.rollout_greedy(m.CartPole(s), lambda x: x[2:4])
        for s in range(4)]))),
])
def test_generator_agrees(name, call):
    _equal(call(PORT[name]), call(REF[name]))


def test_gluon_mnist_digits_are_train_mnists():
    _equal(PORT["gluon_mnist"].synth_mnist(50, seed=7),
           REF["gluon_mnist"].synth_mnist(50, seed=7))


def test_helpers_agree():
    """The helpers the reference writes inline in ``main``: the style
    features' fixed weights and actor-critic's normalized returns."""
    rng = np.random.RandomState(3)
    _equal(PORT["neural_style"].feature_weights(),
           (rng.randn(16, 3, 3, 3).astype(np.float32) * 0.4,
            rng.randn(32, 16, 3, 3).astype(np.float32) * 0.2))
    rewards = [1.0] * 17
    R, rets = 0.0, []
    for r in reversed(rewards):
        R = r + 0.99 * R
        rets.append(R)
    rets = np.asarray(rets[::-1], np.float32)
    _equal(PORT["actor_critic"].returns(rewards, 0.99),
           (rets - rets.mean()) / (rets.std() + 1e-6))
    sr = PORT["super_resolution"], REF["super_resolution"]
    a, b = np.random.RandomState(0).rand(2, 1, 1, 8, 8)
    assert sr[0].psnr(a, b) == sr[1].psnr(a, b)


@pytest.mark.parametrize("name", ["train_mnist", "train_cifar10"])
def test_rec_files_agree(name, tmp_path):
    """``--use-rec`` / train_cifar10's RecordIO: the port's packer writes
    the reference's bytes, and both packages' ``ImageRecordIter`` read
    the same first batch."""
    make = "synth_mnist" if name == "train_mnist" else "synth_cifar"
    x, y = getattr(PORT[name], make)(12, seed=1)
    paths = [str(tmp_path / ("%s.rec" % who)) for who in ("port", "ref")]
    PORT[name]._pack_rec(x, y, paths[0])
    REF[name]._pack_rec(x, y, paths[1])
    assert open(paths[0], "rb").read() == open(paths[1], "rb").read()
    shape = (1, 28, 28) if name == "train_mnist" else (3, 28, 28)
    batches = []
    mt.config.set("MXNET_USE_NATIVE_IO", False)
    try:
        for pkg in (mt, mx):
            it = pkg.io.ImageRecordIter(path_imgrec=paths[0],
                                        data_shape=shape, batch_size=6,
                                        scale=1.0 / 255)
            b = next(iter(it))
            batches.append((b.data[0].asnumpy(), b.label[0].asnumpy()))
    finally:
        mt.config.reset("MXNET_USE_NATIVE_IO")
    _equal(batches[0], batches[1])


# --------------------------------------------------------------- symbols

def _both(build_ref, build_port):
    with mx.name.NameManager():
        ref = build_ref()
    with mt.name.NameManager():
        port = build_port()
    assert port.tojson() == ref.tojson()
    return ref, port


def _batch(pkg, data, labels):
    return pkg.io.DataBatch(data=[pkg.nd.array(d) for d in data],
                            label=[pkg.nd.array(lb) for lb in labels])


def _module_pair(syms, x, y, optimizer, params, fused, store):
    """Both packages' Modules from the reference's seeded Xavier
    parameters (and aux states): step 1's outputs and gradients without
    an update, then three steps of ``optimizer`` (``fit``'s fused step,
    or ``forward_backward`` + ``update``), with a local store when
    ``store``; outputs of each step and the parameters after them."""
    mods = [pkg.mod.Module(s, context=pkg.cpu())
            for pkg, s in zip((mx, mt), syms)]
    for m in mods:
        m.bind(data_shapes=[("data", x.shape)],
               label_shapes=[("softmax_label", y.shape)])
    mods[0].init_params(mx.init.Xavier().set_rng(np.random.default_rng(0)))
    arg, aux = mods[0].get_params()
    mods[1].set_params({k: v.asnumpy() for k, v in arg.items()},
                       {k: v.asnumpy() for k, v in aux.items()})
    batches = [_batch(pkg, [x], [y]) for pkg in (mx, mt)]
    for m, b in zip(mods, batches):
        m.forward_backward(b)
    for i, (g, w) in enumerate(zip(mods[1].get_outputs(),
                                   mods[0].get_outputs())):
        _close(g.asnumpy(), w.asnumpy(), "step 1 output %d" % i)
    for n in mods[1]._param_names:
        _close(mods[1]._exec.grad_dict[n].asnumpy(),
               mods[0]._exec.grad_dict[n].asnumpy(), "gradient of " + n)
    for pkg, m in zip((mx, mt), mods):
        m.init_optimizer(kvstore=pkg.kv.create("local") if store else
                         "local", optimizer=optimizer,
                         optimizer_params=params)
    for s in range(3):
        for m, b in zip(mods, batches):
            if fused:
                m._fit_step(b)
            else:
                m.forward_backward(b)
                m.update()
        for i, (g, w) in enumerate(zip(mods[1].get_outputs(),
                                       mods[0].get_outputs())):
            _close(g.asnumpy(), w.asnumpy(), "step %d output %d" % (s + 2, i))
    for want, got in zip(mods[0].get_params(), mods[1].get_params()):
        assert sorted(want) == sorted(got)
        for k in want:
            _close(got[k].asnumpy(), want[k].asnumpy(), k)
    return mods


HARNESS_SGD = {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-4}


@pytest.mark.parametrize("net", ["mlp", "lenet"])
def test_train_mnist_matches_the_reference(net):
    """The harness's step: ``fit``'s fused step with a local store, SGD
    0.1 / 0.9 / 1e-4 (``add_fit_args``' momentum and decay)."""
    build = "get_lenet" if net == "lenet" else "get_mlp"
    syms = _both(getattr(REF["train_mnist"], build),
                 getattr(PORT["train_mnist"], build))
    x, y = PORT["train_mnist"].synth_mnist(8, seed=7)
    _module_pair(syms, x, y, "sgd", HARNESS_SGD, fused=True, store=True)


def test_train_cifar10_matches_the_reference():
    """ResNet-8 (BatchNorm, the moving statistics compared as aux
    states) on 28x28 crops, the harness's step with a local store."""
    syms = _both(lambda: ref_resnet.get_symbol(
        num_classes=10, num_layers=8, image_shape="3,28,28"),
        PORT["train_cifar10"].get_symbol)
    x, y = PORT["train_cifar10"].synth_cifar(4, seed=11)
    _module_pair(syms, np.ascontiguousarray(x[:, :, 2:30, 2:30]), y, "sgd",
                 HARNESS_SGD, fused=True, store=True)


@pytest.mark.parametrize("head", PORT["svm_mnist"].HEADS)
def test_svm_mnist_matches_the_reference(head):
    """Each loss head through ``forward_backward`` + ``update``, SGD 0.05
    / 0.9, as the example's ``run`` trains it: SVMOutput's backward (L2
    and L1 hinge) against the reference's."""
    syms = _both(lambda: REF["svm_mnist"].build(head),
                 lambda: PORT["svm_mnist"].build(head))
    x, y = PORT["svm_mnist"].synth_digits(8, seed=1)
    _module_pair(syms, x, y, "sgd", {"learning_rate": 0.05, "momentum": 0.9},
                 fused=False, store=False)


def test_cnn_text_classification_matches_the_reference():
    cnn = PORT["cnn_text_classification"], REF["cnn_text_classification"]
    _both(cnn[1].get_symbol, cnn[0].get_symbol)
    syms = _both(lambda: cnn[1].get_symbol(dropout=0.0),
                 lambda: cnn[0].get_symbol(dropout=0.0))
    x, y = cnn[0].synth_corpus(8)
    _module_pair(syms, x, y, "sgd", {"learning_rate": 0.05, "momentum": 0.9},
                 fused=True, store=False)


# ----------------------------------------------------------------- Gluon

def _gluon_pair(nets, loss_fn, optimizer, opt_params, step_size, steps=3,
                params=None):
    """Both packages' nets from the reference's Xavier parameters,
    paired by position (Gluon's global name counters differ between the
    packages' histories), then ``steps`` steps of ``optimizer`` under
    ``autograd.record()``: each step's loss and the step-1 gradients
    agree, and the parameters after them."""
    params = params or (lambda net: list(net.collect_params().values()))
    for pkg, net in zip((mx, mt), nets):
        for blk in (net if isinstance(net, list) else [net]):
            blk.initialize(pkg.init.Xavier())
        loss_fn(pkg, net)                   # finish deferred shapes
    jp, pp = params(nets[0]), params(nets[1])
    assert [p.shape for p in jp] == [p.shape for p in pp]
    for a, b in zip(jp, pp):
        b.set_data(mt.nd.array(a.data().asnumpy()))
    trainers = [pkg.gluon.Trainer(ps, optimizer, dict(opt_params))
                for pkg, ps in zip((mx, mt), (jp, pp))]
    for s in range(steps):
        losses = []
        for pkg, net, tr in zip((mx, mt), nets, trainers):
            with pkg.autograd.record():
                loss = loss_fn(pkg, net)
            loss.backward()
            losses.append(float(np.asarray(loss.asnumpy()).ravel()[0]))
            if s == 0:
                grads = [p.grad().asnumpy()
                         for p in (jp if pkg is mx else pp)]
                if pkg is mx:
                    want = grads
                else:
                    for i, (g, w) in enumerate(zip(grads, want)):
                        _close(g, w, "gradient %d" % i)
            tr.step(step_size)
        _close(losses[1], losses[0], "step %d loss" % (s + 1))
    for i, (a, b) in enumerate(zip(jp, pp)):
        _close(b.data().asnumpy(), a.data().asnumpy(), "parameter %d" % i)
    return nets


def _sce_loss(x, y, mean=True):
    def loss(pkg, net):
        out = pkg.gluon.loss.SoftmaxCrossEntropyLoss()(
            net(pkg.nd.array(x)), pkg.nd.array(y))
        return pkg.nd.mean(out) if mean else out
    return loss


def test_gluon_mnist_matches_the_reference():
    """The example's own builder in each package (prefix ``mlp_``),
    SGD 0.1 / 0.9 stepped by the batch size, as its loop does."""
    np.random.seed(0)
    nets = [REF["gluon_mnist"].build_net(), PORT["gluon_mnist"].build_net()]
    assert sorted(nets[0].collect_params()) == \
        sorted(nets[1].collect_params())
    x, y = PORT["gluon_mnist"].synth_mnist(8, seed=7)
    _gluon_pair(nets, _sce_loss(x, y, mean=False), "sgd",
                {"learning_rate": 0.1, "momentum": 0.9}, 8)


def test_autoencoder_matches_the_reference():
    """The whole stack's reconstruction loss, Adam 0.01 stepped by the
    batch size, as the fine-tune runs it."""
    np.random.seed(0)
    ae = PORT["autoencoder"]
    stacks = [ae.build_stack(mx), ae.build_stack(mt)]
    x = ae.synth_data(8)

    def loss(pkg, stack):
        z = pkg.nd.array(x)
        return pkg.nd.mean(pkg.nd.square(ae.full(*stack, z) - z))

    _gluon_pair([list(s[0] + s[1]) for s in stacks],
                lambda pkg, blocks: loss(pkg, (blocks[:2], blocks[2:])),
                "adam", {"learning_rate": 0.01}, 8,
                params=lambda blocks: [p for b in blocks for p in
                                       b.collect_params().values()])


def test_adversary_fgsm_matches_the_reference():
    """The classifier's training steps (Adam 1e-3, ``step(1)``), then
    the gradient on the input images that FGSM steps along."""
    np.random.seed(0)
    fg = PORT["adversary_fgsm"]
    x, y = fg.synth_digits(8, seed=1)
    nets = _gluon_pair([fg.build_net(mx), fg.build_net(mt)],
                       lambda pkg, net: pkg.nd.mean(_sce_loss(x, y)(pkg,
                                                                    net)),
                       "adam", {"learning_rate": 1e-3}, 1)
    _, g = fg.fgsm(nets[1], mt.gluon.loss.SoftmaxCrossEntropyLoss(), x, y,
                   0.3)
    xv = mx.nd.array(x)
    xv.attach_grad()
    with mx.autograd.record():
        loss = mx.nd.mean(mx.gluon.loss.SoftmaxCrossEntropyLoss()(
            nets[0](xv), mx.nd.array(y)))
    loss.backward()
    _close(g, xv.grad.asnumpy(), "the gradient on the input")


def test_super_resolution_matches_the_reference():
    """The reference's own ``SuperResolutionNet`` against the port's
    (pixel shuffle, the nearest-upscale residual). At the example's Adam
    0.01, 31 of the first conv's 1,600 weights part by up to 3.9e-4 after
    three steps: Adam's normalized step turns the last-bit difference of
    a gradient near zero into up to lr (C10), so the steps run at lr
    1e-4, as the LM's Adam parity test does."""
    np.random.seed(0)
    sr = PORT["super_resolution"]
    hi = sr.make_images(4, 16)
    lo = sr.downscale(hi, 2)
    nets = [REF["super_resolution"].SuperResolutionNet(mx, 2),
            sr.SuperResolutionNet(mt, 2)]

    def loss(pkg, net):
        return pkg.nd.mean(pkg.nd.square(net(pkg.nd.array(lo))
                                         - pkg.nd.array(hi)))

    _gluon_pair(nets, loss, "adam", {"learning_rate": 1e-4}, 4)


def test_actor_critic_matches_the_reference():
    """One episode's actor-critic loss (the policy gradient with the
    critic's baseline, half the value regression), Adam 0.02."""
    np.random.seed(0)
    ac = PORT["actor_critic"]
    env, rng = ac.CartPole(0), np.random.RandomState(1)
    states, actions = [env.reset()], []
    for _ in range(12):
        actions.append(int(rng.randint(2)))
        s, _, done = env.step(actions[-1])
        if done:
            break
        states.append(s)
    states = states[:len(actions)]
    rets = ac.returns([1.0] * len(actions), 0.99)
    _gluon_pair([ac.build_net(mx), ac.build_net(mt)],
                lambda pkg, net: ac.episode_loss(pkg, net, states, actions,
                                                 rets),
                "adam", {"learning_rate": 0.02}, 1)


def test_dqn_matches_the_reference():
    """The TD loss of one replay batch against a frozen target with the
    Q-network's initial weights, Adam 1e-3."""
    np.random.seed(0)
    dq = PORT["dqn"]
    rng = np.random.RandomState(2)
    batch = [(rng.randn(4).astype(np.float32), int(rng.randint(2)),
              float(rng.randint(2)), rng.randn(4).astype(np.float32),
              bool(rng.rand() < 0.2)) for _ in range(16)]
    targets = []
    for pkg in (mx, mt):
        t = dq.make_net(pkg)
        t.initialize(pkg.init.Xavier())
        t(pkg.nd.array(np.zeros((1, 4), np.float32)))
        draw = np.random.RandomState(3)
        for p in t.collect_params().values():
            p.set_data(pkg.nd.array(draw.randn(*p.shape) * 0.3))
        targets.append(t)
    qnets = [dq.make_net(mx), dq.make_net(mt)]

    def loss(pkg, net):
        return dq.td_loss(pkg, net, targets[0 if pkg is mx else 1], batch,
                          0.99)

    _gluon_pair(qnets, loss, "adam", {"learning_rate": 1e-3}, 1)


def test_neural_style_matches_the_reference():
    """The content and style losses and the gradient on the pixels, the
    reference's features built by the port's ``features`` in its
    package, then three normalized pixel steps."""
    ns = PORT["neural_style"]
    content, style = ns.make_images(16)
    xs = []
    for pkg in (mx, mt):
        W1, W2 = (pkg.nd.array(w) for w in ns.feature_weights())
        c_feats = [f.detach() for f in ns.features(pkg, pkg.nd.array(content),
                                                   W1, W2)]
        s_grams = [ns.gram(pkg, f) for f in ns.features(
            pkg, pkg.nd.array(style), W1, W2)]
        x, trace = pkg.nd.array(content.copy()), []
        for _ in range(3):
            x.attach_grad()
            with pkg.autograd.record():
                closs, sloss = ns.losses(pkg, x, W1, W2, c_feats, s_grams)
                loss = closs + 30.0 * sloss
            loss.backward()
            g = x.grad.asnumpy()
            trace.append((float(closs.asnumpy()), float(sloss.asnumpy()), g))
            g = g / (np.abs(g).mean() + 1e-8)
            x = pkg.nd.array(np.clip(x.asnumpy() - 0.02 * g, -0.2, 1.4))
        xs.append((x.asnumpy(), trace))
    for s, (a, b) in enumerate(zip(xs[1][1], xs[0][1])):
        _close(a[0], b[0], "content loss %d" % s)
        _close(a[1], b[1], "style loss %d" % s)
        _close(a[2], b[2], "pixel gradient %d" % s)
    _close(xs[1][0], xs[0][0], "the image after three steps")


# -------------------------------------------------------- the harness

def test_harness_contexts_never_fall_back():
    """``--gpus`` names cards; without it the current context, the CPU
    only inside a scope that asks for it; with no card and no scope
    (a thread of its own starts with none) it raises."""
    import argparse
    import threading
    from mxnet_tpu_torch.examples.common import fit as fit_mod
    args = argparse.Namespace(gpus=None)
    assert fit_mod._contexts(args) == [mt.cpu()]
    assert fit_mod._contexts(argparse.Namespace(gpus="0,1")) == \
        [mt.gpu(0), mt.gpu(1)]
    raised = []

    def bare():
        try:
            fit_mod._contexts(args)
        except mt.MXNetError as exc:
            raised.append(exc)

    th = threading.Thread(target=bare)
    th.start()
    th.join()
    assert not torch.cuda.is_available() and len(raised) == 1
    assert "no CUDA device" in str(raised[0])


def test_harness_lr_steps_match_the_reference():
    import argparse
    from mxnet_tpu_torch.examples.common import fit as fit_mod
    sys.path.insert(0, os.path.dirname(REF["train_mnist"].__file__))
    from common import fit as ref_fit
    for load, steps in ((None, "4,6"), (5, "4,6"), (7, "4,6"), (0, "")):
        args = argparse.Namespace(lr=0.1, lr_factor=0.1, load_epoch=load,
                                  lr_step_epochs=steps)
        got = fit_mod._lr_scheduler(args, 18, None)
        want = ref_fit._lr_scheduler(args, 18, None)
        assert got[0] == want[0]
        assert (got[1] is None) == (want[1] is None)
        if got[1] is not None:
            assert got[1].step == want[1].step
            assert got[1].factor == want[1].factor
    parsers = []
    for mod in (fit_mod, ref_fit):
        p = argparse.ArgumentParser()
        mod.add_fit_args(p)
        parsers.append(vars(p.parse_args([])))
    assert parsers[0] == parsers[1]


# ------------------------------------------------------------ rehearsal

SMALL_ARGV = {
    "train_mnist": ["--num-epochs", "1", "--num-examples", "200",
                    "--batch-size", "50", "--use-rec"],
    "train_cifar10": ["--num-epochs", "1", "--num-examples", "120",
                      "--batch-size", "40"],
    "svm_mnist": ["--num-epochs", "1", "--num-examples", "200"],
    "cnn_text_classification": ["--num-epochs", "1", "--num-examples",
                                "300"],
    "gluon_mnist": ["--num-epochs", "1", "--num-examples", "300"],
    "autoencoder": ["--num-epochs", "1", "--pretrain-epochs", "1",
                    "--num-examples", "300"],
    "adversary_fgsm": ["--num-epochs", "1"],
    "super_resolution": ["--num-epochs", "1", "--num-examples", "40"],
    "neural_style": ["--num-steps", "3"],
    "actor_critic": ["--num-episodes", "3", "--max-steps", "20"],
    "dqn": ["--num-episodes", "2"],
}


@pytest.fixture
def small(monkeypatch, tmp_path):
    """Phase 18 on the CPU: the store checks at a small width, the
    examples at a few steps with their gates off, the CUDA-only calls
    stood in for."""
    for name, value in (("DEVICE", "cpu"), ("ROOT", tmp_path),
                        ("KV_SHAPE", (4, 9)),
                        ("KV_MLP", dict(cs.KV_MLP, examples=96, epochs=1)),
                        ("A9A_ARGV", SMALL_ARGV)):
        monkeypatch.setattr(cs, name, value)
    monkeypatch.setattr(mt, "gpu", lambda i=0: mt.cpu())
    for fn in ("synchronize", "reset_peak_memory_stats"):
        monkeypatch.setattr(torch.cuda, fn, lambda *a: None)
    monkeypatch.setattr(torch.cuda, "memory_allocated", lambda *a: 0)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated", lambda *a: 1)
    # the gates hold at the examples' sizes, not at these
    monkeypatch.setattr(common, "gate", lambda ok, message: None)
    lines = []
    monkeypatch.setattr(cs, "log", lambda *a: lines.append(a[0]))
    return lines


def test_kvstore_phase_rehearsal_on_cpu(small):
    out = cs.kvstore_phase(torch, np)
    assert sorted(out["examples"]) == sorted(NAMES)
    for head in ["18a store:", "18 kvstore and examples:"] + [
            "18b %s:" % n for n in NAMES]:
        assert any(ln.startswith(head) for ln in small), head
    assert out["store"]["update_err"] <= cs.KV_ATOL


def test_a_failed_gate_ends_the_run(small, monkeypatch):
    monkeypatch.setattr(common, "gate", GATE)
    monkeypatch.setattr(cs, "A9A_EXAMPLES", ("gluon_mnist",))
    monkeypatch.setattr(cs, "A9A_ARGV",
                        {"gluon_mnist": ["--num-epochs", "0"]})
    with pytest.raises(cs.SmokeFailure, match="18b gluon_mnist: its gate"):
        cs.a9a_examples(torch, np, mt)


def test_store_checks_end_the_run(small, monkeypatch, tmp_path):
    real = mt.kvstore.KVStore._local_reduce
    monkeypatch.setattr(mt.kvstore.KVStore, "_local_reduce",
                        staticmethod(lambda vl: real(vl[:-1])))
    with pytest.raises(cs.SmokeFailure, match="push of four values"):
        cs.kvstore_arith(torch, np, mt, tmp_path)
    monkeypatch.undo()


def test_fit_with_a_store_that_differs_ends_the_run(small, monkeypatch):
    real = mt.mod.Module._fit_step

    def off(self, batch):
        real(self, batch)
        if self._kvstore is not None:
            w = self._exec.arg_dict["fc2_bias"].data
            w.add_(1e-7)

    monkeypatch.setattr(mt.mod.Module, "_fit_step", off)
    with pytest.raises(cs.SmokeFailure, match="fit with a local store"):
        cs.kvstore_module(torch, np, mt)
