"""The slice as a whole: the zoo LM trains with Adam through
``Module.fit`` in both packages.

The zoo decoder LM at a small size (vocab 64, 2 layers, d_model 64, 4
heads, T 32, batch 4, ``attention="flash"``; the reference runs its
Pallas kernels in interpret mode, as its own tests do) starts from the
same seeded parameters in both packages and trains one ``fit`` epoch
of 5 batches with Adam (lr 1e-4, wd 1e-4, clip_gradient 1.0), a
``FactorScheduler(step=4, factor=0.5)`` (its boundary falls on step 5)
and ``CompositeEvalMetric([CrossEntropy(), Perplexity(None)])``: the
configuration the card's phase 11 runs at full width. Each step's
cross-entropy, the epoch's metrics and the final parameters agree
within 1e-5. The two packages' gradients part by f32 rounding, and
Adam's normalized step turns a rounding of a gradient near zero into a
difference of up to about lr in the step (measured at lr 1e-3: 8e-6 in
the parameters after one step, 9e-5 after five), so the gap scales
with lr. A second port run that checkpoints after 3 batches and
resumes ends on the uninterrupted run's parameters exactly.

Where the two packages part (ROADMAP C10, closed as not a fault): in the
step-1 gradients, before any update. The backward's f32 sums run in
another order in each package, so almost every gradient element differs
in its last bits (measured: up to 7.4e-7 of a parameter's largest
gradient, ``layer0_ln1_gamma``); an element near zero (``layer0_att_qkv_bias``
holds gradients of 4.5e-11) then moves Adam's normalized step by up to
lr. The update arithmetic is no fixed order to match: the reference's
own ``adam_update`` rounds differently jitted and eager (tens of
thousands of moment elements of 10^5 differ), and the port's lies as
close to the jitted one as the eager one does. So the test keeps lr
1e-4 and its limit.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import mxnet_tpu as mx
from mxnet_tpu.models import transformer as jax_transformer
import mxnet_tpu_torch as mt
from mxnet_tpu_torch.models import transformer as port_transformer

# test files run side by side in parallel workers: each keeps torch's
# intra-op pool small
torch.set_num_threads(2)

ATOL = 1e-5
V, L, D, H, T, N, STEPS = 64, 2, 64, 4, 32, 4, 5
KW = dict(vocab_size=V, num_layers=L, d_model=D, n_heads=H, seq_len=T,
          attention="flash")
ADAM = {"learning_rate": 1e-4, "wd": 1e-4, "clip_gradient": 1.0}


class _Stop(Exception):
    pass


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(0)
    x = rng.integers(0, V, (STEPS * N, T)).astype(np.float32)
    y = rng.integers(0, V, (STEPS * N, T)).astype(np.float32)
    init = mx.mod.Module(jax_transformer.get_symbol(**KW), context=mx.cpu())
    init.bind(data_shapes=[("data", (N, T))],
              label_shapes=[("softmax_label", (N, T))])
    init.init_params(mx.init.Xavier())
    args = {k: v.asnumpy() for k, v in init.get_params()[0].items()}
    return x, y, args, _run(mx, x, y, args)


def _run(pkg, x, y, args, ckpt=None, resume=None, stop_after=None):
    """One fit epoch; returns the per-step cross-entropies, the metric
    values and the final parameters."""
    ctx = {"ctx": mt.cpu()} if pkg is mt else {}
    models = port_transformer if pkg is mt else jax_transformer
    mod = pkg.mod.Module(models.get_symbol(**KW),
                         context=mt.cpu() if pkg is mt else mx.cpu())
    metric = pkg.metric.CompositeEvalMetric(
        [pkg.metric.CrossEntropy(), pkg.metric.Perplexity(None)])
    losses = []

    def record(param):
        probs = mod.get_outputs()[0].asnumpy()
        label = y[param.nbatch * N:(param.nbatch + 1) * N].reshape(-1)
        p = probs[np.arange(label.size), label.astype(np.int64)]
        losses.append(float(-np.log(p + 1e-12).mean()))
        if stop_after is not None and len(losses) >= stop_after:
            raise _Stop()

    try:
        mod.fit(pkg.io.NDArrayIter(x, y, batch_size=N), num_epoch=1,
                eval_metric=metric, optimizer="adam",
                optimizer_params=dict(
                    ADAM, lr_scheduler=pkg.lr_scheduler.FactorScheduler(
                        step=4, factor=0.5)),
                arg_params=None if resume else
                {k: pkg.nd.array(v, **ctx) for k, v in args.items()},
                batch_end_callback=record, checkpoint=ckpt,
                resume_from=resume)
    except _Stop:
        pass
    params = {k: v.asnumpy() for k, v in mod.get_params()[0].items()}
    return losses, metric.get(), params


def test_adam_lm_fit_matches_reference(setup):
    x, y, args, (want_losses, want_metric, want_params) = setup
    losses, metric, params = _run(mt, x, y, args)
    assert len(losses) == len(want_losses) == STEPS
    np.testing.assert_allclose(losses, want_losses, atol=ATOL)
    assert metric[0] == want_metric[0] == ["cross-entropy", "perplexity"]
    np.testing.assert_allclose(metric[1], want_metric[1], rtol=ATOL)
    assert sorted(params) == sorted(want_params)
    for k in want_params:
        np.testing.assert_allclose(params[k], want_params[k], atol=ATOL,
                                   err_msg=k)


def test_adam_lm_resume_is_bit_identical(setup, tmp_path):
    x, y, args, _ = setup
    _, metric, want = _run(mt, x, y, args)
    ckpt = mt.checkpoint.CheckpointConfig(str(tmp_path), every_n_batches=3)
    _run(mt, x, y, args, ckpt=ckpt, stop_after=4)
    latest = mt.checkpoint.restore_latest(str(tmp_path))
    assert latest.batches_done == 3 and latest.step == 3
    _, metric_res, got = _run(mt, x, y, args, resume=str(tmp_path))
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    np.testing.assert_allclose(metric_res[1], metric[1], rtol=1e-12)


def test_the_packages_part_in_the_step_one_gradients(setup):
    """C10: one forward and backward from the same parameters on the
    same batch: every gradient agrees within 1e-5 of its largest
    element, and the gradients already differ (f32 sums in another
    order) before any Adam update runs."""
    x, y, args, _ = setup
    grads = []
    for pkg, models in ((mx, jax_transformer), (mt, port_transformer)):
        ctx = {"ctx": mt.cpu()} if pkg is mt else {}
        mod = pkg.mod.Module(models.get_symbol(**KW),
                             context=mt.cpu() if pkg is mt else mx.cpu())
        mod.bind(data_shapes=[("data", (N, T))],
                 label_shapes=[("softmax_label", (N, T))])
        mod.init_params(arg_params={k: pkg.nd.array(v, **ctx)
                                    for k, v in args.items()})
        mod.forward(pkg.io.DataBatch(data=[pkg.nd.array(x[:N], **ctx)],
                                     label=[pkg.nd.array(y[:N], **ctx)]),
                    is_train=True)
        mod.backward()
        grads.append({k: mod._exec.grad_dict[k].asnumpy() for k in args})
    differ = 0
    for k in args:
        want, got = grads[0][k], grads[1][k]
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=ATOL * np.abs(want).max(), err_msg=k)
        differ += int((got != want).sum())
    assert differ > 0


def test_adam_update_arithmetic_has_no_single_order_to_match():
    """C10: the reference's ``adam_update`` jitted and eager round
    differently; the port's lies as close to the jitted one as the eager
    one does (measured: the same largest difference in the weights and
    the variances, 1.1 times it in the means)."""
    from mxnet_tpu.ops import get_op as ref_op
    from mxnet_tpu_torch.ops import get_op as port_op
    r = np.random.default_rng(1)
    n = 100000
    w = r.standard_normal(n).astype(np.float32)
    g = (r.standard_normal(n) * 1e-3).astype(np.float32)
    m = (r.standard_normal(n) * 1e-4).astype(np.float32)
    v = (r.random(n) * 1e-6).astype(np.float32)
    kw = dict(lr=1e-3, wd=1e-4, rescale_grad=0.25, clip_gradient=1.0)
    jit = [np.asarray(t) for t in jax.jit(
        lambda *a: ref_op("adam_update").fn(*a, **kw))(w, g, m, v)]
    eager = [np.asarray(t) for t in ref_op("adam_update").fn(
        *[jnp.asarray(a) for a in (w, g, m, v)], **kw)]
    port = [t.numpy() for t in port_op("adam_update").fn(
        *[torch.from_numpy(a) for a in (w, g, m, v)], **kw)]
    assert any((a != b).any() for a, b in zip(jit, eager))
    for a, b, c in zip(jit, eager, port):
        assert np.abs(c - a).max() <= 2 * np.abs(b - a).max()
