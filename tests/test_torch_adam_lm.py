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
"""
import numpy as np
import pytest

import mxnet_tpu as mx
from mxnet_tpu.models import transformer as jax_transformer
import mxnet_tpu_torch as mt
from mxnet_tpu_torch.models import transformer as port_transformer

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
