"""The port's Symbol, executor and training-path ops against the
reference package.

* The zoo transformer's ``get_symbol`` gives the same argument names,
  order and inferred shapes in both packages
  (``tests/test_transformer.py``'s shape-inference check).
* The JSON that ``mxnet_tpu`` writes for the transformer loads in the
  port and runs forward to the same outputs.
* Every op of the training path gives the same forward and the same
  input gradients as the reference op (``jax.vjp`` there,
  ``torch.autograd`` here) on numpy-seeded inputs, atol 1e-5 in f32:
  both sides compute the same formulas in f32 over at most a few hundred
  terms. This includes LayerNorm's analytic backward, SoftmaxOutput's
  cross-entropy gradient (which ignores the incoming cotangent) and the
  Reshape codes.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import mxnet_tpu as mx
from mxnet_tpu.models import transformer as jax_transformer
from mxnet_tpu.ops import get_op as jax_get_op
import mxnet_tpu_torch as mt
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.models import transformer as port_transformer
from mxnet_tpu_torch.ops import get_op
from mxnet_tpu_torch.ops.matrix import reshape_shape

ATOL = 1e-5
SMALL = dict(vocab_size=64, num_layers=2, d_model=32, n_heads=2,
             seq_len=64)


@pytest.mark.parametrize("attention", ["flash", "dense"])
def test_get_symbol_arguments_and_shapes_match(attention):
    kw = dict(SMALL, attention=attention)
    js = jax_transformer.get_symbol(**kw)
    ps = port_transformer.get_symbol(**kw)
    assert ps.list_arguments() == js.list_arguments()
    assert ps.list_outputs() == js.list_outputs()
    shapes = dict(data=(4, 64), softmax_label=(4, 64))
    ja, jo, _ = js.infer_shape(**shapes)
    pa, po, _ = ps.infer_shape(**shapes)
    assert pa == [tuple(s) for s in ja]
    assert po == [tuple(s) for s in jo] == [(256, 64)]


def test_shapes_infer_from_data_alone():
    """The reference's check: parameter shapes follow from the data."""
    sym = port_transformer.get_symbol(vocab_size=50, num_layers=1,
                                      d_model=32, n_heads=4, seq_len=8)
    arg_shapes, out_shapes, _ = sym.infer_shape(data=(2, 8),
                                                softmax_label=(2, 8))
    shapes = dict(zip(sym.list_arguments(), arg_shapes))
    assert shapes["tok_embed_weight"] == (50, 32)
    assert shapes["layer0_att_qkv_weight"] == (96, 32)
    assert shapes["layer0_ln1_gamma"] == (32,)
    assert out_shapes[0] == (2 * 8, 50)


def _seeded_args(names, shapes, seed, vocab):
    rng = np.random.default_rng(seed)
    out = {}
    for n, s in zip(names, shapes):
        if n in ("data", "softmax_label"):
            out[n] = rng.integers(0, vocab, s).astype(np.float32)
        elif n.endswith("_gamma"):
            out[n] = (1 + 0.1 * rng.standard_normal(s)).astype(np.float32)
        else:
            out[n] = (0.1 * rng.standard_normal(s)).astype(np.float32)
    return out


@pytest.mark.parametrize("attention", ["flash", "dense"])
def test_reference_json_loads_and_runs_to_same_outputs(attention):
    js = jax_transformer.get_symbol(**dict(SMALL, attention=attention))
    ps = mt.sym.load_json(js.tojson())
    assert ps.list_arguments() == js.list_arguments()
    shapes = dict(data=(2, 64), softmax_label=(2, 64))
    arg_shapes, _, _ = js.infer_shape(**shapes)
    args = _seeded_args(js.list_arguments(), arg_shapes, 0, 64)
    jex = js.bind(mx.cpu(), {n: mx.nd.array(a) for n, a in args.items()},
                  grad_req="null")
    want = jex.forward(is_train=False)[0].asnumpy()
    pex = ps.bind(mt.cpu(), {n: mt.nd.array(a, ctx=mt.cpu())
                             for n, a in args.items()},
                  grad_req="null")
    got = pex.forward(is_train=False)[0].asnumpy()
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_port_json_round_trip():
    ps = port_transformer.get_symbol(**dict(SMALL, attention="flash"))
    back = mt.sym.load_json(ps.tojson())
    assert back.list_arguments() == ps.list_arguments()
    assert back.tojson() == ps.tojson()


# ------------------------------------------------------------- per-op parity
# (op name, input shapes, attrs, positions of differentiable inputs,
#  integer-valued inputs as {position: high})
OP_CASES = [
    ("FullyConnected", [(4, 3, 5), (6, 5), (6,)],
     dict(num_hidden=6, flatten=False), (0, 1, 2), {}),
    ("FullyConnected", [(4, 3, 5), (6, 15), (6,)],
     dict(num_hidden=6), (0, 1, 2), {}),
    ("FullyConnected", [(4, 5), (6, 5)],
     dict(num_hidden=6, no_bias=True), (0, 1), {}),
    ("Activation", [(4, 7)], dict(act_type="relu"), (0,), {}),
    ("softmax", [(3, 4, 9)], dict(axis=-1), (0,), {}),
    ("LayerNorm", [(3, 5, 16), (16,), (16,)], {}, (0, 1, 2), {}),
    ("LayerNorm", [(6, 8), (6,), (6,)], dict(axis=0), (0, 1, 2), {}),
    ("SoftmaxOutput", [(12, 9), (12,)], dict(normalization="batch"),
     (0,), {1: 9}),
    ("SoftmaxOutput", [(12, 9), (12,)], dict(grad_scale=0.5), (0,),
     {1: 9}),
    ("SoftmaxOutput", [(4, 5, 3), (4, 3)], dict(multi_output=True), (0,),
     {1: 5}),
    ("SoftmaxOutput", [(2, 3, 6), (2, 3)], dict(preserve_shape=True), (0,),
     {1: 6}),
    ("SoftmaxOutput", [(6, 5), (6,)],
     dict(use_ignore=True, ignore_label=2, normalization="valid"), (0,),
     {1: 5}),
    ("Reshape", [(2, 3, 4)], dict(shape=(0, -1)), (0,), {}),
    ("Reshape", [(2, 3, 4)], dict(shape=(-1, 3, 2, 2)), (0,), {}),
    ("Reshape", [(2, 3, 4)], dict(shape=(-3, -2)), (0,), {}),
    ("Reshape", [(2, 3, 4)], dict(shape=(0, -4, 1, -1, 4)), (0,), {}),
    ("Reshape", [(2, 3, 4)], dict(shape=(-1, 0), reverse=True), (0,), {}),
    ("transpose", [(2, 3, 4, 5)], dict(axes=(2, 0, 3, 1)), (0,), {}),
    ("transpose", [(2, 3)], {}, (0,), {}),
    ("slice_axis", [(3, 4, 5)], dict(axis=1, begin=1, end=3), (0,), {}),
    ("slice_axis", [(3, 4, 5)], dict(axis=-1, begin=2, end=None), (0,),
     {}),
    ("batch_dot", [(3, 4, 5), (3, 6, 5)], dict(transpose_b=True), (0, 1),
     {}),
    ("batch_dot", [(3, 4, 5), (3, 5, 6)], {}, (0, 1), {}),
    ("elemwise_add", [(3, 4), (3, 4)], {}, (0, 1), {}),
    ("broadcast_add", [(2, 3, 4), (1, 3, 4)], {}, (0, 1), {}),
    ("_plus", [(3, 4), (3, 4)], {}, (0, 1), {}),
    ("broadcast_greater", [(1, 5), (5, 1)], {}, (), {}),
    ("_mul_scalar", [(3, 4)], dict(scalar=-1e9), (0,), {}),
    ("_plus_scalar", [(3, 4)], dict(scalar=2.5), (0,), {}),
    ("elemwise_sub", [(3, 4), (3, 4)], {}, (0, 1), {}),
    ("elemwise_mul", [(3, 4), (3, 4)], {}, (0, 1), {}),
    ("elemwise_div", [(3, 4), (3, 4)], {}, (0,), {}),
    ("_minus_scalar", [(3, 4)], dict(scalar=1.5), (0,), {}),
    ("_rminus_scalar", [(3, 4)], dict(scalar=1.5), (0,), {}),
    ("_div_scalar", [(3, 4)], dict(scalar=4.0), (0,), {}),
    ("_rdiv_scalar", [(3, 4)], dict(scalar=2.0), (), {}),
    ("negative", [(3, 4)], {}, (0,), {}),
    ("Embedding", [(2, 5), (11, 4)], dict(input_dim=11, output_dim=4),
     (1,), {0: 11}),
    ("FlashAttention", [(1, 2, 32, 16)] * 3, dict(causal=True), (0, 1, 2),
     {}),
]


def _case_id(case):
    name, shapes, attrs = case[:3]
    return "%s-%s" % (name, "-".join("%s=%s" % kv for kv in
                                     sorted(attrs.items())) or "default")


@pytest.mark.parametrize("case", OP_CASES, ids=[_case_id(c)
                                                 for c in OP_CASES])
def test_op_forward_and_input_grads_match_reference(case):
    name, shapes, attrs, diff, ints = case
    rng = np.random.default_rng(7)
    ins = []
    for pos, shape in enumerate(shapes):
        if pos in ints:
            ins.append(rng.integers(0, ints[pos], shape).astype(np.float32))
        else:
            ins.append(rng.standard_normal(shape).astype(np.float32))
    jattrs = dict(attrs)
    if name == "FlashAttention":
        jattrs["interpret"] = True
    jop, pop = jax_get_op(name), get_op(name)

    jout, vjp = jax.vjp(lambda *xs: jop.fn(*xs, **jattrs),
                        *[jnp.asarray(x) for x in ins])
    jout = np.asarray(jout)
    ct = rng.standard_normal(jout.shape).astype(np.float32)
    jgrads = vjp(jnp.asarray(ct))

    tins = [torch.from_numpy(x).requires_grad_(pos in diff)
            for pos, x in enumerate(ins)]
    pout = pop.fn(*tins, **attrs)
    np.testing.assert_allclose(pout.detach().numpy(), jout, atol=ATOL)
    if diff:
        pgrads = torch.autograd.grad(pout, [tins[p] for p in diff],
                                     torch.from_numpy(ct))
        for p, g in zip(diff, pgrads):
            np.testing.assert_allclose(g.numpy(), np.asarray(jgrads[p]),
                                       atol=ATOL)


def test_arange_matches_reference():
    got = get_op("_arange").fn(start=0, stop=7, _device="cpu")
    want = np.asarray(jax_get_op("_arange").fn(start=0, stop=7))
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.dtype == torch.float32


@pytest.mark.parametrize("shape,spec,reverse", [
    ((2, 3, 4), (0, -1), False), ((2, 3, 4), (-2,), False),
    ((2, 3, 4), (-3, 0), False), ((6, 4), (-4, 2, -1, 0), False),
    ((2, 3, 4), (-1, 0), True), ((24,), (2, -1, 3), False)])
def test_reshape_codes_match_reference(shape, spec, reverse):
    x = np.arange(int(np.prod(shape)), dtype=np.float32).reshape(shape)
    want = np.asarray(jax_get_op("Reshape").fn(jnp.asarray(x), shape=spec,
                                               reverse=reverse))
    assert reshape_shape(shape, spec, reverse) == want.shape
    got = get_op("Reshape").fn(torch.from_numpy(x), shape=spec,
                               reverse=reverse)
    np.testing.assert_array_equal(got.numpy(), want)


def test_fully_connected_under_amp_matches_reference():
    """bf16 operands, f32 accumulation, bf16 output, bias added in bf16:
    both packages give the same bf16 result up to one bf16 rounding."""
    rng = np.random.default_rng(8)
    x, w, b = (rng.standard_normal(s).astype(np.float32)
               for s in ((4, 3, 64), (8, 64), (8,)))
    with mx.amp.scope("bfloat16"):
        want = jax_get_op("FullyConnected").fn(
            jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), num_hidden=8,
            flatten=False)
    with mt.amp.scope("bfloat16"):
        got = get_op("FullyConnected").fn(
            *(torch.from_numpy(a) for a in (x, w, b)), num_hidden=8,
            flatten=False)
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    want = np.asarray(want.astype(jnp.float32))
    np.testing.assert_allclose(got.float().numpy(), want,
                               atol=np.abs(want).max() * 2 ** -7)
    assert not mt.amp.active()


def test_softmax_output_head_is_f32_under_amp():
    logits = torch.zeros((4, 5), dtype=torch.bfloat16)
    with mt.amp.scope("bfloat16"):
        out = get_op("SoftmaxOutput").fn(logits, torch.zeros(4))
    assert out.dtype == torch.float32


# ------------------------------------------------------------- executor

def _fc_symbol():
    data = mt.sym.Variable("data")
    fc = mt.sym.FullyConnected(data, num_hidden=3, name="fc")
    return mt.sym.SoftmaxOutput(fc, mt.sym.Variable("softmax_label"),
                                name="softmax")


def test_symbol_operators_lower_to_reference_ops():
    """``x + h``, ``h * -1e9``, ``1 - x``, ``x / 2`` and ``-x`` build the
    same op nodes as in the reference."""
    def ops(sym):
        import json
        return [n["op"] for n in json.loads(sym.tojson())["nodes"]]
    for mod in (mx.sym, mt.sym):
        x, h = mod.Variable("x"), mod.Variable("h")
        got = ops(-((x + h) * -1e9 - (1 - x) / 2))
        if mod is mx.sym:
            want = got
    assert got == want == ["null", "null", "elemwise_add", "_mul_scalar",
                           "_rminus_scalar", "_div_scalar", "elemwise_sub",
                           "negative"]


def test_symbol_auto_names_and_arguments():
    sym = _fc_symbol()
    assert sym.list_arguments() == ["data", "fc_weight", "fc_bias",
                                    "softmax_label"]
    assert sym.list_outputs() == ["softmax_output"]
    with mt.sym.NameManager():
        a = mt.sym.reshape(mt.sym.Variable("x"), (2, -1))
        b = mt.sym.reshape(a, (-1,))
    assert (a.name, b.name) == ("reshape0", "reshape1")


@pytest.mark.parametrize("req", ["write", "add"])
def test_executor_grad_req(req):
    sym = _fc_symbol()
    ex = sym.simple_bind(mt.cpu(), grad_req={"fc_weight": req,
                                             "fc_bias": "null"},
                         data=(4, 5), softmax_label=(4,))
    rng = np.random.default_rng(9)
    ex.arg_dict["data"][:] = rng.standard_normal((4, 5))
    ex.arg_dict["fc_weight"][:] = rng.standard_normal((3, 5))
    ex.arg_dict["softmax_label"][:] = np.array([0, 1, 2, 1])
    assert set(ex.grad_dict) == {"fc_weight"}
    for _ in range(2):
        ex.forward(is_train=True)
        ex.backward()
    once = ex.grad_dict["fc_weight"].asnumpy() / (2 if req == "add" else 1)
    p = ex.outputs[0].asnumpy()
    onehot = np.eye(3)[[0, 1, 2, 1]]
    want = (p - onehot).T @ ex.arg_dict["data"].asnumpy()
    np.testing.assert_allclose(once, want, atol=ATOL)


def test_infer_shape_failure_names_the_node():
    x = mt.sym.Variable("x")
    bad = mt.sym.batch_dot(x, mt.sym.Variable("y"), name="bd")
    with pytest.raises(MXNetError, match="batch_dot.*'bd'"):
        bad.infer_shape(x=(2, 3, 4), y=(2, 5, 6))


def test_backward_without_training_forward_raises():
    ex = _fc_symbol().simple_bind(mt.cpu(), data=(2, 5),
                                  softmax_label=(2,))
    ex.forward(is_train=False)
    with pytest.raises(MXNetError, match="without forward"):
        ex.backward()


@pytest.mark.parametrize("how", ["bind", "simple_bind"])
def test_bind_without_context_needs_a_gpu(monkeypatch, how):
    """``ctx=None`` means ``cuda:0``: without a GPU both binds raise
    instead of running the graph on the host."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    sym = _fc_symbol()
    with pytest.raises(MXNetError, match="no CUDA device"):
        if how == "bind":
            args = {n: mt.nd.zeros(s, ctx=mt.cpu()) for n, s in zip(
                sym.list_arguments(),
                sym.infer_shape(data=(2, 5), softmax_label=(2,))[0])}
            sym.bind(None, args)
        else:
            sym.simple_bind(None, data=(2, 5), softmax_label=(2,))
