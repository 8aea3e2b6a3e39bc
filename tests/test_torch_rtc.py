"""The port's user-kernel tier (``mxnet_tpu_torch.rtc``) against the
reference's (``mxnet_tpu.rtc.PallasKernel``), the ``nd`` namespace and
the default-device rules, on the CPU.

The reference's three Pallas kernels of ``tests/test_rtc.py`` run in
interpret mode; the port's ``UserKernel``s of the same functions
(``rtc_examples``) run their plain PyTorch versions, which is what CPU
inputs take. Inputs are drawn with numpy (seeds in each test); outputs
agree to rtol 1e-6 (the same single f32 rounding on both sides). The
CUDA kernels themselves build and run only on the card, where
``chip_smoke.py`` holds them against the same plain versions; here the
pieces around them (signature parsing, argument packing, out_shape
rules, registration, multi-output symbols) are checked without a GPU.
"""
import ctypes

import numpy as np
import pytest
import torch

import mxnet_tpu as mx
import mxnet_tpu_torch as mt
from mxnet_tpu_torch import _build, rtc, rtc_examples
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.models import transformer as port_transformer

# test files run side by side in parallel workers: each keeps torch's
# intra-op pool small
torch.set_num_threads(2)

RTOL = 1e-6


# --------------------------------------------------- reference Pallas kernels

def _scale_add_k(x_ref, y_ref, o_ref):
    o_ref[:] = x_ref[:] * 2.0 + y_ref[:]


def _relu_k(x_ref, o_ref):
    import jax.numpy as jnp
    o_ref[:] = jnp.maximum(x_ref[:], 0.0)


def _split_k(x_ref, a_ref, b_ref):
    a_ref[:] = x_ref[:] * 2.0
    b_ref[:] = x_ref[:] + 1.0


def _pallas(fn, out_shape):
    return mx.rtc.PallasKernel(fn, out_shape, interpret=True)


CASES = {
    # name: (Pallas kernel, its out_shape, port factory, input shapes, seed)
    "scale_add": (_scale_add_k, ((8, 128), np.float32),
                  rtc_examples.scale_add, [(8, 128), (8, 128)], 0),
    "relu": (_relu_k, ((4, 128), np.float32), rtc_examples.relu,
             [(4, 128)], 1),
    "split": (_split_k, [((4, 128), np.float32), ((4, 128), np.float32)],
              rtc_examples.split, [(4, 128)], 8),
}


def _inputs(shapes, seed):
    rng = np.random.RandomState(seed)
    return [rng.randn(*s).astype(np.float32) for s in shapes]


@pytest.mark.parametrize("name", sorted(CASES))
def test_user_kernel_matches_pallas_kernel(name):
    kernel_fn, out_shape, factory, shapes, seed = CASES[name]
    xs = _inputs(shapes, seed)
    want = _pallas(kernel_fn, out_shape)(*[mx.nd.array(x) for x in xs])
    got = factory(shapes[0])(*[mt.nd.array(x, ctx=mt.cpu()) for x in xs])
    want = want if isinstance(want, tuple) else (want,)
    got = got if isinstance(got, tuple) else (got,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.context == torch.device("cpu")
        np.testing.assert_allclose(g.asnumpy(), w.asnumpy(), rtol=RTOL)


def test_registered_kernel_appears_in_nd_and_sym_after_import():
    assert not hasattr(mt.nd, "torch_rtc_late_relu")
    assert not hasattr(mt.sym, "torch_rtc_late_relu")
    rtc_examples.relu((4, 128)).register("torch_rtc_late_relu")
    x = _inputs([(4, 128)], 1)[0]
    want = _pallas(_relu_k, ((4, 128), np.float32))(mx.nd.array(x))
    got = mt.nd.torch_rtc_late_relu(mt.nd.array(x, ctx=mt.cpu()))
    np.testing.assert_allclose(got.asnumpy(), want.asnumpy(), rtol=RTOL)
    s = mt.sym.torch_rtc_late_relu(mt.sym.Variable("data"))
    assert s.infer_shape(data=(4, 128))[1] == [(4, 128)]
    ex = s.simple_bind(ctx=mt.cpu(), data=(4, 128))
    ex.arg_dict["data"][:] = x
    np.testing.assert_allclose(ex.forward()[0].asnumpy(), want.asnumpy(),
                               rtol=RTOL)


def test_two_output_symbol_lists_and_returns_both():
    rtc_examples.split((4, 128)).register("torch_rtc_split")
    x = _inputs([(4, 128)], 8)[0]
    a, b = _pallas(_split_k, CASES["split"][1])(mx.nd.array(x))
    s = mt.sym.torch_rtc_split(mt.sym.Variable("data"), name="sp")
    assert s.list_outputs() == ["sp_output", "sp_output1"]
    # the reference names a two-output node's outputs the same way
    mx.rtc.PallasKernel(_split_k, CASES["split"][1],
                        interpret=True).register("torch_parity_split")
    js = mx.sym.torch_parity_split(mx.sym.Variable("data"), name="sp")
    assert js.list_outputs() == s.list_outputs()
    ex = s.simple_bind(ctx=mt.cpu(), data=(4, 128))
    ex.arg_dict["data"][:] = x
    outs = ex.forward()
    assert len(outs) == 2
    np.testing.assert_allclose(outs[0].asnumpy(), a.asnumpy(), rtol=RTOL)
    np.testing.assert_allclose(outs[1].asnumpy(), b.asnumpy(), rtol=RTOL)
    # one output picked by position or name feeds another op; JSON keeps
    # every head
    assert s[1].list_outputs() == ["sp_output1"]
    assert s["sp_output1"].list_outputs() == ["sp_output1"]
    y = mt.sym.Activation(s[1], act_type="relu")
    ex = y.simple_bind(ctx=mt.cpu(), data=(4, 128))
    ex.arg_dict["data"][:] = x
    np.testing.assert_allclose(ex.forward()[0].asnumpy(),
                               np.maximum(b.asnumpy(), 0), rtol=RTOL)
    assert mt.sym.load_json(s.tojson()).list_outputs() == s.list_outputs()
    with pytest.raises(MXNetError, match="single-output"):
        mt.sym.Activation(s, act_type="relu")


@pytest.mark.parametrize("out_shape", [
    ((8, 128), np.float32),
    [((4, 128), np.float32), ((4, 128), np.float32), ((2,), np.int32)],
    # a pair whose second item is a sequence is a list of two outputs
    [((4,), np.float32), ((8, 2), np.float32)],
], ids=["pair", "list", "pair-of-pairs"])
def test_out_shape_parsing_matches_pallas_kernel(out_shape):
    pk = _pallas(_relu_k, out_shape)
    outs, multi = rtc.parse_out_shape(out_shape)
    assert multi == pk._multi
    want = pk._out_shape if pk._multi else [pk._out_shape]
    assert [(s, np.dtype(str(d).replace("torch.", ""))) for s, d in outs] \
        == [(tuple(w.shape), np.dtype(w.dtype)) for w in want]


def test_cpu_call_without_plain_raises():
    kern = rtc.UserKernel(rtc_examples.RELU_SOURCE, "relu",
                          "const float* x, float* o, long long n",
                          ((4, 128), np.float32), grid=(1,), block=(256,),
                          scalars=(512,))
    with pytest.raises(MXNetError, match="plain"):
        kern(mt.nd.zeros((4, 128), ctx=mt.cpu()))
    assert kern.launches == 0


def test_plain_version_is_held_to_out_shape():
    kern = rtc.UserKernel(rtc_examples.RELU_SOURCE, "relu",
                          "const float* x, float* o, long long n",
                          ((4, 128), np.float32), grid=(1,), block=(256,),
                          plain=lambda x: x[:2], scalars=(512,))
    with pytest.raises(MXNetError, match="out_shape"):
        kern(torch.zeros(4, 128))


@pytest.mark.parametrize("signature,want", [
    ("const float*, float *, int",
     [("float", True, True, None, torch.float32),
      ("float", True, False, None, torch.float32),
      ("int", False, False, None, torch.int32)]),
    ("const float *__restrict__ p, const float *label, float *g, "
     "int rows, unsigned int cols",
     [("float", True, True, "p", torch.float32),
      ("float", True, True, "label", torch.float32),
      ("float", True, False, "g", torch.float32),
      ("int", False, False, "rows", torch.int32),
      ("unsigned int", False, False, "cols", None)]),
    ("const __nv_bfloat16* a, long long n, double s, void* any",
     [("__nv_bfloat16", True, True, "a", torch.bfloat16),
      ("long long", False, False, "n", torch.int64),
      ("double", False, False, "s", torch.float64),
      ("void", True, False, "any", None)]),
], ids=["unnamed", "named", "types"])
def test_signature_parsing(signature, want):
    got = [(p.ctype, p.pointer, p.const, p.name, p.dtype)
           for p in rtc.parse_signature(signature)]
    assert got == want


@pytest.mark.parametrize("signature,match", [
    ("const float** x", "pointer to a pointer"),
    ("float4* x", "unknown type"),
    ("__half h", "scalar cannot be passed"),
])
def test_signature_parsing_rejects(signature, match):
    with pytest.raises(MXNetError, match=match):
        rtc.parse_signature(signature)


def test_pack_args_builds_the_void_pointer_array():
    params = rtc.parse_signature("const float* x, float* y, int n, "
                                 "float alpha, long long big")
    x = torch.arange(6, dtype=torch.float32)
    y = mt.nd.zeros((6,), ctx=mt.cpu())
    values, void_pp = rtc.pack_args(
        params, [x, y, np.int64(6), 0.5, 2 ** 40], torch.device("cpu"))
    assert len(void_pp) == 5

    def read(i, ctype):
        return ctypes.cast(void_pp[i], ctypes.POINTER(ctype)).contents.value

    assert read(0, ctypes.c_void_p) == x.data_ptr()
    assert read(1, ctypes.c_void_p) == y.data.data_ptr()
    assert read(2, ctypes.c_int) == 6
    assert read(3, ctypes.c_float) == 0.5
    assert read(4, ctypes.c_longlong) == 2 ** 40


@pytest.mark.parametrize("args,match", [
    ([torch.zeros(4, dtype=torch.float64), torch.zeros(4), 4], "takes torch"),
    ([torch.zeros(4, 2).t(), torch.zeros(4), 4], "contiguous"),
    ([torch.zeros(4), torch.zeros(4), torch.zeros(1)], "Python number"),
    ([torch.zeros(4), torch.zeros(4), 2 ** 40], "does not fit"),
    ([torch.zeros(4), torch.zeros(4), 1.5], "integer"),
    ([torch.zeros(4), torch.zeros(4)], "takes 3 arguments"),
    ([torch.zeros(4), 3, 4], "takes a tensor"),
])
def test_pack_args_rejects(args, match):
    params = rtc.parse_signature("const float* x, float* y, int n")
    with pytest.raises(MXNetError, match=match):
        rtc.pack_args(params, args, torch.device("cpu"))


def test_pack_args_rejects_a_tensor_on_another_device():
    params = rtc.parse_signature("float* x")
    with pytest.raises(MXNetError, match="lies on cpu"):
        rtc.pack_args(params, [torch.zeros(4)], torch.device("cuda", 0))


def test_cuda_module_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    source = "extern \"C\" __global__ void k_%d() {}" % id(tmp_path)
    with pytest.raises(MXNetError, match="nvcc not found"):
        rtc.CudaModule(source)
    assert not _build.cubin_path(source).exists()


class _FakeDriver:
    """Stands in for libcuda: every call fails with one CUresult."""

    def __init__(self, code, message):
        self.code, self.message = code, message

    def cuGetErrorString(self, code, ref):
        ref._obj.value = self.message
        return 0

    def __getattr__(self, name):
        return lambda *args: self.code


def test_driver_errors_raise_with_the_drivers_message(monkeypatch):
    from mxnet_tpu_torch import _cuda_driver
    monkeypatch.setattr(_cuda_driver, "_lib",
                        _FakeDriver(101, b"invalid device ordinal"))
    monkeypatch.setattr(_cuda_driver, "_primary", {})
    # raised from inside make_current's locked section, without deadlock
    with pytest.raises(MXNetError, match=r"cuDeviceGet\(7\) failed: invalid "
                       r"device ordinal \(CUresult 101\)"):
        _cuda_driver.make_current(7)
    with pytest.raises(MXNetError, match=r"cuLaunchKernel failed"):
        _cuda_driver.launch(1, (1, 1, 1), (32, 1, 1), 0, 0, None)
    monkeypatch.setattr(_cuda_driver, "_lib", _FakeDriver(500, b"not found"))
    with pytest.raises(MXNetError, match="extern \"C\""):
        _cuda_driver.get_function(1, "missing")


def test_kernel_launch_needs_a_cuda_device():
    kern = rtc.CudaKernel(None, "relu", "const float* x, float* o, long long n")
    with pytest.raises(MXNetError, match="CUDA device"):
        kern.launch([torch.zeros(4), torch.zeros(4), 4], "cpu", (1,), (32,))


def test_user_kernel_checks_inputs():
    kern = rtc_examples.scale_add((4, 8))
    with pytest.raises(MXNetError, match="takes 2 tensors"):
        kern(torch.zeros(4, 8))
    with pytest.raises(MXNetError, match="unsupported device"):
        kern(torch.zeros(4, 8, device="meta"), torch.zeros(4, 8,
                                                           device="meta"))
    with pytest.raises(MXNetError, match="at least one input"):
        rtc.UserKernel("", "k", "float* o", ((4,), np.float32), (1,), (32,))


# ----------------------------------------------------------- nd namespace

def test_every_registered_op_has_an_nd_function():
    from mxnet_tpu_torch.ops import OP_REGISTRY
    for name in OP_REGISTRY:
        assert callable(getattr(mt.nd, name)), name
    assert "FullyConnected" in dir(mt.nd)


@pytest.mark.parametrize("op,attrs,shapes", [
    ("FullyConnected", {"num_hidden": 5}, [(3, 4), (5, 4), (5,)]),
    ("softmax", {"axis": -1}, [(3, 7)]),
    ("Activation", {"act_type": "tanh"}, [(2, 3)]),
    ("broadcast_add", {}, [(2, 3), (1, 3)]),
    ("transpose", {"axes": (1, 0)}, [(2, 3)]),
])
def test_nd_op_matches_reference(op, attrs, shapes):
    xs = _inputs(shapes, 5)
    want = getattr(mx.nd, op)(*[mx.nd.array(x) for x in xs], **attrs)
    got = getattr(mt.nd, op)(*[mt.nd.array(x, ctx=mt.cpu()) for x in xs],
                             **attrs)
    assert isinstance(got, mt.nd.NDArray)
    np.testing.assert_allclose(got.asnumpy(), want.asnumpy(), rtol=1e-5,
                               atol=1e-6)


def test_nd_op_without_inputs_follows_ctx_and_out():
    got = mt.nd.arange(0, 5, ctx=mt.cpu())
    np.testing.assert_array_equal(got.asnumpy(), np.arange(5))
    with mt.device_scope("cpu"):
        dst = mt.nd.zeros((2, 3))
        res = mt.nd.Activation(mt.nd.array(-np.ones((2, 3))),
                               act_type="relu", out=dst)
    assert res is dst
    np.testing.assert_array_equal(dst.asnumpy(), np.zeros((2, 3)))


def test_contrib_namespaces_resolve_contrib_ops():
    rng = np.random.RandomState(3)
    q = rng.randn(1, 2, 16, 16).astype(np.float32)
    with mt.device_scope("cpu"):
        got = mt.contrib.nd.FlashAttention(mt.nd.array(q), mt.nd.array(q),
                                           mt.nd.array(q), causal=True)
        same = mt.nd.contrib.FlashAttention(mt.nd.array(q), mt.nd.array(q),
                                            mt.nd.array(q), causal=True)
    want = mx.contrib.nd.FlashAttention(mx.nd.array(q), mx.nd.array(q),
                                        mx.nd.array(q), causal=True)
    np.testing.assert_allclose(got.asnumpy(), want.asnumpy(), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_array_equal(same.asnumpy(), got.asnumpy())
    s = mt.contrib.sym.FlashAttention(mt.sym.Variable("q"),
                                      mt.sym.Variable("k"),
                                      mt.sym.Variable("v"))
    assert s.list_arguments() == ["q", "k", "v"]
    assert "FlashAttention" in dir(mt.contrib.nd)
    with pytest.raises(AttributeError, match="_contrib_NoSuchOp"):
        mt.contrib.nd.NoSuchOp


def test_ndarray_arithmetic():
    with mt.device_scope("cpu"):
        a = mt.nd.array([[1.0, 2.0]])
        b = mt.nd.array([[3.0, 5.0]])
    np.testing.assert_array_equal(((a + b) * 2 - 1).asnumpy(), [[7, 13]])
    np.testing.assert_array_equal((1 - a / b).asnumpy(),
                                  1 - np.float32([[1, 2]]) / np.float32([[3, 5]]))
    np.testing.assert_array_equal((-a + [[1, 1]]).asnumpy(), [[0, -1]])


def test_asnumpy_is_a_copy():
    a = mt.nd.array([1.0, 2.0], ctx=mt.cpu())
    a.asnumpy()[0] = 9.0
    assert a.asnumpy()[0] == 1.0


# ------------------------------------------------------ default placement

def test_array_without_ctx_or_gpu_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(MXNetError, match="no CUDA device"):
        mt.nd.array(np.ones(3))
    with pytest.raises(MXNetError, match="no CUDA device"):
        mt.nd.zeros((2,))
    with pytest.raises(MXNetError, match="no CUDA device"):
        mt.nd.NDArray(np.ones(3))
    with pytest.raises(MXNetError, match="no CUDA device"):
        mt.current_device()


def test_device_scope_places_arrays_and_nests(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with mt.device_scope("cpu") as dev:
        assert dev == torch.device("cpu")
        assert mt.current_device() == torch.device("cpu")
        assert mt.nd.array(np.ones(3)).context == torch.device("cpu")
        assert mt.nd.zeros((2,)).context == torch.device("cpu")
        with mt.device_scope(mt.cpu()):
            assert mt.nd.array([1]).context == torch.device("cpu")
        # the scope is the default of the other entry points too
        mod = mt.mod.Module(port_transformer.get_symbol(
            vocab_size=16, num_layers=1, d_model=8, n_heads=2, seq_len=4))
        assert mod._device == torch.device("cpu")
    with pytest.raises(MXNetError, match="no CUDA device"):
        mt.nd.array(np.ones(3))
    with pytest.raises(MXNetError, match="no CUDA device"):
        with mt.device_scope(mt.gpu(0)):
            pass


def test_an_array_over_a_tensor_keeps_its_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    t = torch.ones(3)
    assert mt.nd.NDArray(t).data is t
    assert mt.nd.array(t).context == torch.device("cpu")


def test_iterator_batches_and_initializer_staging_stay_on_the_host(
        monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    x = np.arange(12, dtype=np.float32).reshape(6, 2)
    it = mt.io.NDArrayIter(x, np.arange(6, dtype=np.float32), batch_size=4)
    batches = list(it)
    assert [b.pad for b in batches] == [0, 2]
    for b in batches:
        assert b.data[0].context == torch.device("cpu")
        assert b.label[0].context == torch.device("cpu")
    arr = mt.nd.zeros((3, 4), ctx=mt.cpu())
    for init in (mt.init.Xavier(), mt.init.Xavier(rnd_type="gaussian"),
                 mt.init.Uniform(0.1)):
        init.set_rng(np.random.default_rng(0))(
            mt.init.InitDesc("fc_weight"), arr)
        assert arr.context == torch.device("cpu")
        assert np.abs(arr.asnumpy()).max() > 0
