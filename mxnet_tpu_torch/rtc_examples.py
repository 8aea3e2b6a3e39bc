"""Hand-written user kernels for the ``rtc`` tier: CUDA C++ sources that
``rtc`` compiles at run time for ``sm_90a``, each with its plain PyTorch
version beside it.

They replace the reference's Pallas user kernels, the instances of
``PallasKernel._build`` (``mxnet_tpu/rtc.py``, ``pl.pallas_call``):
``scale_add`` (o = 2x + y), ``relu`` and ``split`` (2x and x + 1, two
outputs) of ``tests/test_rtc.py``, and ``softmax_rows`` and
``softmax_ce_grad``, the forward (row softmax) and backward
(p − onehot(label)) of ``tests/test_custom_op.py``'s
``traced_softmax_loss`` head, which :func:`softmax_loss_prop` puts
behind a ``CustomOp`` so that a user kernel trains.

Every kernel moves each byte once and does a few operations per element,
so device memory bounds it (3.35 TB/s on an H100 SXM). The design is
the simple one that reaches for that: 16-byte ``float4`` loads and
stores where the pointers are aligned, and scalar ones otherwise.
``scale_add`` and ``relu`` take one ``float4`` per thread and as many
128-thread blocks as that needs, with no grid-stride loop, as torch's
own elementwise kernels do. In paired readings on one card
(``chip_smoke.py --pairs-of CHECKOUT rtc``) this lost less to
``torch.relu`` / ``torch.add`` than a grid-stride loop over a fixed grid
did, and less than a loop over the resident blocks with four streaming
(``__ldcs`` / ``__stcs``) ``float4`` loads in flight per thread.
``split`` keeps a grid-stride loop. The two row kernels take one block
per row: a 32000-wide row (128 KB in float32) does not fit a block's
shared memory at useful occupancy, so ``softmax_rows`` keeps a running
(max, sum) per thread in registers over one read of the row, merges them
by warp shuffles and then across warps, and reads the row a second time
to write exp(x − max) / sum (the second read mostly hits the 50 MB L2).

The plain versions are what CPU inputs run (``UserKernel(plain=)``) and
what ``chip_smoke.py`` holds each kernel against on the card; they are
never the card's path. The factories build a :class:`rtc.UserKernel`
at one shape, as the reference's ``PallasKernel`` has fixed outputs.
"""
from __future__ import annotations

import math
from typing import Sequence, Tuple

import torch

from .operator import CustomOpProp
from .rtc import UserKernel

__all__ = ["SCALE_ADD_SOURCE", "RELU_SOURCE", "SPLIT_SOURCE",
           "SOFTMAX_ROWS_SOURCE", "SOFTMAX_CE_GRAD_SOURCE", "SOURCES",
           "scale_add_plain", "relu_plain", "split_plain",
           "softmax_rows_plain", "softmax_ce_grad_plain",
           "scale_add", "relu", "split", "softmax_rows", "softmax_ce_grad",
           "softmax_loss_prop"]

_BLOCK = 256
_MAX_BLOCKS = 132 * 16      # H100 SXM: 132 SMs, grid-stride beyond this
_FLOAT4_BLOCK = 128

SCALE_ADD_SOURCE = r"""
// o = 2x + y over n floats (tests/test_rtc.py scale_add). One float4
// per thread and a grid of ceil(n / 4 / 128) blocks, no grid-stride
// loop: the block scheduler keeps every SM's loads in flight.
__device__ __forceinline__ float4 scale_add4(float4 a, float4 b) {
  return make_float4(2.0f * a.x + b.x, 2.0f * a.y + b.y,
                     2.0f * a.z + b.z, 2.0f * a.w + b.w);
}

extern "C" __global__ void __launch_bounds__(128)
scale_add(const float* __restrict__ x, const float* __restrict__ y,
          float* __restrict__ o, long long n) {
  const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if ((((unsigned long long)x | (unsigned long long)y |
        (unsigned long long)o) & 15) == 0) {
    const long long n4 = n >> 2;
    if (i < n4)
      reinterpret_cast<float4*>(o)[i] =
          scale_add4(reinterpret_cast<const float4*>(x)[i],
                     reinterpret_cast<const float4*>(y)[i]);
    const long long t = (n4 << 2) + i;      // the last n % 4 floats
    if (i < (n & 3)) o[t] = 2.0f * x[t] + y[t];
  } else {
    for (long long k = 4 * i; k < n && k < 4 * i + 4; ++k)
      o[k] = 2.0f * x[k] + y[k];
  }
}
"""

RELU_SOURCE = r"""
// max(x, 0) over n floats, NaN kept (tests/test_rtc.py relu_k). One
// float4 per thread, a grid of ceil(n / 4 / 128) blocks.
__device__ __forceinline__ float relu1(float v) { return v < 0.0f ? 0.0f : v; }
__device__ __forceinline__ float4 relu4(float4 a) {
  return make_float4(relu1(a.x), relu1(a.y), relu1(a.z), relu1(a.w));
}

extern "C" __global__ void __launch_bounds__(128)
relu(const float* __restrict__ x, float* __restrict__ o, long long n) {
  const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if ((((unsigned long long)x | (unsigned long long)o) & 15) == 0) {
    const long long n4 = n >> 2;
    if (i < n4)
      reinterpret_cast<float4*>(o)[i] =
          relu4(reinterpret_cast<const float4*>(x)[i]);
    const long long t = (n4 << 2) + i;      // the last n % 4 floats
    if (i < (n & 3)) o[t] = relu1(x[t]);
  } else {
    for (long long k = 4 * i; k < n && k < 4 * i + 4; ++k)
      o[k] = relu1(x[k]);
  }
}
"""

SPLIT_SOURCE = r"""
// Two outputs over n floats: a = 2x, b = x + 1 (tests/test_rtc.py split_k).
extern "C" __global__ void split(const float* __restrict__ x,
                                 float* __restrict__ a,
                                 float* __restrict__ b, long long n) {
  const long long start = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  const long long stride = (long long)gridDim.x * blockDim.x;
  long long done = 0;
  if ((((unsigned long long)x | (unsigned long long)a |
        (unsigned long long)b) & 15) == 0) {
    const float4* x4 = reinterpret_cast<const float4*>(x);
    float4* a4 = reinterpret_cast<float4*>(a);
    float4* b4 = reinterpret_cast<float4*>(b);
    const long long n4 = n >> 2;
    for (long long i = start; i < n4; i += stride) {
      const float4 v = x4[i];
      a4[i] = make_float4(2.0f * v.x, 2.0f * v.y, 2.0f * v.z, 2.0f * v.w);
      b4[i] = make_float4(v.x + 1.0f, v.y + 1.0f, v.z + 1.0f, v.w + 1.0f);
    }
    done = n4 << 2;
  }
  for (long long i = done + start; i < n; i += stride) {
    a[i] = 2.0f * x[i];
    b[i] = x[i] + 1.0f;
  }
}
"""

SOFTMAX_ROWS_SOURCE = r"""
#include <math.h>

// Row softmax of a (rows, cols) float matrix, one block per row
// (tests/test_custom_op.py traced_softmax_loss forward). blockDim.x is a
// multiple of 32, at most 1024.
__device__ __forceinline__ void push(float& m, float& s, float v) {
  if (v > m) {                       // a new running max: rescale the sum
    s = s * expf(m - v) + 1.0f;
    m = v;
  } else if (v != -INFINITY) {       // NaN falls here and poisons s
    s += expf(v - m);
  }
}

__device__ __forceinline__ void merge(float& m, float& s, float m2, float s2) {
  if (m2 == -INFINITY) return;
  if (m == -INFINITY) { m = m2; s = s2; return; }
  const float mx = fmaxf(m, m2);
  s = s * expf(m - mx) + s2 * expf(m2 - mx);
  m = mx;
}

extern "C" __global__ void softmax_rows(const float* __restrict__ x,
                                        float* __restrict__ y,
                                        int rows, int cols) {
  __shared__ float warp_m[32], warp_s[32];
  const long long row = blockIdx.x;
  const float* xr = x + row * cols;
  float* yr = y + row * cols;
  const bool vec = (cols & 3) == 0 &&
      (((unsigned long long)x | (unsigned long long)y) & 15) == 0;
  // 1. one read: each thread's running (max, sum of exp(v - max))
  float m = -INFINITY, s = 0.0f;
  if (vec) {
    const float4* x4 = reinterpret_cast<const float4*>(xr);
    for (int i = threadIdx.x; i < (cols >> 2); i += blockDim.x) {
      const float4 v = x4[i];
      push(m, s, v.x); push(m, s, v.y); push(m, s, v.z); push(m, s, v.w);
    }
  } else {
    for (int i = threadIdx.x; i < cols; i += blockDim.x) push(m, s, xr[i]);
  }
  // 2. merge: across the warp by shuffles, then across the warps
  for (int off = 16; off > 0; off >>= 1)
    merge(m, s, __shfl_xor_sync(0xffffffffu, m, off),
          __shfl_xor_sync(0xffffffffu, s, off));
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) { warp_m[warp] = m; warp_s[warp] = s; }
  __syncthreads();
  if (warp == 0) {
    const int warps = blockDim.x >> 5;
    m = lane < warps ? warp_m[lane] : -INFINITY;
    s = lane < warps ? warp_s[lane] : 0.0f;
    for (int off = 16; off > 0; off >>= 1)
      merge(m, s, __shfl_xor_sync(0xffffffffu, m, off),
            __shfl_xor_sync(0xffffffffu, s, off));
    if (lane == 0) { warp_m[0] = m; warp_s[0] = s; }
  }
  __syncthreads();
  const float mx = warp_m[0], sum = warp_s[0];
  // 3. a second read writes exp(v - max) / sum
  if (vec) {
    const float4* x4 = reinterpret_cast<const float4*>(xr);
    float4* y4 = reinterpret_cast<float4*>(yr);
    for (int i = threadIdx.x; i < (cols >> 2); i += blockDim.x) {
      const float4 v = x4[i];
      y4[i] = make_float4(expf(v.x - mx) / sum, expf(v.y - mx) / sum,
                          expf(v.z - mx) / sum, expf(v.w - mx) / sum);
    }
  } else {
    for (int i = threadIdx.x; i < cols; i += blockDim.x)
      yr[i] = expf(xr[i] - mx) / sum;
  }
}
"""

SOFTMAX_CE_GRAD_SOURCE = r"""
// g = p - onehot(label) for (rows, cols) probabilities and float labels,
// one block per row (tests/test_custom_op.py traced_softmax_loss
// backward). A label is truncated to int, as astype(int32); one outside
// [0, cols) has no one-hot.
extern "C" __global__ void softmax_ce_grad(const float* __restrict__ p,
                                           const float* __restrict__ label,
                                           float* __restrict__ g,
                                           int rows, int cols) {
  const long long row = blockIdx.x;
  const int l = (int)label[row];
  const float* pr = p + row * cols;
  float* gr = g + row * cols;
  if ((cols & 3) == 0 &&
      (((unsigned long long)p | (unsigned long long)g) & 15) == 0) {
    const float4* p4 = reinterpret_cast<const float4*>(pr);
    float4* g4 = reinterpret_cast<float4*>(gr);
    for (int i = threadIdx.x; i < (cols >> 2); i += blockDim.x) {
      const int c = i << 2;
      const float4 v = p4[i];
      g4[i] = make_float4(v.x - (c == l ? 1.0f : 0.0f),
                          v.y - (c + 1 == l ? 1.0f : 0.0f),
                          v.z - (c + 2 == l ? 1.0f : 0.0f),
                          v.w - (c + 3 == l ? 1.0f : 0.0f));
    }
  } else {
    for (int i = threadIdx.x; i < cols; i += blockDim.x)
      gr[i] = pr[i] - (i == l ? 1.0f : 0.0f);
  }
}
"""

SOURCES = {"scale_add": SCALE_ADD_SOURCE, "relu": RELU_SOURCE,
           "split": SPLIT_SOURCE, "softmax_rows": SOFTMAX_ROWS_SOURCE,
           "softmax_ce_grad": SOFTMAX_CE_GRAD_SOURCE}


# ------------------------------------------------------------ plain versions

def scale_add_plain(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return x * 2.0 + y


def relu_plain(x: torch.Tensor) -> torch.Tensor:
    return torch.where(x < 0, torch.zeros_like(x), x)


def split_plain(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    return x * 2.0, x + 1.0


def softmax_rows_plain(x: torch.Tensor) -> torch.Tensor:
    e = torch.exp(x - x.amax(dim=1, keepdim=True))
    return e / e.sum(dim=1, keepdim=True)


def softmax_ce_grad_plain(p: torch.Tensor, label: torch.Tensor
                          ) -> torch.Tensor:
    cols = torch.arange(p.shape[1], device=p.device)
    onehot = cols[None, :] == label.to(torch.int64)[:, None]
    return p - onehot.to(p.dtype)


# ------------------------------------------------------------ factories

def _expect(expected: Sequence[tuple], scalars: tuple):
    """The kernel's scalar arguments, after checking that the inputs
    have the shapes the kernel was built for (it would read past them
    otherwise)."""
    def resolve(*shapes):
        if list(shapes) != [tuple(s) for s in expected]:
            raise ValueError("kernel built for inputs %s, called on %s"
                             % (list(expected), list(shapes)))
        return scalars
    return resolve


def _elementwise_grid(n: int) -> tuple:
    return (max(1, min(math.ceil(n / (4 * _BLOCK)), _MAX_BLOCKS)),)


def _float4_grid(n: int) -> tuple:
    """One float4 per thread of a ``_FLOAT4_BLOCK``-thread block."""
    return (max(1, math.ceil(math.ceil(n / 4) / _FLOAT4_BLOCK)),)


def scale_add(shape) -> UserKernel:
    """o = 2x + y for float32 x, y of ``shape``."""
    shape = tuple(shape)
    n = math.prod(shape)
    return UserKernel(
        SCALE_ADD_SOURCE, "scale_add",
        "const float* x, const float* y, float* o, long long n",
        (shape, torch.float32), grid=_float4_grid(n),
        block=(_FLOAT4_BLOCK,), plain=scale_add_plain,
        scalars=_expect([shape, shape], (n,)))


def relu(shape) -> UserKernel:
    """max(x, 0) for float32 x of ``shape``."""
    shape = tuple(shape)
    n = math.prod(shape)
    return UserKernel(
        RELU_SOURCE, "relu", "const float* x, float* o, long long n",
        (shape, torch.float32), grid=_float4_grid(n),
        block=(_FLOAT4_BLOCK,), plain=relu_plain,
        scalars=_expect([shape], (n,)))


def split(shape) -> UserKernel:
    """(2x, x + 1), two outputs, for float32 x of ``shape``."""
    shape = tuple(shape)
    n = math.prod(shape)
    return UserKernel(
        SPLIT_SOURCE, "split",
        "const float* x, float* a, float* b, long long n",
        [(shape, torch.float32), (shape, torch.float32)],
        grid=_elementwise_grid(n), block=(_BLOCK,), plain=split_plain,
        scalars=_expect([shape], (n,)))


def softmax_rows(rows: int, cols: int) -> UserKernel:
    """Row softmax of a float32 (rows, cols) matrix."""
    return UserKernel(
        SOFTMAX_ROWS_SOURCE, "softmax_rows",
        "const float* x, float* y, int rows, int cols",
        ((rows, cols), torch.float32), grid=(rows,), block=(_BLOCK,),
        plain=softmax_rows_plain,
        scalars=_expect([(rows, cols)], (rows, cols)))


def softmax_ce_grad(rows: int, cols: int) -> UserKernel:
    """p − onehot(label) for float32 (rows, cols) p and (rows,) float32
    labels."""
    return UserKernel(
        SOFTMAX_CE_GRAD_SOURCE, "softmax_ce_grad",
        "const float* p, const float* label, float* g, int rows, int cols",
        ((rows, cols), torch.float32), grid=(rows,), block=(_BLOCK,),
        plain=softmax_ce_grad_plain,
        scalars=_expect([(rows, cols), (rows,)], (rows, cols)))


def softmax_loss_prop(forward: UserKernel, backward: UserKernel) -> type:
    """A :class:`CustomOpProp` with ``traced_softmax_loss`` semantics
    (``tests/test_custom_op.py``) on two user kernels: inputs ``data``
    and ``label``, output softmax(data) by ``forward``
    (:func:`softmax_rows`), and as its gradient ``backward``'s p −
    onehot(label) (:func:`softmax_ce_grad`), ignoring the head gradient
    (``need_top_grad=False``). Register it under a name of your choice:
    ``mt.operator.register("my_loss")(softmax_loss_prop(f, b))``."""

    class SoftmaxLossProp(CustomOpProp):
        def __init__(self):
            super().__init__(need_top_grad=False)

        def list_arguments(self):
            return ["data", "label"]

        def infer_shape(self, in_shape):
            return [in_shape[0], [in_shape[0][0]]], [in_shape[0]], []

        def forward_traced(self, in_data, is_train):
            return (forward.run([in_data[0]]),)

        def backward_traced(self, out_grad, in_data, out_data):
            label = in_data[1]
            return (backward.run([out_data[0], label]),
                    torch.zeros_like(label))

    return SoftmaxLossProp
