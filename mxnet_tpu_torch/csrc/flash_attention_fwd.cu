// Flash-attention forward (online softmax), float32 or bfloat16, for
// Hopper (sm_90a).
//
// Replaces the TPU kernel mxnet_tpu/ops/pallas/flash_attention.py
// `_fa_kernel` (launched by `_fa_forward`): O = softmax(scale * Q K^T) V
// over (BH, S, D) operands, causal or not, plus the per-row
// log-sum-exp lse = m + log(max(l, 1e-37)). Causal masking is
// top-aligned (q_pos >= k_pos) and uses the finite -1e30 of the TPU
// kernel; keys past Sk (the ragged edge of the last tile) are excluded
// outright.
//
// What bounds it on this card. At the serving path's prefill shapes
// (BH = 16 heads, D = 128, S up to 1024) the function does ~4 S^2 D / 2
// flops per head (causal) against 16 S D bytes of q, k, v and o: about
// 64 flops per byte at S = 1024, far above the H100's ~20 flop/byte
// float32 balance point (67 TFLOP/s over 3.35 TB/s). So it is bound by
// float32 arithmetic, and the design keeps every operand after its
// first read on chip:
//   * one thread block per (bh, 64-row q tile); a loop inside the block
//     walks the 64-key KV tiles (the TPU grid's sequential axis), so m,
//     l and the output accumulator live in registers for the whole row
//     of tiles and never touch device memory;
//   * the Q tile is read once, each K and V tile once per q tile, all
//     staged in shared memory; the P tile goes through shared memory
//     between the two products;
//   * causal KV tiles wholly above the diagonal are never loaded;
//   * rows are padded in shared memory (D + 1 floats) so that the 16
//     threads reading different keys hit 16 different banks.
// This first version issues plain FMAs (no tensor cores: a float32
// input has no exact tensor-core path, and TF32 would change the
// numbers) and no asynchronous copies; about half its shared-memory
// loads could go as float4, which is the next step for speed.
//
// bfloat16 (the training path under amp, fa_fwd_bf16): at the training
// shape (BH 128, S 1024, D 128, causal) the kernel does 34 GFLOP on
// 134 MB, ~250 flops per byte: near the bf16 tensor cores' balance
// point (989 TFLOP/s over 3.35 TB/s = 295), so both bound it. Its
// products run on the tensor cores (mma.sync m16n8k16, bf16 in, float32
// accumulate; see flash_attention_common.cuh):
//   * one block of 4 warps per (bh, 64-row q tile), each warp owning 16
//     rows; the warp's Q fragments stay in registers for the whole walk
//     over the KV tiles, and so do its m, l and the 16 x D accumulator;
//   * S = Q K^T lands in registers in the accumulator layout, which is
//     the A-operand layout of P V once rounded to bf16 (as the TPU kernel
//     rounds P to V's dtype), so P never goes through shared memory;
//   * K and V tiles are staged in shared memory as bf16 with a D + 8
//     row stride, which keeps every fragment load free of bank
//     conflicts; V's fragments are gathered from two rows each;
//   * the row max and sum reduce over the 4 threads that share a row.
// Loads are synchronous (no cp.async / TMA pipeline yet) and the product
// is mma.sync, not wgmma: the next steps for speed.
//
// C interface (bound with ctypes): every function returns a
// cudaError_t as int, 0 on success, and launches on the given stream
// without synchronising.

#include <math.h>

#include "flash_attention_common.cuh"

namespace {

using namespace fa;

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) *
         (size_t(BQ) * (D + 1) + size_t(BK) * (D + 1) + size_t(BK) * D +
          size_t(BQ) * PS);
}

template <int D>
__global__ void __launch_bounds__(THREADS)
fa_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
           const float* __restrict__ v, float* __restrict__ o,
           float* __restrict__ lse, int sq, int sk, float scale,
           int causal) {
  constexpr int DC = D / 16;   // output columns per thread
  extern __shared__ float smem[];
  float* Qs = smem;                        // BQ x (D + 1)
  float* Ks = Qs + BQ * (D + 1);           // BK x (D + 1)
  float* Vs = Ks + BK * (D + 1);           // BK x D
  float* Ps = Vs + BK * D;                 // BQ x PS

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * BQ;
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const float* qb = q + size_t(bh) * sq * D;
  const float* kb = k + size_t(bh) * sk * D;
  const float* vb = v + size_t(bh) * sk * D;

  load_tile<D>(Qs, D + 1, qb, q0, BQ, sq);

  float m[4], l[4], acc[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF_MASK;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DC; ++j) acc[i][j] = 0.f;
  }

  int n_kt = (sk + BK - 1) / BK;
  if (causal) {
    // the last real row of this q tile sees keys up to its own position
    const int last_row = min(q0 + BQ, sq) - 1;
    n_kt = min(n_kt, last_row / BK + 1);
  }

  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();   // the previous tile's K, V and P reads are done
    load_tile<D>(Ks, D + 1, kb, k0, BK, sk);
    load_tile<D>(Vs, D, vb, k0, BK, sk);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = Qs[(ty * 4 + i) * (D + 1) + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = Ks[(tx + 16 * j) * (D + 1) + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qp = q0 + ty * 4 + i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kp = k0 + tx + 16 * j;
        float x = s[i][j] * scale;
        if (kp >= sk)
          x = -INFINITY;
        else if (causal && qp < kp)
          x = NEG_INF_MASK;
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
      // the 16 threads sharing these rows are one half-warp
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        rs += p;
        Ps[(ty * 4 + i) * PS + tx + 16 * j] = p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l[i] = l[i] * alpha + rs;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < DC; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float pv[4], vv[DC];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = Ps[(ty * 4 + i) * PS + kk];
#pragma unroll
      for (int j = 0; j < DC; ++j) vv[j] = Vs[kk * D + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < DC; ++j) acc[i][j] = fmaf(pv[i], vv[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qp = q0 + ty * 4 + i;
    if (qp >= sq) continue;
    const float denom = fmaxf(l[i], 1e-37f);
    float* orow = o + (size_t(bh) * sq + qp) * D;
#pragma unroll
    for (int j = 0; j < DC; ++j) orow[tx + 16 * j] = acc[i][j] / denom;
    if (tx == 0) lse[size_t(bh) * sq + qp] = m[i] + logf(denom);
  }
}

template <int D>
int launch(const float* q, const float* k, const float* v, float* o,
           float* lse, int bh, int sq, int sk, float scale, int causal,
           cudaStream_t stream) {
  const size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      fa_fwd_f32<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      int(smem));
  if (err != cudaSuccess) return int(err);
  const dim3 grid((sq + BQ - 1) / BQ, bh);
  fa_fwd_f32<D><<<grid, THREADS, smem, stream>>>(q, k, v, o, lse, sq, sk,
                                                  scale, causal);
  return int(cudaGetLastError());
}

// ------------------------------------------------------- bfloat16, mma.sync

template <int D>
constexpr size_t smem_bytes_bf16() {
  return sizeof(__nv_bfloat16) * size_t(BQ + 2 * BK) * (D + 8);
}

template <int D>
__global__ void __launch_bounds__(MMA_THREADS)
fa_fwd_bf16(const __nv_bfloat16* __restrict__ q,
            const __nv_bfloat16* __restrict__ k,
            const __nv_bfloat16* __restrict__ v,
            __nv_bfloat16* __restrict__ o, float* __restrict__ lse, int sq,
            int sk, float scale, int causal) {
  constexpr int SX = D + 8;      // shared row stride (bf16 elements)
  constexpr int KS = D / 16;     // k-steps over the head dim
  constexpr int DN = D / 8;      // 8-column tiles of the output
  constexpr int NJ = BK / 8;     // 8-key tiles of a KV tile
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* Ks = Qs + BQ * SX;
  __nv_bfloat16* Vs = Ks + BK * SX;

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * BQ;
  const int warp = threadIdx.x / 32;
  const int g = (threadIdx.x % 32) / 4;
  const int t = threadIdx.x % 4;
  const int r0 = warp * 16;                      // the warp's rows
  const int row[2] = {q0 + r0 + g, q0 + r0 + g + 8};
  const __nv_bfloat16* kb = k + size_t(bh) * sk * D;
  const __nv_bfloat16* vb = v + size_t(bh) * sk * D;

  stage_bf16<D>(Qs, q + size_t(bh) * sq * D, q0, BQ, sq);
  __syncthreads();
  uint32_t qa[KS][4];
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) load_a<SX>(qa[kk], Qs, r0, kk * 16, g, t);

  float m[2] = {NEG_INF_MASK, NEG_INF_MASK}, l[2] = {0.f, 0.f};
  float acc[DN][4];
#pragma unroll
  for (int dn = 0; dn < DN; ++dn)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[dn][e] = 0.f;

  int n_kt = (sk + BK - 1) / BK;
  if (causal) {
    const int last_row = min(q0 + BQ, sq) - 1;
    n_kt = min(n_kt, last_row / BK + 1);
  }

  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();   // the previous tile's K and V reads are done
    stage_bf16<D>(Ks, kb, k0, BK, sk);
    stage_bf16<D>(Vs, vb, k0, BK, sk);
    __syncthreads();

    float s[NJ][4];
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        uint32_t b0, b1;
        load_b_rows<SX>(b0, b1, Ks, j * 8, kk * 16, g, t);
        mma_bf16(s[j], qa[kk], b0, b1);
      }
    }

    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kp = k0 + j * 8 + 2 * t + (e & 1);
        float x = s[j][e] * scale;
        if (kp >= sk)
          x = -INFINITY;
        else if (causal && row[e >> 1] < kp)
          x = NEG_INF_MASK;
        s[j][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    float alpha[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      // the 4 threads of a quad share a row
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      const float m_new = fmaxf(m[h], mx[h]);
      alpha[h] = expf(m[h] - m_new);
      m[h] = m_new;
      l[h] *= alpha[h];
    }
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = expf(s[j][e] - m[e >> 1]);
        s[j][e] = p;
        l[e >> 1] += p;       // this thread's share; reduced at the end
      }
#pragma unroll
    for (int dn = 0; dn < DN; ++dn) {
      acc[dn][0] *= alpha[0];
      acc[dn][1] *= alpha[0];
      acc[dn][2] *= alpha[1];
      acc[dn][3] *= alpha[1];
    }
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t pa[4];
      c_to_a(pa, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
      for (int dn = 0; dn < DN; ++dn) {
        uint32_t b0, b1;
        load_b_cols<SX>(b0, b1, Vs, kk * 16, dn * 8, g, t);
        mma_bf16(acc[dn], pa, b0, b1);
      }
    }
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
    if (row[h] >= sq) continue;
    const float denom = fmaxf(l[h], 1e-37f);
    __nv_bfloat16* orow = o + (size_t(bh) * sq + row[h]) * D;
#pragma unroll
    for (int dn = 0; dn < DN; ++dn)
      *reinterpret_cast<uint32_t*>(orow + dn * 8 + 2 * t) = pack_bf16(
          acc[dn][2 * h] / denom, acc[dn][2 * h + 1] / denom);
    if (t == 0) lse[size_t(bh) * sq + row[h]] = m[h] + logf(denom);
  }
}

template <int D>
int launch_bf16(const __nv_bfloat16* q, const __nv_bfloat16* k,
                const __nv_bfloat16* v, __nv_bfloat16* o, float* lse,
                int bh, int sq, int sk, float scale, int causal,
                cudaStream_t stream) {
  const size_t smem = smem_bytes_bf16<D>();
  cudaError_t err = cudaFuncSetAttribute(
      fa_fwd_bf16<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      int(smem));
  if (err != cudaSuccess) return int(err);
  const dim3 grid((sq + BQ - 1) / BQ, bh);
  fa_fwd_bf16<D><<<grid, MMA_THREADS, smem, stream>>>(q, k, v, o, lse, sq,
                                                      sk, scale, causal);
  return int(cudaGetLastError());
}

}  // namespace

extern "C" {

// q (bh, sq, d), k and v (bh, sk, d), o (bh, sq, d), lse (bh, sq): all
// contiguous float32 on the current device, 16-byte aligned.
// d in {16, 32, 64, 128}.
int mxt_flash_attention_fwd_f32(const void* q, const void* k, const void* v,
                                void* o, void* lse, int bh, int sq, int sk,
                                int d, float scale, int causal,
                                void* stream) {
  const float* qf = static_cast<const float*>(q);
  const float* kf = static_cast<const float*>(k);
  const float* vf = static_cast<const float*>(v);
  float* of = static_cast<float*>(o);
  float* lf = static_cast<float*>(lse);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 16: return launch<16>(qf, kf, vf, of, lf, bh, sq, sk, scale, causal, st);
    case 32: return launch<32>(qf, kf, vf, of, lf, bh, sq, sk, scale, causal, st);
    case 64: return launch<64>(qf, kf, vf, of, lf, bh, sq, sk, scale, causal, st);
    case 128: return launch<128>(qf, kf, vf, of, lf, bh, sq, sk, scale, causal, st);
    default: return int(cudaErrorInvalidValue);
  }
}

// The same for bfloat16 q, k, v and o (lse stays float32).
int mxt_flash_attention_fwd_bf16(const void* q, const void* k, const void* v,
                                 void* o, void* lse, int bh, int sq, int sk,
                                 int d, float scale, int causal,
                                 void* stream) {
  using T = __nv_bfloat16;
  const T* qb = static_cast<const T*>(q);
  const T* kb = static_cast<const T*>(k);
  const T* vb = static_cast<const T*>(v);
  T* ob = static_cast<T*>(o);
  float* lf = static_cast<float*>(lse);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 16: return launch_bf16<16>(qb, kb, vb, ob, lf, bh, sq, sk, scale, causal, st);
    case 32: return launch_bf16<32>(qb, kb, vb, ob, lf, bh, sq, sk, scale, causal, st);
    case 64: return launch_bf16<64>(qb, kb, vb, ob, lf, bh, sq, sk, scale, causal, st);
    case 128: return launch_bf16<128>(qb, kb, vb, ob, lf, bh, sq, sk, scale, causal, st);
    default: return int(cudaErrorInvalidValue);
  }
}

const char* mxt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
