// Flash-attention backward: dQ, and dK with dV, float32 or bfloat16 in,
// for Hopper (sm_90a).
//
// Replaces the TPU kernels of mxnet_tpu/ops/pallas/flash_attention.py
// launched by `_fa_backward`:
//   * `_fa_bwd_dq_kernel`  -> fa_bwd_dq_*:  dQ = sum over KV tiles of dS K
//   * `_fa_bwd_dkv_kernel` -> fa_bwd_dkv_*: dV = sum over q tiles of P^T dO,
//                                           dK = sum over q tiles of dS^T Q
// with P = exp(scale * Q K^T - lse) rebuilt from the forward's saved
// per-row log-sum-exp (exact: lse is the final softmax statistic, so no
// online rescale is needed), dS = P * (dO V^T - delta) * scale and
// delta = rowsum(dO * O), which the wrapper computes. Masking is the
// forward's: causal top-aligned (q_pos >= k_pos) with the finite -1e30,
// keys past Sk and queries past S excluded outright (the ragged edges of
// the last tiles).
//
// What bounds them on this card. Per live (q, k) pair the dQ kernel does
// three D-long dot products (S, dP, dQ) and the dK/dV kernel four (S, dP,
// dV, dK): at the training shape (BH 128, S 1024, D 128, causal, bf16)
// about 52 and 69 GFLOP against ~170 and ~200 MB of operands, some 300
// and 340 flops per byte: at the bf16 tensor cores' balance point (989
// TFLOP/s over 3.35 TB/s = 295) and far above float32 FMA's (20). Both
// variants keep every operand after its first read on chip and run no
// atomics:
//   * the TPU grid's sequential axis becomes a loop inside the block.
//     dQ: one block per (bh, 64-row q tile) walks the KV tiles and keeps
//     its dQ accumulator in registers. dK/dV: one block per (bh, 64-key
//     tile) walks the q tiles and keeps dK and dV in registers. Every
//     output tile has one owner, as on the TPU's KV-major grid, so no
//     block adds into another's output;
//   * Q, dO (dQ) or K, V (dK/dV) stay in shared memory for the whole
//     walk; the other pair is staged once per tile;
//   * causal tiles wholly above the diagonal are never loaded.
//
// float32 (fa_bwd_dq_f32, fa_bwd_dkv_f32): plain FMAs, as in the float32
// forward kernel. 16 x 16 threads, each owning 4 rows x 4 (then D / 16)
// columns of the tile products; rows are padded in shared memory (D + 1
// floats) so that 16 threads reading 16 different rows hit 16 banks; the
// P / dS tiles go through shared memory with row stride BK + 4, so the
// two half-warps' rows land 16 banks apart.
//
// bfloat16 (the training path under amp: fa_bwd_dq_bf16, fa_bwd_dkv_bf16):
// every product runs on the tensor cores (mma.sync m16n8k16, bf16 in,
// float32 accumulate; see flash_attention_common.cuh). 4 warps per block,
// each owning 16 rows (q rows for dQ, keys for dK/dV). S and dP land in
// registers in the accumulator layout; P and dS are rounded to bf16 (as
// the TPU kernels round them to the operands' dtype) and reused in
// registers as the A operand of the next product (dS K for dQ; P^T dO and
// dS^T Q for dK/dV, computed in the transposed orientation S^T = K Q^T so
// the key rows stay with their warp). dK/dV walks q tiles of 32 rows, to
// keep its two 16 x D accumulators and the tile products in registers.
// Loads are synchronous (no cp.async / TMA pipeline) and the product is
// mma.sync, not wgmma: the next steps for speed.
//
// C interface (bound with ctypes): every function returns a cudaError_t
// as int, 0 on success, and launches on the given stream without
// synchronising.

#include <math.h>

#include "flash_attention_common.cuh"

namespace {

using namespace fa;

template <int D>
constexpr size_t dq_smem_bytes() {
  return sizeof(float) * (size_t(2 * BQ + 2 * BK) * (D + 1) +
                          size_t(BQ) * PS);
}

template <int D>
constexpr size_t dkv_smem_bytes() {
  return sizeof(float) * (size_t(2 * BK + 2 * BQ) * (D + 1) +
                          size_t(2 * BK) * PS + 2 * BQ);
}

// dQ: one block per (bh, q tile); KV tiles walked in a loop.
template <int D>
__global__ void __launch_bounds__(THREADS)
fa_bwd_dq_f32(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, const float* __restrict__ dout,
              const float* __restrict__ lse, const float* __restrict__ delta,
              float* __restrict__ dq, int sq, int sk, float scale,
              int causal) {
  constexpr int DC = D / 16;   // output columns per thread
  constexpr int RS = D + 1;
  extern __shared__ float smem[];
  float* Qs = smem;                  // BQ x RS
  float* dOs = Qs + BQ * RS;         // BQ x RS
  float* Ks = dOs + BQ * RS;         // BK x RS
  float* Vs = Ks + BK * RS;          // BK x RS
  float* dSs = Vs + BK * RS;         // BQ x PS

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * BQ;
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const float* qb = q + size_t(bh) * sq * D;
  const float* dob = dout + size_t(bh) * sq * D;
  const float* kb = k + size_t(bh) * sk * D;
  const float* vb = v + size_t(bh) * sk * D;

  load_tile<D>(Qs, RS, qb, q0, BQ, sq);
  load_tile<D>(dOs, RS, dob, q0, BQ, sq);

  // rows past S: lse = +inf makes their P exactly 0
  float lse_r[4], delta_r[4], acc[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qp = q0 + ty * 4 + i;
    lse_r[i] = qp < sq ? lse[size_t(bh) * sq + qp] : INFINITY;
    delta_r[i] = qp < sq ? delta[size_t(bh) * sq + qp] : 0.f;
#pragma unroll
    for (int j = 0; j < DC; ++j) acc[i][j] = 0.f;
  }

  int n_kt = (sk + BK - 1) / BK;
  if (causal) {
    const int last_row = min(q0 + BQ, sq) - 1;
    n_kt = min(n_kt, last_row / BK + 1);
  }

  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();   // the previous tile's K and dS reads are done
    load_tile<D>(Ks, RS, kb, k0, BK, sk);
    load_tile<D>(Vs, RS, vb, k0, BK, sk);
    __syncthreads();

    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qv[4], ov[4], kv[4], vv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        qv[i] = Qs[(ty * 4 + i) * RS + d];
        ov[i] = dOs[(ty * 4 + i) * RS + d];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        kv[j] = Ks[(tx + 16 * j) * RS + d];
        vv[j] = Vs[(tx + 16 * j) * RS + d];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
          dp[i][j] = fmaf(ov[i], vv[j], dp[i][j]);
        }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qp = q0 + ty * 4 + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kp = k0 + tx + 16 * j;
        float p = 0.f;
        if (kp < sk) {
          float x = s[i][j] * scale;
          if (causal && qp < kp) x = NEG_INF_MASK;
          p = expf(x - lse_r[i]);
        }
        dSs[(ty * 4 + i) * PS + tx + 16 * j] =
            p * (dp[i][j] - delta_r[i]) * scale;
      }
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float dsv[4], kv[DC];
#pragma unroll
      for (int i = 0; i < 4; ++i) dsv[i] = dSs[(ty * 4 + i) * PS + kk];
#pragma unroll
      for (int j = 0; j < DC; ++j) kv[j] = Ks[kk * RS + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < DC; ++j) acc[i][j] = fmaf(dsv[i], kv[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qp = q0 + ty * 4 + i;
    if (qp >= sq) continue;
    float* row = dq + (size_t(bh) * sq + qp) * D;
#pragma unroll
    for (int j = 0; j < DC; ++j) row[tx + 16 * j] = acc[i][j];
  }
}

// dK and dV: one block per (bh, key tile); q tiles walked in a loop.
template <int D>
__global__ void __launch_bounds__(THREADS)
fa_bwd_dkv_f32(const float* __restrict__ q, const float* __restrict__ k,
               const float* __restrict__ v, const float* __restrict__ dout,
               const float* __restrict__ lse,
               const float* __restrict__ delta, float* __restrict__ dk,
               float* __restrict__ dv, int sq, int sk, float scale,
               int causal) {
  constexpr int DC = D / 16;
  constexpr int RS = D + 1;
  extern __shared__ float smem[];
  float* Ks = smem;                  // BK x RS
  float* Vs = Ks + BK * RS;          // BK x RS
  float* Qs = Vs + BK * RS;          // BQ x RS
  float* dOs = Qs + BQ * RS;         // BQ x RS
  float* Ps = dOs + BQ * RS;         // BK x PS: P^T
  float* dSs = Ps + BK * PS;         // BK x PS: dS^T
  float* lse_s = dSs + BK * PS;      // BQ
  float* delta_s = lse_s + BQ;       // BQ

  const int bh = blockIdx.y;
  const int k0 = blockIdx.x * BK;
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const float* qb = q + size_t(bh) * sq * D;
  const float* dob = dout + size_t(bh) * sq * D;
  const float* kb = k + size_t(bh) * sk * D;
  const float* vb = v + size_t(bh) * sk * D;

  load_tile<D>(Ks, RS, kb, k0, BK, sk);
  load_tile<D>(Vs, RS, vb, k0, BK, sk);

  float acc_k[4][DC], acc_v[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DC; ++j) acc_k[i][j] = acc_v[i][j] = 0.f;

  const int n_qt = (sq + BQ - 1) / BQ;
  // causal: a q tile wholly before this key tile sees none of it
  const int qt0 = causal ? k0 / BQ : 0;

  for (int qt = qt0; qt < n_qt; ++qt) {
    const int q0 = qt * BQ;
    __syncthreads();   // the previous tile's Q, dO, P and dS reads are done
    load_tile<D>(Qs, RS, qb, q0, BQ, sq);
    load_tile<D>(dOs, RS, dob, q0, BQ, sq);
    for (int r = threadIdx.x; r < BQ; r += THREADS) {
      const int qp = q0 + r;
      lse_s[r] = qp < sq ? lse[size_t(bh) * sq + qp] : INFINITY;
      delta_s[r] = qp < sq ? delta[size_t(bh) * sq + qp] : 0.f;
    }
    __syncthreads();

    // transposed scores: thread rows are keys, columns queries
    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float kv[4], vv[4], qv[4], ov[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        kv[i] = Ks[(ty * 4 + i) * RS + d];
        vv[i] = Vs[(ty * 4 + i) * RS + d];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        qv[j] = Qs[(tx + 16 * j) * RS + d];
        ov[j] = dOs[(tx + 16 * j) * RS + d];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(kv[i], qv[j], s[i][j]);
          dp[i][j] = fmaf(vv[i], ov[j], dp[i][j]);
        }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int kp = k0 + ty * 4 + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        const int qp = q0 + c;
        float p = 0.f;
        if (kp < sk) {
          float x = s[i][j] * scale;
          if (causal && qp < kp) x = NEG_INF_MASK;
          p = expf(x - lse_s[c]);
        }
        Ps[(ty * 4 + i) * PS + c] = p;
        dSs[(ty * 4 + i) * PS + c] = p * (dp[i][j] - delta_s[c]) * scale;
      }
    }
    __syncthreads();

#pragma unroll 4
    for (int qq = 0; qq < BQ; ++qq) {
      float pv[4], dsv[4], ov[DC], qv[DC];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        pv[i] = Ps[(ty * 4 + i) * PS + qq];
        dsv[i] = dSs[(ty * 4 + i) * PS + qq];
      }
#pragma unroll
      for (int j = 0; j < DC; ++j) {
        ov[j] = dOs[qq * RS + tx + 16 * j];
        qv[j] = Qs[qq * RS + tx + 16 * j];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < DC; ++j) {
          acc_v[i][j] = fmaf(pv[i], ov[j], acc_v[i][j]);
          acc_k[i][j] = fmaf(dsv[i], qv[j], acc_k[i][j]);
        }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int kp = k0 + ty * 4 + i;
    if (kp >= sk) continue;
    float* krow = dk + (size_t(bh) * sk + kp) * D;
    float* vrow = dv + (size_t(bh) * sk + kp) * D;
#pragma unroll
    for (int j = 0; j < DC; ++j) {
      krow[tx + 16 * j] = acc_k[i][j];
      vrow[tx + 16 * j] = acc_v[i][j];
    }
  }
}

template <int D>
int launch_dq_f32(const float* q, const float* k, const float* v,
                  const float* dout, const float* lse, const float* delta,
                  float* dq, int bh, int sq, int sk, float scale, int causal,
                  cudaStream_t stream) {
  const size_t smem = dq_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      fa_bwd_dq_f32<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      int(smem));
  if (err != cudaSuccess) return int(err);
  const dim3 grid((sq + BQ - 1) / BQ, bh);
  fa_bwd_dq_f32<D><<<grid, THREADS, smem, stream>>>(
      q, k, v, dout, lse, delta, dq, sq, sk, scale, causal);
  return int(cudaGetLastError());
}

template <int D>
int launch_dkv_f32(const float* q, const float* k, const float* v,
                   const float* dout, const float* lse, const float* delta,
                   float* dk, float* dv, int bh, int sq, int sk, float scale,
                   int causal, cudaStream_t stream) {
  const size_t smem = dkv_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      fa_bwd_dkv_f32<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      int(smem));
  if (err != cudaSuccess) return int(err);
  const dim3 grid((sk + BK - 1) / BK, bh);
  fa_bwd_dkv_f32<D><<<grid, THREADS, smem, stream>>>(
      q, k, v, dout, lse, delta, dk, dv, sq, sk, scale, causal);
  return int(cudaGetLastError());
}

// ------------------------------------------------------- bfloat16, mma.sync

constexpr int QT = 32;   // q rows per tile of the bf16 dK/dV kernel

// dQ: one block of 4 warps per (bh, 64-row q tile); KV tiles walked in a
// loop; each warp owns 16 q rows.
template <int D>
__global__ void __launch_bounds__(MMA_THREADS)
fa_bwd_dq_bf16(const __nv_bfloat16* __restrict__ q,
               const __nv_bfloat16* __restrict__ k,
               const __nv_bfloat16* __restrict__ v,
               const __nv_bfloat16* __restrict__ dout,
               const float* __restrict__ lse,
               const float* __restrict__ delta,
               __nv_bfloat16* __restrict__ dq, int sq, int sk, float scale,
               int causal) {
  constexpr int SX = D + 8;
  constexpr int KS = D / 16;
  constexpr int DN = D / 8;
  constexpr int NJ = BK / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* dOs = Qs + BQ * SX;
  __nv_bfloat16* Ks = dOs + BQ * SX;
  __nv_bfloat16* Vs = Ks + BK * SX;

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * BQ;
  const int warp = threadIdx.x / 32;
  const int g = (threadIdx.x % 32) / 4;
  const int t = threadIdx.x % 4;
  const int r0 = warp * 16;
  const int row[2] = {q0 + r0 + g, q0 + r0 + g + 8};
  const __nv_bfloat16* kb = k + size_t(bh) * sk * D;
  const __nv_bfloat16* vb = v + size_t(bh) * sk * D;

  stage_bf16<D>(Qs, q + size_t(bh) * sq * D, q0, BQ, sq);
  stage_bf16<D>(dOs, dout + size_t(bh) * sq * D, q0, BQ, sq);
  // rows past S: lse = +inf makes their P exactly 0
  float lse_r[2], delta_r[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    lse_r[h] = row[h] < sq ? lse[size_t(bh) * sq + row[h]] : INFINITY;
    delta_r[h] = row[h] < sq ? delta[size_t(bh) * sq + row[h]] : 0.f;
  }
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

    float s[NJ][4], dp[NJ][4];
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      uint32_t qa[4], oa[4];
      load_a<SX>(qa, Qs, r0, kk * 16, g, t);
      load_a<SX>(oa, dOs, r0, kk * 16, g, t);
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        uint32_t b0, b1;
        load_b_rows<SX>(b0, b1, Ks, j * 8, kk * 16, g, t);
        mma_bf16(s[j], qa, b0, b1);
        load_b_rows<SX>(b0, b1, Vs, j * 8, kk * 16, g, t);
        mma_bf16(dp[j], oa, b0, b1);
      }
    }

    // dS = P * (dP - delta) * scale, in place of S
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e >> 1;
        const int kp = k0 + j * 8 + 2 * t + (e & 1);
        float p = 0.f;
        if (kp < sk) {
          float x = s[j][e] * scale;
          if (causal && row[h] < kp) x = NEG_INF_MASK;
          p = expf(x - lse_r[h]);
        }
        s[j][e] = p * (dp[j][e] - delta_r[h]) * scale;
      }

    // dQ += dS K
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t da[4];
      c_to_a(da, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
      for (int dn = 0; dn < DN; ++dn) {
        uint32_t b0, b1;
        load_b_cols<SX>(b0, b1, Ks, kk * 16, dn * 8, g, t);
        mma_bf16(acc[dn], da, b0, b1);
      }
    }
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (row[h] >= sq) continue;
    __nv_bfloat16* out = dq + (size_t(bh) * sq + row[h]) * D;
#pragma unroll
    for (int dn = 0; dn < DN; ++dn)
      *reinterpret_cast<uint32_t*>(out + dn * 8 + 2 * t) =
          pack_bf16(acc[dn][2 * h], acc[dn][2 * h + 1]);
  }
}

// dK and dV: one block of 4 warps per (bh, 64-key tile); q tiles of 32
// rows walked in a loop; each warp owns 16 keys.
template <int D>
__global__ void __launch_bounds__(MMA_THREADS)
fa_bwd_dkv_bf16(const __nv_bfloat16* __restrict__ q,
                const __nv_bfloat16* __restrict__ k,
                const __nv_bfloat16* __restrict__ v,
                const __nv_bfloat16* __restrict__ dout,
                const float* __restrict__ lse,
                const float* __restrict__ delta,
                __nv_bfloat16* __restrict__ dk,
                __nv_bfloat16* __restrict__ dv, int sq, int sk, float scale,
                int causal) {
  constexpr int SX = D + 8;
  constexpr int KS = D / 16;
  constexpr int DN = D / 8;
  constexpr int NJ = QT / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* Vs = Ks + BK * SX;
  __nv_bfloat16* Qs = Vs + BK * SX;
  __nv_bfloat16* dOs = Qs + QT * SX;
  float* lse_s = reinterpret_cast<float*>(dOs + QT * SX);
  float* delta_s = lse_s + QT;

  const int bh = blockIdx.y;
  const int k0 = blockIdx.x * BK;
  const int warp = threadIdx.x / 32;
  const int g = (threadIdx.x % 32) / 4;
  const int t = threadIdx.x % 4;
  const int r0 = warp * 16;                    // the warp's keys
  const int key[2] = {k0 + r0 + g, k0 + r0 + g + 8};
  const __nv_bfloat16* qb = q + size_t(bh) * sq * D;
  const __nv_bfloat16* dob = dout + size_t(bh) * sq * D;

  stage_bf16<D>(Ks, k + size_t(bh) * sk * D, k0, BK, sk);
  stage_bf16<D>(Vs, v + size_t(bh) * sk * D, k0, BK, sk);

  float acc_k[DN][4], acc_v[DN][4];
#pragma unroll
  for (int dn = 0; dn < DN; ++dn)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_k[dn][e] = acc_v[dn][e] = 0.f;

  const int n_qt = (sq + QT - 1) / QT;
  // causal: a q tile wholly before this key tile sees none of it
  const int qt0 = causal ? k0 / QT : 0;

  for (int qt = qt0; qt < n_qt; ++qt) {
    const int q0 = qt * QT;
    __syncthreads();   // the previous tile's Q, dO, lse and delta reads
    stage_bf16<D>(Qs, qb, q0, QT, sq);
    stage_bf16<D>(dOs, dob, q0, QT, sq);
    for (int r = threadIdx.x; r < QT; r += MMA_THREADS) {
      const int qp = q0 + r;
      lse_s[r] = qp < sq ? lse[size_t(bh) * sq + qp] : INFINITY;
      delta_s[r] = qp < sq ? delta[size_t(bh) * sq + qp] : 0.f;
    }
    __syncthreads();

    // transposed: S^T = K Q^T and dP^T = V dO^T, keys x q rows
    float s[NJ][4], dp[NJ][4];
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      uint32_t ka[4], va[4];
      load_a<SX>(ka, Ks, r0, kk * 16, g, t);
      load_a<SX>(va, Vs, r0, kk * 16, g, t);
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        uint32_t b0, b1;
        load_b_rows<SX>(b0, b1, Qs, j * 8, kk * 16, g, t);
        mma_bf16(s[j], ka, b0, b1);
        load_b_rows<SX>(b0, b1, dOs, j * 8, kk * 16, g, t);
        mma_bf16(dp[j], va, b0, b1);
      }
    }

    // P^T in place of S^T, dS^T in place of dP^T
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e >> 1;
        const int c = j * 8 + 2 * t + (e & 1);
        float p = 0.f;
        if (key[h] < sk) {
          float x = s[j][e] * scale;
          if (causal && q0 + c < key[h]) x = NEG_INF_MASK;
          p = expf(x - lse_s[c]);
        }
        s[j][e] = p;
        dp[j][e] = p * (dp[j][e] - delta_s[c]) * scale;
      }

    // dV += P^T dO, dK += dS^T Q
#pragma unroll
    for (int kk = 0; kk < QT / 16; ++kk) {
      uint32_t pa[4], da[4];
      c_to_a(pa, s[2 * kk], s[2 * kk + 1]);
      c_to_a(da, dp[2 * kk], dp[2 * kk + 1]);
#pragma unroll
      for (int dn = 0; dn < DN; ++dn) {
        uint32_t b0, b1;
        load_b_cols<SX>(b0, b1, dOs, kk * 16, dn * 8, g, t);
        mma_bf16(acc_v[dn], pa, b0, b1);
        load_b_cols<SX>(b0, b1, Qs, kk * 16, dn * 8, g, t);
        mma_bf16(acc_k[dn], da, b0, b1);
      }
    }
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (key[h] >= sk) continue;
    __nv_bfloat16* krow = dk + (size_t(bh) * sk + key[h]) * D;
    __nv_bfloat16* vrow = dv + (size_t(bh) * sk + key[h]) * D;
#pragma unroll
    for (int dn = 0; dn < DN; ++dn) {
      *reinterpret_cast<uint32_t*>(krow + dn * 8 + 2 * t) =
          pack_bf16(acc_k[dn][2 * h], acc_k[dn][2 * h + 1]);
      *reinterpret_cast<uint32_t*>(vrow + dn * 8 + 2 * t) =
          pack_bf16(acc_v[dn][2 * h], acc_v[dn][2 * h + 1]);
    }
  }
}

template <int D>
int launch_dq_bf16(const __nv_bfloat16* q, const __nv_bfloat16* k,
                   const __nv_bfloat16* v, const __nv_bfloat16* dout,
                   const float* lse, const float* delta, __nv_bfloat16* dq,
                   int bh, int sq, int sk, float scale, int causal,
                   cudaStream_t stream) {
  const size_t smem = sizeof(__nv_bfloat16) * size_t(2 * BQ + 2 * BK) *
                      (D + 8);
  cudaError_t err = cudaFuncSetAttribute(
      fa_bwd_dq_bf16<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      int(smem));
  if (err != cudaSuccess) return int(err);
  const dim3 grid((sq + BQ - 1) / BQ, bh);
  fa_bwd_dq_bf16<D><<<grid, MMA_THREADS, smem, stream>>>(
      q, k, v, dout, lse, delta, dq, sq, sk, scale, causal);
  return int(cudaGetLastError());
}

template <int D>
int launch_dkv_bf16(const __nv_bfloat16* q, const __nv_bfloat16* k,
                    const __nv_bfloat16* v, const __nv_bfloat16* dout,
                    const float* lse, const float* delta, __nv_bfloat16* dk,
                    __nv_bfloat16* dv, int bh, int sq, int sk, float scale,
                    int causal, cudaStream_t stream) {
  const size_t smem = sizeof(__nv_bfloat16) * size_t(2 * BK + 2 * QT) *
                      (D + 8) + sizeof(float) * 2 * QT;
  cudaError_t err = cudaFuncSetAttribute(
      fa_bwd_dkv_bf16<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      int(smem));
  if (err != cudaSuccess) return int(err);
  const dim3 grid((sk + BK - 1) / BK, bh);
  fa_bwd_dkv_bf16<D><<<grid, MMA_THREADS, smem, stream>>>(
      q, k, v, dout, lse, delta, dk, dv, sq, sk, scale, causal);
  return int(cudaGetLastError());
}

#define MXT_HEAD_DIMS(CALL)                          \
  switch (d) {                                       \
    case 16: return CALL(16);                        \
    case 32: return CALL(32);                        \
    case 64: return CALL(64);                        \
    case 128: return CALL(128);                      \
    default: return int(cudaErrorInvalidValue);      \
  }

}  // namespace

extern "C" {

// q and dout (bh, sq, d), k and v (bh, sk, d), dq (bh, sq, d), dk and dv
// (bh, sk, d): contiguous, of the entry point's type, 16-byte aligned;
// lse and delta (bh, sq) float32; all on the current device.
// d in {16, 32, 64, 128}.
int mxt_flash_attention_bwd_dq_f32(const void* q, const void* k,
                                   const void* v, const void* dout,
                                   const void* lse, const void* delta,
                                   void* dq, int bh, int sq, int sk, int d,
                                   float scale, int causal, void* stream) {
  using T = float;
#define CALL(D)                                                              \
  launch_dq_f32<D>(static_cast<const T*>(q), static_cast<const T*>(k),      \
                   static_cast<const T*>(v), static_cast<const T*>(dout),   \
                   static_cast<const float*>(lse),                          \
                   static_cast<const float*>(delta), static_cast<T*>(dq),   \
                   bh, sq, sk, scale, causal,                               \
                   static_cast<cudaStream_t>(stream))
  MXT_HEAD_DIMS(CALL)
#undef CALL
}

int mxt_flash_attention_bwd_dq_bf16(const void* q, const void* k,
                                    const void* v, const void* dout,
                                    const void* lse, const void* delta,
                                    void* dq, int bh, int sq, int sk, int d,
                                    float scale, int causal, void* stream) {
  using T = __nv_bfloat16;
#define CALL(D)                                                              \
  launch_dq_bf16<D>(static_cast<const T*>(q), static_cast<const T*>(k),     \
                    static_cast<const T*>(v), static_cast<const T*>(dout),  \
                    static_cast<const float*>(lse),                         \
                    static_cast<const float*>(delta), static_cast<T*>(dq),  \
                    bh, sq, sk, scale, causal,                              \
                    static_cast<cudaStream_t>(stream))
  MXT_HEAD_DIMS(CALL)
#undef CALL
}

int mxt_flash_attention_bwd_dkv_f32(const void* q, const void* k,
                                    const void* v, const void* dout,
                                    const void* lse, const void* delta,
                                    void* dk, void* dv, int bh, int sq,
                                    int sk, int d, float scale, int causal,
                                    void* stream) {
  using T = float;
#define CALL(D)                                                              \
  launch_dkv_f32<D>(static_cast<const T*>(q), static_cast<const T*>(k),     \
                    static_cast<const T*>(v), static_cast<const T*>(dout),  \
                    static_cast<const float*>(lse),                         \
                    static_cast<const float*>(delta), static_cast<T*>(dk),  \
                    static_cast<T*>(dv), bh, sq, sk, scale, causal,         \
                    static_cast<cudaStream_t>(stream))
  MXT_HEAD_DIMS(CALL)
#undef CALL
}

int mxt_flash_attention_bwd_dkv_bf16(const void* q, const void* k,
                                     const void* v, const void* dout,
                                     const void* lse, const void* delta,
                                     void* dk, void* dv, int bh, int sq,
                                     int sk, int d, float scale, int causal,
                                     void* stream) {
  using T = __nv_bfloat16;
#define CALL(D)                                                              \
  launch_dkv_bf16<D>(static_cast<const T*>(q), static_cast<const T*>(k),    \
                     static_cast<const T*>(v), static_cast<const T*>(dout), \
                     static_cast<const float*>(lse),                        \
                     static_cast<const float*>(delta), static_cast<T*>(dk), \
                     static_cast<T*>(dv), bh, sq, sk, scale, causal,        \
                     static_cast<cudaStream_t>(stream))
  MXT_HEAD_DIMS(CALL)
#undef CALL
}

const char* mxt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
