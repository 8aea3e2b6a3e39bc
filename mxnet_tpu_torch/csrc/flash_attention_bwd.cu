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
//     dQ: one block per (bh, q tile) walks the KV tiles and keeps its dQ
//     accumulator in registers. dK/dV: one block per (bh, key
//     tile) walks the q tiles and keeps dK and dV in registers. Every
//     output tile has one owner, as on the TPU's KV-major grid, so no
//     block adds into another's output;
//   * Q, dO (dQ) or K, V (dK/dV) stay in shared memory for the whole
//     walk; the other pair is staged once per tile;
//   * causal tiles wholly above the diagonal are never loaded.
//
// float32 (fa_bwd_dq_f32, fa_bwd_dkv_f32; off the main path, which trains
// under amp bf16): plain FMAs, the first version. 16 x 16 threads, each
// owning 4 rows x 4 (then D / 16) columns of the tile products; rows are
// padded in shared memory (D + 1 floats) so that 16 threads reading 16
// different rows hit 16 banks; the
// P / dS tiles go through shared memory with row stride BK + 4, so the
// two half-warps' rows land 16 banks apart.
//
// bfloat16 (the training path under amp). fa_bwd_dq_bf16 and
// fa_bwd_dkv_bf16, for head dims 16 and 32, run on mma.sync m16n8k16 (bf16
// in, float32 accumulate; see flash_attention_common.cuh): 4 warps per
// block, each owning 16 rows (q rows for dQ, keys for dK/dV); S and dP
// land in registers in the accumulator layout; P and dS are rounded to
// bf16 (as the TPU kernels round them to the operands' dtype) and reused
// in registers as the A operand of the next product; dK/dV walks q tiles
// of 32 rows in the transposed orientation S^T = K Q^T, so the key rows
// stay with their warp. Loads are synchronous.
//
// fa_bwd_dkv_bf16_wgmma (dK and dV for head dims 64 and 128, the models')
// is built for this card. At the training shape (BH 128, S 1024, D 128,
// causal) it does 68.8 GFLOP on 202.4 MB: 0.070 ms at 989 TFLOP/s
// against 0.060 ms at 3.35 TB/s, so its tensor-core work bounds it.
//   * a block of three warpgroups per (bh, 128-key tile): a producer
//     whose one elected thread issues every TMA load (setmaxnreg 24), and
//     two consumers of 64 keys each (setmaxnreg 240: dK and dV take 128
//     registers a thread, S^T and dP^T 64 more); ptxas gives the block
//     168 registers a thread at launch and spills nothing. Key tiles are
//     scheduled in order, so the causal tiles of most work lead;
//   * K and V are loaded once and held for the walk over the q tiles; Q,
//     dO (64 rows each), lse and delta (64 floats each) go through a
//     two-stage ring, each stage with a "loaded" mbarrier and a "free"
//     one that all 256 consumer threads arrive on;
//   * per q tile: S^T = K Q^T and dP^T = V dO^T as two wgmma groups with
//     both operands in shared memory, K-major; P^T = exp2(S^T scale log2 e
//     - lse log2 e) is computed while dP^T still runs, then dS^T = P^T
//     (dP^T - delta) scale; both are rounded to bf16 and become register
//     A operands (c_to_a) of dV += P^T dO and dK += dS^T Q, whose B (dO,
//     Q) is read MN-major with the transpose bit set, since both lie
//     q-row-major along D;
//   * masks are evaluated only on tiles that cross the diagonal or an
//     edge; dK and dV are written as bf16 from registers, one owner per
//     output tile and no atomics.
// fa_bwd_dq_bf16_wgmma (dQ for head dims 64 and 128) is built the same
// way. At the training shape it does 51.6 GFLOP on 168.8 MB: 0.052 ms at
// 989 TFLOP/s against 0.050 ms at 3.35 TB/s, so it sits at the balance
// point. The first dQ kernel (mma.sync) reached 12% of that: 4 warps
// staged each K/V tile synchronously between two barriers, built the B
// operand of dS K from 16-bit shared loads, and ran q tiles in ascending
// order, so the heaviest causal tiles came last. Now:
//   * a block of three warpgroups per (bh, 128-row q tile): the producer
//     (setmaxnreg 24) whose one elected thread issues every TMA load, and
//     two consumers of 64 q rows each (setmaxnreg 240). The last q tile of
//     each head is scheduled first;
//   * Q, dO, lse and delta of the block's rows are loaded once and held
//     (lse and delta in one 132-float box each from the 4-float boundary
//     at or below the first row); K and V tiles of 64 keys pass through a
//     three-stage ring, each stage with a "loaded" mbarrier and a "free"
//     one that all 256 consumer threads arrive on. 64 keys keep the dQ
//     accumulator (64 registers a thread at D 128), S and dP (32 each)
//     and dS as bf16 (16) in registers with no spill;
//   * per KV tile: S = Q K^T and dP = dO V^T are wgmma with both operands
//     in shared memory, K-major; dQ += dS K takes dS from registers
//     (c_to_a, rounded to bf16 as the TPU kernel rounds it to k's dtype)
//     and K MN-major with the transpose bit, as K1 takes V in P V. A step
//     issues S_j, dP_j and dQ += dS_(j-1) K_(j-1) together; P_j is
//     computed once S_j is in (wait_group 2) while the other two run, and
//     a stage is freed once the dQ product that reads its K is done;
//   * causal KV tiles wholly above the diagonal are never loaded; a tile
//     that only the second warpgroup's rows see is waited for and
//     released by the first, so the ring's phases stay in step. Masks run
//     only on tiles that cross the diagonal, the Sk edge or S, in a loop
//     of their own, and the last dQ product is peeled off, so no branch
//     lies between a product and its wait (C7514);
//   * dQ is written as bf16 from registers, rows past S not at all: one
//     owner per output tile and no atomics, as on the TPU's grid.
// Where trouble lay, and what the design does about it (pitfalls as in
// flash_attention_fwd.cu):
//   1. swizzle at D 128: two 64-column TMA boxes per row, read by the
//      descriptors of flash_attention_sm90.cuh;
//   2. TMA's zero fill is no mask: lse and delta travel as flat (BH * S)
//      float32 vectors (a rank-1 map, which needs no 16-byte row stride
//      and so takes any S), and the values past a head's last row belong
//      to the next head or are zeros. P is therefore set to 0 explicitly
//      for q rows past S, for keys past Sk and above the diagonal; the
//      +inf lse of the mma.sync kernels does not carry over. A box of
//      that map must also start on a 16-byte boundary (a start at
//      bh * S + q0 floats faulted with "illegal instruction" wherever that
//      is no multiple of 4, e.g. S 65 with BH > 1): each box starts at the
//      4-float boundary at or below the tile's first row and reads 68
//      floats, and the consumers index past the 0-3 float offset;
//   3. tensor maps as in the forward: rank-3 (D, S, BH) for Q, K, V, dO,
//      rank-1 for lse and delta, encoded per call and passed as
//      __grid_constant__ parameters; the wrapper aligns lse and delta to
//      16 bytes as well;
//   4. wgmma ordering: wait_group 1 lets P^T be computed while dP^T runs;
//      the registers of P, dS and the accumulators are pinned before the
//      wgmma.fence of the products that read them; a stage is freed only
//      after the wait on its last wgmma;
//   5. head dims 16 and 32 keep fa_bwd_dq_bf16 and fa_bwd_dkv_bf16
//      (mma.sync), chosen by head dim alone in
//      mxt_flash_attention_bwd_dq_bf16 and _dkv_bf16.
//
// C interface (bound with ctypes): every function returns a cudaError_t
// as int, 0 on success, and launches on the given stream without
// synchronising.

#include <math.h>

#include <type_traits>

#include "flash_attention_common.cuh"
#include "flash_attention_sm90.cuh"

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

// ------------------------ bfloat16, mma.sync (dQ; dK/dV at head dims 16, 32)

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

// --------------------------------------------- bfloat16, wgmma + TMA ring

using namespace fa90;

constexpr int WG_KEYS = 128;      // keys per block: 2 consumer warpgroups
constexpr int WG_QT = 64;         // q rows per ring tile
// lse and delta of a q tile: a TMA box must start 16-byte aligned, so the
// box starts at the 4-float boundary at or below the tile's first row and
// reads 4 floats more
constexpr int WG_VEC = WG_QT + 4;
constexpr int WG_THREADS = 384;   // producer warpgroup + 2 consumers

// Byte offsets in the (1024-aligned) dynamic shared memory of the block.
template <int D>
struct DkvSmem {
  static constexpr uint32_t KV_TILE = WG_KEYS * D * 2;   // K or V
  static constexpr uint32_t Q_TILE = WG_QT * D * 2;      // Q or dO
  static constexpr uint32_t K = 0;
  static constexpr uint32_t V = KV_TILE;
  // ring stage: Q, dO, lse and delta (68 floats each), 1024-aligned
  static constexpr uint32_t STAGE = 2 * Q_TILE + 1024;
  static constexpr uint32_t RING = 2 * KV_TILE;
  __device__ static uint32_t Q(int s) { return RING + s * STAGE; }
  __device__ static uint32_t DO(int s) { return Q(s) + Q_TILE; }
  __device__ static uint32_t LSE(int s) { return DO(s) + Q_TILE; }
  __device__ static uint32_t DELTA(int s) { return LSE(s) + 512; }
  static constexpr uint32_t BAR = RING + 2 * STAGE;    // 5 mbarriers
  static constexpr size_t BYTES = BAR + 5 * 8 + 1024;  // + alignment
};

template <int D>
__global__ void __launch_bounds__(WG_THREADS, 1)
fa_bwd_dkv_bf16_wgmma(const __grid_constant__ CUtensorMap tq,
                      const __grid_constant__ CUtensorMap tk,
                      const __grid_constant__ CUtensorMap tv,
                      const __grid_constant__ CUtensorMap tdo,
                      const __grid_constant__ CUtensorMap tlse,
                      const __grid_constant__ CUtensorMap tdelta,
                      __nv_bfloat16* __restrict__ dk,
                      __nv_bfloat16* __restrict__ dv, int sq, int sk,
                      float scale, int causal) {
  using L = DkvSmem<D>;
  constexpr int NH = D / 64;       // 64-column boxes of a row
  extern __shared__ __align__(1024) unsigned char dkv_smem[];
  const uint32_t base = (smem_u32(dkv_smem) + 1023u) & ~1023u;
  unsigned char* const gbase = dkv_smem + (base - smem_u32(dkv_smem));
  // barriers: K and V loaded; stage s loaded; stage s free again
  const uint32_t bar_kv = base + L::BAR;
  const uint32_t bar_full = bar_kv + 8, bar_free = bar_kv + 24;

  const int bh = blockIdx.x;
  const int k0 = blockIdx.y * WG_KEYS;   // low key tiles (most work) first
  const int n_qt = (sq + WG_QT - 1) / WG_QT;
  // causal: a q tile wholly before this key tile sees none of it
  const int qt0 = causal ? k0 / WG_QT : 0;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    mbar_init(bar_kv, 1);
    for (int s = 0; s < 2; ++s) {
      mbar_init(bar_full + 8 * s, 1);
      mbar_init(bar_free + 8 * s, 2 * 128);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == 0) {
    // producer: one thread keeps the ring full
    regs_release<24>();
    if (threadIdx.x == 0) {
      tma_prefetch_map(&tq);
      tma_prefetch_map(&tdo);
      mbar_expect_tx(bar_kv, 2 * L::KV_TILE);
#pragma unroll
      for (int h = 0; h < NH; ++h) {
        tma_load_3d(base + L::K + h * WG_KEYS * 128, &tk, bar_kv, h * 64, k0,
                    bh);
        tma_load_3d(base + L::V + h * WG_KEYS * 128, &tv, bar_kv, h * 64, k0,
                    bh);
      }
      for (int qt = qt0; qt < n_qt; ++qt) {
        const int i = qt - qt0, s = i & 1;
        const uint32_t full = bar_full + 8 * s;
        mbar_wait(bar_free + 8 * s, ((i >> 1) & 1) ^ 1);
        mbar_expect_tx(full, 2 * L::Q_TILE + 2 * WG_VEC * 4);
#pragma unroll
        for (int h = 0; h < NH; ++h) {
          tma_load_3d(base + L::Q(s) + h * WG_QT * 128, &tq, full, h * 64,
                      qt * WG_QT, bh);
          tma_load_3d(base + L::DO(s) + h * WG_QT * 128, &tdo, full, h * 64,
                      qt * WG_QT, bh);
        }
        // lse and delta as flat (bh * sq) vectors: values past this head's
        // rows belong to the next head or are zeros, and are masked below
        const int v0 = (bh * sq + qt * WG_QT) & ~3;
        tma_load_1d(base + L::LSE(s), &tlse, full, v0);
        tma_load_1d(base + L::DELTA(s), &tdelta, full, v0);
      }
    }
  } else {
    // consumers: warpgroup g owns keys k0 + 64g .. k0 + 64g + 63
    regs_claim<240>();
    constexpr int NO = D / 2;   // dK and dV registers each: 64 x D / 128
    const int g = wg - 1;
    const int t = threadIdx.x % 128;
    const int lane = t % 32;
    const int cq = 2 * (lane % 4);
    const int kg = k0 + 64 * g;                  // the warpgroup's keys
    const int key0 = kg + 16 * (t / 32) + lane / 4;
    const int key1 = key0 + 8;
    const float scale_log2 = scale * LOG2E;
    float acc_k[NO], acc_v[NO];
#pragma unroll
    for (int i = 0; i < NO; ++i) acc_k[i] = acc_v[i] = 0.f;
    const uint32_t ka = base + L::K + g * 64 * 128;
    const uint32_t va = base + L::V + g * 64 * 128;
    mbar_wait(bar_kv, 0);

    for (int qt = qt0; qt < n_qt; ++qt) {
      const int i = qt - qt0, s = i & 1;
      const int q0 = qt * WG_QT;
      const uint32_t qs = base + L::Q(s), dos = base + L::DO(s);
      // the tile's first row lies 0-3 floats into the boxes
      const int v_off = (bh * sq + q0) & 3;
      const float* lse_s =
          reinterpret_cast<const float*>(gbase + L::LSE(s)) + v_off;
      const float* delta_s =
          reinterpret_cast<const float*>(gbase + L::DELTA(s)) + v_off;

      // S^T = K Q^T and dP^T = V dO^T (keys x q rows), all K-major
      float st[32], dpt[32];
      mbar_wait(bar_full + 8 * s, (i >> 1) & 1);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss(st,
                 kmajor_desc(ka + (kk / 4) * WG_KEYS * 128 + (kk % 4) * 32),
                 kmajor_desc(qs + (kk / 4) * WG_QT * 128 + (kk % 4) * 32),
                 kk > 0);
      wgmma_commit();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss(dpt,
                 kmajor_desc(va + (kk / 4) * WG_KEYS * 128 + (kk % 4) * 32),
                 kmajor_desc(dos + (kk / 4) * WG_QT * 128 + (kk % 4) * 32),
                 kk > 0);
      wgmma_commit();

      // P^T = exp2(S^T scale log2e - lse log2e) while dP^T runs; masks
      // only on tiles that need them. q rows past S are zeroed here: TMA
      // fills them with zeros, which is no mask
      wgmma_wait<1>();
      fence_regs(st);
      const bool edge = q0 + WG_QT > sq || kg + 64 > sk ||
                        (causal && q0 < kg + 63);
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = 8 * j + cq + (e & 1);
          float p = exp2f(fmaf(st[4 * j + e], scale_log2, -lse_s[c] * LOG2E));
          if (edge) {
            const int qp = q0 + c, key = (e & 2) ? key1 : key0;
            if (qp >= sq || key >= sk || (causal && qp < key)) p = 0.f;
          }
          st[4 * j + e] = p;
        }
      wgmma_wait<0>();
      fence_regs(dpt);
      // dS^T = P^T (dP^T - delta) scale, in place of dP^T
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = 8 * j + cq + (e & 1);
          dpt[4 * j + e] =
              st[4 * j + e] * (dpt[4 * j + e] - delta_s[c]) * scale;
        }
      // both rounded to bf16: the A operands of the next two products
      uint32_t pa[4][4], da[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        c_to_a(pa[kk], &st[8 * kk], &st[8 * kk + 4]);
        c_to_a(da[kk], &dpt[8 * kk], &dpt[8 * kk + 4]);
      }

      // dV += P^T dO and dK += dS^T Q: B MN-major (q-row-major in memory)
      fence_regs(acc_v);
      fence_regs(acc_k);
      fence_regs(pa);
      fence_regs(da);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_rs(acc_v, pa[kk], mnmajor_desc(dos + kk * 16 * 128, WG_QT));
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_rs(acc_k, da[kk], mnmajor_desc(qs + kk * 16 * 128, WG_QT));
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc_v);
      fence_regs(acc_k);
      mbar_arrive(bar_free + 8 * s);   // Q, dO, lse and delta are read
    }

#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int key = h ? key1 : key0;
      if (key >= sk) continue;
      __nv_bfloat16* krow = dk + (size_t(bh) * sk + key) * D;
      __nv_bfloat16* vrow = dv + (size_t(bh) * sk + key) * D;
#pragma unroll
      for (int j = 0; j < NO / 4; ++j) {
        *reinterpret_cast<uint32_t*>(krow + 8 * j + cq) =
            pack_bf16(acc_k[4 * j + 2 * h], acc_k[4 * j + 2 * h + 1]);
        *reinterpret_cast<uint32_t*>(vrow + 8 * j + cq) =
            pack_bf16(acc_v[4 * j + 2 * h], acc_v[4 * j + 2 * h + 1]);
      }
    }
  }
}

template <int D>
int launch_dkv_bf16_wgmma(const __nv_bfloat16* q, const __nv_bfloat16* k,
                          const __nv_bfloat16* v, const __nv_bfloat16* dout,
                          const float* lse, const float* delta,
                          __nv_bfloat16* dk, __nv_bfloat16* dv, int bh,
                          int sq, int sk, float scale, int causal,
                          cudaStream_t stream) {
  alignas(64) CUtensorMap tq, tk, tv, tdo, tlse, tdelta;
  int err = map_heads_bf16(&tq, q, bh, sq, D, WG_QT);
  if (!err) err = map_heads_bf16(&tk, k, bh, sk, D, WG_KEYS);
  if (!err) err = map_heads_bf16(&tv, v, bh, sk, D, WG_KEYS);
  if (!err) err = map_heads_bf16(&tdo, dout, bh, sq, D, WG_QT);
  if (!err) err = map_vector_f32(&tlse, lse, size_t(bh) * sq, WG_VEC);
  if (!err) err = map_vector_f32(&tdelta, delta, size_t(bh) * sq, WG_VEC);
  if (err) return err;
  const size_t smem = DkvSmem<D>::BYTES;
  cudaError_t cerr = cudaFuncSetAttribute(
      fa_bwd_dkv_bf16_wgmma<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      int(smem));
  if (cerr != cudaSuccess) return int(cerr);
  const dim3 grid(bh, (sk + WG_KEYS - 1) / WG_KEYS);
  fa_bwd_dkv_bf16_wgmma<D><<<grid, WG_THREADS, smem, stream>>>(
      tq, tk, tv, tdo, tlse, tdelta, dk, dv, sq, sk, scale, causal);
  return int(cudaGetLastError());
}

// ---------------------------------------- dQ, bfloat16, wgmma + TMA ring

constexpr int DQ_BQ = 128;         // q rows per block: 2 consumer warpgroups
constexpr int DQ_BK = 64;          // keys per ring tile
constexpr int DQ_STAGES = 3;       // K/V tiles in flight
// lse and delta of the block's rows, from the 4-float boundary at or
// below its first row (a TMA box must start 16-byte aligned)
constexpr int DQ_VEC = DQ_BQ + 4;

// Byte offsets in the (1024-aligned) dynamic shared memory of the block:
// Q and dO (loaded once), a ring of K and V tiles (3 stages: 160 KB at D
// 128 with Q and dO), lse and delta, the mbarriers.
template <int D>
struct DqSmem {
  static constexpr uint32_t Q_TILE = DQ_BQ * D * 2;   // Q or dO
  static constexpr uint32_t KV_TILE = DQ_BK * D * 2;  // K or V
  static constexpr uint32_t Q = 0;
  static constexpr uint32_t DO = Q_TILE;
  static constexpr uint32_t RING = 2 * Q_TILE;
  static constexpr uint32_t STAGE = 2 * KV_TILE;
  __device__ static uint32_t K(int s) { return RING + s * STAGE; }
  __device__ static uint32_t V(int s) { return K(s) + KV_TILE; }
  static constexpr uint32_t LSE = RING + DQ_STAGES * STAGE;
  static constexpr uint32_t DELTA = LSE + 1024;
  static constexpr uint32_t BAR = DELTA + 1024;
  static constexpr int N_BAR = 1 + 2 * DQ_STAGES;
  static constexpr size_t BYTES = BAR + N_BAR * 8 + 1024;   // + alignment
};

// P = exp2(S scale log2e - lse log2e) in place of the scores of a 64-key
// tile, on the thread's two rows (nl: -lse log2e of each). The masks run
// only on tiles that need them (EDGE): q rows past S, keys past Sk and
// keys above the diagonal get P = 0 (TMA's zero fill is no mask).
template <bool EDGE>
__device__ __forceinline__ void dq_probs(float (&sc)[32], int k0, int sq,
                                         int sk, int causal, int row0,
                                         int row1, int cq, float scale_log2,
                                         float nl0, float nl1) {
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float p = exp2f(fmaf(sc[4 * j + e], scale_log2, (e & 2) ? nl1 : nl0));
      if (EDGE) {
        const int key = k0 + 8 * j + cq + (e & 1);
        const int row = (e & 2) ? row1 : row0;
        if (row >= sq || key >= sk || (causal && row < key)) p = 0.f;
      }
      sc[4 * j + e] = p;
    }
}

template <int D>
__global__ void __launch_bounds__(WG_THREADS, 1)
fa_bwd_dq_bf16_wgmma(const __grid_constant__ CUtensorMap tq,
                     const __grid_constant__ CUtensorMap tk,
                     const __grid_constant__ CUtensorMap tv,
                     const __grid_constant__ CUtensorMap tdo,
                     const __grid_constant__ CUtensorMap tlse,
                     const __grid_constant__ CUtensorMap tdelta,
                     __nv_bfloat16* __restrict__ dq, int sq, int sk,
                     float scale, int causal) {
  using L = DqSmem<D>;
  constexpr int NH = D / 64;       // 64-column boxes of a row
  constexpr int NST = DQ_STAGES;
  extern __shared__ __align__(1024) unsigned char dq_smem[];
  const uint32_t base = (smem_u32(dq_smem) + 1023u) & ~1023u;
  unsigned char* const gbase = dq_smem + (base - smem_u32(dq_smem));
  // barriers: Q, dO, lse and delta loaded; stage s loaded; stage s free
  const uint32_t bar_q = base + L::BAR;
  const uint32_t bar_full = bar_q + 8, bar_free = bar_full + 8 * NST;

  const int bh = blockIdx.x;
  // the last q tile of a head first: causal tiles of most work lead
  const int q0 = (gridDim.y - 1 - blockIdx.y) * DQ_BQ;
  int n_kt = (sk + DQ_BK - 1) / DQ_BK;
  if (causal) n_kt = min(n_kt, (min(q0 + DQ_BQ, sq) - 1) / DQ_BK + 1);
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < NST; ++s) {
      mbar_init(bar_full + 8 * s, 1);
      mbar_init(bar_free + 8 * s, 2 * 128);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == 0) {
    // producer: one thread keeps the ring full
    regs_release<24>();
    if (threadIdx.x == 0) {
      tma_prefetch_map(&tk);
      tma_prefetch_map(&tv);
      mbar_expect_tx(bar_q, 2 * L::Q_TILE + 2 * DQ_VEC * 4);
#pragma unroll
      for (int h = 0; h < NH; ++h) {
        tma_load_3d(base + L::Q + h * DQ_BQ * 128, &tq, bar_q, h * 64, q0,
                    bh);
        tma_load_3d(base + L::DO + h * DQ_BQ * 128, &tdo, bar_q, h * 64, q0,
                    bh);
      }
      // lse and delta as flat (bh * sq) vectors: values past this head's
      // rows belong to the next head or are zeros, and are masked below
      const int v0 = (bh * sq + q0) & ~3;
      tma_load_1d(base + L::LSE, &tlse, bar_q, v0);
      tma_load_1d(base + L::DELTA, &tdelta, bar_q, v0);
      for (int kt = 0; kt < n_kt; ++kt) {
        const int s = kt % NST;
        const uint32_t full = bar_full + 8 * s;
        mbar_wait(bar_free + 8 * s, ((kt / NST) & 1) ^ 1);
        mbar_expect_tx(full, 2 * L::KV_TILE);
#pragma unroll
        for (int h = 0; h < NH; ++h) {
          tma_load_3d(base + L::K(s) + h * DQ_BK * 128, &tk, full, h * 64,
                      kt * DQ_BK, bh);
          tma_load_3d(base + L::V(s) + h * DQ_BK * 128, &tv, full, h * 64,
                      kt * DQ_BK, bh);
        }
      }
    }
  } else {
    // consumers: warpgroup g owns q rows q0 + 64g .. q0 + 64g + 63. The
    // products S_j = Q K_j^T and dP_j = dO V_j^T are issued together with
    // dQ += dS_(j-1) K_(j-1), so P_j is computed while dP_j and that dQ
    // product are on the tensor cores
    regs_claim<240>();
    constexpr int NO = D / 2;   // dQ registers: 64 x D / 128
    const int g = wg - 1;
    const int t = threadIdx.x % 128;
    const int lane = t % 32;
    const int cq = 2 * (lane % 4);
    const int r0 = q0 + 64 * g;                  // the warpgroup's rows
    const int row0 = r0 + 16 * (t / 32) + lane / 4;
    const int row1 = row0 + 8;
    const float scale_log2 = scale * LOG2E;
    // the KV tiles this warpgroup's rows see, and the first that needs
    // the masks (on the Sk edge, crossing the diagonal of its first row,
    // or any tile where its rows pass S); every later one does too
    int n_own = 0;
    if (r0 < sq) {
      n_own = (sk + DQ_BK - 1) / DQ_BK;
      if (causal) n_own = min(n_own, (min(r0 + 64, sq) - 1) / DQ_BK + 1);
    }
    int kt_edge = sk / DQ_BK;
    if (causal) kt_edge = min(kt_edge, (r0 + 1) / DQ_BK);
    if (r0 + 64 > sq) kt_edge = 0;
    float acc[NO], sc[32], dp[32];
    uint32_t da[DQ_BK / 16][4];   // dS rounded to bf16: the A operand
#pragma unroll
    for (int i = 0; i < NO; ++i) acc[i] = 0.f;
    const uint32_t qa = base + L::Q + g * 64 * 128;
    const uint32_t oa = base + L::DO + g * 64 * 128;

    mbar_wait(bar_q, 0);
    // the block's first row lies 0-3 floats into the lse and delta boxes
    const int v_off = ((bh * sq + q0) & 3) - q0;
    const float* lse_s = reinterpret_cast<const float*>(gbase + L::LSE);
    const float* delta_s = reinterpret_cast<const float*>(gbase + L::DELTA);
    const float nl0 = -lse_s[row0 + v_off] * LOG2E;
    const float nl1 = -lse_s[row1 + v_off] * LOG2E;
    const float dl0 = delta_s[row0 + v_off], dl1 = delta_s[row1 + v_off];

    // S = Q K^T and dP = dO V^T of the tile in stage s, all K-major; the
    // first k-step of each overwrites its accumulator
    auto issue_sdp = [&](int s) {
      const uint32_t ks = base + L::K(s), vs = base + L::V(s);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss(sc,
                 kmajor_desc(qa + (kk / 4) * DQ_BQ * 128 + (kk % 4) * 32),
                 kmajor_desc(ks + (kk / 4) * DQ_BK * 128 + (kk % 4) * 32),
                 kk > 0);
      wgmma_commit();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss(dp,
                 kmajor_desc(oa + (kk / 4) * DQ_BQ * 128 + (kk % 4) * 32),
                 kmajor_desc(vs + (kk / 4) * DQ_BK * 128 + (kk % 4) * 32),
                 kk > 0);
      wgmma_commit();
    };
    // dQ += dS K of the tile in stage s: dS from registers, K MN-major
    // (key-major in memory)
    auto issue_dq = [&](int s) {
      const uint32_t ks = base + L::K(s);
#pragma unroll
      for (int kk = 0; kk < DQ_BK / 16; ++kk)
        wgmma_rs(acc, da[kk], mnmajor_desc(ks + kk * 16 * 128, DQ_BK));
      wgmma_commit();
    };
    // dS = P (dP - delta) scale in place of dP
    auto grads = [&]() {
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          dp[4 * j + e] = sc[4 * j + e] *
                          (dp[4 * j + e] - ((e & 2) ? dl1 : dl0)) * scale;
    };
    // dS rounded to bf16, as the TPU kernel rounds it to k's dtype
    auto to_a = [&]() {
#pragma unroll
      for (int kk = 0; kk < DQ_BK / 16; ++kk)
        c_to_a(da[kk], &dp[8 * kk], &dp[8 * kk + 4]);
    };

    if (n_own > 0) {
      mbar_wait(bar_full, 0);
      wgmma_fence();
      issue_sdp(0);
      wgmma_wait<0>();
      fence_regs(sc);
      fence_regs(dp);
      if (kt_edge == 0)
        dq_probs<true>(sc, 0, sq, sk, causal, row0, row1, cq, scale_log2,
                       nl0, nl1);
      else
        dq_probs<false>(sc, 0, sq, sk, causal, row0, row1, cq, scale_log2,
                        nl0, nl1);
      grads();
      to_a();

      // tiles 1 .. n_own - 1, those without masks first: no branch lies
      // between a product and its wait, so ptxas keeps the three products
      // of a step in flight together
      auto step = [&](int kt, auto edge_tile) {
        constexpr bool EDGE = decltype(edge_tile)::value;
        const int s = kt % NST, sp = (kt - 1) % NST;
        fence_regs(acc);
        fence_regs(da);
        mbar_wait(bar_full + 8 * s, (kt / NST) & 1);
        wgmma_fence();
        issue_sdp(s);
        issue_dq(sp);
        wgmma_wait<2>();                   // S of this tile is in
        fence_regs(sc);
        dq_probs<EDGE>(sc, kt * DQ_BK, sq, sk, causal, row0, row1, cq,
                       scale_log2, nl0, nl1);
        wgmma_wait<1>();                   // and dP
        fence_regs(dp);
        grads();
        wgmma_wait<0>();                   // and dQ of the previous tile
        fence_regs(acc);
        mbar_arrive(bar_free + 8 * sp);    // K and V of that stage are read
        to_a();
      };
      const int mid = max(1, min(kt_edge, n_own));
      for (int kt = 1; kt < mid; ++kt) step(kt, std::false_type());
      for (int kt = mid; kt < n_own; ++kt) step(kt, std::true_type());
      // the last tile's dQ product
      {
        const int sp = (n_own - 1) % NST;
        fence_regs(acc);
        fence_regs(da);
        wgmma_fence();
        issue_dq(sp);
        wgmma_wait<0>();
        fence_regs(acc);
        mbar_arrive(bar_free + 8 * sp);
      }
    }
    // tiles loaded for the other warpgroup's rows alone (the causal
    // diagonal): waited for and released, so the ring's phases stay in
    // step
    for (int kt = n_own; kt < n_kt; ++kt) {
      mbar_wait(bar_full + 8 * (kt % NST), (kt / NST) & 1);
      mbar_arrive(bar_free + 8 * (kt % NST));
    }

#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = h ? row1 : row0;
      if (row >= sq) continue;
      __nv_bfloat16* out = dq + (size_t(bh) * sq + row) * D;
#pragma unroll
      for (int j = 0; j < NO / 4; ++j)
        *reinterpret_cast<uint32_t*>(out + 8 * j + cq) =
            pack_bf16(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
    }
  }
}

template <int D>
int launch_dq_bf16_wgmma(const __nv_bfloat16* q, const __nv_bfloat16* k,
                         const __nv_bfloat16* v, const __nv_bfloat16* dout,
                         const float* lse, const float* delta,
                         __nv_bfloat16* dq, int bh, int sq, int sk,
                         float scale, int causal, cudaStream_t stream) {
  alignas(64) CUtensorMap tq, tk, tv, tdo, tlse, tdelta;
  int err = map_heads_bf16(&tq, q, bh, sq, D, DQ_BQ);
  if (!err) err = map_heads_bf16(&tk, k, bh, sk, D, DQ_BK);
  if (!err) err = map_heads_bf16(&tv, v, bh, sk, D, DQ_BK);
  if (!err) err = map_heads_bf16(&tdo, dout, bh, sq, D, DQ_BQ);
  if (!err) err = map_vector_f32(&tlse, lse, size_t(bh) * sq, DQ_VEC);
  if (!err) err = map_vector_f32(&tdelta, delta, size_t(bh) * sq, DQ_VEC);
  if (err) return err;
  const size_t smem = DqSmem<D>::BYTES;
  cudaError_t cerr = cudaFuncSetAttribute(
      fa_bwd_dq_bf16_wgmma<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      int(smem));
  if (cerr != cudaSuccess) return int(cerr);
  const dim3 grid(bh, (sq + DQ_BQ - 1) / DQ_BQ);
  fa_bwd_dq_bf16_wgmma<D><<<grid, WG_THREADS, smem, stream>>>(
      tq, tk, tv, tdo, tlse, tdelta, dq, sq, sk, scale, causal);
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
  // D 64 and 128 (the models' head dims) on wgmma + TMA; D 16 and 32 on
  // the mma.sync kernel, chosen by shape alone
#define CALL(LAUNCH, D)                                                      \
  LAUNCH<D>(static_cast<const T*>(q), static_cast<const T*>(k),             \
            static_cast<const T*>(v), static_cast<const T*>(dout),          \
            static_cast<const float*>(lse), static_cast<const float*>(delta), \
            static_cast<T*>(dq), bh, sq, sk, scale, causal,                 \
            static_cast<cudaStream_t>(stream))
  switch (d) {
    case 16: return CALL(launch_dq_bf16, 16);
    case 32: return CALL(launch_dq_bf16, 32);
    case 64: return CALL(launch_dq_bf16_wgmma, 64);
    case 128: return CALL(launch_dq_bf16_wgmma, 128);
    default: return int(cudaErrorInvalidValue);
  }
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
  // D 64 and 128 (the models' head dims) on wgmma + TMA; D 16 and 32 on
  // the mma.sync kernel, chosen by shape alone
#define CALL(LAUNCH, D)                                                      \
  LAUNCH<D>(static_cast<const T*>(q), static_cast<const T*>(k),             \
            static_cast<const T*>(v), static_cast<const T*>(dout),          \
            static_cast<const float*>(lse), static_cast<const float*>(delta), \
            static_cast<T*>(dk), static_cast<T*>(dv), bh, sq, sk, scale,    \
            causal, static_cast<cudaStream_t>(stream))
  switch (d) {
    case 16: return CALL(launch_dkv_bf16, 16);
    case 32: return CALL(launch_dkv_bf16, 32);
    case 64: return CALL(launch_dkv_bf16_wgmma, 64);
    case 128: return CALL(launch_dkv_bf16_wgmma, 128);
    default: return int(cudaErrorInvalidValue);
  }
#undef CALL
}

const char* mxt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
