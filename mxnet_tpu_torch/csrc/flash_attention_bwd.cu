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
// float32 (fa_bwd_dq_f32_tf32x3, fa_bwd_dkv_f32_tf32x3: training with amp
// off, the reference's default). At the training shape in float32 the
// two do 51.6 and 68.8 GFLOP on 337 and 404 MB: 0.770 and 1.027 ms on
// float32 FMAs (67 TFLOP/s), so the FMA kernels they replace were bound by
// arithmetic. They run on the tensor cores instead, with the forward
// fa_fwd_f32_tf32x3's arithmetic (flash_attention_common.cuh):
//   * 3xTF32 on mma.sync.m16n8k8: every operand x is split in registers
//     into big = tf32(x) (cvt.rna) and small = x - big, and each product
//     is small * big + big * small + big * big in float32, which keeps
//     float32's accuracy (a single tf32 pass keeps about three decimal
//     digits). Every product runs so: S = Q K^T, dP = dO V^T, dQ += dS K,
//     dV += P^T dO, dK += dS^T Q. The bound is max(bytes at 3.35 TB/s,
//     3 x flops at 495 TFLOP/s): 0.313 and 0.417 ms at the training shape;
//   * wgmma is no route: its tf32 form reads shared-memory operands
//     K-major only, and each kernel multiplies both by a tile and by its
//     transpose (dQ: K in S = Q K^T and in dS K);
//   * dQ: one block of 8 warps per (bh, 64-row q tile); K and V tiles
//     come through a two-stage cp.async ring (one stage of 32 keys at
//     D 256). As in the forward, the block splits each KV tile's keys
//     between its two halves of 4 warps (16 q rows each), so every
//     warp's dependent chains are those of half a tile; dQ being a plain
//     sum over keys, the halves' sums are added through shared memory at
//     the end. S's and dP's small-term products accumulate apart from
//     big * big, which halves those chains again;
//   * dK/dV: one block of 8 warps per (bh, 64-key tile) holds K and V and
//     walks the q tiles, which come with their lse and delta (4-byte
//     cp.async: a head's rows need not start 16-byte aligned) through a
//     two-stage ring. Warp w owns keys 16 (w % 4) and computes S^T = K Q^T
//     and dP^T = V dO^T for them. dK and dV of 16 keys take 2 D registers
//     a thread: up to D 128 the two halves of the block take the two
//     halves of each 32-row q tile and are added at the end; at D 256
//     (DSPLIT) each half takes all 16 rows of a q tile and owns half of D
//     of both sums, computing the same S^T and dP^T (1.5 times the flops
//     of the split above). Up to D 128 each Q and dO tile is split into
//     its tf32 halves once, as it lands, instead of by each of the four
//     warps that read it (PERF.md §6 has the times with and without);
//   * P and dS never leave registers: the m16n8k8 C fragment becomes the
//     A fragment of the next product with no shuffle, by ordering each
//     k-step's keys (q rows for dK/dV) 2t, 2t + 1 and reading the B rows
//     to match (c_to_a_tf32, split_b_cols). Shared rows are D + 4 floats
//     apart, which puts every fragment load in 32 different banks;
//   * P = exp(S scale - lse) is rebuilt from the forward's lse in float32
//     (expf, as the TPU kernel); the masks (keys past Sk, q rows past S,
//     keys above the diagonal) run only on tiles that cross an edge, and
//     set P to 0; causal tiles wholly above the diagonal are never
//     loaded; every output tile has one owner block, no atomics.
//
// bfloat16 (the training path under amp). fa_bwd_dq_bf16 and
// fa_bwd_dkv_bf16, for head dims 16, 32 and 256, run on mma.sync m16n8k16
// (bf16 in, float32 accumulate; see flash_attention_common.cuh): 4 warps
// per block, each owning 16 rows (q rows for dQ, keys for dK/dV); S and dP
// land in registers in the accumulator layout; P and dS are rounded to
// bf16 (as the TPU kernels round them to the operands' dtype) and reused
// in registers as the A operand of the next product; dK/dV walks q tiles
// of 32 rows in the transposed orientation S^T = K Q^T, so the key rows
// stay with their warp. Loads are synchronous. At D 256 the dQ kernel
// takes 32-key tiles and the dK/dV kernel gives each 16-key strip two
// warps, each owning half of D of dK and dV (32 keys a block), so that the
// float32 sums fit in registers; speed at D 256 is no aim yet.
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

// ----------------------------------------------- float32, 3xTF32 on mma.sync

// dQ: shared memory of a block, its 64 q rows of Q and dO and a ring of NST
// K and V tiles of 2 KH keys, rows D + 4 floats apart.
template <int D, int KH, int NST>
constexpr size_t dq_f32_smem_bytes() {
  return sizeof(float) * size_t(2 * 64 + NST * 2 * 2 * KH) * (D + 4);
}

// The dQ key tile: 64 keys in a two-stage ring up to D 128 (198 KB at
// D 128); at D 256, where dQ takes 128 registers a thread, 32 keys in one
// stage (195 KB).
template <int D>
constexpr int dq_f32_kh() {
  return D > 128 ? 16 : 32;
}
template <int D>
constexpr int dq_f32_stages() {
  return D > 128 ? 1 : 2;
}

// dQ: one block of 8 warps per (bh, 64-row q tile). Warp w owns q rows
// 16 (w % 4) .. + 15 and, of each KV tile of 2 KH keys, keys KH (w / 4) ..
// + KH - 1: each half of the block sums dQ over its keys, and the halves
// are added through shared memory at the end (dQ is a plain sum over keys,
// P being exact from lse), so each warp's dependent chains are half the
// block's.
template <int D, int KH, int NST>
__global__ void __launch_bounds__(F32_THREADS, 1)
fa_bwd_dq_f32_tf32x3(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v,
                     const float* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, float* __restrict__ dq,
                     int sq, int sk, float scale, int causal) {
  constexpr int ROWS = 64;          // q rows per block
  constexpr int BKT = 2 * KH;       // keys per KV tile
  constexpr int SX = D + 4;         // shared row stride (floats)
  constexpr int KS = D / 8;         // k-steps of S and dP
  constexpr int DN = D / 8;         // 8-column tiles of dQ
  constexpr int NJ = KH / 8;        // 8-key tiles of a warp's keys
  static_assert(2 * NST * BKT >= ROWS, "the K/V ring holds the merge's dQ");
  extern __shared__ __align__(16) float f32_dq_smem[];
  float* Qs = f32_dq_smem;              // ROWS x SX
  float* dOs = Qs + ROWS * SX;          // ROWS x SX
  float* Ks = dOs + ROWS * SX;          // NST x BKT x SX
  float* Vs = Ks + NST * BKT * SX;      // NST x BKT x SX

  const int bh = blockIdx.x;
  // the last q tile of a head first: causal tiles of most work lead
  const int q0 = (gridDim.y - 1 - blockIdx.y) * ROWS;
  const int warp = threadIdx.x / 32;
  const int half = warp / 4;                     // the warp's KH keys
  const int g = (threadIdx.x % 32) / 4;
  const int t = threadIdx.x % 4;
  const int r0 = (warp % 4) * 16;                // the warp's rows
  const int row[2] = {q0 + r0 + g, q0 + r0 + g + 8};
  const float* kb = k + size_t(bh) * sk * D;
  const float* vb = v + size_t(bh) * sk * D;

  int n_kt = (sk + BKT - 1) / BKT;
  if (causal) n_kt = min(n_kt, (min(q0 + ROWS, sq) - 1) / BKT + 1);

  auto stage_kv = [&](int kt) {
    const int st = kt % NST;
    stage_f32<D, SX>(Ks + st * BKT * SX, kb, kt * BKT, BKT, sk);
    stage_f32<D, SX>(Vs + st * BKT * SX, vb, kt * BKT, BKT, sk);
    cp_async_commit();
  };
  // Q and dO join the first tile's group
  stage_f32<D, SX>(Qs, q + size_t(bh) * sq * D, q0, ROWS, sq);
  stage_f32<D, SX>(dOs, dout + size_t(bh) * sq * D, q0, ROWS, sq);
  if (NST > 1) stage_kv(0);

  // lse and delta of the thread's two rows; rows past S are computed on
  // zeros and never written
  float lr[2], dr[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    lr[h] = row[h] < sq ? lse[size_t(bh) * sq + row[h]] : 0.f;
    dr[h] = row[h] < sq ? delta[size_t(bh) * sq + row[h]] : 0.f;
  }
  float acc[DN][4];
#pragma unroll
  for (int dn = 0; dn < DN; ++dn)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[dn][e] = 0.f;

  for (int kt = 0; kt < n_kt; ++kt) {
    if (NST > 1) {
      if (kt + 1 < n_kt) {
        stage_kv(kt + 1);   // into the stage read one tile ago
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
    } else {
      stage_kv(kt);
      cp_async_wait<0>();
    }
    __syncthreads();   // this tile (and Q, dO) are in for every thread
    const int k0 = kt * BKT + half * KH;   // the warp's first key
    const float* Kt = Ks + (kt % NST) * BKT * SX + half * KH * SX;
    const float* Vt = Vs + (kt % NST) * BKT * SX + half * KH * SX;

    // S = Q K^T and dP = dO V^T, the small-term products apart
    float s[NJ][4], s2[NJ][4], dp[NJ][4], dp2[NJ][4];
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = s2[j][e] = dp[j][e] = dp2[j][e] = 0.f;
#pragma unroll 2
    for (int kk = 0; kk < KS; ++kk) {
      uint32_t qb[4], qs[4], ob[4], os[4];
      split_a<SX>(qb, qs, Qs, r0, kk * 8, g, t);
      split_a<SX>(ob, os, dOs, r0, kk * 8, g, t);
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        uint32_t bb[2], bs[2];
        split_b_rows<SX>(bb, bs, Kt, j * 8, kk * 8, g, t);
        mma_3xtf32_2(s[j], s2[j], qb, qs, bb, bs);
        split_b_rows<SX>(bb, bs, Vt, j * 8, kk * 8, g, t);
        mma_3xtf32_2(dp[j], dp2[j], ob, os, bb, bs);
      }
    }

    // dS = P (dP - delta) scale in place of S, P = exp(S scale - lse); the
    // masks (keys past Sk, above the diagonal) only on tiles that need them
    const bool edge =
        k0 + KH > sk || (causal && k0 + KH - 1 > q0 + r0);
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e >> 1;
        float p = expf((s[j][e] + s2[j][e]) * scale - lr[h]);
        if (edge) {
          const int kp = k0 + j * 8 + 2 * t + (e & 1);
          if (kp >= sk || (causal && row[h] < kp)) p = 0.f;
        }
        s[j][e] = p * (dp[j][e] + dp2[j][e] - dr[h]) * scale;
      }

    // dQ += dS K: dS's C fragment is the A fragment of a k-step whose keys
    // come in the order 2t, 2t + 1; K's rows are read to match
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      uint32_t ab[4], as[4];
      c_to_a_tf32(ab, as, s[j]);
#pragma unroll
      for (int dn = 0; dn < DN; ++dn) {
        uint32_t bb[2], bs[2];
        split_b_cols<SX>(bb, bs, Kt, j * 8, dn * 8, g, t);
        mma_3xtf32(acc[dn], ab, as, bb, bs);
      }
    }
    __syncthreads();   // this stage is read: the next load may land
  }

  // the second half hands its dQ over through shared memory (free now: no
  // load is in flight)
  float* xo = Ks;   // ROWS x SX
  if (half == 1) {
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int dn = 0; dn < DN; ++dn)
        *reinterpret_cast<float2*>(xo + (r0 + g + 8 * h) * SX + dn * 8 +
                                   2 * t) =
            make_float2(acc[dn][2 * h], acc[dn][2 * h + 1]);
  }
  __syncthreads();
  if (half == 1) return;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (row[h] >= sq) continue;
    float* out = dq + (size_t(bh) * sq + row[h]) * D;
#pragma unroll
    for (int dn = 0; dn < DN; ++dn) {
      const float2 x = *reinterpret_cast<const float2*>(
          xo + (r0 + g + 8 * h) * SX + dn * 8 + 2 * t);
      *reinterpret_cast<float2*>(out + dn * 8 + 2 * t) =
          make_float2(acc[dn][2 * h] + x.x, acc[dn][2 * h + 1] + x.y);
    }
  }
}

// dK/dV: shared memory of a block, its 64 keys of K and V and a two-stage
// ring of Q and dO tiles of QT rows (with their small halves up to D 128)
// and their lse and delta, rows D + 4 floats apart (199 KB at D 128,
// 195 KB at D 256).
template <int D, int QT>
constexpr size_t dkv_f32_smem_bytes() {
  return sizeof(float) * (size_t(2 * 64 + 2 * (D > 128 ? 2 : 4) * QT) *
                              (D + 4) +
                          size_t(2 * 2 * QT));
}

// The dK/dV q tile: 32 rows up to D 128 and 16 at D 256.
template <int D>
constexpr int dkv_f32_qt() {
  return D > 128 ? 16 : 32;
}

// dK and dV: one block of 8 warps per (bh, 64-key tile) walking the q
// tiles, which come with their lse and delta through a two-stage cp.async
// ring. Warp w owns keys 16 (w % 4) .. + 15 and computes the transposed
// products S^T = K Q^T and dP^T = V dO^T for its keys. Up to D 128 the two
// halves of the block (w / 4) take the first and second QT / 2 rows of
// each q tile, each half summing dK and dV over its rows, and the halves
// are added through shared memory at the end; each q tile's Q and dO are
// split into tf32 halves once, as they land (presplit_tile), since four
// warps read every value of them. At D 256 (DSPLIT) dK and dV of 16 keys
// would take 256 registers a thread: there the two halves take all QT
// rows, compute the same S^T and dP^T, and each owns half of the head dim
// of dK and dV; the split halves would not fit in shared memory, so each
// warp splits what it loads.
template <int D, int QT, bool DSPLIT>
__global__ void __launch_bounds__(F32_THREADS, 1)
fa_bwd_dkv_f32_tf32x3(const float* __restrict__ q,
                      const float* __restrict__ k,
                      const float* __restrict__ v,
                      const float* __restrict__ dout,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta,
                      float* __restrict__ dk, float* __restrict__ dv, int sq,
                      int sk, float scale, int causal) {
  constexpr int KEYS = 64;                   // keys per block
  constexpr int NST = 2;                     // q tiles in flight
  constexpr int SX = D + 4;                  // shared row stride (floats)
  constexpr int QW = DSPLIT ? QT : QT / 2;   // a warp's q rows of a tile
  constexpr int DW = DSPLIT ? D / 2 : D;     // a warp's columns of dK, dV
  constexpr int KS = D / 8;                  // k-steps of S^T and dP^T
  constexpr int DN = DW / 8;                 // 8-column tiles of dK, dV
  constexpr int NJ = QW / 8;                 // 8-row tiles of a warp's rows
  constexpr bool SPLIT = !DSPLIT;            // Q and dO split as they land
  constexpr int NT = SPLIT ? 4 : 2;          // tiles a stage: Q, dO (+ small)
  extern __shared__ __align__(16) float f32_dkv_smem[];
  float* Ks = f32_dkv_smem;             // KEYS x SX
  float* Vs = Ks + KEYS * SX;           // KEYS x SX
  float* ring = Vs + KEYS * SX;         // NST x NT x QT x SX
  float* ls = ring + NST * NT * QT * SX;   // NST x QT: lse
  float* ds = ls + NST * QT;               // NST x QT: delta
  // tile i of stage st: Q, dO, then the small halves of Q and dO
  auto tile = [&](int st, int i) { return ring + (st * NT + i) * QT * SX; };

  const int bh = blockIdx.x;
  const int k0 = blockIdx.y * KEYS;     // low key tiles (most work) first
  const int warp = threadIdx.x / 32;
  const int half = warp / 4;
  const int g = (threadIdx.x % 32) / 4;
  const int t = threadIdx.x % 4;
  const int r0 = (warp % 4) * 16;                // the warp's keys
  const int key[2] = {k0 + r0 + g, k0 + r0 + g + 8};
  const int qc = DSPLIT ? 0 : half * QW;         // its rows of a q tile
  const int dc = DSPLIT ? half * DW : 0;         // its columns of dK, dV
  const float* qb = q + size_t(bh) * sq * D;
  const float* dob = dout + size_t(bh) * sq * D;
  const float* lb = lse + size_t(bh) * sq;
  const float* db = delta + size_t(bh) * sq;

  const int n_qt = (sq + QT - 1) / QT;
  // causal: a q tile wholly before this key tile sees none of it
  const int qt0 = causal ? k0 / QT : 0;

  auto stage_q = [&](int qt) {
    const int st = (qt - qt0) % NST;
    stage_f32<D, SX>(tile(st, 0), qb, qt * QT, QT, sq);
    stage_f32<D, SX>(tile(st, 1), dob, qt * QT, QT, sq);
    // rows past S arrive as zeros, and their P is masked below
    for (int r = threadIdx.x; r < QT; r += F32_THREADS) {
      const int qp = qt * QT + r;
      const int n = qp < sq ? 4 : 0;
      cp_async4(ls + st * QT + r, lb + (n ? qp : 0), n);
      cp_async4(ds + st * QT + r, db + (n ? qp : 0), n);
    }
    cp_async_commit();
  };

  float acc_k[DN][4], acc_v[DN][4];
#pragma unroll
  for (int dn = 0; dn < DN; ++dn)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_k[dn][e] = acc_v[dn][e] = 0.f;

  // keys that no q row sees (causal, keys past S) keep dK = dV = 0
  if (qt0 < n_qt) {
    // K and V join the first q tile's group
    stage_f32<D, SX>(Ks, k + size_t(bh) * sk * D, k0, KEYS, sk);
    stage_f32<D, SX>(Vs, v + size_t(bh) * sk * D, k0, KEYS, sk);
    stage_q(qt0);
    for (int qt = qt0; qt < n_qt; ++qt) {
      if (qt + 1 < n_qt) {
        stage_q(qt + 1);   // into the stage read one tile ago
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();   // this tile (and K, V) are in for every thread
      const int st = (qt - qt0) % NST;
      if (SPLIT) {
        presplit_tile<D, SX>(tile(st, 0), tile(st, 2), QT);
        presplit_tile<D, SX>(tile(st, 1), tile(st, 3), QT);
        __syncthreads();
      }
      const int q0 = qt * QT + qc;                 // the warp's first row
      const float* Qt = tile(st, 0) + qc * SX;
      const float* Ot = tile(st, 1) + qc * SX;
      const float* Qsm = tile(st, SPLIT ? 2 : 0) + qc * SX;
      const float* Osm = tile(st, SPLIT ? 3 : 1) + qc * SX;
      const float* lt = ls + st * QT + qc;
      const float* dt = ds + st * QT + qc;
      // the split halves of B fragments of Q and dO, loaded or computed
      auto b_rows = [&](uint32_t (&bb)[2], uint32_t (&bs)[2], const float* x,
                        const float* xs, int n0, int k0) {
        if (SPLIT)
          load_b_rows_split<SX>(bb, bs, x, xs, n0, k0, g, t);
        else
          split_b_rows<SX>(bb, bs, x, n0, k0, g, t);
      };
      auto b_cols = [&](uint32_t (&bb)[2], uint32_t (&bs)[2], const float* x,
                        const float* xs, int k0, int n0) {
        if (SPLIT)
          load_b_cols_split<SX>(bb, bs, x, xs, k0, n0, g, t);
        else
          split_b_cols<SX>(bb, bs, x, k0, n0, g, t);
      };

      // S^T = K Q^T and dP^T = V dO^T (keys x q rows), the small-term
      // products apart
      float s[NJ][4], s2[NJ][4], dp[NJ][4], dp2[NJ][4];
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          s[j][e] = s2[j][e] = dp[j][e] = dp2[j][e] = 0.f;
#pragma unroll 2
      for (int kk = 0; kk < KS; ++kk) {
        uint32_t kb2[4], ks2[4], vb2[4], vs2[4];
        split_a<SX>(kb2, ks2, Ks, r0, kk * 8, g, t);
        split_a<SX>(vb2, vs2, Vs, r0, kk * 8, g, t);
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          uint32_t bb[2], bs[2];
          b_rows(bb, bs, Qt, Qsm, j * 8, kk * 8);
          mma_3xtf32_2(s[j], s2[j], kb2, ks2, bb, bs);
          b_rows(bb, bs, Ot, Osm, j * 8, kk * 8);
          mma_3xtf32_2(dp[j], dp2[j], vb2, vs2, bb, bs);
        }
      }

      // P^T in place of S^T, dS^T = P^T (dP^T - delta) scale in place of
      // dP^T; masks (q rows past S, keys past Sk, keys above the
      // diagonal) only on tiles that need them
      const bool edge = q0 + QW > sq || k0 + r0 + 16 > sk ||
                        (causal && q0 < k0 + r0 + 15);
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int h = e >> 1;
          const int c = j * 8 + 2 * t + (e & 1);
          float p = expf((s[j][e] + s2[j][e]) * scale - lt[c]);
          if (edge) {
            const int qp = q0 + c;
            if (qp >= sq || key[h] >= sk || (causal && qp < key[h])) p = 0.f;
          }
          s[j][e] = p;
          dp[j][e] = p * (dp[j][e] + dp2[j][e] - dt[c]) * scale;
        }

      // dV += P^T dO and dK += dS^T Q: P^T's and dS^T's C fragments are
      // the A fragments of k-steps whose q rows come in the order 2t,
      // 2t + 1; dO's and Q's rows are read to match
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        uint32_t pb[4], ps[4], sb[4], ss[4];
        c_to_a_tf32(pb, ps, s[j]);
        c_to_a_tf32(sb, ss, dp[j]);
#pragma unroll
        for (int dn = 0; dn < DN; ++dn) {
          uint32_t bb[2], bs[2];
          b_cols(bb, bs, Ot, Osm, j * 8, dc + dn * 8);
          mma_3xtf32(acc_v[dn], pb, ps, bb, bs);
          b_cols(bb, bs, Qt, Qsm, j * 8, dc + dn * 8);
          mma_3xtf32(acc_k[dn], sb, ss, bb, bs);
        }
      }
      __syncthreads();   // this stage is read: the next load may land
    }
  }

  if (!DSPLIT) {
    // the second half hands its sums over through K's and V's shared
    // memory (free now: no load is in flight)
    if (half == 1) {
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int dn = 0; dn < DN; ++dn) {
          const int off = (r0 + g + 8 * h) * SX + dn * 8 + 2 * t;
          *reinterpret_cast<float2*>(Ks + off) =
              make_float2(acc_k[dn][2 * h], acc_k[dn][2 * h + 1]);
          *reinterpret_cast<float2*>(Vs + off) =
              make_float2(acc_v[dn][2 * h], acc_v[dn][2 * h + 1]);
        }
    }
    __syncthreads();
    if (half == 1) return;
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int dn = 0; dn < DN; ++dn) {
        const int off = (r0 + g + 8 * h) * SX + dn * 8 + 2 * t;
        const float2 xk = *reinterpret_cast<const float2*>(Ks + off);
        const float2 xv = *reinterpret_cast<const float2*>(Vs + off);
        acc_k[dn][2 * h] += xk.x;
        acc_k[dn][2 * h + 1] += xk.y;
        acc_v[dn][2 * h] += xv.x;
        acc_v[dn][2 * h + 1] += xv.y;
      }
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (key[h] >= sk) continue;
    float* krow = dk + (size_t(bh) * sk + key[h]) * D + dc;
    float* vrow = dv + (size_t(bh) * sk + key[h]) * D + dc;
#pragma unroll
    for (int dn = 0; dn < DN; ++dn) {
      *reinterpret_cast<float2*>(krow + dn * 8 + 2 * t) =
          make_float2(acc_k[dn][2 * h], acc_k[dn][2 * h + 1]);
      *reinterpret_cast<float2*>(vrow + dn * 8 + 2 * t) =
          make_float2(acc_v[dn][2 * h], acc_v[dn][2 * h + 1]);
    }
  }
}

template <int D>
int launch_dq_f32(const float* q, const float* k, const float* v,
                  const float* dout, const float* lse, const float* delta,
                  float* dq, int bh, int sq, int sk, float scale, int causal,
                  cudaStream_t stream) {
  constexpr int KH = dq_f32_kh<D>(), NST = dq_f32_stages<D>();
  const auto kernel = fa_bwd_dq_f32_tf32x3<D, KH, NST>;
  const size_t smem = dq_f32_smem_bytes<D, KH, NST>();
  const cudaError_t err = set_max_shared(kernel, smem);
  if (err != cudaSuccess) return int(err);
  const dim3 grid(bh, (sq + 63) / 64);
  kernel<<<grid, F32_THREADS, smem, stream>>>(q, k, v, dout, lse, delta, dq,
                                              sq, sk, scale, causal);
  return int(cudaGetLastError());
}

template <int D>
int launch_dkv_f32(const float* q, const float* k, const float* v,
                   const float* dout, const float* lse, const float* delta,
                   float* dk, float* dv, int bh, int sq, int sk, float scale,
                   int causal, cudaStream_t stream) {
  constexpr int QT = dkv_f32_qt<D>();
  const auto kernel = fa_bwd_dkv_f32_tf32x3<D, QT, (D > 128)>;
  const size_t smem = dkv_f32_smem_bytes<D, QT>();
  const cudaError_t err = set_max_shared(kernel, smem);
  if (err != cudaSuccess) return int(err);
  const dim3 grid(bh, (sk + 63) / 64);
  kernel<<<grid, F32_THREADS, smem, stream>>>(q, k, v, dout, lse, delta, dk,
                                              dv, sq, sk, scale, causal);
  return int(cudaGetLastError());
}

// ------------------ bfloat16, mma.sync (dQ, dK/dV at head dims 16, 32, 256)

constexpr int QT = 32;   // q rows per tile of the bf16 dK/dV kernel

// Keys per KV tile of the bf16 dQ kernel: 64, or 32 at D 256, where dQ
// takes 128 registers a thread beside S and dP.
template <int D>
__host__ __device__ constexpr int dq_bf16_keys() {
  return D > 128 ? 32 : BK;
}

// Warps of the bf16 dK/dV kernel that share a 16-key strip, each owning
// D / n columns of dK and dV: 1, or 2 at D 256, where dK and dV of 16 keys
// would take 256 registers a thread (both warps compute the strip's S^T
// and dP^T).
template <int D>
__host__ __device__ constexpr int dkv_bf16_split() {
  return D > 128 ? 2 : 1;
}

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
  constexpr int TK = dq_bf16_keys<D>();   // keys per KV tile
  constexpr int NJ = TK / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* dOs = Qs + BQ * SX;
  __nv_bfloat16* Ks = dOs + BQ * SX;
  __nv_bfloat16* Vs = Ks + TK * SX;

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

  int n_kt = (sk + TK - 1) / TK;
  if (causal) {
    const int last_row = min(q0 + BQ, sq) - 1;
    n_kt = min(n_kt, last_row / TK + 1);
  }

  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * TK;
    __syncthreads();   // the previous tile's K and V reads are done
    stage_bf16<D>(Ks, kb, k0, TK, sk);
    stage_bf16<D>(Vs, vb, k0, TK, sk);
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
    for (int kk = 0; kk < TK / 16; ++kk) {
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

// dK and dV: one block of 4 warps per (bh, 64-key tile; 32 keys at
// D 256); q tiles of 32 rows walked in a loop; each warp owns 16 keys and
// D / dkv_bf16_split<D>() columns of their dK and dV.
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
  constexpr int NS = dkv_bf16_split<D>();   // warps sharing a key strip
  constexpr int KEYS = BK / NS;             // keys per block
  constexpr int DN = D / 8 / NS;            // the warp's 8-column tiles
  constexpr int NJ = QT / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* Vs = Ks + KEYS * SX;
  __nv_bfloat16* Qs = Vs + KEYS * SX;
  __nv_bfloat16* dOs = Qs + QT * SX;
  float* lse_s = reinterpret_cast<float*>(dOs + QT * SX);
  float* delta_s = lse_s + QT;

  const int bh = blockIdx.y;
  const int k0 = blockIdx.x * KEYS;
  const int warp = threadIdx.x / 32;
  const int g = (threadIdx.x % 32) / 4;
  const int t = threadIdx.x % 4;
  const int r0 = (warp % (4 / NS)) * 16;      // the warp's keys
  const int dc = (warp / (4 / NS)) * (D / NS);   // its columns of dK, dV
  const int key[2] = {k0 + r0 + g, k0 + r0 + g + 8};
  const __nv_bfloat16* qb = q + size_t(bh) * sq * D;
  const __nv_bfloat16* dob = dout + size_t(bh) * sq * D;

  stage_bf16<D>(Ks, k + size_t(bh) * sk * D, k0, KEYS, sk);
  stage_bf16<D>(Vs, v + size_t(bh) * sk * D, k0, KEYS, sk);

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
        load_b_cols<SX>(b0, b1, dOs, kk * 16, dc + dn * 8, g, t);
        mma_bf16(acc_v[dn], pa, b0, b1);
        load_b_cols<SX>(b0, b1, Qs, kk * 16, dc + dn * 8, g, t);
        mma_bf16(acc_k[dn], da, b0, b1);
      }
    }
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (key[h] >= sk) continue;
    __nv_bfloat16* krow = dk + (size_t(bh) * sk + key[h]) * D + dc;
    __nv_bfloat16* vrow = dv + (size_t(bh) * sk + key[h]) * D + dc;
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
  const size_t smem = sizeof(__nv_bfloat16) *
                      size_t(2 * BQ + 2 * dq_bf16_keys<D>()) * (D + 8);
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
  constexpr int KEYS = BK / dkv_bf16_split<D>();
  const size_t smem = sizeof(__nv_bfloat16) * size_t(2 * KEYS + 2 * QT) *
                      (D + 8) + sizeof(float) * 2 * QT;
  cudaError_t err = cudaFuncSetAttribute(
      fa_bwd_dkv_bf16<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      int(smem));
  if (err != cudaSuccess) return int(err);
  const dim3 grid((sk + KEYS - 1) / KEYS, bh);
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
    case 256: return CALL(256);                      \
    default: return int(cudaErrorInvalidValue);      \
  }

}  // namespace

extern "C" {

// q and dout (bh, sq, d), k and v (bh, sk, d), dq (bh, sq, d), dk and dv
// (bh, sk, d): contiguous, of the entry point's type, 16-byte aligned;
// lse and delta (bh, sq) float32; all on the current device.
// d in {16, 32, 64, 128, 256}.
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
  // D 64 and 128 (the models' head dims) on wgmma + TMA; D 16, 32 and 256
  // on the mma.sync kernel, chosen by shape alone
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
    case 256: return CALL(launch_dq_bf16, 256);
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
  // D 64 and 128 (the models' head dims) on wgmma + TMA; D 16, 32 and 256
  // on the mma.sync kernel, chosen by shape alone
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
    case 256: return CALL(launch_dkv_bf16, 256);
    default: return int(cudaErrorInvalidValue);
  }
#undef CALL
}

const char* mxt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
