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
// float32 (the serving path's prefill, and training with amp off):
// fa_fwd_f32_tf32x3 at every head dim. At the prefill shapes (BH = 16 heads, D = 128, S the prompt bucket,
// up to 1024, causal) the function does 4 S^2 D / 2 flops per head against
// 16 S D bytes of q, k, v and o: about 64 flops per byte at S = 1024. On
// float32 FMAs (67 TFLOP/s) that is bound by arithmetic (the first kernel,
// on FMAs, reached 21% of that bound); on the tensor cores it need not be:
//   * the arithmetic is 3xTF32 on mma.sync.m16n8k8 (tf32 in, float32
//     accumulate): every operand x is split in registers into big =
//     tf32(x) (cvt.rna) and small = x - big, which the tensor cores read
//     truncated to tf32, and each product is small * big + big * small +
//     big * big, the small terms first. What is dropped (small * small,
//     the truncation of small) is about 2^-21 of a term, of float32's
//     order; a single TF32 pass keeps about three decimal
//     digits and would change the numbers. Three tf32 products cost 3
//     times the flops at 495 TFLOP/s: the bound is max(bytes at 3.35
//     TB/s, 3 x flops at 495 TFLOP/s);
//   * wgmma is no route here: its tf32 form reads shared-memory operands
//     K-major only (no transpose bit for 32-bit types), and V lies
//     key-major, so P V would need a transposed copy of V, and the small
//     halves tiles of their own. mma.sync fragments are loaded by each
//     thread in any layout and split in registers;
//   * one block of 8 warps per (bh, 64-row q tile). A warp's products form
//     long dependent chains (each S accumulator takes D / 8 k-steps of
//     three products), so a block runs at the latency of its chains, not
//     at the SM's rate: a 4-warp block took about as long per KV tile
//     alone on an SM as beside another. So the block splits the keys
//     instead of the rows: warps 0-3 and 4-7 own the same 16-row slices
//     and take the first and second 32 keys of every 64-key tile, each
//     half with its own online softmax (m, l and O in registers), merged
//     through shared memory at the end. Each warp's chain per tile is
//     then that of a 32-key tile, and a short prompt's few q tiles still
//     keep 8 warps busy on each SM they reach. The two small-term
//     products of Q K^T accumulate apart from big * big, which halves
//     that product's chain again;
//   * Q is read once; K and V tiles of 64 keys come through a two-stage
//     cp.async ring, so the next tile loads while this one computes;
//     shared rows are D + 4 floats, which puts every fragment load of Q,
//     K and V in 32 different banks. 165 KB at D 128: one block (8 warps)
//     per SM, as many warps as two 4-warp blocks of 99 KB, which ran
//     slower. At D 256, where O takes 128 registers a thread, the tiles
//     are 32 keys (16 a warp; 195 KB);
//   * P never leaves registers: the m16n8k8 C fragment does not map onto
//     the A fragment (a thread holds P's columns 2t, 2t + 1, the A operand
//     wants t, t + 4), but a k-step may take its 8 keys in any order, so
//     P V's k-step orders them 2t, 2t + 1 and reads V's rows to match;
//   * a half that has seen only masked keys of a row (the causal diagonal)
//     holds m = -1e30 and a meaningless l and O; the first real key, in
//     its own walk or in the merge, scales them by exp(-1e30 - m) = 0;
//   * causal KV tiles wholly above the diagonal are never loaded, and the
//     last q tile of each head is scheduled first;
//   * unchanged semantics: the finite -1e30 causal mask, kp >= Sk
//     excluded, O / max(l, 1e-37) and lse = m + log(max(l, 1e-37)) in
//     float32, with expf as in the TPU kernel.
//
// bfloat16 (the training path under amp). At the training shape (BH 128,
// S 1024, D 128, causal) the function does 34.4 GFLOP on 134.7 MB: 0.035
// ms at the bf16 tensor cores' 989 TFLOP/s against 0.040 ms at 3.35
// TB/s, so it sits at the card's balance point and both bound it. For
// head dims 64 and 128 (the models') it runs fa_fwd_bf16_wgmma, built for
// this card rather than carried over from the TPU kernel:
//   * a block of three warpgroups per (bh, 128-row q tile): a producer
//     whose one elected thread issues every TMA load and gives its
//     registers back (setmaxnreg 24), and two consumers of 64 q rows each
//     that take them (setmaxnreg 240). KV tiles are 128 keys; ptxas gives
//     the block 168 registers a thread at launch and spills nothing;
//   * shared memory holds the Q tile, loaded once, and a three-stage ring
//     of K and V tiles (224 KB at D 128), each stage with a "loaded"
//     mbarrier for K, one for V, and a "free" one that all 256 consumer
//     threads arrive on once both products of the stage have completed;
//   * S = Q K^T is a wgmma with both operands in shared memory, K-major;
//     the online softmax runs on its accumulator registers (the 4 threads
//     of a quad share a row: two shuffles), in log2 units with scale *
//     log2 e folded into one multiply and exp2f;
//   * P, rounded to bf16 (as the TPU kernel rounds P to V's dtype), goes
//     from the accumulator layout straight into the register A operand of
//     O += P V (c_to_a); V is read from shared memory MN-major, with the
//     transpose bit set, because it lies key-major;
//   * within a warpgroup, S_j = Q K_j^T and O += P_(j-1) V_(j-1) are
//     issued together, and the softmax of tile j runs while the second is
//     on the tensor cores; O is rescaled once that product has completed.
//     ptxas keeps the two in flight only if no branch lies between a
//     product and its wait (else it serialises every wgmma, warning
//     C7514): the last tile's P V is peeled off the loop, and the tiles
//     that need masks run in a loop of their own (PERF.md has the times
//     with and without the overlap);
//   * causal: KV tiles wholly above the diagonal are never loaded, the
//     mask is evaluated only on tiles that cross the diagonal or the Sk
//     edge, and the last q tile of each head is scheduled first, so the
//     longest rows do not land in the last wave;
//   * O / max(l, 1e-37) is written as bf16 from registers (rows past S are
//     not written), lse = m + log(max(l, 1e-37)) as float32.
// Where trouble lay, and what the design does about it:
//   1. swizzle at D 128: a 128-byte swizzle row holds 64 bf16 values, so
//      a row of 128 is two TMA boxes of 64 columns, stored as two halves;
//      the K-major descriptors step 32 bytes per k-step within a half and
//      jump to the other half at k-step 4, the MN-major ones reach the
//      second half through their leading byte offset
//      (flash_attention_sm90.cuh). A mismatch would permute results
//      silently: chip_smoke.py's comparison and edge sweep check it;
//   2. TMA's zero fill is no mask: keys past Sk arrive as zero rows, whose
//      score is 0, so the kp >= sk mask stays on the edge tile; q rows
//      past S are computed on zeros and never written;
//   3. tensor maps are encoded on the host for every call, through the
//      runtime's driver entry point (no -lcuda), as rank-3 (D, S, BH)
//      maps so that a box never reaches into the next head, and passed as
//      __grid_constant__ parameters; the wrapper keeps bases 16-byte
//      aligned, and D >= 16 keeps row strides a multiple of 16 bytes;
//   4. wgmma ordering: the registers of P and of the rescaled O are pinned
//      before a wgmma.fence that precedes the product reading them; every
//      accumulator is read only after commit and wait; no thread writes
//      an operand buffer through the generic proxy, so only the barrier
//      initialisation needs a fence; a stage is freed only after the wait
//      on the last wgmma that reads it;
//   5. head dims 16, 32 and 256 keep fa_fwd_bf16, the earlier mma.sync
//      kernel (4 warps per 64-row q tile, K and V staged synchronously),
//      chosen by head dim alone in mxt_flash_attention_fwd_bf16. At D 256,
//      where O takes 128 registers a thread, it reads Q's fragments from
//      shared memory per k-step instead of holding them.
//
// C interface (bound with ctypes): every function returns a
// cudaError_t as int, 0 on success, and launches on the given stream
// without synchronising.

#include <math.h>

#include <type_traits>

#include "flash_attention_common.cuh"
#include "flash_attention_sm90.cuh"

namespace {

using namespace fa;

// ------------------------------------------- float32, 3xTF32 on mma.sync

// Shared memory of a block: its 64 q rows and a ring of NST K and V tiles
// of 2 KH keys, rows D + 4 floats apart (165 KB at D 128, 195 KB at D 256
// with 32-key tiles).
template <int D, int KH, int NST>
constexpr size_t tf32_smem_bytes() {
  return sizeof(float) * size_t(64 + 2 * NST * 2 * KH) * (D + 4);
}

// The key tile: 64 keys up to D 128; at D 256, where O takes 128
// registers a thread, 32 keys (which also keeps the ring in shared memory).
template <int D>
constexpr int tf32_fwd_kh() {
  return D > 128 ? 16 : 32;
}

// One block of 8 warps per (bh, 64-row q tile). Warp w owns q rows
// 16 (w % 4) .. + 15 and, of each tile of 2 KH keys that cp.async brings
// into a ring of NST stages, keys KH (w / 4) .. + KH - 1: the two halves of
// the block walk the same tiles with an online softmax each, and merge m,
// l and O at the end, so each warp's serial chain is half the block's.
template <int D, int KH, int NST>
__global__ void __launch_bounds__(F32_THREADS, 1)
fa_fwd_f32_tf32x3(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, float* __restrict__ o,
                  float* __restrict__ lse, int sq, int sk, float scale,
                  int causal) {
  constexpr int BQR = 64;           // q rows per block
  constexpr int BK = 2 * KH;        // keys per KV tile
  constexpr int SX = D + 4;         // shared row stride (floats)
  constexpr int KS = D / 8;         // k-steps of Q K^T
  constexpr int DN = D / 8;         // 8-column tiles of O
  constexpr int NJ = KH / 8;        // 8-key tiles of a warp's keys
  extern __shared__ __align__(16) float tf_smem[];
  float* Qs = tf_smem;                  // BQR x SX
  float* Ks = Qs + BQR * SX;            // NST x BK x SX
  float* Vs = Ks + NST * BK * SX;       // NST x BK x SX

  const int bh = blockIdx.x;
  // the last q tile of a head first: causal tiles of most work lead
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQR;
  const int warp = threadIdx.x / 32;
  const int half = warp / 4;                     // the warp's 32 keys
  const int g = (threadIdx.x % 32) / 4;
  const int t = threadIdx.x % 4;
  const int r0 = (warp % 4) * 16;                // the warp's rows
  const int row[2] = {q0 + r0 + g, q0 + r0 + g + 8};
  const float* kb = k + size_t(bh) * sk * D;
  const float* vb = v + size_t(bh) * sk * D;

  auto stage_kv = [&](int kt) {
    const int st = kt % NST;
    stage_f32<D, SX>(Ks + st * BK * SX, kb, kt * BK, BK, sk);
    stage_f32<D, SX>(Vs + st * BK * SX, vb, kt * BK, BK, sk);
    cp_async_commit();
  };

  int n_kt = (sk + BK - 1) / BK;
  if (causal) {
    // the last real row of this q tile sees keys up to its own position
    const int last_row = min(q0 + BQR, sq) - 1;
    n_kt = min(n_kt, last_row / BK + 1);
  }

  stage_f32<D, SX>(Qs, q + size_t(bh) * sq * D, q0, BQR, sq);
  stage_kv(0);

  // a half that has seen only masked keys of a row holds m = -1e30 and
  // a meaningless l and O; the first real key, here or in the merge,
  // scales them by exp(-1e30 - m) = 0
  float m[2] = {NEG_INF_MASK, NEG_INF_MASK}, l[2] = {0.f, 0.f};
  float acc[DN][4];
#pragma unroll
  for (int dn = 0; dn < DN; ++dn)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[dn][e] = 0.f;

  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * BK + half * KH;
    if (kt + 1 < n_kt) {
      stage_kv(kt + 1);   // into the stage read one tile ago
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();   // this tile (and Q) are in for every thread
    const float* Kt = Ks + (kt % NST) * BK * SX + half * KH * SX;
    const float* Vt = Vs + (kt % NST) * BK * SX + half * KH * SX;

    // S = Q K^T: A fragments from Q's rows, B from K's rows, both split
    // in registers as they are loaded; the two small-term products
    // accumulate apart from big * big, which halves the dependent chain
    float s[NJ][4], c2[NJ][4];
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = c2[j][e] = 0.f;
#pragma unroll 4
    for (int kk = 0; kk < KS; ++kk) {
      uint32_t ab[4], as[4];
      split_a<SX>(ab, as, Qs, r0, kk * 8, g, t);
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        uint32_t bb[2], bs[2];
        split_b_rows<SX>(bb, bs, Kt, j * 8, kk * 8, g, t);
        mma_3xtf32_2(s[j], c2[j], ab, as, bb, bs);
      }
    }

    // the online softmax on the C fragments: the 4 threads of a quad
    // share a row
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kp = k0 + j * 8 + 2 * t + (e & 1);
        float x = (s[j][e] + c2[j][e]) * scale;
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

    // O += P V. The C fragment of P's 8-key tile j becomes the A fragment
    // of a k-step without any shuffle by ordering that k-step's keys
    // 2t, 2t + 1 (c_to_a_tf32); V's B fragment is read from rows 2t and
    // 2t + 1 to match
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      uint32_t pb[4], ps[4];
      c_to_a_tf32(pb, ps, s[j]);
#pragma unroll
      for (int dn = 0; dn < DN; ++dn) {
        uint32_t vb[2], vs[2];
        split_b_cols<SX>(vb, vs, Vt, j * 8, dn * 8, g, t);
        mma_3xtf32(acc[dn], pb, ps, vb, vs);
      }
    }
    __syncthreads();   // this stage is read: the next load may land
  }

  // merge the two halves of each row: the second half hands m, l and O
  // over through shared memory (free now: no load is in flight)
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
  }
  static_assert(NST * BK >= BQR, "the K ring holds the merge's O");
  float* xo = Ks;   // BQR x SX: the second half's O
  float* xm = Qs;   // BQR x 2: its m and l
  if (half == 1) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = r0 + g + 8 * h;
#pragma unroll
      for (int dn = 0; dn < DN; ++dn)
        *reinterpret_cast<float2*>(xo + r * SX + dn * 8 + 2 * t) =
            make_float2(acc[dn][2 * h], acc[dn][2 * h + 1]);
      if (t == 0) {
        xm[2 * r] = m[h];
        xm[2 * r + 1] = l[h];
      }
    }
  }
  __syncthreads();
  if (half == 1) return;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r0 + g + 8 * h;
    const float mb = xm[2 * r], m_new = fmaxf(m[h], mb);
    const float fa = expf(m[h] - m_new), fb = expf(mb - m_new);
    const float denom = fmaxf(l[h] * fa + xm[2 * r + 1] * fb, 1e-37f);
    if (row[h] >= sq) continue;
    float* orow = o + (size_t(bh) * sq + row[h]) * D;
#pragma unroll
    for (int dn = 0; dn < DN; ++dn) {
      const float2 x =
          *reinterpret_cast<const float2*>(xo + r * SX + dn * 8 + 2 * t);
      *reinterpret_cast<float2*>(orow + dn * 8 + 2 * t) =
          make_float2((acc[dn][2 * h] * fa + x.x * fb) / denom,
                      (acc[dn][2 * h + 1] * fa + x.y * fb) / denom);
    }
    if (t == 0) lse[size_t(bh) * sq + row[h]] = m_new + logf(denom);
  }
}

template <int D>
int launch(const float* q, const float* k, const float* v, float* o,
           float* lse, int bh, int sq, int sk, float scale, int causal,
           cudaStream_t stream) {
  constexpr int KH = tf32_fwd_kh<D>(), NST = 2;
  const auto kernel = fa_fwd_f32_tf32x3<D, KH, NST>;
  const size_t smem = tf32_smem_bytes<D, KH, NST>();
  const cudaError_t err = set_max_shared(kernel, smem);
  if (err != cudaSuccess) return int(err);
  const dim3 grid(bh, (sq + 63) / 64);
  kernel<<<grid, F32_THREADS, smem, stream>>>(q, k, v, o, lse, sq, sk, scale,
                                              causal);
  return int(cudaGetLastError());
}

// ------------------------------------- bfloat16, mma.sync (head dims 16, 32)

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
  // Q's A fragments stay in registers up to D 128; at D 256, where O takes
  // 128 registers a thread, they are read from shared memory per k-step
  constexpr bool QREG = D <= 128;
  uint32_t qa[QREG ? KS : 1][4];
  if constexpr (QREG) {
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) load_a<SX>(qa[kk], Qs, r0, kk * 16, g, t);
  }

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
    if constexpr (QREG) {
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
    } else {
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll 4
      for (int kk = 0; kk < KS; ++kk) {
        uint32_t a[4];
        load_a<SX>(a, Qs, r0, kk * 16, g, t);
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          uint32_t b0, b1;
          load_b_rows<SX>(b0, b1, Ks, j * 8, kk * 16, g, t);
          mma_bf16(s[j], a, b0, b1);
        }
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

// --------------------------------------------- bfloat16, wgmma + TMA ring

using namespace fa90;

constexpr int WG_BQ = 128;        // q rows per block: 2 consumer warpgroups
constexpr int WG_BK = 128;        // keys per KV tile
constexpr int WG_THREADS = 384;   // producer warpgroup + 2 consumers

// Byte offsets in the (1024-aligned) dynamic shared memory of the block:
// the Q tile, then a ring of K and V tiles (3 stages: 224 KB at D 128).
template <int D>
struct FwdSmem {
  static constexpr int STAGES = 3;
  static constexpr uint32_t TILE = WG_BK * D * 2;   // one K or V tile
  static constexpr uint32_t Q = 0;
  static constexpr uint32_t K = WG_BQ * D * 2;      // K ring
  static constexpr uint32_t V = K + STAGES * TILE;  // V ring
  static constexpr uint32_t BAR = V + STAGES * TILE;
  static constexpr int N_BAR = 1 + 3 * STAGES;
  static constexpr size_t BYTES = BAR + N_BAR * 8 + 1024;   // + alignment
};

// One KV tile's step of the online softmax, in log2 units, on the scores
// of the thread's two rows: sc becomes P (unrounded), m and l are
// updated, and a0, a1 are the factors by which the rows' O must shrink.
// The masks are evaluated only on tiles that need them (EDGE).
template <bool EDGE, int NS>
__device__ __forceinline__ void softmax_tile(
    float (&sc)[NS], float& m0, float& m1, float& l0, float& l1,
    float& a0, float& a1, int k0, int sk, int causal, int row0, int row1,
    int cq, float scale_log2, float masked) {
  float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
  for (int j = 0; j < NS / 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float x = sc[4 * j + e] * scale_log2;
      if (EDGE) {
        const int kp = k0 + 8 * j + cq + (e & 1);
        if (kp >= sk)
          x = -INFINITY;
        else if (causal && ((e & 2) ? row1 : row0) < kp)
          x = masked;
      }
      sc[4 * j + e] = x;
      if (e & 2)
        mx1 = fmaxf(mx1, x);
      else
        mx0 = fmaxf(mx0, x);
    }
  // the 4 threads of a quad share a row
  mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
  mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
  mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
  mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
  const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
  a0 = exp2f(m0 - mn0);
  a1 = exp2f(m1 - mn1);
  m0 = mn0;
  m1 = mn1;
  l0 *= a0;
  l1 *= a1;
#pragma unroll
  for (int j = 0; j < NS / 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float p = exp2f(sc[4 * j + e] - ((e & 2) ? m1 : m0));
      sc[4 * j + e] = p;
      if (e & 2)
        l1 += p;   // this thread's share; reduced at the end
      else
        l0 += p;
    }
}

template <int D>
__global__ void __launch_bounds__(WG_THREADS, 1)
fa_fwd_bf16_wgmma(const __grid_constant__ CUtensorMap tq,
                  const __grid_constant__ CUtensorMap tk,
                  const __grid_constant__ CUtensorMap tv,
                  __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                  int sq, int sk, float scale_log2, int causal) {
  using L = FwdSmem<D>;
  constexpr int NH = D / 64;       // 64-column boxes of a row
  constexpr int NST = L::STAGES;
  extern __shared__ __align__(1024) unsigned char fwd_smem[];
  const uint32_t base = (smem_u32(fwd_smem) + 1023u) & ~1023u;
  // barriers: Q loaded; K, V of stage s loaded; stage s free again
  const uint32_t bar_q = base + L::BAR;
  const uint32_t bar_k = bar_q + 8, bar_v = bar_k + 8 * NST;
  const uint32_t bar_free = bar_v + 8 * NST;

  const int bh = blockIdx.x;
  // the last q tile of a head first: causal tiles of most work lead
  const int q0 = (gridDim.y - 1 - blockIdx.y) * WG_BQ;
  int n_kt = (sk + WG_BK - 1) / WG_BK;
  if (causal) n_kt = min(n_kt, (min(q0 + WG_BQ, sq) - 1) / WG_BK + 1);
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < NST; ++s) {
      mbar_init(bar_k + 8 * s, 1);
      mbar_init(bar_v + 8 * s, 1);
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
      mbar_expect_tx(bar_q, WG_BQ * D * 2);
#pragma unroll
      for (int h = 0; h < NH; ++h)
        tma_load_3d(base + L::Q + h * WG_BQ * 128, &tq, bar_q, h * 64, q0,
                    bh);
      for (int kt = 0; kt < n_kt; ++kt) {
        const int s = kt % NST;
        mbar_wait(bar_free + 8 * s, ((kt / NST) & 1) ^ 1);
        mbar_expect_tx(bar_k + 8 * s, L::TILE);
#pragma unroll
        for (int h = 0; h < NH; ++h)
          tma_load_3d(base + L::K + s * L::TILE + h * WG_BK * 128, &tk,
                      bar_k + 8 * s, h * 64, kt * WG_BK, bh);
        mbar_expect_tx(bar_v + 8 * s, L::TILE);
#pragma unroll
        for (int h = 0; h < NH; ++h)
          tma_load_3d(base + L::V + s * L::TILE + h * WG_BK * 128, &tv,
                      bar_v + 8 * s, h * 64, kt * WG_BK, bh);
      }
    }
  } else {
    // consumers: warpgroup g owns q rows q0 + 64g .. q0 + 64g + 63. The
    // product S_j = Q K_j^T is issued together with O += P_(j-1) V_(j-1),
    // so the softmax of tile j runs while the tensor cores do the second
    regs_claim<240>();
    constexpr int NS = WG_BK / 2;   // score registers: 64 x WG_BK / 128
    constexpr int NO = D / 2;       // output registers: 64 x D / 128
    const int g = wg - 1;
    const int t = threadIdx.x % 128;
    const int lane = t % 32;
    const int cq = 2 * (lane % 4);
    const int row0 = q0 + 64 * g + 16 * (t / 32) + lane / 4;
    const int row1 = row0 + 8;
    const float masked = NEG_INF_MASK * LOG2E;   // scores in log2 units
    float m0 = masked, m1 = masked, l0 = 0.f, l1 = 0.f, a0, a1;
    float acc[NO], sc[NS];
    uint32_t pa[WG_BK / 16][4];   // P rounded to bf16: the A operand
#pragma unroll
    for (int i = 0; i < NO; ++i) acc[i] = 0.f;
    const uint32_t qa = base + L::Q + g * 64 * 128;
    // the first tile that needs the masks: on the Sk edge, or crossing
    // the diagonal of the warpgroup's first row; every later one does too
    int kt_edge = sk / WG_BK;
    if (causal) kt_edge = min(kt_edge, (q0 + 64 * g + 1) / WG_BK);
    // S = Q K^T of the tile in stage s, both K-major; the first k-step
    // overwrites sc
    auto issue_qk = [&](int s) {
      const uint32_t ks = base + L::K + s * L::TILE;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss(sc,
                 kmajor_desc(qa + (kk / 4) * WG_BQ * 128 + (kk % 4) * 32),
                 kmajor_desc(ks + (kk / 4) * WG_BK * 128 + (kk % 4) * 32),
                 kk > 0);
      wgmma_commit();
    };

    mbar_wait(bar_q, 0);
    mbar_wait(bar_k, 0);
    wgmma_fence();
    issue_qk(0);
    wgmma_wait<0>();
    fence_regs(sc);
    if (kt_edge == 0)
      softmax_tile<true>(sc, m0, m1, l0, l1, a0, a1, 0, sk, causal, row0,
                         row1, cq, scale_log2, masked);
    else
      softmax_tile<false>(sc, m0, m1, l0, l1, a0, a1, 0, sk, causal, row0,
                          row1, cq, scale_log2, masked);
#pragma unroll
    for (int kk = 0; kk < WG_BK / 16; ++kk)
      c_to_a(pa[kk], &sc[8 * kk], &sc[8 * kk + 4]);

    // O += P V of the tile in stage s: P from registers, V MN-major
    // (key-major in memory)
    auto issue_pv = [&](int s) {
      const uint32_t vs = base + L::V + s * L::TILE;
#pragma unroll
      for (int kk = 0; kk < WG_BK / 16; ++kk)
        wgmma_rs(acc, pa[kk], mnmajor_desc(vs + kk * 16 * 128, WG_BK));
      wgmma_commit();
    };

    // tiles 1 .. n_kt - 1, those without masks first: no branch lies
    // between a product and its wait, so ptxas keeps the two products of
    // a step in flight together
    auto step = [&](int kt, auto edge_tile) {
      constexpr bool EDGE = decltype(edge_tile)::value;
      const int s = kt % NST, sp = (kt - 1) % NST;
      fence_regs(acc);
      fence_regs(pa);
      mbar_wait(bar_k + 8 * s, (kt / NST) & 1);
      mbar_wait(bar_v + 8 * sp, ((kt - 1) / NST) & 1);
      wgmma_fence();
      issue_qk(s);
      issue_pv(sp);
      wgmma_wait<1>();                   // S of this tile is in
      fence_regs(sc);
      softmax_tile<EDGE>(sc, m0, m1, l0, l1, a0, a1, kt * WG_BK, sk, causal,
                         row0, row1, cq, scale_log2, masked);
      wgmma_wait<0>();                   // and P V of the previous one
      fence_regs(acc);
      mbar_arrive(bar_free + 8 * sp);    // K and V of that stage are read
#pragma unroll
      for (int j = 0; j < NO / 4; ++j) {
        acc[4 * j] *= a0;
        acc[4 * j + 1] *= a0;
        acc[4 * j + 2] *= a1;
        acc[4 * j + 3] *= a1;
      }
#pragma unroll
      for (int kk = 0; kk < WG_BK / 16; ++kk)
        c_to_a(pa[kk], &sc[8 * kk], &sc[8 * kk + 4]);
    };
    const int mid = max(1, min(kt_edge, n_kt));
    for (int kt = 1; kt < mid; ++kt) step(kt, std::false_type());
    for (int kt = mid; kt < n_kt; ++kt) step(kt, std::true_type());
    // the last tile's P V
    {
      const int sp = (n_kt - 1) % NST;
      fence_regs(acc);
      fence_regs(pa);
      mbar_wait(bar_v + 8 * sp, ((n_kt - 1) / NST) & 1);
      wgmma_fence();
      issue_pv(sp);
      wgmma_wait<0>();
      fence_regs(acc);
      mbar_arrive(bar_free + 8 * sp);
    }

    l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
    l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = h ? row1 : row0;
      if (row >= sq) continue;
      const float denom = fmaxf(h ? l1 : l0, 1e-37f);
      __nv_bfloat16* orow = o + (size_t(bh) * sq + row) * D;
#pragma unroll
      for (int j = 0; j < NO / 4; ++j)
        *reinterpret_cast<uint32_t*>(orow + 8 * j + cq) = pack_bf16(
            acc[4 * j + 2 * h] / denom, acc[4 * j + 2 * h + 1] / denom);
      if (lane % 4 == 0)
        lse[size_t(bh) * sq + row] = (h ? m1 : m0) * LN2 + logf(denom);
    }
  }
}

template <int D>
int launch_bf16_wgmma(const __nv_bfloat16* q, const __nv_bfloat16* k,
                      const __nv_bfloat16* v, __nv_bfloat16* o, float* lse,
                      int bh, int sq, int sk, float scale, int causal,
                      cudaStream_t stream) {
  alignas(64) CUtensorMap tq, tk, tv;
  int err = map_heads_bf16(&tq, q, bh, sq, D, WG_BQ);
  if (!err) err = map_heads_bf16(&tk, k, bh, sk, D, WG_BK);
  if (!err) err = map_heads_bf16(&tv, v, bh, sk, D, WG_BK);
  if (err) return err;
  const size_t smem = FwdSmem<D>::BYTES;
  cudaError_t cerr = cudaFuncSetAttribute(
      fa_fwd_bf16_wgmma<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      int(smem));
  if (cerr != cudaSuccess) return int(cerr);
  const dim3 grid(bh, (sq + WG_BQ - 1) / WG_BQ);
  fa_fwd_bf16_wgmma<D><<<grid, WG_THREADS, smem, stream>>>(
      tq, tk, tv, o, lse, sq, sk, scale * LOG2E, causal);
  return int(cudaGetLastError());
}

}  // namespace

extern "C" {

// q (bh, sq, d), k and v (bh, sk, d), o (bh, sq, d), lse (bh, sq): all
// contiguous float32 on the current device, 16-byte aligned.
// d in {16, 32, 64, 128, 256}.
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
    case 256: return launch<256>(qf, kf, vf, of, lf, bh, sq, sk, scale, causal, st);
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
    // D 64 and 128 (the models' head dims) on wgmma + TMA; D 16, 32 and
    // 256 on the mma.sync kernel, chosen by shape alone
    case 64: return launch_bf16_wgmma<64>(qb, kb, vb, ob, lf, bh, sq, sk, scale, causal, st);
    case 128: return launch_bf16_wgmma<128>(qb, kb, vb, ob, lf, bh, sq, sk, scale, causal, st);
    case 256: return launch_bf16<256>(qb, kb, vb, ob, lf, bh, sq, sk, scale, causal, st);
    default: return int(cudaErrorInvalidValue);
  }
}

const char* mxt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
