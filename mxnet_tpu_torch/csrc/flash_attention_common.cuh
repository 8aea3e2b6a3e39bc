// Pieces shared by the flash-attention kernels (flash_attention_fwd.cu,
// flash_attention_bwd.cu): tile sizes, staging of tiles into shared
// memory, the warp-level bf16 tensor-core product, and the 3xTF32
// product of the float32 kernels.
//
// The float32 kernels (forward, dQ and dK/dV) stage float32 tiles through
// cp.async with a row stride of D + 4 floats and run 3xTF32 on
// mma.sync.m16n8k8 (split_tf32, mma_3xtf32 below). The bf16 mma.sync
// kernels (forward, dQ and dK/dV at head dims 16, 32 and 256) stage bf16
// tiles with a row stride of D + 8 elements and multiply with
// mma.sync.m16n8k16 (bf16 in, float32 accumulate). The wgmma kernels (flash_attention_sm90.cuh) use only
// NEG_INF_MASK, pack_bf16 and c_to_a from here: a wgmma accumulator and
// register A operand are, warp by warp, the C and A fragments below. For
// mma.sync each warp owns 16 rows of a tile, and a thread holds the
// fragments that the PTX ISA fixes for that instruction (g = lane / 4,
// t = lane % 4):
//   A (16 x 16, row-major): {A[g][2t..2t+1]}, {A[g+8][2t..]},
//                           {A[g][2t+8..]},   {A[g+8][2t+8..]}
//   B (16 x 8, k x n):      {B[2t..2t+1][g]}, {B[2t+8..2t+9][g]}
//   C (16 x 8, float32):    C[g][2t], C[g][2t+1], C[g+8][2t], C[g+8][2t+1]
// The D + 8 stride puts the 8 rows x 4 words of one fragment load in 32
// different banks (D / 2 + 4 words per row, 4 times an odd number).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace fa {

constexpr int BQ = 64;         // query rows per tile
constexpr int BK = 64;         // keys per tile
constexpr int F32_THREADS = 256;   // float32 kernels: 8 warps
constexpr int MMA_THREADS = 128;   // bf16 kernels: 4 warps x 16 rows
constexpr float NEG_INF_MASK = -1e30f;

// ------------------------------------------ float32: cp.async and 3xTF32

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src), "r"(src_bytes)
               : "memory");
}

// One float, for vectors whose rows need not start 16-byte aligned.
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Waits until at most N committed groups of this thread are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Rows [row0, row0 + nrows) of a (rows, D) float32 matrix into shared
// memory with row stride SX, 16 bytes a cp.async, by the block's
// F32_THREADS threads; rows >= limit arrive as zeros. Not committed.
template <int D, int SX>
__device__ __forceinline__ void stage_f32(float* dst, const float* src,
                                          int row0, int nrows, int limit) {
  constexpr int V4 = D / 4;
  for (int idx = threadIdx.x; idx < nrows * V4; idx += F32_THREADS) {
    const int r = idx / V4;
    const int c = (idx % V4) * 4;
    const bool in = row0 + r < limit;
    cp_async16(dst + r * SX + c, src + size_t(in ? row0 + r : 0) * D + c,
               in ? 16 : 0);
  }
}

// x = big + small: big = tf32(x) (10-bit mantissa, rounded to nearest),
// small = x - big, exact in float32. The tensor cores read a tf32 operand's
// top 19 bits, so small enters the product truncated: about 2^-21 of x is
// lost there, and about 2^-22 of each term in the small * small product
// that the three-pass product drops.
__device__ __forceinline__ void split_tf32(float x, uint32_t& big,
                                           uint32_t& small) {
  uint32_t b;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(b) : "f"(x));
  b &= 0xffffe000u;
  big = b;
  small = __float_as_uint(x - __uint_as_float(b));
}

// The split A fragment (m16n8k8, tf32) of rows r0 .. r0 + 15, columns
// c0 .. c0 + 7 of a row-major float32 tile with row stride SX:
// a0 = A[g][t], a1 = A[g + 8][t], a2 = A[g][t + 4], a3 = A[g + 8][t + 4].
template <int SX>
__device__ __forceinline__ void split_a(uint32_t (&big)[4],
                                        uint32_t (&small)[4], const float* s,
                                        int r0, int c0, int g, int t) {
  const float* p = s + (r0 + g) * SX + c0 + t;
  split_tf32(p[0], big[0], small[0]);
  split_tf32(p[8 * SX], big[1], small[1]);
  split_tf32(p[4], big[2], small[2]);
  split_tf32(p[8 * SX + 4], big[3], small[3]);
}

// The split B fragment with B[k][n] = X[n0 + n][k0 + k] (the product with
// X's rows: Q K^T and the like): b0 = X[n0 + g][k0 + t], b1 = ...[k0 + t + 4].
template <int SX>
__device__ __forceinline__ void split_b_rows(uint32_t (&big)[2],
                                             uint32_t (&small)[2],
                                             const float* s, int n0, int k0,
                                             int g, int t) {
  const float* p = s + (n0 + g) * SX + k0 + t;
  split_tf32(p[0], big[0], small[0]);
  split_tf32(p[4], big[1], small[1]);
}

// The split B fragment with B[k][n] = X[k0 + key(k)][n0 + n] (the product
// with X itself: P V and the like), where a k-step's 8 keys come in the
// order 2t, 2t + 1 (k = t, t + 4) that c_to_a_tf32 gives the A operand.
template <int SX>
__device__ __forceinline__ void split_b_cols(uint32_t (&big)[2],
                                             uint32_t (&small)[2],
                                             const float* s, int k0, int n0,
                                             int g, int t) {
  const float* p = s + (k0 + 2 * t) * SX + n0 + g;
  split_tf32(p[0], big[0], small[0]);
  split_tf32(p[SX], big[1], small[1]);
}

// Splits rows [0, rows) of a staged float32 tile with row stride SX, by
// the block's F32_THREADS threads: big in place, small into the twin tile
// `small`. A tile that several warps read is so split once, not by each.
template <int D, int SX>
__device__ __forceinline__ void presplit_tile(float* big, float* small,
                                              int rows) {
  constexpr int V4 = D / 4;
  for (int idx = threadIdx.x; idx < rows * V4; idx += F32_THREADS) {
    const int off = (idx / V4) * SX + (idx % V4) * 4;
    const float4 x = *reinterpret_cast<const float4*>(big + off);
    uint32_t b[4], s[4];
    split_tf32(x.x, b[0], s[0]);
    split_tf32(x.y, b[1], s[1]);
    split_tf32(x.z, b[2], s[2]);
    split_tf32(x.w, b[3], s[3]);
    *reinterpret_cast<float4*>(big + off) =
        make_float4(__uint_as_float(b[0]), __uint_as_float(b[1]),
                    __uint_as_float(b[2]), __uint_as_float(b[3]));
    *reinterpret_cast<float4*>(small + off) =
        make_float4(__uint_as_float(s[0]), __uint_as_float(s[1]),
                    __uint_as_float(s[2]), __uint_as_float(s[3]));
  }
}

// split_b_rows and split_b_cols from a tile split by presplit_tile.
template <int SX>
__device__ __forceinline__ void load_b_rows_split(uint32_t (&big)[2],
                                                  uint32_t (&small)[2],
                                                  const float* sb,
                                                  const float* ss, int n0,
                                                  int k0, int g, int t) {
  const int o = (n0 + g) * SX + k0 + t;
  big[0] = __float_as_uint(sb[o]);
  big[1] = __float_as_uint(sb[o + 4]);
  small[0] = __float_as_uint(ss[o]);
  small[1] = __float_as_uint(ss[o + 4]);
}

template <int SX>
__device__ __forceinline__ void load_b_cols_split(uint32_t (&big)[2],
                                                  uint32_t (&small)[2],
                                                  const float* sb,
                                                  const float* ss, int k0,
                                                  int n0, int g, int t) {
  const int o = (k0 + 2 * t) * SX + n0 + g;
  big[0] = __float_as_uint(sb[o]);
  big[1] = __float_as_uint(sb[o + SX]);
  small[0] = __float_as_uint(ss[o]);
  small[1] = __float_as_uint(ss[o + SX]);
}

// The split A fragment of a k-step whose 8 columns are the C fragment c
// of a previous m16n8k8 product (P, dS and the like): a thread holds
// columns 2t, 2t + 1 of rows g and g + 8, and the A layout wants columns
// t and t + 4, so the k-step takes its columns in the order 2t, 2t + 1:
// a0 = c0, a1 = c2, a2 = c1, a3 = c3 (no shuffle); split_b_cols reads the
// B rows to match.
__device__ __forceinline__ void c_to_a_tf32(uint32_t (&big)[4],
                                            uint32_t (&small)[4],
                                            const float (&c)[4]) {
  split_tf32(c[0], big[0], small[0]);
  split_tf32(c[2], big[1], small[1]);
  split_tf32(c[1], big[2], small[2]);
  split_tf32(c[3], big[3], small[3]);
}

// c += a b, one m16n8k8 tf32 product with float32 accumulation. Not
// volatile: the compiler may interleave independent products.
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a b at float32 accuracy: the three products of the split halves,
// the small terms first.
__device__ __forceinline__ void mma_3xtf32(float (&c)[4],
                                           const uint32_t (&a_big)[4],
                                           const uint32_t (&a_small)[4],
                                           const uint32_t (&b_big)[2],
                                           const uint32_t (&b_small)[2]) {
  mma_tf32(c, a_small, b_big[0], b_big[1]);
  mma_tf32(c, a_big, b_small[0], b_small[1]);
  mma_tf32(c, a_big, b_big[0], b_big[1]);
}

// The same with the two small-term products accumulated in c2, apart
// from big * big in c: two dependent chains of half the length (the
// caller adds c + c2 when it reads the product).
__device__ __forceinline__ void mma_3xtf32_2(float (&c)[4], float (&c2)[4],
                                             const uint32_t (&a_big)[4],
                                             const uint32_t (&a_small)[4],
                                             const uint32_t (&b_big)[2],
                                             const uint32_t (&b_small)[2]) {
  mma_tf32(c2, a_small, b_big[0], b_big[1]);
  mma_tf32(c2, a_big, b_small[0], b_small[1]);
  mma_tf32(c, a_big, b_big[0], b_big[1]);
}

// Lets a float32 kernel take `smem` bytes of dynamic shared memory (above
// the default 48 KB), with the SM's carveout set to shared memory first.
template <typename Kernel>
cudaError_t set_max_shared(Kernel kernel, size_t smem) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributePreferredSharedMemoryCarveout,
                              int(cudaSharedmemCarveoutMaxShared));
}

// ------------------------------------------------ bf16: mma.sync m16n8k16

// Copies rows [row0, row0 + nrows) of a (rows, D) bf16 matrix into shared
// memory with row stride D + 8, 16 bytes at a time, zero-filling rows >=
// limit.
template <int D>
__device__ __forceinline__ void stage_bf16(__nv_bfloat16* dst,
                                           const __nv_bfloat16* src,
                                           int row0, int nrows, int limit) {
  constexpr int V8 = D / 8;
  for (int idx = threadIdx.x; idx < nrows * V8; idx += MMA_THREADS) {
    const int r = idx / V8;
    const int c = (idx % V8) * 8;
    uint4 x = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < limit)
      x = *reinterpret_cast<const uint4*>(src + size_t(row0 + r) * D + c);
    *reinterpret_cast<uint4*>(dst + r * (D + 8) + c) = x;
  }
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pack_halves(__nv_bfloat16 lo,
                                                __nv_bfloat16 hi) {
  return uint32_t(__bfloat16_as_ushort(lo)) |
         (uint32_t(__bfloat16_as_ushort(hi)) << 16);
}

// c += a * b on the tensor cores (one m16n8k16 bf16 product).
__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// A fragment of rows [r0, r0 + 16) x cols [c0, c0 + 16) of a row-major
// shared tile with row stride SX.
template <int SX>
__device__ __forceinline__ void load_a(uint32_t* a, const __nv_bfloat16* s,
                                       int r0, int c0, int g, int t) {
  const __nv_bfloat16* p = s + (r0 + g) * SX + c0 + 2 * t;
  a[0] = *reinterpret_cast<const uint32_t*>(p);
  a[1] = *reinterpret_cast<const uint32_t*>(p + 8 * SX);
  a[2] = *reinterpret_cast<const uint32_t*>(p + 8);
  a[3] = *reinterpret_cast<const uint32_t*>(p + 8 * SX + 8);
}

// B fragment with B[k][n] = X[n0 + n][k0 + k]: the product with X's rows
// (Q Kᵀ and the like); each register is one 32-bit load.
template <int SX>
__device__ __forceinline__ void load_b_rows(uint32_t& b0, uint32_t& b1,
                                            const __nv_bfloat16* s, int n0,
                                            int k0, int g, int t) {
  const __nv_bfloat16* p = s + (n0 + g) * SX + k0 + 2 * t;
  b0 = *reinterpret_cast<const uint32_t*>(p);
  b1 = *reinterpret_cast<const uint32_t*>(p + 8);
}

// B fragment with B[k][n] = X[k0 + k][n0 + n]: the product with X itself
// (P V and the like); each register is two 16-bit loads from two rows.
template <int SX>
__device__ __forceinline__ void load_b_cols(uint32_t& b0, uint32_t& b1,
                                            const __nv_bfloat16* s, int k0,
                                            int n0, int g, int t) {
  const __nv_bfloat16* p = s + (k0 + 2 * t) * SX + n0 + g;
  b0 = pack_halves(p[0], p[SX]);
  b1 = pack_halves(p[8 * SX], p[9 * SX]);
}

// The A fragment for k-step kk of a 16-row product whose left operand is
// held as float32 C fragments c[j] (8 columns each): columns 16kk..16kk+15
// are c[2kk] and c[2kk + 1], rounded to bf16.
__device__ __forceinline__ void c_to_a(uint32_t* a, const float* c_lo,
                                       const float* c_hi) {
  a[0] = pack_bf16(c_lo[0], c_lo[1]);
  a[1] = pack_bf16(c_lo[2], c_lo[3]);
  a[2] = pack_bf16(c_hi[0], c_hi[1]);
  a[3] = pack_bf16(c_hi[2], c_hi[3]);
}

}  // namespace fa
