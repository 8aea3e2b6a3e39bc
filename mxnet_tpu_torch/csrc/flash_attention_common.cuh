// Pieces shared by the flash-attention kernels (flash_attention_fwd.cu,
// flash_attention_bwd.cu): tile sizes, staging of tiles into shared
// memory, and the warp-level bf16 tensor-core product.
//
// The float32 backward kernels issue plain FMAs on tiles staged as
// float32 (the float32 forward runs 3xTF32 on its own mma.sync fragments,
// in flash_attention_fwd.cu). The bf16 mma.sync kernels (forward, dQ and
// dK/dV at head dims 16 and 32) stage bf16 tiles with a row stride of
// D + 8 elements and multiply with mma.sync.m16n8k16 (bf16 in, float32
// accumulate). The wgmma kernels (flash_attention_sm90.cuh) use only
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
constexpr int THREADS = 256;   // float32 backward kernels: 16 x 16
constexpr int PS = BK + 4;     // float32 backward kernels: P / dS stride
constexpr int MMA_THREADS = 128;   // bf16 kernels: 4 warps x 16 rows
constexpr float NEG_INF_MASK = -1e30f;

// Loads rows [row0, row0 + nrows) of a (rows, D) float matrix into
// shared memory with row stride `stride`, zero-filling rows >= limit.
template <int D>
__device__ __forceinline__ void load_tile(float* dst, int stride,
                                          const float* src, int row0,
                                          int nrows, int limit) {
  constexpr int V4 = D / 4;
  for (int idx = threadIdx.x; idx < nrows * V4; idx += THREADS) {
    const int r = idx / V4;
    const int c = (idx % V4) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + r < limit)
      x = *reinterpret_cast<const float4*>(src + size_t(row0 + r) * D + c);
    float* d = dst + r * stride + c;
    d[0] = x.x;
    d[1] = x.y;
    d[2] = x.z;
    d[3] = x.w;
  }
}

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
