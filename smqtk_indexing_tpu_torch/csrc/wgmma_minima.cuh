// What the stage-1 kernels on the tensor cores share: K1's
// (segment_minima_wgmma.cu, row-major database) and the tiled layout's
// (segment_minima_tiled_wgmma.cu: K2, K4, K5). Both compute per-128-row
// segment minima of (db_sq - 2 <q, x>) + penalty with wgmma.m64n128
// (wgmma.cuh): a block of two warpgroups holds kMTiles 64-query tiles a
// warpgroup (A) and multiplies them by one segment's 128 rows (B), one
// 128-byte K-chunk at a time, both operands in the 128-byte swizzle layout.
// The query's element type Q names the product: bf16 (raw 16-bit
// patterns; 64 dims a chunk, k16 steps, f32 sums) or int8 (128 dims a
// chunk, k32 steps, exact s32 sums). This header holds the block's
// geometry, the cp.async staging of a row-major K-chunk (the query tile;
// K1's bf16 or int8 database), and the epilogue's fold and quad reduction.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

#include "scan_loads.cuh"
#include "wgmma.cuh"

namespace {

constexpr int kSeg = 128;       // rows per segment: wgmma's N
constexpr int kChunkBf16 = 64;  // bf16 dims per K-chunk: one swizzled row
constexpr int kChunkS8 = 128;   // int8 dims per K-chunk: one swizzled row
constexpr int kMTile = 64;      // queries per wgmma: its M
constexpr int kThreads = 256;   // two warpgroups
constexpr int kDbStageBytes = kSeg * kSwizzleBytes;  // 16 KB
constexpr int kMaxSmem = 232448;                     // 227 KB a block

static_assert(kChunkBf16 * 2 == kSwizzleBytes && kChunkS8 == kSwizzleBytes,
              "a K-chunk is one swizzled row");

// Dims of one K-chunk and of one 16-byte piece of it, for query type Q.
template <typename Q>
__host__ __device__ constexpr int chunk_dims() {
  return sizeof(Q) == 1 ? kChunkS8 : kChunkBf16;
}
template <typename Q>
__host__ __device__ constexpr int piece_dims() {
  return kPieceBytes / static_cast<int>(sizeof(Q));
}

// The accumulator type of Q's product.
template <typename Q>
struct MmaAcc { using type = float; };
template <>
struct MmaAcc<int8_t> { using type = int; };

// One K step of the product of a 64-query tile and a segment: k16 of
// bf16 into f32, or k32 of int8 into s32 (32 bytes of each row either way).
__device__ __forceinline__ void wgmma_step(float (&d)[64], uint64_t a,
                                           uint64_t b, int scale_d) {
  wgmma_m64n128k16_bf16(d, a, b, scale_d);
}
__device__ __forceinline__ void wgmma_step(int (&d)[64], uint64_t a,
                                           uint64_t b, int scale_d) {
  wgmma_m64n128k32_s8(d, a, b, scale_d);
}

// Queries a block owns with kMTiles tiles per warpgroup.
template <int kMTiles>
__host__ __device__ constexpr int q_rows() {
  return 2 * kMTile * kMTiles;
}

// Copies one K-chunk of `rows` rows (row r reads src_row(r), a pointer of
// any element type) into a swizzled tile at shared address dst: 8 cp.async
// pieces of 16 bytes a row. Pieces at or past `live` are zero-filled and
// read nothing: the tail of a chunk past the last dimension.
template <int kRows, typename RowPtr>
__device__ __forceinline__ void copy_chunk(uint32_t dst, RowPtr src_row,
                                           int tid, int live) {
  static_assert(kRows * 8 % kThreads == 0, "whole pieces a thread");
#pragma unroll
  for (int j = 0; j < kRows * 8 / kThreads; ++j) {
    const int i = tid + j * kThreads;
    const int r = i >> 3;
    const int p = i & 7;
    const bool on = p < live;
    const uint32_t bytes = on ? 16u : 0u;
    const uint8_t* src = reinterpret_cast<const uint8_t*>(src_row(r));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                     dst + swizzle_offset(r, p)),
                 "l"(src + (on ? p * kPieceBytes : 0)), "r"(bytes)
                 : "memory");
  }
}

// Round to the nearest bf16, ties to even, kept in an f32 (finite values
// and +inf; scores are never NaN): torch's and jnp's astype(bfloat16).
__device__ __forceinline__ float round_bf16(float x) {
  uint32_t u = __float_as_uint(x);
  u += 0x7fffu + ((u >> 16) & 1u);
  return __uint_as_float(u & 0xffff0000u);
}

// The epilogue's fold: acc[i] is the warpgroup's 64 x 128 tile i of <q, x>
// for one segment (wgmma.cuh's fragment: this thread holds columns 8 j + 2
// (lane % 4) + e of query rows 16 warp + lane / 4 + 8 h), f32 or s32.
// sq_pen(j) returns the db_sq and penalty of the thread's columns 8 j + 2
// (lane % 4) + {0, 1} as (sq.x, sq.y, pen.x, pen.y). m[i][h] becomes the
// minimum of (db_sq - 2 ip) + penalty over the thread's 32 columns of row
// h of tile i, with ip = inner(acc, scale) (scan_loads.cuh: an f32 sum as
// it is, an s32 sum converted and scaled). The K9 probe's epilogues:
// kPen false drops the penalty (its "folded"), kRound rounds each score
// to bf16 before the minimum (its "bf16min"); production takes neither.
template <int kMTiles, bool kPen = true, bool kRound = false, typename Acc,
          typename SqPen>
__device__ __forceinline__ void fold_minima(const Acc (&acc)[kMTiles][64],
                                            float scale, SqPen sq_pen,
                                            float (&m)[kMTiles][2]) {
#pragma unroll
  for (int i = 0; i < kMTiles; ++i) {
    m[i][0] = m[i][1] = __int_as_float(0x7f800000);  // +inf
  }
  auto score = [](float sq, float ip, float pen) {
    float v = sq - 2.0f * ip;
    if constexpr (kPen) v = v + pen;
    if constexpr (kRound) v = round_bf16(v);
    return v;
  };
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const float4 sp = sq_pen(j);
#pragma unroll
    for (int i = 0; i < kMTiles; ++i) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float ip0 = inner(acc[i][4 * j + 2 * h], scale);
        const float ip1 = inner(acc[i][4 * j + 2 * h + 1], scale);
        m[i][h] = fminf(m[i][h], score(sp.x, ip0, sp.z));
        m[i][h] = fminf(m[i][h], score(sp.y, ip1, sp.w));
      }
    }
  }
}

// The minimum over the 4 lanes of a quad, which hold every column of
// their two query rows; every lane of the quad gets it.
__device__ __forceinline__ float quad_min(float v) {
  v = fminf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  v = fminf(v, __shfl_xor_sync(0xffffffffu, v, 2));
  return v;
}

}  // namespace
