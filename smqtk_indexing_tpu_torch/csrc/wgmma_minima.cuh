// What the two stage-1 kernels on the tensor cores share: K1's
// (segment_minima_wgmma.cu, row-major database) and the tiled layout's
// (segment_minima_tiled_wgmma.cu: K2, K4, K5). Both compute per-128-row
// segment minima of (db_sq - 2 <q, x>) + penalty with wgmma.m64n128k16
// (wgmma.cuh): a block of two warpgroups holds kMTiles 64-query tiles a
// warpgroup (A) and multiplies them by one segment's 128 rows (B), one
// 64-dim K-chunk at a time, both operands bf16 in the 128-byte swizzle
// layout. This header holds the block's geometry, the cp.async staging of
// a row-major bf16 K-chunk (the query tile; K1's bf16 database), and the
// epilogue's fold and quad reduction.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

#include "scan_loads.cuh"
#include "wgmma.cuh"

namespace {

constexpr int kSeg = 128;       // rows per segment: wgmma's N
constexpr int kChunk = 64;      // dims per K-chunk: one swizzled row
constexpr int kMTile = 64;      // queries per wgmma: its M
constexpr int kThreads = 256;   // two warpgroups
constexpr int kDbStageBytes = kSeg * kSwizzleBytes;  // 16 KB
constexpr int kMaxSmem = 232448;                     // 227 KB a block

// Queries a block owns with kMTiles tiles per warpgroup.
template <int kMTiles>
__host__ __device__ constexpr int q_rows() {
  return 2 * kMTile * kMTiles;
}

// Copies one 64-dim K-chunk of `rows` rows (row r reads src_row(r)) into a
// swizzled tile at shared address dst: 8 cp.async pieces a row. Pieces at
// or past `live` (8 bf16 each) are zero-filled and read nothing: the tail
// of a chunk past the last dimension.
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
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                     dst + swizzle_offset(r, p)),
                 "l"(src_row(r) + (on ? p * 8 : 0)), "r"(bytes)
                 : "memory");
  }
}

// The epilogue's fold: acc[i] is the warpgroup's 64 x 128 tile i of <q, x>
// for one segment (wgmma.cuh's fragment: this thread holds columns 8 j + 2
// (lane % 4) + e of query rows 16 warp + lane / 4 + 8 h). sq_pen(j)
// returns the db_sq and penalty of the thread's columns 8 j + 2 (lane % 4)
// + {0, 1} as (sq.x, sq.y, pen.x, pen.y). m[i][h] becomes the minimum of
// (db_sq - 2 acc) + penalty over the thread's 32 columns of row h of tile
// i.
template <int kMTiles, typename SqPen>
__device__ __forceinline__ void fold_minima(const float (&acc)[kMTiles][64],
                                            SqPen sq_pen,
                                            float (&m)[kMTiles][2]) {
#pragma unroll
  for (int i = 0; i < kMTiles; ++i) {
    m[i][0] = m[i][1] = __int_as_float(0x7f800000);  // +inf
  }
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const float4 sp = sq_pen(j);
#pragma unroll
    for (int i = 0; i < kMTiles; ++i) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        m[i][h] = fminf(m[i][h],
                        (sp.x - 2.0f * acc[i][4 * j + 2 * h]) + sp.z);
        m[i][h] = fminf(m[i][h],
                        (sp.y - 2.0f * acc[i][4 * j + 2 * h + 1]) + sp.w);
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
