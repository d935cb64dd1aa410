// The stage-1 scan over the tiled-transposed layout on the CUDA cores:
// the production kernel of the f32 and bf16 databases
// (segment_minima_tiled.cu: K2, K4, K5). Int8 codes, with a float or an
// int8 query, run on the tensor cores (segment_minima_tiled_wgmma.cu,
// which also holds the K9 variant probe).
//
// The database db3 is (n_tiles, d, tile_n), tile_n % 128 == 0: row r is
// column r % tile_n of tile r / tile_n, so element (r, j) lies at
// db3[r / tile_n][j][r % tile_n], and a segment's 128 rows are 128
// contiguous values in each of the d dimension rows. With q (B, d), db_sq
// and penalty (N,) f32 (penalty = +inf on dead rows), it computes
//
//     m[b, s] = min over r in [128 s, 128 s + 128) of
//               (db_sq[r] - 2 <q_b, x_r>) + penalty[r]
//
// written as out1[(s / G) * B * G + b * G + s % G]: with G = N / 128 that is
// K2's and K4's (B, N / 128) output, with G = t_step * tile_n / 128 K5's
// step-major m1 (n_steps, B, G). When out2 is given (K5), it also writes
// m2[(s / G) * B * (G / bw) + b * (G / bw) + (s % G) / bw], the minimum of
// m over each group of bw consecutive segments (bw divides G).
//
// The product is f32 FFMA over the database widened to f32 as it is
// staged, against an f32 query (rounded to bf16 by the wrapper for a bf16
// database, so every product is exact). The kernel keeps K1's
// (segment_minima.cu) block shape: 256 threads own 128 queries and walk bw
// consecutive segments (one group; one segment for K2 and K4); per segment
// each thread owns an 8 x 8 micro-tile of scores in registers (queries
// ty*4 + {0..3} and 64 + ty*4 + {0..3}, rows tx*4 + {0..3} and 64 + tx*4 +
// {0..3}), and each query's segment minimum is reduced over the thread's 8
// rows, then over the 16 lanes that share the query with warp shuffles.
// The group minimum is a running minimum in registers, written once after
// the group's last segment. Queries past B are staged as zeros and not
// written. Blocks are numbered query-tile fastest, so the blocks that read
// one group run close together and find it in L2. Every global offset is
// 64-bit: N d passes 2^31 at capacity.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

#include "scan_loads.cuh"

namespace {

constexpr int kSeg = 128;      // rows per segment
constexpr int kTileB = 128;    // queries per block
constexpr int kDepth = 16;     // dims of one FFMA shared-memory stage
constexpr int kThreads = 256;
constexpr int kPad = 4;        // keeps rows 16-byte aligned

__device__ __forceinline__ int query_of(int ty, int i) {
  return i < 4 ? ty * 4 + i : 64 + ty * 4 + (i - 4);
}

__device__ __forceinline__ int row_of(int tx, int j) {
  return j < 4 ? tx * 4 + j : 64 + tx * 4 + (j - 4);
}

// The epilogue of segment s: the thread's 8 x 8 accumulators become
// scores, each query's minimum over the segment goes to out1 and into the
// running group minimum gmin.
__device__ __forceinline__ void segment_epilogue(
    const float (&acc)[8][8], const float* __restrict__ db_sq,
    const float* __restrict__ penalty, float* __restrict__ out1,
    float (&gmin)[8], int64_t s, int64_t q0, int64_t n_queries, int64_t g,
    int tx, int ty) {
  const int64_t r0 = s * kSeg;
  float sq[8], pen[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int64_t r = r0 + row_of(tx, j);
    sq[j] = db_sq[r];
    pen[j] = penalty[r];
  }
  const int64_t step = s / g;
  const int64_t gi = s % g;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int64_t qi = q0 + query_of(ty, i);
    float m = __int_as_float(0x7f800000);  // +inf
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      m = fminf(m, (sq[j] - 2.0f * acc[i][j]) + pen[j]);
    }
    // The 16 lanes sharing this query hold the segment's other rows.
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) {
      m = fminf(m, __shfl_xor_sync(0xffffffffu, m, off));
    }
    gmin[i] = fminf(gmin[i], m);
    if (tx == 0 && qi < n_queries) out1[(step * n_queries + qi) * g + gi] = m;
  }
}

// K5's second output: each query's minimum over the block's group.
__device__ __forceinline__ void group_epilogue(
    const float (&gmin)[8], float* __restrict__ out2, int64_t group,
    int64_t q0, int64_t n_queries, int64_t g, int64_t bw, int tx, int ty) {
  const int64_t s = group * bw;
  const int64_t ng = g / bw;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int64_t qi = q0 + query_of(ty, i);
    if (tx == 0 && qi < n_queries) {
      out2[((s / g) * n_queries + qi) * ng + (s % g) / bw] = gmin[i];
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
tiled_minima_kernel(const float* __restrict__ q, const T* __restrict__ db3,
                    const float* __restrict__ db_sq,
                    const float* __restrict__ penalty,
                    float* __restrict__ out1, float* __restrict__ out2,
                    int64_t n_queries, int64_t dim, int64_t tile_n,
                    int64_t g, int64_t bw, int64_t n_qtiles) {
  __shared__ __align__(16) float q_s[kDepth][kTileB + kPad];
  __shared__ __align__(16) float x_s[kDepth][kSeg + kPad];

  const int64_t q0 = (blockIdx.x % n_qtiles) * kTileB;
  const int64_t group = blockIdx.x / n_qtiles;
  const int64_t nseg_t = tile_n / kSeg;
  const int t = threadIdx.x;
  const int tx = t % 16;  // row group: lanes 0-15 / 16-31 of a warp
  const int ty = t / 16;  // query group

  // Query staging, as K1: thread t copies 8 consecutive depth values of
  // query row t / 2, transposed into q_s.
  const int lrow = t / 2;
  const int lcol = (t % 2) * 8;
  const bool q_live = q0 + lrow < n_queries;
  const float* q_src = q + (q_live ? q0 + lrow : 0) * dim + lcol;
  // Database staging: 8 rows of dim t / 16, starting at row (t % 16) * 8,
  // so 16 threads read one 128-value run and the loads coalesce fully.
  const int xdim = t / 16;
  const int xrow = (t % 16) * 8;

  float gmin[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) gmin[i] = __int_as_float(0x7f800000);  // +inf

  for (int64_t s = group * bw; s < (group + 1) * bw; ++s) {
    const T* x_src = db3 + (s / nseg_t) * dim * tile_n
                     + (s % nseg_t) * kSeg + xdim * tile_n + xrow;

    float acc[8][8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;
    }

    for (int64_t k0 = 0; k0 < dim; k0 += kDepth) {
      float v[8];
      if (q_live) {
        load8(q_src + k0, v);
      } else {
#pragma unroll
        for (int i = 0; i < 8; ++i) v[i] = 0.0f;
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) q_s[lcol + i][lrow] = v[i];
      load8(x_src + k0 * tile_n, v);
      *reinterpret_cast<float4*>(&x_s[xdim][xrow]) =
          make_float4(v[0], v[1], v[2], v[3]);
      *reinterpret_cast<float4*>(&x_s[xdim][xrow + 4]) =
          make_float4(v[4], v[5], v[6], v[7]);
      __syncthreads();

#pragma unroll
      for (int kk = 0; kk < kDepth; ++kk) {
        const float4 a0 =
            *reinterpret_cast<const float4*>(&q_s[kk][ty * 4]);
        const float4 a1 =
            *reinterpret_cast<const float4*>(&q_s[kk][64 + ty * 4]);
        const float4 b0 =
            *reinterpret_cast<const float4*>(&x_s[kk][tx * 4]);
        const float4 b1 =
            *reinterpret_cast<const float4*>(&x_s[kk][64 + tx * 4]);
        const float a[8] = {a0.x, a0.y, a0.z, a0.w,
                            a1.x, a1.y, a1.z, a1.w};
        const float b[8] = {b0.x, b0.y, b0.z, b0.w,
                            b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int i = 0; i < 8; ++i) {
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
          }
        }
      }
      __syncthreads();
    }
    segment_epilogue(acc, db_sq, penalty, out1, gmin, s, q0, n_queries, g,
                     tx, ty);
  }
  if (out2 != nullptr) {
    group_epilogue(gmin, out2, group, q0, n_queries, g, bw, tx, ty);
  }
}

// The checks every launcher makes; cudaSuccess or cudaErrorInvalidValue.
inline cudaError_t check_tiled(int64_t n_queries, int64_t n_tiles,
                               int64_t dim, int64_t tile_n, int64_t g,
                               int64_t bw, int64_t* n_qtiles,
                               int64_t* n_blocks) {
  const int64_t nseg = n_tiles * (tile_n / kSeg);
  if (tile_n <= 0 || tile_n % kSeg || dim % kDepth || g <= 0 || bw <= 0
      || nseg % g || g % bw) {
    return cudaErrorInvalidValue;
  }
  *n_qtiles = (n_queries + kTileB - 1) / kTileB;
  *n_blocks = *n_qtiles * (nseg / bw);
  if (*n_blocks >= (1LL << 31)) return cudaErrorInvalidValue;
  return cudaSuccess;
}

template <typename T>
int launch_tiled(const void* q, const void* db3, const void* db_sq,
                 const void* penalty, void* out1, void* out2,
                 int64_t n_queries, int64_t n_tiles, int64_t dim,
                 int64_t tile_n, int64_t g, int64_t bw, int device,
                 void* stream) {
  // This library carries its own CUDA runtime: select the tensors' device
  // in it before launching on the caller's stream.
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  int64_t n_qtiles, n_blocks;
  err = check_tiled(n_queries, n_tiles, dim, tile_n, g, bw, &n_qtiles,
                    &n_blocks);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n_blocks > 0) {
    tiled_minima_kernel<T><<<dim3(static_cast<unsigned>(n_blocks)), kThreads,
                             0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(q), static_cast<const T*>(db3),
        static_cast<const float*>(db_sq), static_cast<const float*>(penalty),
        static_cast<float*>(out1), static_cast<float*>(out2), n_queries, dim,
        tile_n, g, bw, n_qtiles);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
