// Stage 1 of the single-copy SQ8 capacity scan: per-128-row segment minima
// of the L2 surrogate over the tiled-transposed layout, with an optional
// second output of per-group minima, written by hand for Hopper (sm_90a).
//
// Replaces three TPU kernels of smqtk_indexing_tpu/ops/pallas_scan.py:
//
// - K2 segment_minima_tiled -> _scan_kernel, 3-D branch (:244-310);
// - K4 segment_minima_blocked -> _blocked_kernel (:457-544), whose
//   (N/128, d, 128) blocked layout is the tiled layout with tile_n = 128;
// - K5 segment_minima_tiled2 -> _scan_kernel_tiled2 (:758-870).
//
// The database db3 is (n_tiles, d, tile_n), tile_n % 128 == 0: row r is
// column r % tile_n of tile r / tile_n, so element (r, j) lies at
// db3[r / tile_n][j][r % tile_n], and a segment's 128 rows are 128
// contiguous values in each of the d dimension rows. With q (B, d) f32,
// db_sq and penalty (N,) f32 (penalty = +inf on dead rows):
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
// What bounds it on an H100, at the capacity configuration (N =
// 100,663,296, d = 128, int8 codes): the products are 2 B N d FLOP, 3.30e12
// at B = 128 and 6.60e12 at B = 256. The bytes that must move are the
// 12.88 GB of codes, 0.40 GB each of db_sq and penalty and the 0.40 GB
// (B = 128) of m1: 4.2 ms at 3.35 TB/s. At B = 128 the least time is that
// memory bound (the products are exact on the bf16 tensor cores, int8 code
// times bf16 query, 3.3 ms at 989 TFLOP/s); at B = 256 the tensor cores
// bound it at 6.7 ms. This kernel adds in full f32 FFMA, with no tensor
// cores: its floor is the 67 TFLOP/s FP32 rate, 49 ms at B = 128 and 98 ms
// at B = 256. So FFMA throughput bounds it, and the design is K1's
// (segment_minima.cu) register-tiled FP32 GEMM with a segment-min
// epilogue, fed from the tiled layout:
//
// - One block of 256 threads owns 128 queries and walks bw consecutive
//   segments (one group; one segment for K2 and K4). Per segment, each
//   thread owns an 8 x 8 micro-tile of scores in registers, and every step
//   of the inner loop issues four 16-byte shared loads for 64 FFMAs.
// - The depth is staged 16 dims at a time through shared memory. A stage
//   of one segment is 16 contiguous 128-value runs of db3: thread t loads
//   8 values of dim t / 16 at rows (t % 16) * 8, so 16 threads read one
//   128-byte int8 run (256 bytes bf16, 512 f32) and the loads coalesce
//   fully, with no transpose (K1's row-major read transposes on store).
// - A bf16 or int8 database is widened to f32 as it is staged; the wrapper
//   rounds the query to bf16 first, so every product is exact in f32, as
//   on the TPU's matrix unit.
// - Each query's segment minimum is reduced in registers over the thread's
//   8 rows, then over the 16 lanes that share the query with warp
//   shuffles. The group minimum is a running minimum of those in
//   registers, written once after the group's last segment: no second
//   pass, no atomics, no dependence on block order. At capacity that is
//   6,144 blocks (B = 128, bw = 128) over 132 SMs.
// - Queries past B are staged as zeros and not written.
// - Blocks are numbered query-tile fastest, so the blocks that read one
//   group run close together and find it in L2.
// - Every global offset is 64-bit: N d passes 2^31 at capacity.
//
// The kernel allocates nothing and launches on the caller's stream. The C
// entry points return cudaGetLastError() after the launch.

#include <cuda_runtime.h>

#include <cstdint>

#include "scan_loads.cuh"

namespace {

constexpr int kSeg = 128;      // rows per segment
constexpr int kTileB = 128;    // queries per block
constexpr int kDepth = 16;     // depth of one shared-memory stage
constexpr int kThreads = 256;
constexpr int kPad = 4;        // keeps rows 16-byte aligned

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
  // Database staging: 8 rows of dim t / 16, starting at row (t % 16) * 8.
  const int xdim = t / 16;
  const int xrow = (t % 16) * 8;

  float gmin[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) gmin[i] = __int_as_float(0x7f800000);  // +inf

  for (int64_t s = group * bw; s < (group + 1) * bw; ++s) {
    const int64_t r0 = s * kSeg;
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
        const float4 a0 = *reinterpret_cast<const float4*>(&q_s[kk][ty * 4]);
        const float4 a1 =
            *reinterpret_cast<const float4*>(&q_s[kk][64 + ty * 4]);
        const float4 b0 = *reinterpret_cast<const float4*>(&x_s[kk][tx * 4]);
        const float4 b1 =
            *reinterpret_cast<const float4*>(&x_s[kk][64 + tx * 4]);
        const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
        const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
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

    float sq[8], pen[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int64_t r = r0 + (j < 4 ? tx * 4 + j : 64 + tx * 4 + (j - 4));
      sq[j] = db_sq[r];
      pen[j] = penalty[r];
    }
    const int64_t step = s / g;
    const int64_t gi = s % g;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
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
      const int64_t qi = q0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + (i - 4));
      if (tx == 0 && qi < n_queries) {
        out1[(step * n_queries + qi) * g + gi] = m;
      }
    }
  }

  if (out2 != nullptr) {
    const int64_t s = group * bw;
    const int64_t ng = g / bw;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int64_t qi = q0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + (i - 4));
      if (tx == 0 && qi < n_queries) {
        out2[((s / g) * n_queries + qi) * ng + (s % g) / bw] = gmin[i];
      }
    }
  }
}

template <typename T>
int launch(const void* q, const void* db3, const void* db_sq,
           const void* penalty, void* out1, void* out2, int64_t n_queries,
           int64_t n_tiles, int64_t dim, int64_t tile_n, int64_t g,
           int64_t bw, int device, void* stream) {
  // This library carries its own CUDA runtime: select the tensors' device
  // in it before launching on the caller's stream.
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  const int64_t nseg = n_tiles * (tile_n / kSeg);
  if (tile_n % kSeg || dim % kDepth || g <= 0 || bw <= 0 || nseg % g
      || g % bw) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t n_qtiles = (n_queries + kTileB - 1) / kTileB;
  const int64_t n_blocks = n_qtiles * (nseg / bw);
  if (n_blocks >= (1LL << 31)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n_blocks > 0) {
    tiled_minima_kernel<T><<<dim3(static_cast<unsigned>(n_blocks)),
                             kThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(q), static_cast<const T*>(db3),
        static_cast<const float*>(db_sq), static_cast<const float*>(penalty),
        static_cast<float*>(out1), static_cast<float*>(out2), n_queries, dim,
        tile_n, g, bw, n_qtiles);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Shape contract (checked by the Python wrapper): db3 (n_tiles, dim,
// tile_n) with tile_n % 128 == 0 and dim % 16 == 0; q (n_queries, dim) f32;
// db_sq and penalty (n_tiles * tile_n,) f32; all contiguous and 16-byte
// aligned on CUDA device `device`. The (B, N / 128) form (K2, K4) writes
// out (n_queries, N / 128); the step-major form (K5) writes m1 (N / 128 / g,
// n_queries, g) and m2 (N / 128 / g, n_queries, g / bw), with g dividing
// N / 128 and bw dividing g.
#define SEGMENT_MINIMA_TILED(NAME, T)                                        \
  extern "C" int segment_minima_tiled_##NAME(                                \
      const void* q, const void* db3, const void* db_sq,                     \
      const void* penalty, void* out, int64_t n_queries, int64_t n_tiles,    \
      int64_t dim, int64_t tile_n, int device, void* stream) {               \
    return launch<T>(q, db3, db_sq, penalty, out, nullptr, n_queries,        \
                     n_tiles, dim, tile_n, n_tiles * (tile_n / kSeg), 1,     \
                     device, stream);                                        \
  }                                                                          \
  extern "C" int segment_minima_tiled2_##NAME(                               \
      const void* q, const void* db3, const void* db_sq,                     \
      const void* penalty, void* m1, void* m2, int64_t n_queries,            \
      int64_t n_tiles, int64_t dim, int64_t tile_n, int64_t g, int64_t bw,   \
      int device, void* stream) {                                            \
    return launch<T>(q, db3, db_sq, penalty, m1, m2, n_queries, n_tiles,     \
                     dim, tile_n, g, bw, device, stream);                    \
  }

SEGMENT_MINIMA_TILED(f32, float)
SEGMENT_MINIMA_TILED(bf16, uint16_t)
SEGMENT_MINIMA_TILED(i8, int8_t)
