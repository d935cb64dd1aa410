// Stage 1 of the exact flat kNN scan: per-128-row segment minima of the L2
// surrogate, written by hand for Hopper (sm_90a). This file holds its exact
// f32 form, the TPU kernel's "highest" mode (SMQTK_TPU_STAGE1=highest,
// precision="highest"); the f32 store's default, split3, and native run on
// the tensor cores in segment_minima_wgmma.cu, as do the bf16, int8-code
// and int8 x int8 forms.
//
// Replaces the TPU kernel smqtk_indexing_tpu/ops/pallas_scan.py
// segment_minima -> _scan_kernel (2-D branch, :102-241). It computes
//
//     out[b, s] = min over r in [128 s, 128 s + 128) of
//                 (db_sq[r] - 2 <q_b, x_r>) + penalty[r]
//
// for q (B, d) f32, db (N, d) row-major f32, db_sq and penalty (N,) f32
// (penalty = +inf on dead rows), out (B, N / 128) f32. The (B, N) score
// matrix never reaches device memory: each block keeps its scores in
// registers and writes one minimum per query and segment.
//
// What bounds the f32 form on an H100: at the main path's shapes
// (B = 2048, N = 1,048,576, d = 128) the products are 2 B N d = 5.5e11
// FLOP, about 8 ms at the card's 67 TFLOP/s FP32 (non-tensor-core) peak,
// while the database is 512 MB, about 0.16 ms at 3.35 TB/s even if read
// once per 128-query tile. FFMA throughput bounds it, and only FFMA keeps
// f32 products exact, so the design is a classic register-tiled FP32 GEMM
// whose epilogue is the segment minimum:
//
// - One block of 256 threads owns a tile of 128 queries x 128 rows (one
//   segment). Each thread owns an 8 x 8 micro-tile of scores in registers
//   (queries ty*4 + {0..3} and 64 + ty*4 + {0..3}, rows tx*4 + {0..3} and
//   64 + tx*4 + {0..3}), so every step of the inner loop issues four
//   16-byte shared loads for 64 FFMAs.
// - The depth d is walked in chunks of 16, staged through 16 KB of shared
//   memory with coalesced 16-byte global loads; shared memory does not grow
//   with d.
// - Accumulation is full f32 FFMA: no TF32, no tensor cores.
// - Each query's minimum over its segment is reduced in registers across
//   the thread's 8 rows, then across the 16 threads of the half-warp that
//   share the query with warp shuffles.
// - Blocks are numbered query-tile fastest, so the B / 128 blocks that read
//   the same segment run close together and find it in L2.
// - Every global offset is 64-bit: N * d passes 2^31 at 100M rows.
//
// The kernel allocates nothing and launches on the caller's stream. The C
// entry point returns cudaGetLastError() after the launch.

#include <cuda_runtime.h>

#include <cstdint>

#include "scan_loads.cuh"

namespace {

constexpr int kSeg = 128;      // rows per segment (one block's row tile)
constexpr int kTileB = 128;    // queries per block
constexpr int kDepth = 16;     // depth of one shared-memory stage
constexpr int kThreads = 256;
constexpr int kPad = 4;        // keeps rows 16-byte aligned

__global__ void __launch_bounds__(kThreads, 2)
segment_minima_kernel(const float* __restrict__ q,
                      const float* __restrict__ db,
                      const float* __restrict__ db_sq,
                      const float* __restrict__ penalty,
                      float* __restrict__ out, int64_t n_queries,
                      int64_t n_rows, int64_t dim, int64_t n_qtiles) {
  __shared__ __align__(16) float q_s[kDepth][kTileB + kPad];
  __shared__ __align__(16) float x_s[kDepth][kSeg + kPad];

  const int64_t tile = blockIdx.x;
  const int64_t q0 = (tile % n_qtiles) * kTileB;
  const int64_t seg = tile / n_qtiles;
  const int64_t r0 = seg * kSeg;
  const int t = threadIdx.x;
  const int tx = t % 16;  // row group: lanes 0-15 / 16-31 of a warp
  const int ty = t / 16;  // query group

  // Staging: thread t copies 8 consecutive depth values of tile row t / 2.
  const int lrow = t / 2;
  const int lcol = (t % 2) * 8;
  const bool q_live = q0 + lrow < n_queries;
  const float* q_src = q + (q_live ? q0 + lrow : 0) * dim + lcol;
  const float* x_src = db + (r0 + lrow) * dim + lcol;

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
    load8(x_src + k0, v);
#pragma unroll
    for (int i = 0; i < 8; ++i) x_s[lcol + i][lrow] = v[i];
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
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
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
  const int64_t n_seg = n_rows / kSeg;
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
    const int64_t qi = q0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + (i - 4));
    if (tx == 0 && qi < n_queries) out[qi * n_seg + seg] = m;
  }
}

int launch(const float* q, const float* db, const float* db_sq,
           const float* penalty, float* out, int64_t n_queries,
           int64_t n_rows, int64_t dim, int device, cudaStream_t stream) {
  // This library carries its own CUDA runtime: select the tensors' device
  // in it before launching on the caller's stream.
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  const int64_t n_qtiles = (n_queries + kTileB - 1) / kTileB;
  const int64_t n_blocks = n_qtiles * (n_rows / kSeg);
  if (n_blocks > 0) {
    segment_minima_kernel<<<dim3(static_cast<unsigned>(n_blocks)), kThreads,
                            0, stream>>>(
        q, db, db_sq, penalty, out, n_queries, n_rows, dim, n_qtiles);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Shape contract (checked by the Python wrapper): n_rows % 128 == 0,
// dim % 128 == 0, all arrays contiguous and 16-byte aligned on CUDA device
// `device`, n_blocks = ceil(n_queries / 128) * n_rows / 128 < 2^31.
extern "C" int segment_minima_f32(const void* q, const void* db,
                                  const void* db_sq, const void* penalty,
                                  void* out, int64_t n_queries,
                                  int64_t n_rows, int64_t dim, int device,
                                  void* stream) {
  return launch(static_cast<const float*>(q), static_cast<const float*>(db),
                static_cast<const float*>(db_sq),
                static_cast<const float*>(penalty), static_cast<float*>(out),
                n_queries, n_rows, dim, device,
                static_cast<cudaStream_t>(stream));
}
