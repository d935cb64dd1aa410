// Stage 1 of the single-copy SQ8 capacity scan: per-128-row segment minima
// of the L2 surrogate over the tiled-transposed layout, with an optional
// second output of per-group minima, written by hand for Hopper (sm_90a).
// The kernels themselves are in tiled_minima.cuh (layout, outputs, both
// product forms); this file holds the production entry points of the f32
// and bf16 databases. Int8 codes, with a float query (the capacity scan's
// own form) or an int8 query (the i8dot form, and K10's int8 arm), run on
// the tensor cores instead: segment_minima_tiled_wgmma.cu holds their
// entry points.
//
// Replaces three TPU kernels of smqtk_indexing_tpu/ops/pallas_scan.py:
//
// - K2 segment_minima_tiled -> _scan_kernel, 3-D branch (:244-310);
// - K4 segment_minima_blocked -> _blocked_kernel (:457-544), whose
//   (N/128, d, 128) blocked layout is the tiled layout with tile_n = 128;
// - K5 segment_minima_tiled2 -> _scan_kernel_tiled2 (:758-870);
//
// here over an f32 or bf16 database against an f32 (bf16-rounded) query
// (the f32 product form of _tile_ip, :50-82).
//
// What bounds it on an H100: 2 B N d operations, which these kernels add
// in f32 FFMA at the 67 TFLOP/s FP32 rate (49 ms at the capacity
// configuration, N = 100,663,296, d = 128, B = 128, where the bytes take
// 4.2 ms), so the issue rate of the inner loop bounds them, and the design
// is K1's register-tiled GEMM with a segment-min epilogue
// (tiled_minima.cuh). No caller of the port passes an f32 or bf16 tiled
// database; the SQ8 capacity scan runs the tensor-core kernel.
//
// The kernels allocate nothing and launch on the caller's stream. The C
// entry points return cudaGetLastError() after the launch.

#include "tiled_minima.cuh"

// Shape contract (checked by the Python wrapper): db3 (n_tiles, dim,
// tile_n) f32 or bf16 with tile_n % 128 == 0 and dim % 16 == 0; q
// (n_queries, dim) f32; db_sq and penalty (n_tiles * tile_n,) f32; all
// contiguous and 16-byte aligned on CUDA device `device`. The (B, N / 128)
// form (K2, K4) writes out (n_queries, N / 128); the step-major form (K5)
// writes m1 (N / 128 / g, n_queries, g) and m2 (N / 128 / g, n_queries,
// g / bw), with g dividing N / 128 and bw dividing g.
#define SEGMENT_MINIMA_TILED(NAME, T)                                        \
  extern "C" int segment_minima_tiled_##NAME(                                \
      const void* q, const void* db3, const void* db_sq,                     \
      const void* penalty, void* out, int64_t n_queries, int64_t n_tiles,    \
      int64_t dim, int64_t tile_n, int device, void* stream) {               \
    return launch_tiled<T>(q, db3, db_sq, penalty, out, nullptr, n_queries,  \
                           n_tiles, dim, tile_n, n_tiles * (tile_n / kSeg),  \
                           1, device, stream);                               \
  }                                                                          \
  extern "C" int segment_minima_tiled2_##NAME(                               \
      const void* q, const void* db3, const void* db_sq,                     \
      const void* penalty, void* m1, void* m2, int64_t n_queries,            \
      int64_t n_tiles, int64_t dim, int64_t tile_n, int64_t g, int64_t bw,   \
      int device, void* stream) {                                            \
    return launch_tiled<T>(q, db3, db_sq, penalty, m1, m2, n_queries,        \
                           n_tiles, dim, tile_n, g, bw, device, stream);     \
  }

SEGMENT_MINIMA_TILED(f32, float)
SEGMENT_MINIMA_TILED(bf16, uint16_t)
