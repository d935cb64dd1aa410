// Stage 1 of the single-copy SQ8 capacity scan: per-128-row segment minima
// of the L2 surrogate over the tiled-transposed layout, with an optional
// second output of per-group minima, written by hand for Hopper (sm_90a).
// The kernels themselves are in tiled_minima.cuh (layout, outputs, both
// product forms); this file holds the production entry points of the f32
// and bf16 databases and of the int8 x int8 form. Int8 codes with a float
// query (the capacity scan's own form) run on the tensor cores instead:
// segment_minima_tiled_wgmma.cu holds their entry points.
//
// Replaces three TPU kernels of smqtk_indexing_tpu/ops/pallas_scan.py:
//
// - K2 segment_minima_tiled -> _scan_kernel, 3-D branch (:244-310);
// - K4 segment_minima_blocked -> _blocked_kernel (:457-544), whose
//   (N/128, d, 128) blocked layout is the tiled layout with tile_n = 128;
// - K5 segment_minima_tiled2 -> _scan_kernel_tiled2 (:758-870);
//
// each in the TPU kernel's two product forms (_tile_ip, :50-82): an f32
// or bf16 database against an f32 (bf16-rounded) query, and the
// int8 x int8 form of the i8dot stage 1 (int8 codes against an int8
// query; smqtk_indexing_tpu/ops/sq8.py:368-374). The int8 x int8 entries
// also serve the int8 arm of the K10 probe (tools/probe_int8_mxu.py:65,
// through smqtk_indexing_tpu_torch/tools/probe_int8_mxu.py) with its
// scale g.
//
// What bounds it on an H100, at the capacity configuration (N =
// 100,663,296, d = 128, int8 codes): the products are 2 B N d operations,
// 3.30e12 at B = 128 and 6.60e12 at B = 256. The bytes that must move are
// the 12.88 GB of codes, 0.40 GB each of db_sq and penalty and the 0.40 GB
// (B = 128) of m1: 4.2 ms at 3.35 TB/s. At B = 128 the least time is that
// memory bound (the products are exact on the tensor cores: 3.3 ms at
// bf16's 989 TFLOP/s, 1.7 ms at int8's 1,979 TOPS). These kernels use no
// tensor cores:
//
// - the FFMA form adds in f32 at the 67 TFLOP/s FP32 rate, 49 ms at B =
//   128 and 98 ms at B = 256;
// - the int8 x int8 form issues one __dp4a (IDP4A) per 4 products and
//   sums in int32. At half the FFMA issue rate it would do twice FFMA's
//   products a clock: about 25 ms at B = 128 if the issue rate alone
//   bounded it. Each staged word also feeds 4 products, so it reads a
//   quarter of FFMA's shared-memory operands per product.
//
// So the issue rate of the inner loop bounds both, and the design is K1's
// register-tiled GEMM with a segment-min epilogue (tiled_minima.cuh).
//
// The kernels allocate nothing and launch on the caller's stream. The C
// entry points return cudaGetLastError() after the launch.

#include "tiled_minima.cuh"

// Shape contract (checked by the Python wrapper): db3 (n_tiles, dim,
// tile_n) f32 or bf16 (int8 for the int8 x int8 form) with tile_n % 128
// == 0 and dim % 16 == 0 (dim % 32 == 0 for the int8 x int8 form); q
// (n_queries, dim) f32 (int8 for the int8 x int8 form); db_sq and penalty (n_tiles * tile_n,) f32; all contiguous and
// 16-byte aligned on CUDA device `device`. The (B, N / 128) form (K2, K4)
// writes out (n_queries, N / 128); the step-major form (K5) writes m1
// (N / 128 / g, n_queries, g) and m2 (N / 128 / g, n_queries, g / bw),
// with g dividing N / 128 and bw dividing g.
#define SEGMENT_MINIMA_TILED(NAME, T)                                        \
  extern "C" int segment_minima_tiled_##NAME(                                \
      const void* q, const void* db3, const void* db_sq,                     \
      const void* penalty, void* out, int64_t n_queries, int64_t n_tiles,    \
      int64_t dim, int64_t tile_n, int device, void* stream) {               \
    return launch_tiled<T, kFull>(q, db3, db_sq, penalty, out, nullptr,      \
                                  n_queries, n_tiles, dim, tile_n,           \
                                  n_tiles * (tile_n / kSeg), 1, device,      \
                                  stream);                                   \
  }                                                                          \
  extern "C" int segment_minima_tiled2_##NAME(                               \
      const void* q, const void* db3, const void* db_sq,                     \
      const void* penalty, void* m1, void* m2, int64_t n_queries,            \
      int64_t n_tiles, int64_t dim, int64_t tile_n, int64_t g, int64_t bw,   \
      int device, void* stream) {                                            \
    return launch_tiled<T, kFull>(q, db3, db_sq, penalty, m1, m2,            \
                                  n_queries, n_tiles, dim, tile_n, g, bw,    \
                                  device, stream);                           \
  }

SEGMENT_MINIMA_TILED(f32, float)
SEGMENT_MINIMA_TILED(bf16, uint16_t)

// The int8 x int8 form: scores (db_sq - 2 (float(<q, x>) * scale)) +
// penalty; the production i8dot passes scale = 1.
extern "C" int segment_minima_tiled_i8i8(
    const void* q, const void* db3, const void* db_sq, const void* penalty,
    void* out, int64_t n_queries, int64_t n_tiles, int64_t dim,
    int64_t tile_n, float scale, int device, void* stream) {
  return launch_tiled_i8i8<kFull>(q, db3, db_sq, penalty, out, nullptr,
                                  n_queries, n_tiles, dim, tile_n,
                                  n_tiles * (tile_n / kSeg), 1, scale,
                                  device, stream);
}

extern "C" int segment_minima_tiled2_i8i8(
    const void* q, const void* db3, const void* db_sq, const void* penalty,
    void* m1, void* m2, int64_t n_queries, int64_t n_tiles, int64_t dim,
    int64_t tile_n, int64_t g, int64_t bw, float scale, int device,
    void* stream) {
  return launch_tiled_i8i8<kFull>(q, db3, db_sq, penalty, m1, m2, n_queries,
                                  n_tiles, dim, tile_n, g, bw, scale, device,
                                  stream);
}
