// The stage-1 variant probe on Hopper (sm_90a): the capacity scan's
// stage 1 (tiled_minima.cuh) with its epilogue swapped, so that timing the
// variants against each other splits stage 1 into its parts.
//
// Replaces the TPU kernel tools/stage1_analysis.py _run_variant ->
// _variant_kernel (:67-198, pallas_call :176). Each variant computes the
// function of the TPU kernel's variant of the same name, over the tiled
// layout (n_tiles, d, tile_n), into the step-major (n_steps, B, G) output
// with G = t_step * tile_n / 128:
//
// - kFull: K5's m1, the segment minima of (db_sq - 2 <q, x>) + penalty;
// - kFolded: the segment minima of db_sq - 2 <q, x> (no penalty);
// - kNoMin: the first tile_n / 128 scores of each tile, no minimum (the
//   block of the tile's first segment writes them; every block still does
//   its segment's products);
// - kNoDot: the segment minima of (db_sq - 2 x[r, 0]) + penalty, the same
//   for every query: the tile is still staged through shared memory, but
//   no product is taken;
// - kBf16Min: each score rounded to bf16 (to nearest, ties to even) before
//   the minimum.
//
// The TPU probe's "staged" and "minfirst" reorder the TPU kernel's
// instructions and compute kFull's function bit for bit; the port runs
// kFull for them (their GPU analogue, overlapping one segment's epilogue
// with the next one's products, is not written yet).
//
// Each variant has both product forms: int8 codes against a bf16-rounded
// f32 query (FFMA, as the TPU probe's main() runs it) and against an int8
// query (__dp4a). What bounds them: kNoDot moves the full stage's bytes
// and does no products, so its time against the memory bound (bytes /
// 3.35 TB/s) says how far the staging alone is from the card's rate; the
// others do kFull's products, whose issue rate bounds kFull (see
// segment_minima_tiled.cu).
//
// The kernels allocate nothing and launch on the caller's stream. The C
// entry points return cudaGetLastError() after the launch.

#include "tiled_minima.cuh"

namespace {

template <int V>
int launch_variant(bool i8i8, const void* q, const void* db3,
                   const void* db_sq, const void* penalty, void* out,
                   int64_t n_queries, int64_t n_tiles, int64_t dim,
                   int64_t tile_n, int64_t g, int device, void* stream) {
  if (i8i8) {
    return launch_tiled_i8i8<V>(q, db3, db_sq, penalty, out, nullptr,
                                n_queries, n_tiles, dim, tile_n, g, 1, 1.0f,
                                device, stream);
  }
  return launch_tiled<int8_t, V>(q, db3, db_sq, penalty, out, nullptr,
                                 n_queries, n_tiles, dim, tile_n, g, 1,
                                 device, stream);
}

int dispatch(bool i8i8, const void* q, const void* db3, const void* db_sq,
             const void* penalty, void* out, int64_t n_queries,
             int64_t n_tiles, int64_t dim, int64_t tile_n, int64_t g,
             int64_t variant, int device, void* stream) {
  switch (variant) {
    case kFull:
      return launch_variant<kFull>(i8i8, q, db3, db_sq, penalty, out,
                                   n_queries, n_tiles, dim, tile_n, g,
                                   device, stream);
    case kFolded:
      return launch_variant<kFolded>(i8i8, q, db3, db_sq, penalty, out,
                                     n_queries, n_tiles, dim, tile_n, g,
                                     device, stream);
    case kNoMin:
      return launch_variant<kNoMin>(i8i8, q, db3, db_sq, penalty, out,
                                    n_queries, n_tiles, dim, tile_n, g,
                                    device, stream);
    case kNoDot:
      return launch_variant<kNoDot>(i8i8, q, db3, db_sq, penalty, out,
                                    n_queries, n_tiles, dim, tile_n, g,
                                    device, stream);
    case kBf16Min:
      return launch_variant<kBf16Min>(i8i8, q, db3, db_sq, penalty, out,
                                      n_queries, n_tiles, dim, tile_n, g,
                                      device, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Shape contract (checked by the Python wrapper): db3 (n_tiles, dim,
// tile_n) int8 with tile_n % 128 == 0 (and tile_n <= 16384 for kNoMin),
// dim % 16 == 0 (dim % 32 == 0 for the int8 query); q (n_queries, dim) f32
// holding bf16 values, or int8; db_sq and penalty (n_tiles * tile_n,) f32;
// out (N / 128 / g, n_queries, g) f32 with g dividing N / 128; all
// contiguous and 16-byte aligned on CUDA device `device`. `variant` is one
// of the Variant values of tiled_minima.cuh.
extern "C" int stage1_variant_i8(const void* q, const void* db3,
                                 const void* db_sq, const void* penalty,
                                 void* out, int64_t n_queries,
                                 int64_t n_tiles, int64_t dim,
                                 int64_t tile_n, int64_t g, int64_t variant,
                                 int device, void* stream) {
  return dispatch(false, q, db3, db_sq, penalty, out, n_queries, n_tiles,
                  dim, tile_n, g, variant, device, stream);
}

extern "C" int stage1_variant_i8i8(const void* q, const void* db3,
                                   const void* db_sq, const void* penalty,
                                   void* out, int64_t n_queries,
                                   int64_t n_tiles, int64_t dim,
                                   int64_t tile_n, int64_t g,
                                   int64_t variant, int device,
                                   void* stream) {
  return dispatch(true, q, db3, db_sq, penalty, out, n_queries, n_tiles,
                  dim, tile_n, g, variant, device, stream);
}
