// Stage 1 of the exact flat kNN scan over a bf16 or int8-code database,
// with its products on Hopper's tensor cores (wgmma, sm_90a): the bf16,
// int8-code and int8 x int8 forms of K1. The f32 form stays in
// segment_minima.cu.
//
// Replaces the TPU kernel smqtk_indexing_tpu/ops/pallas_scan.py:173
// segment_minima -> _scan_kernel (2-D branch, :152-162), which runs the
// same products on the TPU's matrix unit. It computes
//
//     out[b, s] = min over r in [128 s, 128 s + 128) of
//                 (db_sq[r] - 2 <q_b, x_r>) + penalty[r]
//
// for q (B, d), db (N, d) row-major, db_sq and penalty (N,) f32 (penalty =
// +inf on dead rows), out (B, N / 128) f32, in three forms:
//
// - bf16: db bf16, q bf16 (the query rounded to bf16 by the wrapper);
// - int8 codes: db the flat SQ8 store's codes u, q the bf16-rounded codec
//   fold (q - b) a, db_sq the rows' sum((a u)^2). Every product of a bf16
//   value with a bf16 value or an int8 code is exact in f32, so the tensor
//   cores' bf16 x bf16 -> f32 products change nothing but the order and
//   rounding of the f32 sums;
// - int8 x int8 (segment_minima_i8i8, the store's i8dot stage 1,
//   smqtk_indexing_tpu/ops/sq8.py:253-257; the TPU kernel's int8 x int8 ->
//   int32 dot in _tile_ip, pallas_scan.py:53-61): db the codes, q the fold
//   quantised to int8 with one scale, db_sq the stats divided by it. The
//   products run as wgmma s8 x s8 -> s32, exact in any order; the epilogue
//   is (db_sq - 2 float(acc)) + penalty, and float(acc) is exact below 2^24
//   (d <= 1040), so the result is bit-equal to the plain PyTorch version.
//
// What bounds it on an H100: 2 B N d operations, 5.5e11 at the flat path's
// shapes (B = 2048, N = 2^20, d = 128): 0.556 ms at the card's 989 TFLOP/s
// dense bf16 tensor-core rate, 0.278 ms at its 1,979 TOPS int8 rate; the
// database is 256 MB (bf16) or 128 MB (int8), under 0.08 ms at 3.35 TB/s if
// read once. The products bound it, so the design keeps the tensor cores
// fed and the (B, N) scores out of memory:
//
// - A block of two warpgroups (256 threads) owns 256 queries (128 where
//   256 do not fit resident) and walks a strip of kStrip consecutive
//   128-row segments. Each warpgroup issues wgmma.m64n128 (k16 bf16 or k32
//   int8) for one or two 64-query tiles (A, from shared memory) against
//   one segment's 128 rows (B): 64 or 128 accumulators a thread.
// - A K-chunk is one 128-byte swizzled row: 64 bf16 dims or 128 int8 dims,
//   four K steps either way. The query tile is resident in shared memory
//   for the whole strip while it fits beside the ring (bf16: d <= 640;
//   int8: d <= 1280); above that, its K-chunks stream through the ring
//   with the database's, which costs L2 traffic but keeps any d right.
// - The database streams through a ring of kStages stages, one K-chunk of
//   one segment (16 KB) each, in the 128-byte swizzle layout of wgmma.cuh.
//   bf16 rows and int8 rows under an int8 query arrive by cp.async (K1's
//   database is row-major, so K-major already: no register work); the int8
//   x int8 form zero-fills a chunk's tail past d in both operands, so any
//   d % 32 == 0 is right. Int8 codes under a bf16 query are read into
//   registers one step ahead, widened exactly to bf16 (2^23 + u as f32
//   bits, less 2^23 + 128: two byte permutes and an add per code, no
//   int-to-float conversion) and stored at the same swizzled addresses:
//   wgmma takes no int8 x bf16 product, and widening keeps it on the
//   tensor cores at the bf16 rate.
// - Epilogue, once a segment's last K-chunk is summed: each thread holds
//   32 columns of two query rows per tile; it folds
//   (db_sq - 2 ip) + penalty into a minimum in registers (float2 loads of
//   db_sq and penalty match its column pairs), then across the 4 lanes of
//   its quad with two shuffles, and one lane writes out[b, s] with 64-bit
//   offsets. No shared-memory reduction. The int8 x int8 form converts
//   each s32 sum to f32 for it (I2F, inner() of scan_loads.cuh).
// - Blocks are numbered query-tile fastest, so the blocks that read one
//   strip run together and find it in L2.
// - The first form waits for each step's wgmma group before the next
//   step; overlapping a segment's epilogue with the next one's products is
//   later work.
//
// The block geometry, the query staging, the widening and the epilogue's
// fold and quad reduction are shared with the tiled layout's kernel
// (segment_minima_tiled_wgmma.cu) through wgmma_minima.cuh.
//
// The kernel allocates nothing and launches on the caller's stream. The C
// entry points return cudaGetLastError() after the launch.

#include <cuda_runtime.h>

#include <cstdint>

#include "wgmma_minima.cuh"

namespace {

constexpr int kStages = 4;      // ring depth
constexpr int kStrip = 32;      // segments a block walks

template <int kMTiles, bool kStreamQ>
__host__ __device__ constexpr int stage_bytes() {
  return kDbStageBytes + (kStreamQ ? q_rows<kMTiles>() * kSwizzleBytes : 0);
}

// Dynamic shared memory: the ring, the resident query tile, and 1 KB to
// align the start to a swizzle atom.
template <typename Q, int kMTiles, bool kStreamQ>
int64_t smem_bytes(int64_t dim) {
  const int64_t n_chunks = (dim + chunk_dims<Q>() - 1) / chunk_dims<Q>();
  const int64_t q_res =
      kStreamQ ? 0 : q_rows<kMTiles>() * n_chunks * kSwizzleBytes;
  return kAtomBytes + kStages * stage_bytes<kMTiles, kStreamQ>() + q_res;
}

// Q: the query's type (uint16_t for bf16, int8_t); T: the database's. A
// bf16 query over int8 codes widens them (kWiden).
template <typename Q, typename T, int kMTiles, bool kStreamQ>
__global__ void __launch_bounds__(kThreads, 1)
segment_minima_wgmma_kernel(const Q* __restrict__ q,
                            const T* __restrict__ db,
                            const float* __restrict__ db_sq,
                            const float* __restrict__ penalty,
                            float* __restrict__ out, int64_t n_queries,
                            int64_t n_rows, int64_t dim, int64_t n_qtiles) {
  constexpr bool kWiden = sizeof(T) != sizeof(Q);
  constexpr int kDims = chunk_dims<Q>();
  constexpr int kQRows = q_rows<kMTiles>();
  constexpr int kQChunkBytes = kQRows * kSwizzleBytes;
  constexpr int kStageBytes = stage_bytes<kMTiles, kStreamQ>();
  using Acc = typename MmaAcc<Q>::type;

  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t ring = (raw + kAtomBytes - 1) & ~uint32_t(kAtomBytes - 1);
  uint8_t* const ring_ptr = smem_raw + (ring - raw);
  const uint32_t q_res = ring + kStages * kStageBytes;

  const int tid = threadIdx.x;
  const int wg = tid >> 7;
  const int64_t q0 = (blockIdx.x % n_qtiles) * kQRows;
  const int64_t n_seg = n_rows / kSeg;
  const int64_t seg0 = (blockIdx.x / n_qtiles) * kStrip;
  const int n_chunks = static_cast<int>((dim + kDims - 1) / kDims);
  const int n_steps =
      static_cast<int>(n_seg - seg0 < kStrip ? n_seg - seg0 : kStrip) *
      n_chunks;

  // Step t is K-chunk t % n_chunks of segment seg0 + t / n_chunks.
  auto q_row = [&](int c) {
    return [=](int r) {
      // Rows past the batch read its last query; they are never written.
      const int64_t qr = q0 + r < n_queries ? q0 + r : n_queries - 1;
      return q + qr * dim + c * kDims;
    };
  };
  auto db_row = [&](int t) {
    const int64_t r0 = (seg0 + t / n_chunks) * kSeg;
    const int c = t % n_chunks;
    return [=](int r) { return db + (r0 + r) * dim + c * kDims; };
  };
  // Live 16-byte pieces of K-chunk c: the int8 x int8 form's last chunk
  // may end early (d % 32 == 0: whole pieces); the others take d % 128.
  auto live_pieces = [&](int c) {
    const int64_t left = (dim - c * kDims) / piece_dims<Q>();
    return static_cast<int>(left < 8 ? left : 8);
  };
  // The cp.async copies of step t (if any): the db chunk (unless it is
  // widened) and, when the queries stream, the query chunk.
  auto issue = [&](int t) {
    if (t >= n_steps) return;
    const uint32_t stage = ring + (t % kStages) * kStageBytes;
    const int c = t % n_chunks;
    if constexpr (!kWiden) {
      copy_chunk<kSeg>(stage, db_row(t), tid, live_pieces(c));
    }
    if constexpr (kStreamQ) {
      copy_chunk<kQRows>(stage + kDbStageBytes, q_row(c), tid,
                         live_pieces(c));
    }
  };

  // Widening: thread tid stages 32 codes of row tid / 2 (half tid % 2 of
  // the chunk) through registers, widened into 4 swizzled bf16 pieces.
  uint4 codes[2];
  auto load_codes = [&](int t) {
    if constexpr (kWiden) {
      const int8_t* src = reinterpret_cast<const int8_t*>(db_row(t)(tid >> 1)) +
                          (tid & 1) * 32;
      codes[0] = __ldg(reinterpret_cast<const uint4*>(src));
      codes[1] = __ldg(reinterpret_cast<const uint4*>(src + 16));
    }
  };
  auto store_codes = [&](int t) {
    if constexpr (kWiden) {
      uint8_t* stage = ring_ptr + (t % kStages) * kStageBytes;
      const uint32_t w[8] = {codes[0].x ^ 0x80808080u, codes[0].y ^ 0x80808080u,
                             codes[0].z ^ 0x80808080u, codes[0].w ^ 0x80808080u,
                             codes[1].x ^ 0x80808080u, codes[1].y ^ 0x80808080u,
                             codes[1].z ^ 0x80808080u, codes[1].w ^ 0x80808080u};
      const int r = tid >> 1;
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        uint4 v;
        v.x = codes_to_bf16x2(w[2 * p], 0);
        v.y = codes_to_bf16x2(w[2 * p], 2);
        v.z = codes_to_bf16x2(w[2 * p + 1], 0);
        v.w = codes_to_bf16x2(w[2 * p + 1], 2);
        *reinterpret_cast<uint4*>(
            stage + swizzle_offset(r, (tid & 1) * 4 + p)) = v;
      }
    }
  };

  Acc acc[kMTiles][64];
#pragma unroll
  for (int i = 0; i < kMTiles; ++i) {
#pragma unroll
    for (int j = 0; j < 64; ++j) acc[i][j] = 0;
  }

  // Prologue: the resident query tile and steps 0 .. kStages - 2 (the
  // query tile joins step 0's group), then widened steps 0 and 1.
  if constexpr (!kStreamQ) {
    for (int c = 0; c < n_chunks; ++c) {
      copy_chunk<kQRows>(q_res + c * kQChunkBytes, q_row(c), tid,
                         live_pieces(c));
    }
  }
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    issue(s);
    cp_async_commit();
  }
  load_codes(0);
  store_codes(0);
  load_codes(1);  // widened: n_steps >= 2, d is a multiple of 128

  const int lane = tid & 31;
  const int warp = (tid >> 5) & 3;
  for (int t = 0; t < n_steps; ++t) {
    cp_async_wait<kStages - 2>();  // step t's copies have landed
    fence_proxy_async();
    __syncthreads();  // ... everyone's; step t - 1's wgmma are done
    issue(t + kStages - 1);  // into the stage step t - 1 read
    cp_async_commit();
    if (t + 1 < n_steps) {
      store_codes(t + 1);
      if (t + 2 < n_steps) load_codes(t + 2);
    }

    const int c = t % n_chunks;
    const uint32_t stage = ring + (t % kStages) * kStageBytes;
    const uint32_t a_tile = (kStreamQ ? stage + kDbStageBytes
                                      : q_res + c * kQChunkBytes) +
                            wg * kMTiles * kMTile * kSwizzleBytes;
#pragma unroll
    for (int i = 0; i < kMTiles; ++i) {
#pragma unroll
      for (int j = 0; j < 64; ++j) fence_operand(acc[i][j]);
    }
    wgmma_fence();
#pragma unroll
    for (int k = 0; k < kSwizzleBytes / kKStepBytes; ++k) {
      const uint64_t b_desc = smem_desc(stage + k * kKStepBytes);
#pragma unroll
      for (int i = 0; i < kMTiles; ++i) {
        const uint64_t a_desc =
            smem_desc(a_tile + i * kMTile * kSwizzleBytes + k * kKStepBytes);
        wgmma_step(acc[i], a_desc, b_desc, (c | k) != 0);
      }
    }
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int i = 0; i < kMTiles; ++i) {
#pragma unroll
      for (int j = 0; j < 64; ++j) fence_operand(acc[i][j]);
    }
    if (c != n_chunks - 1) continue;

    // Epilogue of segment seg: this thread's columns 8 j + 2 (lane % 4) +
    // e of query rows 16 warp + lane / 4 + 8 h of each tile.
    const int64_t seg = seg0 + t / n_chunks;
    const int64_t r0 = seg * kSeg + 2 * (lane & 3);
    float m[kMTiles][2];
    fold_minima<kMTiles>(acc, 1.0f, [&](int j) {
      // float2 loads of db_sq and penalty match the column pairs.
      const float2 sq = __ldg(reinterpret_cast<const float2*>(db_sq + r0 + 8 * j));
      const float2 pen =
          __ldg(reinterpret_cast<const float2*>(penalty + r0 + 8 * j));
      return make_float4(sq.x, sq.y, pen.x, pen.y);
    }, m);
#pragma unroll
    for (int i = 0; i < kMTiles; ++i) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float v = quad_min(m[i][h]);
        const int64_t qi = q0 + (wg * kMTiles + i) * kMTile + warp * 16 +
                           (lane >> 2) + 8 * h;
        if ((lane & 3) == 0 && qi < n_queries) out[qi * n_seg + seg] = v;
      }
    }
  }
}

template <typename Q, typename T, int kMTiles, bool kStreamQ>
int launch_variant(const Q* q, const T* db, const float* db_sq,
                   const float* penalty, float* out, int64_t n_queries,
                   int64_t n_rows, int64_t dim, cudaStream_t stream) {
  auto kernel = segment_minima_wgmma_kernel<Q, T, kMTiles, kStreamQ>;
  const int64_t smem = smem_bytes<Q, kMTiles, kStreamQ>(dim);
  const cudaError_t set = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (set != cudaSuccess) return static_cast<int>(set);
  const int64_t n_qtiles = (n_queries + q_rows<kMTiles>() - 1) /
                           q_rows<kMTiles>();
  const int64_t n_strips = (n_rows / kSeg + kStrip - 1) / kStrip;
  const int64_t n_blocks = n_qtiles * n_strips;
  if (n_blocks >= (1LL << 31)) return static_cast<int>(cudaErrorInvalidValue);
  if (n_blocks > 0) {
    kernel<<<dim3(static_cast<unsigned>(n_blocks)), kThreads,
             static_cast<size_t>(smem), stream>>>(
        q, db, db_sq, penalty, out, n_queries, n_rows, dim, n_qtiles);
  }
  return static_cast<int>(cudaGetLastError());
}

// Picks the widest query tile that stays resident beside the ring: 256
// queries (bf16: d <= 256; int8: d <= 640), 128 (bf16: d <= 640; int8: d
// <= 1280), else 256 streamed with the database.
template <typename Q, typename T>
int launch(const void* q, const void* db, const void* db_sq,
           const void* penalty, void* out, int64_t n_queries, int64_t n_rows,
           int64_t dim, int device, void* stream) {
  // This library carries its own CUDA runtime: select the tensors' device
  // in it before launching on the caller's stream.
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  // The int8 x int8 form takes whole k32 steps; the others whole 128-dim
  // pairs of bf16 K-chunks (the widening stages two steps ahead).
  const int64_t unit = sizeof(Q) == 1 ? 32 : 2 * kChunkBf16;
  if (n_rows % kSeg || dim % unit || dim <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto* qq = static_cast<const Q*>(q);
  const auto* x = static_cast<const T*>(db);
  const auto* sq = static_cast<const float*>(db_sq);
  const auto* pen = static_cast<const float*>(penalty);
  auto* o = static_cast<float*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  if (smem_bytes<Q, 2, false>(dim) <= kMaxSmem) {
    return launch_variant<Q, T, 2, false>(qq, x, sq, pen, o, n_queries,
                                          n_rows, dim, s);
  }
  if (smem_bytes<Q, 1, false>(dim) <= kMaxSmem) {
    return launch_variant<Q, T, 1, false>(qq, x, sq, pen, o, n_queries,
                                          n_rows, dim, s);
  }
  return launch_variant<Q, T, 2, true>(qq, x, sq, pen, o, n_queries, n_rows,
                                       dim, s);
}

}  // namespace

// Shape contract (checked by the Python wrapper): q (n_queries, dim) bf16,
// db (n_rows, dim) bf16 or int8, dim % 128 == 0; for segment_minima_i8i8
// q and db int8, dim % 32 == 0; n_rows % 128 == 0, all arrays contiguous
// and 16-byte aligned on CUDA device `device`.
extern "C" int segment_minima_bf16(const void* q, const void* db,
                                   const void* db_sq, const void* penalty,
                                   void* out, int64_t n_queries,
                                   int64_t n_rows, int64_t dim, int device,
                                   void* stream) {
  return launch<uint16_t, uint16_t>(q, db, db_sq, penalty, out, n_queries,
                                    n_rows, dim, device, stream);
}

extern "C" int segment_minima_i8(const void* q, const void* db,
                                 const void* db_sq, const void* penalty,
                                 void* out, int64_t n_queries, int64_t n_rows,
                                 int64_t dim, int device, void* stream) {
  return launch<uint16_t, int8_t>(q, db, db_sq, penalty, out, n_queries,
                                  n_rows, dim, device, stream);
}

extern "C" int segment_minima_i8i8(const void* q, const void* db,
                                   const void* db_sq, const void* penalty,
                                   void* out, int64_t n_queries,
                                   int64_t n_rows, int64_t dim, int device,
                                   void* stream) {
  return launch<int8_t, int8_t>(q, db, db_sq, penalty, out, n_queries,
                                n_rows, dim, device, stream);
}
