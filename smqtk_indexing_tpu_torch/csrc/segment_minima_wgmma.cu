// Stage 1 of the exact flat kNN scan with its products on Hopper's tensor
// cores (wgmma, sm_90a): K1's bf16, int8-code and int8 x int8 forms, and
// the split3 and native forms of its f32 database, which serve the flat
// f32 store by default. The exact f32 form ("highest", FFMA) stays in
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
// +inf on dead rows), out (B, N / 128) f32, in five forms:
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
//   (d <= 1040), so the result is bit-equal to the plain PyTorch version;
// - f32 split3 (segment_minima_f32_split3, the TPU kernel's default f32
//   mode, _tile_ip(mode="split3"), pallas_scan.py:64-77): db f32, q given
//   as its bf16 hi and lo parts (2, B, d), xh = bf16(x) and xl = bf16(x -
//   f32(xh)) (both rounded to nearest even), and
//   <q, x> = qh.xh + qh.xl + ql.xh: three bf16 passes into the same f32
//   accumulators. The dropped ql.xl is below 2^-16 of |q| . |x|, so a
//   score is within about 4e-6 of |db_sq| + 2 |q| . |x| of the exact one;
// - f32 native (segment_minima_f32_native, the TPU's default-precision f32
//   dot): the single pass qh.xh.
//
// What bounds it on an H100: 2 B N d operations a pass, 5.5e11 at the flat
// path's shapes (B = 2048, N = 2^20, d = 128): 0.556 ms at the card's 989
// TFLOP/s dense bf16 tensor-core rate (split3: three passes, 1.668 ms),
// 0.278 ms at its 1,979 TOPS int8 rate; the database is 256 MB (bf16), 128
// MB (int8) or 512 MB (f32), under 0.16 ms at 3.35 TB/s if read once. The
// products bound it, so the design keeps the tensor cores fed and the (B,
// N) scores out of memory:
//
// - A block of two warpgroups (256 threads) owns 256 queries (128 where
//   256 do not fit resident) and walks a strip of kStrip consecutive
//   128-row segments. Each warpgroup issues wgmma.m64n128 (k16 bf16 or k32
//   int8) for one or two 64-query tiles (A, from shared memory) against
//   one segment's 128 rows (B): 64 or 128 accumulators a thread.
// - A K-chunk is one 128-byte swizzled row: 64 bf16 dims or 128 int8 dims,
//   four K steps either way. The query tile is resident in shared memory
//   for the whole strip while it fits beside the ring (bf16: d <= 640;
//   int8: d <= 1280; split3: d <= 256; native: d <= 768); above that, its
//   K-chunks stream through the ring with the database's, which costs L2
//   traffic but keeps any d right.
// - The database streams through a ring of stages, one K-chunk of one
//   segment (16 KB a bf16 or int8 tile) each, in the 128-byte swizzle
//   layout of wgmma.cuh. bf16 rows and int8 rows under an int8 query
//   arrive by cp.async (K1's database is row-major, so K-major already: no
//   register work) through kStages stages; the int8 x int8 form zero-fills
//   a chunk's tail past d in both operands, so any d % 32 == 0 is right.
// - The other forms stage the database through registers, one step ahead
//   (read with __ldg two steps ahead), and store it at the same swizzled
//   addresses. Int8 codes under a bf16 query are widened exactly to bf16
//   (2^23 + u as f32 bits, less 2^23 + 128: two byte permutes and an add
//   per code, no int-to-float conversion): wgmma takes no int8 x bf16
//   product, and widening keeps it on the tensor cores at the bf16 rate.
//   f32 rows are split into a hi and (split3) a lo tile, two cvt.rn.bf16x2
//   and two subtractions a pair of values; the split keeps no bf16 mirror
//   of the store in device memory. A 64-dim K-chunk of 128 f32 rows is 32
//   KB: 32 values a thread. The f32 forms take kRegStages stages, since a
//   stage is written only after the barrier that follows the wgmma that
//   read it, and they store step t + 1 while step t's products run: at 256
//   queries and d = 128 the split3 ring and the resident hi and lo query
//   fit in 193 KB.
// - Epilogue, once a segment's last K-chunk is summed: each thread holds
//   32 columns of two query rows per tile; it folds
//   (db_sq - 2 ip) + penalty into a minimum in registers (float2 loads of
//   db_sq and penalty match its column pairs), then across the 4 lanes of
//   its quad with two shuffles, and one lane writes out[b, s] with 64-bit
//   offsets. No shared-memory reduction. The int8 x int8 form converts
//   each s32 sum to f32 for it (I2F, inner() of scan_loads.cuh).
// - Blocks are numbered query-tile fastest, so the blocks that read one
//   strip run together and find it in L2.
// - Each step waits for its wgmma group before the next step; overlapping
//   a segment's epilogue with the next one's products is later work.
//
// The block geometry, the query staging, the widening and the epilogue's
// fold and quad reduction are shared with the tiled layout's kernel
// (segment_minima_tiled_wgmma.cu) through wgmma_minima.cuh.
//
// The kernel allocates nothing and launches on the caller's stream. The C
// entry points return cudaGetLastError() after the launch.

#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "wgmma_minima.cuh"

namespace {

constexpr int kStages = 4;      // ring depth of the cp.async forms
constexpr int kRegStages = 2;   // ring depth of the f32 forms
constexpr int kStrip = 32;      // segments a block walks

// bf16 tiles a K-chunk of each operand: hi and lo for split3, else one.
template <int kPasses>
__host__ __device__ constexpr int parts() {
  return kPasses == 3 ? 2 : 1;
}

template <typename T>
__host__ __device__ constexpr int ring_stages() {
  return std::is_same<T, float>::value ? kRegStages : kStages;
}

template <int kMTiles, bool kStreamQ, int kPasses>
__host__ __device__ constexpr int stage_bytes() {
  return parts<kPasses>() *
         (kDbStageBytes + (kStreamQ ? q_rows<kMTiles>() * kSwizzleBytes : 0));
}

// Dynamic shared memory: the ring, the resident query tile, and 1 KB to
// align the start to a swizzle atom.
template <typename Q, typename T, int kMTiles, bool kStreamQ, int kPasses>
int64_t smem_bytes(int64_t dim) {
  const int64_t n_chunks = (dim + chunk_dims<Q>() - 1) / chunk_dims<Q>();
  const int64_t q_res = kStreamQ ? 0
                                 : parts<kPasses>() * q_rows<kMTiles>() *
                                       n_chunks * kSwizzleBytes;
  return kAtomBytes +
         ring_stages<T>() * stage_bytes<kMTiles, kStreamQ, kPasses>() + q_res;
}

// Q: the query's type (uint16_t for bf16, int8_t); T: the database's. A
// bf16 query over int8 codes widens them (kWiden); over f32 rows it splits
// them (kSplit) and takes kPasses products (1: native, 3: split3).
template <typename Q, typename T, int kMTiles, bool kStreamQ, int kPasses>
__global__ void __launch_bounds__(kThreads, 1)
segment_minima_wgmma_kernel(const Q* __restrict__ q,
                            const T* __restrict__ db,
                            const float* __restrict__ db_sq,
                            const float* __restrict__ penalty,
                            float* __restrict__ out, int64_t n_queries,
                            int64_t n_rows, int64_t dim, int64_t n_qtiles) {
  constexpr bool kSplit = std::is_same<T, float>::value;
  constexpr bool kWiden = !kSplit && sizeof(T) != sizeof(Q);
  constexpr bool kRegStaged = kSplit || kWiden;
  constexpr int kParts = parts<kPasses>();
  constexpr int kRing = ring_stages<T>();
  constexpr int kDims = chunk_dims<Q>();
  constexpr int kQRows = q_rows<kMTiles>();
  constexpr int kQChunkBytes = kQRows * kSwizzleBytes;
  constexpr int kStageBytes = stage_bytes<kMTiles, kStreamQ, kPasses>();
  // Register staging: 32 values of one row a thread, in 16-byte words.
  constexpr int kWords = 32 * static_cast<int>(sizeof(T)) / 16;
  using Acc = typename MmaAcc<Q>::type;
  static_assert(kPasses == 1 || (kSplit && kPasses == 3),
                "three passes split f32 rows");

  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t ring = (raw + kAtomBytes - 1) & ~uint32_t(kAtomBytes - 1);
  uint8_t* const ring_ptr = smem_raw + (ring - raw);
  const uint32_t q_res = ring + kRing * kStageBytes;

  const int tid = threadIdx.x;
  const int wg = tid >> 7;
  const int64_t q0 = (blockIdx.x % n_qtiles) * kQRows;
  const int64_t n_seg = n_rows / kSeg;
  const int64_t seg0 = (blockIdx.x / n_qtiles) * kStrip;
  const int n_chunks = static_cast<int>((dim + kDims - 1) / kDims);
  const int n_steps =
      static_cast<int>(n_seg - seg0 < kStrip ? n_seg - seg0 : kStrip) *
      n_chunks;

  // Step t is K-chunk t % n_chunks of segment seg0 + t / n_chunks. Part s
  // of the query (split3: 0 hi, 1 lo) follows part s - 1 in memory.
  auto q_row = [&](int c, int s) {
    return [=](int r) {
      // Rows past the batch read its last query; they are never written.
      const int64_t qr = q0 + r < n_queries ? q0 + r : n_queries - 1;
      return q + (s * n_queries + qr) * dim + c * kDims;
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
  // A stage: the database's kParts tiles, then (streamed) the query's.
  auto q_tile = [&](uint32_t stage, int c, int s) {
    return kStreamQ ? stage + kParts * kDbStageBytes + s * kQChunkBytes
                    : q_res + (c * kParts + s) * kQChunkBytes;
  };
  // The cp.async copies of step t (if any): the db chunk (unless it is
  // staged through registers) and, when the queries stream, the query's.
  auto issue = [&](int t) {
    if (t >= n_steps) return;
    const uint32_t stage = ring + (t % kRing) * kStageBytes;
    const int c = t % n_chunks;
    if constexpr (!kRegStaged) {
      copy_chunk<kSeg>(stage, db_row(t), tid, live_pieces(c));
    }
    if constexpr (kStreamQ) {
#pragma unroll
      for (int s = 0; s < kParts; ++s) {
        copy_chunk<kQRows>(q_tile(stage, c, s), q_row(c, s), tid,
                           live_pieces(c));
      }
    }
  };

  // Register staging: thread tid stages 32 values of row tid / 2 (half
  // tid % 2 of the chunk), as 4 swizzled bf16 pieces of each tile.
  uint4 vals[kWords];
  auto load_regs = [&](int t) {
    if constexpr (kRegStaged) {
      const uint4* src = reinterpret_cast<const uint4*>(
          db_row(t)(tid >> 1) + (tid & 1) * 32);
#pragma unroll
      for (int i = 0; i < kWords; ++i) vals[i] = __ldg(src + i);
    }
  };
  auto store_regs = [&](int t) {
    uint8_t* stage = ring_ptr + (t % kRing) * kStageBytes;
    const int r = tid >> 1;
    if constexpr (kWiden) {
      const uint32_t w[8] = {vals[0].x ^ 0x80808080u, vals[0].y ^ 0x80808080u,
                             vals[0].z ^ 0x80808080u, vals[0].w ^ 0x80808080u,
                             vals[1].x ^ 0x80808080u, vals[1].y ^ 0x80808080u,
                             vals[1].z ^ 0x80808080u, vals[1].w ^ 0x80808080u};
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
    } else if constexpr (kSplit) {
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        // Piece p: values 8 p .. 8 p + 7, in words 2 p and 2 p + 1.
        const uint4 a = vals[2 * p];
        const uint4 b = vals[2 * p + 1];
        uint4 hi, lo;
        split_bf16x2(a.x, a.y, hi.x, lo.x);
        split_bf16x2(a.z, a.w, hi.y, lo.y);
        split_bf16x2(b.x, b.y, hi.z, lo.z);
        split_bf16x2(b.z, b.w, hi.w, lo.w);
        const uint32_t off = swizzle_offset(r, (tid & 1) * 4 + p);
        *reinterpret_cast<uint4*>(stage + off) = hi;
        if constexpr (kParts == 2) {
          *reinterpret_cast<uint4*>(stage + kDbStageBytes + off) = lo;
        }
      }
    }
  };

  Acc acc[kMTiles][64];
#pragma unroll
  for (int i = 0; i < kMTiles; ++i) {
#pragma unroll
    for (int j = 0; j < 64; ++j) acc[i][j] = 0;
  }

  // Prologue: the resident query tile and steps 0 .. kRing - 2 (the query
  // tile joins step 0's group), then the register-staged steps 0 and 1.
  if constexpr (!kStreamQ) {
    for (int c = 0; c < n_chunks; ++c) {
#pragma unroll
      for (int s = 0; s < kParts; ++s) {
        copy_chunk<kQRows>(q_tile(0, c, s), q_row(c, s), tid,
                           live_pieces(c));
      }
    }
  }
#pragma unroll
  for (int s = 0; s < kRing - 1; ++s) {
    issue(s);
    cp_async_commit();
  }
  if constexpr (kRegStaged) {
    load_regs(0);
    store_regs(0);
    load_regs(1);  // n_steps >= 2: d is a multiple of 128
  }

  const int lane = tid & 31;
  const int warp = (tid >> 5) & 3;
  for (int t = 0; t < n_steps; ++t) {
    cp_async_wait<kRing - 2>();  // step t's copies have landed
    fence_proxy_async();
    __syncthreads();  // ... everyone's; step t - 1's wgmma are done
    issue(t + kRing - 1);  // into the stage step t - 1 read
    cp_async_commit();
    if constexpr (kWiden) {
      if (t + 1 < n_steps) {
        store_regs(t + 1);
        if (t + 2 < n_steps) load_regs(t + 2);
      }
    }

    const int c = t % n_chunks;
    const uint32_t stage = ring + (t % kRing) * kStageBytes;
    const uint32_t a_off = wg * kMTiles * kMTile * kSwizzleBytes;
#pragma unroll
    for (int i = 0; i < kMTiles; ++i) {
#pragma unroll
      for (int j = 0; j < 64; ++j) fence_operand(acc[i][j]);
    }
    wgmma_fence();
#pragma unroll
    for (int k = 0; k < kSwizzleBytes / kKStepBytes; ++k) {
      // Pass 0: q hi x db hi; split3 adds q hi x db lo, then q lo x db hi.
#pragma unroll
      for (int pass = 0; pass < kPasses; ++pass) {
        const uint64_t b_desc = smem_desc(
            stage + (pass == 1 ? kDbStageBytes : 0) + k * kKStepBytes);
        const uint32_t a_tile = q_tile(stage, c, pass == 2 ? 1 : 0) + a_off;
#pragma unroll
        for (int i = 0; i < kMTiles; ++i) {
          const uint64_t a_desc = smem_desc(
              a_tile + i * kMTile * kSwizzleBytes + k * kKStepBytes);
          wgmma_step(acc[i], a_desc, b_desc, (c | k | pass) != 0);
        }
      }
    }
    wgmma_commit();
    // The f32 forms split the next step while this step's products run:
    // its stage was read by step t - 1, whose wgmma are done.
    if constexpr (kSplit) {
      if (t + 1 < n_steps) {
        store_regs(t + 1);
        if (t + 2 < n_steps) load_regs(t + 2);
      }
    }
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

template <typename Q, typename T, int kMTiles, bool kStreamQ, int kPasses>
int launch_variant(const Q* q, const T* db, const float* db_sq,
                   const float* penalty, float* out, int64_t n_queries,
                   int64_t n_rows, int64_t dim, cudaStream_t stream) {
  auto kernel = segment_minima_wgmma_kernel<Q, T, kMTiles, kStreamQ, kPasses>;
  const int64_t smem = smem_bytes<Q, T, kMTiles, kStreamQ, kPasses>(dim);
  // Never launch a plan that overflows the block's shared memory.
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
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
// queries (bf16: d <= 256; int8: d <= 640; split3: d <= 128; native: d <=
// 384), 128 (bf16: d <= 640; int8: d <= 1280; split3: d <= 256; native: d
// <= 768), else 256 streamed with the database (at most 193 KB in every
// form, whatever d).
template <typename Q, typename T, int kPasses = 1>
int launch(const void* q, const void* db, const void* db_sq,
           const void* penalty, void* out, int64_t n_queries, int64_t n_rows,
           int64_t dim, int device, void* stream) {
  // This library carries its own CUDA runtime: select the tensors' device
  // in it before launching on the caller's stream.
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  // The int8 x int8 form takes whole k32 steps; the others whole 128-dim
  // pairs of bf16 K-chunks (register staging loads two steps ahead).
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
  if (smem_bytes<Q, T, 2, false, kPasses>(dim) <= kMaxSmem) {
    return launch_variant<Q, T, 2, false, kPasses>(qq, x, sq, pen, o,
                                                   n_queries, n_rows, dim, s);
  }
  if (smem_bytes<Q, T, 1, false, kPasses>(dim) <= kMaxSmem) {
    return launch_variant<Q, T, 1, false, kPasses>(qq, x, sq, pen, o,
                                                   n_queries, n_rows, dim, s);
  }
  return launch_variant<Q, T, 2, true, kPasses>(qq, x, sq, pen, o, n_queries,
                                                n_rows, dim, s);
}

}  // namespace

// Shape contract (checked by the Python wrapper): q (n_queries, dim) bf16,
// db (n_rows, dim) bf16 or int8, dim % 128 == 0; for segment_minima_i8i8
// q and db int8, dim % 32 == 0; for segment_minima_f32_split3 q (2,
// n_queries, dim) bf16 (hi, then lo) and db f32, for
// segment_minima_f32_native q (n_queries, dim) bf16 (hi) and db f32, dim %
// 128 == 0; n_rows % 128 == 0, all arrays contiguous and 16-byte aligned
// on CUDA device `device`.
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

extern "C" int segment_minima_f32_split3(const void* q, const void* db,
                                         const void* db_sq,
                                         const void* penalty, void* out,
                                         int64_t n_queries, int64_t n_rows,
                                         int64_t dim, int device,
                                         void* stream) {
  return launch<uint16_t, float, 3>(q, db, db_sq, penalty, out, n_queries,
                                    n_rows, dim, device, stream);
}

extern "C" int segment_minima_f32_native(const void* q, const void* db,
                                         const void* db_sq,
                                         const void* penalty, void* out,
                                         int64_t n_queries, int64_t n_rows,
                                         int64_t dim, int device,
                                         void* stream) {
  return launch<uint16_t, float, 1>(q, db, db_sq, penalty, out, n_queries,
                                    n_rows, dim, device, stream);
}
