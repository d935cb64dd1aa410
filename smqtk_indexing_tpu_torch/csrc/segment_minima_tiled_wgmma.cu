// Stage 1 of the single-copy SQ8 capacity scan over the tiled-transposed
// layout, with its products on Hopper's tensor cores (wgmma, sm_90a): the
// int8-code forms of K2, K4 and K5 with a float query (and of the K10
// probe's bf16 arm) and with an int8 query (the i8dot int8 x int8 form,
// and K10's int8 arm), both through K2's and K5's entry points; and the K9
// stage-1 variant probe in both query forms (the stage1_variant_* entry
// points, below). The f32 and bf16 databases stay on tiled_minima.cuh's
// FFMA kernels.
//
// Replaces the TPU kernels of smqtk_indexing_tpu/ops/pallas_scan.py:
// K2 segment_minima_tiled -> _scan_kernel, 3-D branch (:244-310); K4
// segment_minima_blocked -> _blocked_kernel (:490-544), the tiled layout
// with tile_n = 128; K5 segment_minima_tiled2 -> _scan_kernel_tiled2
// (:758-870); each in the two product forms of _tile_ip (:50-82): the int8
// tile cast to bf16 against a bf16 query (:62-63), and int8 x int8 ->
// int32 on the matrix unit (:53-61). It computes tiled_minima.cuh's
// function:
//
//     m[b, s] = min over r in [128 s, 128 s + 128) of
//               (db_sq[r] - 2 ip(q_b, x_r)) + penalty[r]
//
// for db3 (n_tiles, d, tile_n) int8 codes (row r at db3[r / tile_n][.][r
// % tile_n]), db_sq and penalty (N,) f32 (penalty = +inf on dead rows),
// written as out1[(s / G) * B * G + b * G + s % G] (G = N / 128: K2's and
// K4's (B, N / 128); G = t_step * tile_n / 128: K5's step-major m1) and,
// when out2 is given (K5), m2[(s / G) * B * (G / bw) + b * (G / bw) + (s %
// G) / bw], the minimum over each group of bw consecutive segments. The
// query q (B, d) and ip are:
//
// - bf16 (the query rounded to bf16 by the wrapper): ip = <q, x> summed in
//   f32 by wgmma bf16 x bf16 -> f32. Every product of a bf16 value and an
//   int8 code is exact in f32, so the tensor cores change nothing but the
//   order and rounding of the f32 sums;
// - int8 (ops/sq8._i8dot_q, or K10's int8 query): ip = float(<q, x>) *
//   scale, the sum exact in s32 by wgmma s8 x s8 -> s32, then
//   scan_loads.cuh's inner() order (the product, then the scale; the
//   order tools/probe_int8_mxu.py:51-59 uses). Production passes scale =
//   1.0f, which changes no bit; float(acc) is exact below 2^24 (d <= 1040),
//   so the result is bit-equal to the plain PyTorch version.
//
// What bounds it on an H100, at the capacity configuration (N =
// 100,663,296, d = 128): 12.9 GB of codes and 0.8 GB of db_sq and penalty
// must move, 4.1 ms at 3.35 TB/s; the products are 2 B N d = 3.3e12 at B =
// 128 (3.3 ms at bf16's 989 TFLOP/s, 1.7 ms at int8's 1,979 TOPS) and
// 6.6e12 at B = 256 (6.7 / 3.3 ms). So the bytes bound the int8 form and
// the bytes and the products the bf16 form about equally; the design reads
// every code byte from memory once and keeps the tensor cores fed:
//
// - A block of two warpgroups (256 threads) owns 128 queries (kMTiles = 1,
//   B <= 128) or 256 (kMTiles = 2), resident in shared memory as the A
//   operand, and walks a strip of consecutive segments: whole groups of bw
//   segments (K5), or kStrip segments when bw = 1 (K2, K4). At B = 128 and
//   256 one block column covers the batch, so every code leaves memory
//   once. Wider batches take more query tiles, numbered fastest, so the
//   blocks that read one strip run together and find it in L2. A strip
//   ends at the last segment.
// - A K-chunk is one 128-byte swizzled row of each segment row: 64 dims
//   (bf16) or 128 (int8), four K steps (k16 or k32). The tiled layout is
//   MN-major for wgmma's B (K = dims, N = rows: a segment is 128
//   contiguous codes in each dimension row), and wgmma takes int8 only
//   K-major, so the staging transposes in registers into wgmma.cuh's
//   K-major 128-byte swizzle. A 16-byte piece of the swizzle holds P dims
//   of one row (P = 8 bf16 or 16 int8). Thread (warp w, lane l) owns dim
//   group o = l % kDimGroups + kDimGroups (w % 2), the P dims o P .. o P +
//   P - 1 of the chunk, and rows 4 p .. 4 p + 3 of the segment, p = l /
//   kDimGroups + kRowQuads (w / 2). It loads them as P words, one a dim (a
//   warp's load covers 4 dims x 32 contiguous bytes: whole sectors),
//   transposes each 4 x 4 byte block with transpose4x4, widens each code
//   exactly to bf16 (codes_to_bf16x2; the bf16 form only) and stores one
//   16-byte piece a row at swizzle_offset(row, o). Each 8 consecutive
//   lanes then store to the 8 distinct piece positions of the swizzle, so
//   a store takes the least shared-memory wavefronts.
// - The codes are read into registers one step ahead and stored into the
//   two-stage ring while the step's wgmma run, so staging overlaps the
//   products; the epilogue does not (it follows the last K-chunk of each
//   segment, as K1's: the fold and quad reduction of wgmma_minima.cuh).
//   Each segment's db_sq and penalty arrive in shared memory by cp.async
//   one segment ahead, so the epilogue waits on no device-memory load.
// - Widths: any d % 16 == 0. The last K-chunk's dims past d are staged as
//   zeros in both operands (the query by cp.async zero-fill). The query
//   tile stays resident while it fits beside the ring (bf16: d <= 384 at
//   256 queries, d <= 768 at 128; int8: d <= 768 and d <= 1536), else its
//   K-chunks stream through the ring.
// - At kMTiles = 1 with a resident query the bf16 form needs at most 128
//   registers a thread and 67 KB of shared memory at d = 128, so two
//   blocks share an SM and one's epilogue runs under the other's products.
//   The int8 x int8 form holds 16 prefetched words a thread where the bf16
//   form holds 8, spills under that cap, and takes one block an SM.
// - Queries past B read the last query and are never written. Every
//   global offset is 64-bit: N d passes 2^31 at capacity.
//
// K9, the stage-1 variant probe (replaces tools/stage1_analysis.py
// _run_variant -> _variant_kernel, :67-198, pallas_call :176), is this
// kernel with its epilogue swapped: the variant V is a template parameter,
// and kFull is production's own instantiation (K2's, with g = t_step *
// tile_n / 128 and no m2). Each variant computes the JAX probe's function
// into the step-major (n_steps, B, g) output:
//
// - kFolded: the segment minima of db_sq - 2 ip, no penalty (its stats
//   are not copied and its add is not taken);
// - kNoMin: no minimum: the block of a tile's first segment writes the
//   scores of that segment's first tile_n / 128 rows into the tile's
//   tile_n / 128 slots, straight from the accumulator fragment; every
//   block still takes its segment's products;
// - kNoDot: no wgmma (nor its fences, commits and waits): the codes are
//   still staged through shared memory,
//   and the scores are (db_sq - 2 x[r, 0]) + penalty, the same for every
//   query, with x[r, 0] read from the staged K-chunk 0 (its byte or bf16
//   at swizzle_offset(r, 0));
// - kBf16Min: each score rounded to bf16 (nearest, ties to even) before
//   the minimum.
//
// The four are built for the probe's plan only (B <= 128 queries resident,
// kMTiles 1), so that production's build carries eight instantiations for
// them, not 24; kFull keeps its three plans.
//
// The probe's "staged" and "minfirst" reorder the TPU kernel's
// instructions and compute kFull's function; they run kFull. So the
// differences between the variants' times split production's stage 1 into
// products, staging, fold and minimum.
//
// The kernel allocates nothing and launches on the caller's stream. The C
// entry points return cudaGetLastError() after the launch.

#include <cuda_runtime.h>

#include <cstdint>

#include "wgmma_minima.cuh"

namespace {

constexpr int kStages = 2;      // ring depth
constexpr int kStrip = 32;      // segments a block walks when bw = 1
constexpr int kRowQuads = 8;    // row quads of a warp: 32 rows
constexpr int kDimGroups = 4;   // dim groups (one piece each) of a warp
constexpr int kStatsSlotBytes = 2 * kSeg * 4;  // a segment's db_sq, penalty

// Epilogue variants: kFull is production (K2, K4, K5), the others the K9
// probe's (tools/stage1_analysis.py:67-162; see the top).
enum Variant : int { kFull = 0, kFolded = 1, kNoMin = 2, kNoDot = 3,
                     kBf16Min = 4 };

template <int kMTiles, bool kStreamQ>
__host__ __device__ constexpr int stage_bytes() {
  return kDbStageBytes + (kStreamQ ? q_rows<kMTiles>() * kSwizzleBytes : 0);
}

// Dynamic shared memory: the ring, the resident query tile, two segments'
// stats, and 1 KB to align the start to a swizzle atom.
template <typename Q, int kMTiles, bool kStreamQ>
int64_t smem_bytes(int64_t dim) {
  const int64_t n_chunks = (dim + chunk_dims<Q>() - 1) / chunk_dims<Q>();
  const int64_t q_res =
      kStreamQ ? 0 : q_rows<kMTiles>() * n_chunks * kSwizzleBytes;
  return kAtomBytes + kStages * stage_bytes<kMTiles, kStreamQ>() + q_res +
         2 * kStatsSlotBytes;
}

// Segments a block walks: whole groups, at least kStrip segments where a
// group is narrower.
inline int64_t strip_segments(int64_t bw) {
  return bw >= kStrip ? bw : bw * (kStrip / bw);
}

// Q: the query's type, uint16_t (bf16; the codes are widened) or int8_t.
// Two blocks share an SM at 128 resident queries in the bf16 form; the
// int8 x int8 form would spill under the 128 registers that leaves a
// thread, and takes one. V: the epilogue (Variant).
template <typename Q, int kMTiles, bool kStreamQ, int V>
__global__ void __launch_bounds__(
    kThreads, kMTiles == 1 && !kStreamQ && sizeof(Q) == 2 ? 2 : 1)
tiled_minima_wgmma_kernel(const Q* __restrict__ q,
                          const int8_t* __restrict__ db3,
                          const float* __restrict__ db_sq,
                          const float* __restrict__ penalty,
                          float* __restrict__ out1, float* __restrict__ out2,
                          int64_t n_queries, int64_t n_seg, int64_t dim,
                          int64_t tile_n, int64_t g, int64_t bw,
                          int64_t strip, int64_t n_qtiles, float scale) {
  constexpr bool kWiden = sizeof(Q) == 2;
  constexpr int kDims = chunk_dims<Q>();
  constexpr int kPiece = piece_dims<Q>();  // dims of a piece: words a thread
  constexpr int kQRows = q_rows<kMTiles>();
  constexpr int kQChunkBytes = kQRows * kSwizzleBytes;
  constexpr int kStageBytes = stage_bytes<kMTiles, kStreamQ>();

  const int tid = threadIdx.x;
  const int wg = tid >> 7;
  const int lane = tid & 31;
  const int warp = (tid >> 5) & 3;  // warp of the warpgroup
  const int64_t q0 = (blockIdx.x % n_qtiles) * kQRows;
  const int64_t seg0 = (blockIdx.x / n_qtiles) * strip;
  const int64_t nseg_t = tile_n / kSeg;
  const int n_chunks = static_cast<int>((dim + kDims - 1) / kDims);
  const int n_segs =
      static_cast<int>(n_seg - seg0 < strip ? n_seg - seg0 : strip);
  const int n_steps = n_segs * n_chunks;

  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t ring = (raw + kAtomBytes - 1) & ~uint32_t(kAtomBytes - 1);
  uint8_t* const ring_ptr = smem_raw + (ring - raw);
  const uint32_t q_res = ring + kStages * kStageBytes;
  const uint32_t stats =
      q_res + (kStreamQ ? 0 : kQChunkBytes * n_chunks);
  const float* const stats_ptr =
      reinterpret_cast<const float*>(smem_raw + (stats - raw));

  // Step t is K-chunk t % n_chunks of segment seg0 + t / n_chunks.
  auto q_row = [&](int c) {
    return [=](int r) {
      // Rows past the batch read its last query; they are never written.
      const int64_t qr = q0 + r < n_queries ? q0 + r : n_queries - 1;
      return q + qr * dim + c * kDims;
    };
  };
  // Live pieces of K-chunk c.
  auto live_pieces = [&](int c) {
    const int64_t left = (dim - c * kDims) / kPiece;
    return static_cast<int>(left < 8 ? left : 8);
  };
  // db_sq and penalty of the strip's segment j into stats slot j % 2
  // (db_sq's 128 values, then penalty's): 16 bytes a thread of the first
  // two warps (kFolded: db_sq only).
  auto copy_stats = [&](int j) {
    if (tid < (V == kFolded ? 1 : 2) * 32 && j < n_segs) {
      const float* src = (tid < 32 ? db_sq : penalty) + (seg0 + j) * kSeg +
                         4 * (tid & 31);
      cp_async16(stats + (j & 1) * kStatsSlotBytes + 16 * tid, src);
    }
  };

  // This thread's dim group o and row quad p of every step (see the top).
  // The codes of the next step to load: K-chunk ld_c of the segment whose
  // row quad starts at ld_src, segment ld_col of its tile.
  const int o = (lane % kDimGroups) + kDimGroups * ((tid >> 5) & 1);
  const int p = (lane / kDimGroups) + kRowQuads * (tid >> 6);
  int ld_c = 0;
  int64_t ld_col = seg0 % nseg_t;
  const int8_t* ld_src = db3 + (seg0 / nseg_t) * dim * tile_n +
                         ld_col * kSeg + 4 * p;
  uint32_t words[kPiece];
  auto load_codes = [&]() {
    const int64_t k0 = ld_c * kDims + kPiece * o;
    const bool live = k0 < dim;  // d % 16 == 0: a group is whole
#pragma unroll
    for (int i = 0; i < kPiece; ++i) {
      words[i] = live ? __ldg(reinterpret_cast<const unsigned int*>(
                            ld_src + (k0 + i) * tile_n))
                      : 0u;
    }
    if (++ld_c == n_chunks) {
      ld_c = 0;
      if (++ld_col == nseg_t) {  // the next tile's first segment
        ld_col = 0;
        ld_src += dim * tile_n - (nseg_t - 1) * kSeg;
      } else {
        ld_src += kSeg;
      }
    }
  };
  // rows[u][j]: dims 4 u .. 4 u + 3 of row 4 p + j (byte i = dim 4 u + i),
  // widened to bf16 or as they are: one 16-byte piece a row.
  auto store_codes = [&](int t) {
    uint8_t* stage = ring_ptr + (t % kStages) * kStageBytes;
    uint32_t rows[kPiece / 4][4];
#pragma unroll
    for (int u = 0; u < kPiece / 4; ++u) {
      const uint32_t flip = kWiden ? 0x80808080u : 0u;
      const uint32_t w[4] = {words[4 * u] ^ flip, words[4 * u + 1] ^ flip,
                             words[4 * u + 2] ^ flip,
                             words[4 * u + 3] ^ flip};
      transpose4x4(w, rows[u]);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      uint4 v;
      if constexpr (kWiden) {
        v.x = codes_to_bf16x2(rows[0][j], 0);
        v.y = codes_to_bf16x2(rows[0][j], 2);
        v.z = codes_to_bf16x2(rows[1][j], 0);
        v.w = codes_to_bf16x2(rows[1][j], 2);
      } else {
        v = make_uint4(rows[0][j], rows[1][j], rows[2][j], rows[3][j]);
      }
      *reinterpret_cast<uint4*>(stage + swizzle_offset(4 * p + j, o)) = v;
    }
  };

  typename MmaAcc<Q>::type acc[kMTiles][64];
#pragma unroll
  for (int i = 0; i < kMTiles; ++i) {
#pragma unroll
    for (int j = 0; j < 64; ++j) acc[i][j] = 0;
  }
  float gmin[kMTiles][2];
#pragma unroll
  for (int i = 0; i < kMTiles; ++i) {
    gmin[i][0] = gmin[i][1] = __int_as_float(0x7f800000);  // +inf
  }
  // kNoDot: x[r, 0] of this thread's columns r = 8 jj + 2 (lane % 4) + e
  // of the segment, x0[2 jj + e], read from its staged K-chunk 0.
  float x0[V == kNoDot ? 32 : 1];

  // Prologue: the resident query tile (or step 0's query chunk) and the
  // first segment's stats, then the codes of step 0 staged and those of
  // step 1 in registers.
  if constexpr (!kStreamQ) {
    for (int c = 0; c < n_chunks; ++c) {
      copy_chunk<kQRows>(q_res + c * kQChunkBytes, q_row(c), tid,
                         live_pieces(c));
    }
  } else {
    copy_chunk<kQRows>(ring + kDbStageBytes, q_row(0), tid, live_pieces(0));
  }
  copy_stats(0);
  cp_async_commit();
  load_codes();
  store_codes(0);
  if (n_steps > 1) load_codes();
  cp_async_wait<0>();

  // Step t is K-chunk c of the strip's segment j; the epilogue writes
  // out1's (step, ., gi) and, after each group of bw segments, out2's
  // (step, ., gq).
  int c = 0, j = 0;
  int64_t step = seg0 / g, gi = seg0 % g, gq = gi / bw, gpos = 0;
  for (int t = 0; t < n_steps; ++t) {
    if (c == n_chunks - 1) {
      // Segment j's stats (copied one segment ahead) are in; the next
      // segment's may still be on their way.
      if (n_chunks == 1) {
        cp_async_wait<0>();
      } else {
        cp_async_wait<1>();
      }
    }
    fence_proxy_async();
    __syncthreads();  // step t's operands are in; step t - 1's wgmma done
    const uint32_t stage = ring + (t % kStages) * kStageBytes;
    if (c == 0) copy_stats(j + 1);  // its slot was read by segment j - 1
    if constexpr (V == kNoDot) {
      if (c == 0) {
        const uint8_t* chunk0 = ring_ptr + (t % kStages) * kStageBytes;
#pragma unroll
        for (int e = 0; e < 32; ++e) {
          const int r = 8 * (e / 2) + 2 * (lane & 3) + e % 2;
          const uint8_t* x = chunk0 + swizzle_offset(r, 0);
          if constexpr (kWiden) {  // the code widened to bf16
            x0[e] = __uint_as_float(
                static_cast<uint32_t>(*reinterpret_cast<const uint16_t*>(x))
                << 16);
          } else {
            x0[e] = static_cast<float>(*reinterpret_cast<const int8_t*>(x));
          }
        }
      }
    }
    if constexpr (kStreamQ) {
      if (t + 1 < n_steps) {
        const int c1 = c + 1 == n_chunks ? 0 : c + 1;
        copy_chunk<kQRows>(ring + ((t + 1) % kStages) * kStageBytes +
                               kDbStageBytes,
                           q_row(c1), tid, live_pieces(c1));
      }
    }
    if (kStreamQ || c == 0) cp_async_commit();
    const uint32_t a_tile = (kStreamQ ? stage + kDbStageBytes
                                      : q_res + c * kQChunkBytes) +
                            wg * kMTiles * kMTile * kSwizzleBytes;
    if constexpr (V != kNoDot) {
#pragma unroll
      for (int i = 0; i < kMTiles; ++i) {
#pragma unroll
        for (int e = 0; e < 64; ++e) fence_operand(acc[i][e]);
      }
      wgmma_fence();
    }
#pragma unroll
    for (int k = 0; k < kSwizzleBytes / kKStepBytes; ++k) {
      const uint64_t b_desc = smem_desc(stage + k * kKStepBytes);
#pragma unroll
      for (int i = 0; i < kMTiles; ++i) {
        const uint64_t a_desc =
            smem_desc(a_tile + i * kMTile * kSwizzleBytes + k * kKStepBytes);
        if constexpr (V != kNoDot) {
          wgmma_step(acc[i], a_desc, b_desc, (c | k) != 0);
        }
      }
    }
    if constexpr (V != kNoDot) wgmma_commit();
    // Stage step t + 1 into the other stage (read by step t - 1, done)
    // while the products run.
    if (t + 1 < n_steps) {
      store_codes(t + 1);
      if (t + 2 < n_steps) load_codes();
    }
    if constexpr (V != kNoDot) {
      wgmma_wait<0>();
#pragma unroll
      for (int i = 0; i < kMTiles; ++i) {
#pragma unroll
        for (int e = 0; e < 64; ++e) fence_operand(acc[i][e]);
      }
    }
    if constexpr (kStreamQ) cp_async_wait<0>();
    if (++c < n_chunks) continue;

    // Epilogue of segment j: this thread's columns 8 jj + 2 (lane % 4) + e
    // of query rows 16 warp + lane / 4 + 8 h of each tile, its stats from
    // shared memory.
    const float* sq = stats_ptr + (j & 1) * (kStatsSlotBytes / 4) +
                      2 * (lane & 3);
    float m[kMTiles][2];
    if constexpr (V == kNoMin) {
      // The tile's first segment: its columns below tile_n / 128 are the
      // scores of the tile's slots gi .. gi + tile_n / 128 - 1.
      if ((seg0 + j) % nseg_t == 0) {
#pragma unroll
        for (int jj = 0; jj < 16; ++jj) {
          const float2 a = *reinterpret_cast<const float2*>(sq + 8 * jj);
          const float2 b =
              *reinterpret_cast<const float2*>(sq + kSeg + 8 * jj);
          const float sv[2] = {a.x, a.y};
          const float pv[2] = {b.x, b.y};
#pragma unroll
          for (int i = 0; i < kMTiles; ++i) {
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int64_t qi = q0 + (wg * kMTiles + i) * kMTile +
                                 warp * 16 + (lane >> 2) + 8 * h;
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                const int col = 8 * jj + 2 * (lane & 3) + e;
                if (col < nseg_t && qi < n_queries) {
                  out1[(step * n_queries + qi) * g + gi + col] =
                      (sv[e] - 2.0f * inner(acc[i][4 * jj + 2 * h + e],
                                            scale)) +
                      pv[e];
                }
              }
            }
          }
        }
      }
#pragma unroll
      for (int i = 0; i < kMTiles; ++i) {
        m[i][0] = m[i][1] = __int_as_float(0x7f800000);  // +inf
      }
    } else if constexpr (V == kNoDot) {
      float v = __int_as_float(0x7f800000);  // +inf
#pragma unroll
      for (int jj = 0; jj < 16; ++jj) {
        const float2 a = *reinterpret_cast<const float2*>(sq + 8 * jj);
        const float2 b = *reinterpret_cast<const float2*>(sq + kSeg + 8 * jj);
        v = fminf(v, (a.x - 2.0f * x0[2 * jj]) + b.x);
        v = fminf(v, (a.y - 2.0f * x0[2 * jj + 1]) + b.y);
      }
#pragma unroll
      for (int i = 0; i < kMTiles; ++i) m[i][0] = m[i][1] = v;
    } else {
      fold_minima<kMTiles, V != kFolded, V == kBf16Min>(
          acc, scale, [&](int jj) {
            const float2 a = *reinterpret_cast<const float2*>(sq + 8 * jj);
            const float2 b = V == kFolded
                ? make_float2(0.0f, 0.0f)
                : *reinterpret_cast<const float2*>(sq + kSeg + 8 * jj);
            return make_float4(a.x, a.y, b.x, b.y);
          }, m);
    }
    const bool group_end = out2 != nullptr && ++gpos == bw;
#pragma unroll
    for (int i = 0; i < kMTiles; ++i) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float v = quad_min(m[i][h]);
        const int64_t qi = q0 + (wg * kMTiles + i) * kMTile + warp * 16 +
                           (lane >> 2) + 8 * h;
        const bool write =
            V != kNoMin && (lane & 3) == 0 && qi < n_queries;
        if (write) out1[(step * n_queries + qi) * g + gi] = v;
        gmin[i][h] = fminf(gmin[i][h], v);
        if (group_end) {
          if (write) {
            out2[(step * n_queries + qi) * (g / bw) + gq] = gmin[i][h];
          }
          gmin[i][h] = __int_as_float(0x7f800000);
        }
      }
    }
    if (group_end) {
      gpos = 0;
      ++gq;
    }
    if (++gi == g) {  // the next step of the output
      gi = 0;
      gq = 0;
      ++step;
    }
    c = 0;
    ++j;
  }
}

template <typename Q, int kMTiles, bool kStreamQ, int V>
int launch_variant(const Q* q, const int8_t* db3, const float* db_sq,
                   const float* penalty, float* out1, float* out2,
                   int64_t n_queries, int64_t n_seg, int64_t dim,
                   int64_t tile_n, int64_t g, int64_t bw, float scale,
                   cudaStream_t stream) {
  auto kernel = tiled_minima_wgmma_kernel<Q, kMTiles, kStreamQ, V>;
  const int64_t smem = smem_bytes<Q, kMTiles, kStreamQ>(dim);
  const cudaError_t set = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (set != cudaSuccess) return static_cast<int>(set);
  const int64_t strip = strip_segments(bw);
  const int64_t n_qtiles = (n_queries + q_rows<kMTiles>() - 1) /
                           q_rows<kMTiles>();
  const int64_t n_blocks = n_qtiles * ((n_seg + strip - 1) / strip);
  if (n_blocks >= (1LL << 31)) return static_cast<int>(cudaErrorInvalidValue);
  if (n_blocks > 0) {
    kernel<<<dim3(static_cast<unsigned>(n_blocks)), kThreads,
             static_cast<size_t>(smem), stream>>>(
        q, db3, db_sq, penalty, out1, out2, n_queries, n_seg, dim, tile_n, g,
        bw, strip, n_qtiles, scale);
  }
  return static_cast<int>(cudaGetLastError());
}

// Picks the block: 256 resident queries for B > 128 while they fit beside
// the ring, else 128 resident, else 128 streamed with the codes.
template <typename Q, int V = kFull>
int launch(const void* q, const void* db3, const void* db_sq,
           const void* penalty, void* out1, void* out2, int64_t n_queries,
           int64_t n_tiles, int64_t dim, int64_t tile_n, int64_t g,
           int64_t bw, float scale, int device, void* stream) {
  // This library carries its own CUDA runtime: select the tensors' device
  // in it before launching on the caller's stream.
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  const int64_t n_seg = n_tiles * (tile_n / kSeg);
  if (tile_n <= 0 || tile_n % kSeg || dim <= 0 || dim % 16 || g <= 0 ||
      bw <= 0 || n_seg % g || g % bw ||
      (V == kNoMin && tile_n / kSeg > kSeg)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto* qq = static_cast<const Q*>(q);
  const auto* x = static_cast<const int8_t*>(db3);
  const auto* sq = static_cast<const float*>(db_sq);
  const auto* pen = static_cast<const float*>(penalty);
  auto* o1 = static_cast<float*>(out1);
  auto* o2 = static_cast<float*>(out2);
  auto s = static_cast<cudaStream_t>(stream);
  if constexpr (V != kFull) {
    // K9's other variants are built for the probe's plan only: at most
    // 128 queries, resident beside the ring.
    if (n_queries > q_rows<1>() || smem_bytes<Q, 1, false>(dim) > kMaxSmem) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    return launch_variant<Q, 1, false, V>(qq, x, sq, pen, o1, o2, n_queries,
                                          n_seg, dim, tile_n, g, bw, scale,
                                          s);
  }
  if (n_queries > q_rows<1>() && smem_bytes<Q, 2, false>(dim) <= kMaxSmem) {
    return launch_variant<Q, 2, false, V>(qq, x, sq, pen, o1, o2, n_queries,
                                          n_seg, dim, tile_n, g, bw, scale,
                                          s);
  }
  if (smem_bytes<Q, 1, false>(dim) <= kMaxSmem) {
    return launch_variant<Q, 1, false, V>(qq, x, sq, pen, o1, o2, n_queries,
                                          n_seg, dim, tile_n, g, bw, scale,
                                          s);
  }
  return launch_variant<Q, 1, true, V>(qq, x, sq, pen, o1, o2, n_queries,
                                       n_seg, dim, tile_n, g, bw, scale, s);
}

// K9: variant `variant` into the step-major (n_steps, B, g) output, no m2,
// the products unscaled.
template <typename Q>
int launch_probe(const void* q, const void* db3, const void* db_sq,
                 const void* penalty, void* out, int64_t n_queries,
                 int64_t n_tiles, int64_t dim, int64_t tile_n, int64_t g,
                 int64_t variant, int device, void* stream) {
  switch (variant) {
    case kFull:
      return launch<Q, kFull>(q, db3, db_sq, penalty, out, nullptr,
                              n_queries, n_tiles, dim, tile_n, g, 1, 1.0f,
                              device, stream);
    case kFolded:
      return launch<Q, kFolded>(q, db3, db_sq, penalty, out, nullptr,
                                n_queries, n_tiles, dim, tile_n, g, 1, 1.0f,
                                device, stream);
    case kNoMin:
      return launch<Q, kNoMin>(q, db3, db_sq, penalty, out, nullptr,
                               n_queries, n_tiles, dim, tile_n, g, 1, 1.0f,
                               device, stream);
    case kNoDot:
      return launch<Q, kNoDot>(q, db3, db_sq, penalty, out, nullptr,
                               n_queries, n_tiles, dim, tile_n, g, 1, 1.0f,
                               device, stream);
    case kBf16Min:
      return launch<Q, kBf16Min>(q, db3, db_sq, penalty, out, nullptr,
                                 n_queries, n_tiles, dim, tile_n, g, 1, 1.0f,
                                 device, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Shape contract (checked by the Python wrapper): db3 (n_tiles, dim,
// tile_n) int8 with tile_n % 128 == 0 and dim % 16 == 0 (dim % 32 == 0
// for the int8 query); q (n_queries, dim) bf16 (the _i8 entries) or int8
// (the _i8i8 entries, whose products are scaled by `scale`); db_sq and
// penalty (n_tiles * tile_n,) f32; all contiguous and 16-byte aligned on
// CUDA device `device`. The (B, N / 128) form (K2, K4) writes out
// (n_queries, N / 128); the step-major form (K5) writes m1 (N / 128 / g,
// n_queries, g) and m2 (N / 128 / g, n_queries, g / bw), with g dividing
// N / 128 and bw dividing g.
extern "C" int segment_minima_tiled_i8(const void* q, const void* db3,
                                       const void* db_sq, const void* penalty,
                                       void* out, int64_t n_queries,
                                       int64_t n_tiles, int64_t dim,
                                       int64_t tile_n, int device,
                                       void* stream) {
  return launch<uint16_t>(q, db3, db_sq, penalty, out, nullptr, n_queries,
                          n_tiles, dim, tile_n, n_tiles * (tile_n / kSeg), 1,
                          1.0f, device, stream);
}

extern "C" int segment_minima_tiled2_i8(const void* q, const void* db3,
                                        const void* db_sq,
                                        const void* penalty, void* m1,
                                        void* m2, int64_t n_queries,
                                        int64_t n_tiles, int64_t dim,
                                        int64_t tile_n, int64_t g,
                                        int64_t bw, int device,
                                        void* stream) {
  return launch<uint16_t>(q, db3, db_sq, penalty, m1, m2, n_queries, n_tiles,
                          dim, tile_n, g, bw, 1.0f, device, stream);
}

extern "C" int segment_minima_tiled_i8i8(
    const void* q, const void* db3, const void* db_sq, const void* penalty,
    void* out, int64_t n_queries, int64_t n_tiles, int64_t dim,
    int64_t tile_n, float scale, int device, void* stream) {
  return launch<int8_t>(q, db3, db_sq, penalty, out, nullptr, n_queries,
                        n_tiles, dim, tile_n, n_tiles * (tile_n / kSeg), 1,
                        scale, device, stream);
}

extern "C" int segment_minima_tiled2_i8i8(
    const void* q, const void* db3, const void* db_sq, const void* penalty,
    void* m1, void* m2, int64_t n_queries, int64_t n_tiles, int64_t dim,
    int64_t tile_n, int64_t g, int64_t bw, float scale, int device,
    void* stream) {
  return launch<int8_t>(q, db3, db_sq, penalty, m1, m2, n_queries, n_tiles,
                        dim, tile_n, g, bw, scale, device, stream);
}

// K9's entry points: db3, db_sq and penalty as above; q (n_queries, dim)
// bf16 (_i8) or int8 (_i8i8); out (N / 128 / g, n_queries, g) f32 with g
// dividing N / 128; `variant` one of the Variant values (kNoMin takes
// tile_n <= 16384; all but kFull take n_queries <= 128 and a query tile
// that fits resident).
extern "C" int stage1_variant_i8(const void* q, const void* db3,
                                 const void* db_sq, const void* penalty,
                                 void* out, int64_t n_queries,
                                 int64_t n_tiles, int64_t dim,
                                 int64_t tile_n, int64_t g, int64_t variant,
                                 int device, void* stream) {
  return launch_probe<uint16_t>(q, db3, db_sq, penalty, out, n_queries,
                                n_tiles, dim, tile_n, g, variant, device,
                                stream);
}

extern "C" int stage1_variant_i8i8(const void* q, const void* db3,
                                   const void* db_sq, const void* penalty,
                                   void* out, int64_t n_queries,
                                   int64_t n_tiles, int64_t dim,
                                   int64_t tile_n, int64_t g,
                                   int64_t variant, int device,
                                   void* stream) {
  return launch_probe<int8_t>(q, db3, db_sq, penalty, out, n_queries,
                              n_tiles, dim, tile_n, g, variant, device,
                              stream);
}
