// Stage 2 of the exact flat scan: the exact distances of every row of the
// segments each query kept, for the whole batch in one launch, written by
// hand for Hopper (sm_90a).
//
// Replaces the f32 stage 2 of smqtk_indexing_tpu/ops/pallas_scan.py
// flat_topk_fused (:619-700), which XLA fused on the TPU (a gather of the
// kept segments, the exact per-metric distances, the liveness mask), and
// the port's eager version of it (fused_scan.rerank_segments_reference),
// which wrote every candidate row of every query to device memory as a
// (b, s_keep * 128, d) f32 block and ran a dozen elementwise passes over
// it, in blocks of ~30 queries.
//
// Input: the batch's (query, slot) pairs sorted by segment id (seg, with
// perm the pair index b * s_keep + slot of each), the (N, d) rows (f32 or
// bf16), their liveness and, for cosine, their norms and the queries'.
// Output: for every pair and each row r < 128 of its segment s,
//
//     out[b, slot * 128 + r] = dist(q_b, db[s * 128 + r])
//                              if s >= 0 and valid[s * 128 + r], +inf else
//
// with dist the metric's exact f32 formula: euclidean sqrt(sum_d (x - q)^2)
// (the difference form), inner product -sum_d x q, cosine
// 2 acos(clamp(sum_d x q / (|q| |x|), -1, 1)) / pi (a zero denominator
// divides by 1). Every product and square is an f32 FMA on the CUDA cores;
// only the order of the sums differs from the plain version.
//
// What bounds it on an H100: bytes. Each query keeps k + 8 segments of 128
// rows, so at the GIST1M shape (B = 1024, d = 960 padded to 1024, k = 10)
// the pairs hold 1024 x 18 x 128 x 1024 x 4 B = 9.66 GB of rows, but the
// 1024 queries keep at most the store's 8192 segments between them (4.29
// GB, 1.3 ms at 3.35 TB/s), many of them more than once. The arithmetic,
// a subtraction and an FMA a (query, row, dim), is ~7 GFLOP there: 0.1 ms
// at the FP32 peak. The design:
//
// - Segment-major order. The wrapper sorts the pairs by segment id, so the
//   pairs of one segment sit side by side. Block w takes the window of
//   pairs [w * qmax, (w + 1) * qmax) and walks it as runs of one segment:
//   each run's segment is read once for all of the run's queries, and a
//   segment whose run spans two windows is read by two neighbouring
//   blocks, which run at the same time, so the second read hits L2.
// - The segment's 128 rows are one contiguous block of db. They reach
//   shared memory in tiles of tile_rows rows (up to 32 KB), each one bulk
//   async copy (cp.async.bulk) completing on an mbarrier, in a ring of
//   kStages tiles. A row wider than 32 KB is cut into slabs of 32 KB (the
//   last one shorter), a tile each. Thread 0 keeps kStages - 1 tiles in
//   flight ahead of the one being scored, across the runs of the window,
//   and issues the first ones before the block loads its queries.
// - The window's queries (at most qmax, f32) are loaded into shared memory
//   once a block: 16 KB at most where that holds a query, else as many as
//   fit beside the ring. Where not even one fits (d past ~33,000 f32
//   columns), the queries are read from global memory (__ldg) instead.
// - A warp scores one row of the tile against the run's nq queries: each
//   lane takes the row's 16-byte chunks lane, lane + 32, ..., loads each
//   once and adds its terms to NQ running sums (NQ, the run's query count
//   rounded up to 1, 2, 4 or 8, is a template parameter so the sums stay in
//   registers; padded slots repeat the last query and are not written).
//   The 32 lanes' NQ sums are then reduced by a transposed butterfly (each
//   step halves the values a lane carries), so lane l ends with the total
//   of sum l / (32 / NQ), and one lane a sum writes the distance. Where a
//   tile holds fewer rows than the block has warps (rows past 4 KB), the
//   warps split each row's chunks, and their sums meet in shared memory,
//   carried from slab to slab of a cut row. The layout (Layout) is a
//   template parameter, so rows up to 4 KB, the benchmark cells' among
//   them, run a warp a row with no slab arithmetic.
// - Dead rows and -1 segments (no live row) write +inf; a -1 pair reads
//   nothing.
// - The window size adapts to the batch: qmax is at most 8 (4 at
//   d = 1024, the 16 KB of queries), and smaller when the batch has too
//   few pairs to give every SM two windows.
//
// Global offsets are 64-bit. The kernel allocates nothing and launches on
// the caller's stream. Each C entry point returns cudaGetLastError() after
// the launch.

#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSeg = 128;
constexpr int kStages = 3;            // ring depth of row tiles
constexpr int kStageBytes = 32768;    // most bytes a row tile, or a slab
constexpr int kQueryBytes = 16384;    // bytes of a window's queries, where
                                      // they hold one
constexpr int kMaxQ = 8;              // most pairs a window
constexpr float kPi = 3.14159265358979323846f;

enum Metric { kEuclidean = 0, kInnerProduct = 1, kCosine = 2 };

// How a block stages and scores rows: kNarrow, a tile of whole rows with a
// row for every warp (rows up to 4 KB); kWide, the warps split each row,
// cut into slabs past 32 KB; kWideGlobal, kWide with the queries read from
// global memory.
enum Layout { kNarrow = 0, kWide = 1, kWideGlobal = 2 };

struct Params {
  const uint8_t* db;     // (N, dim) rows, f32 or bf16
  const uint8_t* valid;  // (N,) liveness, 0 or 1
  const float* q;        // (nb, dim) f32 queries
  const float* q_norm;   // (nb,) |q| (cosine only)
  const float* db_norm;  // (N,) |x| (cosine only)
  const int32_t* seg;    // (pairs,) segment ids, ascending, -1 first
  const int64_t* perm;   // (pairs,) pair index b * s_keep + slot of each
  float* out;            // (nb, s_keep * 128)
  int64_t pairs;
  int64_t s_keep;
  int dim;
  int qmax;       // pairs a window
  int tile_rows;  // rows a staged tile, a power of two dividing 128 (1
                  // where a row is cut into slabs)
  int slabs;      // tiles a row: 1 unless a row passes kStageBytes
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// One arrival expected: the staging thread's arrive.expect_tx.
__device__ __forceinline__ void mbar_init(uint32_t bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar)
               : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// Copies `bytes` (a multiple of 16, both ends 16-byte aligned) from global
// src to shared dst; the barrier's phase completes when they have landed.
// The proxy fence orders this thread's earlier generic accesses of the
// destination (the previous tile's reads, after a block barrier) before
// the async write.
__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar), "r"(bytes)
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// Waits until the barrier's phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT;\n"
      "}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// A 16-byte chunk of a row as f32: 4 f32 or 8 bf16 values (a bf16 value is
// the high half of its f32, so the widening is exact).
template <typename Row>
struct Chunk;

template <>
struct Chunk<float> {
  static constexpr int kElems = 4;
  __device__ __forceinline__ static void unpack(uint4 w, float (&x)[4]) {
    x[0] = __uint_as_float(w.x);
    x[1] = __uint_as_float(w.y);
    x[2] = __uint_as_float(w.z);
    x[3] = __uint_as_float(w.w);
  }
};

struct Bf16 {};  // a row element of two bytes, bf16

template <>
struct Chunk<Bf16> {
  static constexpr int kElems = 8;
  __device__ __forceinline__ static void unpack(uint4 w, float (&x)[8]) {
    const uint32_t v[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      x[2 * i] = __uint_as_float(v[i] << 16);
      x[2 * i + 1] = __uint_as_float(v[i] & 0xffff0000u);
    }
  }
};

// Sums V values across the warp's 32 lanes: each of the first log2(V)
// steps sends half of the values a lane carries to its partner and keeps
// the other half, so lane l ends with the total of value l / (32 / V);
// the remaining steps add across the lanes that hold the same value.
template <int V>
__device__ __forceinline__ float transpose_reduce(float (&v)[V], int lane) {
#pragma unroll
  for (int n = V, o = 16; n > 1; n /= 2, o /= 2) {
    const bool up = (lane & o) != 0;
#pragma unroll
    for (int i = 0; i < n / 2; ++i) {
      const float send = up ? v[i] : v[i + n / 2];
      const float keep = up ? v[i + n / 2] : v[i];
      v[i] = keep + __shfl_xor_sync(0xffffffffu, send, o);
    }
  }
#pragma unroll
  for (int o = 16 / V; o >= 1; o /= 2) {
    v[0] += __shfl_xor_sync(0xffffffffu, v[0], o);
  }
  return v[0];
}

template <int M>
__device__ __forceinline__ float finish(float sum, float qn, float xn) {
  if constexpr (M == kEuclidean) {
    return sqrtf(fmaxf(sum, 0.0f));
  } else if constexpr (M == kInnerProduct) {
    return -sum;
  } else {
    const float den = qn * xn;
    const float sim = fminf(fmaxf(sum / (den == 0.0f ? 1.0f : den), -1.0f),
                            1.0f);
    return 2.0f * acosf(sim) / kPi;
  }
}

// Staged tile t of a segment whose first row is `row` in db: its source
// and its bytes. A tile is tile_rows whole rows, or one slab of a row cut
// into slabs.
template <int L>
__device__ __forceinline__ const uint8_t* tile_src(const Params& p,
                                                   int64_t row_bytes,
                                                   int64_t row, int t,
                                                   uint32_t* bytes) {
  if constexpr (L == kNarrow) {
    *bytes = static_cast<uint32_t>(p.tile_rows * row_bytes);
    return p.db + (row + static_cast<int64_t>(t) * p.tile_rows) * row_bytes;
  } else {
    const int sl = t % p.slabs;
    const int64_t first =
        row + static_cast<int64_t>(t / p.slabs) * p.tile_rows;
    const int64_t rest = row_bytes - static_cast<int64_t>(sl) * kStageBytes;
    *bytes = static_cast<uint32_t>(
        p.slabs == 1 ? p.tile_rows * row_bytes
                     : (rest < kStageBytes ? rest : kStageBytes));
    return p.db + first * row_bytes + static_cast<int64_t>(sl) * kStageBytes;
  }
}

// The distance of row r of the tile (row0 + r in db) to the run's query j,
// or +inf for a dead row, written to its place in out.
template <int M>
__device__ __forceinline__ void put(const Params& p, const int64_t* off,
                                    const float* qn, int j, int r0, int r,
                                    int64_t row0, float sum) {
  const int64_t row = row0 + r;
  const float xn = M == kCosine ? p.db_norm[row] : 0.0f;
  p.out[off[j] + r0 + r] =
      p.valid[row] ? finish<M>(sum, qn[j], xn) : __int_as_float(0x7f800000);
}

// Scores the staged tile (rows of `chunks` 16-byte chunks, the columns from
// col0 on) against the run's nq (<= NQ) queries. qs: the run's first query
// in shared memory, or (kWideGlobal) qrow: the run's query rows in q. off: each
// pair's output offset; r0: the tile's first row within the segment; row0:
// its row in db. last: the tile holds the rows' last columns. part, carry:
// the per-warp sums and the sums carried from slab to slab of a cut row.
template <typename Row, int M, int NQ, int L>
__device__ void score_tile(const Params& p, const uint4* tile, int chunks,
                           int col0, const float* qs, const int64_t* qrow,
                           const int64_t* off, const float* qn, int nq,
                           int r0, int64_t row0, bool last, float* part,
                           float* carry) {
  using C = Chunk<Row>;
  constexpr int kE = C::kElems;
  constexpr int kSpan = 32 / NQ;
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  constexpr bool QG = L == kWideGlobal;
  const float* qb;
  std::conditional_t<QG, int64_t, int> qoff[NQ];
#pragma unroll
  for (int j = 0; j < NQ; ++j) {
    const int jj = j < nq ? j : nq - 1;
    if constexpr (QG) {
      qoff[j] = qrow[jj] * p.dim + col0;
    } else {
      qoff[j] = jj * p.dim + col0;
    }
  }
  if constexpr (QG) {
    qb = p.q;
  } else {
    qb = qs;
  }
  // Warps a row: one (kNarrow), else the tile's wpr = 8 / tile_rows warps
  // of a row take every wpr-th run of 32 chunks.
  const int wpr = L == kNarrow ? 1 : kWarps / p.tile_rows;
  for (int r = L == kNarrow ? warp : warp / wpr; r < p.tile_rows;
       r += L == kNarrow ? kWarps : p.tile_rows) {
    const uint4* x = tile + r * chunks;
    float acc[NQ];
#pragma unroll
    for (int j = 0; j < NQ; ++j) acc[j] = 0.0f;
#pragma unroll 2
    for (int c = (warp % wpr) * 32 + lane; c < chunks; c += 32 * wpr) {
      float xf[kE];
      C::unpack(x[c], xf);
#pragma unroll
      for (int j = 0; j < NQ; ++j) {
        const float4* qc =
            reinterpret_cast<const float4*>(qb + qoff[j] + c * kE);
#pragma unroll
        for (int h = 0; h < kE / 4; ++h) {
          float4 qv;
          if constexpr (QG) {
            qv = __ldg(qc + h);
          } else {
            qv = qc[h];
          }
          const float qf[4] = {qv.x, qv.y, qv.z, qv.w};
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            if constexpr (M == kEuclidean) {
              const float t = xf[4 * h + e] - qf[e];
              acc[j] = fmaf(t, t, acc[j]);
            } else {
              acc[j] = fmaf(xf[4 * h + e], qf[e], acc[j]);
            }
          }
        }
      }
    }
    const float sum = transpose_reduce<NQ>(acc, lane);
    const int j = lane / kSpan;
    if (lane % kSpan == 0 && j < nq) {
      if constexpr (L == kNarrow) {
        put<M>(p, off, qn, j, r0, r, row0, sum);
      } else {
        part[warp * kMaxQ + j] = sum;
      }
    }
  }
  if constexpr (L != kNarrow) {
    // The warps' sums of each (row, query), added in warp order.
    __syncthreads();
    const int i = threadIdx.x;
    if (i < p.tile_rows * nq) {
      const int r = i / nq;
      const int j = i % nq;
      float sum = col0 > 0 ? carry[i] : 0.0f;
      for (int w = 0; w < wpr; ++w) sum += part[(r * wpr + w) * kMaxQ + j];
      if (last) {
        put<M>(p, off, qn, j, r0, r, row0, sum);
      } else {
        carry[i] = sum;
      }
    }
  }
}

template <typename Row, int M, int L>
__global__ void __launch_bounds__(kThreads)
rerank_segments_kernel(const Params p) {
  extern __shared__ __align__(128) uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bar_s[kStages];
  __shared__ int32_t seg_s[kMaxQ];
  __shared__ int64_t off_s[kMaxQ];
  __shared__ int64_t qrow_s[kMaxQ];
  __shared__ float qn_s[kMaxQ];
  __shared__ float part_s[kWarps * kMaxQ];
  __shared__ float carry_s[kWarps * kMaxQ];
  __shared__ int run_s[kMaxQ + 1];  // run starts in the window, then its end
  __shared__ int n_runs_s;
  __shared__ int first_live_s;

  constexpr int kE = Chunk<Row>::kElems;
  const int tid = threadIdx.x;
  const int64_t base = static_cast<int64_t>(blockIdx.x) * p.qmax;
  const int wn = static_cast<int>(
      p.pairs - base < p.qmax ? p.pairs - base : p.qmax);
  const int64_t row_bytes = static_cast<int64_t>(p.dim) * (kE == 4 ? 4 : 2);
  const int slabs = L == kNarrow ? 1 : p.slabs;
  const uint32_t stage_bytes = static_cast<uint32_t>(
      slabs == 1 ? p.tile_rows * row_bytes : kStageBytes);
  const int n_tiles = kSeg / p.tile_rows * slabs;
  float* qs = reinterpret_cast<float*>(smem_raw + kStages * stage_bytes);

  // The window's pairs: segment, output offset, query row.
  if (tid < wn) {
    const int64_t pair = p.perm[base + tid];
    seg_s[tid] = p.seg[base + tid];
    off_s[tid] = pair * kSeg;
    qrow_s[tid] = pair / p.s_keep;
  }
  if (tid == 0) {
    for (int st = 0; st < kStages; ++st) mbar_init(smem_u32(&bar_s[st]));
  }
  __syncthreads();
  // Thread 0 splits the window into runs of one segment and starts the
  // first tiles' copies while the others load the window's queries.
  if (tid == 0) {
    int first_live = 0;
    int n_runs = 0;
    for (int j = 0; j < wn; ++j) {
      if (seg_s[j] < 0) {
        first_live = j + 1;
      } else if (j == first_live || seg_s[j] != seg_s[j - 1]) {
        run_s[n_runs++] = j;
      }
    }
    run_s[n_runs] = wn;
    n_runs_s = n_runs;
    first_live_s = first_live;
    const int total = n_runs * n_tiles;
    for (int g = 0; g < kStages && g < total; ++g) {
      uint32_t bytes;
      const uint8_t* src =
          tile_src<L>(p, row_bytes,
                   static_cast<int64_t>(seg_s[run_s[g / n_tiles]]) * kSeg,
                   g % n_tiles, &bytes);
      bulk_copy(smem_u32(smem_raw + g * stage_bytes), src, bytes,
                smem_u32(&bar_s[g]));
    }
  }
  // The window's queries, one after another, a float4 a thread (a -1
  // pair's query too: its row is a real query, and it is never scored).
  if constexpr (L != kWideGlobal) {
    const int q4 = p.dim / 4;
    for (int i = tid; i < wn * q4; i += kThreads) {
      const int j = i / q4;
      const int c = i % q4;
      reinterpret_cast<float4*>(qs)[i] =
          __ldg(reinterpret_cast<const float4*>(p.q + qrow_s[j] * p.dim) + c);
    }
  }
  if (M == kCosine && tid < wn) qn_s[tid] = p.q_norm[qrow_s[tid]];
  __syncthreads();
  const int n_runs = n_runs_s;
  const int first_live = first_live_s;

  // -1 pairs: no live row in the segment.
  const float inf = __int_as_float(0x7f800000);
  for (int i = tid; i < first_live * kSeg; i += kThreads) {
    p.out[off_s[i / kSeg] + i % kSeg] = inf;
  }

  const int total = n_runs * n_tiles;
  for (int g = 0; g < total; ++g) {
    const int st = g % kStages;
    mbar_wait(smem_u32(&bar_s[st]), (g / kStages) & 1);
    const int run = g / n_tiles;
    const int t = g % n_tiles;
    const int sl = t % slabs;
    const int j0 = run_s[run];
    const int nq = run_s[run + 1] - j0;
    const int r0 = t / slabs * p.tile_rows;
    const int64_t row0 = static_cast<int64_t>(seg_s[j0]) * kSeg + r0;
    uint32_t bytes;
    tile_src<L>(p, row_bytes, row0 - r0, t, &bytes);
    const int chunks = static_cast<int>(
        (slabs == 1 ? row_bytes : bytes) / 16);
    const int col0 = sl * (kStageBytes / (kE == 4 ? 4 : 2));
    const bool last = sl == slabs - 1;
    const uint4* tl =
        reinterpret_cast<const uint4*>(smem_raw + st * stage_bytes);
    const float* q0 = L == kWideGlobal ? qs : qs + j0 * p.dim;
    const int64_t* qr = qrow_s + j0;
    const int64_t* off = off_s + j0;
    const float* qn = qn_s + j0;
    if (nq == 1) {
      score_tile<Row, M, 1, L>(p, tl, chunks, col0, q0, qr, off, qn, nq, r0,
                                row0, last, part_s, carry_s);
    } else if (nq == 2) {
      score_tile<Row, M, 2, L>(p, tl, chunks, col0, q0, qr, off, qn, nq, r0,
                                row0, last, part_s, carry_s);
    } else if (nq <= 4) {
      score_tile<Row, M, 4, L>(p, tl, chunks, col0, q0, qr, off, qn, nq, r0,
                                row0, last, part_s, carry_s);
    } else {
      score_tile<Row, M, 8, L>(p, tl, chunks, col0, q0, qr, off, qn, nq, r0,
                                row0, last, part_s, carry_s);
    }
    // Every warp is done with stage st before it is refilled.
    __syncthreads();
    if (tid == 0 && g + kStages < total) {
      const int h = g + kStages;
      uint32_t nbytes;
      const uint8_t* src =
          tile_src<L>(p, row_bytes,
                   static_cast<int64_t>(seg_s[run_s[h / n_tiles]]) * kSeg,
                   h % n_tiles, &nbytes);
      bulk_copy(smem_u32(smem_raw + st * stage_bytes), src, nbytes,
                smem_u32(&bar_s[st]));
    }
  }
}

template <typename Row, int M, int L>
cudaError_t run(const Params& p, int smem, cudaStream_t stream) {
  auto kernel = rerank_segments_kernel<Row, M, L>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int64_t blocks = (p.pairs + p.qmax - 1) / p.qmax;
  kernel<<<dim3(static_cast<unsigned>(blocks)), kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename Row, int M>
cudaError_t launch(const Params& p0, int device, cudaStream_t stream) {
  Params p = p0;
  const int esize = Chunk<Row>::kElems == 4 ? 4 : 2;
  const int64_t row_bytes = static_cast<int64_t>(p.dim) * esize;
  // Tiles: whole rows up to kStageBytes, else slabs of a row.
  p.tile_rows = kSeg;
  p.slabs = 1;
  if (row_bytes > kStageBytes) {
    p.tile_rows = 1;
    p.slabs = static_cast<int>((row_bytes + kStageBytes - 1) / kStageBytes);
  }
  while (p.tile_rows * row_bytes > kStageBytes && p.tile_rows > 1) {
    p.tile_rows /= 2;
  }
  const int64_t ring =
      kStages * (p.slabs == 1 ? p.tile_rows * row_bytes : kStageBytes);
  // The window's queries: kQueryBytes where that holds one (two blocks an
  // SM), else as many as fit beside the ring (one block an SM), else none
  // (read from global memory).
  int opt_in = 0;
  int n_sm = 0;
  cudaError_t err = cudaDeviceGetAttribute(
      &opt_in, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, rerank_segments_kernel<Row, M, kWide>);
  if (err != cudaSuccess) return err;
  const int64_t q_bytes = 4LL * p.dim;
  int64_t qmax = q_bytes <= kQueryBytes
                     ? kQueryBytes / q_bytes
                     : (opt_in - static_cast<int64_t>(attr.sharedSizeBytes) -
                        ring) / q_bytes;
  const bool global_queries = qmax < 1;
  if (global_queries || qmax > kMaxQ) qmax = kMaxQ;
  // Smaller windows where the batch would not give every SM two.
  while (qmax > 1 && (p.pairs + qmax - 1) / qmax < 2LL * n_sm) qmax /= 2;
  p.qmax = static_cast<int>(qmax);
  if (global_queries) {
    return run<Row, M, kWideGlobal>(p, static_cast<int>(ring), stream);
  }
  const int smem = static_cast<int>(ring + qmax * q_bytes);
  if (p.tile_rows >= kWarps) return run<Row, M, kNarrow>(p, smem, stream);
  return run<Row, M, kWide>(p, smem, stream);
}

template <typename Row>
int dispatch(const void* db, const void* valid, const void* q,
             const void* q_norm, const void* db_norm, const void* seg,
             const void* perm, void* out, int64_t pairs, int64_t s_keep,
             int64_t dim, int64_t metric, int device, void* stream) {
  // This library carries its own CUDA runtime: select the tensors' device
  // in it before launching on the caller's stream.
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  const int64_t esize = Chunk<Row>::kElems == 4 ? 4 : 2;
  if (dim < 1 || dim * esize % 16 || dim >= (1LL << 31) || s_keep < 1 ||
      pairs >= (1LL << 31) || metric < 0 || metric > 2) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (pairs <= 0) return static_cast<int>(cudaGetLastError());
  Params p{static_cast<const uint8_t*>(db),
           static_cast<const uint8_t*>(valid),
           static_cast<const float*>(q),
           static_cast<const float*>(q_norm),
           static_cast<const float*>(db_norm),
           static_cast<const int32_t*>(seg),
           static_cast<const int64_t*>(perm),
           static_cast<float*>(out),
           pairs, s_keep, static_cast<int>(dim), 0, 0, 0};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (metric == kEuclidean) {
    err = launch<Row, kEuclidean>(p, device, st);
  } else if (metric == kInnerProduct) {
    err = launch<Row, kInnerProduct>(p, device, st);
  } else {
    err = launch<Row, kCosine>(p, device, st);
  }
  return static_cast<int>(err);
}

}  // namespace

// Shape contract (checked by the Python wrapper): db (N, dim) contiguous
// and 16-byte aligned, N % 128 == 0, dim * element size % 16 == 0; valid
// (N,) bool; q (nb, dim) f32 contiguous and 16-byte aligned; q_norm (nb,)
// and db_norm (N,) f32 for cosine (else unread); seg (pairs,) int32
// ascending, each -1 or a segment id < N / 128; perm (pairs,) int64, a
// permutation of 0 .. pairs - 1 with pairs = nb * s_keep; out (nb, s_keep
// * 128) f32; metric 0 euclidean, 1 inner product, 2 cosine.
extern "C" int rerank_segments_f32(const void* db, const void* valid,
                                   const void* q, const void* q_norm,
                                   const void* db_norm, const void* seg,
                                   const void* perm, void* out, int64_t pairs,
                                   int64_t s_keep, int64_t dim, int64_t metric,
                                   int device, void* stream) {
  return dispatch<float>(db, valid, q, q_norm, db_norm, seg, perm, out, pairs,
                         s_keep, dim, metric, device, stream);
}

extern "C" int rerank_segments_bf16(const void* db, const void* valid,
                                    const void* q, const void* q_norm,
                                    const void* db_norm, const void* seg,
                                    const void* perm, void* out,
                                    int64_t pairs, int64_t s_keep,
                                    int64_t dim, int64_t metric, int device,
                                    void* stream) {
  return dispatch<Bf16>(db, valid, q, q_norm, db_norm, seg, perm, out, pairs,
                        s_keep, dim, metric, device, stream);
}
