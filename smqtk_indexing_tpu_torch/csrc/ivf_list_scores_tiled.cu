// K7: masked surrogate scores over windows of the tiled-transposed IVF
// code layout, written by hand for Hopper (sm_90a).
//
// Replaces the TPU kernel smqtk_indexing_tpu/ops/pallas_ivf.py
// ivf_list_scores_tiled -> _ivf_tiled_kernel (:397-519). The codes are
// int8 in (n_tiles, d, tile_n) tiles (row r at [r / tile_n, :,
// r % tile_n]), with per-row stats s2 in (n_tiles, 1, tile_n) f32 (+inf on
// dead or removed rows). For every (query b, probe slot p) it scores the
// W = 640 columns c0 + w of tile ti:
//
//     out[b, p, w] = s2[ti, 0, c0 + w] - 2 sum_k t_bk u[ti, k, c0 + w]
//                    if lo <= w < hi, +inf otherwise
//
// with t the query fold ((q - b) a for euclidean and cosine, q a / 2
// against zeroed stats for inner_product).
//
// What bounds it on an H100: bytes. A live window's columns inside
// [lo, hi) hold d code bytes each (a list averages ~244 of the 640
// columns), read for 2 flops a byte, and every slot, live or dead, writes
// 2.5 KB of scores: at the serving shape (B = 1024, P = 64 slots, ~5 of
// them live a query) the output alone is 168 MB, most of it +inf. The
// design reads only the columns the windows need, keeps every lane of a
// busy warp on them, and writes everything in 16-byte streaming stores:
//
// - A block of kThreads = 160 threads walks a run of one query's slots
//   (csrc/slot_runs.cuh: all of them when the queries fill the card
//   kWaves times, else runs of at least kMinRun), kThreads slots a pass.
//   A pass loads its slots' windows into shared memory and counts each
//   live window's chunks of kCols = 8 columns that meet [lo, hi) (c0 is a
//   multiple of 128, so a chunk is 8-byte aligned in every code row); a
//   block scan numbers the pass's chunks, and thread i takes chunks i,
//   i + kThreads, ... So neighbouring lanes score neighbouring chunks of
//   one window, and a chunk outside its window is never read.
// - Dead slots, and a live window's chunks outside [lo, hi), get +inf
//   from the whole block in output order, one 16-byte streaming store a
//   thread a slot (kThreads float4 are one window), with no load between
//   them.
// - A chunk's thread loads its 8 columns of a code row as one 8-byte load,
//   kBatch = 8 code rows a batch, the next batch in flight while one is
//   summed; the chunks at the window's edges are masked when stored.
//   (16 columns a thread with 16-byte loads, or each row's load issued
//   as the row kBatch before it is summed in place of whole batches, took
//   longer at the serving batch: PERF.md, section 6.)
// - The query fold sits in shared memory (d floats), staged once a block,
//   and is read as a broadcast.
// - Each column accumulates sum_k t_k u_k in f32 FFMA in the order
//   k = 0 .. d - 1 from 0.0f, so the output equals the first version's
//   (a block a slot, every column read) bit for bit. int8 codes are exact
//   in f32, so this is the TPU's split-bf16 product without its ~2^-16
//   residual. A +inf stat stays +inf, so a removed row never wins.
// - Scores and +inf go out as 16-byte streaming stores (__stcs): the
//   output is read once, by the top-k, and need not stay in L2.
// - Global offsets are 64-bit.
//
// The kernel allocates nothing and launches on the caller's stream. The C
// entry point returns cudaGetLastError() after the launch.

#include <cuda_runtime.h>

#include <cstdint>

#include "slot_runs.cuh"

namespace {

constexpr int kWindow = 640;
constexpr int kCols = 8;                  // columns a chunk (a thread's)
constexpr int kWords = kCols / 4;         // 32-bit words of a chunk's row
constexpr int kThreads = kWindow / 4;     // 160: a window is a float4 each
constexpr int kWarps = kThreads / 32;
constexpr int kBatch = 8;   // code rows a batch: the next in flight
constexpr int kMinRun = 8;  // fewest slots a block, when queries are few
constexpr int kWaves = 4;   // the grid fills the resident blocks this often

// A 16-byte streaming store: the output is read once, by the top-k, and
// need not stay in L2.
__device__ __forceinline__ void store4(float* p, float4 v) {
  __stcs(reinterpret_cast<float4*>(p), v);
}

// Byte b of w as a signed int8 code, widened exactly to f32.
__device__ __forceinline__ float code_at(uint32_t w, int b) {
  return static_cast<float>(static_cast<int32_t>(w << (24 - 8 * b)) >> 24);
}

// A chunk's codes in one code row: one aligned load.
struct alignas(4 * kWords) ChunkRow {
  uint32_t w[kWords];
};

// acc[i] += tk * code of column i, for the kCols columns of one code row.
__device__ __forceinline__ void fma_row(float acc[kCols], float tk,
                                        const ChunkRow& u) {
#pragma unroll
  for (int i = 0; i < kWords; ++i) {
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      acc[4 * i + b] = fmaf(tk, code_at(u.w[i], b), acc[4 * i + b]);
    }
  }
}

// Scores the kCols columns from col of a live window [l0, l1) of tile
// `tile` from column c0, and writes them to dst.
__device__ __forceinline__ void score_chunk(
    const int8_t* __restrict__ db3, const float* __restrict__ s2t,
    const float* t_s, int64_t tile, int64_t c0, int col, int l0, int l1,
    int64_t dim, int64_t tile_n, float* dst) {
  const int8_t* src = db3 + tile * dim * tile_n + c0 + col;
  auto load = [&](int64_t k) {
    return k < dim ? *reinterpret_cast<const ChunkRow*>(src + k * tile_n)
                   : ChunkRow{};
  };
  ChunkRow cur[kBatch];
#pragma unroll
  for (int r = 0; r < kBatch; ++r) cur[r] = load(r);
  float acc[kCols];
#pragma unroll
  for (int v = 0; v < kCols; ++v) acc[v] = 0.0f;
  for (int64_t k0 = 0; k0 < dim; k0 += kBatch) {
    ChunkRow nxt[kBatch];  // the next batch's rows, in flight meanwhile
#pragma unroll
    for (int r = 0; r < kBatch; ++r) nxt[r] = load(k0 + kBatch + r);
#pragma unroll
    for (int r = 0; r < kBatch; ++r) {
      if (k0 + r < dim) fma_row(acc, t_s[k0 + r], cur[r]);
      cur[r] = nxt[r];
    }
  }
  const float4* s2 =
      reinterpret_cast<const float4*>(s2t + tile * tile_n + c0 + col);
  const float inf = __int_as_float(0x7f800000);
#pragma unroll
  for (int v = 0; v < kCols / 4; ++v) {
    const float4 s = __ldg(s2 + v);
    const float sv[4] = {s.x, s.y, s.z, s.w};
    float r[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int w = col + 4 * v + e;
      r[e] = w >= l0 && w < l1 ? sv[e] - 2.0f * acc[4 * v + e] : inf;
    }
    store4(dst + 4 * v, make_float4(r[0], r[1], r[2], r[3]));
  }
}

__global__ void __launch_bounds__(kThreads)
ivf_list_scores_tiled_kernel(const float* __restrict__ t,
                             const int8_t* __restrict__ db3,
                             const float* __restrict__ s2t,
                             const int32_t* __restrict__ ti,
                             const int32_t* __restrict__ c0,
                             const int32_t* __restrict__ lo,
                             const int32_t* __restrict__ hi,
                             float* __restrict__ out, int64_t n_probe,
                             int run, int64_t dim, int64_t tile_n) {
  extern __shared__ __align__(16) float t_s[];
  // The pass's windows, and each one's first chunk in the pass's count.
  __shared__ int lo_s[kThreads], hi_s[kThreads], ti_s[kThreads],
      c0_s[kThreads], chunk_s[kThreads];
  __shared__ int warp_chunks[kWarps];

  const int tid = threadIdx.x;
  // This block's run of query blockIdx.x's slots: the n_run slots from
  // row0 in the (n_queries, n_probe) slot tables.
  const int64_t p0 = static_cast<int64_t>(blockIdx.y) * run;
  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * n_probe + p0;
  const int n_run = static_cast<int>(n_probe - p0 < run ? n_probe - p0
                                                         : run);
  const float inf = __int_as_float(0x7f800000);
  const float4 inf4 = make_float4(inf, inf, inf, inf);

  for (int i = tid; i < dim; i += kThreads) {
    t_s[i] = t[static_cast<int64_t>(blockIdx.x) * dim + i];
  }

  for (int base = 0; base < n_run; base += kThreads) {
    const int n_pass = n_run - base < kThreads ? n_run - base : kThreads;
    int n_chunks = 0;
    if (tid < n_pass) {
      const int64_t slot = row0 + base + tid;
      const int l0 = lo[slot];
      const int l1 = hi[slot];
      lo_s[tid] = l0;
      hi_s[tid] = l1;
      if (l1 > l0) {
        ti_s[tid] = ti[slot];
        c0_s[tid] = c0[slot];
        n_chunks = (l1 + kCols - 1) / kCols - l0 / kCols;
      }
    }
    int total = 0;  // (the barrier inside also publishes the fold)
    chunk_s[tid] = block_prefix<kThreads>(n_chunks, warp_chunks, &total);
    __syncthreads();  // the chunk numbering

    // +inf wherever no chunk writes: thread tid owns float4 tid of each
    // window, in chunk my_chunk.
    float* pass_out = out + (row0 + base) * kWindow;
    const int my_chunk = tid / (kCols / 4);
    for (int j = 0; j < n_pass; ++j) {
      const int l0 = lo_s[j];
      const int l1 = hi_s[j];
      const bool dead = l1 <= l0 || my_chunk < l0 / kCols ||
                        my_chunk >= (l1 + kCols - 1) / kCols;
      if (dead) store4(pass_out + j * kWindow + 4 * tid, inf4);
    }

    for (int i = tid; i < total; i += kThreads) {
      const int j = unit_slot<kThreads>(chunk_s, n_pass, i);
      const int l0 = lo_s[j];
      const int col = kCols * (l0 / kCols + (i - chunk_s[j]));
      score_chunk(db3, s2t, t_s, ti_s[j], c0_s[j], col, l0, hi_s[j], dim,
                  tile_n, pass_out + j * kWindow + col);
    }
    __syncthreads();  // every thread is done with this pass's tables
  }
}

}  // namespace

// Shape contract (checked by the Python wrapper): db3 (n_tiles, dim,
// tile_n) int8 and s2t (n_tiles, 1, tile_n) f32, contiguous and 16-byte
// aligned, tile_n % 128 == 0; t (n_queries, dim) f32; ti, c0, lo, hi
// (n_queries, n_probe) int32 with c0 % 128 == 0, c0 + win <= tile_n and
// 0 <= lo <= hi <= win; out (n_queries, n_probe, win) f32, 16-byte
// aligned; win == 640; n_queries and n_probe < 2^31 (the grid is
// n_queries x runs blocks).
extern "C" int ivf_list_scores_tiled_i8(
    const void* t, const void* db3, const void* s2t, const void* ti,
    const void* c0, const void* lo, const void* hi, void* out,
    int64_t n_queries, int64_t n_probe, int64_t dim, int64_t tile_n,
    int64_t win, int device, void* stream) {
  // This library carries its own CUDA runtime: select the tensors' device
  // in it before launching on the caller's stream.
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  const size_t smem = static_cast<size_t>(dim) * sizeof(float);
  if (win != kWindow || smem > 48 * 1024 || tile_n % 128 ||
      n_queries >= (1LL << 31) || n_probe >= (1LL << 31)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n_queries <= 0 || n_probe <= 0) {
    return static_cast<int>(cudaGetLastError());
  }
  int64_t run = 0;
  int64_t runs = 0;
  const cudaError_t err =
      plan_slot_runs(ivf_list_scores_tiled_kernel, kThreads, smem, device,
                     n_queries, n_probe, kMinRun, kWaves, &run, &runs);
  if (err != cudaSuccess) return static_cast<int>(err);
  ivf_list_scores_tiled_kernel<<<
      dim3(static_cast<unsigned>(n_queries), static_cast<unsigned>(runs)),
      kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(t), static_cast<const int8_t*>(db3),
      static_cast<const float*>(s2t), static_cast<const int32_t*>(ti),
      static_cast<const int32_t*>(c0), static_cast<const int32_t*>(lo),
      static_cast<const int32_t*>(hi), static_cast<float*>(out), n_probe,
      static_cast<int>(run), dim, tile_n);
  return static_cast<int>(cudaGetLastError());
}
