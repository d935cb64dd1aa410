// K6: masked L2 surrogate scores over row-major IVF list windows, written
// by hand for Hopper (sm_90a).
//
// Replaces the TPU kernel smqtk_indexing_tpu/ops/pallas_ivf.py
// ivf_list_scores -> _ivf_kernel (:50-188). For every (query b, probe p)
// it scores the L rows start[b, p] + l, l in [0, L), of the list-sorted
// (N, d) database (f32, bf16 or int8 SQ8 codes):
//
//     out[b, p, l] = sum_k (a_k u_k)^2 - 2 sum_k t_bk u_k   if lo <= l < hi
//                    +inf                                    otherwise
//
// with u the stored row (widened to f32), a the per-dim row scale (ones
// for float storage, the SQ8 codec scale for codes) and t the query (or
// its SQ8 fold (q - b) a). The output is (B, P, L) f32, in the natural
// order: the TPU kernel's (steps, L, probes-per-step) lane order existed
// for its vector registers.
//
// What bounds it on an H100: bytes. A live window's rows [lo, hi) are
// contiguous in the (N, d) layout (a list averages ~244 rows of d values,
// 125 KB in f32 at d = 128) and are read for 4 flops a value, far below
// the card's 295 flops a byte; every slot writes L floats. The design
// keeps many rows' bytes in flight and reads nothing outside the windows:
//
// - A block of kThreads = 256 threads (8 warps) walks a run of one
//   query's slots (csrc/slot_runs.cuh: all of them when the queries fill
//   the card kWaves times, else runs of at least kMinRun), kThreads slots
//   a pass. A pass loads its slots' windows into shared memory and counts
//   each live window's tiles of kTile = 32 rows (aligned to 32 within the
//   window, from the one holding lo to the one holding hi - 1); a block
//   scan numbers them, and the warps take the pass's tiles in turn.
// - A warp scores a tile: 8 lanes a row, 4 rows at a time; lane l of a
//   row reads 16 bytes at 16 l of each 128-byte column block of the row,
//   so 8 lanes read 128 contiguous bytes. A lane loads the 8 rows of the
//   tile that are its (4 u + g, u < 8, g its row group) before any
//   arithmetic: 8 x 16 bytes in flight a lane, 4 KB a warp, whatever the
//   dtype. Rows outside [lo, hi) are not read.
// - The query and the row scale sit in shared memory (2 d floats), staged
//   once a block. A lane reads the 16 bytes of t and a that match its
//   values (1, 2 or 4 float4 per 16-byte piece for f32, bf16, int8); they
//   are stored with the float4 index i at i ^ ((i >> 3) & (F - 1)), F
//   those float4 a piece, so the 8 lanes of a row read 8 distinct bank
//   groups (4 row groups read the same words: a broadcast).
// - Each lane sums its part of the 8 rows' (a u)^2 - 2 t u in f32 FFMA;
//   one transposed butterfly over the row's 8 lanes (offsets 4, 2, 1)
//   halves the 8 partial scores at each step, 7 shuffles for the tile's
//   32 rows, and leaves lane (g, l) holding row 4 l + g. The warp writes
//   the tile's 32 scores (+inf outside [lo, hi)) as one 128-byte store.
// - Dead slots, and the tiles of a live window outside its rows, get
//   +inf from the whole block in output order, 16-byte streaming stores
//   (__stcs): the output is read once, by the top-k.
// - Full f32 FFMA, no tensor cores. bf16 and int8 are exact in f32; the
//   sums run in another order than the plain version's, so the kernel
//   agrees with float64 to rounding.
// - Global offsets are 64-bit.
//
// The kernel allocates nothing and launches on the caller's stream. The C
// entry points return cudaGetLastError() after the launch.

#include <cuda_runtime.h>

#include <cstdint>

#include "slot_runs.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRowLanes = 8;            // lanes a row
constexpr int kRowGroups = 32 / kRowLanes;  // rows a warp at a time: 4
constexpr int kSteps = 8;               // rows a lane loads a tile
constexpr int kTile = kRowGroups * kSteps;  // rows a warp tile: 32
constexpr int kMinRun = 8;  // fewest slots a block, when queries are few
constexpr int kWaves = 4;   // the grid fills the resident blocks this often

// The 16 bytes at p, widened to f32: 4 f32, 8 bf16 or 16 int8 values.
template <typename T>
struct Piece;

template <>
struct Piece<float> {
  static constexpr int kValues = 4;
  static __device__ __forceinline__ void widen(const uint4& w,
                                               float v[kValues]) {
    v[0] = __uint_as_float(w.x);
    v[1] = __uint_as_float(w.y);
    v[2] = __uint_as_float(w.z);
    v[3] = __uint_as_float(w.w);
  }
};

// bf16 as raw 16-bit patterns, little-endian.
template <>
struct Piece<uint16_t> {
  static constexpr int kValues = 8;
  static __device__ __forceinline__ void widen(const uint4& w,
                                               float v[kValues]) {
    const uint32_t x[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      v[2 * i] = __uint_as_float(x[i] << 16);
      v[2 * i + 1] = __uint_as_float(x[i] & 0xffff0000u);
    }
  }
};

template <>
struct Piece<int8_t> {
  static constexpr int kValues = 16;
  static __device__ __forceinline__ void widen(const uint4& w,
                                               float v[kValues]) {
    const uint32_t x[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        v[4 * i + b] = static_cast<float>(
            static_cast<int32_t>(x[i] << (24 - 8 * b)) >> 24);
      }
    }
  }
};

// Shared-memory slot of float4 i of t or a: the 8 lanes of a row read
// float4 F l + f (f < F) at the same f, and this puts them in 8 distinct
// groups of 4 banks.
template <int F>
__device__ __forceinline__ int swizzle(int i) {
  return i ^ ((i >> 3) & (F - 1));
}

__device__ __forceinline__ float comp(const float4& v, int e) {
  return e == 0 ? v.x : e == 1 ? v.y : e == 2 ? v.z : v.w;
}

// Scores tile m (window rows 32 m .. 32 m + 31) of a live window and
// writes its 32 scores to o (the slot's output).
template <typename T>
__device__ __forceinline__ void score_tile(
    const T* __restrict__ db, int64_t start, int m, int l0, int l1,
    int64_t dim, const float4* t4, const float4* a4, float* o, int lane) {
  constexpr int kV = Piece<T>::kValues;
  constexpr int kF = kV / 4;  // float4 of t (or a) a 16-byte piece
  const int g = lane / kRowLanes;
  const int l = lane % kRowLanes;
  const int w0 = m * kTile;
  const int64_t row_bytes = dim * static_cast<int64_t>(sizeof(T));
  const int n_blocks = static_cast<int>(row_bytes / 128);
  const char* rows = reinterpret_cast<const char*>(db) +
                     (start + w0 + g) * row_bytes + 16 * l;
  bool ok[kSteps];
#pragma unroll
  for (int u = 0; u < kSteps; ++u) {
    const int w = w0 + kRowGroups * u + g;
    ok[u] = w >= l0 && w < l1;
  }
  float sq[kSteps];
  float ip[kSteps];
#pragma unroll
  for (int u = 0; u < kSteps; ++u) {
    sq[u] = 0.0f;
    ip[u] = 0.0f;
  }
  for (int cb = 0; cb < n_blocks; ++cb) {
    uint4 piece[kSteps];
#pragma unroll
    for (int u = 0; u < kSteps; ++u) {
      piece[u] = ok[u] ? __ldg(reinterpret_cast<const uint4*>(
                             rows + kRowGroups * u * row_bytes + 128 * cb))
                       : make_uint4(0u, 0u, 0u, 0u);
    }
    float4 tt[kF];
    float4 aa[kF];
#pragma unroll
    for (int f = 0; f < kF; ++f) {
      const int i = swizzle<kF>(8 * kF * cb + kF * l + f);
      tt[f] = t4[i];
      aa[f] = a4[i];
    }
#pragma unroll
    for (int u = 0; u < kSteps; ++u) {
      float v[kV];
      Piece<T>::widen(piece[u], v);
#pragma unroll
      for (int e = 0; e < kV; ++e) {
        const float au = comp(aa[e / 4], e % 4) * v[e];
        sq[u] = fmaf(au, au, sq[u]);
        ip[u] = fmaf(comp(tt[e / 4], e % 4), v[e], ip[u]);
      }
    }
  }
  float part[kSteps];
#pragma unroll
  for (int u = 0; u < kSteps; ++u) part[u] = sq[u] - 2.0f * ip[u];
  // Transposed butterfly: after offset s the lane keeps the half of its
  // partial scores that its bit s selects, summed with its partner's.
#pragma unroll
  for (int s = kSteps / 2; s >= 1; s /= 2) {
    const bool upper = l & s;
#pragma unroll
    for (int i = 0; i < s; ++i) {
      const float send = upper ? part[i] : part[i + s];
      const float keep = upper ? part[i + s] : part[i];
      part[i] = keep + __shfl_xor_sync(0xffffffffu, send, s);
    }
  }
  const int w = w0 + kRowGroups * l + g;
  __stcs(o + w, w >= l0 && w < l1 ? part[0] : __int_as_float(0x7f800000));
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
ivf_list_scores_kernel(const float* __restrict__ t,
                       const float* __restrict__ a, const T* __restrict__ db,
                       const int32_t* __restrict__ starts,
                       const int32_t* __restrict__ lo,
                       const int32_t* __restrict__ hi,
                       float* __restrict__ out, int64_t n_probe, int run,
                       int64_t dim, int64_t win) {
  constexpr int kF = Piece<T>::kValues / 4;
  extern __shared__ __align__(16) float4 ta_s[];  // t, then a (swizzled)
  // The pass's windows, and each one's first tile in the pass's count.
  __shared__ int start_s[kThreads], lo_s[kThreads], hi_s[kThreads],
      tile_s[kThreads];
  __shared__ int warp_tiles[kWarps];

  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int n4 = static_cast<int>(dim / 4);
  float4* t4 = ta_s;
  float4* a4 = ta_s + n4;
  // This block's run of query blockIdx.x's slots: the n_run slots from
  // row0 in the (n_queries, n_probe) slot tables.
  const int64_t p0 = static_cast<int64_t>(blockIdx.y) * run;
  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * n_probe + p0;
  const int n_run = static_cast<int>(n_probe - p0 < run ? n_probe - p0
                                                         : run);
  const int win4 = static_cast<int>(win / 4);
  const float inf = __int_as_float(0x7f800000);
  const float4 inf4 = make_float4(inf, inf, inf, inf);

  const float4* tq = reinterpret_cast<const float4*>(
      t + static_cast<int64_t>(blockIdx.x) * dim);
  for (int i = tid; i < n4; i += kThreads) {
    t4[swizzle<kF>(i)] = tq[i];
    a4[swizzle<kF>(i)] = reinterpret_cast<const float4*>(a)[i];
  }

  for (int base = 0; base < n_run; base += kThreads) {
    const int n_pass = n_run - base < kThreads ? n_run - base : kThreads;
    int n_tiles = 0;
    if (tid < n_pass) {
      const int64_t slot = row0 + base + tid;
      const int l0 = lo[slot];
      const int l1 = hi[slot];
      lo_s[tid] = l0;
      hi_s[tid] = l1;
      start_s[tid] = starts[slot];
      if (l1 > l0) n_tiles = (l1 + kTile - 1) / kTile - l0 / kTile;
    }
    int total = 0;  // (the barrier inside also publishes t and a)
    tile_s[tid] = block_prefix<kThreads>(n_tiles, warp_tiles, &total);
    __syncthreads();  // the tile numbering

    // +inf wherever no tile writes: dead slots whole, and a live
    // window's float4 outside its tiles (8 float4 a tile).
    float4* pass_out =
        reinterpret_cast<float4*>(out + (row0 + base) * win);
    for (int f = tid; f < n_pass * win4; f += kThreads) {
      const int j = f / win4;
      const int tile = (f % win4) / (kTile / 4);
      const int l0 = lo_s[j];
      const int l1 = hi_s[j];
      const bool dead = l1 <= l0 || tile < l0 / kTile ||
                        tile >= (l1 + kTile - 1) / kTile;
      if (dead) __stcs(pass_out + f, inf4);
    }

    for (int i = warp; i < total; i += kWarps) {
      const int j = unit_slot<kThreads>(tile_s, n_pass, i);
      const int l0 = lo_s[j];
      score_tile<T>(db, start_s[j], l0 / kTile + (i - tile_s[j]), l0,
                    hi_s[j], dim, t4, a4, out + (row0 + base + j) * win,
                    lane);
    }
    __syncthreads();  // every thread is done with this pass's tables
  }
}

template <typename T>
int launch(const void* t, const void* a, const void* db, const void* starts,
           const void* lo, const void* hi, void* out, int64_t n_queries,
           int64_t n_probe, int64_t dim, int64_t win, int device,
           void* stream) {
  // This library carries its own CUDA runtime: select the tensors' device
  // in it before launching on the caller's stream.
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  const size_t smem = 2 * static_cast<size_t>(dim) * sizeof(float);
  if (smem > 48 * 1024 || dim % 128 || win % kTile ||
      n_queries >= (1LL << 31) || n_probe >= (1LL << 31)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n_queries <= 0 || n_probe <= 0) {
    return static_cast<int>(cudaGetLastError());
  }
  int64_t run = 0;
  int64_t runs = 0;
  const cudaError_t err =
      plan_slot_runs(ivf_list_scores_kernel<T>, kThreads, smem, device,
                     n_queries, n_probe, kMinRun, kWaves, &run, &runs);
  if (err != cudaSuccess) return static_cast<int>(err);
  ivf_list_scores_kernel<T><<<
      dim3(static_cast<unsigned>(n_queries), static_cast<unsigned>(runs)),
      kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(t), static_cast<const float*>(a),
      static_cast<const T*>(db), static_cast<const int32_t*>(starts),
      static_cast<const int32_t*>(lo), static_cast<const int32_t*>(hi),
      static_cast<float*>(out), n_probe, static_cast<int>(run), dim, win);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Shape contract (checked by the Python wrapper): dim % 128 == 0; db
// (N, dim) contiguous and 16-byte aligned; t (n_queries, dim) and a (dim,)
// f32, 16-byte aligned; starts, lo, hi (n_queries, n_probe) int32 with
// 0 <= start <= N - win and 0 <= lo <= hi <= win; out (n_queries, n_probe,
// win) f32, 16-byte aligned; win % 32 == 0; n_queries and n_probe < 2^31
// (the grid is n_queries x runs blocks).
#define SMQTK_IVF_ENTRY(NAME, T)                                            \
  extern "C" int NAME(const void* t, const void* a, const void* db,         \
                      const void* starts, const void* lo, const void* hi,   \
                      void* out, int64_t n_queries, int64_t n_probe,        \
                      int64_t dim, int64_t win, int device, void* stream) { \
    return launch<T>(t, a, db, starts, lo, hi, out, n_queries, n_probe,     \
                     dim, win, device, stream);                             \
  }

SMQTK_IVF_ENTRY(ivf_list_scores_f32, float)
SMQTK_IVF_ENTRY(ivf_list_scores_bf16, uint16_t)
SMQTK_IVF_ENTRY(ivf_list_scores_i8, int8_t)
