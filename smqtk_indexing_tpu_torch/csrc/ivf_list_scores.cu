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
// What bounds it on an H100: each live window reads up to L - 32 rows of
// d values (480 x 128 x 4 B = 240 KB in f32) for 4 flops a value, far
// below the card's 295 flops a byte, so device-memory bandwidth bounds
// it. The design reads every row once, coalesced, and keeps no
// intermediate in device memory:
//
// - One block of 256 threads (8 warps) per (query, probe). A block whose
//   window is empty (lo == hi: a budget slot past the eligible lists)
//   writes +inf and reads nothing.
// - A warp scores one row at a time: lane j reads 4 consecutive values at
//   4 j + 128 c, so a warp reads 128 contiguous values per step (512 B of
//   f32, 256 B of bf16, 128 B of int8), and the two sums are reduced
//   across the warp with shuffles.
// - The query and the row scale sit in shared memory (2 d floats).
// - Full f32 FFMA, no tensor cores. bf16 and int8 are exact in f32.
// - Global offsets are 64-bit.
//
// The kernel allocates nothing and launches on the caller's stream. The C
// entry points return cudaGetLastError() after the launch.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ void load4(const float* __restrict__ p,
                                      float v[4]) {
  const float4 x = __ldg(reinterpret_cast<const float4*>(p));
  v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
}

// Four bf16 values (raw 16-bit patterns, little-endian) widened to f32.
__device__ __forceinline__ void load4(const uint16_t* __restrict__ p,
                                      float v[4]) {
  const uint2 w = __ldg(reinterpret_cast<const uint2*>(p));
  v[0] = __uint_as_float(w.x << 16);
  v[1] = __uint_as_float(w.x & 0xffff0000u);
  v[2] = __uint_as_float(w.y << 16);
  v[3] = __uint_as_float(w.y & 0xffff0000u);
}

__device__ __forceinline__ void load4(const int8_t* __restrict__ p,
                                      float v[4]) {
  const char4 c = __ldg(reinterpret_cast<const char4*>(p));
  v[0] = c.x; v[1] = c.y; v[2] = c.z; v[3] = c.w;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
ivf_list_scores_kernel(const float* __restrict__ t,
                       const float* __restrict__ a, const T* __restrict__ db,
                       const int32_t* __restrict__ starts,
                       const int32_t* __restrict__ lo,
                       const int32_t* __restrict__ hi,
                       float* __restrict__ out, int64_t n_probe, int64_t dim,
                       int64_t win) {
  extern __shared__ __align__(16) float smem[];
  float* t_s = smem;
  float* a_s = smem + dim;

  const int64_t slot = blockIdx.x;  // query * n_probe + probe
  const int64_t qi = slot / n_probe;
  const int l0 = lo[slot];
  const int l1 = hi[slot];
  float* o = out + slot * win;
  for (int l = threadIdx.x; l < win; l += kThreads) {
    if (l < l0 || l >= l1) o[l] = __int_as_float(0x7f800000);  // +inf
  }
  if (l1 <= l0) return;  // the same for every thread of the block

  for (int i = threadIdx.x; i < dim; i += kThreads) {
    t_s[i] = t[qi * dim + i];
    a_s[i] = a[i];
  }
  __syncthreads();

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int64_t start = starts[slot];
  for (int l = l0 + warp; l < l1; l += kWarps) {
    const T* row = db + (start + l) * dim;
    float sq = 0.0f;
    float ip = 0.0f;
    for (int64_t k0 = 4 * lane; k0 < dim; k0 += 128) {
      float v[4];
      load4(row + k0, v);
      const float4 tv = *reinterpret_cast<const float4*>(t_s + k0);
      const float4 av = *reinterpret_cast<const float4*>(a_s + k0);
      const float tt[4] = {tv.x, tv.y, tv.z, tv.w};
      const float aa[4] = {av.x, av.y, av.z, av.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float au = aa[i] * v[i];
        sq = fmaf(au, au, sq);
        ip = fmaf(tt[i], v[i], ip);
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      sq += __shfl_xor_sync(0xffffffffu, sq, off);
      ip += __shfl_xor_sync(0xffffffffu, ip, off);
    }
    if (lane == 0) o[l] = sq - 2.0f * ip;
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
  if (smem > 48 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t n_blocks = n_queries * n_probe;
  if (n_blocks > 0) {
    ivf_list_scores_kernel<T><<<dim3(static_cast<unsigned>(n_blocks)),
                                kThreads, smem,
                                static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(t), static_cast<const float*>(a),
        static_cast<const T*>(db), static_cast<const int32_t*>(starts),
        static_cast<const int32_t*>(lo), static_cast<const int32_t*>(hi),
        static_cast<float*>(out), n_probe, dim, win);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Shape contract (checked by the Python wrapper): dim % 128 == 0; db
// (N, dim) contiguous and 16-byte aligned; t (n_queries, dim) and a (dim,)
// f32; starts, lo, hi (n_queries, n_probe) int32 with
// 0 <= start <= N - win and 0 <= lo <= hi <= win; out (n_queries, n_probe,
// win) f32; n_queries * n_probe < 2^31.
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
