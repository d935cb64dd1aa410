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
// What bounds it on an H100: a live window reads d x 640 bytes of codes
// (80 KB at d = 128) for 2 flops a byte, so device-memory bandwidth bounds
// it (the serving line reads about 1 GB per 1024-query batch). The design
// reads each window once, coalesced, in full f32:
//
// - One block of 160 threads per (query, probe slot); thread j owns the
//   four columns 4 j .. 4 j + 3 of the window. A slot whose window is
//   empty (lo == hi: dead slots, padding, tile ti = c0 = 0) writes +inf
//   and reads nothing.
// - For each of the d code rows the block reads 640 contiguous bytes, one
//   char4 a thread (c0 is a multiple of 128, so every char4 is aligned).
// - The query fold sits in shared memory (d floats) and is read as a
//   broadcast.
// - Each column accumulates sum_k t_k u_k in f32 FFMA. int8 codes are
//   exact in f32, so this is the TPU's split-bf16 product without its
//   ~2^-16 residual. A +inf stat stays +inf, so a removed row never wins.
// - Global offsets are 64-bit.
//
// The kernel allocates nothing and launches on the caller's stream. The C
// entry point returns cudaGetLastError() after the launch.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kWindow = 640;
constexpr int kThreads = kWindow / 4;

__global__ void __launch_bounds__(kThreads)
ivf_list_scores_tiled_kernel(const float* __restrict__ t,
                             const int8_t* __restrict__ db3,
                             const float* __restrict__ s2t,
                             const int32_t* __restrict__ ti,
                             const int32_t* __restrict__ c0,
                             const int32_t* __restrict__ lo,
                             const int32_t* __restrict__ hi,
                             float* __restrict__ out, int64_t n_probe,
                             int64_t dim, int64_t tile_n) {
  extern __shared__ __align__(16) float t_s[];

  const int64_t slot = blockIdx.x;  // query * n_probe + probe slot
  const int64_t qi = slot / n_probe;
  const int l0 = lo[slot];
  const int l1 = hi[slot];
  const int col = 4 * threadIdx.x;
  float4* o = reinterpret_cast<float4*>(out + slot * kWindow + col);
  const float inf = __int_as_float(0x7f800000);
  if (l1 <= l0) {  // the same for every thread of the block
    *o = make_float4(inf, inf, inf, inf);
    return;
  }

  for (int i = threadIdx.x; i < dim; i += kThreads) t_s[i] = t[qi * dim + i];
  __syncthreads();

  const int64_t tile = ti[slot];
  const int64_t c = c0[slot];
  const int8_t* src = db3 + tile * dim * tile_n + c + col;
  float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll 8
  for (int64_t k = 0; k < dim; ++k) {
    const char4 u = __ldg(reinterpret_cast<const char4*>(src + k * tile_n));
    const float tk = t_s[k];
    acc[0] = fmaf(tk, static_cast<float>(u.x), acc[0]);
    acc[1] = fmaf(tk, static_cast<float>(u.y), acc[1]);
    acc[2] = fmaf(tk, static_cast<float>(u.z), acc[2]);
    acc[3] = fmaf(tk, static_cast<float>(u.w), acc[3]);
  }
  const float4 s2 =
      __ldg(reinterpret_cast<const float4*>(s2t + tile * tile_n + c + col));
  const float sv[4] = {s2.x, s2.y, s2.z, s2.w};
  float r[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int w = col + i;
    r[i] = (w >= l0 && w < l1) ? sv[i] - 2.0f * acc[i] : inf;
  }
  *o = make_float4(r[0], r[1], r[2], r[3]);
}

}  // namespace

// Shape contract (checked by the Python wrapper): db3 (n_tiles, dim,
// tile_n) int8 and s2t (n_tiles, 1, tile_n) f32, contiguous and 16-byte
// aligned, tile_n % 128 == 0; t (n_queries, dim) f32; ti, c0, lo, hi
// (n_queries, n_probe) int32 with c0 % 128 == 0, c0 + win <= tile_n and
// 0 <= lo <= hi <= win; out (n_queries, n_probe, win) f32; win == 640;
// n_queries * n_probe < 2^31.
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
  if (win != kWindow || smem > 48 * 1024) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t n_blocks = n_queries * n_probe;
  if (n_blocks > 0) {
    ivf_list_scores_tiled_kernel<<<dim3(static_cast<unsigned>(n_blocks)),
                                   kThreads, smem,
                                   static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(t), static_cast<const int8_t*>(db3),
        static_cast<const float*>(s2t), static_cast<const int32_t*>(ti),
        static_cast<const int32_t*>(c0), static_cast<const int32_t*>(lo),
        static_cast<const int32_t*>(hi), static_cast<float*>(out), n_probe,
        dim, tile_n);
  }
  return static_cast<int>(cudaGetLastError());
}
