// K8: PQ asymmetric-distance (ADC) scores over windows of the tiled IVF
// code layout, written by hand for Hopper (sm_90a).
//
// Replaces the TPU kernel smqtk_indexing_tpu/ops/pallas_ivf.py
// ivf_list_scores_tiled_pq -> _ivf_tiled_pq_kernel (:707-836). The codes
// are uint8 PQ codes in (n_tiles, M, tile_n) tiles (row r at
// [r / tile_n, :, r % tile_n]), with per-row stats s2 in (n_tiles, 1,
// tile_n) f32 (+inf on dead or removed rows), and each query has an
// (M, 256) f32 lookup table lut[m, v] = <q_m, codebook[m, v]>. For every
// (query b, probe slot p) it scores the W = 640 columns c0 + w of tile ti:
//
//     out[b, p, w] = s2[ti, 0, c0 + w] - 2 sum_m lut[b, m, code(m, c0 + w)]
//                    if lo <= w < hi, +inf otherwise
//
// What the TPU needed and the card does not: a TPU has no table gather, so
// the Pallas kernel expands the codes into a one-hot (M * 256, W) block and
// multiplies it with a split-bf16 LUT on the matrix unit, which leaves
// ~2^-16 of the LUT's magnitude. A GPU thread gathers from shared memory.
//
// What bounds it on an H100: a live window reads M x 640 bytes of codes
// (10 KB at M = 16) and 2.5 KB of stats for M table lookups and adds a
// column, so it is bound by memory and by the shared-memory lookups, not
// by arithmetic. The design:
//
// - One block of 160 threads per (query, group of kSlots probe slots);
//   thread j owns the four columns 4 j .. 4 j + 3 of each window. The
//   query's table is staged in shared memory once and serves every slot
//   of the group. A table larger than kLutChunk subspaces (48 KB) is
//   staged in chunks of subspaces, so every M the codec accepts runs.
// - For each subspace the block reads 640 contiguous code bytes of a
//   window, one uchar4 a thread (c0 is a multiple of 128, so every uchar4
//   is aligned). Codes are unsigned bytes: a code >= 128 indexes
//   codewords 128..255.
// - Each column sums its M table entries in f32 in m order, so the kernel
//   agrees with float64 to rounding. A +inf stat stays +inf.
// - A slot with lo == hi (dead slots, budget padding) writes +inf and
//   reads nothing; a group with no live slot stages no table.
// - Global offsets are 64-bit.
//
// The kernel allocates nothing and launches on the caller's stream. The C
// entry point returns cudaGetLastError() after the launch.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kWindow = 640;
constexpr int kThreads = kWindow / 4;
constexpr int kSlots = 8;        // probe slots a block scores
constexpr int kLutChunk = 48;    // subspaces of table staged at once
constexpr int kCodes = 256;      // codewords a subspace

__global__ void __launch_bounds__(kThreads)
ivf_list_scores_tiled_pq_kernel(const float* __restrict__ lut,
                                const uint8_t* __restrict__ db3,
                                const float* __restrict__ s2t,
                                const int32_t* __restrict__ ti,
                                const int32_t* __restrict__ c0,
                                const int32_t* __restrict__ lo,
                                const int32_t* __restrict__ hi,
                                float* __restrict__ out, int64_t n_probe,
                                int64_t m_sub, int64_t tile_n) {
  extern __shared__ __align__(16) float lut_s[];

  const int64_t groups = (n_probe + kSlots - 1) / kSlots;
  const int64_t qi = blockIdx.x / groups;
  const int64_t p0 = (blockIdx.x % groups) * kSlots;
  const int col = 4 * threadIdx.x;
  const float inf = __int_as_float(0x7f800000);

  // Window bookkeeping of the group's slots (the same in every thread).
  int l0[kSlots], l1[kSlots];
  int64_t codes_at[kSlots], s2_at[kSlots];
  bool any_live = false;
#pragma unroll
  for (int s = 0; s < kSlots; ++s) {
    const int64_t p = p0 + s;
    l0[s] = l1[s] = 0;
    codes_at[s] = s2_at[s] = 0;
    if (p < n_probe) {
      const int64_t slot = qi * n_probe + p;
      l0[s] = lo[slot];
      l1[s] = hi[slot];
      const int64_t tile = ti[slot];
      codes_at[s] = tile * m_sub * tile_n + c0[slot] + col;
      s2_at[s] = tile * tile_n + c0[slot] + col;
    }
    any_live = any_live || (l1[s] > l0[s]);
  }

  float acc[kSlots][4];
#pragma unroll
  for (int s = 0; s < kSlots; ++s) {
    acc[s][0] = acc[s][1] = acc[s][2] = acc[s][3] = 0.0f;
  }

  if (any_live) {
    const float* lut_q = lut + qi * m_sub * kCodes;
    for (int64_t mc = 0; mc < m_sub; mc += kLutChunk) {
      const int n_m = static_cast<int>(
          m_sub - mc < kLutChunk ? m_sub - mc : kLutChunk);
      __syncthreads();  // the previous chunk's lookups are done
      const float4* src =
          reinterpret_cast<const float4*>(lut_q + mc * kCodes);
      float4* dst = reinterpret_cast<float4*>(lut_s);
      for (int i = threadIdx.x; i < n_m * (kCodes / 4); i += kThreads) {
        dst[i] = __ldg(src + i);
      }
      __syncthreads();
#pragma unroll
      for (int s = 0; s < kSlots; ++s) {
        if (l1[s] <= l0[s]) continue;
        const uint8_t* codes = db3 + codes_at[s] + mc * tile_n;
#pragma unroll 4
        for (int m = 0; m < n_m; ++m) {
          const uchar4 u =
              __ldg(reinterpret_cast<const uchar4*>(codes + m * tile_n));
          const float* row = lut_s + m * kCodes;
          acc[s][0] += row[u.x];
          acc[s][1] += row[u.y];
          acc[s][2] += row[u.z];
          acc[s][3] += row[u.w];
        }
      }
    }
  }

#pragma unroll
  for (int s = 0; s < kSlots; ++s) {
    const int64_t p = p0 + s;
    if (p >= n_probe) break;
    float r[4] = {inf, inf, inf, inf};
    if (l1[s] > l0[s]) {
      const float4 s2 =
          __ldg(reinterpret_cast<const float4*>(s2t + s2_at[s]));
      const float sv[4] = {s2.x, s2.y, s2.z, s2.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int w = col + i;
        if (w >= l0[s] && w < l1[s]) r[i] = sv[i] - 2.0f * acc[s][i];
      }
    }
    *reinterpret_cast<float4*>(out + (qi * n_probe + p) * kWindow + col) =
        make_float4(r[0], r[1], r[2], r[3]);
  }
}

}  // namespace

// Shape contract (checked by the Python wrapper): db3 (n_tiles, m_sub,
// tile_n) uint8 and s2t (n_tiles, 1, tile_n) f32, contiguous and 16-byte
// aligned, tile_n % 128 == 0; lut (n_queries, m_sub * 256) f32 contiguous
// and 16-byte aligned; ti, c0, lo, hi (n_queries, n_probe) int32 with
// c0 % 128 == 0, c0 + win <= tile_n and 0 <= lo <= hi <= win; out
// (n_queries, n_probe, win) f32; win == 640;
// n_queries * ceil(n_probe / 8) < 2^31.
extern "C" int ivf_list_scores_tiled_pq(
    const void* lut, const void* db3, const void* s2t, const void* ti,
    const void* c0, const void* lo, const void* hi, void* out,
    int64_t n_queries, int64_t n_probe, int64_t m_sub, int64_t tile_n,
    int64_t win, int device, void* stream) {
  // This library carries its own CUDA runtime: select the tensors' device
  // in it before launching on the caller's stream.
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  if (win != kWindow || m_sub < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t chunk = m_sub < kLutChunk ? m_sub : kLutChunk;
  const size_t smem = static_cast<size_t>(chunk) * kCodes * sizeof(float);
  const int64_t n_blocks = n_queries * ((n_probe + kSlots - 1) / kSlots);
  if (n_blocks > 0) {
    ivf_list_scores_tiled_pq_kernel<<<dim3(static_cast<unsigned>(n_blocks)),
                                      kThreads, smem,
                                      static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(lut), static_cast<const uint8_t*>(db3),
        static_cast<const float*>(s2t), static_cast<const int32_t*>(ti),
        static_cast<const int32_t*>(c0), static_cast<const int32_t*>(lo),
        static_cast<const int32_t*>(hi), static_cast<float*>(out), n_probe,
        m_sub, tile_n);
  }
  return static_cast<int>(cudaGetLastError());
}
