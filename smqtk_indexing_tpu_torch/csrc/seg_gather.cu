// K3: gather of (d, 128) column slices of the tiled-transposed layout by
// global segment id, written by hand for Hopper (sm_90a).
//
// Replaces the TPU kernel smqtk_indexing_tpu/ops/pallas_scan.py
// _seg_gather_tiled -> _seg_gather_kernel / _seg_gather_kernel_pf
// (:319-454; the two are a TPU DMA-scheduling A/B, and one kernel covers
// both). SMQTK_TPU_NO_GATHER_PREFETCH, which picks between those two TPU
// schedules (:393-401), has no counterpart here: this kernel has one
// schedule. For every entry m of the flattened (B, s_keep) id array, with
// segment s = sid[m], tile ti = s / (tile_n / 128) and column
// c0 = (s % (tile_n / 128)) * 128:
//
//     out[m, k, j] = db3[ti, k, c0 + j],   k < d, j < 128
//
// for an element of 1, 2 or 4 bytes (int8 codes, bf16, f32). It is a copy:
// the output equals the plain version bit for bit.
//
// What bounds it on an H100: it moves bytes and computes nothing, so
// device-memory bandwidth bounds it. Each segment is d rows of 128
// contiguous elements (128, 256 or 512 bytes, each a whole number of
// 16-byte words, since c0 and tile_n are multiples of 128). One block of
// 256 threads copies one segment as 16-byte words, neighbouring threads
// on neighbouring words, so both the reads and the writes coalesce.
// Offsets are 64-bit. The kernel allocates nothing and launches on the
// caller's stream. The C entry point returns cudaGetLastError() after the
// launch.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kSeg = 128;

__global__ void __launch_bounds__(kThreads)
seg_gather_kernel(const uint8_t* __restrict__ db3,
                  const int64_t* __restrict__ sid, uint8_t* __restrict__ out,
                  int64_t dim, int64_t tile_n, int64_t esize) {
  const int64_t m = blockIdx.x;
  const int64_t s = sid[m];
  const int64_t nseg_t = tile_n / kSeg;
  const int64_t ti = s / nseg_t;
  const int64_t c0 = (s % nseg_t) * kSeg;
  const int64_t words_per_row = kSeg * esize / 16;  // 8, 16 or 32
  const int64_t row_stride = tile_n * esize;        // bytes between rows
  const uint8_t* src = db3 + (ti * dim * tile_n + c0) * esize;
  uint4* dst = reinterpret_cast<uint4*>(out + m * dim * kSeg * esize);
  const int64_t total = dim * words_per_row;
  for (int64_t i = threadIdx.x; i < total; i += kThreads) {
    const int64_t r = i / words_per_row;
    const int64_t w = i % words_per_row;
    dst[i] = __ldg(reinterpret_cast<const uint4*>(src + r * row_stride) + w);
  }
}

}  // namespace

// Shape contract (checked by the Python wrapper): db3 (n_tiles, dim,
// tile_n) contiguous and 16-byte aligned, tile_n % 128 == 0, esize in
// {1, 2, 4}; sid (n_seg,) int64 with 0 <= sid < n_tiles * tile_n / 128;
// out (n_seg, dim, 128) of db3's element type; n_seg < 2^31.
extern "C" int seg_gather_tiled(const void* db3, const void* sid, void* out,
                                int64_t n_seg, int64_t dim, int64_t tile_n,
                                int64_t esize, int device, void* stream) {
  // This library carries its own CUDA runtime: select the tensors' device
  // in it before launching on the caller's stream.
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  if ((esize != 1 && esize != 2 && esize != 4) || n_seg >= (1LL << 31)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n_seg > 0) {
    seg_gather_kernel<<<dim3(static_cast<unsigned>(n_seg)), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(db3), static_cast<const int64_t*>(sid),
        static_cast<uint8_t*>(out), dim, tile_n, esize);
  }
  return static_cast<int>(cudaGetLastError());
}
