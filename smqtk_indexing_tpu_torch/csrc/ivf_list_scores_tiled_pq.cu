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
// What bounds it on an H100: bytes. A live window reads M x 640 bytes of
// codes (10 KB at M = 16) and 2.5 KB of stats, a query's table is M KB,
// and every slot, live or dead, writes 2.5 KB of scores: at the serving
// shape (B = 1024, P = 64 slots, M = 16) the output alone is 168 MB, most
// of it +inf for the slots past a query's probed windows. The M lookups a
// column go to random shared-memory banks, so they cost issue slots too.
// The design:
//
// - A block of kThreads = 160 threads walks a run of one query's slots,
//   kGroups = 2 windows at a time: thread j of a group owns the kCols = 8
//   columns 8 j .. 8 j + 7 of its window. A group takes every other slot
//   of the run: a probed list's sublist windows sit side by side in the
//   slot table, live and dead ones mixed, so both groups get about half
//   of the live ones. The run is all of the query's slots when the
//   queries alone fill the card (the serving batch); with fewer queries
//   than resident blocks (a small batch, or thousands of slots a query
//   under nprobe = n_lists) each query's slots are cut into runs of at
//   least kMinRun, so that the grid still fills every SM once
//   (csrc/slot_runs.cuh, the plan K6 and K7 share). A dead
//   slot's +inf goes out at once, so the dead slots' stores overlap the
//   live windows' loads and lookups.
//   (These stores alone run at half a fill's rate for the same bytes; the
//   whole grid writing the dead slots in output order runs at a fill's
//   rate, but before, after or between the scoring it took longer in all,
//   since the scoring then no longer hides the stores: PERF.md, section 6.)
// - The query's table (kLutChunk = 64 subspaces at most, 64 KB) is staged
//   into shared memory once a block, by one bulk async copy
//   (cp.async.bulk) that completes on an mbarrier. The copy is issued
//   before anything else and runs under the first window's code loads and
//   the first dead slots' stores; a thread waits on the barrier just
//   before its first lookup. A block with no live slot stages nothing. A
//   larger table is staged a chunk of subspaces at a time: each chunk
//   walks the live slots again, carrying each column's running sum
//   through its output slot, so every M the codec accepts runs and every
//   sum keeps subspace order.
// - Codes: 8 bytes a thread a subspace (one uint2; c0 is a multiple of
//   128, so every load is aligned), loaded kBatch = 2 subspaces at a time,
//   with the next 2 in flight while this 2's lookups run. At 48 registers
//   a thread, 8 blocks share an SM, so the serving batch (B = 1024) runs in
//   one wave on 132 SMs, a block a query (four subspaces ahead took 53
//   and spilled).
// - Each column sums its M table entries in f32 in subspace order, from
//   0.0f, so the kernel agrees with float64 to rounding. A +inf stat stays
//   +inf. Codes are unsigned bytes: a code >= 128 indexes codewords
//   128..255.
// - Scores and +inf are written as 16-byte streaming stores (__stcs): the
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
constexpr int kCols = 8;                         // columns a thread
constexpr int kWinThreads = kWindow / kCols;     // threads a window: 80
constexpr int kGroups = 2;                       // windows scored at once
constexpr int kThreads = kGroups * kWinThreads;  // 160
constexpr int kBatch = 2;                        // subspaces a code batch
constexpr int kLutChunk = 64;   // subspaces of table staged at once (64 KB)
constexpr int kCodes = 256;     // codewords a subspace
constexpr int kMinRun = 8;      // fewest slots a block, when queries are few

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
// destination (the previous chunk's lookups, after a block barrier) before
// the async write.
__device__ __forceinline__ void stage_table(uint32_t dst, const float* src,
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

// A 16-byte streaming store: the output is read once, by the top-k, and
// need not stay in L2.
__device__ __forceinline__ void store4(float* p, float4 v) {
  __stcs(reinterpret_cast<float4*>(p), v);
}

// The table entry of one code byte.
__device__ __forceinline__ float lookup(const float* row, uint32_t code) {
  return row[code];
}

__global__ void __launch_bounds__(kThreads, 8)
ivf_list_scores_tiled_pq_kernel(const float* __restrict__ lut,
                                const uint8_t* __restrict__ db3,
                                const float* __restrict__ s2t,
                                const int32_t* __restrict__ ti,
                                const int32_t* __restrict__ c0,
                                const int32_t* __restrict__ lo,
                                const int32_t* __restrict__ hi,
                                float* __restrict__ out, int64_t n_probe,
                                int run, int64_t m_sub, int64_t tile_n) {
  extern __shared__ __align__(128) float lut_s[];
  __shared__ __align__(8) uint64_t bar_s;

  const int tid = threadIdx.x;
  const int grp = tid / kWinThreads;
  const int col = kCols * (tid % kWinThreads);
  // This block's run of query blockIdx.x's slots: the n_run slots from
  // row0 in the (n_queries, n_probe) slot tables.
  const int64_t p0 = static_cast<int64_t>(blockIdx.y) * run;
  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * n_probe + p0;
  const int n_run = static_cast<int>(n_probe - p0 < run ? n_probe - p0
                                                         : run);
  const float* lut_q = lut + static_cast<int64_t>(blockIdx.x) * m_sub *
                                 kCodes;
  const uint32_t bar = smem_u32(&bar_s);
  const uint32_t lut_a = smem_u32(lut_s);
  const int n_chunks = static_cast<int>((m_sub + kLutChunk - 1) / kLutChunk);
  const float inf = __int_as_float(0x7f800000);
  const float4 inf4 = make_float4(inf, inf, inf, inf);

  auto chunk_subspaces = [&](int c) {
    const int64_t left = m_sub - static_cast<int64_t>(c) * kLutChunk;
    return static_cast<int>(left < kLutChunk ? left : kLutChunk);
  };
  auto stage = [&](int c) {
    stage_table(lut_a, lut_q + static_cast<int64_t>(c) * kLutChunk * kCodes,
                static_cast<uint32_t>(chunk_subspaces(c)) * kCodes * 4u,
                bar);
  };

  int any = 0;
  for (int p = tid; p < n_run; p += kThreads) {
    any |= hi[row0 + p] > lo[row0 + p];
  }
  if (tid == 0) mbar_init(bar);
  any = __syncthreads_or(any);  // also publishes the barrier's init
  if (any && tid == 0) stage(0);

  for (int c = 0; c < n_chunks; ++c) {
    const int64_t m0 = static_cast<int64_t>(c) * kLutChunk;
    const int n_m = chunk_subspaces(c);
    const bool last = c == n_chunks - 1;
    bool staged = false;  // this thread has seen chunk c land
    for (int p = grp; p < n_run; p += kGroups) {
      const int64_t slot = row0 + p;
      const int l0 = lo[slot];
      const int l1 = hi[slot];
      float* dst = out + slot * kWindow + col;
      if (l1 <= l0) {
        if (c == 0) {
          store4(dst, inf4);
          store4(dst + 4, inf4);
        }
        continue;
      }
      const int64_t tile = ti[slot];
      const int64_t cs = c0[slot] + col;
      const uint8_t* codes = db3 + (tile * m_sub + m0) * tile_n + cs;
      uint2 cur[kBatch];
#pragma unroll
      for (int k = 0; k < kBatch; ++k) {
        cur[k] = k < n_m ? __ldg(reinterpret_cast<const uint2*>(
                               codes + k * tile_n))
                         : make_uint2(0u, 0u);
      }
      float acc[kCols];
      if (c == 0) {
#pragma unroll
        for (int i = 0; i < kCols; ++i) acc[i] = 0.0f;
      } else {  // the running sums of the chunks before
        const float4 a = *reinterpret_cast<const float4*>(dst);
        const float4 b = *reinterpret_cast<const float4*>(dst + 4);
        acc[0] = a.x; acc[1] = a.y; acc[2] = a.z; acc[3] = a.w;
        acc[4] = b.x; acc[5] = b.y; acc[6] = b.z; acc[7] = b.w;
      }
      if (!staged) {
        mbar_wait(bar, c & 1);
        staged = true;
      }
      for (int mb = 0; mb < n_m; mb += kBatch) {
        uint2 nxt[kBatch];
#pragma unroll
        for (int k = 0; k < kBatch; ++k) {
          const int m = mb + kBatch + k;
          nxt[k] = m < n_m ? __ldg(reinterpret_cast<const uint2*>(
                                 codes + m * tile_n))
                           : make_uint2(0u, 0u);
        }
#pragma unroll
        for (int k = 0; k < kBatch; ++k) {
          if (mb + k < n_m) {
            const float* row = lut_s + (mb + k) * kCodes;
            const uint32_t w0 = cur[k].x;
            const uint32_t w1 = cur[k].y;
            acc[0] += lookup(row, w0 & 0xffu);
            acc[1] += lookup(row, (w0 >> 8) & 0xffu);
            acc[2] += lookup(row, (w0 >> 16) & 0xffu);
            acc[3] += lookup(row, w0 >> 24);
            acc[4] += lookup(row, w1 & 0xffu);
            acc[5] += lookup(row, (w1 >> 8) & 0xffu);
            acc[6] += lookup(row, (w1 >> 16) & 0xffu);
            acc[7] += lookup(row, w1 >> 24);
          }
          cur[k] = nxt[k];
        }
      }
      if (!last) {
        *reinterpret_cast<float4*>(dst) =
            make_float4(acc[0], acc[1], acc[2], acc[3]);
        *reinterpret_cast<float4*>(dst + 4) =
            make_float4(acc[4], acc[5], acc[6], acc[7]);
        continue;
      }
      const float* s2 = s2t + tile * tile_n + cs;
      const float4 sa = __ldg(reinterpret_cast<const float4*>(s2));
      const float4 sb = __ldg(reinterpret_cast<const float4*>(s2 + 4));
      const float sv[kCols] = {sa.x, sa.y, sa.z, sa.w,
                               sb.x, sb.y, sb.z, sb.w};
      float r[kCols];
#pragma unroll
      for (int i = 0; i < kCols; ++i) {
        const int w = col + i;
        r[i] = w >= l0 && w < l1 ? sv[i] - 2.0f * acc[i] : inf;
      }
      store4(dst, make_float4(r[0], r[1], r[2], r[3]));
      store4(dst + 4, make_float4(r[4], r[5], r[6], r[7]));
    }
    if (!last && any) {
      // Every lookup of chunk c is done, and chunk c has landed, before
      // the next chunk overwrites the table.
      __syncthreads();
      if (tid == 0) {
        mbar_wait(bar, c & 1);
        stage(c + 1);
      }
    }
  }

  // No block ends with its table copy in flight.
  if (any && tid == 0) mbar_wait(bar, (n_chunks - 1) & 1);
}

}  // namespace

// Shape contract (checked by the Python wrapper): db3 (n_tiles, m_sub,
// tile_n) uint8 and s2t (n_tiles, 1, tile_n) f32, contiguous and 16-byte
// aligned, tile_n % 128 == 0; lut (n_queries, m_sub * 256) f32 contiguous
// and 16-byte aligned; ti, c0, lo, hi (n_queries, n_probe) int32 with
// c0 % 128 == 0, c0 + win <= tile_n and 0 <= lo <= hi <= win; out
// (n_queries, n_probe, win) f32, 16-byte aligned; win == 640;
// n_queries and n_probe < 2^31 (the grid is n_queries x runs blocks).
extern "C" int ivf_list_scores_tiled_pq(
    const void* lut, const void* db3, const void* s2t, const void* ti,
    const void* c0, const void* lo, const void* hi, void* out,
    int64_t n_queries, int64_t n_probe, int64_t m_sub, int64_t tile_n,
    int64_t win, int device, void* stream) {
  // This library carries its own CUDA runtime: select the tensors' device
  // in it before launching on the caller's stream.
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  if (win != kWindow || m_sub < 1 || tile_n % 128 ||
      n_queries >= (1LL << 31) || n_probe >= (1LL << 31)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t chunk = m_sub < kLutChunk ? m_sub : kLutChunk;
  const int smem = static_cast<int>(chunk * kCodes * sizeof(float));
  const cudaError_t attr = cudaFuncSetAttribute(
      ivf_list_scores_tiled_pq_kernel,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  if (n_queries <= 0 || n_probe <= 0) {
    return static_cast<int>(cudaGetLastError());
  }
  // Runs a query: as many as fill the card's resident blocks once, each of
  // at least kMinRun slots; one (all its slots) when the queries fill it.
  int64_t run = 0;
  int64_t runs = 0;
  const cudaError_t err = plan_slot_runs(
      ivf_list_scores_tiled_pq_kernel, kThreads, static_cast<size_t>(smem),
      device, n_queries, n_probe, kMinRun, 1, &run, &runs);
  if (err != cudaSuccess) return static_cast<int>(err);
  ivf_list_scores_tiled_pq_kernel<<<
      dim3(static_cast<unsigned>(n_queries), static_cast<unsigned>(runs)),
      kThreads, static_cast<size_t>(smem),
      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(lut), static_cast<const uint8_t*>(db3),
      static_cast<const float*>(s2t), static_cast<const int32_t*>(ti),
      static_cast<const int32_t*>(c0), static_cast<const int32_t*>(lo),
      static_cast<const int32_t*>(hi), static_cast<float*>(out), n_probe,
      static_cast<int>(run), m_sub, tile_n);
  return static_cast<int>(cudaGetLastError());
}
