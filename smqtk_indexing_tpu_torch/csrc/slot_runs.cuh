// The grid of the IVF list-scan kernels (K6, K7, K8): n_queries x runs
// blocks, each walking a run of one query's probe slots, so that the
// query's data (its fold, row scale or table) is staged once a block.
//
// The run is all of the query's slots when the queries alone fill
// `waves` times the card's resident blocks (the serving batch). With fewer
// queries (a small batch, or thousands of slots a query under nprobe =
// n_lists) each query's slots are cut into runs of at least min_run, so
// that the grid still fills every SM `waves` times: one block a query
// starved small batches (K8's exhaustive probe took 0.22 s against 0.03).
// K8 stages a 16 KB table a block and takes one wave; K6 and K7 stage a
// query's d floats and take more, so that a block whose run holds more
// live windows than the others does not set the kernel's time.

#pragma once

#include <cuda_runtime.h>

#include <cstdint>

// Sets *run (slots a block) and *runs (blocks a query, at most 65535, the
// grid's y limit) for `kernel` launched with `threads` threads and `smem`
// bytes of dynamic shared memory on `device`. n_queries, n_probe > 0.
template <typename Kernel>
cudaError_t plan_slot_runs(Kernel kernel, int threads, size_t smem,
                           int device, int64_t n_queries, int64_t n_probe,
                           int64_t min_run, int64_t waves, int64_t* run,
                           int64_t* runs) {
  int n_sm = 0;
  int per_sm = 0;
  cudaError_t err =
      cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      threads, smem);
  if (err != cudaSuccess) return err;
  const int64_t resident =
      static_cast<int64_t>(n_sm) * (per_sm > 0 ? per_sm : 1);
  int64_t r = waves * resident / n_queries;
  const int64_t most = (n_probe + min_run - 1) / min_run;
  if (r > most) r = most;
  if (r > 65535) r = 65535;
  if (r < 1) r = 1;
  *run = (n_probe + r - 1) / r;
  *runs = (n_probe + *run - 1) / *run;  // no empty run
  return cudaSuccess;
}

// A pass of K6 or K7 numbers the work units (tiles, chunks) of up to
// kThreads of its slots, thread j holding slot j's count, and its threads
// or warps then take the units in turn.

// The exclusive prefix of `count` over the block's kThreads threads, in
// thread order, and *total their sum. warp_sums is kThreads / 32 ints of
// shared memory; the block barrier inside publishes them.
template <int kThreads>
__device__ __forceinline__ int block_prefix(int count, int* warp_sums,
                                            int* total) {
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  int x = count;  // inclusive scan over the warp
#pragma unroll
  for (int off = 1; off < 32; off *= 2) {
    const int y = __shfl_up_sync(0xffffffffu, x, off);
    if (lane >= off) x += y;
  }
  if (lane == 31) warp_sums[warp] = x;
  __syncthreads();
  int before = 0;
  int sum = 0;
#pragma unroll
  for (int w = 0; w < kThreads / 32; ++w) {
    before += w < warp ? warp_sums[w] : 0;
    sum += warp_sums[w];
  }
  *total = sum;
  return before + x - count;
}

// The slot of unit i < the pass's total: the last j < n with first[j] <=
// i, where first[0 .. n) are the slots' prefixes from block_prefix (n <=
// kThreads). A slot without units shares its prefix with the next one, so
// it is never the answer.
template <int kThreads>
__device__ __forceinline__ int unit_slot(const int* first, int n, int i) {
  int top = 1;
  while (2 * top < kThreads) top *= 2;
  int j = 0;
  for (int step = top; step >= 1; step /= 2) {
    if (j + step < n && first[j + step] <= i) j += step;
  }
  return j;
}
