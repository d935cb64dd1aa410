// Hopper (sm_90a) building blocks for kernels whose products run on the
// tensor cores through wgmma: inline-PTX wrappers for cp.async, the wgmma
// fences and groups, the 64-bit shared-memory matrix descriptor, and
// wgmma.mma_async m64n128k16 with bf16 operands and f32 accumulators.
//
// Operand layout. Every operand tile is K-major (a row's K values are
// contiguous) and stored in the 128-byte swizzle layout that the
// descriptor's layout type 1 reads:
//
// - a tile holds R rows of one 64-value K-chunk of bf16: row r lies at
//   byte r * 128 of the tile, so eight rows make one 1024-byte swizzle
//   atom and the tile starts on a 1024-byte boundary;
// - the row's eight 16-byte pieces (8 bf16 each) are stored XOR-permuted:
//   logical piece p of row r sits at piece p ^ (r % 8) (swizzle_offset);
// - the descriptor of a k16 step (16 K values, 32 bytes) starts at the
//   tile plus 32 * step; SBO is the 1024-byte stride between 8-row groups;
//   LBO is unused in this layout (set to one 16-byte unit). The hardware
//   applies the XOR to the address bits it computes, which is why the
//   tile must be 1024-byte aligned.
//
// tests/test_torch_wgmma_layout.py models this layout in numpy and reads
// the constants below from this file.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kSwizzleBytes = 128;   // one swizzled row: 64 bf16 values
constexpr int kPieceBytes = 16;      // one cp.async copy, 8 bf16 values
constexpr int kAtomRows = 8;         // rows of one swizzle atom
constexpr int kAtomBytes = 1024;     // kAtomRows * kSwizzleBytes
constexpr int kLboBytes = 16;        // leading byte offset (unused here)
constexpr int kSboBytes = 1024;      // stride byte offset: next 8 rows
constexpr int kK16Bytes = 32;        // one k16 step of bf16 along a row
constexpr int kDescAddrShift = 0;    // bits 0-13: start address >> 4
constexpr int kDescLboShift = 16;    // bits 16-29: LBO >> 4
constexpr int kDescSboShift = 32;    // bits 32-45: SBO >> 4
constexpr int kDescLayoutShift = 62; // bits 62-63: layout type
constexpr int kLayoutSwizzle128 = 1; // 128-byte swizzle

// Byte offset of logical 16-byte piece `piece` of row `row` in a
// 1024-byte-aligned 128-byte-swizzle tile.
__device__ __forceinline__ uint32_t swizzle_offset(int row, int piece) {
  return static_cast<uint32_t>(row * kSwizzleBytes +
                               ((piece ^ (row % kAtomRows)) * kPieceBytes));
}

// The wgmma matrix descriptor of a K-major 128-byte-swizzle operand whose
// first row starts at shared address `addr`.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr) {
  return (static_cast<uint64_t>((addr & 0x3FFFF) >> 4) << kDescAddrShift) |
         (static_cast<uint64_t>(kLboBytes >> 4) << kDescLboShift) |
         (static_cast<uint64_t>(kSboBytes >> 4) << kDescSboShift) |
         (static_cast<uint64_t>(kLayoutSwizzle128) << kDescLayoutShift);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared memory, asynchronously (cache in L2 only).
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's cp.async groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Make this thread's generic-proxy writes to shared memory (st.shared and
// cp.async) visible to the async proxy that wgmma reads through; a barrier
// after it publishes them to the other threads.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving reads or writes of accumulator registers
// across an asynchronous wgmma (call on each register before the first
// wgmma and after wgmma_wait).
__device__ __forceinline__ void fence_operand(float& r) {
  asm volatile("" : "+f"(r)::"memory");
}

// d (64 x 128, f32) = A (64 x 16, bf16) B (16 x 128, bf16) + (scale_d ? d
// : 0), A and B K-major in shared memory. Thread t of the warpgroup holds
// d[4 j + 2 h + e] = D[16 (t / 32) + (t % 32) / 4 + 8 h][8 j + 2 (t % 4) +
// e] for j in [0, 16), h and e in {0, 1}.
__device__ __forceinline__ void wgmma_m64n128k16_bf16(float (&d)[64],
                                                      uint64_t desc_a,
                                                      uint64_t desc_b,
                                                      int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

}  // namespace
