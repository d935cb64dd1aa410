// Hopper (sm_90a) building blocks for kernels whose products run on the
// tensor cores through wgmma: inline-PTX wrappers for cp.async, the wgmma
// fences and groups, the 64-bit shared-memory matrix descriptor, and
// wgmma.mma_async m64n128 in two operand types: k16 of bf16 with f32
// accumulators, and k32 of int8 with s32 accumulators.
//
// Operand layout. Every operand tile is K-major (a row's K values are
// contiguous) and stored in the 128-byte swizzle layout that the
// descriptor's layout type 1 reads:
//
// - a tile holds R rows of one 128-byte K-chunk (64 bf16 or 128 int8
//   values): row r lies at byte r * 128 of the tile, so eight rows make one
//   1024-byte swizzle atom and the tile starts on a 1024-byte boundary;
// - the row's eight 16-byte pieces (8 bf16 or 16 int8 each) are stored
//   XOR-permuted: logical piece p of row r sits at piece p ^ (r % 8)
//   (swizzle_offset);
// - one wgmma K step reads 32 bytes of each row (k16 of bf16, k32 of
//   int8), so the descriptor of step k starts at the tile plus 32 * k in
//   both types; SBO is the 1024-byte stride between 8-row groups; LBO is
//   unused in this layout (set to one 16-byte unit). The hardware applies
//   the XOR to the address bits it computes, which is why the tile must be
//   1024-byte aligned.
//
// tests/test_torch_wgmma_layout.py models this layout in numpy and reads
// the constants below from this file.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kSwizzleBytes = 128;   // one swizzled row: 64 bf16, 128 int8
constexpr int kPieceBytes = 16;      // one cp.async copy: 8 bf16, 16 int8
constexpr int kAtomRows = 8;         // rows of one swizzle atom
constexpr int kAtomBytes = 1024;     // kAtomRows * kSwizzleBytes
constexpr int kLboBytes = 16;        // leading byte offset (unused here)
constexpr int kSboBytes = 1024;      // stride byte offset: next 8 rows
constexpr int kKStepBytes = 32;      // one K step: k16 of bf16, k32 of int8
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

__device__ __forceinline__ void fence_operand(int& r) {
  asm volatile("" : "+r"(r)::"memory");
}

// The 64 accumulator registers of an m64n128 wgmma: the PTX operand list
// and the asm outputs, "+f" (f32) or "+r" (s32).
#define WGMMA_D64_REGS                                                  \
  "{%0, %1, %2, %3, %4, %5, %6, %7, "                                   \
  "%8, %9, %10, %11, %12, %13, %14, %15, "                              \
  "%16, %17, %18, %19, %20, %21, %22, %23, "                            \
  "%24, %25, %26, %27, %28, %29, %30, %31, "                            \
  "%32, %33, %34, %35, %36, %37, %38, %39, "                            \
  "%40, %41, %42, %43, %44, %45, %46, %47, "                            \
  "%48, %49, %50, %51, %52, %53, %54, %55, "                            \
  "%56, %57, %58, %59, %60, %61, %62, %63}"
#define WGMMA_D64(C, d)                                                 \
  C(d[0]), C(d[1]), C(d[2]), C(d[3]), C(d[4]), C(d[5]), C(d[6]),        \
  C(d[7]), C(d[8]), C(d[9]), C(d[10]), C(d[11]), C(d[12]), C(d[13]),    \
  C(d[14]), C(d[15]), C(d[16]), C(d[17]), C(d[18]), C(d[19]),           \
  C(d[20]), C(d[21]), C(d[22]), C(d[23]), C(d[24]), C(d[25]),           \
  C(d[26]), C(d[27]), C(d[28]), C(d[29]), C(d[30]), C(d[31]),           \
  C(d[32]), C(d[33]), C(d[34]), C(d[35]), C(d[36]), C(d[37]),           \
  C(d[38]), C(d[39]), C(d[40]), C(d[41]), C(d[42]), C(d[43]),           \
  C(d[44]), C(d[45]), C(d[46]), C(d[47]), C(d[48]), C(d[49]),           \
  C(d[50]), C(d[51]), C(d[52]), C(d[53]), C(d[54]), C(d[55]),           \
  C(d[56]), C(d[57]), C(d[58]), C(d[59]), C(d[60]), C(d[61]),           \
  C(d[62]), C(d[63])

// d (64 x 128, f32) = A (64 x 16, bf16) B (16 x 128, bf16) + (scale_d ? d
// : 0), A and B K-major in shared memory. Thread t of the warpgroup holds
// d[4 j + 2 h + e] = D[16 (t / 32) + (t % 32) / 4 + 8 h][8 j + 2 (t % 4) +
// e] for j in [0, 16), h and e in {0, 1}. The immediates after the
// predicate scale A and B by +1 and take both as K-major (no transpose).
__device__ __forceinline__ void wgmma_m64n128k16_bf16(float (&d)[64],
                                                      uint64_t desc_a,
                                                      uint64_t desc_b,
                                                      int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      WGMMA_D64_REGS ", %64, %65, p, 1, 1, 0, 0;\n"
      "}\n"
      : WGMMA_D64("+f", d)
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// d (64 x 128, s32) = A (64 x 32, s8) B (32 x 128, s8) + (scale_d ? d :
// 0), A and B K-major in shared memory (the only layout wgmma takes for
// int8). The integer form takes no scale or transpose immediates, only
// the scale-d predicate. Its accumulator fragment is the bf16 form's
// above. The int32 sums are exact in any order.
__device__ __forceinline__ void wgmma_m64n128k32_s8(int (&d)[64],
                                                    uint64_t desc_a,
                                                    uint64_t desc_b,
                                                    int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      WGMMA_D64_REGS ", %64, %65, p;\n"
      "}\n"
      : WGMMA_D64("+r", d)
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

}  // namespace
