// Widening loads shared by the stage-1 scan kernels (segment_minima.cu,
// segment_minima_tiled.cu): eight consecutive f32, bf16 or int8 values,
// read with one or two vector loads and widened exactly to f32. The
// pointer is aligned to the load's width (16 bytes for f32 and bf16, 8 for
// int8); the callers' wrappers check the base pointers and the strides
// keep every load aligned.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace {

__device__ __forceinline__ void load8(const float* __restrict__ p,
                                      float v[8]) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  const float4 b = __ldg(reinterpret_cast<const float4*>(p + 4));
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

// Eight bf16 values (raw 16-bit patterns) widened exactly to f32.
__device__ __forceinline__ void load8(const uint16_t* __restrict__ p,
                                      float v[8]) {
  const uint4 w = __ldg(reinterpret_cast<const uint4*>(p));
  const uint32_t words[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    v[2 * i] = __uint_as_float(words[i] << 16);
    v[2 * i + 1] = __uint_as_float(words[i] & 0xffff0000u);
  }
}

// Eight int8 codes widened exactly to f32 (byte j of word i is value
// 4 i + j: the card is little-endian).
__device__ __forceinline__ void load8(const int8_t* __restrict__ p,
                                      float v[8]) {
  const uint2 w = __ldg(reinterpret_cast<const uint2*>(p));
  const uint32_t words[2] = {w.x, w.y};
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      v[4 * i + j] = static_cast<float>(
          static_cast<int8_t>((words[i] >> (8 * j)) & 0xffu));
    }
  }
}

}  // namespace
