// Widening loads and byte shuffles shared by the stage-1 scan kernels:
//
// - load8 (segment_minima.cu, tiled_minima.cuh): eight consecutive f32
//   or bf16 values, read with one or two 16-byte loads and widened exactly
//   to f32. The pointer is 16-byte aligned; the callers' wrappers check
//   the base pointers and the strides keep every load aligned.
// - transpose4x4 (segment_minima_tiled_wgmma.cu): a 4 x 4 byte transpose
//   of int8 codes in registers.
// - codes_to_bf16x2 (segment_minima_wgmma.cu,
//   segment_minima_tiled_wgmma.cu): two int8 codes widened exactly to one
//   bf16x2 word for the tensor cores.
// - split_bf16x2 (segment_minima_wgmma.cu): two f32 values split into
//   bf16 hi and lo words, each rounded to nearest even, for the split3 and
//   native forms of the f32 stage 1 on the tensor cores.
// - inner (wgmma_minima.cuh, segment_minima_tiled_wgmma.cu): an
//   accumulator as the f32 inner product of the epilogue.
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

// 4 words w[i], each holding 4 consecutive rows (byte j = row j) of dim i,
// become 4 words o[j], each holding 4 consecutive dims (byte i = dim i) of
// row j: a 4 x 4 byte transpose. __byte_perm(x, y, s) picks result byte n
// from the 8 bytes {x, y} by nibble n of s.
__device__ __forceinline__ void transpose4x4(const uint32_t (&w)[4],
                                             uint32_t (&o)[4]) {
  const uint32_t t0 = __byte_perm(w[0], w[1], 0x5140);  // w0.b0 w1.b0 w0.b1 w1.b1
  const uint32_t t1 = __byte_perm(w[2], w[3], 0x5140);  // w2.b0 w3.b0 w2.b1 w3.b1
  const uint32_t t2 = __byte_perm(w[0], w[1], 0x7362);  // w0.b2 w1.b2 w0.b3 w1.b3
  const uint32_t t3 = __byte_perm(w[2], w[3], 0x7362);  // w2.b2 w3.b2 w2.b3 w3.b3
  o[0] = __byte_perm(t0, t1, 0x5410);  // w0.b0 w1.b0 w2.b0 w3.b0
  o[1] = __byte_perm(t0, t1, 0x7632);  // w0.b1 w1.b1 w2.b1 w3.b1
  o[2] = __byte_perm(t2, t3, 0x5410);  // w0.b2 w1.b2 w2.b2 w3.b2
  o[3] = __byte_perm(t2, t3, 0x7632);  // w0.b3 w1.b3 w2.b3 w3.b3
}

// Two int8 codes (bytes k and k + 1 of w, already XORed with 0x80) as one
// bf16x2 word, exactly: 0x4B0000uu is the f32 2^23 + uu, and less
// 2^23 + 128 it is the signed code, whose top 16 bits are its bf16.
__device__ __forceinline__ uint32_t codes_to_bf16x2(uint32_t w, int k) {
  const float lo = __uint_as_float(__byte_perm(w, 0x4B000000u, 0x7540 | k)) -
                   8388736.0f;
  const float hi =
      __uint_as_float(__byte_perm(w, 0x4B000000u, 0x7540 | (k + 1))) -
      8388736.0f;
  return __byte_perm(__float_as_uint(lo), __float_as_uint(hi), 0x7632);
}

// Two f32 values x0, x1 (bit patterns a, b) as one bf16x2 word of each,
// x0 in the low half: hi = bf16(x) and lo = bf16(x - f32(hi)), both
// rounded to nearest even (cvt.rn.bf16x2.f32 packs its first source into
// the high half), as torch's and jnp's astype(bfloat16) round. x - f32(hi)
// is exact in f32, and a bf16 widens to f32 by a 16-bit shift.
__device__ __forceinline__ uint32_t bf16x2_rn(float x0, float x1) {
  uint32_t d;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;\n" : "=r"(d) : "f"(x1), "f"(x0));
  return d;
}
__device__ __forceinline__ void split_bf16x2(uint32_t a, uint32_t b,
                                             uint32_t& hi, uint32_t& lo) {
  const float x0 = __uint_as_float(a);
  const float x1 = __uint_as_float(b);
  hi = bf16x2_rn(x0, x1);
  lo = bf16x2_rn(x0 - __uint_as_float(hi << 16),
                 x1 - __uint_as_float(hi & 0xffff0000u));
}

// An accumulator as the f32 inner product: an f32 sum as it is, an int32
// sum converted (exactly, below 2^24) and scaled. The int8 x int8 forms
// pass scale = 1.0f in production and in the K9 probe, which changes no
// bit, and the K10 probe's g (tools/probe_int8_mxu.py:51-59: the product,
// then the scale).
__device__ __forceinline__ float inner(float acc, float) { return acc; }
__device__ __forceinline__ float inner(int acc, float scale) {
  return static_cast<float>(acc) * scale;
}

}  // namespace
