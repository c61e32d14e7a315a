// M31 field arithmetic (p = 2^31 - 1) shared by the port's CUDA kernels.
//
// Operands are canonical (< p) and so are results. Each operation ends in
// one conditional subtract written as an unsigned min: for r < 2p,
// min(r, r - p) is r - p when r >= p and r otherwise (r - p then wraps
// above r). That is two instructions (add, min) and no branch.
//
// The product is one 32 x 32 -> 64-bit multiply (mul.wide.u32) and one
// Mersenne fold of its 32-bit halves: x = hi * 2^32 + lo, so
// x = (x >> 31) * 2^31 + (lo & p) == (x >> 31) + (lo & p) (mod p), with
// x >> 31 = (hi << 1) | (lo >> 31), one funnel shift (SHF) of the halves.
// For canonical a, b: x <= (p - 1)^2, so x >> 31 <= p - 3 and the folded
// sum is below 2p. On sm_90a a product is 4 SASS instructions: IMAD.WIDE.U32,
// LOP3 (lo & p), LEA.HI (the funnel shift and the add) and VIADDMNMX (the
// conditional subtract).
// ops/m31_kernels.py::emulate replays these steps on int64 tensors.

#pragma once

#include <cstdint>

namespace m31 {

constexpr uint32_t kP = 0x7fffffffu;

__device__ __forceinline__ uint32_t reduce_once(uint32_t r) {  // r < 2p
  return min(r, r - kP);
}

__device__ __forceinline__ uint32_t add(uint32_t a, uint32_t b) {
  return reduce_once(a + b);
}

__device__ __forceinline__ uint32_t sub(uint32_t a, uint32_t b) {
  const uint32_t d = a - b;  // wraps above p when a < b
  return min(d, d + kP);
}

__device__ __forceinline__ uint32_t mul(uint32_t a, uint32_t b) {
  const uint64_t x = static_cast<uint64_t>(a) * b;
  const uint32_t lo = static_cast<uint32_t>(x);
  const uint32_t hi = static_cast<uint32_t>(x >> 32);
  return reduce_once((lo & kP) + __funnelshift_r(lo, hi, 31));
}

// Product with a doubled operand t2 = 2b (b < p, so t2 < 2^32), as the
// circle FFT keeps its twiddles: a * t2 = 2x with x = a * b, so the high
// word is x >> 31 and the low word is (x & p) << 1, and the fold
// (x >> 31) + (x & p) is one LEA.HI of the two words. Three instructions
// (IMAD.WIDE.U32, LEA.HI, VIADDMNMX) where mul takes four; the same bounds
// (the sum is below 2p for a, b < p).
__device__ __forceinline__ uint32_t mul_doubled(uint32_t a, uint32_t t2) {
  const uint64_t x = static_cast<uint64_t>(a) * t2;
  const uint32_t lo = static_cast<uint32_t>(x);
  const uint32_t hi = static_cast<uint32_t>(x >> 32);
  return reduce_once(hi + (lo >> 1));
}

}  // namespace m31
