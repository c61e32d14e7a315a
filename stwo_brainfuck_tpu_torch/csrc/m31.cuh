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

// A sum of products held in 64 bits and reduced once. mac is one
// IMAD.WIDE.U32 (the 64-bit addend rides in it). reduce64 takes x < 2^64:
// x = (x >> 31) * 2^31 + (x & p) == (x >> 31) + (x & p) (mod p), folded
// twice (the first leaves less than 2^34, the second less than 2p), then one
// conditional subtract, all on the integer pipe. Four products of canonical
// operands (each below 2^62) and a canonical addend fit: a sum of four
// products costs four IMAD.WIDE and one reduction, where m31::mul and
// m31::add spend four and two instructions a term.
__device__ __forceinline__ uint64_t mac(uint64_t s, uint32_t a, uint32_t b) {
  return s + static_cast<uint64_t>(a) * b;
}

__device__ __forceinline__ uint32_t reduce64(uint64_t x) {
  const uint64_t y = (x & kP) + (x >> 31);  // < 2^31 + 2^33
  return reduce_once(static_cast<uint32_t>(y & kP) + static_cast<uint32_t>(y >> 31));
}

// reduce64's first fold alone: x < 2^64 -> a word below 2^34, the same mod
// p. Four more products of canonical operands fit on it (2^34 + 4 (p - 1)^2
// < 2^64), so a long sum of products folds between runs of four and reduces
// once at its end (the composition bodies' weighted sums).
__device__ __forceinline__ uint64_t fold64(uint64_t x) { return (x & kP) + (x >> 31); }

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

// The product as a policy of the QM31 helpers (qm31.cuh). Product is mul.
// Doubled doubles b (below 2^32) and takes mul_doubled: the same word, one
// integer-pipe instruction fewer (the LOP3 of lo & p) for an add that the
// compiler may put on the multiply pipe (the quotient kernel's choice,
// measured faster there on an H100).
struct Product {
  static __device__ __forceinline__ uint32_t mul(uint32_t a, uint32_t b) { return m31::mul(a, b); }
};

struct Doubled {
  static __device__ __forceinline__ uint32_t mul(uint32_t a, uint32_t b) {
    return mul_doubled(a, b + b);
  }
};

}  // namespace m31
