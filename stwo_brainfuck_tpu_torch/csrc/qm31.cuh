// CM31 and QM31 arithmetic on canonical uint32 words, and the point of a
// canonic circle domain at a storage position, shared by the port's
// kernels (csrc/quotients.cu, csrc/constraints.cu).
//
// QM31 = CM31[u] / (u^2 - (2 + i)), CM31 = M31[i] / (i^2 + 1), as in
// core/qm31.py; a value (a + b i) + (c + d i) u is the struct Qm {a, b, c, d}.
// Every result is canonical, like its operands (m31.cuh).

#pragma once

#include <cstdint>

#include "m31.cuh"

namespace qm31 {

constexpr int kMaxLogSize = 30;  // a canonic domain: 2^(30 - log_size) is its first index
constexpr int kLoLog = 16;       // the point tables: lo holds G^k for k < 2^kLoLog

struct Qm {
  uint32_t a, b, c, d;  // (a + b i) + (c + d i) u
};

struct Cm {
  uint32_t r, i;
};

template <class P = m31::Product>
__device__ __forceinline__ Cm cm_mul(Cm x, Cm y) {
  return {m31::sub(P::mul(x.r, y.r), P::mul(x.i, y.i)),
          m31::add(P::mul(x.r, y.i), P::mul(x.i, y.r))};
}

__device__ __forceinline__ Qm qm_add(Qm x, Qm y) {
  return {m31::add(x.a, y.a), m31::add(x.b, y.b), m31::add(x.c, y.c), m31::add(x.d, y.d)};
}

__device__ __forceinline__ Qm qm_sub(Qm x, Qm y) {
  return {m31::sub(x.a, y.a), m31::sub(x.b, y.b), m31::sub(x.c, y.c), m31::sub(x.d, y.d)};
}

// (A + Bu)(C + Du) = AC + (2 + i) BD + (AD + BC) u
template <class P = m31::Product>
__device__ __forceinline__ Qm qm_mul(Qm x, Qm y) {
  const Cm ac = cm_mul<P>({x.a, x.b}, {y.a, y.b});
  const Cm bd = cm_mul<P>({x.c, x.d}, {y.c, y.d});
  const Cm ad = cm_mul<P>({x.a, x.b}, {y.c, y.d});
  const Cm bc = cm_mul<P>({x.c, x.d}, {y.a, y.b});
  // (2 + i)(r + s i) = (2r - s) + (r + 2s) i
  const uint32_t t0 = m31::sub(m31::add(bd.r, bd.r), bd.i);
  const uint32_t t1 = m31::add(bd.r, m31::add(bd.i, bd.i));
  return {m31::add(ac.r, t0), m31::add(ac.i, t1), m31::add(ad.r, bc.r), m31::add(ad.i, bc.i)};
}

// x^2 in CM31 with two products: (r + s)(r - s) + 2rs i.
template <class P = m31::Product>
__device__ __forceinline__ Cm cm_sqr(Cm x) {
  const uint32_t t = P::mul(x.r, x.i);
  return {P::mul(m31::add(x.r, x.i), m31::sub(x.r, x.i)), m31::add(t, t)};
}

// QM31 x M31: each coordinate times s (4 products).
template <class P = m31::Product>
__device__ __forceinline__ Qm qm_mul_m31(Qm x, uint32_t s) {
  return {P::mul(x.a, s), P::mul(x.b, s), P::mul(x.c, s), P::mul(x.d, s)};
}

// An M31 value as a QM31 one.
__device__ __forceinline__ Qm qm_from_m31(uint32_t s) { return {s, 0u, 0u, 0u}; }

template <class P = m31::Product>
__device__ __forceinline__ uint32_t sqn(uint32_t x, int n) {
#pragma unroll
  for (int k = 0; k < n; ++k) x = P::mul(x, x);
  return x;
}

// x^(p - 2), 0 -> 0: the addition chain of core/m31.py inv
// (p - 2 = (2^29 - 1) * 4 + 1).
template <class P = m31::Product>
__device__ __forceinline__ uint32_t m31_inv(uint32_t x1) {
  const uint32_t x2 = P::mul(sqn<P>(x1, 1), x1);
  const uint32_t x4 = P::mul(sqn<P>(x2, 2), x2);
  const uint32_t x5 = P::mul(sqn<P>(x4, 1), x1);
  const uint32_t x10 = P::mul(sqn<P>(x5, 5), x5);
  const uint32_t x20 = P::mul(sqn<P>(x10, 10), x10);
  const uint32_t x29 = P::mul(sqn<P>(x20, 9), P::mul(sqn<P>(x5, 4), x4));
  return P::mul(sqn<P>(x29, 2), x1);
}

// Montgomery's trick: inv[m] = z[m]^-1 for K values with one m31_inv and
// 3 (K - 1) products (the running products, then two products a value on the
// way back), in place of K inversions. Zero-safe, bit for bit the per-value
// inverse with 0 -> 0: a zero takes 1 into the running product and gets 0 out.
template <int K, class P = m31::Product>
__device__ __forceinline__ void batch_inv(const uint32_t (&z)[K], uint32_t (&inv)[K]) {
  uint32_t run[K];
#pragma unroll
  for (int m = 0; m < K; ++m) {
    const uint32_t zm = z[m] ? z[m] : 1u;
    run[m] = m ? P::mul(run[m - 1], zm) : zm;
  }
  uint32_t t = m31_inv<P>(run[K - 1]);
#pragma unroll
  for (int m = K - 1; m > 0; --m) {
    inv[m] = z[m] ? P::mul(t, run[m - 1]) : 0u;
    t = P::mul(t, z[m] ? z[m] : 1u);
  }
  inv[0] = z[0] ? t : 0u;
}

// (A + Bu)^-1 = (A - Bu) / (A^2 - (2 + i) B^2), the CM31 denominator
// inverted as conj / norm; 0 -> 0 (core/qm31.py inv).
__device__ __forceinline__ Qm qm_inv(Qm x) {
  const Cm a2 = cm_mul({x.a, x.b}, {x.a, x.b});
  const Cm b2 = cm_mul({x.c, x.d}, {x.c, x.d});
  const Cm den = {m31::add(m31::sub(a2.r, m31::add(b2.r, b2.r)), b2.i),
                  m31::sub(m31::sub(a2.i, b2.r), m31::add(b2.i, b2.i))};
  const uint32_t norm = m31::add(m31::mul(den.r, den.r), m31::mul(den.i, den.i));
  const uint32_t ninv = m31_inv(norm);
  const Cm di = {m31::mul(den.r, ninv), m31::mul(m31::sub(0u, den.i), ninv)};
  const Cm lo = cm_mul({x.a, x.b}, di);
  const Cm hi = cm_mul({m31::sub(0u, x.c), m31::sub(0u, x.d)}, di);
  return {lo.r, lo.i, hi.r, hi.i};
}

__device__ __forceinline__ Qm load_qm(const uint32_t* w) {
  return {__ldg(w), __ldg(w + 1), __ldg(w + 2), __ldg(w + 3)};
}

// G^k, k < 2^31, from the point tables: lo[k mod 2^16] * hi[k / 2^16] (one
// circle multiplication, the product of CM31).
__device__ __forceinline__ Cm table_point(uint32_t k, const uint2* __restrict__ lo,
                                          const uint2* __restrict__ hi) {
  const uint2 p = __ldg(lo + (k & ((1u << kLoLog) - 1u)));
  const uint2 q = __ldg(hi + (k >> kLoLog));
  return cm_mul({p.x, p.y}, {q.x, q.y});
}

// The point at storage position i of the canonic domain of size 2^log_size:
// r = i bit-reversed over log_size bits; the domain in natural order is the
// half coset G^(2^(30 - log_size) * (1 + 4j)), j < 2^(log_size - 1), then
// its conjugates (x, -y); G^k, k < 2^31, is lo[k mod 2^16] * hi[k / 2^16]
// (one circle multiplication; the tables of ops/quotient_kernels.py
// point_tables, whose emulate_points replays this).
__device__ __forceinline__ void domain_point(uint32_t i, int log_size, const uint2* __restrict__ lo,
                                             const uint2* __restrict__ hi, uint32_t& px,
                                             uint32_t& py) {
  const uint32_t r = __brev(i) >> (32 - log_size);
  const uint32_t half = 1u << (log_size - 1);
  const uint32_t j = r < half ? r : r - half;
  const Cm g = table_point((1u + 4u * j) << (kMaxLogSize - log_size), lo, hi);  // k < 2^31
  px = g.r;
  py = r < half ? g.i : m31::sub(0u, g.i);
}

}  // namespace qm31
