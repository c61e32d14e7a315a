// The combined OODS quotient of one commitment size, all point groups in
// one launch, for Hopper (sm_90a).
//
// Replaces stwo_brainfuck_tpu/core/quotients.py:218 _accumulate_all_jit
// (with :116 _weighted_columns and :139 _point_group_quotient), the one
// fused XLA program a size that the JAX package runs; jnp, not Pallas. The
// port's plain version is core/quotients.py accumulate_groups, bit for bit.
//
// For each storage position i in [offset, offset + n) of the canonic domain
// of size 2^log_size, with (px, py) the domain point there:
//
//   out[:, i - offset] = sum over groups of
//       inv(dy * px - dx * py + vc) * (sum_c w_c * f_c[i] - A - B * py)
//
// in QM31 (CM31[u] / (u^2 - (2 + i)), CM31 = M31[i] / (i^2 + 1)), mod
// p = 2^31 - 1. A, B, dy, dx, vc and the weights w_c are QM31 constants of
// a group (core/quotients.py _group_constants); f_c are M31 columns.
//
// Inputs (the wrapper is ops/quotient_kernels.py), one small device table:
//   cols    the column pointers, column c's value at position offset + t at
//           cols[c][t] (each a row of some tensor; nothing is stacked or
//           copied);
//   groups  behind them, the groups' constants as 32-bit words, group after
//           group: n_members, A[4], B[4], dy[4], dx[4], vc[4], then
//           n_members times (column index, w[4]);
//   lo, hi  the circle points G^k for k < 2^16 and G^(k * 2^16) for
//           k < 2^15, (x, y) pairs (G the generator of the circle's 2^31
//           points, core/circle.py).
//
// What bounded the first version (one thread a point): a
// point took ~110 M31 products at 4 columns and one group, 62 of them in
// the QM31 inverse, 42 of those a serial chain (m31_inv) with nothing
// beside it in the thread; every member read its column pointer and then
// its value (two dependent loads), every constant went through the
// read-only path at each use, and each point gathered hi[k >> 16] at a
// bit-reversed index, 32 sectors a warp. It ran at 37 % of its instruction
// bound at (4 columns, 2^28).
//
// The design now:
// - Schedule. A thread takes K positions t0 + i * S, i < K (K = 8 with one
//   group, 4 with more, where each point keeps its sum across groups; S the
//   launch's stride, n / K or, with a tail, ceil(n / K)), so each of its K
//   column loads and output stores is coalesced across the warp.
// - Inversion. The K norms of a group are inverted together (qm31::batch_inv,
//   Montgomery's trick, zero-safe): 3 products a point and one m31_inv per
//   K points, and K independent streams of work in every thread beside it.
//   The QM31 inverse is written as (A - Bu) conj(den) / norm, so a point
//   keeps only y = num (A - Bu) conj(den) (4 words) and its norm until the
//   batch is inverted. Any exact inverse gives the same words, so this is
//   bit for bit the plain version.
// - Points ("walk" launches: n = 2^l with l >= log2 K + 5 and offset a
//   multiple of n, which is the whole domain and every mesh shard). The K
//   points of a thread are P0 * D^m, m < K, for D = G^(2^(32 - l)) (position
//   t0 + rev(m) * S, rev over log2 K bits, has index j0 + m * 2^(log_size - l)
//   in its half coset): one circle multiplication a point. P0 comes from
//   the warp's first position (one lo and one hi word, the same for every
//   lane) times hi[rev4(lane / 2) << 11] = G^(rev4(lane / 2) * 2^27), one of
//   16 words every warp reads, conjugated on odd lanes (the second half).
//   No per-point gather is left. Other launches (a range that is not such a
//   chunk, a tail) make each point from its position (qm31::domain_point).
// - Constants. The launch's table (pointers and group words) is staged once
//   per CTA in shared memory: a member costs one shared load of its pointer
//   and weights, then K coalesced column loads.
// - Sums. Up to four members' products and the running sum are added in 64
//   bits (m31::mac, one IMAD.WIDE a product) with one reduction a
//   coordinate (m31::reduce64), as is the vanishing line.
// - Products. Every other product is m31::Doubled (the QM31 helpers'
//   policy): mul_doubled of the operand doubled, one integer-pipe
//   instruction fewer than m31::mul, whose LOP3, LEA.HI and VIADDMNMX, not
//   the IMAD.WIDE, were the busier pipe's (tools/quotient_variants.py
//   times both). Registers are bounded for two CTAs an SM at K = 8 (it
//   needs about 200 unbounded; one CTA an SM, or three with spills, is
//   slower) and three at K = 4.
//
// What bounds it now: the M31 product rate. A point takes about 75
// products at 4 columns and one group (chip_smoke.py quotient_work), and a
// product costs more issue slots than its four SASS instructions:
// chip_smoke.py's mul_chain probe runs products at about 40 % of the
// one-instruction-a-clock dispatch bound (IMAD.WIDE and the integer ops
// issue at less than a warp a clock). At (4, 2^28) the kernel is about
// 2.4x the bytes bound (4 bytes a column read, 16 written), which sets the
// stated bound; the products alone at the dispatch rate are as long.

#include <cstdint>
#include <cuda_runtime.h>

#include "m31.cuh"
#include "qm31.cuh"

namespace {

using qm31::Cm;
using qm31::Qm;

constexpr int kThreads = 256;
constexpr int kMaxLogSize = qm31::kMaxLogSize;
constexpr int kHeaderWords = 21;         // n_members, A, B, dy, dx, vc
constexpr int kMemberWords = 5;          // column index, w
constexpr int kChunk = 4;                // members summed in 64 bits before one reduction
constexpr int kMaxTableBytes = 48 << 10; // the table staged in shared memory
// CTAs an SM the registers are bounded for: 128 a thread at K = 8, 85 at
// K = 4 (tools/quotient_variants.py times the others)
constexpr int kMinBlocksOne = 2;
constexpr int kMinBlocksMany = 3;

struct Args {
  const uint32_t* table;  // n_cols pointers (two words each), then the group words
  int n_cols;
  int table_words;
  int n_groups;
  const uint2* lo;
  const uint2* hi;
  int log_size;
  uint32_t offset;
  uint32_t n;
  uint32_t stride;  // S: position t0 + i * S is a thread's i-th
  int log_n;        // walk launches: n = 2^log_n
  uint32_t* out;    // (4, n)
};

template <int K>
__host__ __device__ constexpr int log2_of() {
  return K == 8 ? 3 : K == 4 ? 2 : K == 2 ? 1 : 0;
}

// m bit-reversed over log2 K bits.
template <int K>
__device__ __forceinline__ constexpr uint32_t rev(uint32_t m) {
  uint32_t r = 0;
  for (int b = 0; b < log2_of<K>(); ++b) r |= ((m >> b) & 1u) << (log2_of<K>() - 1 - b);
  return r;
}

// A walk launch's thread t0: its first point P0 and the step D, the point
// of walk index m being P0 * D^m at position t0 + rev(m) * S (see the note
// above).
__device__ __forceinline__ void walk_start(const Args& a, uint32_t t0, Cm& p0, Cm& d) {
  const uint32_t lane = threadIdx.x & 31u;
  // the warp's first position, bit-reversed: its top five bits are zero
  const uint32_t r = __brev(a.offset + (t0 - lane)) >> (32 - a.log_size);
  p0 = qm31::table_point((1u + 4u * r) << (kMaxLogSize - a.log_size), a.lo, a.hi);
  const uint2 e = __ldg(a.hi + ((__brev(lane >> 1) >> 28) << 11));
  p0 = qm31::cm_mul(p0, {e.x, e.y});
  d = qm31::table_point(1u << (32 - a.log_n), a.lo, a.hi);
  if (lane & 1u) {
    p0.i = m31::sub(0u, p0.i);
    d.i = m31::sub(0u, d.i);
  }
}

// The thread's m-th position, relative to the launch's offset.
template <int K, bool kWalk>
__device__ __forceinline__ uint32_t position(const Args& a, uint32_t t0, int m) {
  return t0 + (kWalk ? rev<K>(m) : static_cast<uint32_t>(m)) * a.stride;
}

using P = m31::Doubled;  // the product (m31.cuh)

// One group's value inv(van) * num at the thread's K points (0 where a
// point is not live), as y / z for y = num (A - Bu) conj(den) and z = |den|^2
// (van = A + Bu, den = A^2 - (2 + i) B^2); g points at the group's words in
// shared memory. The points are walked again from P0 (walk launches) or
// looked up (others).
template <int K, bool kWalk>
__device__ __forceinline__ void group_values(const Args& a, const uint32_t* g,
                                             const unsigned long long* cols, uint32_t t0,
                                             uint32_t live, Cm p0, Cm d, Qm (&res)[K]) {
  const int members = static_cast<int>(g[0]);
  uint32_t wf[K][4];
#pragma unroll
  for (int m = 0; m < K; ++m) {
#pragma unroll
    for (int q = 0; q < 4; ++q) wf[m][q] = m31::sub(0u, g[1 + q]);  // -A
  }
  const uint32_t* mem = g + kHeaderWords;
#pragma unroll 1
  for (int c0 = 0; c0 < members; c0 += kChunk) {
    uint32_t f[kChunk][K];
#pragma unroll
    for (int c = 0; c < kChunk; ++c) {
      const bool here = c0 + c < members;
      const uint32_t* col =
          here ? reinterpret_cast<const uint32_t*>(cols[mem[(c0 + c) * kMemberWords]]) : nullptr;
#pragma unroll
      for (int m = 0; m < K; ++m)
        f[c][m] = here && ((live >> m) & 1u) ? __ldg(col + position<K, kWalk>(a, t0, m)) : 0u;
    }
#pragma unroll
    for (int m = 0; m < K; ++m) {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        uint64_t s = wf[m][q];
#pragma unroll
        for (int c = 0; c < kChunk; ++c)
          if (c0 + c < members) s = m31::mac(s, mem[(c0 + c) * kMemberWords + 1 + q], f[c][m]);
        wf[m][q] = m31::reduce64(s);
      }
    }
  }
  Qm y[K];
  uint32_t z[K];
  Cm p = p0;
#pragma unroll
  for (int m = 0; m < K; ++m) {
    uint32_t px = 0u, py = 0u;
    if (kWalk) {
      if (m) p = qm31::cm_mul<P>(p, d);
      px = p.r;
      py = p.i;
    } else if ((live >> m) & 1u) {
      qm31::domain_point(a.offset + position<K, kWalk>(a, t0, m), a.log_size, a.lo, a.hi, px, py);
    }
    uint32_t num[4], van[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      num[q] = m31::sub(wf[m][q], P::mul(g[5 + q], py));  // - B py
      van[q] = m31::reduce64(m31::mac(m31::mac(g[17 + q], g[9 + q], px),  // vc + dy px
                                      m31::sub(0u, g[13 + q]), py));        // - dx py
    }
    const Cm a2 = qm31::cm_sqr<P>({van[0], van[1]}), b2 = qm31::cm_sqr<P>({van[2], van[3]});
    const Cm den = {m31::add(m31::sub(a2.r, m31::add(b2.r, b2.r)), b2.i),
                    m31::sub(m31::sub(a2.i, b2.r), m31::add(b2.i, b2.i))};
    z[m] = (live >> m) & 1u ? m31::add(P::mul(den.r, den.r), P::mul(den.i, den.i)) : 0u;
    const Qm t = qm31::qm_mul<P>({num[0], num[1], num[2], num[3]},
                                 {van[0], van[1], m31::sub(0u, van[2]), m31::sub(0u, van[3])});
    const Cm cd = {den.r, m31::sub(0u, den.i)};
    const Cm lo = qm31::cm_mul<P>({t.a, t.b}, cd), hi = qm31::cm_mul<P>({t.c, t.d}, cd);
    y[m] = {lo.r, lo.i, hi.r, hi.i};
  }
  uint32_t inv[K];
  qm31::batch_inv<K, P>(z, inv);
#pragma unroll
  for (int m = 0; m < K; ++m) res[m] = qm31::qm_mul_m31<P>(y[m], inv[m]);
}

template <int K, bool kWalk>
__global__ void __launch_bounds__(kThreads, K == 8 ? kMinBlocksOne : kMinBlocksMany)
    quotients_kernel(const Args a) {
  extern __shared__ __align__(16) uint32_t table[];
  for (int w = threadIdx.x; w < a.table_words; w += kThreads) table[w] = __ldg(a.table + w);
  __syncthreads();
  const uint32_t t0 = blockIdx.x * kThreads + threadIdx.x;
  if (t0 >= a.stride) return;
  uint32_t live = (1u << K) - 1u;
  Cm p0 = {0u, 0u}, d = {0u, 0u};
  if (kWalk) {
    walk_start(a, t0, p0, d);
  } else {
#pragma unroll
    for (int m = 0; m < K; ++m)
      if (position<K, kWalk>(a, t0, m) >= a.n) live &= ~(1u << m);
  }
  const unsigned long long* cols = reinterpret_cast<const unsigned long long*>(table);
  const uint32_t* g = table + 2 * a.n_cols;
  Qm acc[K];
#pragma unroll 1
  for (int grp = 0; grp < a.n_groups; ++grp) {
    Qm res[K];
    group_values<K, kWalk>(a, g, cols, t0, live, p0, d, res);
#pragma unroll
    for (int m = 0; m < K; ++m) acc[m] = grp ? qm31::qm_add(acc[m], res[m]) : res[m];
    g += kHeaderWords + kMemberWords * static_cast<int>(g[0]);
  }
  const size_t n = a.n;
#pragma unroll
  for (int m = 0; m < K; ++m) {
    if ((live >> m) & 1u) {
      uint32_t* o = a.out + position<K, kWalk>(a, t0, m);
      o[0] = acc[m].a;
      o[n] = acc[m].b;
      o[2 * n] = acc[m].c;
      o[3 * n] = acc[m].d;
    }
  }
}

// The schedule of a launch: K, whether it walks, the stride S.
struct Schedule {
  int k;
  bool walk;
  long long stride;
  int log_n;
};

Schedule schedule(int n_groups, long long offset, long long n) {
  Schedule s;
  s.k = n_groups == 1 ? 8 : 4;
  const int k_log = s.k == 8 ? 3 : 2;
  s.log_n = 0;
  while ((1ll << s.log_n) < n) ++s.log_n;
  s.walk = (1ll << s.log_n) == n && s.log_n >= k_log + 5 && offset % n == 0;
  s.stride = s.walk ? n >> k_log : (n + s.k - 1) / s.k;
  return s;
}

template <int K, bool kWalk>
void launch(const Args& a, unsigned int blocks, size_t smem, cudaStream_t stream) {
  quotients_kernel<K, kWalk><<<blocks, kThreads, smem, stream>>>(a);
}

}  // namespace

extern "C" int quotients_max_log_size() { return kMaxLogSize; }

// out: K, walk (0 or 1), the stride, as the launch of (n_groups, offset, n)
// takes them (ops/quotient_kernels.py schedule mirrors this).
extern "C" int quotients_schedule(int n_groups, long long offset, long long n, long long* out) {
  const Schedule s = schedule(n_groups, offset, n);
  out[0] = s.k;
  out[1] = s.walk;
  out[2] = s.stride;
  return 0;
}

// table: n_cols column pointers (8 bytes each), then group_words words of
// the groups as laid out above, in device memory; out: (4, n) words.
// Returns the CUDA error (cudaErrorInvalidValue for arguments the kernel
// does not take).
extern "C" int quotients_accumulate(const void* table, int n_cols, int n_groups,
                                    long long group_words, const void* lo, const void* hi,
                                    int log_size, long long offset, long long n, void* out,
                                    void* stream) {
  const long long table_words = 2ll * n_cols + group_words;
  if (log_size < 1 || log_size > kMaxLogSize || n < 1 || offset < 0 ||
      offset + n > (1ll << log_size) || n_cols < 1 || n_groups < 1 ||
      group_words < static_cast<long long>(n_groups) * (kHeaderWords + kMemberWords) ||
      table_words * 4 > kMaxTableBytes) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Schedule s = schedule(n_groups, offset, n);
  Args a;
  a.table = static_cast<const uint32_t*>(table);
  a.n_cols = n_cols;
  a.table_words = static_cast<int>(table_words);
  a.n_groups = n_groups;
  a.lo = static_cast<const uint2*>(lo);
  a.hi = static_cast<const uint2*>(hi);
  a.log_size = log_size;
  a.offset = static_cast<uint32_t>(offset);
  a.n = static_cast<uint32_t>(n);
  a.stride = static_cast<uint32_t>(s.stride);
  a.log_n = s.log_n;
  a.out = static_cast<uint32_t*>(out);
  const unsigned int blocks = static_cast<unsigned int>((s.stride + kThreads - 1) / kThreads);
  const size_t smem = static_cast<size_t>(table_words) * 4;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (s.k == 8) {
    s.walk ? launch<8, true>(a, blocks, smem, st) : launch<8, false>(a, blocks, smem, st);
  } else {
    s.walk ? launch<4, true>(a, blocks, smem, st) : launch<4, false>(a, blocks, smem, st);
  }
  return static_cast<int>(cudaGetLastError());
}
