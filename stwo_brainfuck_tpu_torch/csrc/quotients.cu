// The combined OODS quotient of one commitment size, all point groups in
// one launch, for Hopper (sm_90a).
//
// Replaces stwo_brainfuck_tpu/core/quotients.py:217 _accumulate_all_jit
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
// The point of position i is made in the kernel: r = i bit-reversed over
// log_size bits; the domain in natural order is the half coset
// G^(2^(30 - log_size) * (1 + 4j)), j < 2^(log_size - 1), then its
// conjugates (x, -y); the point G^k, k < 2^31, is lo[k mod 2^16] *
// hi[k / 2^16] (one circle multiplication). No domain-point array and no
// intermediate live in device memory: the only allocation is the output.
//
// What bounds it on the card: integer instructions, near the bytes. A
// point reads 4 bytes a column and writes 16, and takes per group 4 M31
// products a member for the weighted sum, 12 for B * py and the vanishing
// line, one QM31 inverse (one M31 inversion, an addition chain of 42
// products, inside about 14 more) and one QM31 product (16), beside the
// point's circle multiplication (4). The design spends nothing else: one
// thread a point, every value a canonical uint32 in registers, each product
// m31::mul (one 32 x 32 -> 64-bit multiply and a Mersenne fold), the table
// words read through the read-only path (the same address across a warp),
// the columns' reads and the output's writes coalesced.

#include <cstdint>
#include <cuda_runtime.h>

#include "m31.cuh"
#include "qm31.cuh"

namespace {

using qm31::Qm;

constexpr int kThreads = 256;
constexpr int kMaxLogSize = qm31::kMaxLogSize;
constexpr int kHeaderWords = 21; // n_members, A, B, dy, dx, vc
constexpr int kMemberWords = 5;  // column index, w

struct Args {
  const uint32_t* const* cols;
  const uint32_t* groups;
  int n_groups;
  const uint2* lo;
  const uint2* hi;
  int log_size;
  uint32_t offset;
  uint32_t n;
  uint32_t* out;  // (4, n)
};

__global__ void __launch_bounds__(kThreads) quotients_kernel(const Args a) {
  const uint32_t t = blockIdx.x * kThreads + threadIdx.x;
  if (t >= a.n) return;
  uint32_t px, py;
  qm31::domain_point(a.offset + t, a.log_size, a.lo, a.hi, px, py);
  Qm acc = {0u, 0u, 0u, 0u};
  const uint32_t* g = a.groups;
#pragma unroll 1
  for (int grp = 0; grp < a.n_groups; ++grp) {
    const int members = static_cast<int>(__ldg(g));
    const Qm A = qm31::load_qm(g + 1), B = qm31::load_qm(g + 5), dy = qm31::load_qm(g + 9),
             dx = qm31::load_qm(g + 13), vc = qm31::load_qm(g + 17);
    g += kHeaderWords;
    Qm wf = {0u, 0u, 0u, 0u};
#pragma unroll 1
    for (int m = 0; m < members; ++m, g += kMemberWords) {
      const uint32_t f = __ldg(a.cols[__ldg(g)] + t);
      wf.a = m31::add(wf.a, m31::mul(__ldg(g + 1), f));
      wf.b = m31::add(wf.b, m31::mul(__ldg(g + 2), f));
      wf.c = m31::add(wf.c, m31::mul(__ldg(g + 3), f));
      wf.d = m31::add(wf.d, m31::mul(__ldg(g + 4), f));
    }
    const Qm num = {m31::sub(wf.a, m31::add(A.a, m31::mul(B.a, py))),
                    m31::sub(wf.b, m31::add(A.b, m31::mul(B.b, py))),
                    m31::sub(wf.c, m31::add(A.c, m31::mul(B.c, py))),
                    m31::sub(wf.d, m31::add(A.d, m31::mul(B.d, py)))};
    const Qm van = {m31::add(m31::sub(m31::mul(dy.a, px), m31::mul(dx.a, py)), vc.a),
                    m31::add(m31::sub(m31::mul(dy.b, px), m31::mul(dx.b, py)), vc.b),
                    m31::add(m31::sub(m31::mul(dy.c, px), m31::mul(dx.c, py)), vc.c),
                    m31::add(m31::sub(m31::mul(dy.d, px), m31::mul(dx.d, py)), vc.d)};
    acc = qm31::qm_add(acc, qm31::qm_mul(num, qm31::qm_inv(van)));
  }
  a.out[t] = acc.a;
  a.out[a.n + t] = acc.b;
  a.out[2ull * a.n + t] = acc.c;
  a.out[3ull * a.n + t] = acc.d;
}

}  // namespace

extern "C" int quotients_max_log_size() { return kMaxLogSize; }

// table: n_cols column pointers (8 bytes each), then group_words words of
// the groups as laid out above, in device memory; out: (4, n) words.
// Returns the CUDA error (cudaErrorInvalidValue for arguments the kernel
// does not take).
extern "C" int quotients_accumulate(const void* table, int n_cols, int n_groups,
                                    long long group_words, const void* lo, const void* hi,
                                    int log_size, long long offset, long long n, void* out,
                                    void* stream) {
  if (log_size < 1 || log_size > kMaxLogSize || n < 1 || offset < 0 ||
      offset + n > (1ll << log_size) || n_cols < 1 || n_groups < 1 ||
      group_words < static_cast<long long>(n_groups) * (kHeaderWords + kMemberWords)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Args a;
  a.cols = static_cast<const uint32_t* const*>(table);
  a.groups = reinterpret_cast<const uint32_t*>(a.cols + n_cols);
  a.n_groups = n_groups;
  a.lo = static_cast<const uint2*>(lo);
  a.hi = static_cast<const uint2*>(hi);
  a.log_size = log_size;
  a.offset = static_cast<uint32_t>(offset);
  a.n = static_cast<uint32_t>(n);
  a.out = static_cast<uint32_t*>(out);
  const unsigned int blocks = static_cast<unsigned int>((n + kThreads - 1) / kThreads);
  quotients_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
