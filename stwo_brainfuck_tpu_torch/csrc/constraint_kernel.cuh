// The constraint kernels' skeleton for Hopper (sm_90a): one thread a row,
// the component's body (generated into csrc/constraints.cu by
// ops/constraint_codegen.py) in between.
//
// composition replaces stwo_brainfuck_tpu/framework/component.py:520
// _constraints_fn, the JAX package's one fused executable a component: at
// each storage position i = offset + t of the component's blown-up domain
// (size 2^(n + log_blowup), n its log_size)
//
//   acc[:, t] (+)= (sum_i alpha^(a + i) * C_i(p)) * V_n(p)^-1
//
// with V_n(p) = pi^(n - 1)(p.x), pi(x) = 2x^2 - 1. On the blown-up domain
// V_n takes 2^log_blowup values, one a block of 2^n storage positions
// (core/poly.py vanishing_inverse_blocks): the host puts their inverses at
// the end of the launch's constant table and a row reads word i >> n, so
// no vanishing or domain-point array exists and no row inverts. S(p - g),
// the one masked value, is read from 4 rows at rot[i] (rot the int32
// rotation index of the whole domain) or, with rot null, at t (rows a
// shard was given).
//
// logup replaces the fraction half of :372 _build_interaction_fn: at each
// row t, den_k = sum_j alpha^j v_j - z, Q_k = num_k * den_k^-1 of every
// relation, written as int32 (4, n) columns q[k], and their sum `total`
// (the prefix sum over it stays a torch op, as in the JAX package).
//
// The plain versions are framework/component.py composition_contribution
// and logup_fractions_plain (the Expr path), bit for bit: every value is
// canonical mod p, so any exact evaluation order gives the same words.
//
// What bounds them on the card: bytes or integer instructions, by component
// (chip_smoke.py's constraints line says which). A row reads 4 bytes a
// column (C main columns, is_first, 4 (K + 1) interaction rows, the rotation
// index, the accumulator) and writes 16; it takes the program's products (a
// QM31 product 16, a QM31 x M31 4, a relation's denominator 4 a value, the
// QM31 inverse of logup 62) and, for composition, 4 or 16 a constraint's
// weight and 4 for V_n^-1. The design spends nothing else: every value in
// registers, the constants (weights, alpha powers, z, claimed sum, V_n^-1)
// read through the read-only path at one address a warp, the columns' loads
// and the stores coalesced, one launch a component.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#include "m31.cuh"
#include "qm31.cuh"

namespace constraints {

using qm31::Qm;

constexpr int kThreads = 256;

// One row's view of a launch's tables.
struct Row {
  const unsigned long long* ptrs;  // the column pointers
  const uint32_t* consts;          // the constant words
  uint32_t t;                      // this row in every column
  uint32_t s_row;                  // the row of S(p - g) in its rows

  __device__ __forceinline__ const uint32_t* ptr(int slot) const {
    return reinterpret_cast<const uint32_t*>(__ldg(ptrs + slot));
  }
  __device__ __forceinline__ uint32_t col(int slot) const { return __ldg(ptr(slot) + t); }
  __device__ __forceinline__ Qm qcol(int slot) const {
    return {col(slot), col(slot + 1), col(slot + 2), col(slot + 3)};
  }
  __device__ __forceinline__ Qm s_prev(int slot) const {
    return {__ldg(ptr(slot) + s_row), __ldg(ptr(slot + 1) + s_row), __ldg(ptr(slot + 2) + s_row),
            __ldg(ptr(slot + 3) + s_row)};
  }
  __device__ __forceinline__ Qm konst(int word) const { return qm31::load_qm(consts + word); }
};

// The constant table's layout (ops/constraint_codegen.py): the lookup
// elements (memory 3 powers and z, instruction 3 and z, processor 7 and z),
// the claimed sum, the weights, then (composition) the 2^log_blowup words
// of V_n^-1.
constexpr int kElementWords = 64;
constexpr int kClaimedWord = kElementWords;
constexpr int kWeightsWord = kClaimedWord + 4;

struct CompositionArgs {
  const unsigned long long* ptrs;
  const uint32_t* consts;
  const uint32_t* v_inv;  // V_n^-1 of the 2^log_blowup blocks of 2^n positions
  const int32_t* rot;     // null: S(p - g) at row t of its rows
  int log_size;           // n
  uint32_t offset;
  uint32_t n;     // rows
  uint32_t* acc;  // (4, rows)
  int accumulate;
};

template <class C>
__global__ void __launch_bounds__(kThreads) composition_kernel(const CompositionArgs a) {
  const uint32_t t = blockIdx.x * kThreads + threadIdx.x;
  if (t >= a.n) return;
  const uint32_t pos = a.offset + t;
  const Row r{a.ptrs, a.consts, t, a.rot ? static_cast<uint32_t>(__ldg(a.rot + pos)) : t};
  Qm acc = qm31::qm_mul_m31(C::composition(r), __ldg(a.v_inv + (pos >> a.log_size)));
  uint32_t* out = a.acc + t;
  const size_t n = a.n;
  if (a.accumulate) acc = qm31::qm_add(acc, {out[0], out[n], out[2 * n], out[3 * n]});
  out[0] = acc.a;
  out[n] = acc.b;
  out[2 * n] = acc.c;
  out[3 * n] = acc.d;
}

struct LogupArgs {
  const unsigned long long* ptrs;
  const uint32_t* consts;
  uint32_t n;
  uint32_t* q;      // (K, 4, n)
  uint32_t* total;  // (4, n)
};

template <class C>
__global__ void __launch_bounds__(kThreads) logup_kernel(const LogupArgs a) {
  const uint32_t t = blockIdx.x * kThreads + threadIdx.x;
  if (t >= a.n) return;
  const Row r{a.ptrs, a.consts, t, t};
  Qm q[C::kRelations];
  C::logup(r, q);
  const size_t n = a.n;
  Qm total = q[0];
#pragma unroll
  for (int k = 0; k < C::kRelations; ++k) {
    if (k) total = qm31::qm_add(total, q[k]);
    uint32_t* out = a.q + 4 * k * n + t;
    out[0] = q[k].a;
    out[n] = q[k].b;
    out[2 * n] = q[k].c;
    out[3 * n] = q[k].d;
  }
  a.total[t] = total.a;
  a.total[n + t] = total.b;
  a.total[2 * n + t] = total.c;
  a.total[3 * n + t] = total.d;
}

template <class C>
constexpr int composition_slots() {
  return C::kColumns + 1 + 4 * (C::kRelations + 1) + 4;
}

template <class C>
int shape_of(int* out) {
  out[0] = C::kColumns;
  out[1] = C::kRelations;
  out[2] = C::kConstraints;
  out[3] = composition_slots<C>();
  out[4] = kWeightsWord + 4 * C::kConstraints;  // and 2^log_blowup words of V_n^-1
  return 0;
}

inline unsigned int blocks(long long n) {
  return static_cast<unsigned int>((n + kThreads - 1) / kThreads);
}

// table: n_ptrs column pointers (8 bytes each), then n_words constant
// words, in device memory. Returns the CUDA error (cudaErrorInvalidValue for
// arguments the kernel does not take).
template <class C>
int composition_entry(const void* table, int n_ptrs, int n_words, const void* rot, int log_size,
                      int log_blowup, long long offset, long long n, void* acc, int accumulate,
                      void* stream) {
  const int eval_log = log_size + log_blowup;
  if (n_ptrs != composition_slots<C>() || log_size < 1 || log_blowup < 0 ||
      eval_log > qm31::kMaxLogSize ||
      n_words != kWeightsWord + 4 * C::kConstraints + (1 << log_blowup) || n < 1 || offset < 0 ||
      offset + n > (1ll << eval_log)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  CompositionArgs a;
  a.ptrs = static_cast<const unsigned long long*>(table);
  a.consts = reinterpret_cast<const uint32_t*>(a.ptrs + n_ptrs);
  a.v_inv = a.consts + kWeightsWord + 4 * C::kConstraints;
  a.rot = static_cast<const int32_t*>(rot);
  a.log_size = log_size;
  a.offset = static_cast<uint32_t>(offset);
  a.n = static_cast<uint32_t>(n);
  a.acc = static_cast<uint32_t*>(acc);
  a.accumulate = accumulate;
  composition_kernel<C><<<blocks(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <class C>
int logup_entry(const void* table, int n_ptrs, int n_words, long long n, void* q, void* total,
                void* stream) {
  if (n_ptrs != C::kColumns + 1 || n_words != kElementWords || n < 1 || n > (1ll << 31)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  LogupArgs a;
  a.ptrs = static_cast<const unsigned long long*>(table);
  a.consts = reinterpret_cast<const uint32_t*>(a.ptrs + n_ptrs);
  a.n = static_cast<uint32_t>(n);
  a.q = static_cast<uint32_t*>(q);
  a.total = static_cast<uint32_t*>(total);
  logup_kernel<C><<<blocks(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace constraints
