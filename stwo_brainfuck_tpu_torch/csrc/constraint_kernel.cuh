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
// interaction replaces the whole of :372 _build_interaction_fn on one
// device, in one launch: at each row t, den_k = sum_j alpha^j v_j - z and
// Q_k = num_k * den_k^-1 of every relation, written as int32 (4, n) columns
// q[k], and S, their sum's prefix sum in coset linear order, with the
// claimed sum. It is the coset scan of csrc/logup_scan.cuh with the rows'
// sums computed in the tile (FractionSource): a lane computes the fractions
// of its pair's four storage rows (2j, 2j + 1, N - 2 - 2j, N - 1 - 2j),
// stores the Q_k words as uint2 (every sector whole) and hands the scan
// their sums, so no row sum goes through device memory where the tile's sums
// fit on chip. is_first is t == 0 (storage row 0 is the first point).
//
// logup (the mesh's shards, whose columns are in linear order: no coset
// scan) writes the Q_k and their sum `total`; the prefix sum is a scan
// launch over the gathered sums.
//
// Both invert in batches: the emitted body is split into the denominators
// and the products by the inverses, and a thread inverts the norms of the K
// relations of kBatchRows rows with one m31_inv (qm31::batch_inv): a
// relation's inverse costs 20 products plus 3 (M - 1) + 42 a batch of M =
// K kBatchRows, where qm31::qm_inv costs 62. Bit for bit qm_inv, 0 -> 0.
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
// QM31 inverse 20 and its share of a batch's) and, for composition, 4 or 16
// a constraint's weight and 4 for V_n^-1. The design spends nothing else: every value in
// registers, the constants (weights, alpha powers, z, claimed sum, V_n^-1)
// read through the read-only path at one address a warp, the columns' loads
// and the stores coalesced, one launch a component.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#include "logup_scan.cuh"
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

constexpr int kBatchRows = 4;  // rows whose norms one m31_inv inverts (1, 2 or 4)
constexpr int kLogupRows = 4;  // rows a thread of the logup kernel

// One row's view of the interaction bodies: the main columns at row t, the
// constants, and is_first, a column's slot (first >= 0) or t == 0.
struct FractionRow {
  const unsigned long long* ptrs;
  const uint32_t* consts;
  uint32_t t;
  int first;

  __device__ __forceinline__ uint32_t col(int slot) const {
    return __ldg(reinterpret_cast<const uint32_t*>(__ldg(ptrs + slot)) + t);
  }
  __device__ __forceinline__ uint32_t is_first() const {
    return first >= 0 ? col(first) : static_cast<uint32_t>(t == 0);
  }
  __device__ __forceinline__ Qm konst(int word) const { return qm31::load_qm(consts + word); }
};

// The fractions Q_k of kB rows, q[first + b] for row r[b], their norms
// inverted together.
template <class C, int kB, int kN>
__device__ __forceinline__ void fractions_batch(const FractionRow (&r)[kB],
                                                Qm (&q)[kN][C::kRelations], int first) {
  constexpr int K = C::kRelations;
  Qm den[kB][K];
  qm31::Cm cd[kB][K];
  uint32_t norm[kB * K], ninv[kB * K];
#pragma unroll
  for (int b = 0; b < kB; ++b) {
    C::denominators(r[b], den[b]);
#pragma unroll
    for (int k = 0; k < K; ++k) {
      cd[b][k] = qm31::qm_inv_den(den[b][k]);
      norm[b * K + k] = qm31::cm_norm(cd[b][k]);
    }
  }
  qm31::batch_inv<kB * K>(norm, ninv);
#pragma unroll
  for (int b = 0; b < kB; ++b) {
    Qm inv[K];
#pragma unroll
    for (int k = 0; k < K; ++k) inv[k] = qm31::qm_inv_from(den[b][k], cd[b][k], ninv[b * K + k]);
    C::fractions(r[b], inv, q[first + b]);
  }
}

struct LogupArgs {
  const unsigned long long* ptrs;
  const uint32_t* consts;
  uint32_t n;
  uint32_t* q;      // (K, 4, n)
  uint32_t* total;  // (4, n)
};

// kLogupRows rows a thread, a CTA's rows consecutive, a warp's loads and
// stores coalesced; past n a thread repeats row n - 1 and stores nothing.
template <class C>
__global__ void __launch_bounds__(kThreads) logup_kernel(const LogupArgs a) {
  constexpr int K = C::kRelations;
  constexpr int kB = kBatchRows;
  const size_t n = a.n;
  const uint32_t base = blockIdx.x * (kThreads * kLogupRows) + threadIdx.x;
#pragma unroll
  for (int g = 0; g < kLogupRows; g += kB) {
    FractionRow r[kB];
#pragma unroll
    for (int b = 0; b < kB; ++b) {
      const uint32_t t = base + (g + b) * kThreads;
      r[b] = {a.ptrs, a.consts, t < a.n ? t : a.n - 1, C::kColumns};
    }
    Qm q[kB][K];
    fractions_batch<C, kB, kB>(r, q, 0);
#pragma unroll
    for (int b = 0; b < kB; ++b) {
      const uint32_t t = base + (g + b) * kThreads;
      if (t >= a.n) continue;
      Qm total = q[b][0];
#pragma unroll
      for (int k = 0; k < K; ++k) {
        if (k) total = qm31::qm_add(total, q[b][k]);
        uint32_t* out = a.q + 4 * k * n + t;
        out[0] = q[b][k].a;
        out[n] = q[b][k].b;
        out[2 * n] = q[b][k].c;
        out[3 * n] = q[b][k].d;
      }
      a.total[t] = total.a;
      a.total[n + t] = total.b;
      a.total[2 * n + t] = total.c;
      a.total[3 * n + t] = total.d;
    }
  }
}

// The coset scan's row source of the interaction kernel: pair j's four
// storage rows' fractions, their Q_k stored, their sums handed on.
template <class C>
struct FractionSource {
  struct Args {
    const unsigned long long* ptrs;
    const uint32_t* consts;
    uint32_t* q;  // (K, 4, N)
  };
  static constexpr bool kKeepsSums = true;

  static __device__ __forceinline__ void pair(const Args& a, int log_n, uint32_t j,
                                              uint2 (&x)[4], uint2 (&y)[4]) {
    constexpr int K = C::kRelations;
    const size_t n = size_t(1) << log_n;
    const uint32_t rows[4] = {2 * j, 2 * j + 1, static_cast<uint32_t>(n) - 2 - 2 * j,
                              static_cast<uint32_t>(n) - 1 - 2 * j};
    constexpr int kB = kBatchRows;
    Qm q[4][K];
#pragma unroll
    for (int g = 0; g < 4; g += kB) {
      FractionRow r[kB];
#pragma unroll
      for (int b = 0; b < kB; ++b) r[b] = {a.ptrs, a.consts, rows[g + b], -1};
      fractions_batch<C, kB, 4>(r, q, g);
    }
    Qm sum[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      sum[i] = q[i][0];
#pragma unroll
      for (int k = 1; k < K; ++k) sum[i] = qm31::qm_add(sum[i], q[i][k]);
    }
#pragma unroll
    for (int k = 0; k < K; ++k) {
      uint32_t* out = a.q + 4 * k * n;
      const uint32_t lo[4][2] = {{q[0][k].a, q[1][k].a}, {q[0][k].b, q[1][k].b},
                                 {q[0][k].c, q[1][k].c}, {q[0][k].d, q[1][k].d}};
      const uint32_t hi[4][2] = {{q[2][k].a, q[3][k].a}, {q[2][k].b, q[3][k].b},
                                 {q[2][k].c, q[3][k].c}, {q[2][k].d, q[3][k].d}};
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        *reinterpret_cast<uint2*>(out + c * n + 2 * j) = make_uint2(lo[c][0], lo[c][1]);
        *reinterpret_cast<uint2*>(out + c * n + n - 2 - 2 * j) = make_uint2(hi[c][0], hi[c][1]);
      }
    }
    x[0] = make_uint2(sum[0].a, sum[1].a);
    x[1] = make_uint2(sum[0].b, sum[1].b);
    x[2] = make_uint2(sum[0].c, sum[1].c);
    x[3] = make_uint2(sum[0].d, sum[1].d);
    y[0] = make_uint2(sum[2].a, sum[3].a);
    y[1] = make_uint2(sum[2].b, sum[3].b);
    y[2] = make_uint2(sum[2].c, sum[3].c);
    y[3] = make_uint2(sum[2].d, sum[3].d);
  }
};

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
  logup_kernel<C><<<blocks((n + kLogupRows - 1) / kLogupRows), kThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// out: col_log, row_log, tile_rows, tiles, rows_per_warp, on_chip of the
// interaction launch of 2^log_n rows on the current device, and the
// resident tiles it was planned for.
template <class C>
int interaction_geometry_of(int log_n, int* out) {
  if (log_n < 2 || log_n > 30) return static_cast<int>(cudaErrorInvalidValue);
  const logup_scan::Geometry g = logup_scan::plan<FractionSource<C>>(log_n);
  out[0] = g.col_log;
  out[1] = g.row_log;
  out[2] = g.tile_rows;
  out[3] = g.tiles;
  out[4] = g.rows_per_warp;
  out[5] = g.on_chip;
  out[6] = logup_scan::resident_tiles<FractionSource<C>, false>(0);
  return static_cast<int>(cudaGetLastError());
}

// table: the C main column pointers, then the element words; q (K, 4, N),
// s (4, N), claimed 4 words; work: 2 tiles x 256 words; sums: (4, N)
// words, used when not on chip.
template <class C>
int interaction_entry(const void* table, int n_ptrs, int n_words, int log_n, void* q, void* s,
                      void* claimed, void* work, void* sums, void* stream) {
  if (n_ptrs != C::kColumns || n_words != kElementWords || log_n < 2 || log_n > 30) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  typename FractionSource<C>::Args src;
  src.ptrs = static_cast<const unsigned long long*>(table);
  src.consts = reinterpret_cast<const uint32_t*>(src.ptrs + n_ptrs);
  src.q = static_cast<uint32_t*>(q);
  logup_scan::ScanArgs a;
  a.s = static_cast<uint32_t*>(s);
  a.claimed = static_cast<uint32_t*>(claimed);
  a.log_n = log_n;
  a.g = logup_scan::plan<FractionSource<C>>(log_n);
  a.agg = static_cast<uint32_t*>(work);
  a.incl = a.agg + static_cast<size_t>(a.g.tiles) * logup_scan::kVec;
  a.sums = static_cast<uint32_t*>(sums);
  if (!a.g.on_chip && !sums) return static_cast<int>(cudaErrorInvalidValue);
  return logup_scan::launch<FractionSource<C>>(src, a, static_cast<cudaStream_t>(stream));
}

}  // namespace constraints
