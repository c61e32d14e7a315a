// The constraint kernels' skeleton for Hopper (sm_90a): one thread a row,
// the component's body (generated into csrc/constraints.cu by
// ops/constraint_codegen.py) in between.
//
// composition replaces stwo_brainfuck_tpu/framework/component.py:520
// _constraints_fn, the JAX package's one fused executable a component, for
// every component of a prove in one launch: at each storage position
// i = offset + t of a segment (the rows of one size's blown-up domain of
// 2^(n + log_blowup) positions, n its log_size, or a shard's chunk of them)
//
//   acc[:, t] = (sum_components sum_i alpha^(a + i) * C_i(p)) * V_n(p)^-1
//
// with V_n(p) = pi^(n - 1)(p.x), pi(x) = 2x^2 - 1. The launch's table
// (ops/constraint_kernels.py plan_composition) lists the segments, each
// with its components in the claim's order; the grid is flat, a block
// kThreads rows of one segment (each segment's blocks after the last's),
// and a thread evaluates every component of its segment at its row and
// sums them in registers. All of them share n, so the thread multiplies by
// V_n^-1 once and writes acc once, never reading it. On the blown-up domain
// V_n takes 2^log_blowup values, one a block of 2^n storage positions
// (core/poly.py vanishing_inverse_blocks): the host puts their inverses in
// the table and a row reads word i >> n, so no vanishing or domain-point
// array exists and no row inverts. S(p - g), the one masked value, is read
// from 4 rows at rot[i] (rot the int32 rotation index of the whole domain)
// or, with rot null, at t (rows a shard was given); is_first and the
// rotation are read once a row for all the segment's components.
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
// (chip_smoke.py's constraints line says which). A composition row reads 4
// bytes a column (each component's C main columns and 4 (K + 1)
// interaction rows, and once is_first and the rotation index) and writes
// 16; it takes the program's products (a QM31 product 16, a QM31 x M31 4,
// a relation's denominator 4 a value, the QM31 inverse 20 and its share of
// a batch's), 4 or 16 a constraint's weight and 4 a segment for V_n^-1.
// The design spends nothing else: every value in registers, the constants
// (weights, alpha powers, z, claimed sum, V_n^-1) read through the
// read-only path at one address a warp, the columns' loads and the stores
// coalesced, the weighted sum of all the constraints one 64-bit sum of
// products a coordinate (a QM31-valued constraint's weight as the 4 x 4
// matrix of the product by it), folded every four products and reduced
// once, the LogUp denominators reduced every four, one composition launch
// a prove.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#include "logup_scan.cuh"
#include "m31.cuh"
#include "qm31.cuh"

namespace constraints {

using qm31::Qm;

constexpr int kThreads = 256;

// The constant words (ops/constraint_codegen.py): the lookup elements
// (memory 3 powers and z, instruction 3 and z, processor 7 and z), shared;
// a component's own composition words: the claimed sum, then its weights
// (an M31-valued constraint's alpha^(a + i), 4 words; a QM31-valued one's
// 4 x 4 matrix of the product by it, row-major).
constexpr int kElementWords = 64;
constexpr int kOwnWeights = 4;

// The product policy of the composition bodies' QM31 products (m31.cuh:
// Product or Doubled).
using CompositionProduct = m31::Doubled;

// One row's view of a component in the composition launch.
struct Row {
  const unsigned long long* ptrs;  // the component's column pointers
  const uint32_t* consts;          // the lookup elements' words
  const uint32_t* own;             // the component's claimed sum and weights
  uint32_t t;                      // this row in every column
  uint32_t s_row;                  // the row of S(p - g) in its rows
  uint32_t first;                  // is_first at this row

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
  __device__ __forceinline__ uint32_t is_first() const { return first; }
  __device__ __forceinline__ Qm own_qm(int word) const { return qm31::load_qm(own + word); }
  // word w of the weights (ops/constraint_codegen.py weight_words)
  __device__ __forceinline__ uint32_t weight(int w) const { return __ldg(own + kOwnWeights + w); }
};

// The composition launch's table (ops/constraint_kernels.py
// plan_composition), 8-byte words: a header, a segment's words each, a
// component's words each, the column pointers, then the uint32 constant
// words (the lookup elements first; each component's own words; each
// segment's 2^log_blowup words of V_n^-1).
constexpr int kCompHeaderWords = 4;
constexpr int kSegmentWords = 10;
constexpr int kMemberWords = 3;
enum : int { kCompSegments = 0, kCompBlocks, kCompMembers, kCompConsts };
enum : int {
  kSegFirstBlock = 0, kSegRows, kSegOffset, kSegLogSize, kSegRot, kSegAcc, kSegIsFirst,
  kSegFirstMember, kSegMembers, kSegVinv,
};
// a component's index, its first pointer's word, its own words' first word
enum : int { kMemComponent = 0, kMemPtrs, kMemOwn };

// A thread's row: its segment by blockIdx.x, the segment's components by
// D::composition(id, row).
template <class D>
__device__ __forceinline__ void composition_row(const unsigned long long* __restrict__ table) {
  const uint32_t b = blockIdx.x;
  const int segments = static_cast<int>(__ldg(table + kCompSegments));
  const unsigned long long* seg = table + kCompHeaderWords;
  int s = 0;
  while (s + 1 < segments && __ldg(seg + (s + 1) * kSegmentWords + kSegFirstBlock) <= b) ++s;
  seg += s * kSegmentWords;
  const uint32_t t =
      (b - static_cast<uint32_t>(__ldg(seg + kSegFirstBlock))) * kThreads + threadIdx.x;
  const uint32_t rows = static_cast<uint32_t>(__ldg(seg + kSegRows));
  if (t >= rows) return;
  const uint32_t pos = static_cast<uint32_t>(__ldg(seg + kSegOffset)) + t;
  const uint32_t* consts = reinterpret_cast<const uint32_t*>(table + __ldg(table + kCompConsts));
  const unsigned long long* members = table + kCompHeaderWords + segments * kSegmentWords;
  const int32_t* rot = reinterpret_cast<const int32_t*>(__ldg(seg + kSegRot));
  const uint32_t s_row = rot ? static_cast<uint32_t>(__ldg(rot + pos)) : t;
  const uint32_t first = __ldg(reinterpret_cast<const uint32_t*>(__ldg(seg + kSegIsFirst)) + t);
  const int m0 = static_cast<int>(__ldg(seg + kSegFirstMember));
  const int m1 = m0 + static_cast<int>(__ldg(seg + kSegMembers));
  Qm sum = {0u, 0u, 0u, 0u};
  for (int j = m0; j < m1; ++j) {
    const unsigned long long* mem = members + j * kMemberWords;
    const Row r{table + __ldg(mem + kMemPtrs), consts, consts + __ldg(mem + kMemOwn), t, s_row,
                first};
    sum = qm31::qm_add(sum, D::composition(static_cast<int>(__ldg(mem + kMemComponent)), r));
  }
  const int log_size = static_cast<int>(__ldg(seg + kSegLogSize));
  const uint32_t v_inv = __ldg(consts + __ldg(seg + kSegVinv) + (pos >> log_size));
  const Qm acc = qm31::qm_mul_m31<CompositionProduct>(sum, v_inv);
  uint32_t* out = reinterpret_cast<uint32_t*>(__ldg(seg + kSegAcc)) + t;
  const size_t n = rows;
  out[0] = acc.a;
  out[n] = acc.b;
  out[2 * n] = acc.c;
  out[3 * n] = acc.d;
}

// 4 blocks an SM (at most 64 registers, no spills): measured faster than
// the 3 that the bodies' 80 registers allow (tools/composition_limiter.py).
template <class D>
__global__ void __launch_bounds__(kThreads, 4) composition_kernel(
    const unsigned long long* __restrict__ table) {
  composition_row<D>(table);
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
  return C::kColumns + 4 * (C::kRelations + 1) + 4;
}

template <class C>
int shape_of(int* out) {
  out[0] = C::kColumns;
  out[1] = C::kRelations;
  out[2] = C::kConstraints;
  out[3] = composition_slots<C>();
  out[4] = C::kOwnWords;
  return 0;
}

inline unsigned int blocks(long long n) {
  return static_cast<unsigned int>((n + kThreads - 1) / kThreads);
}

// table: the composition launch's table in device memory
// (plan_composition), `blocks` its blocks. Returns the CUDA error
// (cudaErrorInvalidValue for arguments the kernel does not take).
template <class D>
int composition_entry(const void* table, long long blocks, void* stream) {
  if (table == nullptr || blocks < 1 || blocks > 0x7fffffffll) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  composition_kernel<D><<<static_cast<unsigned>(blocks), kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned long long*>(table));
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
