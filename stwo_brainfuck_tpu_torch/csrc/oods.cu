// The OODS samples of every (trace log, shift) group of a prove in one
// launch, for Hopper (sm_90a).
//
// Replaces stwo_brainfuck_tpu/core/poly.py:76 _sample_tensor_jit, the one
// small XLA program a group that the JAX package dispatches before its one
// pull (its air.py:745-760); jnp, not Pallas. The port's plain version is
// core/poly.py sample_tensor, bit for bit.
//
// A group g has a trace log n_g, a QM31 point z_g and member rows, each the
// 2^n_g circle-FFT coefficients of a committed column. Its samples are
//
//   out[:, c] = sum_j row_c[j] * basis_g[j],  basis_g[j] = prod_{k: bit k of j} f_g[k]
//
// in QM31, f_g = [y, x, pi(x), pi^2(x), ...] at z_g (core/poly.py
// _point_factors). The basis factors as b_lo[j mod L] * b_hi[j / L], L =
// 2^(n_g / 2) (b_lo the product of the factors the low bits select, b_hi of
// the high bits'), so
//
//   out[:, c] = sum_l b_lo[l] * (sum_h row_c[h L + l] * b_hi[h]).
//
// Inputs (the wrapper is ops/oods_kernels.py), one small device table of
// 32-bit words:
//   members  kMemberWords a sampled column: its row's pointer (two words),
//            log2 of its length n (the whole row, or a mesh shard's chunk
//            of it), the offset of its first coefficient in the row, the
//            index of its first block, its output column and its group.
//   groups   kGroupWords a group: n_g and the word index of its factors;
//   factors  n_g QM31 values a group (four words each).
// Nothing else crosses PCIe: no basis array exists.
//
// Schedule (ops/oods_kernels.py schedule mirrors it). A row's n
// coefficients are an (H_n, L_n) matrix, L_n = min(n, L), H_n = n / L_n (its
// global index j = offset + h L_n + l has basis column j mod L and row
// j / L). A block of 256 threads takes a tile of it: a stripe of W =
// min(L_n, 256) columns and H_b = min(H_n, 2^16 / W) rows; thread (r, w)
// takes column w and rows r, r + R, ... of the tile (R = 256 / W), so
// every row of the tile is read as 4 W contiguous bytes by the block. A
// thread sums row[h, l] * b_hi[h] over its rows (M31 times QM31: four
// products, held in 64 bits and reduced every four rows, m31::mac and
// m31::reduce64), multiplies the sum by b_lo[l] (one QM31 product) and the
// block sums its threads' values (warp shuffles, then the warps). The
// block builds its rows' b_hi in shared memory and each thread its
// column's b_lo in registers, each as the product of the factors its bits
// select (at most n_g - n_g / 2 QM31 products). A tile of 2^16 positions (256 rows a thread at W = 256)
// keeps a thread's b_lo (up to 12 QM31 products) a small part of its row
// products (4 M31 products a row); at 2^13 positions (32 rows) the b_lo
// products outnumbered them (tools/oods_variants.py times the tiles).
//
// Points. A column opened at several points (shifts) of one trace log is
// one member a point, its words read once a point. Reading them once for
// 2 or 4 points (an accumulator and a b_hi tile a point) was slower on an
// H100 at the OODS launch of a default fib19_io, a big22 and a production
// prove: 14 to 44 registers more and 2 to 4 times the shared memory, so
// fewer blocks are resident, and the kernel is not bound by its bytes.
//
// What bounds it: not its bytes. On an H100 it runs at 33-45 % of its
// bytes bound at the OODS launches of a default fib19_io, a big22 and a
// production prove (tools/oods_variants.py); each coefficient costs four
// 64-bit multiply-adds and a shared-memory read of its b_hi, which
// the integer pipes issue below one a clock (the quotient kernel's
// reading), and no profiler runs on the card to say more.
//
// Sums across blocks: each block adds its four words to its column of a
// 64-bit scratch (atomicAdd: canonical words, under 2^31 each, and fewer
// than 2^32 blocks, so no sum wraps); the last block of the launch (a
// counter behind the scratch) reduces every column mod p into the output
// and zeroes the scratch and the counter for the next launch. Any exact sum
// gives the same words, so the order of the blocks does not matter.

#include <cstdint>
#include <cuda_runtime.h>

#include "m31.cuh"
#include "qm31.cuh"

namespace {

using qm31::Qm;

constexpr int kThreads = 256;
constexpr int kThreadsLog = 8;
constexpr int kTileLog = 16;        // positions a block takes at most
constexpr int kMaxRowsLog = 9;      // H_b <= 2^9 (H_n <= 2 L_n when L_n < 256; 2^8 at W = 256)
constexpr int kMemberWords = 7;     // pointer (2), log n, offset, first block, column, group
constexpr int kGroupWords = 2;      // n_g, factor word index
constexpr int kMaxLogSize = 30;

struct Args {
  const uint32_t* table;  // members, then groups, then factors
  int n_members;
  int n_groups;
  int total;              // output columns
  unsigned long long* scratch;  // (4, total) sums, then the block counter
  uint32_t* out;          // (4, total) int32 words
};

struct Tile {
  int lo;        // log2 L
  int log_ln;    // log2 L_n
  int log_w;     // log2 W
  int log_hb;    // log2 H_b
  int stripes_log;
};

__device__ __forceinline__ Tile tile_of(int log_size, int log_n) {
  Tile t;
  t.lo = log_size / 2;
  t.log_ln = min(log_n, t.lo);
  t.log_w = min(t.log_ln, kThreadsLog);
  const int log_hn = log_n - t.log_ln;
  t.log_hb = min(log_hn, kTileLog - t.log_w);
  t.stripes_log = t.log_ln - t.log_w;
  return t;
}

// The product of the factors f[first + k] over the set bits k of `bits`, in
// ascending k (any order gives the same value).
__device__ __forceinline__ Qm basis(const uint32_t* f, int first, uint32_t bits) {
  Qm acc = {1u, 0u, 0u, 0u};
  for (int k = 0; bits; ++k, bits >>= 1)
    if (bits & 1u) acc = qm31::qm_mul(acc, qm31::load_qm(f + 4 * (first + k)));
  return acc;
}

__device__ __forceinline__ Qm shfl_down(Qm v, int d) {
  return {__shfl_down_sync(0xffffffffu, v.a, d), __shfl_down_sync(0xffffffffu, v.b, d),
          __shfl_down_sync(0xffffffffu, v.c, d), __shfl_down_sync(0xffffffffu, v.d, d)};
}

__global__ void __launch_bounds__(kThreads) oods_kernel(const Args a) {
  __shared__ Qm hi_rows[1 << kMaxRowsLog];
  __shared__ Qm warp_sums[kThreads / 32];
  __shared__ bool last;
  // the block's member: the last whose first block is at or before ours
  const uint32_t b = blockIdx.x;
  int lo_m = 0, hi_m = a.n_members - 1;
  while (lo_m < hi_m) {
    const int mid = (lo_m + hi_m + 1) / 2;
    if (__ldg(a.table + mid * kMemberWords + 4) <= b) lo_m = mid; else hi_m = mid - 1;
  }
  const uint32_t* m = a.table + lo_m * kMemberWords;
  const uint32_t* row = reinterpret_cast<const uint32_t*>(
      static_cast<uintptr_t>(__ldg(m)) | (static_cast<uintptr_t>(__ldg(m + 1)) << 32));
  const int log_n = static_cast<int>(__ldg(m + 2));
  const uint32_t offset = __ldg(m + 3);
  const uint32_t k = b - __ldg(m + 4);  // the block's tile of the row
  const uint32_t column = __ldg(m + 5);
  const uint32_t* group = a.table + a.n_members * kMemberWords + __ldg(m + 6) * kGroupWords;
  const int log_size = static_cast<int>(__ldg(group));
  const uint32_t* f = a.table + __ldg(group + 1);
  const Tile t = tile_of(log_size, log_n);
  const uint32_t l0 = (k & ((1u << t.stripes_log) - 1u)) << t.log_w;
  const uint32_t h0 = (k >> t.stripes_log) << t.log_hb;
  const int hb = 1 << t.log_hb;
  const uint32_t mask_l = (1u << t.lo) - 1u;
  for (int r = threadIdx.x; r < hb; r += kThreads)
    hi_rows[r] = basis(f, t.lo, (offset + ((h0 + r) << t.log_ln)) >> t.lo);
  __syncthreads();
  const int w = threadIdx.x & ((1 << t.log_w) - 1);
  const int r0 = threadIdx.x >> t.log_w;
  const int rstep = kThreads >> t.log_w;
  Qm v = {0u, 0u, 0u, 0u};
  if (r0 < hb) {
    uint64_t acc[4] = {};
    int pending = 0;
    const uint32_t* p = row + ((h0 + r0) << t.log_ln) + l0 + w;
    for (int r = r0; r < hb; r += rstep, p += static_cast<size_t>(rstep) << t.log_ln) {
      const uint32_t x = __ldg(p);
      const Qm h = hi_rows[r];
      acc[0] = m31::mac(acc[0], x, h.a);
      acc[1] = m31::mac(acc[1], x, h.b);
      acc[2] = m31::mac(acc[2], x, h.c);
      acc[3] = m31::mac(acc[3], x, h.d);
      if (++pending == 4) {
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[q] = m31::reduce64(acc[q]);
        pending = 0;
      }
    }
    const Qm u = {m31::reduce64(acc[0]), m31::reduce64(acc[1]), m31::reduce64(acc[2]),
                  m31::reduce64(acc[3])};
    v = qm31::qm_mul(u, basis(f, 0, (offset + l0 + w) & mask_l));
  }
#pragma unroll
  for (int d = 16; d; d >>= 1) v = qm31::qm_add(v, shfl_down(v, d));
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = v;
  __syncthreads();
  if (threadIdx.x == 0) {
    Qm s = warp_sums[0];
#pragma unroll
    for (int i = 1; i < kThreads / 32; ++i) s = qm31::qm_add(s, warp_sums[i]);
    atomicAdd(a.scratch + column, static_cast<unsigned long long>(s.a));
    atomicAdd(a.scratch + a.total + column, static_cast<unsigned long long>(s.b));
    atomicAdd(a.scratch + 2 * a.total + column, static_cast<unsigned long long>(s.c));
    atomicAdd(a.scratch + 3 * a.total + column, static_cast<unsigned long long>(s.d));
    __threadfence();
    last = atomicAdd(a.scratch + 4 * a.total, 1ull) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  for (int i = threadIdx.x; i < 4 * a.total; i += kThreads)
    a.out[i] = m31::reduce64(atomicExch(a.scratch + i, 0ull));
  if (threadIdx.x == 0) atomicExch(a.scratch + 4 * a.total, 0ull);
}

}  // namespace

// The constants the wrapper keeps copies of: {kMaxLogSize, kMemberWords,
// kGroupWords} (ops/oods_kernels.py _bind checks them at load).
extern "C" void oods_constants(int* out) {
  out[0] = kMaxLogSize;
  out[1] = kMemberWords;
  out[2] = kGroupWords;
}

// The tile geometry of a row of 2^log_n coefficients in a group of trace log
// log_size: out = {log2 L, log2 L_n, log2 W, log2 H_b, blocks}
// (ops/oods_kernels.py schedule mirrors it).
extern "C" int oods_schedule(int log_size, int log_n, long long* out) {
  if (log_size < 1 || log_size > kMaxLogSize || log_n < 0 || log_n > log_size) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int lo = log_size / 2;
  const int log_ln = log_n < lo ? log_n : lo;
  const int log_w = log_ln < kThreadsLog ? log_ln : kThreadsLog;
  const int log_hn = log_n - log_ln;
  const int log_hb = log_hn < kTileLog - log_w ? log_hn : kTileLog - log_w;
  out[0] = lo;
  out[1] = log_ln;
  out[2] = log_w;
  out[3] = log_hb;
  out[4] = 1ll << (log_ln - log_w + log_hn - log_hb);
  return 0;
}

// table: the members, groups and factors as laid out above, in device
// memory; blocks: the launch's blocks (the last member's first block plus
// its blocks); scratch: 4 total + 1 zeroed 64-bit words, left zeroed; out:
// (4, total) words. Returns the CUDA error (cudaErrorInvalidValue for
// arguments the kernel does not take).
extern "C" int oods_sample(const void* table, int n_members, int n_groups, int total,
                           long long blocks, void* scratch, void* out, void* stream) {
  if (n_members < 1 || n_groups < 1 || total < 1 || blocks < 1 || blocks >= (1ll << 31)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Args a;
  a.table = static_cast<const uint32_t*>(table);
  a.n_members = n_members;
  a.n_groups = n_groups;
  a.total = total;
  a.scratch = static_cast<unsigned long long*>(scratch);
  a.out = static_cast<uint32_t*>(out);
  oods_kernel<<<static_cast<unsigned int>(blocks), kThreads, 0,
                static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
