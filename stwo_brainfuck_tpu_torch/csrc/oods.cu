// The OODS samples of every (trace log, shift) group of a prove in one
// launch, for Hopper (sm_90a).
//
// Replaces stwo_brainfuck_tpu/core/poly.py:76 _sample_tensor_jit, the one
// small XLA program a group that the JAX package dispatches before its one
// pull (its air.py:745-760); jnp, not Pallas. The port's plain version is
// core/poly.py sample_tensor, bit for bit.
//
// A group g has a trace log n_g, a QM31 point z_g and member rows, each the
// 2^n_g circle-FFT coefficients of a committed column (or a mesh shard's
// chunk of them). Its samples are
//
//   out[:, c] = sum_j row_c[j] * basis_g[j],  basis_g[j] = prod_{k: bit k of j} f_g[k]
//
// in QM31, f_g = [y, x, pi(x), pi^2(x), ...] at z_g (core/poly.py
// _point_factors). The basis is a product over the bits of j, so any split
// of the bits factors it exactly. A big row (2^10 coefficients) splits j
// into the thread's quad's bits 0-1 (i), the thread's bits 2-9 (t) and the
// row's bits 10 and up (h); a pair row (2^9) into bit 0, bits 1-8 and 9 up:
//
//   basis[j] = basis[i] * mid[t] * hi[h]
//
// Inputs (the wrapper is ops/oods_kernels.py), one small device table of
// 32-bit words:
//   members  kMemberWords each: its row's pointer (two words), log2 of its
//            length n, the offset of its first coefficient in the whole row
//            (a mesh shard's chunk), its first row (big, pair) or slot
//            (small), then the output column and group of each point. The
//            big members (2^10 or longer), then the pairs (a row of 2^9 or
//            longer opened at two points of one trace log, the shifted
//            groups' rows: read once for both), then the small members
//            (longest first);
//   groups   kGroupWords a group: n_g and its point (x, then y, 8 words);
//   blocks   the big member and the pair at each block's first row;
//   slots    the small member of each slot.
// Nothing else crosses PCIe: every block builds the groups' factors from
// their points in shared memory (one thread a group, n_g - 2 doublings), so
// the host computes none (a numpy chain over a prove's 11 groups costs the
// host more than the whole launch: tools/oods_variants.py, factors_ms).
//
// The walk. A member's rows are padded to whole chunks of 4 (a pad reads
// the member's first row again with hi = 0), so a member changes only
// between chunks. The grid is persistent: at most occupancy x SMs blocks
// (oods_max_blocks: 2 an SM at 111 registers), block b the b-th of `grid`
// equal spans of one weighted list: the small rows (256 slots, weight 2),
// the chunks of big rows, then the chunks of pair rows (weight 1), so the
// pair chunks fall to blocks of their own, which share SMs with blocks of
// big rows. A block walks its rows in tiles of 256: it builds each row's
// pointer, member and hi values in shared memory (a thread a row), then
// sums the rows with each thread's copies of the next 7 always in flight
// (cp.async of its 16 or 8 bytes into its slot of a ring of kStages rows in
// dynamic shared memory: no register holds a load, no barrier waits for
// one, since a thread reads back only what it copied). A thread keeps 16
// 64-bit sums (4 coefficients x 4 coordinates of hi, or 2 x 2 points x 4;
// m31::mac, folded to under 2^34 after each chunk) while its member lasts;
// at a change of member and at the end it flushes: sum_i basis[i] s_i times
// its mid[t], summed over the warp, added by lane 0 into the member's
// column of a 64-bit scratch. A small row's thread reads its quad (or its
// 1-2 coefficients) and multiplies by the quad's whole basis; the threads
// of one member (aligned, longest first) sum over the warp and its first
// lane adds.
//
// Sums across blocks: every addend is a canonical word (under 2^31) and
// there are far fewer than 2^33 of them a column, so no 64-bit sum wraps;
// the last block of the launch (a counter behind the scratch) reduces every
// column mod p into the output and zeroes the scratch and the counter for
// the next launch. Any exact sum gives the same words, so the order of the
// blocks does not matter.
//
// What it replaced (this kernel's first design): a block a tile of 2^16
// positions of a row's (H, L) matrix with a 4-byte load a thread a row,
// issued one at a time after the tile's b_hi were built; a whole block a
// 2^4-2^6 row; one uneven wave of blocks; the factors on the host. About one
// 128-byte load a warp was in flight, and it ran at 32-44 % of its bytes
// bound.
//
// What bounds it now (tools/oods_variants.py, one run on an H100 80GB HBM3
// at 700 W, the OODS launches of a default fib19_io, a big22 and a
// production prove): 0.088, 0.642 and 0.159 ms, 60, 63 and 77 % of the
// bytes bound (each distinct coefficient word read once). Not the bytes in
// flight any more: a ring of 4 or 16 rows was no faster than 8 (0.091,
// 0.681, 0.166 and 0.088, 0.649, 0.161 ms), nor were 3 blocks an SM (80
// registers: 0.087, 0.662, 0.160). Reading a row once for two points (as
// many products as a big row for half its bytes) wins where the rows are
// long (big22's 2^20 and 2^22) and costs a few % where they are short (one
// point a member: 0.089, 0.726, 0.168), so the products' issue (16
// IMAD.WIDE a thread a row, the folds, the shared hi reads) shares the
// bound with the bytes at 16 warps an SM. At fib19_io a few us of the 88
// are fixed: the launch, the factor chains, the first tile's build and the
// last block's reduction.
//
// The variants that lost (same run; fib19_io, big22, production ms): the
// loads into registers a chunk ahead (ld.global.nc) 0.095, 0.606, 0.180,
// and with one point a member 0.088, 0.717, 0.165; one thread copying whole
// chunks with cp.async.bulk into a 2- or 3-stage mbarrier ring (TMA)
// 0.089, 0.654, 0.163 and 0.089, 0.666, 0.162 (a block barrier a chunk);
// one 4-byte copy a word 0.089, 0.684, 0.168; chunks of 8 pair rows 0.109,
// 0.681, 0.221; every block an equal share of each kind 0.098, 0.678,
// 0.171; the sums reduced to canonical words a chunk 0.096, 0.688, 0.170,
// or folded as s mod 2^32 + 2 (s >> 32) 0.088, 0.650, 0.160; a tile's
// first copies issued before its build 0.089, 0.642, 0.160.

#include <cstdint>
#include <cuda_runtime.h>

#include "m31.cuh"
#include "qm31.cuh"

namespace {

using qm31::Qm;

constexpr int kThreadsLog = 8;
constexpr int kThreads = 1 << kThreadsLog;
constexpr int kTileRows = kThreads;  // rows a tile (one row's pointer and hi values a thread)
constexpr int kQuadLog = 2;          // a small member's slot: 4 coefficients
constexpr int kSmallWeight = 2;      // a small row's weight in a span (a chunk's: 1)
constexpr int kStages = 8;           // the ring: rows a thread has copied, 16 bytes a row
constexpr int kRingBytes = kStages * kThreads * 16;
constexpr int kMemberWords = 9;  // pointer (2), log n, offset, first row or slot, then
                                 // column and group for each point (the second 0 if none)
constexpr int kGroupWords = 9;   // n_g, x (4), y (4)
constexpr int kMaxGroups = 64;   // groups a launch (the wrapper splits more)
constexpr int kFactorStride = 32;  // shared factors a group (>= kMaxLogSize)
constexpr int kMaxLogSize = 30;

// A big row: 2^10 coefficients of one member at one point, a thread's
// quad (16 bytes) times hi into 4 x 4 sums.
struct Single {
  using Load = uint4;
  static constexpr int kLog = kThreadsLog + 2;
  static constexpr int kAt = 4;      // coefficients a thread
  static constexpr int kPoints = 1;
  static constexpr int kChunk = 4;   // rows a chunk: a member starts on a chunk
};

// A pair row: 2^9 coefficients of a row opened at two points, a thread's
// two (8 bytes) times both points' hi into 2 x 2 x 4 sums.
struct Pair {
  using Load = uint2;
  static constexpr int kLog = kThreadsLog + 1;
  static constexpr int kAt = 2;
  static constexpr int kPoints = 2;
  static constexpr int kChunk = 4;
};

struct Args {
  const uint32_t* table;  // members (big, pair, small), groups, block members, slot members
  int n_big;
  int n_pairs;
  int n_small;
  int n_groups;
  long long big_rows;     // rows of the big members, each padded to whole chunks
  long long pair_rows;    // rows of the pairs, each padded to whole chunks
  long long small_rows;   // small rows (kThreads slots each)
  long long slots;        // slots of the small members
  int total;              // output columns
  int ld;                 // the output's row stride (>= total)
  unsigned long long* scratch;  // (4, total) sums, then the block counter
  uint32_t* out;          // (4, ld) int32 words
};

struct Span {
  long long small_lo, small_hi, big_lo, big_hi, pair_lo, pair_hi;
};

__host__ __device__ inline long long min_ll(long long x, long long y) { return x < y ? x : y; }

// The first of `count` units of weight 1 placed from `base` on that starts
// at or after x.
__host__ __device__ inline long long first_at(long long x, long long base, long long count) {
  return x <= base ? 0 : min_ll(count, x - base);
}

// Block b of `grid`: the b-th of `grid` equal spans of one weighted list,
// the small rows (kSmallWeight each), then the chunks of big rows, then the
// chunks of pair rows (1 each); a unit belongs to the span that holds its
// start. The big and pair ranges are in rows (whole chunks). The pair
// chunks come last, so they fall to blocks of their own, which share their
// SMs with blocks of big rows: one's products beside the other's bytes.
__host__ __device__ inline Span span_of(long long b, long long grid, long long small_rows,
                                        long long big_rows, long long pair_rows) {
  const long long big = big_rows / Single::kChunk, pair = pair_rows / Pair::kChunk;
  const long long big_at = small_rows * kSmallWeight, pair_at = big_at + big;
  const long long w = pair_at + pair;
  const long long lo = b * w / grid, hi = (b + 1) * w / grid;
  return {min_ll(small_rows, (lo + kSmallWeight - 1) / kSmallWeight),
          min_ll(small_rows, (hi + kSmallWeight - 1) / kSmallWeight),
          first_at(lo, big_at, big) * Single::kChunk, first_at(hi, big_at, big) * Single::kChunk,
          first_at(lo, pair_at, pair) * Pair::kChunk, first_at(hi, pair_at, pair) * Pair::kChunk};
}

// The product of f[k] over the set bits k of `bits`.
__device__ __forceinline__ Qm basis(const Qm* f, uint32_t bits) {
  Qm acc = {1u, 0u, 0u, 0u};
  for (int k = 0; bits; ++k, bits >>= 1)
    if (bits & 1u) acc = qm31::qm_mul(acc, f[k]);
  return acc;
}

// f = [y, x, pi(x), ...], n_g of them (core/poly.py _point_factors).
__device__ void build_factors(const uint32_t* g, Qm* f) {
  const int log_size = static_cast<int>(__ldg(g));
  Qm x = qm31::load_qm(g + 1);
  f[0] = qm31::load_qm(g + 5);
  for (int k = 1; k < log_size; ++k) {
    f[k] = x;
    x = qm31::qm_sub(qm31::qm_mul(x, qm31::qm_add(x, x)), Qm{1u, 0u, 0u, 0u});
  }
}

__device__ __forceinline__ const uint32_t* row_of(const uint32_t* m) {
  return reinterpret_cast<const uint32_t*>(static_cast<uintptr_t>(__ldg(m)) |
                                           (static_cast<uintptr_t>(__ldg(m + 1)) << 32));
}

// The member of row g, from a member at or before it.
__device__ __forceinline__ int advance(const uint32_t* members, int n, int m, long long g) {
  while (m + 1 < n && __ldg(members + (m + 1) * kMemberWords + 4) <= g) ++m;
  return m;
}

template <class K>
__device__ __forceinline__ const typename K::Load* row_address(const uint32_t* m, long long g) {
  return reinterpret_cast<const typename K::Load*>(row_of(m) + ((g - __ldg(m + 4)) << K::kLog));
}

// The ring of kStages rows (a thread's 16-byte slot of each) lives in
// dynamic shared memory after the groups' factors.
__device__ __forceinline__ uint4* ring_of(const Qm* factors, int n_groups) {
  return reinterpret_cast<uint4*>(const_cast<Qm*>(factors) + n_groups * kFactorStride);
}

// The thread's words of a row (one 16- or 8-byte cp.async) into its slot of
// ring stage st.
template <class L>
__device__ __forceinline__ void copy_row(uint4* ring, int st, const L* src) {
  L* dst = reinterpret_cast<L*>(ring + st * kThreads) + threadIdx.x;
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n"
               :: "r"(static_cast<uint32_t>(__cvta_generic_to_shared(dst))), "l"(src),
                  "n"(sizeof(L)) : "memory");
}

__device__ __forceinline__ void commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

// Wait until at most n of the thread's copy groups are in flight.
template <int N>
__device__ __forceinline__ void wait_rows() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

__device__ __forceinline__ void unpack(uint4 x, uint32_t (&w)[4]) {
  w[0] = x.x; w[1] = x.y; w[2] = x.z; w[3] = x.w;
}

__device__ __forceinline__ void unpack(uint2 x, uint32_t (&w)[2]) {
  w[0] = x.x; w[1] = x.y;
}

__device__ __forceinline__ Qm shfl_down(Qm v, int d) {
  return {__shfl_down_sync(0xffffffffu, v.a, d), __shfl_down_sync(0xffffffffu, v.b, d),
          __shfl_down_sync(0xffffffffu, v.c, d), __shfl_down_sync(0xffffffffu, v.d, d)};
}

__device__ __forceinline__ Qm shfl_xor(Qm v, int d) {
  return {__shfl_xor_sync(0xffffffffu, v.a, d), __shfl_xor_sync(0xffffffffu, v.b, d),
          __shfl_xor_sync(0xffffffffu, v.c, d), __shfl_xor_sync(0xffffffffu, v.d, d)};
}

__device__ __forceinline__ void add_column(const Args& a, uint32_t column, Qm v) {
  atomicAdd(a.scratch + column, static_cast<unsigned long long>(v.a));
  atomicAdd(a.scratch + a.total + column, static_cast<unsigned long long>(v.b));
  atomicAdd(a.scratch + 2 * a.total + column, static_cast<unsigned long long>(v.c));
  atomicAdd(a.scratch + 3 * a.total + column, static_cast<unsigned long long>(v.d));
}

// Slot r * kThreads + t of the small members.
__device__ void small_row(const Args& a, const uint32_t* small, const uint32_t* slot_member,
                          const Qm* factors, long long r) {
  const int t = threadIdx.x;
  const long long slot = r * kThreads + t;
  Qm v = {0u, 0u, 0u, 0u};
  int width = 1;
  bool lead = false;
  uint32_t column = 0;
  if (slot < a.slots) {
    const uint32_t* m = small + __ldg(slot_member + slot) * kMemberWords;
    const uint32_t* row = row_of(m);
    const int log_n = static_cast<int>(__ldg(m + 2));
    const uint32_t k = static_cast<uint32_t>(slot - __ldg(m + 4));  // the member's quad
    column = __ldg(m + 5);
    const Qm* f = factors + __ldg(m + 6) * kFactorStride;
    const int n_at = 1 << min(log_n, kQuadLog);
    uint64_t s[4] = {};
    for (int i = 0; i < n_at; ++i) {
      const uint32_t x = __ldg(row + (k << kQuadLog) + i);
      const Qm c = basis(f, i);  // basis[j0 + i] = basis[j0] * basis[i]
      s[0] = m31::mac(s[0], x, c.a);
      s[1] = m31::mac(s[1], x, c.b);
      s[2] = m31::mac(s[2], x, c.c);
      s[3] = m31::mac(s[3], x, c.d);
    }
    const Qm u = {m31::reduce64(s[0]), m31::reduce64(s[1]), m31::reduce64(s[2]),
                  m31::reduce64(s[3])};
    // the quad's first index: its low bits are 0
    v = qm31::qm_mul(u, basis(f, __ldg(m + 3) + (k << kQuadLog)));
    width = log_n > kQuadLog + 5 ? 32 : 1 << (log_n > kQuadLog ? log_n - kQuadLog : 0);
    lead = (t & (width - 1)) == 0;
  }
#pragma unroll
  for (int d = 16; d; d >>= 1) {
    const Qm o = shfl_xor(v, d);
    if (d < width) v = qm31::qm_add(v, o);
  }
  if (lead) add_column(a, column, v);
}

// Each sum s below 2^64 to (s & p) + (s >> 31) (2^31 = 1 mod p), below
// 2^34: room for four more products of canonical words.
__device__ __forceinline__ void fold(uint64_t (&acc)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[i][c] = (acc[i][c] & m31::kP) + (acc[i][c] >> 31);
}

// The thread's sums of member m at each point: sum_i basis[i] s_i times its
// mid, over the warp, into the point's column.
template <class K>
__device__ __forceinline__ void flush(const Args& a, uint64_t (&acc)[4][4], const uint32_t* m,
                                      const Qm* factors, const Qm (&mid)[K::kPoints]) {
#pragma unroll
  for (int p = 0; p < K::kPoints; ++p) {
    const Qm* f = factors + __ldg(m + 6 + 2 * p) * kFactorStride;
    Qm s = {0u, 0u, 0u, 0u};
#pragma unroll
    for (int i = 0; i < K::kAt; ++i) {
      uint64_t(&r)[4] = acc[p * K::kAt + i];
      const Qm q = {m31::reduce64(r[0]), m31::reduce64(r[1]), m31::reduce64(r[2]),
                    m31::reduce64(r[3])};
      r[0] = r[1] = r[2] = r[3] = 0;
      s = qm31::qm_add(s, i ? qm31::qm_mul(q, basis(f, i)) : q);
    }
    Qm v = qm31::qm_mul(s, mid[p]);
#pragma unroll
    for (int d = 16; d; d >>= 1) v = qm31::qm_add(v, shfl_down(v, d));
    if ((threadIdx.x & 31) == 0) add_column(a, __ldg(m + 5 + 2 * p), v);
  }
}

template <class K>
__device__ __forceinline__ void mac_row(uint64_t (&acc)[4][4], typename K::Load x,
                                        const Qm (&h)[K::kPoints]) {
  uint32_t xs[K::kAt];
  unpack(x, xs);
#pragma unroll
  for (int p = 0; p < K::kPoints; ++p)
#pragma unroll
    for (int i = 0; i < K::kAt; ++i) {
      uint64_t(&r)[4] = acc[p * K::kAt + i];
      r[0] = m31::mac(r[0], xs[i], h[p].a);
      r[1] = m31::mac(r[1], xs[i], h[p].b);
      r[2] = m31::mac(r[2], xs[i], h[p].c);
      r[3] = m31::mac(r[3], xs[i], h[p].d);
    }
}

// Row g of member m; a row that pads the member to whole chunks reads its
// first row again (its hi value is 0).
template <class K>
__device__ __forceinline__ bool is_pad(const uint32_t* m, long long g) {
  return (g - __ldg(m + 4)) >> (__ldg(m + 2) - K::kLog);
}

template <class K>
__device__ __forceinline__ const typename K::Load* row_or_first(const uint32_t* m, long long g) {
  return is_pad<K>(m, g) ? row_address<K>(m, __ldg(m + 4)) : row_address<K>(m, g);
}

struct Tile {
  Qm hi[2][kTileRows];  // each row's hi value at each point
  const void* ptr[kTileRows];
  int member[kTileRows];
};

// Rows lo .. hi - 1 of `members` (whole chunks; m: a member at or before
// row lo's), in tiles of kTileRows: each row's pointer (a pad's: its
// member's first row), member and hi values (a pad's: 0) built a thread a
// row, then the rows summed, each thread's copies of the next kStages - 1
// rows always in flight (cp.async into its slots of the ring, so no
// register holds a load and no barrier waits for one). A member starts on a
// chunk, so a flush (at a change of member and at the end) comes only
// between chunks. Every addend of a sum is below 2^62 and each sum is
// folded to under 2^34 after each chunk, so it stays below 2^64.
template <class K>
__device__ void walk_rows(const Args& a, const uint32_t* members, int n, int m, long long lo,
                          long long hi, const Qm* factors, Tile& tile) {
  using L = typename K::Load;
  constexpr int U = K::kChunk;
  const int t = threadIdx.x;
  uint4* ring = ring_of(factors, a.n_groups);
  uint64_t acc[4][4] = {};
  int cur = -1;
  Qm mid[K::kPoints];
  for (long long g0 = lo; g0 < hi; g0 += kTileRows) {
    const int rows = static_cast<int>(min_ll(kTileRows, hi - g0));
    if (t < rows) {
      const int mt = advance(members, n, m, g0 + t);
      const uint32_t* w = members + mt * kMemberWords;
      tile.member[t] = mt;
      tile.ptr[t] = row_or_first<K>(w, g0 + t);
      const uint32_t h = (__ldg(w + 3) >> K::kLog) + static_cast<uint32_t>(g0 + t - __ldg(w + 4));
      const bool pad = is_pad<K>(w, g0 + t);
#pragma unroll
      for (int p = 0; p < K::kPoints; ++p)
        tile.hi[p][t] = pad ? Qm{0u, 0u, 0u, 0u}
                            : basis(factors + __ldg(w + 6 + 2 * p) * kFactorStride + K::kLog, h);
    }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < kStages - 1; ++r) {
      if (r < rows) copy_row(ring, r, static_cast<const L*>(tile.ptr[r]) + t);
      commit();
    }
    for (int k = 0; k < rows; k += U) {
      L xs[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int r = k + u + kStages - 1;
        if (r < rows) copy_row(ring, r % kStages, static_cast<const L*>(tile.ptr[r]) + t);
        commit();
        wait_rows<kStages - 1>();
        xs[u] = reinterpret_cast<const L*>(ring + ((k + u) % kStages) * kThreads)[t];
      }
      const int mk = tile.member[k];
      if (mk != cur) {
        if (cur >= 0) flush<K>(a, acc, members + cur * kMemberWords, factors, mid);
        cur = mk;
        const uint32_t* w = members + mk * kMemberWords;
#pragma unroll
        for (int p = 0; p < K::kPoints; ++p)
          mid[p] = basis(factors + __ldg(w + 6 + 2 * p) * kFactorStride + K::kLog - kThreadsLog,
                         static_cast<uint32_t>(t));
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        Qm h[K::kPoints];
#pragma unroll
        for (int p = 0; p < K::kPoints; ++p) h[p] = tile.hi[p][k + u];
        mac_row<K>(acc, xs[u], h);
        if ((u & 3) == 3 || u == U - 1) fold(acc);
      }
    }
    wait_rows<0>();
    m = tile.member[rows - 1];
    __syncthreads();
  }
  if (cur >= 0) flush<K>(a, acc, members + cur * kMemberWords, factors, mid);
}

__global__ void __launch_bounds__(kThreads, 2) oods_kernel(const Args a) {
  extern __shared__ Qm factors[];  // n_groups x kFactorStride, then the ring
  __shared__ Tile tile;
  __shared__ bool last;
  const uint32_t* big = a.table;
  const uint32_t* pairs = big + a.n_big * kMemberWords;
  const uint32_t* small = pairs + a.n_pairs * kMemberWords;
  const uint32_t* groups = small + a.n_small * kMemberWords;
  const uint32_t* block_big = groups + a.n_groups * kGroupWords;
  const uint32_t* block_pair = block_big + gridDim.x;
  const uint32_t* slot_member = block_pair + gridDim.x;
  const int t = threadIdx.x;
  const Span s = span_of(blockIdx.x, gridDim.x, a.small_rows, a.big_rows, a.pair_rows);

  for (int g = t; g < a.n_groups; g += kThreads)
    build_factors(groups + g * kGroupWords, factors + g * kFactorStride);
  __syncthreads();

  for (long long r = s.small_lo; r < s.small_hi; ++r) small_row(a, small, slot_member, factors, r);
  if (s.big_lo < s.big_hi) {
    walk_rows<Single>(a, big, a.n_big, static_cast<int>(__ldg(block_big + blockIdx.x)),
                      s.big_lo, s.big_hi, factors, tile);
  }
  if (s.pair_lo < s.pair_hi) {
    walk_rows<Pair>(a, pairs, a.n_pairs, static_cast<int>(__ldg(block_pair + blockIdx.x)),
                    s.pair_lo, s.pair_hi, factors, tile);
  }

  __threadfence();
  __syncthreads();
  if (t == 0) last = atomicAdd(a.scratch + 4 * a.total, 1ull) == gridDim.x - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  for (int i = t; i < 4 * a.total; i += kThreads)
    a.out[(i / a.total) * a.ld + i % a.total] = m31::reduce64(atomicExch(a.scratch + i, 0ull));
  if (t == 0) atomicExch(a.scratch + 4 * a.total, 0ull);
}

}  // namespace

// The constants the wrapper keeps copies of (ops/oods_kernels.py _bind
// checks them at load).
extern "C" void oods_constants(int* out) {
  const int c[] = {kMaxLogSize,    kMemberWords, kGroupWords,  kThreadsLog,
                   kQuadLog,       Single::kLog, Pair::kLog,   kTileRows,
                   Single::kChunk, Pair::kChunk, kSmallWeight, kMaxGroups};
  for (int i = 0; i < 12; ++i) out[i] = c[i];
}

// Block b's span of a launch of `grid` blocks over `small_rows` small rows,
// `big_rows` big rows and `pair_rows` pair rows: out = {first small row,
// end, first big row, end, first pair row, end} (ops/oods_kernels.py
// schedule mirrors it).
extern "C" int oods_schedule(long long b, long long grid, long long small_rows,
                             long long big_rows, long long pair_rows, long long* out) {
  if (grid < 1 || b < 0 || b >= grid || small_rows < 0 || big_rows < 0 || pair_rows < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Span s = span_of(b, grid, small_rows, big_rows, pair_rows);
  const long long v[] = {s.small_lo, s.small_hi, s.big_lo, s.big_hi, s.pair_lo, s.pair_hi};
  for (int i = 0; i < 6; ++i) out[i] = v[i];
  return 0;
}

// The most blocks of the kernel resident at once on the current device
// (occupancy at the most groups' shared memory, times the SMs). The kernel
// is allowed that much dynamic shared memory here, before any launch.
extern "C" int oods_max_blocks(int* out) {
  const int smem = kMaxGroups * kFactorStride * sizeof(Qm) + kRingBytes;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess) {
    e = cudaFuncSetAttribute(oods_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  }
  if (e == cudaSuccess) {
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, oods_kernel, kThreads, smem);
  }
  if (e != cudaSuccess) return static_cast<int>(e);
  *out = per_sm * sms;
  return 0;
}

// The kernel's registers a thread, static shared memory and local memory
// (spills) a thread in bytes: out = {registers, shared bytes, local bytes}.
extern "C" int oods_attributes(int* out) {
  cudaFuncAttributes f;
  const cudaError_t e = cudaFuncGetAttributes(&f, oods_kernel);
  if (e != cudaSuccess) return static_cast<int>(e);
  out[0] = f.numRegs;
  out[1] = static_cast<int>(f.sharedSizeBytes);
  out[2] = static_cast<int>(f.localSizeBytes);
  return 0;
}

// table: the members, groups, block and slot members as laid out above, in
// device memory (the block members `grid` words a kind); scratch: 4 total + 1
// zeroed 64-bit words, left zeroed; out: (4, ld) words, columns 0 .. total
// - 1 written. Returns the CUDA error (cudaErrorInvalidValue for arguments
// the kernel does not take).
extern "C" int oods_sample(const void* table, int n_big, int n_pairs, int n_small,
                           int n_groups, long long big_rows, long long pair_rows,
                           long long small_rows, long long slots, int total, int ld,
                           long long grid, void* scratch, void* out, void* stream) {
  if (n_big < 0 || n_pairs < 0 || n_small < 0 || n_big + n_pairs + n_small < 1 ||
      n_groups < 1 || n_groups > kMaxGroups || total < 1 || ld < total || grid < 1 ||
      grid >= (1ll << 31) || big_rows < n_big || pair_rows < n_pairs || slots < n_small ||
      small_rows * kThreads < slots || big_rows % Single::kChunk || pair_rows % Pair::kChunk ||
      grid > small_rows * kSmallWeight + big_rows / Single::kChunk + pair_rows / Pair::kChunk) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Args a;
  a.table = static_cast<const uint32_t*>(table);
  a.n_big = n_big;
  a.n_pairs = n_pairs;
  a.n_small = n_small;
  a.n_groups = n_groups;
  a.big_rows = big_rows;
  a.pair_rows = pair_rows;
  a.small_rows = small_rows;
  a.slots = slots;
  a.total = total;
  a.ld = ld;
  a.scratch = static_cast<unsigned long long*>(scratch);
  a.out = static_cast<uint32_t*>(out);
  oods_kernel<<<static_cast<unsigned int>(grid), kThreads,
                n_groups * kFactorStride * sizeof(Qm) + kRingBytes,
                static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
