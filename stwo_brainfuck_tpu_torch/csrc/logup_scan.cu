// The LogUp prefix sum for Hopper (sm_90a): S, the running QM31 sum of a
// component's per-row fraction sums, in one launch.
//
// Replaces the prefix half of stwo_brainfuck_tpu/framework/component.py:372
// _build_interaction_fn: :674 _qm31_cumsum over the row sums gathered into
// coset LINEAR order (where p - g is the previous point), scattered back to
// bit-reversed storage, and its last value, the claimed sum. With the
// logup kernel (csrc/constraints.cu) it is the whole of that function. The
// plain version is framework/component.py prefix_sum_plain (gather, int64
// cumsum, % p, scatter); addition mod p is exact, so any order of the sum
// gives the same words.
//
// coset_scan: total (4, N) int32 in storage order, N = 2^n; S (4, N) in
// storage order and the claimed sum (4 words), both on the card.
// linear_scan: x (4, n) already in linear order (a mesh shard's chunk), a
// QM31 carry-in (the shards before it) or none; S = carry + the inclusive
// sum, and carry + the whole sum (4 words).
//
// The order. Linear point l = 2k sits at storage 2 rev(k) and l = 2k + 1 at
// N - 1 - 2 rev(k) (core/fft.py coset_order_permutation; rev over m = n - 1
// bits). So with P[k] = total[2 rev(k)] + total[N - 1 - 2 rev(k)] and Pre the
// inclusive sum of P: S_lin[2k + 1] = Pre[k], S_lin[2k] = Pre[k] - (the odd
// one). Read the pair index j = rev(k) as a matrix, j = J 2^c + jl (C = 2^c
// columns, c = min(5, m - 1); R = 2^(m - c) rows): k = rev(jl) 2^(m - c) +
// rev(J), so linear order runs down column rev(jl) = 0 first, each column's
// rows in the order rev(J). Then
//   Pre = ColExcl[rev(jl)] + (the column's sum over rows up to rev(J)),
// ColExcl the sum of the whole columns before it. A row is 2^c consecutive
// j: coalesced. A lane owns a column, a warp a few rows, a tile (a CTA) a
// run of rows consecutive in the order rev(J), so the rows' sums chain from
// tile to tile with a vector of per-column sums.
//
// Mirrors. Row J's storage words 2j and N - 1 - 2j share their sectors with
// the odd and even words of the mirrored pair half - 1 - j (row ~J, column
// ~jl, chain position R - 1 - rev(J)). A tile takes the rows of the first
// half of the chain and their mirrors, so a lane reads two uint2 a
// coordinate, (total[2j], total[2j + 1]) and (total[N - 2 - 2j],
// total[N - 1 - 2j]), every sector whole. The mirrors' prefix is
//   ColIncl[C - 1 - rev(jl)] - H,
// H the sum of the mirrors of the rows before this one in the tiles' order,
// which chains as the low rows do.
//
// The passes. ColExcl needs every row of every column, so no tile can
// finish before all were read once: a launch runs two sweeps over the data,
// as tickets (CTAs take tickets from a counter in the order they start, so
// every CTA a ticket waits on is already running). Tickets 0 .. T - 1 sum
// their tile's rows (per lane: 4 coordinates of the rows, 4 of the
// mirrors), publish the tile's vector (256 words) and find the sum of the
// tiles before it by decoupled look-back (warp 0 reads 32 flags at once;
// aggregates back to the nearest inclusive prefix), then write each warp's
// offset. Tickets T .. 2T - 1 wait for all T, take the column totals from
// the last tile's inclusive vector (ColExcl by a warp scan in key order),
// read their tile again (in reverse ticket order: the tiles read last are
// most likely still in L2), and write S.
//
// What bounds it: bytes. The function reads 16 B a row and writes 16; the
// second read is the price of the global dependency (at 2^20 rows the 16 MB
// stay in L2). A launch's at most 64 look-back vectors are 1 KB each.

#include <cstdint>
#include <cuda_runtime.h>

#include "m31.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kVec = 256;  // a coset tile's vector: 32 lanes x (4 row words, 4 mirror words)
constexpr int kBatch = 4;  // rows loaded before they are summed
constexpr int kLinearPerLane = 8;
constexpr int kLinearTile = kThreads * kLinearPerLane;

// At most 64 tiles: a launch's scratch (2 + 8 vectors a tile) stays below
// 1 MB, in the caching allocator's small pool, away from the large blocks
// whose layout sets the prover's peak.
constexpr int kMaxTiles = 64;

constexpr uint32_t kEmpty = 0, kAggregate = 1, kInclusive = 2;

__device__ __forceinline__ uint32_t ld_acquire(const uint32_t* p) {
  uint32_t v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_release(uint32_t* p, uint32_t v) {
  asm volatile("st.release.gpu.global.u32 [%0], %1;" ::"l"(p), "r"(v) : "memory");
}

__device__ __forceinline__ uint32_t rev_bits(uint32_t x, int bits) {
  return bits ? __brev(x) >> (32 - bits) : 0u;
}

// The CTA's words (stored by threads t < width before the call) become
// visible, then the tile's flag says `state`.
__device__ __forceinline__ void publish(uint32_t* flag, uint32_t state) {
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) st_release(flag, state);
}

// Decoupled look-back: the sum of the vectors of tiles 0 .. u - 1, word
// threadIdx.x (0 for threads at or past `width`). Warp 0 reads the flags of
// 32 tiles at once; the tiles down to the nearest inclusive one add their
// aggregates, that one its inclusive prefix.
__device__ uint32_t look_back(const uint32_t* flags, const uint32_t* agg, const uint32_t* incl,
                              int width, int u, int* sh) {
  uint32_t excl = 0;
  for (int pred = u - 1; pred >= 0; pred -= 32) {
    if (threadIdx.x < 32) {
      const int tile = pred - static_cast<int>(threadIdx.x);
      unsigned incl_mask, empty_mask;
      int first;
      for (;;) {
        // before tile 0: an inclusive zero
        const uint32_t f = tile >= 0 ? ld_acquire(flags + tile) : kInclusive;
        incl_mask = __ballot_sync(~0u, f == kInclusive);
        empty_mask = __ballot_sync(~0u, f == kEmpty);
        first = incl_mask ? __ffs(incl_mask) - 1 : 32;
        const unsigned need = first >= 31 ? ~0u : (2u << first) - 1u;
        if (!(empty_mask & need)) break;
        __nanosleep(64);
      }
      if (threadIdx.x == 0) {
        sh[0] = first == 32 ? 32 : first + 1;
        sh[1] = first != 32;
      }
      __threadfence();
    }
    __syncthreads();
    const int count = sh[0];
    const bool stop = sh[1];
    if (static_cast<int>(threadIdx.x) < width) {
      for (int i = 0; i < count && pred - i >= 0; ++i) {
        const uint32_t* src = stop && i == count - 1 ? incl : agg;
        excl = m31::add(excl, __ldcg(src + static_cast<size_t>(pred - i) * width + threadIdx.x));
      }
    }
    __syncthreads();
    if (stop) break;
  }
  return excl;
}

struct Geometry {
  int col_log;    // c: 2^c columns
  int row_log;    // R = 2^row_log rows
  int tile_rows;  // rows of the chain's first half a tile (with as many mirrors)
  int tiles;
  int rows_per_warp;
};

Geometry geometry(int log_n) {
  Geometry g;
  const int m = log_n - 1;
  g.col_log = m - 1 < 5 ? m - 1 : 5;
  g.row_log = m - g.col_log;
  const int low_rows = 1 << (g.row_log - 1);
  const int wide = low_rows / kMaxTiles > 32 ? low_rows / kMaxTiles : 32;
  g.tile_rows = low_rows < wide ? low_rows : wide;
  g.tiles = low_rows / g.tile_rows;
  g.rows_per_warp = g.tile_rows >> 3 > 1 ? g.tile_rows >> 3 : 1;
  return g;
}

struct CosetArgs {
  const uint32_t* total;  // (4, N)
  uint32_t* s;            // (4, N)
  uint32_t* claimed;      // 4
  uint32_t* head;         // ticket, done, flags[tiles]; zero before the launch
  uint32_t* agg;          // tiles x kVec
  uint32_t* incl;         // tiles x kVec
  uint32_t* off;          // tiles x kWarps x kVec: each warp's offsets
  int log_n;
  Geometry g;
};

struct Pair {
  uint2 a[4], b[4];  // (total[2j], total[2j + 1]), (total[N - 2 - 2j], total[N - 1 - 2j])
  uint32_t j;
};

// The first sweep's loads keep the lines in L2 for the second; the
// second's are their last use.
template <bool kLast>
__device__ __forceinline__ void load_pair(const CosetArgs& a, int u, int rho, uint32_t lane,
                                          Pair& p) {
  const uint32_t kr = static_cast<uint32_t>(u) * a.g.tile_rows + rho;
  p.j = (rev_bits(kr, a.g.row_log) << a.g.col_log) | lane;
  const size_t n = size_t(1) << a.log_n;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const uint32_t* row = a.total + q * n;
    const uint2* x = reinterpret_cast<const uint2*>(row + 2 * p.j);
    const uint2* y = reinterpret_cast<const uint2*>(row + n - 2 - 2 * p.j);
    p.a[q] = kLast ? __ldcs(x) : __ldcg(x);
    p.b[q] = kLast ? __ldcs(y) : __ldcg(y);
  }
}

__global__ void __launch_bounds__(kThreads) coset_scan_kernel(const CosetArgs a) {
  __shared__ int ticket;
  __shared__ int look[2];
  __shared__ uint32_t part[kWarps][kVec];
  if (threadIdx.x == 0) ticket = static_cast<int>(atomicAdd(a.head, 1u));
  __syncthreads();
  const int tiles = a.g.tiles;
  const bool first_sweep = ticket < tiles;
  const int u = first_sweep ? ticket : 2 * tiles - 1 - ticket;
  const int warp = threadIdx.x >> 5;
  const uint32_t lane = threadIdx.x & 31u;
  const uint32_t cols = 1u << a.g.col_log;
  const bool col_live = lane < cols;
  const int rpw = a.g.rows_per_warp;
  const int row0 = warp * rpw;
  const int row_end = min(row0 + rpw, a.g.tile_rows);
  uint32_t* flags = a.head + 2;

  if (first_sweep) {
    uint32_t lsum[4] = {0u, 0u, 0u, 0u}, hsum[4] = {0u, 0u, 0u, 0u};
    if (col_live) {
      for (int rho = row0; rho < row_end; rho += kBatch) {
        Pair p[kBatch];
#pragma unroll
        for (int b = 0; b < kBatch; ++b)
          if (rho + b < row_end) load_pair<false>(a, u, rho + b, lane, p[b]);
#pragma unroll
        for (int b = 0; b < kBatch; ++b) {
          if (rho + b < row_end) {
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              lsum[q] = m31::add(lsum[q], m31::add(p[b].a[q].x, p[b].b[q].y));
              hsum[q] = m31::add(hsum[q], m31::add(p[b].b[q].x, p[b].a[q].y));
            }
          }
        }
      }
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      part[warp][lane * 8 + q] = lsum[q];
      part[warp][lane * 8 + 4 + q] = hsum[q];
    }
    __syncthreads();
    const int t = threadIdx.x;  // this thread's word of the vectors
    uint32_t ex[kWarps], sum = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      ex[w] = sum;
      sum = m31::add(sum, part[w][t]);
    }
    __stcg(a.agg + static_cast<size_t>(u) * kVec + t, sum);
    uint32_t excl = 0;
    if (u == 0) {
      __stcg(a.incl + t, sum);
      publish(flags, kInclusive);
    } else {
      publish(flags + u, kAggregate);
      excl = look_back(flags, a.agg, a.incl, kVec, u, look);
      __stcg(a.incl + static_cast<size_t>(u) * kVec + t, m31::add(excl, sum));
      publish(flags + u, kInclusive);
    }
#pragma unroll
    for (int w = 0; w < kWarps; ++w)
      __stcg(a.off + (static_cast<size_t>(u) * kWarps + w) * kVec + t, m31::add(excl, ex[w]));
    __threadfence();
    __syncthreads();
    if (t == 0) atomicAdd(a.head + 1, 1u);
    return;
  }

  // the second sweep: every tile's offsets are written
  if (threadIdx.x == 0) {
    while (ld_acquire(a.head + 1) < static_cast<uint32_t>(tiles)) __nanosleep(256);
    __threadfence();
  }
  __syncthreads();
  const uint32_t* last = a.incl + static_cast<size_t>(tiles - 1) * kVec + lane * 8;
  const uint32_t* mine = a.off + (static_cast<size_t>(u) * kWarps + warp) * kVec + lane * 8;
  const uint32_t mirror = cols - 1;  // lane ^ mirror = C - 1 - lane
  const uint32_t src = col_live ? rev_bits(lane, a.g.col_log) : lane;
  uint32_t col_excl[4], mirror_incl[4], lo[4], hi[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    // column `lane`'s total: its rows (this lane) and its mirrors (lane C - 1 - lane)
    const uint32_t total =
        m31::add(__ldcg(last + q), __shfl_xor_sync(~0u, __ldcg(last + 4 + q), mirror));
    // in key order (lane = key): an inclusive warp scan
    const uint32_t v = __shfl_sync(~0u, total, src);
    uint32_t s = v;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const uint32_t t = __shfl_up_sync(~0u, s, d);
      if (lane >= static_cast<uint32_t>(d)) s = m31::add(s, t);
    }
    if (u == tiles - 1 && warp == 0 && lane == cols - 1) a.claimed[q] = s;
    col_excl[q] = __shfl_sync(~0u, m31::sub(s, v), src);
    mirror_incl[q] = __shfl_xor_sync(~0u, m31::add(col_excl[q], total), mirror);
    lo[q] = __ldcg(mine + q);
    hi[q] = __ldcg(mine + 4 + q);
  }
  if (!col_live) return;
  const size_t n = size_t(1) << a.log_n;
  for (int rho = row0; rho < row_end; rho += kBatch) {
    Pair p[kBatch];
#pragma unroll
    for (int b = 0; b < kBatch; ++b)
      if (rho + b < row_end) load_pair<true>(a, u, rho + b, lane, p[b]);
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      if (rho + b < row_end) {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          lo[q] = m31::add(lo[q], m31::add(p[b].a[q].x, p[b].b[q].y));
          const uint32_t pre = m31::add(col_excl[q], lo[q]);    // S at 2j's linear pair
          const uint32_t pre_m = m31::sub(mirror_incl[q], hi[q]);  // at the mirror's
          hi[q] = m31::add(hi[q], m31::add(p[b].b[q].x, p[b].a[q].y));
          uint32_t* row = a.s + q * n;
          *reinterpret_cast<uint2*>(row + 2 * p[b].j) =
              make_uint2(m31::sub(pre, p[b].b[q].y), pre_m);
          *reinterpret_cast<uint2*>(row + n - 2 - 2 * p[b].j) =
              make_uint2(m31::sub(pre_m, p[b].a[q].y), pre);
        }
      }
    }
  }
}

struct LinearArgs {
  const uint32_t* x;       // (4, n)
  uint32_t* s;             // (4, n)
  uint32_t* total;         // 4: carry + the sum
  const uint32_t* carry;   // 4, or null
  uint32_t* head;          // ticket, unused, flags[tiles]; zero before the launch
  uint32_t* agg;           // tiles x 4
  uint32_t* incl;          // tiles x 4
  uint32_t n;
  int tiles;
};

// One pass: a warp scans its 256 consecutive values in 8 rounds of 32
// (shuffles), the CTA adds the warps before it, the tiles chain by look-back
// on 4-word vectors.
__global__ void __launch_bounds__(kThreads) linear_scan_kernel(const LinearArgs a) {
  __shared__ int ticket;
  __shared__ int look[2];
  __shared__ uint32_t part[kWarps][4];
  __shared__ uint32_t base_off[kWarps][4];
  if (threadIdx.x == 0) ticket = static_cast<int>(atomicAdd(a.head, 1u));
  __syncthreads();
  const int u = ticket;
  const int warp = threadIdx.x >> 5;
  const uint32_t lane = threadIdx.x & 31u;
  const size_t n = a.n;
  const size_t first = static_cast<size_t>(u) * kLinearTile + warp * 32 * kLinearPerLane;
  uint32_t v[kLinearPerLane][4];
#pragma unroll
  for (int r = 0; r < kLinearPerLane; ++r) {
    const size_t i = first + r * 32 + lane;
#pragma unroll
    for (int q = 0; q < 4; ++q) v[r][q] = i < n ? __ldcs(a.x + q * n + i) : 0u;
  }
  uint32_t run[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int r = 0; r < kLinearPerLane; ++r) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      uint32_t s = v[r][q];
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const uint32_t t = __shfl_up_sync(~0u, s, d);
        if (lane >= static_cast<uint32_t>(d)) s = m31::add(s, t);
      }
      v[r][q] = m31::add(s, run[q]);
      run[q] = m31::add(run[q], __shfl_sync(~0u, s, 31));
    }
  }
  if (lane == 0) {
#pragma unroll
    for (int q = 0; q < 4; ++q) part[warp][q] = run[q];
  }
  __syncthreads();
  const int t = threadIdx.x;
  uint32_t sum = 0;
  if (t < 4) {
    for (int w = 0; w < kWarps; ++w) {
      base_off[w][t] = sum;
      sum = m31::add(sum, part[w][t]);
    }
    __stcg(a.agg + static_cast<size_t>(u) * 4 + t, sum);
  }
  uint32_t excl = 0;
  uint32_t* flags = a.head + 2;
  if (u == 0) {
    if (t < 4) __stcg(a.incl + t, sum);
    publish(flags, kInclusive);
  } else {
    publish(flags + u, kAggregate);
    excl = look_back(flags, a.agg, a.incl, 4, u, look);
    if (t < 4) __stcg(a.incl + static_cast<size_t>(u) * 4 + t, m31::add(excl, sum));
    publish(flags + u, kInclusive);
  }
  if (t < 4) {
    const uint32_t carry = a.carry ? a.carry[t] : 0u;
    for (int w = 0; w < kWarps; ++w)
      base_off[w][t] = m31::add(base_off[w][t], m31::add(excl, carry));
    if (u == a.tiles - 1) a.total[t] = m31::add(carry, m31::add(excl, sum));
  }
  __syncthreads();
#pragma unroll
  for (int r = 0; r < kLinearPerLane; ++r) {
    const size_t i = first + r * 32 + lane;
    if (i < n) {
#pragma unroll
      for (int q = 0; q < 4; ++q) a.s[q * n + i] = m31::add(v[r][q], base_off[warp][q]);
    }
  }
}

}  // namespace

// out: col_log, row_log, tile_rows, tiles, rows_per_warp of the coset scan
// of 2^log_n rows (ops/constraint_kernels.py scan_geometry mirrors this).
extern "C" int logup_scan_geometry(int log_n, int* out) {
  if (log_n < 2 || log_n > 30) return static_cast<int>(cudaErrorInvalidValue);
  const Geometry g = geometry(log_n);
  out[0] = g.col_log;
  out[1] = g.row_log;
  out[2] = g.tile_rows;
  out[3] = g.tiles;
  out[4] = g.rows_per_warp;
  return 0;
}

// The scratch a launch needs, in 32-bit words: out[0] the head (zeroed by
// the caller: ticket, done, one flag a tile), out[1] the rest (uninitialized).
extern "C" int logup_scan_scratch(int coset, long long n, long long* out) {
  if (coset) {
    int log_n = 0;
    while ((1ll << log_n) < n) ++log_n;
    if ((1ll << log_n) != n || log_n < 2 || log_n > 30) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    const long long tiles = geometry(log_n).tiles;
    out[0] = 2 + tiles;
    out[1] = tiles * kVec * (2 + kWarps);
    return 0;
  }
  if (n < 1 || n > (1ll << 31)) return static_cast<int>(cudaErrorInvalidValue);
  const long long tiles = (n + kLinearTile - 1) / kLinearTile;
  out[0] = 2 + tiles;
  out[1] = tiles * 8;
  return 0;
}

// total, s: (4, 2^log_n) words; claimed: 4 words; head, work: the scratch
// of logup_scan_scratch. Returns the CUDA error.
extern "C" int logup_scan_coset(const void* total, void* s, void* claimed, void* head, void* work,
                                int log_n, void* stream) {
  if (log_n < 2 || log_n > 30) return static_cast<int>(cudaErrorInvalidValue);
  CosetArgs a;
  a.total = static_cast<const uint32_t*>(total);
  a.s = static_cast<uint32_t*>(s);
  a.claimed = static_cast<uint32_t*>(claimed);
  a.head = static_cast<uint32_t*>(head);
  a.log_n = log_n;
  a.g = geometry(log_n);
  a.agg = static_cast<uint32_t*>(work);
  a.incl = a.agg + static_cast<size_t>(a.g.tiles) * kVec;
  a.off = a.incl + static_cast<size_t>(a.g.tiles) * kVec;
  coset_scan_kernel<<<2 * a.g.tiles, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// x, s: (4, n) words; total: 4 words; carry: 4 words or null.
extern "C" int logup_scan_linear(const void* x, void* s, void* total, const void* carry,
                                 void* head, void* work, long long n, void* stream) {
  if (n < 1 || n > (1ll << 31)) return static_cast<int>(cudaErrorInvalidValue);
  LinearArgs a;
  a.x = static_cast<const uint32_t*>(x);
  a.s = static_cast<uint32_t*>(s);
  a.total = static_cast<uint32_t*>(total);
  a.carry = static_cast<const uint32_t*>(carry);
  a.head = static_cast<uint32_t*>(head);
  a.n = static_cast<uint32_t>(n);
  a.tiles = static_cast<int>((n + kLinearTile - 1) / kLinearTile);
  a.agg = static_cast<uint32_t*>(work);
  a.incl = a.agg + static_cast<size_t>(a.tiles) * 4;
  linear_scan_kernel<<<a.tiles, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
