// The LogUp coset scan's skeleton for Hopper (sm_90a): S, the running QM31
// sum of a component's per-row fraction sums in coset LINEAR order, written
// back in bit-reversed storage order, and its last value, the claimed sum,
// in one launch. A template over where a row's sum comes from (`Src`):
//
// - a `total` tensor (TotalSource, csrc/logup_scan.cu: the prefix half of
//   stwo_brainfuck_tpu/framework/component.py:372 _build_interaction_fn);
// - a component's fractions, computed in the tile from the main columns and
//   stored as the Q_k columns on the way (csrc/constraint_kernel.cuh
//   FractionSource: the whole of _build_interaction_fn in one launch).
//
// The order. Linear point l = 2k sits at storage 2 rev(k) and l = 2k + 1 at
// N - 1 - 2 rev(k) (core/fft.py coset_order_permutation; rev over m = n - 1
// bits). So with P[k] = x[2 rev(k)] + x[N - 1 - 2 rev(k)] (x the row sums)
// and Pre the inclusive sum of P: S_lin[2k + 1] = Pre[k], S_lin[2k] = Pre[k]
// - (the odd one). Read the pair index j = rev(k) as a matrix, j = J 2^c + jl
// (C = 2^c columns, c = min(5, m - 1); R = 2^(m - c) rows): k = rev(jl)
// 2^(m - c) + rev(J), so linear order runs down column rev(jl) = 0 first,
// each column's rows in the order rev(J). Then
//   Pre = ColExcl[rev(jl)] + (the column's sum over rows up to rev(J)),
// ColExcl the sum of the whole columns before it. A row is 2^c consecutive
// j: coalesced. A lane owns a column, a warp a few rows, a tile (a CTA) a
// run of rows consecutive in the order rev(J), so the rows' sums chain from
// tile to tile with a vector of per-column sums.
//
// Mirrors. Row J's storage words 2j and N - 1 - 2j share their sectors with
// the odd and even words of the mirrored pair half - 1 - j (row ~J, column
// ~jl, chain position R - 1 - rev(J)). A tile takes rows of the first half
// of the chain and their mirrors, so a lane handles the storage rows 2j,
// 2j + 1, N - 2 - 2j and N - 1 - 2j, two uint2 a coordinate, every sector
// whole. The mirrors' prefix is
//   ColIncl[C - 1 - rev(jl)] - H,
// H the sum of the mirrors of the rows before this one in the tiles' order,
// which chains as the low rows do.
//
// The sweeps. ColExcl needs every row of every column, so no tile can write
// S before all were summed. One CTA a tile, the grid persistent: the first
// sweep gets its rows' sums from Src (16 words a lane and row), keeps them
// (on chip: shared memory; else a (4, N) scratch in storage order, which
// for a `total` tensor is the tensor itself), sums them per lane, publishes
// the tile's vector (256 words) and finds the sum of the tiles before it by
// decoupled look-back (warp 0 reads 32 flags at once; aggregates back to the
// nearest inclusive prefix). It then waits for the last tile's inclusive
// vector (the column totals; ColExcl by a warp scan in key order), and the
// second sweep writes S from the kept sums.
//
// Deadlock freedom. CTAs take tickets from a counter in the order they
// start, and a tile is its ticket: the look-back waits only on tiles whose
// CTAs are already running. The wait for the last tile needs every tile
// running at once: the grid is at most the kernel's occupancy times the SMs
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor at the launch's shared
// memory), so every CTA is resident, or becomes so as other kernels' CTAs
// leave the SMs.
//
// The head resets itself. The head (ticket, exit count, a flag a tile) is
// a module global, g_head: one a device for the library, zero when it is
// loaded. A CTA counts itself out once it has read its last flag, and the
// last one out zeroes the head for the next launch: no fill runs before a
// launch and nothing is allocated for it. The library's coset launches on
// a device run in stream order (the prover's one stream).
//
// Tiles. Tiles of tile_rows rows (a power of two, at least kMinTileRows
// where the chain has them: two rows a warp, which measured faster than one
// on an H100 at 2^18 rows and no slower elsewhere, tools/
// interaction_variants.py), as few as keep every resident CTA slot busy:
// tiles <= max_tiles, the kernel's occupancy times the SMs. The sums stay
// on chip when the tile's 2 KB a row fit in kMaxOnChipBytes of shared
// memory and the tiles still fit on the card at that size.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#include "m31.cuh"

namespace logup_scan {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kVec = 256;      // a tile's vector: 32 lanes x (4 row words, 4 mirror words)
constexpr int kSumWords = 16;  // a lane's row: 4 coordinates x 4 storage rows
constexpr int kMinTileRows = 16;
constexpr int kMaxOnChipBytes = 96 * 1024;
constexpr int kMaxTiles = 4096;  // the head's flags

constexpr uint32_t kEmpty = 0, kAggregate = 1, kInclusive = 2;

// ticket, exit count, flags[tiles]: zero before every coset launch and after
__device__ uint32_t g_head[2 + kMaxTiles];

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
  int on_chip;    // the sums kept in shared memory (else in the scratch)
};

// The tiles of 2^log_n rows with at most max_tiles CTAs (ops/constraint_
// kernels.py scan_geometry mirrors this); on_chip is decided at the launch.
inline Geometry tiles_for(int log_n, int max_tiles) {
  Geometry g;
  const int m = log_n - 1;
  g.col_log = m - 1 < 5 ? m - 1 : 5;
  g.row_log = m - g.col_log;
  const int low_rows = 1 << (g.row_log - 1);
  const int most = max_tiles > 1 ? max_tiles : 1;
  const int per_tile = (low_rows + most - 1) / most;
  int rows = kMinTileRows;
  while (rows < per_tile) rows <<= 1;
  g.tile_rows = rows < low_rows ? rows : low_rows;
  g.tiles = low_rows / g.tile_rows;
  g.rows_per_warp = g.tile_rows >> 3 > 1 ? g.tile_rows >> 3 : 1;
  g.on_chip = 0;
  return g;
}

// Shared memory for a tile's sums: 16 words a lane and row.
inline size_t on_chip_bytes(const Geometry& g) {
  return static_cast<size_t>(g.tile_rows) * kSumWords * 32 * sizeof(uint32_t);
}

struct ScanArgs {
  uint32_t* s;        // (4, N)
  uint32_t* claimed;  // 4
  uint32_t* agg;      // tiles x kVec
  uint32_t* incl;     // tiles x kVec
  uint32_t* sums;     // (4, N) in storage order: the kept sums when not on chip
  int log_n;
  Geometry g;
};

// The four storage rows of pair j in one coordinate: x = (2j, 2j + 1),
// y = (N - 2 - 2j, N - 1 - 2j).
__device__ __forceinline__ void load_sums(const uint32_t* rows, size_t n, uint32_t j,
                                          uint2 (&x)[4], uint2 (&y)[4]) {
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    x[q] = __ldcs(reinterpret_cast<const uint2*>(rows + q * n + 2 * j));
    y[q] = __ldcs(reinterpret_cast<const uint2*>(rows + q * n + n - 2 - 2 * j));
  }
}

__device__ __forceinline__ void store_sums(uint32_t* rows, size_t n, uint32_t j,
                                           const uint2 (&x)[4], const uint2 (&y)[4]) {
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    __stcg(reinterpret_cast<uint2*>(rows + q * n + 2 * j), x[q]);
    __stcg(reinterpret_cast<uint2*>(rows + q * n + n - 2 - 2 * j), y[q]);
  }
}

// Src: `Args`; `pair(args, log_n, j, x, y)`, the sums of pair j's four
// storage rows (and whatever Src writes on the way); kKeepsSums: the sums
// must be kept in `sums` when not on chip (false: `sums` is where Src read
// them).
template <class Src, bool kOnChip>
__global__ void __launch_bounds__(kThreads, 2)
    coset_scan_kernel(const typename Src::Args src, const ScanArgs a) {
  extern __shared__ uint32_t kept[];  // on chip: [row][16 words][32 lanes]
  __shared__ int ticket;
  __shared__ int look[2];
  __shared__ uint32_t part[kWarps][kVec];
  uint32_t* const head = g_head;
  if (threadIdx.x == 0) ticket = static_cast<int>(atomicAdd(head, 1u));
  __syncthreads();
  const int u = ticket;
  const int tiles = a.g.tiles;
  const int warp = threadIdx.x >> 5;
  const uint32_t lane = threadIdx.x & 31u;
  const uint32_t cols = 1u << a.g.col_log;
  const bool col_live = lane < cols;
  const int rpw = a.g.rows_per_warp;
  const int row0 = warp * rpw;
  const int row_end = min(row0 + rpw, a.g.tile_rows);
  const size_t n = size_t(1) << a.log_n;
  uint32_t* flags = head + 2;

  // the first sweep: the rows' sums, kept, and each lane's total
  uint32_t lsum[4] = {0u, 0u, 0u, 0u}, hsum[4] = {0u, 0u, 0u, 0u};
  if (col_live) {
    for (int rho = row0; rho < row_end; ++rho) {
      const uint32_t kr = static_cast<uint32_t>(u) * a.g.tile_rows + rho;
      const uint32_t j = (rev_bits(kr, a.g.row_log) << a.g.col_log) | lane;
      uint2 x[4], y[4];
      Src::pair(src, a.log_n, j, x, y);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        lsum[q] = m31::add(lsum[q], m31::add(x[q].x, y[q].y));
        hsum[q] = m31::add(hsum[q], m31::add(y[q].x, x[q].y));
      }
      if (kOnChip) {
        uint32_t* row = kept + rho * kSumWords * 32 + lane;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          row[(4 * q) * 32] = x[q].x;
          row[(4 * q + 1) * 32] = x[q].y;
          row[(4 * q + 2) * 32] = y[q].x;
          row[(4 * q + 3) * 32] = y[q].y;
        }
      } else if (Src::kKeepsSums) {
        store_sums(a.sums, n, j, x, y);
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
  // each warp's offsets (thread t reads and writes only word t)
#pragma unroll
  for (int w = 0; w < kWarps; ++w) part[w][t] = m31::add(excl, ex[w]);

  // every tile's inclusive vector is written once the last tile's is
  if (threadIdx.x == 0) {
    if (u != tiles - 1) {
      while (ld_acquire(flags + tiles - 1) != kInclusive) __nanosleep(128);
    }
    // no flag is read past here: count out; the last CTA out zeroes the head
    __threadfence();
    look[0] = atomicAdd(head + 1, 1u) == static_cast<uint32_t>(tiles - 1);
  }
  __syncthreads();
  if (look[0]) {
    __threadfence();
    for (int i = t; i < tiles + 2; i += kThreads) head[i] = 0u;
  }

  // the second sweep: S from the kept sums
  const uint32_t* last = a.incl + static_cast<size_t>(tiles - 1) * kVec + lane * 8;
  const uint32_t mirror = cols - 1;  // lane ^ mirror = C - 1 - lane
  const uint32_t key = col_live ? rev_bits(lane, a.g.col_log) : lane;
  uint32_t col_excl[4], mirror_incl[4], lo[4], hi[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    // column `lane`'s total: its rows (this lane) and its mirrors (lane C - 1 - lane)
    const uint32_t total =
        m31::add(__ldcg(last + q), __shfl_xor_sync(~0u, __ldcg(last + 4 + q), mirror));
    // in key order (lane = key): an inclusive warp scan
    const uint32_t v = __shfl_sync(~0u, total, key);
    uint32_t s = v;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const uint32_t up = __shfl_up_sync(~0u, s, d);
      if (lane >= static_cast<uint32_t>(d)) s = m31::add(s, up);
    }
    if (u == tiles - 1 && warp == 0 && lane == cols - 1) a.claimed[q] = s;
    col_excl[q] = __shfl_sync(~0u, m31::sub(s, v), key);
    mirror_incl[q] = __shfl_xor_sync(~0u, m31::add(col_excl[q], total), mirror);
    lo[q] = part[warp][lane * 8 + q];
    hi[q] = part[warp][lane * 8 + 4 + q];
  }
  if (!col_live) return;
  for (int rho = row0; rho < row_end; ++rho) {
    const uint32_t kr = static_cast<uint32_t>(u) * a.g.tile_rows + rho;
    const uint32_t j = (rev_bits(kr, a.g.row_log) << a.g.col_log) | lane;
    uint2 x[4], y[4];
    if (kOnChip) {
      const uint32_t* row = kept + rho * kSumWords * 32 + lane;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        x[q] = make_uint2(row[(4 * q) * 32], row[(4 * q + 1) * 32]);
        y[q] = make_uint2(row[(4 * q + 2) * 32], row[(4 * q + 3) * 32]);
      }
    } else {
      load_sums(a.sums, n, j, x, y);
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      lo[q] = m31::add(lo[q], m31::add(x[q].x, y[q].y));
      const uint32_t pre = m31::add(col_excl[q], lo[q]);       // S at 2j's linear pair
      const uint32_t pre_m = m31::sub(mirror_incl[q], hi[q]);  // at the mirror's
      hi[q] = m31::add(hi[q], m31::add(y[q].x, x[q].y));
      uint32_t* row = a.s + q * n;
      *reinterpret_cast<uint2*>(row + 2 * j) = make_uint2(m31::sub(pre, y[q].y), pre_m);
      *reinterpret_cast<uint2*>(row + n - 2 - 2 * j) = make_uint2(m31::sub(pre_m, x[q].y), pre);
    }
  }
}

// The kernel's occupancy on the current device at `smem` bytes of dynamic
// shared memory, times the SMs: the most tiles that are resident at once.
template <class Src, bool kOnChip>
int resident_tiles(size_t smem) {
  int dev = 0, sms = 0, occ = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (kOnChip) {  // once a device: every on-chip launch's shared memory fits
    cudaFuncSetAttribute(coset_scan_kernel<Src, true>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxOnChipBytes);
  }
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, coset_scan_kernel<Src, kOnChip>, kThreads,
                                                smem);
  return occ * sms;
}

// The launch's geometry on the current device: the tiles for the kernel's
// resident CTAs, kept on chip where they fit and stay resident. Cached a
// device and size (the occupancy queries are host work).
template <class Src>
Geometry plan(int log_n) {
  constexpr int kDevices = 64;
  static Geometry cache[kDevices][31];
  static bool known[kDevices][31];
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < kDevices && known[dev][log_n]) return cache[dev][log_n];
  Geometry g = tiles_for(log_n, resident_tiles<Src, false>(0));
  const size_t smem = on_chip_bytes(g);
  if (smem <= static_cast<size_t>(kMaxOnChipBytes) &&
      g.tiles <= resident_tiles<Src, true>(smem)) {
    g.on_chip = 1;
  }
  if (dev < kDevices) {
    cache[dev][log_n] = g;
    known[dev][log_n] = true;
  }
  return g;
}

// One launch (the geometry from plan<Src>); returns the CUDA error.
template <class Src>
int launch(const typename Src::Args& src, ScanArgs a, cudaStream_t stream) {
  if (a.g.tiles > kMaxTiles || a.g.tiles < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (a.g.on_chip) {  // plan set the kernel's shared-memory limit on this device
    coset_scan_kernel<Src, true><<<a.g.tiles, kThreads, on_chip_bytes(a.g), stream>>>(src, a);
  } else {
    coset_scan_kernel<Src, false><<<a.g.tiles, kThreads, 0, stream>>>(src, a);
  }
  return static_cast<int>(cudaGetLastError());
}

// The first n words of this device's head (a test reads it zero after
// launches); returns the CUDA error.
inline int head_words(uint32_t* out, int n) {
  if (n < 0 || n > 2 + kMaxTiles) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaMemcpyFromSymbol(out, g_head, n * sizeof(uint32_t)));
}

}  // namespace logup_scan
