// The LogUp prefix sum for Hopper (sm_90a): S, the running QM31 sum of a
// component's per-row fraction sums, in one launch.
//
// Replaces the prefix half of stwo_brainfuck_tpu/framework/component.py:372
// _build_interaction_fn: :674 _qm31_cumsum over the row sums gathered into
// coset LINEAR order (where p - g is the previous point), scattered back to
// bit-reversed storage, and its last value, the claimed sum. The one-device
// prover computes the whole of that function in one launch (the fused
// interaction kernel, csrc/constraints.cu); this library keeps the prefix
// sum of given row sums for the mesh's shards (linear mode) and for any
// (4, N) row sums in storage order (coset mode). The plain version is
// framework/component.py prefix_sum_plain (gather, int64 cumsum, % p,
// scatter); addition mod p is exact, so any order of the sum gives the same
// words.
//
// coset_scan: total (4, N) int32 in storage order, N = 2^n; S (4, N) in
// storage order and the claimed sum (4 words), both on the card: the
// skeleton of csrc/logup_scan.cuh with the rows' sums read from `total`
// (kept on chip between the sweeps where they fit, else read again).
// linear_scan: x (4, n) already in linear order (a mesh shard's chunk), a
// QM31 carry-in (the shards before it) or none; S = carry + the inclusive
// sum, and carry + the whole sum (4 words): a warp scans its 256
// consecutive values in 8 rounds of 32 (shuffles), the CTA adds the warps
// before it, the tiles chain by decoupled look-back on 4-word vectors.
//
// What bounds it: bytes. The function reads 16 B a row and writes 16.

#include <cstdint>
#include <cuda_runtime.h>

#include "logup_scan.cuh"
#include "m31.cuh"

namespace {

using logup_scan::kThreads;
using logup_scan::kWarps;
using logup_scan::kInclusive;
using logup_scan::kAggregate;
using logup_scan::publish;
using logup_scan::look_back;

constexpr int kLinearPerLane = 8;
constexpr int kLinearTile = kThreads * kLinearPerLane;

// The rows' sums of the coset scan, read from a (4, N) tensor in storage
// order; not on chip, the second sweep reads them from it again.
struct TotalSource {
  struct Args {
    const uint32_t* total;
  };
  static constexpr bool kKeepsSums = false;

  static __device__ __forceinline__ void pair(const Args& a, int log_n, uint32_t j,
                                              uint2 (&x)[4], uint2 (&y)[4]) {
    const size_t n = size_t(1) << log_n;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      x[q] = __ldcg(reinterpret_cast<const uint2*>(a.total + q * n + 2 * j));
      y[q] = __ldcg(reinterpret_cast<const uint2*>(a.total + q * n + n - 2 - 2 * j));
    }
  }
};

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

// out: col_log, row_log, tile_rows, tiles, rows_per_warp, on_chip of the
// coset scan of 2^log_n rows on the current device, and the resident tiles
// it was planned for (ops/constraint_kernels.py scan_geometry mirrors the
// first five from the last).
extern "C" int logup_scan_geometry(int log_n, int* out) {
  if (log_n < 2 || log_n > 30) return static_cast<int>(cudaErrorInvalidValue);
  const logup_scan::Geometry g = logup_scan::plan<TotalSource>(log_n);
  out[0] = g.col_log;
  out[1] = g.row_log;
  out[2] = g.tile_rows;
  out[3] = g.tiles;
  out[4] = g.rows_per_warp;
  out[5] = g.on_chip;
  out[6] = logup_scan::resident_tiles<TotalSource, false>(0);
  return static_cast<int>(cudaGetLastError());
}

// The scratch a linear launch of n values needs, in 32-bit words: out[0]
// the head (zeroed by the caller: ticket, unused, one flag a tile), out[1]
// the rest (uninitialized).
extern "C" int logup_scan_scratch(long long n, long long* out) {
  if (n < 1 || n > (1ll << 31)) return static_cast<int>(cudaErrorInvalidValue);
  const long long tiles = (n + kLinearTile - 1) / kLinearTile;
  out[0] = 2 + tiles;
  out[1] = tiles * 8;
  return 0;
}

// total, s: (4, 2^log_n) words; claimed: 4 words; work: 2 tiles x 256
// words (tiles of logup_scan_geometry). Returns the CUDA error.
extern "C" int logup_scan_coset(const void* total, void* s, void* claimed, void* work, int log_n,
                                void* stream) {
  if (log_n < 2 || log_n > 30) return static_cast<int>(cudaErrorInvalidValue);
  logup_scan::ScanArgs a;
  a.s = static_cast<uint32_t*>(s);
  a.claimed = static_cast<uint32_t*>(claimed);
  a.log_n = log_n;
  a.g = logup_scan::plan<TotalSource>(log_n);
  a.agg = static_cast<uint32_t*>(work);
  a.incl = a.agg + static_cast<size_t>(a.g.tiles) * logup_scan::kVec;
  a.sums = static_cast<uint32_t*>(const_cast<void*>(total));
  return logup_scan::launch<TotalSource>({static_cast<const uint32_t*>(total)}, a,
                                         static_cast<cudaStream_t>(stream));
}

// The first n words of the coset launches' head on the current device.
extern "C" int logup_scan_head(uint32_t* out, int n) { return logup_scan::head_words(out, n); }

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
