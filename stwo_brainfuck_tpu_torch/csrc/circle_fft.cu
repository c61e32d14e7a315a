// Circle FFT over M31 (p = 2^31 - 1) for Hopper (sm_90a).
//
// Replaces the two Pallas passes of the JAX package's circle FFT,
// stwo_brainfuck_tpu/ops/fft_pallas.py::_make_pass1 (stages whose pair
// stride is >= A2*128) and ::_make_pass2 (the remaining row stages and the
// 7 lane stages). Same function, bit for bit: the butterfly network of
// stwo_brainfuck_tpu/core/fft.py on bit-reversed storage.
//
//   evaluate:    stages L = n-1 .. 0, (u, v) -> (u + t*v, u - t*v)
//   interpolate: stages L = 0 .. n-1, (u, v) -> (u + v, t*(u - v)),
//                then * 2^-n (at the store of the last pass)
//
// Stage L pairs element i0 = k*2^(L+1) + j with i1 = i0 + 2^L and uses
// twiddle tw[off(L) + k], k = i0 >> (L+1), off(L) = 2^N - 2^(N-L) in the
// per-stage twiddles of a domain of size 2^N, concatenated.
//
// What bounds it on this card. A pass reads and writes every element once
// (8 bytes per element) and does about 8 integer instructions per
// butterfly; at 2^24 both bounds are near 0.2 ms for 4 columns, so the
// number of passes, the instructions around each butterfly and the
// twiddle traffic decide the time. The design:
//
// * Passes (ops/circle_fft.py::pass_plan): a tile pass of up to 13 stages
//   on contiguous 2^13-element tiles, and global passes of up to 11 higher
//   stages on 2^S x 2^w tiles (2^w >= 8 consecutive words: whole 32-byte
//   sectors). Every transform up to 2^24 takes at most two passes.
// * Register radix: a thread holds 2^R elements (R = 4, or 5 for 2^14
//   tiles; 512 threads) and runs up to R consecutive stages on them in
//   registers. The tile lives in shared memory between these groups of
//   stages, in an XOR-swizzled layout (swz below) that keeps 16-byte
//   chunks whole and makes the exchanges nearly free of bank conflicts
//   (at most 2-way; the CPU tests check the degree). So there is one
//   barrier and one shared-memory round trip per R stages, not per stage.
//   Index arithmetic is 32-bit inside a tile.
// * Twiddles are staged once per block into shared memory, coalesced: a
//   block walks several rows (columns) of one tile position, so a tile's
//   twiddle segment comes from device memory once per block, not once per
//   column.
// * Loads are 16-byte cp.async copies into a two-tile ring: the next row's
//   tile is in flight while this one computes. Stores are 16-byte.
// * The fused extend (kMode 2): coefficients zero-padded from 2^n to
//   2^(n+b) pair every element with an exact zero in the top b forward
//   stages, so the blown-up evaluation is 2^b copies of the coefficients,
//   copy c running the n low stages with stage L's twiddles taken from
//   offset c * 2^(n-1-L) of the big domain's table. One launch takes a
//   tile through the last inverse pass, writes the coefficients and then
//   the first forward pass of every copy; no zero buffer is written.
//
// Arithmetic (csrc/m31.cuh) is canonical: values stay in [0, p) and each
// add, subtract and product ends in one fused add-and-min instruction
// (VIADDMNMX). A semi-reduced form ([0, p], one canonicalization per pass)
// costs as much here: its Mersenne fold is two instructions where the
// conditional subtract is one. The twiddles are stored doubled (2t < 2^32),
// which takes one instruction off each product (m31::mul_doubled).
//
// src may equal dst: a block reads and writes only its own tiles.

#include <cstdint>
#include <cuda_runtime.h>

#include "m31.cuh"

namespace {

using m31::add;
using m31::mul;
using m31::mul_doubled;
using m31::sub;

constexpr int kMaxThreadsLog = 9;

struct PassArgs {
  const uint32_t* src;     // rows of 2^n
  uint32_t* dst;           // rows of 2^n (kMode 2: the coefficients)
  uint32_t* ext;           // kMode 2: 2^copies_log rows of 2^n per source row
  const uint32_t* tw_inv;  // doubled twiddles of the size-2^n domain, inverse
  const uint32_t* tw_fwd;  // doubled twiddles of the size-2^(n+copies_log) domain
  int n, copies_log, l0, s_count, w_log;
  int rows, rows_per_block;
  uint32_t scale;          // inverse: multiply at the store (1 = none)
};

// Shared-memory address of tile element e: XOR bits 2-4 with bits 5-7 and
// 6-8. Linear over GF(2), a bijection, and 4-word chunks stay whole.
__device__ __forceinline__ int swz(int e) {
  return e ^ ((((e >> 5) ^ (e >> 6)) & 7) << 2);
}

__device__ __forceinline__ void cp_async16(uint32_t* smem, const uint32_t* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}

__device__ __forceinline__ void cp_async4(uint32_t* smem, const uint32_t* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_prev() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

// The tile of one block: position, geometry and the offset of element e in
// its row.
struct Tile {
  int n, l0, s, w, t;  // t = s + w: the tile holds 2^t elements
  int high, base;

  __device__ Tile(const PassArgs& a)
      : n(a.n), l0(a.l0), s(a.s_count), w(a.w_log), t(a.s_count + a.w_log) {
    const int pos = blockIdx.x;
    const int chunk_log = l0 - w;
    high = pos >> chunk_log;
    base = (high << (l0 + s)) + ((pos & ((1 << chunk_log) - 1)) << w);
  }
  __device__ int offset(int e) const {
    return base + ((e >> w) << l0) + (e & ((1 << w) - 1));
  }
};

// Global row -> swizzled shared tile, as cp.async copies (one commit group).
__device__ __forceinline__ void load_tile(uint32_t* tile, const uint32_t* row, const Tile& g) {
  if (g.t >= 2) {
    for (int v = threadIdx.x; v < (1 << (g.t - 2)); v += blockDim.x) {
      const int e = v << 2;
      cp_async16(tile + swz(e), row + g.offset(e));
    }
  } else {
    for (int e = threadIdx.x; e < (1 << g.t); e += blockDim.x) {
      cp_async4(tile + swz(e), row + g.offset(e));
    }
  }
  cp_async_commit();
}

// Shared tile -> global row, times `scale` (1 = none); with `keep` the
// scaled values also go back into the tile.
__device__ __forceinline__ void store_tile(uint32_t* tile, uint32_t* row, const Tile& g, uint32_t scale,
                           bool keep) {
  if (g.t >= 2) {
    for (int v = threadIdx.x; v < (1 << (g.t - 2)); v += blockDim.x) {
      const int e = v << 2;
      uint4 q = *reinterpret_cast<const uint4*>(tile + swz(e));
      if (scale != 1u) {
        q.x = mul(q.x, scale);
        q.y = mul(q.y, scale);
        q.z = mul(q.z, scale);
        q.w = mul(q.w, scale);
        if (keep) *reinterpret_cast<uint4*>(tile + swz(e)) = q;
      }
      *reinterpret_cast<uint4*>(row + g.offset(e)) = q;
    }
  } else {
    for (int e = threadIdx.x; e < (1 << g.t); e += blockDim.x) {
      uint32_t v = tile[swz(e)];
      if (scale != 1u) {
        v = mul(v, scale);
        if (keep) tile[swz(e)] = v;
      }
      row[g.offset(e)] = v;
    }
  }
}

// The tile's twiddles of one direction into shared memory: stage s (tile
// stage, L = l0 + s) at offset 2^S - 2^(S-s), its 2^(S-1-s) entries
// table[off(L) + (copy << (n-1-L)) + (high << (S-1-s)) + m], with off(L)
// that of the size-2^big domain.
__device__ __forceinline__ void stage_twiddles(uint32_t* tw, const uint32_t* __restrict__ table, int big,
                               int copy, const Tile& g) {
  const int total = (1 << g.s) - 1;
  for (int i = threadIdx.x; i < total; i += blockDim.x) {
    const int s = g.s - 1 - (31 - __clz(total - i));
    const int m = i - ((1 << g.s) - (1 << (g.s - s)));
    const int L = g.l0 + s;
    const int64_t idx = ((int64_t{1} << big) - (int64_t{1} << (big - L))) +
                        (static_cast<int64_t>(copy) << (g.n - 1 - L)) +
                        (static_cast<int64_t>(g.high) << (g.s - 1 - s)) + m;
    tw[i] = __ldg(table + idx);
  }
}

// One group of G stages (tile stages s0 .. s0+G-1) on the thread's 2^R
// elements, read from `in` and written to the same places in `out`.
// Register k holds tile element e = ebase | (k & (2^F-1)) | ((k >> F) << (w+s0)),
// F = R - G: the low F bits of k are "filler" positions 0 .. F-1 (below the
// group, which is the top group whenever G < R), the thread's own bits fill
// the remaining positions in increasing order.
template <int R, int G, bool kInverse>
__device__ __forceinline__ void run_group(const uint32_t* in, uint32_t* out,
                                          const uint32_t* tw, const Tile& g, int s0) {
  constexpr int F = R - G;
  constexpr int K = 1 << R;
  const int gpos = g.w + s0;             // tile bit of the group's first stage
  const int a_bits = gpos - F;           // thread bits below the group
  const int tid = threadIdx.x;
  const int ebase = ((tid & ((1 << a_bits) - 1)) << F) | ((tid >> a_bits) << (gpos + G));

  int addr[K];
  addr[0] = swz(ebase);
#pragma unroll
  for (int k = 1; k < K; ++k) {
    int j = 0;  // the lowest set bit of k, known at compile time
    while (!(k & (1 << j))) ++j;
    const int bit = j < F ? (1 << j) : (1 << (gpos + j - F));
    addr[k] = addr[k & (k - 1)] ^ swz(bit);
  }

  // Registers k .. k+3 are 4 consecutive words (one 16-byte access) when k's
  // two low bits are tile bits 0 and 1.
  const bool vec = R >= 2 && (F >= 2 || gpos == F);
  uint32_t x[K];
  if constexpr (R < 2) {
#pragma unroll
    for (int k = 0; k < K; ++k) x[k] = in[addr[k]];
  } else if (vec) {
#pragma unroll
    for (int k = 0; k < K; k += 4) {
      const uint4 q = *reinterpret_cast<const uint4*>(in + addr[k]);
      x[k] = q.x;
      x[k + 1] = q.y;
      x[k + 2] = q.z;
      x[k + 3] = q.w;
    }
  } else {
#pragma unroll
    for (int k = 0; k < K; ++k) x[k] = in[addr[k]];
  }

#pragma unroll
  for (int jj = 0; jj < G; ++jj) {
    const int j = kInverse ? jj : G - 1 - jj;
    const int s = s0 + j;
    // twiddle m' = (e >> (w+s+1)) = (ebase >> (w+s+1)) | ((k >> F) >> (j+1))
    const uint32_t* tws = tw + ((1 << g.s) - (1 << (g.s - s))) + (ebase >> (g.w + s + 1));
    uint32_t t[1 << (G - 1)];
#pragma unroll
    for (int q = 0; q < (1 << (G - 1 - j)); ++q) t[q] = tws[q];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      if (k & (1 << (F + j))) continue;
      const int k1 = k | (1 << (F + j));
      const uint32_t tk = t[(k >> F) >> (j + 1)];
      const uint32_t u = x[k];
      const uint32_t v = x[k1];
      if (kInverse) {
        x[k] = add(u, v);
        x[k1] = mul_doubled(sub(u, v), tk);
      } else {
        const uint32_t tv = mul_doubled(v, tk);
        x[k] = add(u, tv);
        x[k1] = sub(u, tv);
      }
    }
  }

  if constexpr (R < 2) {
#pragma unroll
    for (int k = 0; k < K; ++k) out[addr[k]] = x[k];
  } else if (vec) {
#pragma unroll
    for (int k = 0; k < K; k += 4) {
      *reinterpret_cast<uint4*>(out + addr[k]) = make_uint4(x[k], x[k + 1], x[k + 2], x[k + 3]);
    }
  } else {
#pragma unroll
    for (int k = 0; k < K; ++k) out[addr[k]] = x[k];
  }
}

template <int R, bool kInverse>
__device__ __forceinline__ void group_dispatch(int G, const uint32_t* in, uint32_t* out, const uint32_t* tw,
                               const Tile& g, int s0) {
  if (G == 1) return run_group<R, 1, kInverse>(in, out, tw, g, s0);
  if constexpr (R >= 2) if (G == 2) return run_group<R, 2, kInverse>(in, out, tw, g, s0);
  if constexpr (R >= 3) if (G == 3) return run_group<R, 3, kInverse>(in, out, tw, g, s0);
  if constexpr (R >= 4) if (G == 4) return run_group<R, 4, kInverse>(in, out, tw, g, s0);
  if constexpr (R >= 5) if (G == 5) return run_group<R, 5, kInverse>(in, out, tw, g, s0);
}

// All S stages of the tile: groups of R stages from the bottom, the top
// group holding the remainder; inverse runs them upwards, forward downwards.
// The first group reads `in`, every group writes `out`; a barrier follows
// each group.
template <int R, bool kInverse>
__device__ __forceinline__ void transform(const uint32_t* in, uint32_t* out, const uint32_t* tw, const Tile& g) {
  const int groups = (g.s + R - 1) / R;
  for (int i = 0; i < groups; ++i) {
    const int gi = kInverse ? i : groups - 1 - i;
    const int s0 = gi * R;
    const int G = gi == groups - 1 ? g.s - s0 : R;
    group_dispatch<R, kInverse>(G, i == 0 ? in : out, out, tw, g, s0);
    __syncthreads();
  }
}

// kMode 0: forward stages, src -> dst; source row r of copy c is row
// (r << copies_log) + c of both, with copy c's twiddles.
// kMode 1: inverse stages, src -> dst, times `scale` at the store.
// kMode 2: the fused extend's pass: inverse stages and `scale`, the
// coefficients to dst, then for each copy c the forward stages with copy
// c's twiddles, to row (r << copies_log) + c of ext.
template <int R, int kMode>
__global__ void __launch_bounds__(1 << kMaxThreadsLog)
fft_pass(PassArgs a) {
  extern __shared__ __align__(16) uint32_t sm[];
  const Tile g(a);
  const int tile = 1 << g.t;
  uint32_t* work = sm + 2 * tile;                         // kMode 2
  uint32_t* tw_i = sm + (kMode == 2 ? 3 : 2) * tile;
  uint32_t* tw_f = kMode == 2 ? tw_i + (1 << g.s) : tw_i;
  const int copies = 1 << a.copies_log;
  const int copy = kMode == 0 ? static_cast<int>(blockIdx.y) & (copies - 1) : 0;
  const int r0 = (kMode == 0 ? static_cast<int>(blockIdx.y) >> a.copies_log
                             : static_cast<int>(blockIdx.y)) * a.rows_per_block;
  const int count = min(a.rows_per_block, a.rows - r0);
  const int rshift = kMode == 0 ? a.copies_log : 0;
  auto row = [&](int i) {  // element offset of the block's i-th row
    return static_cast<int64_t>(((r0 + i) << rshift) + copy) << a.n;
  };

  if (kMode == 0) stage_twiddles(tw_f, a.tw_fwd, a.n + a.copies_log, copy, g);
  else stage_twiddles(tw_i, a.tw_inv, a.n, 0, g);
  load_tile(sm, a.src + row(0), g);

  for (int i = 0; i < count; ++i) {
    uint32_t* buf = sm + ((i & 1) << g.t);  // the two-tile ring
    if (i + 1 < count) load_tile(sm + (((i + 1) & 1) << g.t), a.src + row(i + 1), g);
    else cp_async_commit();
    cp_async_wait_prev();
    __syncthreads();
    if (kMode == 0) {
      transform<R, false>(buf, buf, tw_f, g);
      store_tile(buf, a.dst + row(i), g, 1u, false);
    } else if (kMode == 1) {
      transform<R, true>(buf, buf, tw_i, g);
      store_tile(buf, a.dst + row(i), g, a.scale, false);
    } else {
      transform<R, true>(buf, buf, tw_i, g);
      store_tile(buf, a.dst + row(i), g, a.scale, true);
      const int64_t ext_row = static_cast<int64_t>(r0 + i) << a.copies_log;
      for (int c = 0; c < copies; ++c) {
        stage_twiddles(tw_f, a.tw_fwd, a.n + a.copies_log, c, g);
        __syncthreads();
        transform<R, false>(buf, work, tw_f, g);
        store_tile(work, a.ext + ((ext_row + c) << a.n), g, 1u, false);
        __syncthreads();
      }
    }
    __syncthreads();
  }
}

template <int R, int kMode>
int launch(const PassArgs& a, dim3 grid, int threads, size_t smem, cudaStream_t st) {
  const cudaError_t err = cudaFuncSetAttribute(
      fft_pass<R, kMode>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  fft_pass<R, kMode><<<grid, threads, smem, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <int R>
int launch_mode(int mode, const PassArgs& a, dim3 grid, int threads, size_t smem,
                cudaStream_t st) {
  if (mode == 0) return launch<R, 0>(a, grid, threads, smem, st);
  if (mode == 1) return launch<R, 1>(a, grid, threads, smem, st);
  return launch<R, 2>(a, grid, threads, smem, st);
}

}  // namespace

// One pass over a batch of rows (ops/circle_fft.py::launch_plan builds the
// arguments). Returns cudaGetLastError() after the launch (0 = launched);
// an argument the kernel cannot take returns cudaErrorInvalidValue.
extern "C" int circle_fft_pass(const void* src, void* dst, void* ext, const void* tw_inv,
                               const void* tw_fwd, int mode, int n, int copies_log, int l0,
                               int s_count, int w_log, int radix, int rows,
                               int rows_per_block, int scale, void* stream) {
  const int t = s_count + w_log;
  if (mode < 0 || mode > 2 || radix < 1 || radix > 5 || radix > t || t > n ||
      t - radix > kMaxThreadsLog || rows_per_block < 1 || rows < 1 || copies_log < 0 ||
      (mode == 1 && copies_log != 0) || (l0 == 0 ? w_log != 0 : w_log < 2 || w_log > l0)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  PassArgs a{static_cast<const uint32_t*>(src), static_cast<uint32_t*>(dst),
             static_cast<uint32_t*>(ext), static_cast<const uint32_t*>(tw_inv),
             static_cast<const uint32_t*>(tw_fwd), n, copies_log, l0, s_count, w_log,
             rows, rows_per_block, static_cast<uint32_t>(scale)};
  const int chunks = (rows + rows_per_block - 1) / rows_per_block;
  const dim3 grid(1u << (n - t), mode == 0 ? chunks << copies_log : chunks);
  const int tiles = mode == 2 ? 3 : 2;
  const size_t smem = sizeof(uint32_t) * ((static_cast<size_t>(tiles) << t) +
                                          ((mode == 2 ? 2u : 1u) << s_count));
  const int threads = 1 << (t - radix);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (radix) {
    case 1: return launch_mode<1>(mode, a, grid, threads, smem, st);
    case 2: return launch_mode<2>(mode, a, grid, threads, smem, st);
    case 3: return launch_mode<3>(mode, a, grid, threads, smem, st);
    case 4: return launch_mode<4>(mode, a, grid, threads, smem, st);
    default: return launch_mode<5>(mode, a, grid, threads, smem, st);
  }
}

// Never launched: two instantiations that differ only in 8 more products,
// so the difference of their SASS instruction counts over 8 is the cost of
// one m31::mul_doubled, the butterfly's product (chip_smoke.py reads it
// with cuobjdump for the dispatch bounds).
template <int K>
__global__ void mul_doubled_probe(uint32_t* x, uint32_t t2) {
  uint32_t v = x[threadIdx.x];
#pragma unroll
  for (int k = 0; k < K; ++k) v = m31::mul_doubled(v, t2);
  x[threadIdx.x] = v;
}
template __global__ void mul_doubled_probe<1>(uint32_t*, uint32_t);
template __global__ void mul_doubled_probe<9>(uint32_t*, uint32_t);
