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
//                then * 2^-n (folded into the last pass)
//
// Stage L pairs element i0 = k*2^(L+1) + j with i1 = i0 + 2^L and uses
// twiddle tw[off(L) + k], k = i0 >> (L+1), off(L) = 2^n - 2^(n-L): the
// compact per-stage twiddles of get_twiddles(n), concatenated.
//
// Schedule. One launch of stages_kernel runs S consecutive stages
// L0 .. L0+S-1. Element index i = high*2^(L0+S) + mid*2^L0 + low: the
// S stages only mix the S "mid" bits, so a block owns one (column, high,
// chunk of W consecutive lows) and all 2^S mids -- a 2^S x W tile held in
// shared memory across its stages, with __syncthreads() between stages.
// The tile pass is L0 = 0, W = 1 (a contiguous 2^S tile); the higher
// passes use W = 32 so that each warp loads one 128-byte line.
//
// What bounds it on the card: device-memory bandwidth. Each pass reads
// and writes every element once (8 bytes per element per pass) and does
// ~S M31 multiplies per element; a 2^24 transform takes 3 passes with
// 4096-element tiles (ops/circle_fft.py::pass_plan). The field arithmetic
// is csrc/m31.cuh: the product is one 64-bit multiply (mul.wide.u32) and a
// Mersenne fold, where the TPU version split 16-bit limbs for want of a
// 64-bit integer path.
//
// Inputs must be canonical (< p); outputs are canonical. src may equal dst:
// a block reads and writes only its own tile.

#include <cstdint>
#include <cuda_runtime.h>

#include "m31.cuh"

namespace {

using m31::add;
using m31::mul;
using m31::sub;

template <bool kInverse>
__global__ void stages_kernel(const uint32_t* src,
                              uint32_t* dst,
                              const uint32_t* __restrict__ tw,
                              int n, int l0, int s_count, int w_log,
                              uint32_t scale) {
  extern __shared__ uint32_t tile[];
  const int tile_log = s_count + w_log;
  const int elems = 1 << tile_log;
  const int w_mask = (1 << w_log) - 1;
  const int chunk_log = l0 - w_log;      // low chunks per high
  const int high_log = n - l0 - s_count;

  const uint64_t b = blockIdx.x;
  const uint64_t chunk = b & ((1ull << chunk_log) - 1);
  const uint64_t high = (b >> chunk_log) & ((1ull << high_log) - 1);
  const uint64_t col = b >> (chunk_log + high_log);
  const uint64_t base = (col << n) + (high << (l0 + s_count)) + (chunk << w_log);

  for (int e = threadIdx.x; e < elems; e += blockDim.x) {
    const uint64_t mid = static_cast<uint64_t>(e >> w_log);
    tile[e] = src[base + (mid << l0) + (e & w_mask)];
  }
  __syncthreads();

  const int pairs = elems >> 1;
  for (int i = 0; i < s_count; ++i) {
    const int s = kInverse ? i : s_count - 1 - i;  // stage L = l0 + s
    const int L = l0 + s;
    const uint32_t* tw_l = tw + ((1ull << n) - (1ull << (n - L)));
    const uint64_t tw_base = high << (s_count - s - 1);
    for (int p = threadIdx.x; p < pairs; p += blockDim.x) {
      const int lo = p & w_mask;
      const int m = p >> w_log;
      const int mblock = m >> s;
      const int mj = m & ((1 << s) - 1);
      const int mid0 = (mblock << (s + 1)) + mj;
      const int e0 = (mid0 << w_log) + lo;
      const int e1 = e0 + (1 << (s + w_log));
      const uint32_t t = tw_l[tw_base + mblock];
      const uint32_t u = tile[e0];
      const uint32_t v = tile[e1];
      if (kInverse) {
        tile[e0] = add(u, v);
        tile[e1] = mul(sub(u, v), t);
      } else {
        const uint32_t tv = mul(v, t);
        tile[e0] = add(u, tv);
        tile[e1] = sub(u, tv);
      }
    }
    __syncthreads();
  }

  for (int e = threadIdx.x; e < elems; e += blockDim.x) {
    const uint64_t mid = static_cast<uint64_t>(e >> w_log);
    uint32_t v = tile[e];
    if (scale != 1u) v = mul(v, scale);
    dst[base + (mid << l0) + (e & w_mask)] = v;
  }
}

}  // namespace

// One pass: stages l0 .. l0+s_count-1 of a (cols, 2^n) row-major matrix.
// Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int circle_fft_pass(const void* src, void* dst, const void* tw,
                               int cols, int n, int l0, int s_count,
                               int w_log, int inverse, int scale,
                               void* stream) {
  const int tile_log = s_count + w_log;
  const long long blocks = static_cast<long long>(cols) << (n - tile_log);
  const int pairs = 1 << (tile_log - 1);
  const int threads = pairs < 256 ? pairs : 256;
  const size_t smem = sizeof(uint32_t) << tile_log;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint32_t* s = static_cast<const uint32_t*>(src);
  uint32_t* d = static_cast<uint32_t*>(dst);
  const uint32_t* t = static_cast<const uint32_t*>(tw);
  if (inverse) {
    stages_kernel<true><<<static_cast<unsigned>(blocks), threads, smem, st>>>(
        s, d, t, n, l0, s_count, w_log, static_cast<uint32_t>(scale));
  } else {
    stages_kernel<false><<<static_cast<unsigned>(blocks), threads, smem, st>>>(
        s, d, t, n, l0, s_count, w_log, static_cast<uint32_t>(scale));
  }
  return static_cast<int>(cudaGetLastError());
}
