// BLAKE2s-256 for Hopper (sm_90a): one Merkle level, the small top of a
// tree, and the proof-of-work nonce scan.
//
// Replaces stwo_brainfuck_tpu/core/blake2s.py:54 _compress_t as XLA fuses
// it into one device program per Merkle level (core/merkle.py:48
// _leaf_hash_jit, :60 _node_hash_jit, :68 _chain_hash_jit) and per PoW
// batch (core/channel.py:137 _pow_batch). Those are jnp, not Pallas
// kernels. Digests are bit-identical to hashlib.blake2s and to the plain
// torch version (stwo_brainfuck_tpu_torch/core/blake2s.py hash_parts).
//
// Entry points (each launches on the caller's stream, allocates nothing and
// returns cudaGetLastError()):
//   blake2s_level  one level: node i hashes child 2i || child 2i+1 || the
//                  level's column words at i. children (8, 2m) and columns
//                  (C, m) are word-leading int32 rows with a row stride, so
//                  thread i reads word w at [w][2i], [w][2i+1] or [w][i] and
//                  a warp's reads are coalesced. Either may be absent; with
//                  no children the columns are any (W, N) message set.
//   blake2s_tail   a run of digest-only levels k_top .. k_bottom (2^k_top
//                  <= 2^kTailLog nodes) in one CTA: each level is kept in
//                  shared memory for the next, with __syncthreads between
//                  levels, and written to its own (8, 2^k) slice of `out`
//                  (word offset 8 * (2^k - 2^k_bottom)).
//   blake2s_grind  nonces base .. base + count - 1: thread i hashes
//                  digest || (base + i) as 8 little-endian bytes (40 bytes)
//                  and, if the low bits `mask` of digest word 0 are zero,
//                  atomicMin's i into *best.
//
// What bounds them on the card: integer instructions. A compression is 80
// quarter-round steps G of 12 instructions (two three-input adds, two adds,
// four xors, four rotations), ~1,000 in all, for 64 message bytes; only a
// level with many columns and no children moves enough bytes (4 per word
// read, 32 per digest written) to approach the memory bound. The design
// spends nothing beyond the hash: no 64-bit arithmetic inside a
// compression; the rotations by 12 and 7 are one funnel shift each
// (__funnelshift_r) and those by 16 and 8 one byte permute (__byte_perm);
// a + b + m is one three-input add; the 8-word chaining value, the 16-word
// state and the 16-word message block live in registers (the message
// schedule SIGMA is unrolled into register indices); zero padding is never
// read or stored; the byte counter is 64 * (b + 1) and the last block
// carries the true length and the last-block flag.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
// The tail's first level has at most 2^kTailLog nodes: its digests (32 KB)
// and the next level's (16 KB) fill the 48 KB of static shared memory.
constexpr int kTailLog = 10;

#define IV0 0x6A09E667u
#define IV1 0xBB67AE85u
#define IV2 0x3C6EF372u
#define IV3 0xA54FF53Au
#define IV4 0x510E527Fu
#define IV5 0x9B05688Cu
#define IV6 0x1F83D9ABu
#define IV7 0x5BE0CD19u

__device__ __forceinline__ uint32_t rotr16(uint32_t x) { return __byte_perm(x, 0u, 0x1032); }
__device__ __forceinline__ uint32_t rotr8(uint32_t x) { return __byte_perm(x, 0u, 0x0321); }
__device__ __forceinline__ uint32_t rotr12(uint32_t x) { return __funnelshift_r(x, x, 12); }
__device__ __forceinline__ uint32_t rotr7(uint32_t x) { return __funnelshift_r(x, x, 7); }

#define G(a, b, c, d, x, y)     \
  do {                          \
    v[a] = v[a] + v[b] + (x);   \
    v[d] = rotr16(v[d] ^ v[a]); \
    v[c] = v[c] + v[d];         \
    v[b] = rotr12(v[b] ^ v[c]); \
    v[a] = v[a] + v[b] + (y);   \
    v[d] = rotr8(v[d] ^ v[a]);  \
    v[c] = v[c] + v[d];         \
    v[b] = rotr7(v[b] ^ v[c]);  \
  } while (0)

#define ROUND(s0, s1, s2, s3, s4, s5, s6, s7, s8, s9, s10, s11, s12, s13, s14, s15) \
  do {                                                                              \
    G(0, 4, 8, 12, m[s0], m[s1]);                                                   \
    G(1, 5, 9, 13, m[s2], m[s3]);                                                   \
    G(2, 6, 10, 14, m[s4], m[s5]);                                                  \
    G(3, 7, 11, 15, m[s6], m[s7]);                                                  \
    G(0, 5, 10, 15, m[s8], m[s9]);                                                  \
    G(1, 6, 11, 12, m[s10], m[s11]);                                                \
    G(2, 7, 8, 13, m[s12], m[s13]);                                                 \
    G(3, 4, 9, 14, m[s14], m[s15]);                                                 \
  } while (0)

// h[0] ^= 0x01010000 | 32: digest length 32, fanout 1, depth 1, no key.
__device__ __forceinline__ void init_state(uint32_t h[8]) {
  h[0] = IV0 ^ 0x01010020u;
  h[1] = IV1;
  h[2] = IV2;
  h[3] = IV3;
  h[4] = IV4;
  h[5] = IV5;
  h[6] = IV6;
  h[7] = IV7;
}

// One compression of the 16-word block m into h; t = (t_lo, t_hi) is the
// byte counter after this block.
__device__ __forceinline__ void compress(uint32_t h[8], const uint32_t m[16], uint32_t t_lo,
                                         uint32_t t_hi, bool last) {
  uint32_t v[16];
#pragma unroll
  for (int i = 0; i < 8; ++i) v[i] = h[i];
  v[8] = IV0;
  v[9] = IV1;
  v[10] = IV2;
  v[11] = IV3;
  v[12] = IV4 ^ t_lo;
  v[13] = IV5 ^ t_hi;
  v[14] = last ? ~IV6 : IV6;
  v[15] = IV7;
  ROUND(0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15);
  ROUND(14, 10, 4, 8, 9, 15, 13, 6, 1, 12, 0, 2, 11, 7, 5, 3);
  ROUND(11, 8, 12, 0, 5, 2, 15, 13, 10, 14, 3, 6, 7, 1, 9, 4);
  ROUND(7, 9, 3, 1, 13, 12, 11, 14, 2, 6, 5, 10, 4, 0, 15, 8);
  ROUND(9, 0, 5, 7, 2, 4, 10, 15, 14, 1, 11, 12, 6, 8, 3, 13);
  ROUND(2, 12, 6, 10, 0, 11, 8, 3, 4, 13, 7, 5, 15, 14, 1, 9);
  ROUND(12, 5, 1, 15, 14, 13, 4, 10, 0, 7, 6, 3, 9, 2, 8, 11);
  ROUND(13, 11, 7, 14, 12, 1, 3, 9, 5, 0, 15, 4, 8, 6, 2, 10);
  ROUND(6, 15, 14, 9, 11, 3, 0, 8, 12, 2, 13, 7, 1, 4, 10, 5);
  ROUND(10, 2, 8, 4, 7, 6, 1, 5, 15, 11, 9, 14, 3, 12, 13, 0);
#pragma unroll
  for (int i = 0; i < 8; ++i) h[i] ^= v[i] ^ v[i + 8];
}

struct LevelArgs {
  const uint32_t* children;  // (8, 2m) rows, or null
  long long child_stride;
  const uint32_t* columns;   // (n_cols, m) rows, or null
  long long col_stride;
  int n_words;               // 16 (with children) + n_cols
  int child_words;           // 16 or 0
  unsigned long long n_bytes;
  uint32_t* out;             // (8, m), contiguous
  long long m;
};

// Message word w of node i; 0 past the message (the padding).
__device__ __forceinline__ uint32_t level_word(const LevelArgs& a, long long i, int w) {
  if (w < a.child_words) {
    return __ldg(a.children + (w & 7) * a.child_stride + 2 * i + (w >> 3));
  }
  if (w < a.n_words) return __ldg(a.columns + (w - a.child_words) * a.col_stride + i);
  return 0u;
}

__global__ void __launch_bounds__(kThreads) level_kernel(const LevelArgs a) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= a.m) return;
  uint32_t h[8];
  init_state(h);
  const int n_blocks = a.n_words > 16 ? (a.n_words + 15) / 16 : 1;
#pragma unroll 1
  for (int b = 0; b < n_blocks; ++b) {
    uint32_t m[16];
#pragma unroll
    for (int j = 0; j < 16; ++j) m[j] = level_word(a, i, 16 * b + j);
    const bool last = b == n_blocks - 1;
    const unsigned long long t = last ? a.n_bytes : 64ull * (b + 1);
    compress(h, m, static_cast<uint32_t>(t), static_cast<uint32_t>(t >> 32), last);
  }
#pragma unroll
  for (int w = 0; w < 8; ++w) a.out[w * a.m + i] = h[w];
}

__global__ void __launch_bounds__(kThreads)
tail_kernel(const uint32_t* __restrict__ children, long long child_stride, int k_top,
            int k_bottom, uint32_t* __restrict__ out) {
  __shared__ uint32_t even[8 << kTailLog];       // levels k_top, k_top - 2, ...
  __shared__ uint32_t odd[8 << (kTailLog - 1)];  // levels k_top - 1, k_top - 3, ...
  for (int k = k_top; k >= k_bottom; --k) {
    const int n = 1 << k;
    const uint32_t* src = ((k_top - k) & 1) ? even : odd;  // level k + 1
    const long long src_stride = k == k_top ? child_stride : 2 * n;
    if (k == k_top) src = children;
    uint32_t* dst = ((k_top - k) & 1) ? odd : even;
    uint32_t* slice = out + 8ll * (n - (1 << k_bottom));
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      uint32_t m[16];
#pragma unroll
      for (int w = 0; w < 8; ++w) {
        m[w] = src[w * src_stride + 2 * i];
        m[w + 8] = src[w * src_stride + 2 * i + 1];
      }
      uint32_t h[8];
      init_state(h);
      compress(h, m, 64u, 0u, true);
#pragma unroll
      for (int w = 0; w < 8; ++w) {
        dst[w * n + i] = h[w];
        slice[w * n + i] = h[w];
      }
    }
    __syncthreads();
  }
}

__global__ void __launch_bounds__(kThreads)
grind_kernel(const uint32_t* __restrict__ digest, unsigned long long base, uint32_t count,
             uint32_t mask, uint32_t* __restrict__ best) {
  const uint32_t i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= count) return;
  const unsigned long long nonce = base + i;
  uint32_t m[16];
#pragma unroll
  for (int w = 0; w < 8; ++w) m[w] = __ldg(digest + w);
  m[8] = static_cast<uint32_t>(nonce);
  m[9] = static_cast<uint32_t>(nonce >> 32);
#pragma unroll
  for (int w = 10; w < 16; ++w) m[w] = 0u;
  uint32_t h[8];
  init_state(h);
  compress(h, m, 40u, 0u, true);
  if ((h[0] & mask) == 0u) atomicMin(best, i);
}

unsigned int blocks_for(long long n) {
  return static_cast<unsigned int>((n + kThreads - 1) / kThreads);
}

}  // namespace

// K chained compressions of one block a thread, never launched: two
// instantiations differ by exactly one compression, so chip_smoke.py reads
// a compression's SASS instruction count from them (cuobjdump).
template <int K>
__global__ void compress_probe(uint32_t* x) {
  uint32_t m[16];
  uint32_t h[8];
#pragma unroll
  for (int j = 0; j < 16; ++j) m[j] = x[16 * threadIdx.x + j];
  init_state(h);
#pragma unroll
  for (int k = 0; k < K; ++k) compress(h, m, 64u, 0u, true);
#pragma unroll
  for (int j = 0; j < 8; ++j) x[16 * threadIdx.x + j] = h[j];
}
template __global__ void compress_probe<1>(uint32_t*);
template __global__ void compress_probe<2>(uint32_t*);

extern "C" int blake2s_tail_log() { return kTailLog; }

// n_bytes < 0: the message's word count times 4.
extern "C" int blake2s_level(const void* children, long long child_stride, const void* columns,
                             long long col_stride, int n_cols, long long m, long long n_bytes,
                             void* out, void* stream) {
  LevelArgs a;
  a.children = static_cast<const uint32_t*>(children);
  a.child_stride = child_stride;
  a.columns = static_cast<const uint32_t*>(columns);
  a.col_stride = col_stride;
  a.child_words = children != nullptr ? 16 : 0;
  a.n_words = a.child_words + n_cols;
  a.n_bytes = n_bytes < 0 ? 4ull * a.n_words : static_cast<unsigned long long>(n_bytes);
  a.out = static_cast<uint32_t*>(out);
  a.m = m;
  level_kernel<<<blocks_for(m), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int blake2s_tail(const void* children, long long child_stride, int k_top,
                            int k_bottom, void* out, void* stream) {
  if (k_top > kTailLog || k_bottom < 0 || k_bottom > k_top) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  tail_kernel<<<1, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(children), child_stride, k_top, k_bottom,
      static_cast<uint32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int blake2s_grind(const void* digest, unsigned long long base, unsigned int count,
                             unsigned int mask, void* best, void* stream) {
  grind_kernel<<<blocks_for(count), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(digest), base, count, mask, static_cast<uint32_t*>(best));
  return static_cast<int>(cudaGetLastError());
}
