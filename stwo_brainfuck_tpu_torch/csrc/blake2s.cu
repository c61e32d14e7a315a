// BLAKE2s-256 for Hopper (sm_90a): a whole Merkle tree in one launch, one
// level of messages, and the proof-of-work nonce scan.
//
// Replaces stwo_brainfuck_tpu/core/blake2s.py:54 _compress_t as XLA fuses
// it into one device program per Merkle level (core/merkle.py:48
// _leaf_hash_jit, :60 _node_hash_jit, :68 _chain_hash_jit, on the schedule
// of level_plan, :78) and per PoW batch (core/channel.py:137 _pow_batch).
// Those are jnp, not Pallas kernels. Digests are bit-identical to
// hashlib.blake2s and to the plain torch version
// (stwo_brainfuck_tpu_torch/core/blake2s.py hash_parts).
//
// Entry points (each launches on the caller's stream, allocates nothing and
// returns the CUDA error):
//   blake2s_tree   levels k_top .. 0 of a tree in one launch: node i of
//                  level k hashes child 2i || child 2i+1 (level k + 1) ||
//                  the column words injected at level k, row i. The caller
//                  gives a column table (pointer, row stride, column count
//                  a level; a row slice of a larger matrix keeps its
//                  stride), the digests below k_top or none, and a stage
//                  table (ops/blake2s_kernels.py tree_stages). Level k is
//                  written to its (8, 2^k) slice of `out`, word offset
//                  8 * (2^k - 1).
//   blake2s_level  one level: node i hashes child 2i || child 2i+1 || the
//                  level's column words at i, or any (W, N) message set
//                  with a byte-length override (blake2s.hash_words).
//   blake2s_grind  the smallest nonce base + i, i < count, whose hash of
//                  digest || nonce as 8 little-endian bytes (40 bytes) has
//                  the low bits `mask` of word 0 zero: i atomicMin'd into
//                  *best. Persistent CTAs walk ascending tiles of 256
//                  nonces in a fixed wave order (CTA c takes tiles c,
//                  c + G, c + 2G, ... of a grid of G) and a thread reads
//                  *best (acquire) before each tile, stopping once it is
//                  below the tile's first nonce: every nonce below the
//                  answer is hashed, few above it are.
//   blake2s_chain  a timing probe, off every path: `chain` dependent
//                  compressions a thread.
//
// The tree kernel. A CTA of 256 threads owns 2^8 consecutive nodes of its
// stage's first level, one a thread, and carries them up in shared memory
// (8 KB and 4 KB, alternating levels, a barrier a level), writing every
// level to device memory as it goes: to 2^5 nodes in a tree whose first
// stage has more CTAs than the card holds at once (so that its narrow
// levels do not idle SMs that have CTAs waiting), else to one node. Thread
// 0 then arrives at its group's counter with one acq_rel atomic (after a
// barrier, so the release covers the CTA's writes; the CTA reads after
// another barrier): the CTA that arrives last in its group reads the
// group's digests through L2 (__ldcg) and goes on up as a CTA of the next
// stage, and the one CTA of the last stage writes the root. No CTA waits
// for another, so the kernel needs no co-residency. The counters sit behind
// the digests in the tree's own buffer and are zeroed on the stream before
// the launch.
//
// What bounds it on the card: integer instructions. A compression is 80
// quarter-round steps G of 12 instructions (two three-input adds, two adds,
// four xors, four rotations), ~1,000 in all, for 64 message bytes; only a
// level with many columns and no children moves enough bytes (4 per word
// read, 32 per digest written) to approach the memory bound. A tree adds a
// latency floor: its root chain is one dependent compression a level (more
// where a level carries more than 16 message words). The design spends
// nothing beyond the hash and that chain: one launch a tree, so the narrow
// levels near the root run beside other subtrees' wide levels instead of
// as launches of their own; no 64-bit arithmetic inside a compression; the
// rotations by 12 and 7 are one funnel shift each and those by 16 and 8
// one byte permute; a + b + m is one three-input add; chaining value,
// state and message block live in registers (at most 64 a thread, so four
// CTAs share an SM); a block's 16 words are fetched by code specialised at
// compile time (children, or a column block of 1..16 words), one branch a
// block, never one a word; zero padding is never read or stored; the byte
// counter is 64 * (b + 1) and the last block carries the true length and
// the last-block flag.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
// A tree CTA owns 2^kSubtreeLog nodes of its stage's first level, one a thread.
constexpr int kSubtreeLog = 8;
static_assert(kThreads == 1 << kSubtreeLog, "one node a thread at a stage's first level");
constexpr int kMaxLevel = 28;  // level offsets stay in 32 bits
constexpr int kMaxStages = 12;

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

// ---------------------------------------------------------------------------
// The tree kernel
// ---------------------------------------------------------------------------

struct Level {           // the columns injected at one level
  const uint32_t* cols;  // (n_cols, 2^k) rows, row stride col_stride; null if none
  uint32_t col_stride;
  int n_cols;
};

struct Stage {
  int top;      // its first level, whose children are read from device memory
  int bottom;   // its last level: 2^(bottom - cta_log) nodes a CTA
  int cta_log;  // 2^cta_log CTAs, each hashing 2^(k - cta_log) nodes of level k
  int counter;  // its CTAs' arrival counters start here (stages after the first)
};

struct TreeArgs {
  const uint32_t* children;  // (8, 2^(k_top+1)) digests below k_top (row stride), or null
  uint32_t child_stride;
  uint32_t* out;             // level k: (8, 2^k) at word 8 * (2^k - 1)
  unsigned int* counters;    // the stages' arrival counters
  Stage stages[kMaxStages];
  Level levels[kMaxLevel + 1];
};

// Columns c0 .. c0 + R - 1 of a node (p = its first column word), zero past R.
template <int R>
__device__ __forceinline__ void fetch_columns(uint32_t m[16], const uint32_t* p, uint32_t stride) {
#pragma unroll
  for (int j = 0; j < 16; ++j) m[j] = j < R ? __ldg(p + j * stride) : 0u;
}

__device__ __forceinline__ void fetch_column_block(uint32_t m[16], const uint32_t* p,
                                                   uint32_t stride, int r) {
  switch (r) {
#define FETCH_CASE(R) \
  case R:             \
    fetch_columns<R>(m, p, stride); \
    break;
    FETCH_CASE(1) FETCH_CASE(2) FETCH_CASE(3) FETCH_CASE(4) FETCH_CASE(5) FETCH_CASE(6)
    FETCH_CASE(7) FETCH_CASE(8) FETCH_CASE(9) FETCH_CASE(10) FETCH_CASE(11) FETCH_CASE(12)
    FETCH_CASE(13) FETCH_CASE(14) FETCH_CASE(15)
#undef FETCH_CASE
    default:
      fetch_columns<16>(m, p, stride);
  }
}

// Children 2t and 2t + 1 of rows src[w * stride] (8-byte aligned pairs).
__device__ __forceinline__ void fetch_children_shared(uint32_t m[16], const uint32_t* src,
                                                      uint32_t stride, uint32_t t) {
#pragma unroll
  for (int w = 0; w < 8; ++w) {
    const uint2 x = *reinterpret_cast<const uint2*>(src + w * stride + 2 * t);
    m[w] = x.x;
    m[w + 8] = x.y;
  }
}

// The same from device memory written by other CTAs: through L2, never L1.
__device__ __forceinline__ void fetch_children_global(uint32_t m[16], const uint32_t* src,
                                                      uint32_t stride, uint32_t i) {
#pragma unroll
  for (int w = 0; w < 8; ++w) {
    const uint2 x = __ldcg(reinterpret_cast<const uint2*>(src + w * stride + 2 * i));
    m[w] = x.x;
    m[w + 8] = x.y;
  }
}

// One arrival at a group's counter, ordered after every write the CTA made
// before the barrier that precedes it (release) and before every read after
// the barrier that follows it (acquire); returns the arrivals before it.
__device__ __forceinline__ unsigned int arrive_acq_rel(unsigned int* counter) {
  unsigned int seen;
  asm volatile("atom.acq_rel.gpu.global.add.u32 %0, [%1], 1;"
               : "=r"(seen)
               : "l"(counter)
               : "memory");
  return seen;
}

__global__ void __launch_bounds__(kThreads, 4) tree_kernel(const __grid_constant__ TreeArgs a) {
  __shared__ __align__(16) uint32_t even[8 * kThreads];  // a stage's levels top, top - 2, ...
  __shared__ __align__(16) uint32_t odd[4 * kThreads];   // top - 1, top - 3, ...
  __shared__ bool carry;
  const uint32_t t = threadIdx.x;
  uint32_t cta = blockIdx.x;
  for (int j = 0;; ++j) {
    const Stage st = a.stages[j];
    for (int k = st.top; k >= st.bottom; --k) {
      const int n_log = k - st.cta_log;  // 2^n_log nodes of level k a CTA
      const int d = st.top - k;
      // children: from device memory at the stage's top (the caller's
      // digests in stage 0, if any; the previous stage's level after it),
      // else the level below in shared memory
      const uint32_t* gsrc = j == 0 ? a.children : a.out + 8u * ((2u << k) - 1u);
      const uint32_t gstride = j == 0 ? a.child_stride : 2u << k;
      const int kids = (d > 0 || gsrc != nullptr) ? 1 : 0;
      const uint32_t* ssrc = (d & 1) ? even : odd;
      uint32_t* dst = (d & 1) ? odd : even;
      uint32_t* level = a.out + 8u * ((1u << k) - 1u);
      const Level lv = a.levels[k];
      const int n_blocks = kids + (lv.n_cols + 15) / 16;
      const uint32_t n_bytes = 4u * (16u * kids + lv.n_cols);
      if (t < (1u << n_log)) {
        const uint32_t i = (cta << n_log) + t;
        const uint32_t* cp = lv.cols + i;
        uint32_t h[8];
        init_state(h);
#pragma unroll 1
        for (int b = 0; b < n_blocks; ++b) {
          uint32_t m[16];
          if (b < kids) {
            if (d > 0) {
              fetch_children_shared(m, ssrc, 2u << n_log, t);
            } else {
              fetch_children_global(m, gsrc, gstride, i);
            }
          } else {
            const int c0 = 16 * (b - kids);
            fetch_column_block(m, cp + c0 * lv.col_stride, lv.col_stride, lv.n_cols - c0);
          }
          const bool last = b == n_blocks - 1;
          compress(h, m, last ? n_bytes : 64u * (b + 1), 0u, last);
        }
#pragma unroll
        for (int w = 0; w < 8; ++w) {
          dst[(w << n_log) + t] = h[w];
          level[(w << k) + i] = h[w];
        }
      }
      __syncthreads();
    }
    if (st.cta_log == 0) return;  // the root is written
    // arrive: the last CTA of the group goes on as the next stage's CTA
    const int g = st.cta_log - a.stages[j + 1].cta_log;
    if (t == 0) {
      carry = arrive_acq_rel(a.counters + a.stages[j + 1].counter + (cta >> g)) == (1u << g) - 1u;
    }
    __syncthreads();
    if (!carry) return;
    cta >>= g;
  }
}

// ---------------------------------------------------------------------------
// One level (hash_words), the grind, the probes
// ---------------------------------------------------------------------------

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

__device__ __forceinline__ uint32_t load_acquire(const uint32_t* p) {
  uint32_t v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

// Tile t holds offsets t * kThreads .. t * kThreads + kThreads - 1; CTA c of
// the grid's G takes tiles c, c + G, c + 2G, ... (all CTAs resident at once:
// the wrapper launches a few an SM), so the nonces are hashed in ascending
// waves, and a thread stops at the first tile that starts above *best.
struct Digest {
  uint32_t w[8];
};

__global__ void __launch_bounds__(kThreads)
grind_kernel(const Digest d, unsigned long long base, uint32_t count, uint32_t mask,
             uint32_t* best) {
  const unsigned long long stride = static_cast<unsigned long long>(gridDim.x) * kThreads;
#pragma unroll 1
  for (unsigned long long start = static_cast<unsigned long long>(blockIdx.x) * kThreads;
       start < count; start += stride) {
    if (load_acquire(best) < start) return;
    const unsigned long long i = start + threadIdx.x;
    if (i >= count) return;
    const unsigned long long nonce = base + i;
    uint32_t m[16];
#pragma unroll
    for (int w = 0; w < 8; ++w) m[w] = d.w[w];
    m[8] = static_cast<uint32_t>(nonce);
    m[9] = static_cast<uint32_t>(nonce >> 32);
#pragma unroll
    for (int w = 10; w < 16; ++w) m[w] = 0u;
    uint32_t h[8];
    init_state(h);
    compress(h, m, 40u, 0u, true);
    if ((h[0] & mask) == 0u) atomicMin(best, static_cast<uint32_t>(i));
  }
}

// `chain` dependent compressions a thread of a block made from its index;
// the xor of the chaining value is written so that none is dropped.
__global__ void __launch_bounds__(kThreads) chain_kernel(uint32_t* __restrict__ out, uint32_t n,
                                                         int chain) {
  const uint32_t i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  uint32_t m[16];
#pragma unroll
  for (int j = 0; j < 16; ++j) m[j] = i ^ (0x9E3779B9u * (j + 1));
  uint32_t h[8];
  init_state(h);
#pragma unroll 1
  for (int k = 0; k < chain; ++k) compress(h, m, 64u, 0u, true);
  out[i] = h[0] ^ h[1] ^ h[2] ^ h[3] ^ h[4] ^ h[5] ^ h[6] ^ h[7];
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

extern "C" int blake2s_subtree_log() { return kSubtreeLog; }

// stages: n_stages quadruples (top, bottom, cta_log, counter), as
// tree_stages gives them; col_ptrs / col_strides / n_cols: k_top + 1
// entries, level k at k.
extern "C" int blake2s_tree(const void* children, long long child_stride, int k_top,
                            const void* const* col_ptrs, const long long* col_strides,
                            const int* n_cols, const int* stages, int n_stages, void* out,
                            void* counters, int n_counters, void* stream) {
  if (k_top < 0 || k_top > kMaxLevel || n_stages < 1 || n_stages > kMaxStages ||
      child_stride < 0 || child_stride > 0xFFFFFFFFll || n_counters < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  TreeArgs a;
  a.children = static_cast<const uint32_t*>(children);
  a.child_stride = static_cast<uint32_t>(child_stride);
  a.out = static_cast<uint32_t*>(out);
  a.counters = static_cast<unsigned int*>(counters);
  for (int k = 0; k <= kMaxLevel; ++k) a.levels[k] = Level{nullptr, 0u, 0};
  for (int k = 0; k <= k_top; ++k) {
    if (n_cols[k] < 0 || col_strides[k] < 0 || col_strides[k] > 0xFFFFFFFFll ||
        (n_cols[k] > 0) != (col_ptrs[k] != nullptr)) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    a.levels[k] = Level{static_cast<const uint32_t*>(col_ptrs[k]),
                        static_cast<uint32_t>(col_strides[k]), n_cols[k]};
  }
  // the deepest level needs a message: children below it or columns
  if (children == nullptr && n_cols[k_top] == 0) return static_cast<int>(cudaErrorInvalidValue);
  for (int j = 0; j < n_stages; ++j) {
    const Stage s{stages[4 * j], stages[4 * j + 1], stages[4 * j + 2], stages[4 * j + 3]};
    const int want_top = j == 0 ? k_top : a.stages[j - 1].bottom - 1;
    const bool final_stage = j == n_stages - 1;
    if (s.top != want_top || s.cta_log < 0 || s.bottom < s.cta_log || s.top < s.bottom ||
        s.top - s.cta_log > kSubtreeLog || (s.top - s.cta_log < kSubtreeLog && s.cta_log != 0) ||
        (s.cta_log == 0) != final_stage || (final_stage && s.bottom != 0) ||
        (j > 0 && (s.cta_log >= a.stages[j - 1].cta_log || s.counter < 0 ||
                   s.counter + (1 << s.cta_log) > n_counters))) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    a.stages[j] = s;
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n_counters > 0) {
    const cudaError_t rc = cudaMemsetAsync(counters, 0, sizeof(unsigned int) * n_counters, st);
    if (rc != cudaSuccess) return static_cast<int>(rc);
  }
  tree_kernel<<<1u << a.stages[0].cta_log, kThreads, 0, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

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

// digest: the 8 words in host memory (passed by value); ctas: the
// persistent grid (a few an SM). *best is set to 0xFFFFFFFF on the stream
// first: no offset below count reaches it, so it means no hit.
extern "C" int blake2s_grind(const unsigned int* digest, unsigned long long base,
                             unsigned int count, unsigned int mask, int ctas, void* best,
                             void* stream) {
  if (ctas < 1) return static_cast<int>(cudaErrorInvalidValue);
  Digest d;
  for (int w = 0; w < 8; ++w) d.w[w] = digest[w];
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t rc = cudaMemsetAsync(best, 0xFF, sizeof(uint32_t), st);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  grind_kernel<<<ctas, kThreads, 0, st>>>(d, base, count, mask, static_cast<uint32_t*>(best));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int blake2s_chain(void* out, unsigned int n, int chain, void* stream) {
  if (n == 0 || chain < 0) return static_cast<int>(cudaErrorInvalidValue);
  const unsigned int threads = n < kThreads ? n : kThreads;
  chain_kernel<<<(n + threads - 1) / threads, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<uint32_t*>(out), n, chain);
  return static_cast<int>(cudaGetLastError());
}
