// The 13 component matrices of a prove in one launch, for Hopper (sm_90a).
//
// Replaces stwo_brainfuck_tpu/components/device_build.py:176
// _build_tables_jit (jnp that XLA fuses into one executable over one
// uploaded buffer; not Pallas). The port's plain version is
// ops/table_kernels.py tables_plain (torch ops), bit for bit, and both
// equal the host builders of components/tables.py.
//
// Inputs, all left on the card by the meta pass
// (components/device_build.py device_meta): the trace rows as uploaded
// ((n, 7) words: clk ip ci ni mp mv mvi), the memory order (trace rows by
// (mp, clk)) and each sorted row's first memory row (the exclusive prefix
// of 1 + its clk gap), the instruction order (concat(program, trace) by
// (ip, clk)), the program table ((4, prog_cap)), the rows of ci[:-1]
// grouped by opcode table, and the end-of-execution row. The launch table
// (kHeaderWords + 13 kTableWords int64 words, staged from pinned memory)
// holds those pointers and sizes, then per matrix its pointer, kind,
// height, first block, columns, opcode rows and their first position.
//
// One flat grid covers every matrix: a block of kThreads rows of one
// matrix (each matrix's blocks follow the last's), a thread one row, all
// its columns: column c of row r at out[c * height + r], so a warp's
// stores of a column are coalesced. A successor column (next_*) is read
// from row r + 1 by the same thread, with the last row's rule (memory: clk
// + 1, mp and mv held, d = 1; instruction: ip held, ci = ni = 0, d = 1;
// processor: clk + 1), not a second pass.
//
// Memory row r comes from the sorted row i with the largest start <= r
// (the gap rows and, after the last row, the power-of-two pad continue its
// clk with mp and mv held: within = r - start, d = within > 0). A block's
// rows r0 .. r0 + 255 map to i0 .. i0 + 255 at most (every count is >= 1),
// so thread 0 finds i0 by a binary search in device memory, the block
// loads the 257 starts from i0 into shared memory, and each thread
// searches its first tid + 1 entries; the entry after its own says whether
// row r + 1 starts the next sorted row.
//
// Bound: bytes. The trace and the index arrays read once, each matrix
// written once: about 0.7 GB at big22's 2^22-row tables, 0.2 ms at 3.35
// TB/s. This first design gathers the trace rows a matrix needs (the memory
// and instruction orders are permutations; a row's successor is read
// again by the thread of row r + 1) and writes a row's columns from one
// thread; the writes are coalesced, the gathers mostly hit L2 (the trace
// is 37 MB at big22).
//
// Indices are 32-bit: the wrapper (ops/table_kernels.plan) refuses a
// matrix of more than 2^32 words and a trace of more than 2^32 words.

#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

#include "m31.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kHeaderWords = 16;
constexpr int kTableWords = 8;
constexpr int kTables = 13;
constexpr int kWords = kHeaderWords + kTables * kTableWords;

// header words
enum : int {
  kRows = 0, kOrderMem, kStartsMem, kOrderIns, kProg, kOps, kEndRow,
  kN, kPlen, kProgCap, kNumTables, kBlocks,
};
// a matrix's words
enum : int { kOut = 0, kKind, kHeight, kFirstBlock, kCols, kK, kStart };
// matrix kinds
enum : int { kMemory = 0, kInstruction, kProgram, kProcessor, kEnd, kJump, kOpcode };

struct Ctx {
  uint32_t* out;
  uint32_t height;
  uint32_t r;
  __device__ __forceinline__ void put(uint32_t c, uint32_t v) const { out[c * height + r] = v; }
};

__device__ __forceinline__ const uint32_t* trace_row(const uint32_t* rows, uint32_t i) {
  return rows + 7u * i;
}

__global__ void __launch_bounds__(kThreads) tables_kernel(const long long* __restrict__ table) {
  __shared__ long long words[kWords];
  __shared__ long long win[kThreads + 1];
  __shared__ uint32_t first_src;
  for (int w = threadIdx.x; w < kWords; w += kThreads) words[w] = table[w];
  __syncthreads();

  const uint32_t b = blockIdx.x;
  const int tables = static_cast<int>(words[kNumTables]);
  int t = 0;
  while (t + 1 < tables && static_cast<uint32_t>(
                               words[kHeaderWords + (t + 1) * kTableWords + kFirstBlock]) <= b) {
    ++t;
  }
  const long long* e = words + kHeaderWords + t * kTableWords;
  const int kind = static_cast<int>(e[kKind]);
  const uint32_t height = static_cast<uint32_t>(e[kHeight]);
  const uint32_t r0 = (b - static_cast<uint32_t>(e[kFirstBlock])) * kThreads;
  const uint32_t r = r0 + threadIdx.x;
  const Ctx o{reinterpret_cast<uint32_t*>(e[kOut]), height, r};
  const uint32_t* rows = reinterpret_cast<const uint32_t*>(words[kRows]);
  const uint32_t n = static_cast<uint32_t>(words[kN]);

  if (kind == kMemory) {  // block-uniform: the barriers below are reached by all
    const long long* order = reinterpret_cast<const long long*>(words[kOrderMem]);
    const long long* starts = reinterpret_cast<const long long*>(words[kStartsMem]);
    if (threadIdx.x == 0) {  // the largest i with starts[i] <= r0 (starts[0] = 0)
      uint32_t lo = 0, hi = n - 1;
      while (lo < hi) {
        const uint32_t mid = lo + (hi - lo + 1) / 2;
        if (starts[mid] <= static_cast<long long>(r0)) lo = mid; else hi = mid - 1;
      }
      first_src = lo;
    }
    __syncthreads();
    const uint32_t i0 = first_src;
    for (uint32_t w = threadIdx.x; w <= kThreads; w += kThreads) {
      win[w] = i0 + w < n ? starts[i0 + w] : LLONG_MAX;
    }
    __syncthreads();
    if (r >= height) return;
    uint32_t lo = 0, hi = threadIdx.x;
    while (lo < hi) {
      const uint32_t mid = (lo + hi + 1) >> 1;
      if (win[mid] <= static_cast<long long>(r)) lo = mid; else hi = mid - 1;
    }
    const uint32_t i = i0 + lo;
    const uint32_t within = r - static_cast<uint32_t>(win[lo]);
    const uint32_t* src = trace_row(rows, static_cast<uint32_t>(order[i]));
    const uint32_t clk = src[0] + within, mp = src[4], mv = src[5];
    o.put(0, clk);
    o.put(1, mp);
    o.put(2, mv);
    o.put(3, within > 0);
    uint32_t nclk = clk + 1, nmp = mp, nmv = mv, nd = 1;
    if (r + 1 < height && win[lo + 1] == static_cast<long long>(r) + 1) {
      const uint32_t* nxt = trace_row(rows, static_cast<uint32_t>(order[i + 1]));
      nclk = nxt[0];
      nmp = nxt[4];
      nmv = nxt[5];
      nd = 0;
    }
    o.put(4, nclk);
    o.put(5, nmp);
    o.put(6, nmv);
    o.put(7, nd);
    return;
  }
  if (r >= height) return;

  switch (kind) {
    case kInstruction: {
      const long long* order = reinterpret_cast<const long long*>(words[kOrderIns]);
      const uint32_t* prog = reinterpret_cast<const uint32_t*>(words[kProg]);
      const uint32_t plen = static_cast<uint32_t>(words[kPlen]);
      const uint32_t pc = static_cast<uint32_t>(words[kProgCap]);
      const uint32_t real = plen + n;  // rows past it repeat the last, ci = ni = 0, d = 1
      auto fetch = [&](uint32_t q, uint32_t* v) {
        const uint32_t g = static_cast<uint32_t>(order[min(q, real - 1)]);
        if (g < plen) {
          v[0] = prog[g];
          v[1] = prog[pc + g];
          v[2] = prog[2 * pc + g];
        } else {
          const uint32_t* s = trace_row(rows, g - plen);
          v[0] = s[1];
          v[1] = s[2];
          v[2] = s[3];
        }
        if (q >= real) v[1] = v[2] = 0;
      };
      uint32_t v[3];
      fetch(r, v);
      o.put(0, v[0]);
      o.put(1, v[1]);
      o.put(2, v[2]);
      o.put(3, r >= real);
      if (r + 1 == height) {
        o.put(4, v[0]);
        o.put(5, 0);
        o.put(6, 0);
        o.put(7, 1);
      } else {
        fetch(r + 1, v);
        o.put(4, v[0]);
        o.put(5, v[1]);
        o.put(6, v[2]);
        o.put(7, r + 1 >= real);
      }
      break;
    }
    case kProgram: {
      const uint32_t* prog = reinterpret_cast<const uint32_t*>(words[kProg]);
      for (uint32_t c = 0; c < 4; ++c) o.put(c, prog[c * height + r]);
      break;
    }
    case kProcessor: {
      const uint32_t* last = trace_row(rows, n - 1);
      auto clk_at = [&](uint32_t q) { return q < n ? rows[7u * q] : last[0] + 1 + (q - n); };
      if (r < n) {
        const uint32_t* s = trace_row(rows, r);
        for (uint32_t c = 0; c < 7; ++c) o.put(c, s[c]);
        o.put(7, 0);
      } else {
        o.put(0, clk_at(r));
        o.put(1, last[1]);
        for (uint32_t c = 2; c < 7; ++c) o.put(c, 0);
        o.put(7, 1);
      }
      o.put(8, clk_at(r + 1));
      break;
    }
    case kEnd: {
      const uint32_t end = static_cast<uint32_t>(
          *reinterpret_cast<const long long*>(words[kEndRow]));
      const uint32_t* s = trace_row(rows, end);
      for (uint32_t c = 0; c < 7; ++c) o.put(c, r == 0 ? s[c] : 0);
      break;
    }
    default: {  // kJump, kOpcode: matched row i paired with row i + 1, then pad rows
      const long long* ops = reinterpret_cast<const long long*>(words[kOps]) + e[kStart];
      const uint32_t k = static_cast<uint32_t>(e[kK]);
      const bool jump = kind == kJump;
      if (r < k) {
        const uint32_t s = static_cast<uint32_t>(ops[r]);
        const uint32_t* e1 = trace_row(rows, s);
        const uint32_t* e2 = trace_row(rows, s + 1);
        for (uint32_t c = 0; c < 7; ++c) o.put(c, e1[c]);
        if (jump) {
          // ... next_clk next_ip next_mp next_mv d is_mv_zero
          o.put(7, e2[0]);
          o.put(8, e2[1]);
          o.put(9, e2[4]);
          o.put(10, e2[5]);
          o.put(11, 0);
          o.put(12, m31::sub(1, m31::mul(e1[5], e1[6])));
        } else {
          // ... d next_ip next_mp next_mv
          o.put(7, 0);
          o.put(8, e2[1]);
          o.put(9, e2[4]);
          o.put(10, e2[5]);
        }
      } else {
        // pad: clk = the last pair's second clk + 2 (r - k), ip held, d = 1
        uint32_t lk = 0, li = 0;
        if (k > 0) {
          const uint32_t* tail = trace_row(rows, static_cast<uint32_t>(ops[k - 1]) + 1);
          lk = tail[0];
          li = tail[1];
        }
        const uint32_t clk = lk + 2 * (r - k);
        o.put(0, clk);
        o.put(1, li);
        for (uint32_t c = 2; c < 7; ++c) o.put(c, 0);
        if (jump) {
          o.put(7, clk + 1);
          o.put(8, li);
          o.put(9, 0);
          o.put(10, 0);
          o.put(11, 1);
          o.put(12, 1);
        } else {
          o.put(7, 1);
          o.put(8, li);
          o.put(9, 0);
          o.put(10, 0);
        }
      }
      break;
    }
  }
}

}  // namespace

// (threads, header words, table words, matrices) by index 0..3, for the
// wrapper's check of its copies.
extern "C" int tables_layout(int i) {
  const int v[4] = {kThreads, kHeaderWords, kTableWords, kTables};
  return i >= 0 && i < 4 ? v[i] : -1;
}

// table: the launch table on the card (ops/table_kernels.plan's words with
// the pointers filled); blocks: its block count. Returns the CUDA error of
// the launch.
extern "C" int tables_build(const void* table, long long blocks, void* stream) {
  if (table == nullptr || blocks < 1 || blocks > INT_MAX) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  tables_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                  static_cast<cudaStream_t>(stream)>>>(static_cast<const long long*>(table));
  return static_cast<int>(cudaGetLastError());
}
