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
// One flat grid covers every matrix: a block of kBlockRows = 4 x 256 rows
// of one matrix (each matrix's blocks follow the last's), a thread four
// rows kThreads apart (their loads in flight together, the block's fixed
// work, its table and the memory search, shared by 1,024 rows), all their
// columns: column c of row r at out[c * height + r], so a warp's stores of
// a column are coalesced. A successor column (next_*) is row r +
// 1's own column where the matrix's rule makes it so (memory: clk, mp, mv
// and d of row r + 1, a gap row or the next sorted row alike; instruction:
// ip, ci, ni and d of row r + 1; processor: clk of row r + 1), taken from
// lane + 1 with __shfl_down_sync; lane 31 fetches its own (row r + 1 is
// the next warp's), and the last row takes the last row's rule (memory:
// clk + 1, mp and mv held, d = 1; instruction: ip held, ci = ni = 0, d = 1;
// processor: clk + 1). In the jump and opcode tables a row's successor is
// trace row s + 1 of its matched row s, which lane + 1 holds where lane +
// 1's matched row is s + 1 (a run of one opcode): taken from it there,
// fetched elsewhere. Rows past a matrix's height stay alive through the
// shuffles and store nothing.
//
// Memory row r comes from the sorted row i with the largest start <= r
// (the gap rows and, after the last row, the power-of-two pad continue its
// clk with mp and mv held: within = r - start, d = within > 0). A block's
// rows r0 .. r0 + 1023 map to i0 .. i0 + 1023 at most (every count is >=
// 1), so the block finds i0 together: each round each of its 256 threads
// tests one of 256 evenly spaced probes of the interval left (starts[p] <=
// r0), __syncthreads_count gives how many hold, and the interval shrinks to
// one step, ceil(log_256 n) rounds (3 at 2^22 sorted rows, where one
// thread's binary search made 22 dependent loads while the block waited).
// The block then loads the 1,025 starts from i0 into shared memory, and
// the thread of row r0 + w searches the first w + 1 entries.
//
// Bound: bytes. The trace and the index arrays read once, each matrix
// written once: about 0.7 GB at big22's 2^22-row tables, 0.2 ms at 3.35
// TB/s. The design gathers the trace rows a matrix needs (the memory and
// instruction orders are permutations) and writes a row's columns from
// one thread; the writes are coalesced, the gathers mostly hit L2 (the
// trace is 37 MB at big22), and no row is gathered twice for its
// successor.
//
// Indices are 32-bit: the wrapper (ops/table_kernels.plan) refuses a
// matrix of more than 2^32 words and a trace of more than 2^32 words.

#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

#include "m31.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kSubRows = 4;                       // rows a thread, kThreads apart
constexpr int kBlockRows = kSubRows * kThreads;  // a block's rows of one matrix
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

constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ uint32_t from_next(uint32_t v) { return __shfl_down_sync(kFull, v, 1); }

// The largest i with starts[i] <= r0 (starts[0] = 0, strictly increasing,
// n entries), found by the whole block: a round's thread k tests probe lo +
// k step of the interval [lo, hi] left, step = ceil((hi - lo + 1) / 256),
// and the count of probes that hold leaves one step of it. Every thread
// returns it.
__device__ __forceinline__ uint32_t block_search(const long long* starts, uint32_t n,
                                                 long long r0) {
  uint32_t lo = 0, hi = n - 1;
  while (lo < hi) {  // block-uniform: lo and hi are the same in every thread
    const uint32_t step = (hi - lo) / kThreads + 1;
    const uint32_t p = lo + threadIdx.x * step;
    const int c = __syncthreads_count(p <= hi && starts[p] <= r0);
    const uint32_t top = lo + static_cast<uint32_t>(c) * step - 1;
    lo += static_cast<uint32_t>(c - 1) * step;
    hi = min(hi, top);
  }
  return lo;
}

// One memory row r: its source i0 + lo (the largest window entry <= r, a
// binary search over the first w + 1 entries, w = r - r0), its columns and
// its successor's.
__device__ __forceinline__ void memory_row(const Ctx& o, const long long* win, uint32_t w,
                                           uint32_t i0, const long long* order,
                                           const uint32_t* rows, bool live, bool own,
                                           bool last) {
  const uint32_t r = o.r;
  uint32_t lo = 0, hi = w;
  while (lo < hi) {
    const uint32_t mid = (lo + hi + 1) >> 1;
    if (win[mid] <= static_cast<long long>(r)) lo = mid; else hi = mid - 1;
  }
  const uint32_t i = i0 + lo;
  const uint32_t within = r - static_cast<uint32_t>(win[lo]);
  const uint32_t* src = trace_row(rows, static_cast<uint32_t>(order[i]));
  const uint32_t clk = src[0] + within, mp = src[4], mv = src[5], d = within > 0;
  // row r + 1: the next sorted row where it starts there, else a gap row
  uint32_t nclk = from_next(clk), nmp = from_next(mp), nmv = from_next(mv), nd = from_next(d);
  if (own) {
    nclk = clk + 1;
    nmp = mp;
    nmv = mv;
    nd = 1;
    if (!last && win[lo + 1] == static_cast<long long>(r) + 1) {
      const uint32_t* nxt = trace_row(rows, static_cast<uint32_t>(order[i + 1]));
      nclk = nxt[0];
      nmp = nxt[4];
      nmv = nxt[5];
      nd = 0;
    }
  }
  if (!live) return;
  o.put(0, clk);
  o.put(1, mp);
  o.put(2, mv);
  o.put(3, d);
  o.put(4, nclk);
  o.put(5, nmp);
  o.put(6, nmv);
  o.put(7, nd);
}

// One row r of a matrix of any other kind.
__device__ __forceinline__ void other_row(const Ctx& o, int kind, const long long* words,
                                          const long long* e, const uint32_t* rows, uint32_t n,
                                          bool live, bool own, bool last) {
  const uint32_t r = o.r;
  const uint32_t height = o.height;
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
      uint32_t v[3], w[3];
      fetch(r, v);
      const uint32_t d = r >= real;
      w[0] = from_next(v[0]);
      w[1] = from_next(v[1]);
      w[2] = from_next(v[2]);
      uint32_t nd = from_next(d);
      if (last) {
        w[0] = v[0];
        w[1] = w[2] = 0;
        nd = 1;
      } else if (own) {
        fetch(r + 1, w);
        nd = r + 1 >= real;
      }
      if (!live) return;
      o.put(0, v[0]);
      o.put(1, v[1]);
      o.put(2, v[2]);
      o.put(3, d);
      o.put(4, w[0]);
      o.put(5, w[1]);
      o.put(6, w[2]);
      o.put(7, nd);
      return;
    }
    case kProgram: {
      if (!live) return;
      const uint32_t* prog = reinterpret_cast<const uint32_t*>(words[kProg]);
      for (uint32_t c = 0; c < 4; ++c) o.put(c, prog[c * height + r]);
      return;
    }
    case kProcessor: {
      const uint32_t* last_row = trace_row(rows, n - 1);
      auto clk_at = [&](uint32_t q) { return q < n ? rows[7u * q] : last_row[0] + 1 + (q - n); };
      const uint32_t clk = clk_at(r);
      uint32_t nclk = from_next(clk);
      if (own) nclk = clk_at(r + 1);
      if (!live) return;
      if (r < n) {
        const uint32_t* s = trace_row(rows, r);
        o.put(0, clk);
        for (uint32_t c = 1; c < 7; ++c) o.put(c, s[c]);
        o.put(7, 0);
      } else {
        o.put(0, clk);
        o.put(1, last_row[1]);
        for (uint32_t c = 2; c < 7; ++c) o.put(c, 0);
        o.put(7, 1);
      }
      o.put(8, nclk);
      return;
    }
    case kEnd: {
      if (!live) return;
      const uint32_t end = static_cast<uint32_t>(
          *reinterpret_cast<const long long*>(words[kEndRow]));
      const uint32_t* s = trace_row(rows, end);
      for (uint32_t c = 0; c < 7; ++c) o.put(c, r == 0 ? s[c] : 0);
      return;
    }
    default: {  // kJump, kOpcode: matched row i paired with row i + 1, then pad rows
      const long long* ops = reinterpret_cast<const long long*>(words[kOps]) + e[kStart];
      const uint32_t k = static_cast<uint32_t>(e[kK]);
      const bool jump = kind == kJump;
      const bool matched = r < k;
      // this row's trace row s, and trace row s + 1 from lane + 1 where it
      // holds it (past k: no row, UINT_MAX)
      const uint32_t s = matched ? static_cast<uint32_t>(ops[r]) : UINT_MAX;
      uint32_t e1[7];
      if (matched) {
        const uint32_t* p = trace_row(rows, s);
        for (uint32_t c = 0; c < 7; ++c) e1[c] = p[c];
      } else {
        for (uint32_t c = 0; c < 7; ++c) e1[c] = 0;
      }
      const uint32_t s_next = from_next(s);
      const uint32_t n0 = from_next(e1[0]), n1 = from_next(e1[1]), n4 = from_next(e1[4]),
                     n5 = from_next(e1[5]);
      if (!live) return;
      if (matched) {
        uint32_t e2[4] = {n0, n1, n4, n5};  // clk ip mp mv of trace row s + 1
        if (own || s_next != s + 1) {
          const uint32_t* p = trace_row(rows, s + 1);
          e2[0] = p[0];
          e2[1] = p[1];
          e2[2] = p[4];
          e2[3] = p[5];
        }
        for (uint32_t c = 0; c < 7; ++c) o.put(c, e1[c]);
        if (jump) {
          // ... next_clk next_ip next_mp next_mv d is_mv_zero
          o.put(7, e2[0]);
          o.put(8, e2[1]);
          o.put(9, e2[2]);
          o.put(10, e2[3]);
          o.put(11, 0);
          o.put(12, m31::sub(1, m31::mul(e1[5], e1[6])));
        } else {
          // ... d next_ip next_mp next_mv
          o.put(7, 0);
          o.put(8, e2[1]);
          o.put(9, e2[2]);
          o.put(10, e2[3]);
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
      return;
    }
  }
}

__global__ void __launch_bounds__(kThreads) tables_kernel(const long long* __restrict__ table) {
  __shared__ long long words[kWords];
  __shared__ long long win[kBlockRows + 1];
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
  const uint32_t r0 = (b - static_cast<uint32_t>(e[kFirstBlock])) * kBlockRows;
  uint32_t* out = reinterpret_cast<uint32_t*>(e[kOut]);
  const uint32_t* rows = reinterpret_cast<const uint32_t*>(words[kRows]);
  const uint32_t n = static_cast<uint32_t>(words[kN]);

  if (kind == kMemory) {  // block-uniform: the barriers below are reached by all
    const long long* order = reinterpret_cast<const long long*>(words[kOrderMem]);
    const long long* starts = reinterpret_cast<const long long*>(words[kStartsMem]);
    const uint32_t i0 = block_search(starts, n, static_cast<long long>(r0));
    for (uint32_t w = threadIdx.x; w <= kBlockRows; w += kThreads) {
      win[w] = i0 + w < n ? starts[i0 + w] : LLONG_MAX;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kSubRows; ++k) {
      const uint32_t w = k * kThreads + threadIdx.x;
      const uint32_t r = r0 + w;
      memory_row(Ctx{out, height, r}, win, w, i0, order, rows, r < height,
                 (threadIdx.x & 31) == 31 || r + 1 == height, r + 1 == height);
    }
    return;
  }
#pragma unroll
  for (int k = 0; k < kSubRows; ++k) {
    const uint32_t r = r0 + k * kThreads + threadIdx.x;
    // rows past height compute, shuffle and store nothing; lane 31 and the
    // last row take no successor from lane + 1
    other_row(Ctx{out, height, r}, kind, words, e, rows, n, r < height,
              (threadIdx.x & 31) == 31 || r + 1 == height, r + 1 == height);
  }
}

}  // namespace

// (threads, header words, table words, matrices, rows a block) by index
// 0..4, for the wrapper's check of its copies.
extern "C" int tables_layout(int i) {
  const int v[5] = {kThreads, kHeaderWords, kTableWords, kTables, kBlockRows};
  return i >= 0 && i < 5 ? v[i] : -1;
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
