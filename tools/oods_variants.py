"""Design variants of the OODS kernel, built from this checkout's
csrc/oods.cu by substitution and timed on one CUDA card against the kernel
as committed, on the OODS launch of three proves (fib19_io at the default
config, big22, fib19_io at production parameters; the groups as the prove
gives them). The variants:

  one_point        a row opened at two points read once a point (the
                   committed library, no pair planned)
  pair_chunk8      chunks of 8 pair rows (16 KB; committed: 4, 8 KB)
  shares           every block an equal share of each kind of row, in place
                   of one weighted list with the pair chunks last
  stages4, stages16
                   4 or 16 rows in the cp.async ring (committed: 8)
  scalar_copies    one 4-byte cp.async a word in place of one 16- or 8-byte copy
  before_build     a tile's first copies issued before its rows are built
                   (their addresses found a thread a row)
  registers        no ring: a chunk's loads (ld.global.nc, 16 or 8 bytes a
                   thread) issued into registers a chunk ahead; with
  registers_one_point  no pair planned too
  blocks3          launch bounds asking for 3 blocks an SM (<= 85 registers)
  reduce4          the sums reduced to canonical words after each chunk in
                   place of folded below 2^34
  fold32           the fold as s mod 2^32 + 2 (s >> 32) in place of
                   (s & p) + (s >> 31)
  tma_ring2, tma_ring3
                   one thread copies whole chunks (16 or 8 KB) with
                   cp.async.bulk into a ring of 2 or 3 stages behind
                   mbarriers, a stage released after each chunk

Each variant's output must equal the committed kernel's word for word; each
time is the device time of REPS launches back to back on a table planned
and staged once (the host part left out), in two rounds (the second in the
reverse order). Also the committed call's whole time (host part
included), the host's plan of the launch (ops/oods_kernels.plan) and what
the factors as a numpy chain over the groups would cost the host
(ops/oods_kernels.group_factors; the kernel builds them). Prints the card,
each variant's registers, shared and local memory (cudaFuncGetAttributes)
and one JSON line: a prove's bytes bound (each distinct coefficient word
read once) and each variant's times and share of it.

    python3 tools/oods_variants.py
"""

from __future__ import annotations

import ctypes
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
from contextlib import nullcontext
from unittest import mock

sys.path.insert(0, os.getcwd())

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke  # noqa: E402
from stwo_brainfuck_tpu_torch import air  # noqa: E402
from stwo_brainfuck_tpu_torch.core import poly  # noqa: E402
from stwo_brainfuck_tpu_torch.ops import nvcc, oods_kernels  # noqa: E402
from stwo_brainfuck_tpu_torch.vm.compiler import compile_program  # noqa: E402
from stwo_brainfuck_tpu_torch.vm.machine import create_test_machine  # noqa: E402

REPS = 20

_STAGES = "constexpr int kStages = 8; "
_FOLD = "for (int c = 0; c < 4; ++c) acc[i][c] = (acc[i][c] & m31::kP) + (acc[i][c] >> 31);"
_REDUCE = "for (int c = 0; c < 4; ++c) acc[i][c] = m31::reduce64(acc[i][c]);"
_FOLD32 = ("for (int c = 0; c < 4; ++c)\n"
           "      acc[i][c] = static_cast<uint32_t>(acc[i][c]) + ((acc[i][c] >> 32) << 1);")
_PAIR_CHUNK = "static constexpr int kChunk = 4;\n};"
_COPY = re.compile(r"template <class L>\n__device__ __forceinline__ void copy_row\(.*?\n}\n", re.S)
_SCALAR_COPY = """template <class L>
__device__ __forceinline__ void copy_row(uint4* ring, int st, const L* src) {
  uint32_t* dst = reinterpret_cast<uint32_t*>(reinterpret_cast<L*>(ring + st * kThreads) +
                                              threadIdx.x);
  const uint32_t* from = reinterpret_cast<const uint32_t*>(src);
#pragma unroll
  for (int i = 0; i < static_cast<int>(sizeof(L) / 4); ++i)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\\n"
                 :: "r"(static_cast<uint32_t>(__cvta_generic_to_shared(dst + i))), "l"(from + i)
                 : "memory");
}
"""
# the committed ring: the tile's first copies (after its build) and its loop
_PROLOGUE = re.compile(r"#pragma unroll\n    for \(int r = 0; r < kStages - 1; \+\+r\) \{\n.*?"
                       r"      commit\(\);\n    }\n", re.S)
_LOOP = re.compile(r"    for \(int k = 0; k < rows; k \+= U\) \{\n.*?    wait_rows<0>\(\);\n", re.S)
_BUILD = "    if (t < rows) {\n      const int mt = advance(members, n, m, g0 + t);"
_BEFORE_BUILD = """    int mr = m;
#pragma unroll
    for (int r = 0; r < kStages - 1; ++r) {
      if (r < rows) {
        mr = advance(members, n, mr, g0 + r);
        copy_row(ring, r, row_or_first<K>(members + mr * kMemberWords, g0 + r) + t);
      }
      commit();
    }
"""

# a chunk's member change and its rows' products, as committed (XV: row u's words)
_CHUNK = """      const int mk = tile.member[k];
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
        mac_row<K>(acc, XV, h);
        if ((u & 3) == 3 || u == U - 1) fold(acc);
      }
"""
# registers: a chunk's loads (ld.global.nc, 16 or 8 bytes) issued a chunk ahead
_REGISTERS = """    L x[U], y[U];
#pragma unroll
    for (int u = 0; u < U; ++u) x[u] = __ldg(static_cast<const L*>(tile.ptr[u]) + t);
    for (int k = 0; k < rows; k += U) {
      if (k + U < rows) {
#pragma unroll
        for (int u = 0; u < U; ++u) y[u] = __ldg(static_cast<const L*>(tile.ptr[k + U + u]) + t);
      }
""" + _CHUNK.replace("XV", "x[u]") + """#pragma unroll
      for (int u = 0; u < U; ++u) x[u] = y[u];
    }
"""

# TMA: one thread copies each chunk (its rows are contiguous) with
# cp.async.bulk into a ring of kStages chunk stages behind mbarriers; the
# block releases a stage after it
_TMA_HELPERS = """constexpr int kStageBytes = 16384;  // a chunk: 4 big rows or 4 pair rows (8 KB)
__shared__ alignas(8) unsigned long long full[kStages];

__device__ __forceinline__ void wait_full(int st, int parity) {
  const uint32_t bar = static_cast<uint32_t>(__cvta_generic_to_shared(full + st));
  asm volatile("{\\n .reg .pred p;\\n WAIT_%=:\\n"
               " mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\\n"
               " @!p bra WAIT_%=;\\n}\\n" :: "r"(bar), "r"(parity) : "memory");
}

// The chunk of rows g .. g + kChunk - 1 (member m; its pads not copied) into stage st.
template <class K>
__device__ __forceinline__ void issue_chunk(uint4* ring, int st, const uint32_t* m, long long g,
                                            const void* src) {
  const long long real = min_ll(K::kChunk, (1ll << (__ldg(m + 2) - K::kLog)) - (g - __ldg(m + 4)));
  const uint32_t bytes = static_cast<uint32_t>(real * kThreads * sizeof(typename K::Load));
  const uint32_t bar = static_cast<uint32_t>(__cvta_generic_to_shared(full + st));
  const uint32_t dst =
      static_cast<uint32_t>(__cvta_generic_to_shared(ring + st * (kStageBytes / 16)));
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\\n"
               :: "r"(bar), "r"(bytes) : "memory");
  asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
               "[%0], [%1], %2, [%3];\\n"
               :: "r"(dst), "l"(src), "r"(bytes), "r"(bar) : "memory");
}

struct Tile {"""
_TMA_LOOP = """    const int chunks = rows / U;
    if (t == 0)
      for (int c = 0; c < kStages && c < chunks; ++c)
        issue_chunk<K>(ring, static_cast<int>((base + c) % kStages),
                       members + tile.member[c * U] * kMemberWords, g0 + c * U, tile.ptr[c * U]);
    for (int c = 0; c < chunks; ++c) {
      const int k = c * U;
      const long long q = base + c;
      wait_full(static_cast<int>(q % kStages), static_cast<int>((q / kStages) & 1));
      const L* stage = reinterpret_cast<const L*>(ring + (q % kStages) * (kStageBytes / 16));
""" + _CHUNK.replace("XV", "stage[u * kThreads + t]") + """      __syncthreads();
      if (t == 0 && c + kStages < chunks)
        issue_chunk<K>(ring, static_cast<int>((base + c + kStages) % kStages),
                       members + tile.member[k + kStages * U] * kMemberWords,
                       g0 + k + kStages * U, tile.ptr[k + kStages * U]);
    }
    base += chunks;
"""
_TMA_INIT = """  __shared__ bool last;
  if (threadIdx.x == 0) {
    for (int st = 0; st < kStages; ++st)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\\n"
                   :: "r"(static_cast<uint32_t>(__cvta_generic_to_shared(full + st))) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\\n" ::: "memory");
  }
  long long base = 0;  // chunks this block has consumed"""


def _tma(stages: int) -> list:
    return [
        (_STAGES, f"constexpr int kStages = {stages}; "),
        ("constexpr int kRingBytes = kStages * kThreads * 16;",
         "constexpr int kRingBytes = kStages * 16384;"),
        ("struct Tile {", _TMA_HELPERS),
        ("const Qm* factors, Tile& tile) {", "const Qm* factors, Tile& tile, long long& base) {"),
        ("s.big_lo, s.big_hi, factors, tile);", "s.big_lo, s.big_hi, factors, tile, base);"),
        ("s.pair_lo, s.pair_hi, factors, tile);", "s.pair_lo, s.pair_hi, factors, tile, base);"),
        ("  __shared__ bool last;", _TMA_INIT),
        (_PROLOGUE, ""), (_LOOP, _TMA_LOOP),
    ]


# equal shares of each kind a block (in place of one weighted list)
_SPAN = re.compile(r"__host__ __device__ inline Span span_of\(.*?\n}\n", re.S)
_SHARES_SPAN = """__host__ __device__ inline Span span_of(long long b, long long grid, long long small_rows,
                                        long long big_rows, long long pair_rows) {
  const long long big = big_rows / Single::kChunk, pair = pair_rows / Pair::kChunk;
  return {b * small_rows / grid, (b + 1) * small_rows / grid,
          b * big / grid * Single::kChunk, (b + 1) * big / grid * Single::kChunk,
          b * pair / grid * Pair::kChunk, (b + 1) * pair / grid * Pair::kChunk};
}
"""


def _shares_schedule(small_rows, big_rows, pair_rows, max_blocks):
    """oods_kernels.schedule as the shares variant cuts the rows."""
    units = (1, oods_kernels.ROW_CHUNK, oods_kernels.PAIR_CHUNK)
    counts = (small_rows, big_rows // units[1], pair_rows // units[2])
    grid = min(max_blocks, max(counts))
    b = np.arange(grid + 1, dtype=np.int64)
    small, big, pair = (b * c // grid * u for c, u in zip(counts, units))
    return oods_kernels.Schedule(grid, small[:-1], small[1:], big[:-1], big[1:], pair[:-1],
                                 pair[1:])


# name -> (substitutions of csrc/oods.cu, the wrapper's attributes at bind
# and launch); one_point is the committed library with no pair planned
VARIANTS = {
    "one_point": ([], {"PAIR_LOG": 31}),
    "pair_chunk8": ([(_PAIR_CHUNK, _PAIR_CHUNK.replace("4", "8"))], {"PAIR_CHUNK": 8}),
    "shares": ([(_SPAN, _SHARES_SPAN)], {"schedule": _shares_schedule}),
    "stages4": ([(_STAGES, "constexpr int kStages = 4; ")], {}),
    "stages16": ([(_STAGES, "constexpr int kStages = 16; ")], {}),
    "scalar_copies": ([(_COPY, _SCALAR_COPY)], {}),
    "before_build": ([(_PROLOGUE, ""), (_BUILD, _BEFORE_BUILD + _BUILD)], {}),
    "registers": ([(_PROLOGUE, ""), (_LOOP, _REGISTERS)], {}),
    "registers_one_point": ([(_PROLOGUE, ""), (_LOOP, _REGISTERS)], {"PAIR_LOG": 31}),
    "blocks3": ([("__launch_bounds__(kThreads, 2)", "__launch_bounds__(kThreads, 3)")], {}),
    "reduce4": ([(_FOLD, _REDUCE)], {}),
    "fold32": ([(_FOLD, _FOLD32)], {}),
    "tma_ring2": (_tma(2), {}),
    "tma_ring3": (_tma(3), {}),
}


def _constants(name: str, bind: bool = False):
    """The wrapper's attributes as variant `name` has them (at bind, its
    library's constants: a PAIR_LOG of 31 only stops the plan pairing)."""
    consts = dict(VARIANTS.get(name, ([], {}))[1])
    if bind:
        consts.pop("PAIR_LOG", None)
    return mock.patch.multiple(oods_kernels, **consts) if consts else nullcontext()


def _substitute(src: str, subs: list, name: str) -> str:
    for old, new in subs:
        if isinstance(old, re.Pattern):
            src, k = old.subn(lambda _: new, src, count=1)
        else:
            k = src.count(old)
            src = src.replace(old, new)
        if k < 1:
            raise RuntimeError(f"variant {name}: {str(old)[:60]!r} not in csrc/oods.cu")
    return src


def _build(tmp: str) -> dict:
    src = (nvcc.CSRC / "oods.cu").read_text()
    procs = {}
    for name, (subs, _) in VARIANTS.items():
        if not subs:
            continue
        d = os.path.join(tmp, name)
        os.makedirs(d)
        for h in nvcc.CSRC.glob("*.cuh"):
            shutil.copy(h, d)
        with open(os.path.join(d, "oods.cu"), "w") as f:
            f.write(_substitute(src, subs, name))
        out = os.path.join(d, "lib.so")
        procs[name] = (subprocess.Popen([nvcc.nvcc_path(), *nvcc.NVCC_FLAGS, "-o", out,
                                         os.path.join(d, "oods.cu")],
                                        stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                        text=True), out)
    kernels = {}
    for name, (proc, out) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            print(f"variant {name} does not build:\n{log[-3000:]}", file=sys.stderr)
            continue
        kernel = oods_kernels.OodsKernel()
        cdll = ctypes.CDLL(out)
        with _constants(name, bind=True):
            oods_kernels._bind(cdll)
        kernel.lib._lib = cdll
        kernels[name] = kernel
    return kernels


def _launch_groups() -> dict:
    """The groups of the OODS launch of each of the three proves."""
    real = poly.sample_groups
    out = {}
    for name, path, inp, config in (
            ("fib19_io", "programs/fib19_io.bf", chip_smoke.FIB_INPUT, None),
            ("big22", "programs/big22.bf", b"", None),
            ("production", "programs/fib19_io.bf", chip_smoke.FIB_INPUT, chip_smoke.PRODUCTION)):
        seen = []

        def hook(groups, shard=0):
            seen.append(groups)
            return real(groups, shard)

        with open(os.path.join(os.getcwd(), path)) as f:
            machine = create_test_machine(compile_program(f.read()), inp)
        machine.execute()
        with mock.patch.object(poly, "sample_groups", hook):
            air.prove_brainfuck(machine, config, device="cuda")
        out[name] = seen[0]
        chip_smoke._clear_prover_caches()  # the groups' rows stay alive through `seen`
    return out


def _host_ms(fn, reps: int = 50) -> float:
    """Mean host time of fn (after one call), ms."""
    fn()
    start = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - start) / reps * 1e3


def main() -> int:
    if not torch.cuda.is_available():
        print("oods_variants: no CUDA device", file=sys.stderr)
        return 1
    launches = _launch_groups()
    result = {}
    with tempfile.TemporaryDirectory() as tmp:
        kernels = {"committed": oods_kernels.KERNEL, **_build(tmp)}
        kernels.update({name: oods_kernels.KERNEL for name, (subs, _) in VARIANTS.items()
                        if not subs})
        for prove, groups in launches.items():
            want = oods_kernels.KERNEL.sample(groups)
            nbytes, _ = chip_smoke.oods_work(groups)
            bound = nbytes / chip_smoke.HBM_BYTES_PER_S * 1e3
            row = {"bytes_bound_ms": bound, "call_ms": chip_smoke._time_ms(
                lambda: oods_kernels.KERNEL.sample(groups), reps=REPS),
                   "plan_ms": _host_ms(lambda: oods_kernels.plan(groups, 0,
                                                                oods_kernels.KERNEL.max_blocks)),
                   "factors_ms": _host_ms(lambda: oods_kernels.group_factors(groups))}
            times = {name: [] for name in kernels}
            for order in (list(kernels), list(kernels)[::-1]):
                for name in order:
                    with _constants(name):
                        times[name].append(chip_smoke.oods_device_ms(kernels[name], groups, want,
                                                                     reps=REPS))
            for name, ms in times.items():
                row[name] = {"ms": ms, "share": bound / min(ms)}
            result[prove] = row
    print(chip_smoke._smi("name,power.limit"))
    for name, kernel in kernels.items():
        print(name, kernel.attributes())
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
