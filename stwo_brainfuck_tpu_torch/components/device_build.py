"""Table building on the device: the raw VM trace is uploaded once, the
sorts, clk gaps and opcode selections run on `device`, and all 13
component matrices are built there from them.

Counterpart of ``stwo_brainfuck_tpu/components/device_build.py``.

``build_tables(trace, program, device)`` is the prover's entry point. Its
meta pass (``device_meta``) stages the trace rows, the program table and a
256-word opcode lookup through pinned memory in one copy, then on the
device: a stable sort of the 64-bit key (mp << 32) | clk (the memory order,
np.lexsort((clk, mp))'s permutation, ties included), the clk gaps where mp
repeats, their exclusive prefix; a stable sort of (ip << 32) | clk over
concat(program rows at clk 0, trace rows) (the instruction order, program
rows first on ties); a stable sort of each row's opcode table (ci[:-1]
through the lookup), which groups every table's rows in row order, its
counts from a search of the sorted keys. One pull of a small int64 vector
(the gap sum, the tables' bounds in the grouped rows, the end-of-execution
rows) is the phase's only host sync (``sync.tables``, tracing.py); the
claim is computed from it on the host. The matrices are then one launch of ``csrc/tables.cu``
(``ops/table_kernels.KERNEL``) on a CUDA device, its plain version
``table_kernels.tables_plain`` on the CPU.

``build_meta`` is the JAX package's host numpy pass, copied as it is (the
plain version of the meta pass; ``META_CALLS`` counts its calls), and
``build_device_tables(trace, meta, device)`` uploads its arrays and runs
the plain build. Neither runs on a prove.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Tuple

import numpy as np
import torch

from .. import tracing
from ..ops import table_kernels
from ..ops.staging import PinnedRing
from . import tables as T

_JUMPS, _OPS = table_kernels.JUMPS, table_kernels.OPS

META_CALLS = 0   # build_meta calls (the host pass; none on a prove)


@dataclass
class TraceMeta:
    """Host-side quick pass over the trace: the claim plus the permutation /
    count arrays the device builder consumes. No full tables are built."""
    claim: Dict[str, int]
    n_steps: int
    plen: int
    order_mem: np.ndarray    # (n,) int32 into trace rows, sorted by (mp, clk)
    counts_mem: np.ndarray   # (n,) int32, sum = memory height
    order_ins: np.ndarray    # (N_ins,) int32 global: prog i -> i,
    #                          trace j -> PROG_CAP + j; pad = last real
    sel: Dict[str, np.ndarray]  # per jump/opcode table: (K,) int32 row idx
    k: Dict[str, int]
    prog_cols: np.ndarray    # (4, PROG_CAP) uint32 program table
    eoe_cols: np.ndarray     # (7, 16) uint32


def build_meta(trace: np.ndarray, program: List[int],
               bucket: bool = True) -> TraceMeta:
    global META_CALLS
    META_CALLS += 1
    n = len(trace)
    clk, ip, ci = trace[:, 0], trace[:, 1], trace[:, 2]
    mp = trace[:, 4]
    plen = len(program)

    # memory: sort by (mp, clk); counts = 1 + clk gap after each sorted row,
    # power-of-two pad folded into the LAST row's count (pad rows continue
    # the clk series with mp/mv frozen — the same pattern as a gap block)
    order_mem = np.lexsort((clk, mp)).astype(np.int32)
    clk_s = clk[order_mem].astype(np.int64)
    mp_s = mp[order_mem].astype(np.int64)
    if n > 1:
        same = mp_s[1:] == mp_s[:-1]
        gaps = np.maximum(np.where(same, clk_s[1:] - clk_s[:-1] - 1, 0), 0)
    else:
        gaps = np.zeros(0, np.int64)
    n_mem_real = n + int(gaps.sum())
    n_mem = T._next_pow2_len(n_mem_real, bucket)
    counts_mem = np.ones(n, np.int64)
    counts_mem[:-1] += gaps
    counts_mem[-1] += n_mem - n_mem_real

    # instruction: concat(program rows, trace rows) sorted by (ip, clk) with
    # program entries first on ties (stable sort, program clk = 0)
    n_ins_real = plen + n
    n_ins = T._next_pow2_len(n_ins_real, bucket)
    cat_ip = np.concatenate([np.arange(plen, dtype=np.int64),
                             ip.astype(np.int64)])
    cat_clk = np.concatenate([np.zeros(plen, np.int64), clk.astype(np.int64)])
    order_i = np.argsort((cat_ip << 32) | cat_clk, kind="stable")
    prog_cap = T._next_pow2_len(plen, bucket)
    glob = np.where(order_i < plen, order_i, prog_cap + order_i - plen)
    order_ins = np.full(n_ins, glob[-1], np.int32)
    order_ins[:n_ins_real] = glob

    claim = {
        "memory": int(np.log2(n_mem)),
        "instruction": int(np.log2(n_ins)),
        "program": int(np.log2(prog_cap)),
        "processor": int(np.log2(T._next_pow2_len(n, bucket))),
        "end_of_execution": T.MIN_LOG_SIZE,
    }

    sel: Dict[str, np.ndarray] = {}
    k: Dict[str, int] = {}
    ci_head = ci[:-1]
    for name, op in _JUMPS + _OPS:
        idx = np.nonzero(ci_head == op)[0].astype(np.int32)
        kk = len(idx)
        # mirror _pad_entries: table rows = target_entries / 2
        rows = T._next_pow2_len(max(1, 2 * kk) // 2 + (2 * kk) % 2, bucket)
        s = np.zeros(rows, np.int32)
        s[:kk] = idx
        sel[name] = s
        k[name] = kk
        claim[name] = int(np.log2(rows))

    return TraceMeta(
        claim=claim, n_steps=n, plen=plen, order_mem=order_mem,
        counts_mem=counts_mem.astype(np.int32), order_ins=order_ins,
        sel=sel, k=k,
        prog_cols=np.stack(list(T.program_table(program, bucket).values())),
        eoe_cols=np.stack(list(T.end_of_execution_table(trace).values())),
    )


def build_device_tables(trace: np.ndarray, meta: TraceMeta,
                        device) -> Dict[str, torch.Tensor]:
    """name -> (n_cols, N) int32 matrix on `device` from the host pass's
    meta: its arrays uploaded, then the plain build
    (``table_kernels.tables_plain``)."""
    device = torch.device(device)
    tr = torch.as_tensor(np.ascontiguousarray(trace).view(np.int32)).to(device).T
    return table_kernels.tables_plain(tr, meta, device)


# ---------------------------------------------------------------------------
# The meta pass on the device
# ---------------------------------------------------------------------------

# The trace's pinned staging: one buffer a device, grown to the largest
# trace; a build waits for the previous build's copy only if it is still
# in flight.
_STAGING = PinnedRing(slots=1)


def _slot_lookup() -> np.ndarray:
    """ci -> the opcode table's index in SELECTIONS (len(SELECTIONS) for
    any other value), for ci < 256 (larger ci are clamped to 255, no
    opcode)."""
    lut = np.full(256, len(table_kernels.SELECTIONS), np.int32)
    for j, (_, op) in enumerate(table_kernels.SELECTIONS):
        lut[op] = j
    return lut


_SLOT_LOOKUP = _slot_lookup()


@dataclass
class DeviceMeta:
    """The meta pass's result: the claim and counts on the host, every
    array on the device. The kernel reads the first group of arrays; the
    properties rebuild ``TraceMeta``'s arrays from them (the plain build
    and the tests read those)."""
    claim: Dict[str, int]
    n_steps: int
    plen: int
    prog_cap: int
    k: Dict[str, int]          # opcode rows a table
    op_start: Dict[str, int]   # each table's first position in `ops`
    n_mem_real: int
    rows: torch.Tensor         # (n, 7) int32 trace rows, as uploaded
    order_mem: torch.Tensor    # (n,) int64 trace rows sorted by (mp, clk)
    starts_mem: torch.Tensor   # (n,) int64 first memory row of each sorted row
    counts: torch.Tensor       # (n,) int64 1 + the clk gap after each sorted row
    order_cat: torch.Tensor    # (plen + n,) int64 concat(program, trace) by (ip, clk)
    ops: torch.Tensor          # (n - 1,) int64 rows of ci[:-1], grouped by table
    prog_cols: torch.Tensor    # (4, prog_cap) int32 program table
    end_row: torch.Tensor      # () int64 the row with ci = 0

    @property
    def counts_mem(self) -> torch.Tensor:
        """(n,) int32: the counts with the power-of-two pad on the last."""
        counts = self.counts.clone()
        counts[-1] += (1 << self.claim["memory"]) - self.n_mem_real
        return counts.to(torch.int32)

    @property
    def order_ins(self) -> torch.Tensor:
        """(N_ins,) int32 global indices (program i -> i, trace j ->
        prog_cap + j), the pad repeating the last."""
        g = self.order_cat
        glob = torch.where(g < self.plen, g, g + (self.prog_cap - self.plen)).to(torch.int32)
        pad = (1 << self.claim["instruction"]) - len(glob)
        return torch.cat([glob, glob[-1:].expand(pad)])

    @property
    def sel(self) -> Dict[str, torch.Tensor]:
        """Per opcode table: (rows,) int32 matched row indices, 0-padded."""
        out = {}
        for name, _ in table_kernels.SELECTIONS:
            kk, st = self.k[name], self.op_start[name]
            s = torch.zeros(1 << self.claim[name], dtype=torch.int32, device=self.rows.device)
            s[:kk] = self.ops[st:st + kk]
            out[name] = s
        return out

    @property
    def eoe_cols(self) -> torch.Tensor:
        """(7, 16) int32: the end row, then zeros."""
        cols = torch.zeros((7, 1 << T.MIN_LOG_SIZE), dtype=torch.int32, device=self.rows.device)
        cols[:, 0] = self.rows[self.end_row]
        return cols


def _stage(parts: List[np.ndarray], device: torch.device) -> torch.Tensor:
    """The int32 words of `parts`, back to back, on `device`: one pinned
    non-blocking copy on CUDA."""
    if device.type == "cuda":
        with torch.cuda.device(device):
            return _STAGING.stage(parts, device)
    return torch.from_numpy(np.concatenate([np.ascontiguousarray(p).reshape(-1).view(np.int32)
                                            for p in parts]))


def device_meta(trace: np.ndarray, program: List[int], device,
                bucket: bool = True) -> DeviceMeta:
    """The meta pass on `device`: one staged upload, the sorts, gaps and
    selections as device ops, one pull of the counts."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    trace = np.ascontiguousarray(trace, dtype=np.uint32)
    n, plen = len(trace), len(program)
    prog_cols = np.stack(list(T.program_table(program, bucket).values()))
    prog_cap = prog_cols.shape[1]
    with tracing.span("tables.stage"):
        buf = _stage([trace, prog_cols, _SLOT_LOOKUP], device)
    with tracing.span("tables.meta"):
        rows = buf[:7 * n].view(n, 7)
        prog = buf[7 * n:7 * n + 4 * prog_cap].view(4, prog_cap)
        lookup = buf[7 * n + 4 * prog_cap:]
        clk, ip, mp = (rows[:, c].to(torch.int64) for c in (0, 1, 4))
        ci = rows[:, 2]

        # memory: (mp, clk) order, 1 + the clk gap after each sorted row
        key, order_mem = torch.sort((mp << 32) | clk, stable=True)
        counts = torch.ones(n, dtype=torch.int64, device=device)
        if n > 1:
            mp_s, clk_s = key >> 32, key & 0xFFFFFFFF
            counts[:-1] += torch.where(mp_s[1:] == mp_s[:-1], clk_s[1:] - clk_s[:-1] - 1,
                                       0).clamp_(min=0)
        starts = torch.cumsum(counts, 0) - counts

        # instruction: concat(program rows at clk 0, trace rows) by (ip, clk)
        cat = torch.cat([torch.arange(plen, dtype=torch.int64, device=device) << 32,
                         (ip << 32) | clk])
        order_cat = torch.sort(cat, stable=True)[1]

        # opcode tables: ci[:-1]'s table index, stably sorted; a table's rows
        # are one run of it, its bounds a search of the sorted keys
        slot = lookup[ci[:-1].clamp(0, 255).to(torch.int64)]
        slot_s, ops = torch.sort(slot, stable=True)
        m = len(table_kernels.SELECTIONS)
        bounds = torch.searchsorted(slot_s, torch.arange(m + 1, dtype=slot_s.dtype,
                                                         device=device))
        is_end = ci == 0
        end_row = is_end.to(torch.int32).argmax()
        counted = torch.cat([(starts[-1:] + counts[-1:] - n), bounds.to(torch.int64),
                             is_end.sum().view(1)])

    # the one pull (the meta pass's one host sync): the gap sum, the bounds,
    # the end rows
    pulled = tracing.pull("tables", counted).tolist()
    gap_sum, bounds, ends = pulled[0], pulled[1:m + 2], pulled[-1]
    if ends != 1:
        raise T.InvalidEndOfExecution(f"{ends} end-of-execution rows")
    k = {name: bounds[j + 1] - bounds[j] for j, (name, _) in enumerate(table_kernels.SELECTIONS)}
    op_start = {name: bounds[j] for j, (name, _) in enumerate(table_kernels.SELECTIONS)}
    n_mem_real = n + gap_sum
    claim = {
        "memory": T._next_pow2_len(n_mem_real, bucket).bit_length() - 1,
        "instruction": T._next_pow2_len(plen + n, bucket).bit_length() - 1,
        "program": prog_cap.bit_length() - 1,
        "processor": T._next_pow2_len(n, bucket).bit_length() - 1,
        "end_of_execution": T.MIN_LOG_SIZE,
    }
    for name, kk in k.items():
        # mirror _pad_entries: table rows = target_entries / 2
        claim[name] = T._next_pow2_len(max(1, 2 * kk) // 2 + (2 * kk) % 2,
                                       bucket).bit_length() - 1
    return DeviceMeta(claim=claim, n_steps=n, plen=plen, prog_cap=prog_cap, k=k,
                      op_start=op_start, n_mem_real=n_mem_real, rows=rows, order_mem=order_mem,
                      starts_mem=starts, counts=counts, order_cat=order_cat, ops=ops, prog_cols=prog,
                      end_row=end_row)


def build_tables(trace: np.ndarray, program: List[int], device,
                 bucket: bool = True) -> Tuple[Dict[str, int], Dict[str, torch.Tensor]]:
    """(claim, name -> (n_cols, N) int32 matrix on `device`): the meta pass
    on the device, then one table-kernel launch (the plain build on the
    CPU)."""
    meta = device_meta(trace, program, device, bucket)
    with tracing.span("tables.kernel"):
        if meta.rows.is_cuda:
            return meta.claim, table_kernels.KERNEL.build(meta)
        return meta.claim, table_kernels.tables_plain(meta.rows.T, meta, meta.rows.device)
