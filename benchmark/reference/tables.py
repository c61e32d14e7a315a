"""Trace table builders for the 13 AIR components.

Each builder maps the VM execution trace (an (n, 7) uint32 array in register
order clk, ip, ci, ni, mp, mv, mvi) to named columns padded to a power of two
(>= 2^MIN_LOG_SIZE rows). Row-construction semantics mirror the reference's
table.rs files exactly (cited per function); the layout difference is that we
do NOT expand rows into 16 SIMD lanes (stwo's LOG_N_LANES broadcast is a CPU
AVX artifact — crates/brainfuck_prover/src/components/memory/table.rs:92-104).

All builders are vectorized numpy (host); a frozen copy of the port's
components/tables.py; the returned dict maps column name
-> uint32 array whose index is the storage position (interpreted as a
bit-reversed circle evaluation, as in the reference's CircleEvaluation::new).
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

from .field import P_INT
from .vm import InstructionType

# Minimum table height (2^4 = 16 rows). The is_first preprocessed ladder
# starts here (reference IS_FIRST_LOG_SIZES, brainfuck_air/mod.rs:435-464).
MIN_LOG_SIZE = 4

Columns = Dict[str, np.ndarray]


class TraceError(Exception):
    pass


class InvalidEndOfExecution(TraceError):
    pass


def _next_pow2_len(n: int, bucket: bool = False) -> int:
    """Next power-of-two table height >= n (>= 2^MIN_LOG_SIZE).

    bucket=True rounds the log up to an EVEN value ("shape bucketing"):
    every component height then lands in {2^4, 2^6, ... 2^24}. The JAX
    package buckets to bound its compiled-shape count; the port keeps the
    same heights so that both packages prove the same claim. Padding rows
    are ordinary dummy rows, so claims/constraints are unaffected (the claim
    simply records the bucketed log)."""
    log = max(MIN_LOG_SIZE, (max(1, n) - 1).bit_length())
    if bucket and log % 2:
        log += 1
    return 1 << log


def _pack(names: List[str], arrays: List[np.ndarray]) -> Columns:
    return {n: np.ascontiguousarray(a, dtype=np.uint32) for n, a in zip(names, arrays)}


# ---------------------------------------------------------------------------
# Memory (reference: components/memory/table.rs)
# ---------------------------------------------------------------------------

def memory_table(trace: np.ndarray, bucket: bool = False) -> Columns:
    """Sort rows by (mp, clk), fill clk gaps with dummies, pad, then flatten
    consecutive entries into (cur, next) rows (table.rs:113-151, 244-318)."""
    clk, mp, mv = trace[:, 0], trace[:, 4], trace[:, 5]
    order = np.lexsort((clk, mp))
    clk_s, mp_s, mv_s = clk[order].astype(np.int64), mp[order].astype(np.int64), mv[order]
    d_s = np.zeros(len(clk_s), np.int64)

    # clk-gap dummies between consecutive same-mp entries (table.rs:259-283).
    # A dummy block's clks lie strictly between its neighbours' (same mp), so
    # interleaving each block right after its source row IS the
    # (mp, clk, d)-sorted order — no second sort needed.
    if len(clk_s) > 1:
        same = mp_s[1:] == mp_s[:-1]
        gaps = np.maximum(np.where(same, clk_s[1:] - clk_s[:-1] - 1, 0), 0)
        total = int(gaps.sum())
        if total:
            counts = np.concatenate([gaps, [0]]) + 1  # real row + its dummies
            n = len(clk_s)
            src = np.repeat(np.arange(n), counts)
            starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
            within = np.arange(n + total) - np.repeat(starts, counts)
            clk_s = clk_s[src] + within
            mp_s = mp_s[src]
            mv_s = mv_s[src]
            d_s = (within > 0).astype(np.int64)

    # pad to power of two continuing the clk series (table.rs:291-303), then
    # pair with successor + appended dummy (clk+1, mp, mv) (table.rs:121-151).
    # Built straight into uint32 output buffers (no int64 copies of the
    # table). clk stays < 2^26 (steps capped at 2^24, gap/pad clks bounded by the max
    # real clk + table length), so no mod-P reduction is needed.
    n = len(clk_s)
    target = _next_pow2_len(n, bucket)
    padn = target - n
    clk_o = np.empty(target, np.uint32)
    mp_o = np.empty(target, np.uint32)
    mv_o = np.empty(target, np.uint32)
    d_o = np.empty(target, np.uint32)
    clk_o[:n] = clk_s
    mp_o[:n] = mp_s
    mv_o[:n] = mv_s
    d_o[:n] = d_s
    if padn:
        clk_o[n:] = clk_s[-1] + 1 + np.arange(padn, dtype=np.uint32)
        mp_o[n:] = mp_s[-1]
        mv_o[n:] = mv_s[-1]
        d_o[n:] = 1
    nxt_clk = np.empty(target, np.uint32)
    nxt_mp = np.empty(target, np.uint32)
    nxt_mv = np.empty(target, np.uint32)
    nxt_d = np.empty(target, np.uint32)
    nxt_clk[:-1] = clk_o[1:]
    nxt_clk[-1] = clk_o[-1] + 1
    nxt_mp[:-1] = mp_o[1:]
    nxt_mp[-1] = mp_o[-1]
    nxt_mv[:-1] = mv_o[1:]
    nxt_mv[-1] = mv_o[-1]
    nxt_d[:-1] = d_o[1:]
    nxt_d[-1] = 1
    return _pack(
        ["clk", "mp", "mv", "d", "next_clk", "next_mp", "next_mv", "next_d"],
        [clk_o, mp_o, mv_o, d_o, nxt_clk, nxt_mp, nxt_mv, nxt_d],
    )


# ---------------------------------------------------------------------------
# Instruction (reference: components/instruction/table.rs)
# ---------------------------------------------------------------------------

def _program_rows(program: List[int]) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    code = np.asarray(program, np.int64)
    ip = np.arange(len(code), dtype=np.int64)
    ni = np.concatenate([code[1:], [0]])
    return ip, code, ni


def instruction_table(trace: np.ndarray, program: List[int], bucket: bool = False) -> Columns:
    """concat(program listing, exec trace) sorted by (ip, clk) — program rows
    first on ties (stable sort, clk=0) — padded, then paired
    (table.rs:251-282, 116-143)."""
    p_ip, p_ci, p_ni = _program_rows(program)
    p_clk = np.zeros(len(p_ip), np.int64)
    t_clk = trace[:, 0].astype(np.int64)
    t_ip = trace[:, 1].astype(np.int64)
    t_ci = trace[:, 2].astype(np.int64)
    t_ni = trace[:, 3].astype(np.int64)

    ip = np.concatenate([p_ip, t_ip])
    ci = np.concatenate([p_ci, t_ci])
    ni = np.concatenate([p_ni, t_ni])
    clk = np.concatenate([p_clk, t_clk])
    order = np.lexsort((clk, ip))  # stable: program entries precede ties
    n = len(order)
    target = _next_pow2_len(n, bucket)
    ip_o = np.empty(target, np.uint32)
    ci_o = np.zeros(target, np.uint32)
    ni_o = np.zeros(target, np.uint32)
    d_o = np.zeros(target, np.uint32)
    ip_o[:n] = ip[order]
    ci_o[:n] = ci[order]
    ni_o[:n] = ni[order]
    ip_o[n:] = ip_o[n - 1]
    d_o[n:] = 1
    nxt_ip = np.empty(target, np.uint32)
    nxt_ci = np.zeros(target, np.uint32)
    nxt_ni = np.zeros(target, np.uint32)
    nxt_d = np.empty(target, np.uint32)
    nxt_ip[:-1] = ip_o[1:]
    nxt_ip[-1] = ip_o[-1]
    nxt_ci[:-1] = ci_o[1:]
    nxt_ni[:-1] = ni_o[1:]
    nxt_d[:-1] = d_o[1:]
    nxt_d[-1] = 1
    return _pack(
        ["ip", "ci", "ni", "d", "next_ip", "next_ci", "next_ni", "next_d"],
        [ip_o, ci_o, ni_o, d_o, nxt_ip, nxt_ci, nxt_ni, nxt_d],
    )


# ---------------------------------------------------------------------------
# Program (reference: components/program/table.rs:111-141, 55-70)
# ---------------------------------------------------------------------------

def program_table(program: List[int], bucket: bool = False) -> Columns:
    ip, ci, ni = _program_rows(program)
    d = np.zeros(len(ip), np.int64)
    target = _next_pow2_len(len(ip), bucket)
    padn = target - len(ip)
    if padn:
        ip = np.concatenate([ip, np.full(padn, ip[-1])])
        ci = np.concatenate([ci, np.zeros(padn, np.int64)])
        ni = np.concatenate([ni, np.zeros(padn, np.int64)])
        d = np.concatenate([d, np.ones(padn, np.int64)])
    return _pack(["ip", "ci", "ni", "d"], [ip, ci, ni, d])


# ---------------------------------------------------------------------------
# Processor (reference: components/processor/table.rs:109-145, 209-222)
# ---------------------------------------------------------------------------

def processor_table(trace: np.ndarray, bucket: bool = False) -> Columns:
    """Built straight into uint32 buffers (clk < 2^26, no reduction needed)."""
    n = len(trace)
    target = _next_pow2_len(n, bucket)
    names = ["clk", "ip", "ci", "ni", "mp", "mv", "mvi"]
    out = {}
    for i, name in enumerate(names):
        col = np.zeros(target, np.uint32)
        col[:n] = trace[:, i]
        out[name] = col
    if target > n:
        out["clk"][n:] = int(trace[-1, 0]) + 1 + np.arange(target - n,
                                                           dtype=np.uint32)
        out["ip"][n:] = trace[-1, 1]
    d = np.zeros(target, np.uint32)
    d[n:] = 1
    out["d"] = d
    nxt_clk = np.empty(target, np.uint32)
    nxt_clk[:-1] = out["clk"][1:]
    nxt_clk[-1] = out["clk"][-1] + 1
    out["next_clk"] = nxt_clk
    return _pack(list(out), list(out.values()))


# ---------------------------------------------------------------------------
# Per-opcode tables (reference: processor/instructions/table.rs:303-330,
# 288-308) and jump tables (jump/table.rs:264-297) — same pairing machinery.
# ---------------------------------------------------------------------------

def _opcode_entries(trace: np.ndarray, opcode: int) -> List[np.ndarray]:
    """Interleaved [row_i, row_{i+1}] register entries for rows with
    ci == opcode (zip with successor; the final trace row has ci = 0 so a
    successor always exists)."""
    ci = trace[:-1, 2]
    sel = np.nonzero(ci == opcode)[0]
    ent = np.empty((2 * len(sel), 7), np.uint32)
    ent[0::2] = trace[sel]
    ent[1::2] = trace[sel + 1]
    return ent


def _pad_entries(ent: np.ndarray, bucket: bool = False) -> Tuple[np.ndarray, np.ndarray]:
    """Pad interleaved entries to a power of two with dummies
    clk = last_clk + i (i = 0..), ip = last_ip, other registers 0, d = 1.
    The FINAL table has target/2 rows, so bucketing rounds the interleaved
    length to an odd log (= even row log)."""
    n = len(ent)
    last_clk = int(ent[-1, 0]) if n else 0
    last_ip = int(ent[-1, 1]) if n else 0
    target = 2 * _next_pow2_len(max(1, n) // 2 + (n % 2), bucket)
    out = np.zeros((target, 7), np.uint32)
    out[:n] = ent
    d = np.zeros(target, np.uint32)
    if target > n:
        out[n:, 0] = last_clk + np.arange(target - n, dtype=np.uint32)
        out[n:, 1] = last_ip
        d[n:] = 1
    return out, d


def opcode_table(trace: np.ndarray, opcode: int, bucket: bool = False) -> Columns:
    """11-column table for + - < > , . (ProcessorInstructionTable<N>)."""
    ent, d = _pad_entries(_opcode_entries(trace, opcode), bucket)
    e1, e2 = ent[0::2], ent[1::2]
    d1 = d[0::2]
    # clk < 2^26 (steps capped at 2^24, pad clks bounded) — already reduced
    return _pack(
        ["clk", "ip", "ci", "ni", "mp", "mv", "mvi", "d", "next_ip", "next_mp", "next_mv"],
        [e1[:, 0], e1[:, 1], e1[:, 2], e1[:, 3], e1[:, 4], e1[:, 5], e1[:, 6],
         d1, e2[:, 1], e2[:, 4], e2[:, 5]],
    )


def jump_table(trace: np.ndarray, opcode: int, bucket: bool = False) -> Columns:
    """13-column table for [ and ] (JumpTable<N>), including
    is_mv_zero = 1 - mv*mvi (jump/table.rs:206)."""
    ent, d = _pad_entries(_opcode_entries(trace, opcode), bucket)
    e1, e2 = ent[0::2], ent[1::2]
    d1 = d[0::2]
    mv, mvi = e1[:, 5].astype(np.uint64), e1[:, 6].astype(np.uint64)
    is_mv_zero = (1 + P_INT - (mv * mvi) % P_INT) % P_INT
    return _pack(
        ["clk", "ip", "ci", "ni", "mp", "mv", "mvi", "next_clk", "next_ip",
         "next_mp", "next_mv", "d", "is_mv_zero"],
        [e1[:, 0], e1[:, 1], e1[:, 2], e1[:, 3], e1[:, 4], e1[:, 5], e1[:, 6],
         e2[:, 0], e2[:, 1], e2[:, 4], e2[:, 5], d1, is_mv_zero],
    )


# ---------------------------------------------------------------------------
# End of execution (reference: processor/instructions/end_of_execution/
# table.rs:71-111) — exactly one row with ci = 0, zero-padded.
# ---------------------------------------------------------------------------

def end_of_execution_table(trace: np.ndarray) -> Columns:
    sel = np.nonzero(trace[:, 2] == 0)[0]
    if len(sel) != 1:
        raise InvalidEndOfExecution(f"{len(sel)} end-of-execution rows")
    row = trace[sel[0]].astype(np.int64)
    size = 1 << MIN_LOG_SIZE
    cols = np.zeros((7, size), np.int64)
    cols[:, 0] = row
    return _pack(["clk", "ip", "ci", "ni", "mp", "mv", "mvi"], list(cols))


# ---------------------------------------------------------------------------
# All tables for a machine run
# ---------------------------------------------------------------------------

OPCODES = {
    "plus": InstructionType.Plus,
    "minus": InstructionType.Minus,
    "left": InstructionType.Left,
    "right": InstructionType.Right,
    "input": InstructionType.ReadChar,
    "output": InstructionType.PutChar,
}


def all_tables(trace: np.ndarray, program: List[int],
               bucket: bool = True) -> Dict[str, Columns]:
    """Build every component table (order: brainfuck_air/mod.rs:511-547).

    bucket defaults to True for the proving path (even-log heights — see
    _next_pow2_len); pass False for reference-exact minimal padding."""
    tables = {
        "memory": memory_table(trace, bucket),
        "instruction": instruction_table(trace, program, bucket),
        "program": program_table(program, bucket),
        "processor": processor_table(trace, bucket),
        "jump_if_not_zero": jump_table(trace, int(InstructionType.JumpIfNotZero), bucket),
        "jump_if_zero": jump_table(trace, int(InstructionType.JumpIfZero), bucket),
    }
    for name, op in OPCODES.items():
        tables[f"{name}_instruction"] = opcode_table(trace, int(op), bucket)
    tables["end_of_execution"] = end_of_execution_table(trace)
    return tables
