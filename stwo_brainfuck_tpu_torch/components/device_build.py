"""Table building on the device: the raw VM trace and a few small
permutation / count arrays are the only bulk upload, and all 13 component
matrices are built from them on `device`.

Counterpart of ``stwo_brainfuck_tpu/components/device_build.py``.
``build_meta`` is its host pass, copied as it is (the memory lexsort and clk
gaps, the instruction order, the per-opcode selectors, the claim).
``build_device_tables`` rebuilds every matrix with torch ops, bit-identical
to the host builders (``components/tables.py``): gathers through the sort
permutations, ``repeat_interleave`` for the clk-gap rows, power-of-two
pads, successor rolls. The step and match counts stay host ints, so no
shape depends on device data and nothing is read back.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List

import numpy as np
import torch

from ..core import m31
from ..vm.instruction import InstructionType
from . import tables as T

_JUMPS = [("jump_if_not_zero", int(InstructionType.JumpIfNotZero)),
          ("jump_if_zero", int(InstructionType.JumpIfZero))]
_OPS = [(f"{name}_instruction", int(op)) for name, op in T.OPCODES.items()]


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


def _upload(a: np.ndarray, device) -> torch.Tensor:
    """int32 copy of a host array (uint32 values < 2^31) on `device`."""
    return torch.as_tensor(np.ascontiguousarray(a).astype(np.int32, copy=False)).to(device)


def _roll_next(col: torch.Tensor, kind: str) -> torch.Tensor:
    """Successor column: col shifted up by one, the last entry filled by
    `kind` (inc: last + 1, hold: last, zero, one)."""
    nxt = torch.roll(col, -1)
    if kind == "inc":
        nxt[-1:] = col[-1:] + 1
    elif kind == "hold":
        nxt[-1:] = col[-1:]
    else:
        nxt[-1] = {"zero": 0, "one": 1}[kind]
    return nxt


def _pad_clk(last: torch.Tensor, start: int, count: int, step: int,
             device) -> torch.Tensor:
    """last + start + step * i for i < count (int32)."""
    return last + start + step * torch.arange(count, dtype=torch.int32, device=device)


def build_device_tables(trace: np.ndarray, meta: TraceMeta,
                        device) -> Dict[str, torch.Tensor]:
    """name -> (n_cols, N) int32 matrix on `device`, rows in the host
    builders' column order (the component's column order)."""
    device = torch.device(device)
    n = meta.n_steps
    tr = _upload(trace, device).T           # (7, n) clk ip ci ni mp mv mvi
    tclk, tip, tci, tni, tmp, tmv, tmvi = tr.contiguous()
    ar = lambda k, dt=torch.int64: torch.arange(k, dtype=dt, device=device)  # noqa: E731
    out: Dict[str, torch.Tensor] = {}

    # memory: each sorted row followed by its clk-gap rows (and, after the
    # last row, the power-of-two pad), which continue its clk with mp/mv held
    n_mem = 1 << meta.claim["memory"]
    order = _upload(meta.order_mem, device).long()
    counts = _upload(meta.counts_mem, device).long()
    src = torch.repeat_interleave(ar(n), counts, output_size=n_mem)
    starts = torch.cumsum(counts, 0) - counts
    within = (ar(n_mem) - starts[src]).to(torch.int32)
    row = order[src]
    clk_o = tclk[row] + within
    mp_o = tmp[row]
    mv_o = tmv[row]
    d_o = (within > 0).to(torch.int32)
    out["memory"] = torch.stack([
        clk_o, mp_o, mv_o, d_o, _roll_next(clk_o, "inc"),
        _roll_next(mp_o, "hold"), _roll_next(mv_o, "hold"),
        _roll_next(d_o, "one")])
    del src, starts, within, row

    # instruction: program rows and trace rows in (ip, clk) order, then pad
    # rows (ip held, the rest 0, d = 1)
    n_real = meta.plen + n
    prog = _upload(meta.prog_cols, device)
    gi = _upload(meta.order_ins, device).long()
    ip_o = torch.cat([prog[0], tip])[gi]
    ci_o = torch.cat([prog[1], tci])[gi]
    ni_o = torch.cat([prog[2], tni])[gi]
    ci_o[n_real:] = 0
    ni_o[n_real:] = 0
    di_o = torch.zeros_like(ip_o)
    di_o[n_real:] = 1
    out["instruction"] = torch.stack([
        ip_o, ci_o, ni_o, di_o, _roll_next(ip_o, "hold"),
        _roll_next(ci_o, "zero"), _roll_next(ni_o, "zero"),
        _roll_next(di_o, "one")])
    del gi

    out["program"] = prog

    # processor: the trace, then pad rows continuing clk with ip held
    tp = 1 << meta.claim["processor"]
    proc = torch.zeros((9, tp), dtype=torch.int32, device=device)
    proc[:7, :n] = tr
    proc[0, n:] = _pad_clk(tclk[n - 1], 1, tp - n, 1, device)
    proc[1, n:] = tip[n - 1]
    proc[7, n:] = 1
    proc[8] = _roll_next(proc[0], "inc")
    out["processor"] = proc

    out["end_of_execution"] = _upload(meta.eoe_cols, device)

    # jump + opcode tables: matched row i paired with row i + 1, then pad
    # entries (clk = last e2 clk + 2(r - k) and + 1, ip = last e2 ip)
    for name, _ in _JUMPS + _OPS:
        kk = meta.k[name]
        rows = len(meta.sel[name])
        s = _upload(meta.sel[name][:kk], device).long()
        e1 = tr[:, s]
        e2 = tr[:, s + 1]
        if kk:
            last = int(meta.sel[name][kk - 1]) + 1
            lk, li = tclk[last], tip[last]
        else:
            lk = li = torch.zeros((), dtype=torch.int32, device=device)
        jump = name in ("jump_if_not_zero", "jump_if_zero")
        mat = torch.zeros((13 if jump else 11, rows), dtype=torch.int32, device=device)
        mat[:7, :kk] = e1
        mat[0, kk:] = _pad_clk(lk, 0, rows - kk, 2, device)
        mat[1, kk:] = li
        mat[8, kk:] = li  # next_ip in both layouts
        if jump:
            # clk ip ci ni mp mv mvi next_clk next_ip next_mp next_mv d is_mv_zero
            mat[7, :kk] = e2[0]
            mat[7, kk:] = _pad_clk(lk, 1, rows - kk, 2, device)
            mat[8, :kk] = e2[1]
            mat[9, :kk] = e2[4]
            mat[10, :kk] = e2[5]
            mat[11, kk:] = 1
            mat[12] = m31.sub(1, m31.mul(mat[5], mat[6])).to(torch.int32)
        else:
            # clk ip ci ni mp mv mvi d next_ip next_mp next_mv
            mat[7, kk:] = 1
            mat[8, :kk] = e2[1]
            mat[9, :kk] = e2[4]
            mat[10, :kk] = e2[5]
        out[name] = mat
    return {name: out[name] for name in meta.claim}
