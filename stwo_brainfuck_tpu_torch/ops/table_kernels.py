"""The table kernel: the hand-written Hopper kernel (``csrc/tables.cu``)
that writes all 13 component matrices of a prove in one launch, and its
plain torch version.

Counterpart of ``stwo_brainfuck_tpu/components/device_build.py``'s
``_build_tables_jit`` (one XLA executable over one uploaded buffer; no
Pallas kernel). Its inputs are what the device meta pass
(``components/device_build.device_meta``) leaves on the card: the trace
rows as uploaded, the memory order and the exclusive prefix of its clk-gap
counts, the instruction order over concat(program, trace), the opcode rows
grouped by table, the program table and the end-of-execution row. Every
output is its own (n_cols, 2^log) int32 allocation in the component's
column order, bit for bit ``components/tables.py``.

``KERNEL.build(meta)`` allocates the 13 matrices and launches the kernel
once (``KERNEL.launches``): ``prepare`` allocates them and fills the
launch table's pointers, ``enqueue`` launches over a table on the card
(staged from pinned memory by ``build``); ``plan(meta)`` lays out the launch's table (the
input pointers and sizes, then each matrix's pointer, kind, height, first
block, columns and opcode rows) and refuses shapes whose 32-bit indices
would wrap. ``tables_plain`` is the plain version (torch ops: gathers
through the permutations, ``repeat_interleave`` for the clk-gap rows, pads,
successor rolls), the CPU's path; ``PLAIN_CUDA_CALLS`` counts its calls on
a CUDA device. ``emulate`` replays the kernel's per-row rules on any device
(the block's search of the memory prefix in rounds of 256 probes, its
window of 1,025 starts and each row's binary search, the successors taken
from lane + 1 or fetched by lane 31 and the last row, the pad rules) as a
function of the row index; ``block_search`` replays the search alone.
"""

from __future__ import annotations

import ctypes
from typing import Dict

import numpy as np
import torch

from ..components import tables as T
from ..core import m31
from ..vm.instruction import InstructionType
from . import nvcc
from .staging import PinnedRing

JUMPS = [("jump_if_not_zero", int(InstructionType.JumpIfNotZero)),
         ("jump_if_zero", int(InstructionType.JumpIfZero))]
OPS = [(f"{name}_instruction", int(op)) for name, op in T.OPCODES.items()]
SELECTIONS = JUMPS + OPS  # the opcode tables, in the claim's order

KIND = {"memory": 0, "instruction": 1, "program": 2, "processor": 3, "end_of_execution": 4,
        **{name: 5 for name, _ in JUMPS}, **{name: 6 for name, _ in OPS}}
COLUMNS = {"memory": 8, "instruction": 8, "program": 4, "processor": 9, "end_of_execution": 7,
           **{name: 13 for name, _ in JUMPS}, **{name: 11 for name, _ in OPS}}
THREADS = 256        # kThreads: a block's threads and the search's probes
BLOCK_ROWS = 1024    # kBlockRows: rows a block, four a thread kThreads apart
HEADER_WORDS = 16    # kHeaderWords
TABLE_WORDS = 8      # kTableWords
MAX_INDEX = 1 << 32  # a matrix's words and the trace's words must stay within 32-bit indices

PLAIN_CUDA_CALLS = 0


def _bind(lib: ctypes.CDLL) -> None:
    lib.tables_build.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p]
    lib.tables_build.restype = ctypes.c_int
    lib.tables_layout.argtypes = [ctypes.c_int]
    lib.tables_layout.restype = ctypes.c_int
    want = (THREADS, HEADER_WORDS, TABLE_WORDS, len(KIND), BLOCK_ROWS)
    got = tuple(lib.tables_layout(i) for i in range(5))
    if got != want:
        raise RuntimeError(f"csrc/tables.cu lays out (threads, header, table words, tables, "
                           f"rows a block) {got}, the wrapper {want}")


# ---------------------------------------------------------------------------
# The plain version
# ---------------------------------------------------------------------------

def _on(a, device) -> torch.Tensor:
    """An int32 copy of a host array (uint32 values < 2^31) or a tensor on
    `device`."""
    if isinstance(a, torch.Tensor):
        return a.to(device)
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


def tables_plain(tr: torch.Tensor, meta, device) -> Dict[str, torch.Tensor]:
    """name -> (n_cols, N) int32 matrix on `device`, rows in the host
    builders' column order, from the (7, n) int32 trace columns `tr` and a
    meta (``device_build.TraceMeta``'s fields as host arrays, or a
    ``DeviceMeta``'s as tensors): the kernel's plain version."""
    global PLAIN_CUDA_CALLS
    device = torch.device(device)
    if device.type == "cuda":
        PLAIN_CUDA_CALLS += 1
    n = meta.n_steps
    tr = tr.to(device)
    tclk, tip, tci, tni, tmp, tmv, tmvi = tr.contiguous()
    ar = lambda k, dt=torch.int64: torch.arange(k, dtype=dt, device=device)  # noqa: E731
    out: Dict[str, torch.Tensor] = {}

    # memory: each sorted row followed by its clk-gap rows (and, after the
    # last row, the power-of-two pad), which continue its clk with mp/mv held
    n_mem = 1 << meta.claim["memory"]
    order = _on(meta.order_mem, device).long()
    counts = _on(meta.counts_mem, device).long()
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
    prog = _on(meta.prog_cols, device)
    gi = _on(meta.order_ins, device).long()
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

    out["end_of_execution"] = _on(meta.eoe_cols, device)

    # jump + opcode tables: matched row i paired with row i + 1, then pad
    # entries (clk = last e2 clk + 2(r - k) and + 1, ip = last e2 ip)
    for name, _ in SELECTIONS:
        kk = meta.k[name]
        sel = _on(meta.sel[name], device).long()
        rows = len(sel)
        s = sel[:kk]
        e1 = tr[:, s]
        e2 = tr[:, s + 1]
        if kk:
            last = sel[kk - 1] + 1
            lk, li = tclk[last], tip[last]
        else:
            lk = li = torch.zeros((), dtype=torch.int32, device=device)
        jump = KIND[name] == KIND["jump_if_zero"]
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


# ---------------------------------------------------------------------------
# The launch
# ---------------------------------------------------------------------------

def heights(meta) -> Dict[str, int]:
    return {name: 1 << log for name, log in meta.claim.items()}


def plan(meta) -> np.ndarray:
    """The launch's table as int64 words, output pointers 0: the header
    (rows, memory order, memory starts, instruction order, program, opcode
    rows, end row: pointers; n, program length, program capacity, tables,
    blocks), then per matrix in the claim's order (pointer, kind, height,
    first block, columns, opcode rows, their first position in the grouped
    opcode rows, 0). Raises where a matrix or the trace would index past 32
    bits."""
    if tuple(meta.claim) != tuple(KIND):
        raise ValueError(f"table kernel: claim order {list(meta.claim)}, expected {list(KIND)}")
    n = meta.n_steps
    if n < 1 or 7 * n > MAX_INDEX or meta.plen + n > MAX_INDEX:
        raise ValueError(f"table kernel: a trace of {n} rows and a program of {meta.plen} "
                         f"index past 32 bits")
    words = np.zeros(HEADER_WORDS + len(KIND) * TABLE_WORDS, np.int64)
    block = 0
    for t, (name, height) in enumerate(heights(meta).items()):
        cols = COLUMNS[name]
        if cols * height > MAX_INDEX:
            raise ValueError(f"table kernel: {name} of {cols} x 2^{meta.claim[name]} words "
                             f"indexes past 32 bits")
        e = HEADER_WORDS + t * TABLE_WORDS
        words[e + 1:e + 7] = (KIND[name], height, block, cols, meta.k.get(name, 0),
                              meta.op_start.get(name, 0))
        block += -(-height // BLOCK_ROWS)
    if block >= 1 << 31:
        raise ValueError(f"table kernel: {block} blocks")
    words[7:12] = (n, meta.plen, meta.prog_cap, len(KIND), block)
    return words


class TableKernel:
    """The built kernel library, its launch count and its pinned table."""

    def __init__(self):
        self.lib = nvcc.CudaLibrary("tables", _bind)
        self.launches = 0
        self.staging = PinnedRing()

    def prepare(self, meta) -> tuple:
        """(the launch table's words, name -> matrix): the 13 outputs of a
        ``DeviceMeta`` on its CUDA device allocated, their pointers and the
        inputs' in the table."""
        words = plan(meta)
        dev = meta.rows.device
        inputs = (meta.rows, meta.order_mem, meta.starts_mem, meta.order_cat, meta.prog_cols,
                  meta.ops, meta.end_row)
        dtypes = (torch.int32, torch.int64, torch.int64, torch.int64, torch.int32, torch.int64,
                  torch.int64)
        for i, (x, dt) in enumerate(zip(inputs, dtypes)):
            if not x.is_cuda or x.device != dev or x.dtype != dt or not x.is_contiguous():
                raise ValueError(f"table kernel: input {i} is a {x.dtype} tensor on {x.device} "
                                 f"(contiguous {x.is_contiguous()}), expected {dt} on {dev}")
            words[i] = x.data_ptr()
        out = {}
        for t, (name, height) in enumerate(heights(meta).items()):
            out[name] = torch.empty((COLUMNS[name], height), dtype=torch.int32, device=dev)
            words[HEADER_WORDS + t * TABLE_WORDS] = out[name].data_ptr()
        return words, out

    def enqueue(self, table: torch.Tensor, blocks: int) -> None:
        """One launch over a launch table already on the card."""
        lib = self.lib.load()
        dev = table.device
        with torch.cuda.device(dev):
            rc = lib.tables_build(table.data_ptr(), blocks,
                                  torch.cuda.current_stream(dev).cuda_stream)
        if rc != 0:
            raise RuntimeError(f"table kernel launch failed: CUDA error {rc}")
        self.launches += 1

    def build(self, meta) -> Dict[str, torch.Tensor]:
        """The 13 matrices of a ``DeviceMeta`` on a CUDA device, in one
        launch: name -> (n_cols, 2^log) int32, in the claim's order."""
        words, out = self.prepare(meta)
        self.lib.load()
        dev = meta.rows.device
        with torch.cuda.device(dev):
            table = self.staging.to_card(words.view(np.int32), dev)
        self.enqueue(table, int(words[11]))
        return out


KERNEL = TableKernel()


def bound_bytes(meta) -> int:
    """The bytes the function must move: the trace rows read once, each
    matrix written once (the orders and counts the meta pass leaves are
    the kernel's own intermediates, not counted)."""
    return 4 * 7 * meta.n_steps + sum(4 * COLUMNS[name] * h for name, h in heights(meta).items())


# ---------------------------------------------------------------------------
# The kernel's per-row rules, replayed
# ---------------------------------------------------------------------------

def block_search(starts: torch.Tensor, r0: torch.Tensor) -> tuple:
    """The kernel's block_search for each block start r0: (i0, rounds),
    i0 the largest i with starts[i] <= r0, found in rounds of THREADS
    probes lo + k step of the interval [lo, hi] left (step = (hi - lo) //
    THREADS + 1), the count c of probes at or below hi with starts <= r0
    leaving [lo + (c - 1) step, min(hi, lo + c step - 1)]."""
    n = len(starts)
    lo = torch.zeros_like(r0)
    hi = torch.full_like(r0, n - 1)
    k = torch.arange(THREADS, dtype=torch.int64, device=r0.device)
    rounds = 0
    while bool((lo < hi).any()):
        step = (hi - lo) // THREADS + 1
        p = lo[:, None] + k[None, :] * step[:, None]
        ok = (p <= hi[:, None]) & (starts[p.clamp(max=n - 1)] <= r0[:, None])
        c = ok.sum(1)
        active = lo < hi
        top = lo + c * step - 1
        lo = torch.where(active, lo + (c - 1) * step, lo)
        hi = torch.where(active, torch.minimum(hi, top), hi)
        rounds += 1
    return lo, rounds


def _window_search(starts: torch.Tensor, height: int) -> tuple:
    """The memory rows' sources as the kernel finds them: block b's first
    source i0 (block_search of BLOCK_ROWS b), its window of BLOCK_ROWS + 1
    starts from i0 (past the end: int64 max), and row r0 + w's binary
    search over the window's first w + 1 entries. Returns (i, window entry
    at i, window entry at i + 1) a row of the blocks' whole rows (past
    height too)."""
    dev = starts.device
    n = len(starts)
    blocks = -(-height // BLOCK_ROWS)
    r0 = torch.arange(blocks, dtype=torch.int64, device=dev) * BLOCK_ROWS
    i0, _ = block_search(starts, r0)
    j = i0[:, None] + torch.arange(BLOCK_ROWS + 1, device=dev)[None, :]
    win = torch.where(j < n, starts[j.clamp(max=n - 1)], torch.iinfo(torch.int64).max)
    r = torch.arange(blocks * BLOCK_ROWS, dtype=torch.int64, device=dev).view(blocks, BLOCK_ROWS)
    lo = torch.zeros_like(r)
    hi = torch.arange(BLOCK_ROWS, device=dev).expand(blocks, BLOCK_ROWS).clone()
    while bool((lo < hi).any()):
        mid = (lo + hi + 1) >> 1
        take = torch.gather(win, 1, mid) <= r
        active = lo < hi
        lo = torch.where(active & take, mid, lo)
        hi = torch.where(active & ~take, mid - 1, hi)
    i = (i0[:, None] + lo).reshape(-1)
    at = torch.gather(win, 1, lo).reshape(-1)
    after = torch.gather(win, 1, lo + 1).reshape(-1)
    return i, at, after


def _from_next(col: torch.Tensor) -> torch.Tensor:
    """__shfl_down_sync(v, 1) over the rows of whole blocks: lane + 1's
    value (lane 31 gets its own back, as the instruction returns it)."""
    warps = col.reshape(-1, 32)
    return torch.cat([warps[:, 1:], warps[:, -1:]], 1).reshape(-1)


def emulate(meta) -> Dict[str, torch.Tensor]:
    """What one launch writes, on the meta's device, row by row as the
    kernel computes it (uint32 arithmetic as int64 masked to 32 bits), over
    the blocks' whole rows (past height too, as the shuffles see them):
    name -> (n_cols, 2^log) int32."""
    rows = meta.rows.to(torch.int64) & 0xFFFFFFFF  # (n, 7)
    dev = rows.device
    n, plen, pc = meta.n_steps, meta.plen, meta.prog_cap
    prog = meta.prog_cols.to(torch.int64)
    u32 = lambda x: x & 0xFFFFFFFF  # noqa: E731
    out = {}
    for name, height in heights(meta).items():
        kind = KIND[name]
        r = torch.arange(-(-height // BLOCK_ROWS) * BLOCK_ROWS, dtype=torch.int64, device=dev)
        last = r + 1 == height
        own = ((r % 32) == 31) | last  # no successor in lane + 1
        cols = []
        if kind == KIND["memory"]:
            i, at, after = _window_search(meta.starts_mem, height)
            within = r - at
            src = rows[meta.order_mem[i]]
            clk, mp, mv = u32(src[:, 0] + within), src[:, 4], src[:, 5]
            d = (within > 0).long()
            # lane 31 and the last row: the next sorted row where it starts
            # at r + 1, else clk + 1 with mp and mv held
            step = ~last & (after == r + 1)
            nxt = rows[meta.order_mem[torch.where(step, i + 1, i).clamp(max=n - 1)]]
            fetched = [torch.where(step, nxt[:, 0], u32(clk + 1)),
                       torch.where(step, nxt[:, 4], mp), torch.where(step, nxt[:, 5], mv),
                       (~step).long()]
            cols = [clk, mp, mv, d] + [torch.where(own, f, _from_next(v))
                                       for f, v in zip(fetched, (clk, mp, mv, d))]
        elif kind == KIND["instruction"]:
            nr = plen + n

            def fetch(q):
                g = meta.order_cat[q.clamp(max=nr - 1)]
                p = g < plen
                gp, gt = g.clamp(max=plen - 1), (g - plen).clamp(min=0)
                v = [torch.where(p, prog[c, gp], rows[gt, c + 1]) for c in range(3)]
                return [v[0], torch.where(q < nr, v[1], 0), torch.where(q < nr, v[2], 0)]

            v = fetch(r)
            d = (r >= nr).long()
            w = fetch(r + 1)
            fetched = [torch.where(last, v[0], w[0]), torch.where(last, 0, w[1]),
                       torch.where(last, 0, w[2]), torch.where(last, 1, (r + 1 >= nr).long())]
            cols = v + [d] + [torch.where(own, f, _from_next(x))
                              for f, x in zip(fetched, v + [d])]
        elif kind == KIND["program"]:
            cols = [prog[c, r.clamp(max=height - 1)] for c in range(4)]
        elif kind == KIND["processor"]:
            def clk_at(q):
                return torch.where(q < n, rows[q.clamp(max=n - 1), 0],
                                   u32(rows[n - 1, 0] + 1 + (q - n)))

            live = r < n
            src = rows[r.clamp(max=n - 1)]
            clk = clk_at(r)
            cols = [clk, torch.where(live, src[:, 1], rows[n - 1, 1]),
                    *[torch.where(live, src[:, c], 0) for c in range(2, 7)],
                    (~live).long(), torch.where(own, clk_at(r + 1), _from_next(clk))]
        elif kind == KIND["end_of_execution"]:
            cols = [torch.where(r == 0, rows[meta.end_row, c], 0) for c in range(7)]
        else:
            kk, st = meta.k[name], meta.op_start[name]
            matched = r < kk
            s = meta.ops[st + r.clamp(max=kk - 1)] if kk else torch.zeros_like(r)
            e1 = torch.where(matched[:, None], rows[s], 0)
            # trace row s + 1: lane + 1's where it holds it, else fetched
            s_next = _from_next(torch.where(matched, s, 0xFFFFFFFF))
            take = ~own & (s_next == s + 1)
            fetched = rows[(s + 1).clamp(max=n - 1)]
            e2 = {c: torch.where(take, _from_next(e1[:, c]), fetched[:, c]) for c in (0, 1, 4, 5)}
            if kk:
                tail = rows[meta.ops[st + kk - 1] + 1]
                lk, li = tail[0], tail[1]
            else:
                lk = li = torch.zeros((), dtype=torch.int64, device=dev)
            pad = u32(lk + 2 * (r - kk))
            head = [torch.where(matched, e1[:, 0], pad), torch.where(matched, e1[:, 1], li),
                    *[e1[:, c] for c in range(2, 7)]]
            tailcols = [torch.where(matched, e2[1], li), torch.where(matched, e2[4], 0),
                        torch.where(matched, e2[5], 0)]
            d = (~matched).long()
            if kind == KIND["jump_if_zero"]:
                mv, mvi = head[5], head[6]
                cols = [*head, torch.where(matched, e2[0], u32(pad + 1)), *tailcols, d,
                        m31.sub(1, m31.mul(mv, mvi))]
            else:
                cols = [*head, d, *tailcols]
        out[name] = torch.stack([c.to(torch.int64)[:height] for c in cols]).to(torch.int32)
    return out
