"""The constraint kernels: the hand-written Hopper kernels
(``csrc/constraint_kernel.cuh`` and ``csrc/logup_scan.cuh`` with the bodies
``ops/constraint_codegen.py`` emits into ``csrc/constraints.cu``) behind
``framework.component.composition_evaluate``,
``build_interaction_trace_async`` and ``logup_fractions`` on CUDA tensors.

Counterparts of ``stwo_brainfuck_tpu/framework/component.py``'s
``_constraints_fn`` (the composition contribution of a component, one fused
executable) and ``_build_interaction_fn`` (the LogUp fractions, their sum's
prefix sum in coset order and the claimed sum); bit for bit the plain
versions ``composition_contribution``, ``interaction_plain`` and
``logup_fractions_plain`` (the Expr path).

``KERNELS.composition(segments, elements, alpha, log_blowup)``: every
segment's (4, m) int32 accumulator (``framework.CompositionSegment``: the
storage positions offset .. offset + m - 1 of one size's blown-up domain
and its components) written in one launch a prove: each component's
weighted constraint sum, summed over the segment's components, over V_n;
V_n^-1 takes 2^log_blowup values there (``core/poly.py``
``vanishing_inverse_blocks``), which ride in the launch's table, and S(p -
g) is read through the int32 rotation index (``core/fft.py``
``rotation_index``) or from rows the kernel is given. ``plan_composition``
lays out the table (one alpha ladder gives every component's weights);
``emulate_composition`` replays a launch from it.
``KERNELS.interaction(...)``: ((K, 4, N) int32 Q_k, (4, N) int32 S, (4,)
int32 claimed sum) of a whole component in one launch: the coset scan of
``csrc/logup_scan.cuh`` with the rows' sums computed in the tile (one
device; ``emulate_interaction`` replays it). ``KERNELS.logup(...)``: ((K,
4, n) int32 Q_k, (4, n) int32 their sum) in one launch (the mesh's shards).
``KERNELS.scan(total, coset, carry)`` (``csrc/logup_scan.cu``, a library of
its own): the LogUp prefix sum S of that sum and its last value, the
claimed sum, both on the card, in one launch; in coset order (the same
skeleton, the sums read from ``total``) or, for a mesh shard already in
linear order, with a QM31 carry-in. ``scan_geometry`` mirrors the coset
tiles and ``emulate_scan`` replays a launch on any device. A library's
coset launches on a device share one head, a global of the library (zero
when it loads, left zero by each launch's last CTA: no fill runs before a
launch; ``head`` reads it).

Each launch's column pointers and constants (the lookup elements and, for
composition, the segments, each component's claimed sum and weights
alpha^(offset + i), V_n^-1) go to the card as one small table from a
reused pinned buffer (``ops/staging.py``) with one non-blocking copy. The wrapper checks
what it is given (CUDA, int32, 1-D rows with unit stride, one length, one
device, the positions inside the domain) before it loads the library, and
raises on what the kernel does not take; the C entry returns
``cudaGetLastError()`` and the wrapper raises if it is not 0. The library
is built with nvcc at first use (``ops/nvcc.py``).
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import tracing
from ..components.defs import COMPONENT_CLASSES
from ..core import m31, poly, qm31
from ..core.m31 import P_INT
from ..framework.component import LookupElements, constraint_program, emulate
from . import nvcc
from .staging import PinnedRing
from .constraint_codegen import (ELEMENT_ORDER, ELEMENT_WORDS, M31_INV, OWN_CLAIMED, OWN_WEIGHTS,
                                 QM_INV, batch_inv_products, composition_slots,
                                 interaction_slots, logup_slots, op_work, own_words,
                                 weight_offsets)

FAMILIES = ("composition", "logup", "scan", "interaction")
SCAN_WARPS = 8
SCAN_LINEAR_TILE = 2048  # values a linear tile (8 warps of 8 rounds of 32)
SCAN_MIN_TILE_ROWS = 16  # logup_scan::kMinTileRows
SCAN_MAX_TILES = 4096  # logup_scan::kMaxTiles: the shared head's flags
SCAN_VEC = 256  # a coset tile's vector (words)
BATCH_ROWS = 4  # constraints::kBatchRows: rows whose norms one m31_inv inverts
RESIDENT_TILES = 264  # the emulations' default: an H100's 132 SMs at two CTAs each
MAX_EVAL_LOG = 30  # qm31::kMaxLogSize: the largest canonic domain the kernel takes
THREADS = 256  # constraints::kThreads
COMPONENT_IDS = {cls.name: i for i, cls in enumerate(COMPONENT_CLASSES)}
# the composition launch's table (csrc/constraint_kernel.cuh): 8-byte words
COMP_HEADER_WORDS = 4    # kCompHeaderWords: segments, blocks, members, the constants' word
SEGMENT_WORDS = 10       # kSegmentWords
MEMBER_WORDS = 3         # kMemberWords
SEGMENT_FIELDS = ("first_block", "rows", "offset", "log_size", "rot", "acc", "is_first",
                  "first_member", "members", "v_inv")


def _bind(lib: ctypes.CDLL) -> None:
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.constraints_components.restype = i32
    lib.constraints_component_name.argtypes = [i32]
    lib.constraints_component_name.restype = ctypes.c_char_p
    lib.constraints_shape.argtypes = [i32, ptr]
    lib.constraints_shape.restype = i32
    lib.constraints_composition.argtypes = [ptr, i64, ptr]
    lib.constraints_composition.restype = i32
    lib.constraints_logup.argtypes = [i32, ptr, i32, i32, i64, ptr, ptr, ptr]
    lib.constraints_logup.restype = i32
    lib.constraints_interaction_geometry.argtypes = [i32, i32, ptr]
    lib.constraints_interaction_geometry.restype = i32
    lib.constraints_interaction.argtypes = [i32, ptr, i32, i32, i32, ptr, ptr, ptr, ptr, ptr, ptr]
    lib.constraints_interaction.restype = i32
    lib.constraints_head.argtypes = [ptr, i32]
    lib.constraints_head.restype = i32
    # the built file must be the one the programs emit now
    if lib.constraints_components() != len(COMPONENT_CLASSES):
        raise RuntimeError("csrc/constraints.cu: another component count; regenerate it")
    for cls, i in ((c, COMPONENT_IDS[c.name]) for c in COMPONENT_CLASSES):
        shape = (ctypes.c_int * 5)()
        lib.constraints_shape(i, ctypes.addressof(shape))
        if lib.constraints_component_name(i).decode() != cls.name or tuple(shape) != shape_of(cls):
            raise RuntimeError(f"csrc/constraints.cu: component {i} is not {cls.name} "
                               f"{shape_of(cls)}; regenerate it")


def shape_of(cls) -> Tuple[int, int, int, int, int]:
    """(columns, relations, constraints, pointer slots and own constant
    words in the composition launch) of a component class."""
    p = constraint_program(cls)
    return (len(p.columns), len(p.relations), len(p.constraints), composition_slots(p),
            own_words(p))


# ---------------------------------------------------------------------------
# Tables
# ---------------------------------------------------------------------------

def _words(v) -> list:
    return [int(c) % P_INT for c in v]


def pack_constants(elements: Dict[str, LookupElements]) -> np.ndarray:
    """The lookup elements' constant words (uint32) in ELEMENT_ORDER:
    alpha^0 .. alpha^(size - 1), then z."""
    words = []
    for name in ELEMENT_ORDER:
        els = elements[name]
        for a in els.alpha_powers:
            words += _words(a)
        words += _words(els.z)
    assert len(words) == ELEMENT_WORDS
    return np.array(words, np.uint32)


def weight_words(w: tuple, qm: bool) -> list:
    """A constraint's weight words in the composition launch: for an
    M31-valued constraint the weight's 4 coordinates; for a QM31-valued one
    the 4 x 4 matrix of the product by w = (a + b i) + (c + d i) u,
    row-major, so that (w x)[k] = sum_j M[k][j] x[j]: with u^2 = 2 + i,
    rows (a, -b, 2c - d, -c - 2d), (b, a, c + 2d, 2c - d), (c, -d, a, -b),
    (d, c, b, a) mod p."""
    if not qm:
        return _words(w)
    a, b, c, d = (int(v) % P_INT for v in w)
    return [v % P_INT for v in (a, -b, 2 * c - d, -c - 2 * d, b, a, c + 2 * d, 2 * c - d,
                                c, -d, a, -b, d, c, b, a)]


def weights(alpha: tuple, alpha_offset: int, n: int) -> list:
    """alpha^(alpha_offset + i), i < n (host QM31), one product a power."""
    first = qm31.h_pow(alpha, alpha_offset)
    out = [first]
    for _ in range(n - 1):
        out.append(qm31.h_mul(out[-1], alpha))
    return out


def _bind_scan(lib: ctypes.CDLL) -> None:
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.logup_scan_geometry.argtypes = [i32, ptr]
    lib.logup_scan_geometry.restype = i32
    lib.logup_scan_scratch.argtypes = [i64, ptr]
    lib.logup_scan_scratch.restype = i32
    lib.logup_scan_coset.argtypes = [ptr, ptr, ptr, ptr, i32, ptr]
    lib.logup_scan_coset.restype = i32
    lib.logup_scan_head.argtypes = [ptr, i32]
    lib.logup_scan_head.restype = i32
    lib.logup_scan_linear.argtypes = [ptr, ptr, ptr, ptr, ptr, ptr, i64, ptr]
    lib.logup_scan_linear.restype = i32


def pack_table(pointers: Sequence[int], words: np.ndarray) -> np.ndarray:
    """A launch's table as uint32 words: the pointers (8 bytes each, little
    endian), then the constant words."""
    return np.concatenate([np.array(pointers, np.uint64).view(np.uint32), words])


def plan_composition(segments, elements: Dict[str, LookupElements], alpha: tuple,
                     log_blowup: int, outputs: Sequence[int] = ()) -> Tuple[np.ndarray, int]:
    """The composition launch's table as uint32 words, and its blocks (of
    THREADS rows of one segment).

    8-byte words: the header (segments, blocks, components, the word the
    constants start at), a segment's words each (first block, rows,
    offset, log_size, rotation index pointer or 0, accumulator pointer
    (`outputs`, 0 if not given), is_first pointer, first component, count,
    the uint32 word of its V_n^-1 values), a component's words each (its
    index in COMPONENT_CLASSES, its first pointer's 8-byte word, its own
    constant words' first word), the column pointers (a component's main
    columns, interaction rows, S rows: composition_slots); then the uint32
    constants: the lookup elements, a component's claimed sum and weights
    (one alpha ladder from alpha^0 to the largest exponent; weight_words a
    constraint), a segment's 2^log_blowup words of V_n^-1 (padded to an
    even count)."""
    members = [m for seg in segments for m in seg.members]
    top = max(m.alpha_offset + len(constraint_program(type(m.component)).constraints)
              for m in members)
    ladder = weights(alpha, 0, top)
    n_words = (COMP_HEADER_WORDS + SEGMENT_WORDS * len(segments) + MEMBER_WORDS * len(members)
               + sum(composition_slots(constraint_program(type(m.component))) for m in members))
    head = np.zeros(n_words, np.uint64)
    consts = [pack_constants(elements)]
    cwords = ELEMENT_WORDS
    ptr = COMP_HEADER_WORDS + SEGMENT_WORDS * len(segments) + MEMBER_WORDS * len(members)
    block = j = 0
    for s, seg in enumerate(segments):
        rows = int(seg.is_first.shape[0])
        e = COMP_HEADER_WORDS + SEGMENT_WORDS * s
        first_member = j
        for mem in seg.members:
            program = constraint_program(type(mem.component))
            w = ladder[mem.alpha_offset:mem.alpha_offset + len(program.constraints)]
            own = np.array(_words(mem.claimed_sum) + [
                v for q, c in zip(w, program.constraints) for v in weight_words(q, program.qm[c])],
                np.uint32)
            k = COMP_HEADER_WORDS + SEGMENT_WORDS * len(segments) + MEMBER_WORDS * j
            head[k:k + MEMBER_WORDS] = (COMPONENT_IDS[mem.component.name], ptr, cwords)
            rows_of = _main_rows(mem.component, mem.main_cols) + list(mem.inter_rows) + \
                list(mem.s_rows)
            head[ptr:ptr + len(rows_of)] = [r.data_ptr() for r in rows_of]
            ptr += len(rows_of)
            consts.append(own)
            cwords += own.size
            j += 1
        v_inv = np.array(poly.vanishing_inverse_blocks(seg.log_size, log_blowup), np.uint32)
        head[e:e + SEGMENT_WORDS] = (
            block, rows, seg.offset, seg.log_size,
            0 if seg.rotation is None else seg.rotation.data_ptr(),
            outputs[s] if outputs else 0, seg.is_first.data_ptr(), first_member,
            len(seg.members), cwords)
        consts.append(v_inv)
        cwords += v_inv.size
        block += -(-rows // THREADS)
    if cwords % 2:
        consts.append(np.zeros(1, np.uint32))
    head[:COMP_HEADER_WORDS] = (len(segments), block, len(members), n_words)
    return np.concatenate([head.view(np.uint32), *consts]), block


def emulate_composition(segments, elements: Dict[str, LookupElements], alpha: tuple,
                        log_blowup: int) -> list:
    """What one composition launch writes, on the segments' device, read
    from its table (plan_composition): the flat grid's blocks a segment,
    then at each row of a segment each component's program (its pointers
    resolved to the tensors given, framework.component.emulate), its
    weighted sum with the claimed sum and weights of the table, the
    segment's components summed and multiplied by the table's V_n^-1 at
    position >> log_size; a (4, m) int32 tensor a segment."""
    words, blocks = plan_composition(segments, elements, alpha, log_blowup)
    head = words.view(np.uint64).astype(np.int64)  # the 8-byte words (pointers below 2^63)
    n_seg, n_blocks, _, cword = (int(v) for v in head[:COMP_HEADER_WORDS])
    consts = words[2 * cword:].astype(np.int64)
    assert n_blocks == blocks and (consts[:ELEMENT_WORDS] == pack_constants(elements)).all()
    tensors: Dict[int, torch.Tensor] = {}
    for seg in segments:
        for t in [seg.is_first, seg.rotation] + [
                r for m in seg.members for r in [*m.main_cols.values(), *m.inter_rows,
                                                  *m.s_rows]]:
            if t is not None and t.numel() > tensors.get(t.data_ptr(), t[:0]).numel():
                tensors[t.data_ptr()] = t
    seg_words = head[COMP_HEADER_WORDS:COMP_HEADER_WORDS + SEGMENT_WORDS * n_seg]
    fields = [dict(zip(SEGMENT_FIELDS, (int(v) for v in seg_words[SEGMENT_WORDS * s:
                                                                  SEGMENT_WORDS * (s + 1)])))
              for s in range(n_seg)]
    # the grid: block b runs the last segment whose first block is <= b
    firsts = np.array([f["first_block"] for f in fields])
    owner = np.searchsorted(firsts, np.arange(n_blocks), side="right") - 1
    out = []
    for s, f in enumerate(fields):
        rows = f["rows"]
        assert (owner == s).sum() == -(-rows // THREADS)
        dev = tensors[f["is_first"]].device
        t = torch.arange(rows, dtype=torch.int64, device=dev)
        pos = f["offset"] + t
        if f["rot"]:
            s_row = tensors[f["rot"]].to(torch.int64)[pos]
        else:
            s_row = t
        total = torch.zeros((4, rows), dtype=torch.int64, device=dev)
        for j in range(f["first_member"], f["first_member"] + f["members"]):
            k = COMP_HEADER_WORDS + SEGMENT_WORDS * n_seg + MEMBER_WORDS * j
            cid, ptr, own = (int(v) for v in head[k:k + MEMBER_WORDS])
            cls = COMPONENT_CLASSES[cid]
            program = constraint_program(cls)
            n_cols, n_inter = len(program.columns), 4 * (len(program.relations) + 1)
            ptrs = [int(v) for v in head[ptr:ptr + composition_slots(program)]]
            cols = [tensors[q][:rows] for q in ptrs[:n_cols]]
            inter = [tensors[q][:rows] for q in ptrs[n_cols:n_cols + n_inter]]
            s_prev = torch.stack([tensors[q].to(torch.int64)[s_row] for q in ptrs[-4:]])
            claimed = tuple(int(v) for v in consts[own + OWN_CLAIMED:own + OWN_CLAIMED + 4])
            vals = emulate(program, {
                "cols": cols, "is_first": tensors[f["is_first"]][:rows],
                "inter": [inter[4 * c:4 * c + 4] for c in range(n_inter // 4)],
                "s_prev": s_prev, "claimed": claimed, "elements": elements},
                program.constraints)
            # each weight's words: 4 coordinates, or the product's 4 x 4 matrix
            for c, off in zip(program.constraints, weight_offsets(program)):
                at = own + OWN_WEIGHTS + off
                if program.qm[c]:
                    mat = torch.tensor(consts[at:at + 16], dtype=torch.int64, device=dev)
                    term = (mat.reshape(4, 4, 1) * vals[c][None] % P_INT).sum(1) % P_INT
                else:
                    wq = torch.tensor(consts[at:at + 4], dtype=torch.int64, device=dev)
                    term = wq.reshape(4, 1) * vals[c] % P_INT
                total = (total + term) % P_INT
        v_inv = torch.tensor(consts[f["v_inv"]:f["v_inv"] + (1 << log_blowup)],
                             dtype=torch.int64, device=dev)
        out.append((total * v_inv[pos >> f["log_size"]] % P_INT).to(torch.int32))
    return out


def emulate_logup(component, main_cols: Dict[str, torch.Tensor], is_first: torch.Tensor,
                  elements: Dict[str, LookupElements]) -> Tuple[torch.Tensor, torch.Tensor]:
    """What one logup launch computes, on any device: ((K, 4, n) int32 Q_k,
    (4, n) int32 their sum)."""
    program = constraint_program(type(component))
    vals = emulate(program, {"cols": [main_cols[c] for c in component.columns],
                             "is_first": is_first, "elements": elements}, program.fractions)
    q = torch.stack([vals[f] for f in program.fractions])
    return q.to(torch.int32), (q.sum(0) % P_INT).to(torch.int32)


def scan_geometry(log_n: int, max_tiles: int) -> Tuple[int, int, int, int, int]:
    """(col_log, row_log, tile_rows, tiles, rows_per_warp) of a coset launch
    of 2^log_n rows (the scan's and the interaction kernel's) planned for
    max_tiles resident CTAs, as csrc/logup_scan.cuh tiles_for: the pair
    index j < 2^(log_n - 1) read as 2^row_log rows of 2^col_log columns
    (col_log = min(5, log_n - 2)); a tile tile_rows rows of the chain's
    first half (and their mirrors), the least power of two of at least
    SCAN_MIN_TILE_ROWS that keeps tiles <= max_tiles (all the rows where
    there are fewer); rows_per_warp of them a warp."""
    if not 2 <= log_n <= MAX_EVAL_LOG:
        raise ValueError(f"the scan takes 2^2 .. 2^{MAX_EVAL_LOG} rows, not 2^{log_n}")
    m = log_n - 1
    col_log = min(5, m - 1)
    row_log = m - col_log
    low_rows = 1 << (row_log - 1)
    per_tile = -(-low_rows // max(1, max_tiles))
    rows = SCAN_MIN_TILE_ROWS
    while rows < per_tile:
        rows <<= 1
    tile_rows = min(rows, low_rows)
    return col_log, row_log, tile_rows, low_rows // tile_rows, max(1, tile_rows >> 3)


def on_chip_bytes(log_n: int, max_tiles: int) -> int:
    """Shared memory a tile's sums take on chip (16 words a lane and row)."""
    return scan_geometry(log_n, max_tiles)[2] * 16 * 32 * 4


def _bitrev(x: torch.Tensor, bits: int) -> torch.Tensor:
    out = torch.zeros_like(x)
    for b in range(bits):
        out |= ((x >> b) & 1) << (bits - 1 - b)
    return out


def _cumsum_mod(x: torch.Tensor, dim: int) -> torch.Tensor:
    return torch.cumsum(x, dim=dim) % P_INT


def emulate_scan(total: torch.Tensor, coset: bool = True, carry: Optional[torch.Tensor] = None,
                 max_tiles: int = RESIDENT_TILES) -> Tuple[torch.Tensor, torch.Tensor]:
    """What one scan launch computes, on any device, as the kernel
    schedules it (coset: planned for max_tiles resident CTAs): ((4, n)
    int32 S, (4,) int32 its last linear value).

    coset: the pairs (2j, N - 1 - 2j) and their mirrors as the lanes read
    them, each warp's rows and each tile's sums, the tiles' chain (the
    look-back's result), the column totals scanned in key order (rev over
    col_log bits), and the four words a lane writes a row. Else the linear
    tiles of 8 warps of 8 rounds of 32 values, each warp's running sums,
    the tiles' chain and the carry."""
    x = total.to(torch.int64)
    n = x.shape[1]
    dev = x.device
    if not coset:
        c = (torch.zeros(4, dtype=torch.int64, device=dev) if carry is None
             else carry.to(torch.int64))
        tiles = -(-n // SCAN_LINEAR_TILE)
        pad = torch.zeros((4, tiles * SCAN_LINEAR_TILE), dtype=torch.int64, device=dev)
        pad[:, :n] = x
        rounds = pad.reshape(4, tiles, SCAN_WARPS, 8, 32)
        lane_scan = _cumsum_mod(rounds, 4)                             # a round's warp scan
        round_off = _cumsum_mod(lane_scan[..., -1], 3) - lane_scan[..., -1]   # rounds before
        warp_tot = _cumsum_mod(lane_scan[..., -1], 3)[..., -1]           # (4, tiles, warps)
        warp_off = _cumsum_mod(warp_tot, 2) - warp_tot
        agg = warp_tot.sum(2) % P_INT                                   # (4, tiles)
        chain = _cumsum_mod(agg, 1) - agg
        s = (lane_scan + round_off[..., None] + warp_off[..., None, None]
             + chain[:, :, None, None, None] + c[:, None, None, None, None]) % P_INT
        s = s.reshape(4, -1)[:, :n]
        return s.to(torch.int32), s[:, -1].to(torch.int32)
    log_n = n.bit_length() - 1
    col_log, row_log, tile_rows, tiles, rpw = scan_geometry(log_n, max_tiles)
    cols = 1 << col_log
    kr = torch.arange(1 << (row_log - 1), dtype=torch.int64, device=dev)
    j = (_bitrev(kr, row_log) << col_log)[:, None] + torch.arange(cols, device=dev)[None, :]
    a0, a1, b0, b1 = x[:, 2 * j], x[:, 2 * j + 1], x[:, n - 2 - 2 * j], x[:, n - 1 - 2 * j]
    pl, ph = (a0 + b1) % P_INT, (b0 + a1) % P_INT        # (4, rows, lanes); ph for column C-1-lane
    warps = SCAN_WARPS if tile_rows >= SCAN_WARPS else tile_rows
    shape = (4, tiles, warps, rpw, cols)
    pl, ph = pl.reshape(shape), ph.reshape(shape)
    part_l, part_h = pl.sum(3) % P_INT, ph.sum(3) % P_INT      # (4, tiles, warps, lanes)
    agg_l, agg_h = part_l.sum(2) % P_INT, part_h.sum(2) % P_INT
    off_l = (_cumsum_mod(agg_l, 1) - agg_l)[:, :, None] + _cumsum_mod(part_l, 2) - part_l
    off_h = (_cumsum_mod(agg_h, 1) - agg_h)[:, :, None] + _cumsum_mod(part_h, 2) - part_h
    lane = torch.arange(cols, device=dev)
    col_total = (agg_l.sum(1) + agg_h.sum(1).flip(1)) % P_INT    # (4, lanes)
    key = _bitrev(lane, col_log)
    in_keys = col_total[:, key]
    incl = _cumsum_mod(in_keys, 1)
    col_excl = (incl - in_keys)[:, key]
    mirror_incl = ((col_excl + col_total) % P_INT).flip(1)
    lo = (off_l[:, :, :, None] + _cumsum_mod(pl, 3)) % P_INT             # inclusive
    hi = (off_h[:, :, :, None] + _cumsum_mod(ph, 3) - ph) % P_INT        # exclusive
    pre = (col_excl[:, None, None, None] + lo) % P_INT
    pre_m = (mirror_incl[:, None, None, None] - hi) % P_INT
    s = torch.empty_like(x)
    jj = j.reshape(tiles, warps, rpw, cols)
    s[:, 2 * jj] = (pre - b1.reshape(shape)) % P_INT
    s[:, 2 * jj + 1] = pre_m
    s[:, n - 2 - 2 * jj] = (pre_m - a1.reshape(shape)) % P_INT
    s[:, n - 1 - 2 * jj] = pre
    return s.to(torch.int32), incl[:, -1].to(torch.int32)


def _batch_inv(z: torch.Tensor) -> torch.Tensor:
    """qm31::batch_inv along the last axis (int64, canonical): the running
    products (a zero takes 1), one inverse, two products a value on the way
    back; a zero gets 0."""
    zz = torch.where(z == 0, torch.ones_like(z), z)
    run = [zz[..., 0]]
    for m in range(1, z.shape[-1]):
        run.append(run[-1] * zz[..., m] % P_INT)
    t = m31.inv(run[-1])
    out = torch.empty_like(z)
    for m in range(z.shape[-1] - 1, 0, -1):
        out[..., m] = t * run[m - 1] % P_INT
        t = t * zz[..., m] % P_INT
    out[..., 0] = t
    return torch.where(z == 0, torch.zeros_like(z), out)


def emulate_fractions(component, main_cols: Dict[str, torch.Tensor], is_first: torch.Tensor,
                      elements: Dict[str, LookupElements], order: torch.Tensor,
                      batch: int = BATCH_ROWS) -> torch.Tensor:
    """The Q_k of the rows `order` ((..., B') int64 row indices, the last
    axis a thread's rows in its order) as the kernels' batched inversion
    computes them: the program's denominators (constraint_codegen's split),
    each den's CM31 denominator and norm (qm31::qm_inv_den, cm_norm), the
    norms of `batch` consecutive rows' K relations (row-major) inverted
    together (_batch_inv), each inverse from its norm's (qm_inv_from), then
    the fractions with those inverses given; (K, 4, *order.shape) int64."""
    program = constraint_program(type(component))
    idx = order.reshape(-1)
    inputs = {"cols": [main_cols[c][idx] for c in component.columns],
              "is_first": is_first[idx], "elements": elements}
    inv_ops = program.inversions()
    vals = emulate(program, inputs, [d for d, _ in inv_ops])
    k = len(inv_ops)
    x = torch.stack([vals[d] for d, _ in inv_ops])            # (K, 4, rows)
    a, b, c, d = x[:, 0], x[:, 1], x[:, 2], x[:, 3]
    a2r, a2i = (a * a - b * b) % P_INT, 2 * a * b % P_INT
    b2r, b2i = (c * c - d * d) % P_INT, 2 * c * d % P_INT
    den_r = (a2r - 2 * b2r + b2i) % P_INT
    den_i = (a2i - b2r - 2 * b2i) % P_INT
    norm = (den_r * den_r + den_i * den_i) % P_INT                 # (K, rows)
    # a batch: `batch` consecutive rows of a thread, their K norms row-major
    lead = order.shape[:-1]
    per = order.shape[-1]
    grouped = norm.reshape(k, *lead, per // batch, batch).movedim(0, -1)
    ninv = _batch_inv(grouped.reshape(*lead, per // batch, batch * k))
    ninv = ninv.reshape(*lead, per // batch, batch, k).movedim(-1, 0).reshape(k, -1)
    di_r, di_i = den_r * ninv % P_INT, (P_INT - den_i) % P_INT * ninv % P_INT
    inv = torch.stack([(a * di_r - b * di_i) % P_INT, (a * di_i + b * di_r) % P_INT,
                       (-c * di_r + d * di_i) % P_INT, (-c * di_i - d * di_r) % P_INT], 1)
    given = {}
    for j, (_, i) in enumerate(inv_ops):
        given.setdefault(i, inv[j])
    vals = emulate(program, inputs, program.fractions, given)
    q = torch.stack([vals[f].expand(4, idx.shape[0]) for f in program.fractions])
    return q.reshape(len(program.fractions), 4, *order.shape)


def emulate_interaction(component, main_cols: Dict[str, torch.Tensor],
                        elements: Dict[str, LookupElements], max_tiles: int = RESIDENT_TILES,
                        batch: int = BATCH_ROWS
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """What one interaction launch computes, on any device, as it schedules
    it: each lane's pair row j (tiles of scan_geometry(log_n, max_tiles))
    and its four storage rows 2j, 2j + 1, N - 2 - 2j, N - 1 - 2j, their
    fractions in batches of `batch` rows (emulate_fractions; is_first is t
    == 0), the Q_k stored at those rows and their sums handed to the coset
    scan (emulate_scan); ((K, 4, N) int32 Q_k, (4, N) int32 S, (4,) int32
    claimed sum)."""
    n = 1 << component.log_size
    dev = main_cols[component.columns[0]].device
    col_log, row_log, _, _, _ = scan_geometry(component.log_size, max_tiles)
    kr = torch.arange(1 << (row_log - 1), dtype=torch.int64, device=dev)
    j = (_bitrev(kr, row_log) << col_log)[:, None] + torch.arange(1 << col_log, device=dev)
    order = torch.stack([2 * j, 2 * j + 1, n - 2 - 2 * j, n - 1 - 2 * j], -1)
    is_first = (torch.arange(n, device=dev) == 0).to(torch.int64)
    q = emulate_fractions(component, main_cols, is_first, elements, order, batch)
    out = torch.empty((q.shape[0], 4, n), dtype=torch.int64, device=dev)
    out[:, :, order.reshape(-1)] = q.reshape(q.shape[0], 4, -1)
    total = (out.sum(0) % P_INT).to(torch.int32)
    s, claimed = emulate_scan(total, True, None, max_tiles)
    return out.to(torch.int32), s, claimed


# ---------------------------------------------------------------------------
# Checks (before any library load)
# ---------------------------------------------------------------------------

def _check_rows(rows: Sequence[torch.Tensor], what: str, n: Optional[int] = None
                ) -> Tuple[torch.device, int]:
    """Raise unless the rows are int32 vectors of one length (n if given)
    with unit stride on one device; returns the device and the length."""
    if not rows:
        raise ValueError(f"{what}: no rows")
    for r in rows:
        if not isinstance(r, torch.Tensor):
            raise TypeError(f"{what}: a row is a {type(r).__name__}, not a tensor")
        if r.dtype != torch.int32:
            raise TypeError(f"the constraint kernels take int32 rows, {what} has {r.dtype}")
    n = int(rows[0].shape[-1]) if n is None else n
    for r in rows:
        if r.dim() != 1 or r.shape[0] != n:
            raise ValueError(f"{what}: a row of shape {tuple(r.shape)}, expected ({n},)")
        if n > 1 and r.stride(0) != 1:
            raise ValueError(f"{what}: row stride {r.stride(0)}, the kernel takes 1")
        if r.device != rows[0].device:
            raise ValueError(f"{what}: rows on {r.device} and {rows[0].device}")
    if not n:
        raise ValueError(f"{what}: empty rows")
    return rows[0].device, n


def _require_cuda(dev: torch.device, what: str) -> None:
    if dev.type != "cuda":
        raise ValueError(f"the constraint kernels take CUDA tensors, {what} is on {dev}")


def _main_rows(component, main_cols: Dict[str, torch.Tensor]) -> list:
    missing = [c for c in component.columns if c not in main_cols]
    if missing:
        raise ValueError(f"{component.name}: no column {missing}")
    return [main_cols[c] for c in component.columns]


def _check_segments(segments, log_blowup: int) -> torch.device:
    """Raise unless every segment's rows are int32 vectors of its length on
    one device, its components of its log_size with their interaction and S
    rows, its positions inside a domain the kernel takes, and every 32-bit
    index of the launch in range; returns the device."""
    if not segments:
        raise ValueError("composition: no segments")
    dev, blocks = None, 0
    for seg in segments:
        n = seg.log_size
        what = f"composition segment 2^{n} at {seg.offset}"
        if not seg.members:
            raise ValueError(f"{what}: no components")
        rows = [seg.is_first]
        for mem in seg.members:
            program = constraint_program(type(mem.component))
            if mem.component.log_size != n:
                raise ValueError(f"{what}: {mem.component.name} of log_size "
                                 f"{mem.component.log_size}")
            n_inter = 4 * (len(program.relations) + 1)
            if len(mem.inter_rows) != n_inter or len(mem.s_rows) != 4:
                raise ValueError(f"{what}: {mem.component.name} has {len(mem.inter_rows)} "
                                 f"interaction rows and {len(mem.s_rows)} S rows, expected "
                                 f"{n_inter} and 4")
            rows += _main_rows(mem.component, mem.main_cols) + list(mem.inter_rows)
        d, m = _check_rows(rows, what)
        eval_log = n + log_blowup
        if (n < 1 or log_blowup < 0 or eval_log > MAX_EVAL_LOG or seg.offset < 0
                or seg.offset + m > 1 << eval_log):
            raise ValueError(f"{what}: positions {seg.offset} .. {seg.offset + m - 1} of a "
                             f"domain of 2^{eval_log}")
        s_rows = [r for mem in seg.members for r in mem.s_rows]
        if seg.rotation is None:
            _check_rows(s_rows, f"{what}: S(p - g) rows", m)
        else:
            _check_rows([*s_rows, seg.rotation], f"{what}: S rows and rotation index",
                        1 << eval_log)
            if seg.rotation.device != d:
                raise ValueError(f"{what}: S rows on {seg.rotation.device}, the columns on {d}")
        if dev is not None and d != dev:
            raise ValueError(f"composition: segments on {dev} and {d}")
        dev = d
        blocks += -(-m // THREADS)
    if blocks >= 1 << 31:
        raise ValueError(f"composition: {blocks} blocks")
    return dev


class ConstraintKernels:
    """The built library and the launch count of each family."""

    def __init__(self):
        self.lib = nvcc.CudaLibrary("constraints", _bind)
        self.scan_lib = nvcc.CudaLibrary("logup_scan", _bind_scan)
        self.launches = dict.fromkeys(FAMILIES, 0)
        self.staging = PinnedRing()
        self._plans: Dict[tuple, Tuple[int, ...]] = {}

    def head(self, kind, dev: torch.device) -> list:
        """The coset launches' head on `dev` (ticket, exit count, a flag a
        tile; a global of the library, "scan" or the interaction's): zero
        when the library loads, left zero by every launch."""
        out = (ctypes.c_uint32 * (2 + SCAN_MAX_TILES))()
        with torch.cuda.device(dev):
            lib = self.scan_lib.load().logup_scan_head if kind == "scan" else \
                self.lib.load().constraints_head
            rc = lib(ctypes.addressof(out), len(out))
        if rc != 0:
            raise RuntimeError(f"the coset head: CUDA error {rc}")
        return list(out)

    def geometry(self, kind, log_n: int, dev: torch.device) -> Tuple[int, ...]:
        """(col_log, row_log, tile_rows, tiles, rows_per_warp, on_chip,
        resident tiles) of a coset launch of 2^log_n rows on `dev`: kind a
        component class (the interaction kernel) or "scan"."""
        key = (kind, log_n, dev)
        if key not in self._plans:
            out = (ctypes.c_int * 7)()
            with torch.cuda.device(dev):
                if kind == "scan":
                    rc = self.scan_lib.load().logup_scan_geometry(log_n, ctypes.addressof(out))
                else:
                    rc = self.lib.load().constraints_interaction_geometry(
                        COMPONENT_IDS[kind.name], log_n, ctypes.addressof(out))
            if rc != 0:
                raise RuntimeError(f"coset launch of 2^{log_n} rows: no plan, CUDA error {rc}")
            self._plans[key] = tuple(out)
        return self._plans[key]

    def composition(self, segments, elements: Dict[str, LookupElements], alpha: tuple,
                    log_blowup: int) -> list:
        """framework.composition_evaluate in one launch: a (4, m) int32
        accumulator a segment, written."""
        with tracing.span("composition.plan"):
            dev = _check_segments(segments, log_blowup)
            _require_cuda(dev, "the composition's rows")
            lib = self.lib.load()
            out = [torch.empty((4, seg.is_first.shape[0]), dtype=torch.int32, device=dev)
                   for seg in segments]
            words, blocks = plan_composition(segments, elements, alpha, log_blowup,
                                             [o.data_ptr() for o in out])
        with tracing.span("composition.kernel"), torch.cuda.device(dev):
            table = self.staging.to_card(words, dev)
            rc = lib.constraints_composition(table.data_ptr(), blocks,
                                             torch.cuda.current_stream(dev).cuda_stream)
        if rc != 0:
            raise RuntimeError(f"composition kernel launch failed: CUDA error {rc}")
        self.launches["composition"] += 1
        return out

    def logup(self, component, main_cols: Dict[str, torch.Tensor], is_first: torch.Tensor,
              elements: Dict[str, LookupElements]) -> Tuple[torch.Tensor, torch.Tensor]:
        """framework.component.logup_fractions in one launch: ((K, 4, n)
        int32 Q_k, (4, n) int32 their sum)."""
        program = constraint_program(type(component))
        rows = _main_rows(component, main_cols) + [is_first]
        dev, n = _check_rows(rows, f"{component.name} logup")
        _require_cuda(dev, f"{component.name} logup")
        lib = self.lib.load()
        words = pack_constants(elements)
        host = pack_table([r.data_ptr() for r in rows], words)
        q = torch.empty((len(program.relations), 4, n), dtype=torch.int32, device=dev)
        total = torch.empty((4, n), dtype=torch.int32, device=dev)
        with torch.cuda.device(dev):
            table = self.staging.to_card(host, dev)
            rc = lib.constraints_logup(COMPONENT_IDS[component.name], table.data_ptr(),
                                       logup_slots(program), words.size, n, q.data_ptr(),
                                       total.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
        if rc != 0:
            raise RuntimeError(f"{component.name} logup kernel launch failed: CUDA error {rc}")
        self.launches["logup"] += 1
        return q, total

    def interaction(self, component, main_cols: Dict[str, torch.Tensor],
                    elements: Dict[str, LookupElements]
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """framework.component.build_interaction_trace_async in one launch:
        ((K, 4, N) int32 Q_k, (4, N) int32 S, (4,) int32 claimed sum), N =
        2^log_size the columns' length, S and the claimed sum in coset
        order."""
        cls = type(component)
        program = constraint_program(cls)
        rows = _main_rows(component, main_cols)
        dev, n = _check_rows(rows, f"{component.name} interaction")
        log_n = n.bit_length() - 1
        if n != 1 << component.log_size or not 2 <= log_n <= MAX_EVAL_LOG:
            raise ValueError(f"{component.name} interaction: {n} rows, expected 2^"
                             f"{component.log_size} (2^2 .. 2^{MAX_EVAL_LOG})")
        _require_cuda(dev, f"{component.name} interaction")
        lib = self.lib.load()
        _, _, _, tiles, _, on_chip, _ = self.geometry(cls, log_n, dev)
        words = pack_constants(elements)
        host = pack_table([r.data_ptr() for r in rows], words)
        q = torch.empty((len(program.relations), 4, n), dtype=torch.int32, device=dev)
        s = torch.empty((4, n), dtype=torch.int32, device=dev)
        claimed = torch.empty(4, dtype=torch.int32, device=dev)
        work = torch.empty(2 * tiles * SCAN_VEC, dtype=torch.int32, device=dev)
        sums = None if on_chip else torch.empty((4, n), dtype=torch.int32, device=dev)
        with torch.cuda.device(dev):
            table = self.staging.to_card(host, dev)
            rc = lib.constraints_interaction(
                COMPONENT_IDS[component.name], table.data_ptr(), interaction_slots(program),
                words.size, log_n, q.data_ptr(), s.data_ptr(), claimed.data_ptr(),
                work.data_ptr(), None if sums is None else sums.data_ptr(),
                torch.cuda.current_stream(dev).cuda_stream)
        if rc != 0:
            raise RuntimeError(f"{component.name} interaction kernel launch failed: "
                               f"CUDA error {rc}")
        self.launches["interaction"] += 1
        return q, s, claimed

    def scan(self, total: torch.Tensor, coset: bool = True,
             carry: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
        """framework.component.prefix_sum in one launch: ((4, n) int32 S,
        (4,) int32 its last linear value, the claimed sum), both on the
        card. coset: total in bit-reversed storage order (n = 2^k, k >= 2),
        S scattered back to it; else total in linear order, S = carry (4,)
        int32 or 0 + the inclusive sum."""
        if not isinstance(total, torch.Tensor) or total.dtype != torch.int32:
            raise TypeError(f"the scan takes an int32 tensor, got "
                            f"{getattr(total, 'dtype', type(total).__name__)}")
        if total.dim() != 2 or total.shape[0] != 4 or not total.is_contiguous():
            raise ValueError(f"the scan takes a contiguous (4, n) tensor, got {tuple(total.shape)}")
        n = int(total.shape[1])
        if coset and (n & (n - 1) or not 4 <= n <= 1 << MAX_EVAL_LOG):
            raise ValueError(f"the coset scan takes 2^2 .. 2^{MAX_EVAL_LOG} rows, not {n}")
        if not 1 <= n <= 1 << 31:
            raise ValueError(f"the scan takes 1 .. 2^31 rows, not {n}")
        if carry is not None and (coset or carry.dtype != torch.int32 or carry.shape != (4,)
                                  or carry.device != total.device
                                  or not carry.is_contiguous()):
            raise ValueError("the scan's carry is a contiguous (4,) int32 tensor on the rows' "
                             "device, in linear order only")
        dev = total.device
        _require_cuda(dev, "the scan's rows")
        lib = self.scan_lib.load()
        s = torch.empty_like(total)
        claimed = torch.empty(4, dtype=torch.int32, device=dev)
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            if coset:
                tiles = self.geometry("scan", n.bit_length() - 1, dev)[3]
                work = torch.empty(2 * tiles * SCAN_VEC, dtype=torch.int32, device=dev)
                rc = lib.logup_scan_coset(total.data_ptr(), s.data_ptr(), claimed.data_ptr(),
                                          work.data_ptr(), n.bit_length() - 1, stream)
            else:
                sizes = (ctypes.c_longlong * 2)()
                if lib.logup_scan_scratch(n, ctypes.addressof(sizes)) != 0:
                    raise ValueError(f"the scan refused {n} rows")
                head = torch.zeros(sizes[0], dtype=torch.int32, device=dev)
                work = torch.empty(sizes[1], dtype=torch.int32, device=dev)
                rc = lib.logup_scan_linear(total.data_ptr(), s.data_ptr(), claimed.data_ptr(),
                                           None if carry is None else carry.data_ptr(),
                                           head.data_ptr(), work.data_ptr(), n, stream)
        if rc != 0:
            raise RuntimeError(f"scan kernel launch failed: CUDA error {rc}")
        self.launches["scan"] += 1
        return s, claimed


KERNELS = ConstraintKernels()


# ---------------------------------------------------------------------------
# The kernels' work, for their bounds
# ---------------------------------------------------------------------------

def launch_work(component, family: str, rows: int, batch: int = BATCH_ROWS
                ) -> Tuple[int, int, int]:
    """(bytes, M31 products, M31 adds) of one launch over `rows` rows, the
    work the function needs: each input word read once and each output
    word written once (the scan: 16 bytes a row in, 16 out, and the
    claimed sum; interaction: the live main columns in, Q_k and S out, the
    claimed sum); the program's distinct ops
    (ops/constraint_codegen.op_work). logup and
    interaction invert as the kernels do: the norms of `batch` rows' K
    relations with one m31_inv (qm31::batch_inv: QM_INV less the chain, 20
    products a relation, and batch_inv_products(batch K) a batch), or with
    batch 0 each relation on its own (qm31::qm_inv, 62)."""
    if family == "scan":  # the sums in, S out, the claimed sum; n - 1 adds a coordinate
        return rows * 32 + 16, 0, 4 * (rows - 1)
    p = constraint_program(type(component))
    k = len(p.relations)
    if family in ("logup", "interaction"):
        if batch:
            products, adds = op_work(p, p.fractions, (QM_INV[0] - M31_INV, QM_INV[1]))
            products = rows * products + -(-rows // batch) * batch_inv_products(batch * k)
        else:
            products, adds = op_work(p, p.fractions)
            products *= rows
        live = p.live(p.fractions)
        if family == "logup":
            inputs = sum(1 for v in live if p.ops[v][0] in ("col", "is_first"))
            return (rows * 4 * (inputs + 4 * (k + 1)) + 4 * ELEMENT_WORDS, products,
                    rows * (adds + 4 * (k - 1)))
        inputs = sum(1 for v in live if p.ops[v][0] == "col")  # is_first is t == 0
        return (rows * 4 * (inputs + 4 * (k + 1)) + 4 * ELEMENT_WORDS + 16, products,
                rows * (adds + 4 * (k - 1)) + 4 * (rows - 1))
    raise ValueError(f"launch_work: no family {family!r} (composition: composition_work)")


def composition_work(segments: Sequence[Tuple[int, int, Sequence, bool]], log_blowup: int
                     ) -> Tuple[int, int, int]:
    """(bytes, M31 products, M31 adds) of one composition launch over
    `segments` ((log_size, rows, components, rotation) each), the work the
    function needs whatever computes it: each input word read once (a
    component's live main columns and interaction rows, S(p - g)'s rows
    when they are not S's rows read again at the rotation; the segment's
    is_first and rotation index once), each accumulator written once (16
    bytes a row); the programs' distinct ops (constraint_codegen.op_work),
    the weights (4 or 16 products a constraint), the components' sum and
    one product by V_n^-1 a row, and once a segment the 2^log_blowup values
    of V_n^-1 (a point, log_size - 1 doublings and an inversion each:
    core/poly.py vanishing_inverse_blocks)."""
    nbytes = products = adds = 0
    for n, rows, components, rotation in segments:
        words = 1 + int(rotation) + 4  # is_first, the rotation index, the accumulator
        row_products, row_adds = 4, 4 * (len(components) - 1)
        for component in components:
            p = constraint_program(type(component))
            live = p.live(p.constraints)
            words += sum(4 if p.ops[v][0] in ("inter", "s_prev") else 1
                         for v in live if p.ops[v][0] in ("col", "inter", "s_prev"))
            if rotation and ("inter", len(p.relations)) in (p.ops[v] for v in live):
                words -= 4  # S(p - g) is S's rows read again at the rotation: one input
            pr, ad = op_work(p, p.constraints)
            row_products += pr + sum(16 if p.qm[c] else 4 for c in p.constraints)
            row_adds += ad + 4 * (len(p.constraints) - 1)
            nbytes += 4 * (own_words(p) + composition_slots(p) * 2)
        blocks = 1 << log_blowup
        nbytes += rows * 4 * words + 4 * blocks
        products += rows * row_products + blocks * (4 + (n - 1) + 42)
        adds += rows * row_adds + blocks * (3 + 2 * (n - 1))
    return nbytes + 4 * ELEMENT_WORDS, products, adds
