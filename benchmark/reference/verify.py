"""The proof's own checks, worked out again on the host: the Fiat-Shamir
transcript, the LogUp sum, the composition identity at the OODS point, every
Merkle decommitment, the quotients at the queried positions, the FRI folds
and the proof of work.

A frozen copy of the verifier half of the port (air.verify_brainfuck and
what it calls in core/channel.py, core/merkle.py, core/fri.py,
core/quotients.py, core/pcs.py and core/poly.py), host code only. Two
departures: the security parameters are the configuration's, never the
proof's, and the preprocessed root is passed in (reference/commit.py works
it out from the ladder).
"""

from __future__ import annotations

import hashlib
import struct
from dataclasses import dataclass
from functools import lru_cache
from typing import Dict, List, Sequence, Tuple

import numpy as np

from . import field as F
from .air import LookupElements
from .defs import COMPONENT_CLASSES, ELEMENT_SIZES
from .field import M31_CIRCLE_LOG_ORDER, P_INT
from .tables import MIN_LOG_SIZE

N_TREES = 4
LOG_LAST_LAYER = 1
_INV2 = (P_INT + 1) // 2


class Rejected(Exception):
    """The proof fails one of its checks; the message says which."""


# ---------------------------------------------------------------------------
# Configuration and layout
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class PcsConfig:
    log_blowup: int
    n_queries: int
    pow_bits: int
    log_max_rows: int

    def words(self) -> List[int]:
        return [self.log_blowup, self.n_queries, self.pow_bits, self.log_max_rows]

    def to_json(self) -> dict:
        return {"log_blowup": self.log_blowup, "n_queries": self.n_queries,
                "pow_bits": self.pow_bits, "log_max_rows": self.log_max_rows}


@dataclass
class ColumnMeta:
    log_size: int
    shifts: Tuple[int, ...] = (0,)


def ladder_of(claim: Dict[str, int], config: PcsConfig) -> List[int]:
    top = config.log_max_rows or max(claim.values())
    return list(range(top, MIN_LOG_SIZE - 1, -1))


def layout(claim: Dict[str, int], config: PcsConfig):
    """(components, the four trees' column metas) of a claim."""
    comps = [cls(claim[cls.name]) for cls in COMPONENT_CLASSES]
    used = set(claim.values())
    tree0 = [ColumnMeta(lg, (0,) if lg in used else ()) for lg in ladder_of(claim, config)]
    tree1 = [ColumnMeta(c.log_size) for c in comps for _ in c.columns]
    tree2 = []
    for c in comps:
        tree2 += [ColumnMeta(c.log_size)] * (4 * c.relation_count())
        tree2 += [ColumnMeta(c.log_size, (0, 1))] * 4
    tree3 = [ColumnMeta(max(claim.values()) + config.log_blowup)] * 4
    return comps, [tree0, tree1, tree2, tree3]


def main_columns(tables: Dict[str, Dict[str, np.ndarray]], claim: Dict[str, int]):
    """The main tree's (log size, column) list in commitment order."""
    return [(claim[cls.name], tables[cls.name][col])
            for cls in COMPONENT_CLASSES for col in cls.columns]


# ---------------------------------------------------------------------------
# Channel
# ---------------------------------------------------------------------------

def _blake(data: bytes) -> bytes:
    return hashlib.blake2s(data).digest()


class Channel:
    def __init__(self):
        self.digest = bytes(32)
        self._counter = 0

    def mix_bytes(self, data: bytes) -> None:
        self.digest = _blake(self.digest + data)
        self._counter = 0

    def mix_root(self, root: bytes) -> None:
        if len(root) != 32:
            raise Rejected("a root is not 32 bytes")
        self.mix_bytes(root)

    def mix_u32s(self, values: Sequence[int]) -> None:
        self.mix_bytes(b"".join(struct.pack("<I", v & 0xFFFFFFFF) for v in values))

    def mix_u64(self, value: int) -> None:
        self.mix_bytes(struct.pack("<Q", value & 0xFFFFFFFFFFFFFFFF))

    def mix_felts(self, felts) -> None:
        self.mix_u32s([c for f in felts for c in f])

    def draw_words(self, n: int) -> List[int]:
        words: List[int] = []
        while len(words) < n:
            block = _blake(self.digest + struct.pack("<Q", self._counter))
            self._counter += 1
            words.extend(struct.unpack("<8I", block))
        return words[:n]

    def draw_felt(self) -> tuple:
        return tuple(v % P_INT for v in self.draw_words(4))

    def draw_queries(self, n_queries: int, log_domain_size: int) -> List[int]:
        mask = (1 << log_domain_size) - 1
        target = min(n_queries, 1 << log_domain_size)
        positions: set = set()
        while len(positions) < target:
            for w in self.draw_words(8):
                positions.add(w & mask)
                if len(positions) >= target:
                    break
        return sorted(positions)

    def pow_ok(self, pow_bits: int, nonce: int) -> bool:
        h = _blake(self.digest + struct.pack("<Q", nonce))
        return (struct.unpack("<I", h[:4])[0] & ((1 << pow_bits) - 1)) == 0


def draw_elements(ch: Channel) -> Dict[str, LookupElements]:
    return {k: LookupElements.draw(ch, ELEMENT_SIZES[k])
            for k in ("memory", "instruction", "processor")}


# ---------------------------------------------------------------------------
# Merkle decommitments
# ---------------------------------------------------------------------------

def _needed_positions(queries, max_log: int) -> Dict[int, List[int]]:
    if not isinstance(queries, dict):
        queries = {max_log: list(queries)}
    needed: Dict[int, List[int]] = {}
    below: set = set()
    for k in range(max_log, -1, -1):
        cur = set(queries.get(k, ())) | {p >> 1 for p in below}
        needed[k] = sorted(cur)
        below = cur
    return needed


def merkle_verify(root: bytes, column_counts: Dict[int, int], queries, column_values,
                  witness: List[bytes], max_log: int) -> None:
    needed = _needed_positions(queries, max_log)
    wit = iter(witness)
    prev: Dict[int, bytes] = {}
    for k in range(max_log, -1, -1):
        vals = column_values.get(k, [])
        if len(vals) != column_counts.get(k, 0) or any(len(v) != len(needed[k]) for v in vals):
            raise Rejected(f"bad column values at level {k}")
        if vals:
            arr = np.array(vals, dtype=np.uint64)
            if (arr >> 32).any():
                raise Rejected(f"column value out of range at level {k}")
            val_bytes = np.ascontiguousarray(arr.T.astype("<u4"))
        cur: Dict[int, bytes] = {}
        for pi, p in enumerate(needed[k]):
            msg = b""
            if k < max_log:
                for child in (2 * p, 2 * p + 1):
                    if child in prev:
                        msg += prev[child]
                    else:
                        nxt = next(wit, None)
                        if nxt is None:
                            raise Rejected("witness exhausted")
                        msg += nxt
            if vals:
                msg += val_bytes[pi].tobytes()
            cur[p] = _blake(msg)
        prev = cur
    if next(wit, None) is not None:
        raise Rejected("unused witness hashes")
    if prev.get(0) != root:
        raise Rejected("Merkle root mismatch")


def query_positions_by_level(queries, s_max: int, levels) -> Dict[int, List[int]]:
    return {s: sorted({((q >> (s_max - s)) & ~3) + j for q in queries for j in range(4)})
            for s in levels if s <= s_max}


# ---------------------------------------------------------------------------
# Points, quotients
# ---------------------------------------------------------------------------

def shifted_point(z, log_size: int, shift: int):
    if shift == 0:
        return z
    idx = (-shift * (1 << (M31_CIRCLE_LOG_ORDER - log_size))) % (1 << M31_CIRCLE_LOG_ORDER)
    return F.secure_point_add(z, F.secure_point_from_m31(F.point_at_index(idx)))


def vanishing_at_point(log_size: int, point) -> tuple:
    x = point[0]
    for _ in range(log_size - 1):
        x = F.h_sub(F.h_mul(x, F.h_add(x, x)), F.ONE)
    return x


def points_at_storage(log_size: int, positions) -> Tuple[np.ndarray, np.ndarray]:
    pos = np.asarray(positions, np.uint64)
    rev = np.zeros_like(pos)
    v = pos.copy()
    for _ in range(log_size):
        rev = (rev << np.uint64(1)) | (v & np.uint64(1))
        v >>= np.uint64(1)
    half = np.uint64(1 << (log_size - 1))
    hc = F.half_odds(log_size - 1)
    order = np.uint64(1 << M31_CIRCLE_LOG_ORDER)
    base = (np.uint64(hc.initial_index)
            + np.where(rev < half, rev, rev - half) * np.uint64(hc.step)) % order
    idx = np.where(rev < half, base, (order - base) % order)
    return F.points_at_indices(idx)


def _point_groups(claims, alpha):
    """Claims (per column: [(point, value, alpha index)]) grouped by point:
    [(A, B, dy, dx, vc), [(column, alpha^k)]] with A = sum a^k l0_k and
    B = sum a^k s_k of each claim's vanishing line through (z, f(z)) and
    its conjugate."""
    groups: dict = {}
    for ci, col in enumerate(claims):
        for point, value, aidx in col:
            key = (tuple(point[0]), tuple(point[1]))
            groups.setdefault(key, (point, []))[1].append((ci, value, aidx))
    n_pows = 1 + max((a for _, ms in groups.values() for _, _, a in ms), default=0)
    powers = [F.ONE]
    for _ in range(n_pows - 1):
        powers.append(F.h_mul(powers[-1], alpha))
    out = []
    for (zx, zy), members in groups.values():
        dy = F.h_sub(F.h_frobenius(zy), zy)
        dx = F.h_sub(F.h_frobenius(zx), zx)
        dy_inv = F.h_inv(dy)
        vc = F.h_sub(F.h_mul(zy, dx), F.h_mul(zx, dy))
        a_sum, b_sum, weights = F.ZERO, F.ZERO, []
        for ci, value, aidx in members:
            value = tuple(v % P_INT for v in value)
            s = F.h_mul(F.h_sub(F.h_frobenius(value), value), dy_inv)
            l0 = F.h_sub(value, F.h_mul(zy, s))
            w = powers[aidx]
            a_sum = F.h_add(a_sum, F.h_mul(w, l0))
            b_sum = F.h_add(b_sum, F.h_mul(w, s))
            weights.append((ci, w))
        out.append(((a_sum, b_sum, dy, dx, vc), weights))
    return out


def quotient_values(log_size: int, positions, column_values: np.ndarray, groups) -> dict:
    """The combined quotient sum_g (sum_k a^k f_k - A - B p.y) / V_g(p) at
    the storage positions: {position: QM31}."""
    positions = list(positions)
    n = len(positions)
    xs, ys = points_at_storage(log_size, positions)
    px = np.zeros((4, n), np.uint64)
    py = np.zeros((4, n), np.uint64)
    px[0] = xs
    py[0] = ys
    vals = np.asarray(column_values, np.uint64) % P_INT
    acc = np.zeros((4, n), np.uint64)
    for consts, members in groups:
        a_c, b_c, dy, dx, vc = (F.npq_const(c, n) for c in consts)
        aw = np.array([w for _ci, w in members], np.uint64)
        sel = vals[[ci for ci, _w in members]]
        wf = ((aw.T[:, :, None] * sel[None, :, :]) % P_INT).sum(axis=1) % P_INT
        num = F.npq_sub(wf, F.npq_add(a_c, F.npq_mul(b_c, py)))
        van = F.npq_add(F.npq_sub(F.npq_mul(dy, px), F.npq_mul(dx, py)), vc)
        acc = F.npq_add(acc, F.npq_mul(num, F.npq_inv(van)))
    return {p: tuple(int(acc[k, i]) for k in range(4)) for i, p in enumerate(positions)}


# ---------------------------------------------------------------------------
# FRI
# ---------------------------------------------------------------------------

def _bitrev(x: int, bits: int) -> int:
    r = 0
    for _ in range(bits):
        r = (r << 1) | (x & 1)
        x >>= 1
    return r


@lru_cache(maxsize=1 << 14)
def _circle_itw(log_size: int, t: int) -> int:
    y = F.half_odds(log_size - 1).at(_bitrev(t, log_size - 1))[1]
    return pow(2 * y % P_INT, P_INT - 2, P_INT)


@lru_cache(maxsize=1 << 14)
def _line_itw(line_log: int, t: int) -> int:
    x = F.half_odds(line_log).at(_bitrev(t, line_log - 1))[0]
    return pow(2 * x % P_INT, P_INT - 2, P_INT)


def fri_levels(max_log: int) -> List[int]:
    levels, m = [], max_log - 1
    while m > LOG_LAST_LAYER:
        levels.append(m)
        m -= 1
        if m > LOG_LAST_LAYER:
            m -= 1
    return levels


def fri_verify(fri: dict, beta0, betas, max_log: int, queries, input_values) -> None:
    """Walk every query's folds through the committed layers."""
    levels = fri_levels(max_log)
    roots = [bytes.fromhex(r) for r in fri["layer_roots"]]
    if not (len(levels) == len(roots) == len(fri["layer_decommitments"])
            == len(fri["layer_values"])):
        raise Rejected("bad FRI layer count")
    layer_pos, layer_arr = [], []
    for li, (root, dec, lvl) in enumerate(zip(roots, fri["layer_decommitments"], levels)):
        positions = sorted({((q >> (max_log - lvl)) & ~3) + j for q in queries for j in range(4)})
        if dec["column_values"]:
            raise Rejected(f"FRI layer {li}: unexpected column values")
        vals = {int(k): tuple(int(x) for x in v) for k, v in fri["layer_values"][li].items()}
        if sorted(vals) != positions:
            raise Rejected(f"FRI layer {li}: bad positions")
        if any(len(vals[p]) != 4 or not all(0 <= x < P_INT for x in vals[p]) for p in vals):
            raise Rejected(f"FRI layer {li}: non-canonical value")
        cols = [[vals[p][k] for p in positions] for k in range(4)]
        merkle_verify(root, {lvl: 4}, positions, {lvl: cols},
                      [bytes.fromhex(h) for h in dec["witness_hashes"]], lvl)
        layer_pos.append(np.array(positions, np.int64))
        layer_arr.append(np.array(cols, np.uint64))
    last = tuple(int(x) for x in fri["last_layer_value"])
    if len(last) != 4 or not all(0 <= v < P_INT for v in last):
        raise Rejected("non-canonical FRI last layer value")

    qs = np.asarray(list(queries), np.int64)
    nq = len(qs)
    beta0_b = F.npq_const(tuple(v % P_INT for v in beta0), nq)

    def batch_input(m, pos_arr):
        got = [input_values(m, int(p)) for p in pos_arr]
        if got[0] is None:
            return None
        return np.array([[v[k] % P_INT for v in got] for k in range(4)], np.uint64)

    def fold(a, b, beta, itw):
        s = ((a + b) % P_INT) * _INV2 % P_INT
        d = ((a + (P_INT - b)) % P_INT) * itw % P_INT
        return F.npq_add(s, F.npq_mul(beta, d))

    def circ_itw(m, t_arr):
        return np.array([_circle_itw(m, int(t)) for t in t_arr], np.uint64)

    def line_itw(m, t_arr):
        return np.array([_line_itw(m, int(t)) for t in t_arr], np.uint64)

    def inject(m, pos_arr, cur):
        if m + 1 == max_log:
            return cur
        a = batch_input(m + 1, 2 * pos_arr)
        if a is None:
            return cur
        b = batch_input(m + 1, 2 * pos_arr + 1)
        return F.npq_add(cur, fold(a, b, beta0_b, circ_itw(m + 1, pos_arr)))

    pos = qs & ~np.int64(1)
    cur = fold(batch_input(max_log, pos), batch_input(max_log, pos | 1), beta0_b,
               circ_itw(max_log, pos >> 1))
    m, pos, li = max_log - 1, pos >> 1, 0
    while m > LOG_LAST_LAYER:
        cur = inject(m, pos, cur)
        ps, va = layer_pos[li], layer_arr[li]
        idx = np.searchsorted(ps, pos)
        if np.any(idx >= len(ps)) or np.any(ps[np.minimum(idx, len(ps) - 1)] != pos):
            raise Rejected(f"FRI layer {li}: missing fold position")
        if (va[:, idx] != cur).any():
            raise Rejected(f"FRI fold mismatch at layer {li}")
        beta = F.npq_const(tuple(v % P_INT for v in betas[li]), nq)
        quad = pos & ~np.int64(3)
        iq = np.searchsorted(ps, quad)
        if np.any(iq + 3 >= len(ps)) or np.any(ps[iq] != quad) or np.any(ps[iq + 3] != quad + 3):
            raise Rejected(f"FRI layer {li}: missing quad values")
        a0, a1, a2, a3 = va[:, iq], va[:, iq + 1], va[:, iq + 2], va[:, iq + 3]
        t0 = quad >> 1
        u0 = fold(a0, a1, beta, line_itw(m, t0))
        u1 = fold(a2, a3, beta, line_itw(m, t0 + 1))
        p1 = pos >> 1
        if m - 1 == LOG_LAST_LAYER:
            cur = np.where(((p1 & 1) == 0)[None, :], u0, u1)
            pos, m, li = p1, m - 1, li + 1
            continue
        u0 = inject(m - 1, t0, u0)
        u1 = inject(m - 1, t0 + 1, u1)
        cur = fold(u0, u1, F.npq_mul(beta, beta), line_itw(m - 1, t0 >> 1))
        pos, m, li = pos >> 2, m - 2, li + 1
    cur = inject(m, pos, cur)
    if (cur != np.array(last, np.uint64)[:, None]).any():
        raise Rejected("FRI last layer mismatch")


# ---------------------------------------------------------------------------
# The whole proof
# ---------------------------------------------------------------------------

def _composition_identity(comps, trees, sampled, iclaim, elements, alpha, z, ladder) -> None:
    ladder_index = {lg: i for i, lg in enumerate(ladder)}
    alpha_idx, total, t1, t2 = 0, F.ZERO, 0, 0
    for comp in comps:
        main = {}
        for col in comp.columns:
            main[col] = sampled[1][t1][0]
            t1 += 1
        n_inter = comp.relation_count() + 1
        inter = [F.h_recombine([sampled[2][t2 + 4 * k + c][0] for c in range(4)])
                 for k in range(n_inter)]
        prev = F.h_recombine([sampled[2][t2 + 4 * (n_inter - 1) + c][1] for c in range(4)])
        t2 += 4 * n_inter
        isf = sampled[0][ladder_index[comp.log_size]][0]
        v_inv = F.h_inv(vanishing_at_point(comp.log_size, z))
        for c in comp.constraints_at(main, inter, prev, isf, iclaim[comp.name], elements):
            term = F.h_mul(F.h_pow(alpha, alpha_idx), F.h_mul(c, v_inv))
            total = F.h_add(total, term)
            alpha_idx += 1
    if F.h_recombine([sampled[3][c][0] for c in range(4)]) != total:
        raise Rejected("the composition identity fails at the OODS point")


def verify(proof: dict, config: PcsConfig, preprocessed_root: bytes) -> None:
    """Raise Rejected unless `proof` is a valid proof at `config`."""
    if proof.get("config") != config.to_json():
        raise Rejected(f"proof config {proof.get('config')} is not {config.to_json()}")
    claim = {k: int(v) for k, v in proof["claim"].items()}
    if set(claim) != {c.name for c in COMPONENT_CLASSES}:
        raise Rejected("bad claim components")
    iclaim = {k: tuple(int(x) % P_INT for x in v) for k, v in proof["interaction_claim"].items()}
    roots = [bytes.fromhex(r) for r in proof["commitments"]]
    sampled = [[[tuple(int(x) for x in v) for v in cvals] for cvals in tvals]
               for tvals in proof["sampled_values"]]
    decs = proof["decommitments"]
    nonce = int(proof["pow_nonce"])
    comps, trees = layout(claim, config)
    ladder = ladder_of(claim, config)
    if len(roots) != N_TREES or len(decs) != N_TREES or len(sampled) != N_TREES:
        raise Rejected("bad tree count")
    for tvals, metas in zip(sampled, trees):
        if len(tvals) != len(metas) or any(len(c) != len(m.shifts) for c, m in zip(tvals, metas)):
            raise Rejected("bad sampled value shape")
    if roots[0] != preprocessed_root:
        raise Rejected("preprocessed commitment mismatch")
    blow = config.log_blowup

    ch = Channel()
    ch.mix_u32s(config.words())
    ch.mix_root(roots[0])
    for cls in COMPONENT_CLASSES:
        ch.mix_u32s([claim[cls.name]])
    ch.mix_root(roots[1])
    elements = draw_elements(ch)
    total = F.ZERO
    for v in iclaim.values():
        total = F.h_add(total, v)
    if total != F.ZERO:
        raise Rejected("the LogUp claimed sums do not cancel")
    for cls in COMPONENT_CLASSES:
        ch.mix_felts([iclaim[cls.name]])
    ch.mix_root(roots[2])
    alpha_comp = ch.draw_felt()
    ch.mix_root(roots[3])
    z = F.point_from_t(ch.draw_felt())
    for tvals in sampled:
        for cvals in tvals:
            ch.mix_felts(cvals)
    _composition_identity(comps, trees, sampled, iclaim, elements, alpha_comp, z, ladder)

    alpha_q = ch.draw_felt()
    beta0 = ch.draw_felt()
    betas = []
    for root in proof["fri"]["layer_roots"]:
        ch.mix_root(bytes.fromhex(root))
        betas.append(ch.draw_felt())
    ch.mix_felts([tuple(int(x) for x in proof["fri"]["last_layer_value"])])
    if not ch.pow_ok(config.pow_bits, nonce):
        raise Rejected("invalid proof of work")
    ch.mix_u64(nonce)
    s_max = max(m.log_size + blow for metas in trees for m in metas if m.shifts)
    queries = ch.draw_queries(config.n_queries, s_max)

    by_size: Dict[int, list] = {}
    positions_by_size: Dict[int, List[int]] = {}
    aidx = 0
    for ti, (root, metas, tvals, dec) in enumerate(zip(roots, trees, sampled, decs)):
        counts: Dict[int, int] = {}
        for meta in metas:
            counts[meta.log_size + blow] = counts.get(meta.log_size + blow, 0) + 1
        levels = sorted(counts)
        pos = query_positions_by_level(queries, s_max, levels)
        values = {int(k): [[int(x) for x in col] for col in v]
                  for k, v in dec["column_values"].items()}
        try:
            merkle_verify(root, counts, pos, values,
                          [bytes.fromhex(h) for h in dec["witness_hashes"]], max(levels))
        except Rejected as exc:
            raise Rejected(f"tree {ti}: {exc}") from None
        seen: Dict[int, int] = {}
        for meta, cvals in zip(metas, tvals):
            lvl = meta.log_size + blow
            ci = seen.get(lvl, 0)
            seen[lvl] = ci + 1
            if not meta.shifts:
                continue
            col_claims = []
            for s, v in zip(meta.shifts, cvals):
                col_claims.append((shifted_point(z, meta.log_size, s), v, aidx))
                aidx += 1
            positions_by_size[lvl] = pos[lvl]
            by_size.setdefault(lvl, []).append((values[lvl][ci], col_claims))
    qvals = {size: quotient_values(size, positions_by_size[size],
                                   np.array([c[0] for c in cols], np.uint64),
                                   _point_groups([c[1] for c in cols], alpha_q))
             for size, cols in by_size.items()}

    def input_values(size, position):
        d = qvals.get(size)
        return None if d is None else d[position]

    fri_verify(proof["fri"], beta0, betas, s_max, queries, input_values)
