"""FRI over the circle: commit/fold on a device, per-query verification on host.

Counterpart of ``stwo_brainfuck_tpu/core/fri.py`` (host-channel form) —
stwo's FRI (internal to ``prover::prove``; entry at
crates/brainfuck_prover/src/brainfuck_air/mod.rs:732). Mixed-degree inputs
are supported the same way: the combined quotient of each commitment size is
"injected" (circle->line folded and added) when the running accumulator
reaches its size.

Folds (bit-reversed storage => pairs are adjacent positions 2t, 2t+1):
- circle->line (y-twiddle):  g = (a+b)/2 + beta * (a-b)/(2 y_t)
- line->line  (x-twiddles):  g = (a+b)/2 + beta * (a-b)/(2 x_t)

The same beta (circle_fold_alpha) is used for every circle->line injection;
each committed intermediate line layer draws a fresh beta from the channel
after its Merkle root is mixed. The last layer (line domain of size
2^LOG_LAST_LAYER) is sent in the clear as a single constant coefficient.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from functools import lru_cache
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from . import fft, m31, merkle, qm31
from .circle import half_odds
from .fft import bitrev_int
from .m31 import P_INT

LOG_LAST_LAYER = 1  # stop at a 2-point line domain; send 1 (constant) coeff

_INV2 = (P_INT + 1) // 2


@lru_cache(maxsize=64)
def _fold_itw(kind: str, log: int, device) -> torch.Tensor:
    """inv(2*y_t) of the circle domain of size 2^log (kind "c"), or
    inv(2*x_t) of the line domain of size 2^log (kind "l": the x-projection
    of the circle domain of size 2^(log+1)); int64 on `device`."""
    if kind == "c":
        t = fft.get_twiddles(log, False, str(device))[0]
    else:
        t = fft.get_twiddles(log + 1, False, str(device))[1]
    return m31.inv(2 * t % P_INT)


def _fold(values: torch.Tensor, itw: torch.Tensor, beta: tuple) -> torch.Tensor:
    """One fold of a QM31 evaluation (4, 2N) -> (4, N) int64:
    g = (a+b)/2 + beta * (a-b) * itw over adjacent pairs."""
    a = values[:, 0::2].to(torch.int64)
    b = values[:, 1::2].to(torch.int64)
    s = (a + b) % P_INT * _INV2 % P_INT
    d = (a - b) % P_INT * itw % P_INT
    return (s + qm31.mul(qm31.const(beta, values.device), d)) % P_INT


@dataclass
class FriProof:
    layer_roots: List[bytes]
    last_layer_value: tuple
    # filled during decommit:
    layer_decommitments: List[merkle.MerkleDecommitment] = field(default_factory=list)
    layer_values: List[Dict[int, tuple]] = field(default_factory=list)

    def to_json(self):
        return {
            "layer_roots": [r.hex() for r in self.layer_roots],
            "last_layer_value": list(self.last_layer_value),
            "layer_decommitments": [d.to_json() for d in self.layer_decommitments],
            "layer_values": [
                {str(k): list(v) for k, v in lv.items()} for lv in self.layer_values
            ],
        }

    @staticmethod
    def from_json(obj) -> "FriProof":
        return FriProof(
            layer_roots=[bytes.fromhex(r) for r in obj["layer_roots"]],
            last_layer_value=tuple(obj["last_layer_value"]),
            layer_decommitments=[
                merkle.MerkleDecommitment.from_json(d) for d in obj["layer_decommitments"]
            ],
            layer_values=[
                {int(k): tuple(v) for k, v in lv.items()} for lv in obj["layer_values"]
            ],
        )


@dataclass
class FriProver:
    """Holds the committed layers so queries can be decommitted later."""

    proof: FriProof
    layers: List[merkle.MerkleTree]          # committed line layers
    layer_evals: List[torch.Tensor]          # (4, N) device evaluations
    layer_levels: List[int]                  # line level of each layer
    max_log: int


def fri_commit(inputs: Dict[int, torch.Tensor], channel, ops=None) -> FriProver:
    """inputs: circle-domain size log -> combined quotient (4, 2^log).
    Performs all folds, committing each intermediate line layer and mixing
    roots/last value into the channel. Radix-4: each committed layer folds
    twice (beta, then beta^2); a circle-folded input is injected (added)
    when the running line evaluation reaches its size. With `ops` (the mesh
    backend, parallel/prove.ShardedOps) the folds and layer commits run
    sharded, both folds of a layer in one step where no input is injected
    between them."""
    logs = sorted(inputs, reverse=True)
    if not logs:
        raise ValueError("no FRI inputs")
    max_log = logs[0]
    dev = inputs[max_log].device if ops is None else ops.mesh.devices[0]
    fold = _fold if ops is None else ops.fold

    beta0 = channel.draw_felt()  # circle fold coefficient for all injections
    cur = fold(inputs[max_log], _fold_itw("c", max_log, dev), beta0)
    m = max_log - 1
    layers: List[merkle.MerkleTree] = []
    layer_evals: List[torch.Tensor] = []
    layer_levels: List[int] = []
    roots: List[bytes] = []

    def inject(cur, m):
        if m + 1 in inputs and m + 1 != max_log:
            itw = _fold_itw("c", m + 1, dev)
            if ops is not None:
                return ops.fold_add(inputs[m + 1], itw, beta0, cur)
            return (cur + _fold(inputs[m + 1], itw, beta0)) % P_INT
        return cur

    while m > LOG_LAST_LAYER:
        cur = inject(cur, m)
        if ops is None:
            cur = cur.to(torch.int32)
        tree = merkle.commit({m: cur}) if ops is None else ops.commit({m: cur})
        layers.append(tree)
        layer_evals.append(cur)
        layer_levels.append(m)
        roots.append(tree.root)
        channel.mix_root(tree.root)
        beta = channel.draw_felt()
        beta2 = qm31.h_mul(beta, beta)
        if ops is not None and m - 1 > LOG_LAST_LAYER and m not in inputs:
            cur = ops.fold2(cur, _fold_itw("l", m, dev), _fold_itw("l", m - 1, dev), beta, beta2)
            m -= 2
            continue
        cur = fold(cur, _fold_itw("l", m, dev), beta)
        m -= 1
        if m > LOG_LAST_LAYER:
            cur = inject(cur, m)
            cur = fold(cur, _fold_itw("l", m, dev), beta2)
            m -= 1

    cur = inject(cur, m)
    if ops is not None:
        cur = ops.mesh.full(cur)
    last = tuple(int(x) for x in cur[:, 0].cpu())
    channel.mix_felts([last])

    proof = FriProof(layer_roots=roots, last_layer_value=last)
    return FriProver(
        proof=proof, layers=layers, layer_evals=layer_evals,
        layer_levels=layer_levels, max_log=max_log,
    )


def fri_decommit(prover: FriProver, queries: Sequence[int]) -> None:
    """Decommit each layer at the query fold quads, filling
    proof.layer_decommitments (witness hashes only: the values travel once,
    in proof.layer_values)."""
    for tree, evals, m in zip(prover.layers, prover.layer_evals, prover.layer_levels):
        positions = sorted({((q >> (prover.max_log - m)) & ~3) + j
                            for q in queries for j in range(4)})
        prover.proof.layer_decommitments.append(
            merkle.decommit(tree, positions, include_values=False))
        got = merkle.gather_columns(evals, positions)
        prover.proof.layer_values.append(
            {p: tuple(int(x) for x in got[:, i]) for i, p in enumerate(positions)})


class FriVerificationError(Exception):
    pass


def fri_verify_queries(
    proof: FriProof,
    channel_betas: Tuple[tuple, List[tuple]],
    max_log: int,
    queries: Sequence[int],
    input_values_fn,
) -> None:
    """Walk the folds for each query and check consistency.

    channel_betas: (beta0, [per-layer betas]) re-drawn by the caller in
    transcript order. input_values_fn(log, position) -> QM31 value of the
    combined quotient of circle-size `log` at `position` (computed by the
    caller from decommitted trace values).
    """
    beta0, betas = channel_betas

    # reconstruct the committed layer levels (mirror of fri_commit)
    levels: List[int] = []
    m = max_log - 1
    while m > LOG_LAST_LAYER:
        levels.append(m)
        m -= 1
        if m > LOG_LAST_LAYER:
            m -= 1
    if len(levels) != len(proof.layer_roots):
        raise FriVerificationError("bad layer count")

    # verify layer merkle decommitments and collect values
    layer_vals: List[Dict[int, tuple]] = []
    for li, (root, dec, lvl) in enumerate(
        zip(proof.layer_roots, proof.layer_decommitments, levels)
    ):
        positions = sorted({((q >> (max_log - lvl)) & ~3) + j
                            for q in queries for j in range(4)})
        if dec.column_values:
            # values must travel exactly once (layer_values); a second,
            # unchecked copy would be proof malleability
            raise FriVerificationError(f"layer {li}: unexpected column values")
        vals = proof.layer_values[li]
        if sorted(vals) != positions:
            raise FriVerificationError(f"layer {li}: bad positions")
        cols = [[vals[p][k] for p in positions] for k in range(4)]
        dec_check = merkle.MerkleDecommitment(
            column_values={lvl: cols}, witness_hashes=dec.witness_hashes
        )
        try:
            merkle.verify(root, {lvl: 4}, positions, dec_check, max_log=lvl)
        except merkle.MerkleVerificationError as exc:
            raise FriVerificationError(f"layer {li} merkle: {exc}")
        layer_vals.append(vals)

    # Batched walk: every query's fold chain follows the SAME layer sequence
    # (the per-query control flow depends only on max_log), so the whole walk
    # runs as (4, n_queries) numpy QM31 arrays. Inputs are reduced mod p up
    # front.
    qs = np.asarray(list(queries), np.int64)
    nq = len(qs)
    if nq == 0:
        return
    beta0_b = qm31.npq_const(tuple(v % P_INT for v in beta0), nq)

    # Proof-supplied values must be CANONICAL (< p): reducing a
    # non-canonical alias (v + p) on load would silently accept a second
    # encoding of the same proof (malleability). Validate instead of reduce.
    layer_pos: List[np.ndarray] = []
    layer_arr: List[np.ndarray] = []
    for li, vals in enumerate(layer_vals):
        ps = np.array(sorted(vals), np.int64)
        if any(not (0 <= v < P_INT) for p in vals for v in vals[p]):
            raise FriVerificationError(f"layer {li}: non-canonical value")
        layer_pos.append(ps)
        layer_arr.append(np.array(
            [[vals[int(p)][k] for p in ps] for k in range(4)], np.uint64))
    if any(not (0 <= v < P_INT) for v in proof.last_layer_value):
        raise FriVerificationError("non-canonical last layer value")

    def batch_input(m, pos_arr):
        """(4, nq) combined-quotient values of circle-size m, or None
        (each position fetched once)."""
        first = input_values_fn(m, int(pos_arr[0]))
        if first is None:
            return None
        vals = [first] + [input_values_fn(m, int(p)) for p in pos_arr[1:]]
        return np.array([[v[k] % P_INT for v in vals] for k in range(4)], np.uint64)

    def circ_itw(m, t_arr):
        return np.array([_circle_itw_host(m, int(t)) for t in t_arr],
                        np.uint64)

    def line_itw(m, t_arr):
        return np.array([_line_itw_host(m, int(t)) for t in t_arr],
                        np.uint64)

    def np_fold(a, b, beta, itw_arr):
        s = ((a + b) % P_INT) * _INV2 % P_INT
        d = ((a + (P_INT - b)) % P_INT) * itw_arr % P_INT
        return qm31.npq_add(s, qm31.npq_mul(beta, d))

    def inject(m, pos_arr, cur):
        """Add the circle-size m+1 injections at line positions, if any."""
        if m + 1 == max_log:
            return cur
        a = batch_input(m + 1, 2 * pos_arr)
        if a is None:
            return cur
        b = batch_input(m + 1, 2 * pos_arr + 1)
        return qm31.npq_add(cur, np_fold(a, b, beta0_b,
                                         circ_itw(m + 1, pos_arr)))

    pos = qs & ~np.int64(1)
    a = batch_input(max_log, pos)
    b = batch_input(max_log, pos | 1)
    cur = np_fold(a, b, beta0_b, circ_itw(max_log, pos >> 1))
    m = max_log - 1
    pos = pos >> 1
    li = 0
    while m > LOG_LAST_LAYER:
        cur = inject(m, pos, cur)
        ps, va = layer_pos[li], layer_arr[li]
        idx = np.searchsorted(ps, pos)
        if np.any(idx >= len(ps)) or np.any(ps[np.minimum(idx, len(ps) - 1)]
                                            != pos):
            raise FriVerificationError(f"layer {li}: missing fold position")
        mism = (va[:, idx] != cur).any(axis=0)
        if mism.any():
            bad = int(pos[int(np.nonzero(mism)[0][0])])
            raise FriVerificationError(f"fold mismatch at layer {li} pos {bad}")
        beta = qm31.npq_const(tuple(v % P_INT for v in betas[li]), nq)
        quad = pos & ~np.int64(3)
        iq = np.searchsorted(ps, quad)
        if np.any(iq + 3 >= len(ps)) or np.any(ps[iq] != quad) \
                or np.any(ps[iq + 3] != quad + 3):
            raise FriVerificationError(f"layer {li}: missing quad values")
        a0, a1, a2, a3 = va[:, iq], va[:, iq + 1], va[:, iq + 2], va[:, iq + 3]
        t0 = quad >> 1
        u0 = np_fold(a0, a1, beta, line_itw(m, t0))
        u1 = np_fold(a2, a3, beta, line_itw(m, t0 + 1))
        p1 = pos >> 1
        if m - 1 == LOG_LAST_LAYER:
            # single-fold tail
            cur = np.where(((p1 & 1) == 0)[None, :], u0, u1)
            pos = p1
            m -= 1
            li += 1
            continue
        # mid injection at level m-1 on both half values
        u0 = inject(m - 1, t0, u0)
        u1 = inject(m - 1, t0 + 1, u1)
        beta2 = qm31.npq_mul(beta, beta)
        cur = np_fold(u0, u1, beta2, line_itw(m - 1, t0 >> 1))
        pos = pos >> 2
        m -= 2
        li += 1
    cur = inject(m, pos, cur)
    llv = np.array(list(proof.last_layer_value), np.uint64)[:, None]
    mism = (cur != llv).any(axis=0)
    if mism.any():
        bad = int(qs[int(np.nonzero(mism)[0][0])])
        raise FriVerificationError(f"last layer mismatch at query {bad}")


@lru_cache(maxsize=1 << 14)
def _circle_itw_host(log_size: int, t: int) -> int:
    """inv(2*y_t) for ONE fold pair (verifier): y_t = fwd[0][t] is the y of
    the half-coset point at bit-reversed block t — computed point-wise, so a
    verify-only process never builds the full twiddle stacks."""
    y = half_odds(log_size - 1).at(bitrev_int(t, log_size - 1))[1]
    return pow(2 * y % P_INT, P_INT - 2, P_INT)


@lru_cache(maxsize=1 << 14)
def _line_itw_host(line_log: int, t: int) -> int:
    """inv(2*x_t) for ONE line-fold pair (verifier): x_t = fwd[1][t] of the
    size-2^(line_log+1) twiddles = x of the half-coset point at bit-reversed
    block t."""
    x = half_odds(line_log).at(bitrev_int(t, line_log - 1))[0]
    return pow(2 * x % P_INT, P_INT - 2, P_INT)
