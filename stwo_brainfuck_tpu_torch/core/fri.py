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

from .. import tracing
from . import fft, m31, merkle, qm31
from .circle import half_odds
from .fft import bitrev_int
from .m31 import P_INT

LOG_LAST_LAYER = 1  # stop at a 2-point line domain; send 1 (constant) coeff

_INV2 = (P_INT + 1) // 2


# Plain fold calls (_fold) on CUDA tensors: the fold kernel is the only
# path there.
PLAIN_CUDA_CALLS = 0


@lru_cache(maxsize=64)
def _fold_itw(kind: str, log: int, device) -> torch.Tensor:
    """inv(2*y_t) of the circle domain of size 2^log (kind "c"), or
    inv(2*x_t) of the line domain of size 2^log (kind "l": the x-projection
    of the circle domain of size 2^(log+1)); int32 on `device`. The plain
    folds' twiddles (the kernel inverts the FFT's, fold_twiddles)."""
    if kind == "c":
        t = fft.get_twiddles(log, False, str(device))[0]
    else:
        t = fft.get_twiddles(log + 1, False, str(device))[1]
    return m31.inv(2 * t % P_INT).to(torch.int32)


def fold_twiddles(kind: str, log: int, top: int, device) -> Tuple[torch.Tensor, int]:
    """Where the fold kernel reads the doubled twiddles 2 y_t (kind "c",
    the circle domain of size 2^log) or 2 x_t (kind "l", the line domain of
    size 2^log): (the FFT's int32 table, ops/circle_fft.twiddle_table, the
    index of pair 0 in it). A circle fold's are stage 0 of the table of its
    size; every line level's are a stage of the table of size 2^top (top >
    log): the line domain of size 2^log is the x-projection of the circle
    domain of size 2^(log + 1), whose x twiddles are stage top - log of the
    size-2^top table, at 2^top - 2^log."""
    from ..ops import circle_fft

    if kind == "c":
        return circle_fft.twiddle_table(log, False, str(device)), 0
    if not 0 < log < top:
        raise ValueError(f"line level {log} has no stage in the table of 2^{top}")
    return circle_fft.twiddle_table(top, False, str(device)), (1 << top) - (1 << log)


# A fold's int64 temporaries are (4, chunk): a fold of more output
# positions runs in chunks of _FOLD_CHUNK (1 GiB a temporary) into one
# output (the first fold of a production prove folds 2^28 positions).
_FOLD_CHUNK = 1 << 25


def _fold(values: torch.Tensor, itw: torch.Tensor, beta: tuple) -> torch.Tensor:
    """One fold of a QM31 evaluation (4, 2N) -> (4, N) int64:
    g = (a+b)/2 + beta * (a-b) * itw over adjacent pairs. The plain version
    of the fold kernel (fold_step)."""
    global PLAIN_CUDA_CALLS
    PLAIN_CUDA_CALLS += values.is_cuda
    n = values.shape[1] // 2
    if n <= _FOLD_CHUNK:
        return _fold_chunk(values, itw, beta)
    out = torch.empty((4, n), dtype=torch.int64, device=values.device)
    for s in range(0, n, _FOLD_CHUNK):
        e = min(s + _FOLD_CHUNK, n)
        out[:, s:e] = _fold_chunk(values[:, 2 * s:2 * e], itw[s:e], beta)
    return out


def _fold_chunk(values: torch.Tensor, itw: torch.Tensor, beta: tuple) -> torch.Tensor:
    a = values[:, 0::2].to(torch.int64)
    b = values[:, 1::2].to(torch.int64)
    s = (a + b) % P_INT * _INV2 % P_INT
    d = (a - b) % P_INT * itw % P_INT
    return (s + qm31.mul(qm31.const(beta, values.device), d)) % P_INT


@dataclass(frozen=True)
class FoldStep:
    """What fri_commit does between two committed layers, in one fold
    launch: from `values` of 2^level positions (the circle input of size
    2^level if `circle`, else a line layer), `folds` folds (0, 1 or 2: by
    beta, then beta2), the circle-folded input of size 2^level added after
    the first of two folds (inject_a: inputs[level], folded by beta0 to
    line level level - 1), and the circle-folded input of size 2^(out + 1)
    added at the output level out = level - folds (inject_b). Line twiddles
    are read from the FFT table of size 2^top (fold_twiddles)."""
    level: int
    folds: int
    circle: bool
    beta: tuple
    beta2: tuple
    beta0: tuple
    top: int

    @property
    def out_level(self) -> int:
        return self.level - self.folds

    def twiddles(self, inject_a: bool, inject_b: bool) -> list:
        """(use, kind, log) of each twiddle the step reads, for output
        position t: "fold1" (pair 2t + k with two folds, t with one),
        "inject_a" (2t + k), "fold2" (t), "inject_b" (t)."""
        uses = []
        if self.folds:
            uses.append(("fold1", "c" if self.circle else "l", self.level))
        if self.folds == 2 and inject_a:
            uses.append(("inject_a", "c", self.level))
        if self.folds == 2:
            uses.append(("fold2", "l", self.level - 1))
        if inject_b:
            uses.append(("inject_b", "c", self.out_level + 1))
        return uses


def fold_step_plain(values: torch.Tensor, step: FoldStep, inject_a=None, inject_b=None,
                    offset: int = 0) -> torch.Tensor:
    """The plain version of one fold launch (int64 torch ops, _fold):
    (4, n) int32 at output positions offset .. offset + n - 1 of the level
    step.out_level, from that chunk's values and injected inputs."""
    dev = values.device
    n = values.shape[1] >> step.folds
    itw = {use: _fold_itw(kind, log, dev)
           for use, kind, log in step.twiddles(inject_a is not None, inject_b is not None)}
    width = 2 if step.folds == 2 else 1
    cur = values
    if step.folds:
        cur = _fold(cur, itw["fold1"][width * offset:width * (offset + n)], step.beta)
    if step.folds == 2:
        if inject_a is not None:
            cur = (cur + _fold(inject_a, itw["inject_a"][2 * offset:2 * (offset + n)],
                               step.beta0)) % P_INT
        cur = _fold(cur, itw["fold2"][offset:offset + n], step.beta2)
    if inject_b is not None:
        cur = (cur + _fold(inject_b, itw["inject_b"][offset:offset + n], step.beta0)) % P_INT
    return cur.to(torch.int32)


def fold_step(values: torch.Tensor, step: FoldStep, inject_a=None, inject_b=None,
              offset: int = 0) -> torch.Tensor:
    """One fold launch on CUDA tensors (ops/fri_kernels.py), its plain
    version on CPU tensors: (4, n) int32 at output positions offset ..
    offset + n - 1 of step.out_level (n = the values' positions /
    2^folds; `offset` is a mesh shard's chunk)."""
    if values.is_cuda:
        from ..ops import fri_kernels

        return fri_kernels.KERNEL.fold(values, step, inject_a, inject_b, offset)
    return fold_step_plain(values, step, inject_a, inject_b, offset)


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
    """inputs: circle-domain size log -> combined quotient (4, 2^log); the
    call takes the dict over and removes its largest entry.
    Performs all folds, committing each intermediate line layer and mixing
    roots/last value into the channel. Radix-4: each committed layer folds
    twice (beta, then beta^2); a circle-folded input is injected (added)
    when the running line evaluation reaches its size. From one committed
    layer to the next is one FoldStep (fold_step: one kernel launch on a
    card, int32 in and out), both folds and the injections between and
    after them included; so are the first circle fold and the last fold to
    LOG_LAST_LAYER. With `ops` (the mesh backend, parallel/prove.ShardedOps)
    the steps and layer commits run sharded. The largest input leaves the
    dict once the first step has read it, so it is freed before the first
    layer's tree is built (at production it sets the prove's peak)."""
    logs = sorted(inputs, reverse=True)
    if not logs:
        raise ValueError("no FRI inputs")
    max_log = logs[0]
    step_fn = fold_step if ops is None else ops.fold_step

    def injected(level):
        """The input circle-folded and added at line level `level`."""
        return inputs.get(level + 1) if level + 1 != max_log else None

    beta0 = channel.draw_felt()  # circle fold coefficient for all injections
    with tracing.span("fri.fold"):
        cur = step_fn(inputs[max_log], FoldStep(max_log, 1, True, beta0, beta0, beta0, max_log),
                      None, injected(max_log - 1))
    del inputs[max_log]
    m = max_log - 1
    layers: List[merkle.MerkleTree] = []
    layer_evals: List[torch.Tensor] = []
    layer_levels: List[int] = []
    roots: List[bytes] = []

    while m > LOG_LAST_LAYER:
        tree = merkle.commit({m: cur}) if ops is None else ops.commit({m: cur})
        layers.append(tree)
        layer_evals.append(cur)
        layer_levels.append(m)
        roots.append(tree.root)
        channel.mix_root(tree.root)
        beta = channel.draw_felt()
        folds = 2 if m - 1 > LOG_LAST_LAYER else 1
        step = FoldStep(m, folds, False, beta, qm31.h_mul(beta, beta), beta0, max_log)
        with tracing.span("fri.fold"):
            cur = step_fn(cur, step, inputs.get(m) if folds == 2 else None, injected(m - folds))
        m -= folds

    if ops is not None:
        cur = ops.mesh.full(cur)
    last = tuple(int(x) for x in tracing.pull("fri_last", cur[:, 0]))
    channel.mix_felts([last])

    proof = FriProof(layer_roots=roots, last_layer_value=last)
    return FriProver(
        proof=proof, layers=layers, layer_evals=layer_evals,
        layer_levels=layer_levels, max_log=max_log,
    )


def fri_decommit_async(prover: FriProver, queries: Sequence[int]):
    """Every layer's decommitment gathers at the query fold quads (witness
    hashes only: the values travel once, in proof.layer_values) and its
    value gather, recorded and not served. Returns (each layer's
    positions, the layers' pending decommitments, the value gathers); the
    caller serves them with other gathers (merkle.finalize_with_extra)
    and passes the results to fri_decommit_finish."""
    positions_list, pendings, values = [], [], []
    for tree, evals, m in zip(prover.layers, prover.layer_evals, prover.layer_levels):
        positions = sorted({((q >> (prover.max_log - m)) & ~3) + j
                            for q in queries for j in range(4)})
        pendings.append(merkle.decommit_async(tree, positions, include_values=False))
        values.append(merkle.Gather(evals, positions))
        positions_list.append(positions)
    return positions_list, pendings, values


def fri_decommit_finish(prover: FriProver, positions_list, decs, values_host) -> None:
    """Fill proof.layer_decommitments and layer_values from the served
    decommitments and value gathers ((4, n) host arrays)."""
    for positions, dec, got in zip(positions_list, decs, values_host):
        prover.proof.layer_decommitments.append(dec)
        prover.proof.layer_values.append(dict(zip(positions, map(tuple, got.T.tolist()))))


def fri_decommit(prover: FriProver, queries: Sequence[int]) -> None:
    """Decommit each layer at the query fold quads, filling
    proof.layer_decommitments and layer_values (one pass, one pull)."""
    positions_list, pendings, values = fri_decommit_async(prover, queries)
    decs, values_host = merkle.finalize_with_extra(pendings, values)
    fri_decommit_finish(prover, positions_list, decs, values_host)


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
