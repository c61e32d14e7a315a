"""Proof orchestration: prove_brainfuck / verify_brainfuck.

Counterpart of ``stwo_brainfuck_tpu/air.py`` on its host-channel path (the
path its mesh prover takes; proof bytes are the same as its single-chip
path): the 4-phase pipeline (preprocessed / main / interaction commitments,
then composition, OODS sampling, quotients, FRI, PoW, query decommitment)
and its mirror verifier. As on the JAX package's single-device path, the
tables are built on `device` from the uploaded trace
(``components/device_build.py``); the transcript runs on the host; every
bulk array lives on `device`.
"""

from __future__ import annotations

import logging
import time
from dataclasses import dataclass
from functools import lru_cache
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .components import device_build
from .components.defs import COMPONENT_CLASSES, ELEMENT_SIZES
from .components.tables import MIN_LOG_SIZE
from .core import fft, fri, merkle, poly, qm31, quotients
from .core.channel import Blake2sChannel
from .core.circle import point_from_t
from .core.m31 import P_INT
from .core.pcs import (
    ColumnRecord,
    PcsConfig,
    TreeProver,
    query_positions_by_level,
    row,
    shifted_point,
)
from .framework.component import (
    LookupElements,
    build_interaction_trace_async,
    composition_accumulate,
    evaluate_constraints_at_point,
)

log = logging.getLogger("stwo_brainfuck_tpu_torch")

N_TREES = 4  # preprocessed, main, interaction, composition

# Capacity bound: components above 2^24 rows are refused (the reference's
# LOG_MAX_ROWS).
LOG_MAX_ROWS_CAP = 24

# Key order of the proof's "claim" object: the JAX package's single-device
# prover emits it in this order (its device table builder's), so the port
# follows it for byte-identical proof JSON.
CLAIM_ORDER = ("memory", "instruction", "program", "processor", "end_of_execution",
               "jump_if_not_zero", "jump_if_zero", "plus_instruction",
               "minus_instruction", "left_instruction", "right_instruction",
               "input_instruction", "output_instruction")


class ProvingError(Exception):
    pass


class VerificationError(Exception):
    pass


# The phases prove_brainfuck marks, in order: a phase's time runs from the
# mark before it to its own.
PHASES = ("trace", "tables", "tree0", "tree1", "interaction", "tree2", "composition", "tree3",
          "oods", "quotients", "fri", "pow", "decommit")


class PhaseTimer:
    """Wall time per prover phase. On a CUDA device each mark synchronizes
    first, so a phase's time includes its device work (only when a timer is
    passed: an untimed prove never synchronizes for it)."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.seconds: Dict[str, float] = {}
        self._t = time.perf_counter()

    def mark(self, name: str) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        now = time.perf_counter()
        self.seconds[name] = self.seconds.get(name, 0.0) + now - self._t
        self._t = now

    def current(self) -> str:
        """The phase running now: the first of PHASES not marked yet."""
        return next((p for p in PHASES if p not in self.seconds), "done")


def canonical_device(device) -> torch.device:
    """`device` as a torch.device that names a card by its index ("cuda"
    is the current card, cuda:{torch.cuda.current_device()}), so that one
    card is one key of the device caches. Raises if a card is asked for and
    there is none."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"{device}: no CUDA device is available")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


@lru_cache(maxsize=4)
def _preprocessed_tree(ladder: tuple, log_blowup: int, device: str) -> TreeProver:
    """The is_first ladder commitment: a pure function of (ladder, blowup),
    built from the closed form of the Lagrange kernel at the first domain
    point (no CFFT) and cached in process."""
    cfg = PcsConfig(log_blowup=log_blowup)
    records = [
        ColumnRecord(lg, fft.is_first_coeffs(lg, device),
                     fft.is_first_extended(lg, lg + log_blowup, device))
        for lg in ladder
    ]
    return TreeProver.from_records(records, cfg)


def clear_caches() -> None:
    """Drop every device tensor the provers keep between proves (twiddle
    tables, domain points, fold twiddles, the ladder tree, the mesh's
    permutations, the composition's rotation indices), so that the next
    prove builds its own and the caching allocator can hand their memory
    back (torch.cuda.empty_cache)."""
    from .ops import circle_fft, quotient_kernels
    from .parallel import prove as sharded_prove

    for cached in (fft.get_twiddles, circle_fft.twiddle_table, circle_fft.shard_twiddle_table,
                   sharded_prove._permutation, _preprocessed_tree, fri._fold_itw,
                   quotients.domain_points_storage, quotient_kernels.point_tables,
                   fft.rotation_index):
        cached.cache_clear()


@lru_cache(maxsize=16)
def _preprocessed_root(ladder: tuple, log_blowup: int, device: str) -> bytes:
    """The verifier's expected preprocessed root, recomputed in process
    (never taken from the proof)."""
    return _preprocessed_tree(ladder, log_blowup, device).root


# ---------------------------------------------------------------------------
# Shared layout: column structure of each tree, derived from the claim
# ---------------------------------------------------------------------------

@dataclass
class ColumnMeta:
    name: str           # "<component>/<column>" or "is_first/<log>" etc.
    log_size: int       # trace-domain log
    shifts: Tuple[int, ...] = (0,)  # sample points: z - shift * g_{log_size}


@dataclass
class SystemLayout:
    config: PcsConfig
    claim: Dict[str, int]
    ladder: List[int]
    trees: List[List[ColumnMeta]]      # per tree, ordered columns
    components: list                    # instantiated Component objects

    @property
    def composition_log(self) -> int:
        return max(self.claim.values()) + self.config.log_blowup


def build_layout(claim: Dict[str, int], config: PcsConfig) -> SystemLayout:
    comps = [cls(claim[cls.name]) for cls in COMPONENT_CLASSES]
    max_log = max(claim.values())
    top = config.log_max_rows if config.log_max_rows else max_log
    if max_log > LOG_MAX_ROWS_CAP:
        big = {n: lg for n, lg in claim.items() if lg > LOG_MAX_ROWS_CAP}
        raise ProvingError(
            f"program exceeds the 2^{LOG_MAX_ROWS_CAP} rows/component capacity "
            f"(reference LOG_MAX_ROWS): {big}")
    if top < max_log:
        raise ProvingError(f"log_max_rows {top} < max component log {max_log}")
    ladder = list(range(top, MIN_LOG_SIZE - 1, -1))

    # Only the component-size is_first columns are opened; the rest of the
    # ladder stays committed (program-independent root) unopened.
    used_sizes = set(claim.values())
    tree0 = [ColumnMeta(f"is_first/{lg}", lg, shifts=((0,) if lg in used_sizes else ()))
             for lg in ladder]
    tree1 = [ColumnMeta(f"{comp.name}/{col}", comp.log_size)
             for comp in comps for col in comp.columns]
    tree2: List[ColumnMeta] = []
    for comp in comps:
        for k in range(comp.relation_count()):
            for c in range(4):
                tree2.append(ColumnMeta(f"{comp.name}/q{k}.{c}", comp.log_size))
        for c in range(4):
            tree2.append(ColumnMeta(f"{comp.name}/s.{c}", comp.log_size, shifts=(0, 1)))
    comp_log = max_log + config.log_blowup
    tree3 = [ColumnMeta(f"composition/{c}", comp_log) for c in range(4)]
    return SystemLayout(config, claim, ladder, [tree0, tree1, tree2, tree3], comps)


def draw_elements(channel: Blake2sChannel) -> Dict[str, LookupElements]:
    return {
        "memory": LookupElements.draw(channel, ELEMENT_SIZES["memory"]),
        "instruction": LookupElements.draw(channel, ELEMENT_SIZES["instruction"]),
        "processor": LookupElements.draw(channel, ELEMENT_SIZES["processor"]),
    }


def mix_claim(channel: Blake2sChannel, claim: Dict[str, int]) -> None:
    for cls in COMPONENT_CLASSES:
        channel.mix_u32s([claim[cls.name]])


def mix_interaction_claim(channel: Blake2sChannel, iclaim: Dict[str, tuple]) -> None:
    for cls in COMPONENT_CLASSES:
        channel.mix_felts([iclaim[cls.name]])


def lookup_sum_valid(iclaim: Dict[str, tuple]) -> bool:
    total = qm31.ZERO
    for v in iclaim.values():
        total = qm31.h_add(total, tuple(v))
    return total == qm31.ZERO


# ---------------------------------------------------------------------------
# Prover
# ---------------------------------------------------------------------------

def prove_brainfuck(machine, config: Optional[PcsConfig] = None, device="cuda",
                    timer: Optional[PhaseTimer] = None, mesh=None) -> dict:
    """Generate a proof for an executed Machine on `device`. Returns a
    JSON-able dict (docs/PROOF_FORMAT.md), byte-identical to the JAX
    package's proof of the same execution and config.

    mesh: a parallel.mesh.Mesh to prove on instead (the tables are built
    on this process's device, mesh.home): every heavy phase runs sharded
    through parallel/prove.ShardedOps, and the proof bytes are the same for
    any number of shards and processes."""
    mark = timer.mark if timer is not None else (lambda name: None)
    device = canonical_device(device) if mesh is None else mesh.home
    trace = machine.trace()
    mark("trace")
    meta = device_build.build_meta(trace, machine.program())
    assert tuple(meta.claim) == CLAIM_ORDER, list(meta.claim)
    mats = device_build.build_device_tables(trace, meta, device)
    mark("tables")
    return _prove_tables(mats, meta.claim, config, device, mark, mesh)


def _prove_tables(mats: Dict[str, torch.Tensor], claim: Dict[str, int],
                  config: Optional[PcsConfig], device: torch.device, mark,
                  mesh=None) -> dict:
    """The prove pipeline from the component matrices (name -> (n_cols, N)
    int32 on `device`, rows in the component's column order), on `mesh`
    (whose home is `device`) if one is given."""
    config = config or PcsConfig(log_max_rows=0)  # 0 = auto ladder top
    ops = None
    if mesh is not None:
        from .parallel.prove import ShardedOps

        ops = ShardedOps(mesh)
    layout = build_layout(claim, config)
    comps = layout.components
    blow = config.log_blowup
    dev_key = str(device)

    channel = Blake2sChannel(device)
    config.mix_into(channel)

    log.info("Phase 0: preprocessed trace")
    tree0 = _preprocessed_tree(tuple(layout.ladder), blow, dev_key)
    channel.mix_root(tree0.root)
    mark("tree0")

    log.info("Phase 1: main trace")
    mix_claim(channel, claim)
    dev_tabs: Dict[str, Dict[str, torch.Tensor]] = {}
    main_cols: List[Tuple[int, torch.Tensor]] = []
    for comp in comps:
        mat = mats[comp.name]
        dev_tabs[comp.name] = {c: mat[i] for i, c in enumerate(comp.columns)}
        main_cols += [(comp.log_size, mat[i]) for i in range(len(comp.columns))]
    tree1 = TreeProver(main_cols, config, channel, ops=ops)
    mark("tree1")

    log.info("Phase 2: interaction trace")
    elements = draw_elements(channel)
    inter_cols: List[Tuple[int, torch.Tensor]] = []
    claimed = []
    interaction = build_interaction_trace_async if ops is None else ops.interaction
    for comp in comps:
        cols, comp_claimed = interaction(comp, dev_tabs[comp.name], elements)
        claimed.append(comp_claimed)
        for q in cols:
            inter_cols += [(comp.log_size, row(q, c)) for c in range(4)]
    # every component's claimed sum, kept on the card until here: one pull
    pulled = torch.stack(claimed).cpu().tolist()
    del claimed, comp_claimed  # nothing holds the device copies past it
    iclaim: Dict[str, tuple] = {comp.name: tuple(v) for comp, v in zip(comps, pulled)}
    if not lookup_sum_valid(iclaim):
        raise ProvingError("LogUp sum does not cancel — invalid trace")
    mix_interaction_claim(channel, iclaim)
    mark("interaction")
    tree2 = TreeProver(inter_cols, config, channel, ops=ops)
    mats.clear()  # the caller's dict too: the matrices are freed from here on
    del dev_tabs, main_cols, inter_cols
    mark("tree2")

    log.info("Composition polynomial")
    alpha_comp = channel.draw_felt()
    tree0_index = {lg: i for i, lg in enumerate(layout.ladder)}
    acc: Dict[int, object] = {}
    alpha_idx = 0
    t1 = 0
    t2 = 0
    for comp in comps:
        n = comp.log_size
        ext_main = {}
        for col in comp.columns:
            ext_main[col] = tree1.records[t1].extended
            t1 += 1
        n_rows = 4 * (comp.relation_count() + 1)
        inter_rows = [tree2.records[t2 + i].extended for i in range(n_rows)]
        t2 += n_rows
        isf_ext = tree0.records[tree0_index[n]].extended
        lg = n + blow
        # acc[lg] += the component's contribution, in place (one kernel
        # launch on the card; S(p - g) read through the rotation index)
        if ops is None:
            acc[lg], alpha_idx = composition_accumulate(
                comp, ext_main, inter_rows, inter_rows[-4:], fft.rotation_index(n, blow, device),
                isf_ext, iclaim[comp.name], elements, alpha_comp, alpha_idx, blow, acc.get(lg))
        else:
            acc[lg], alpha_idx = ops.composition_accumulate(
                comp, ext_main, inter_rows, isf_ext, iclaim[comp.name], elements, alpha_comp,
                alpha_idx, blow, acc.get(lg))
        del inter_rows

    comp_log = layout.composition_log
    # per-size interpolate, zero-pad + modular add, one evaluate on the
    # composition domain (the circle-FFT basis is nested across sizes)
    if ops is None:
        total = torch.zeros((4, 1 << comp_log), dtype=torch.int64, device=device)
        for lg, arr in sorted(acc.items()):
            coeffs = fft.interpolate(arr, lg)
            total[:, : 1 << lg] = (total[:, : 1 << lg] + coeffs) % P_INT
        comp_evals = fft.evaluate(total.to(torch.int32), comp_log)
        del total
    else:
        comp_evals = ops.combine_eval(acc, comp_log)
    del acc
    mark("composition")
    tree3 = TreeProver([(comp_log, row(comp_evals, c)) for c in range(4)], config, channel,
                       ops=ops)
    del comp_evals
    mark("tree3")
    trees = [tree0, tree1, tree2, tree3]

    log.info("OODS sampling")
    z = point_from_t(channel.draw_felt())
    sampled = _sample_all_trees(trees, layout, z, ops)
    for tvals in sampled:
        for cvals in tvals:
            channel.mix_felts([tuple(v) for v in cvals])
    mark("oods")

    log.info("Quotients")
    alpha_q = channel.draw_felt()
    claims_by_size: Dict[int, List[Tuple[torch.Tensor, List[quotients.QuotientClaim]]]] = {}
    aidx = 0
    for tree, metas, tvals in zip(trees, layout.trees, sampled):
        for rec, meta, cvals in zip(tree.records, metas, tvals):
            if not meta.shifts:
                continue  # committed but never opened (unused ladder sizes)
            size = rec.log_size + blow
            cl = []
            for s, v in zip(meta.shifts, cvals):
                cl.append(quotients.QuotientClaim(
                    point=shifted_point(z, meta.log_size, s), value=v, alpha_index=aidx))
                aidx += 1
            claims_by_size.setdefault(size, []).append((rec.extended, cl))
    fri_inputs = {}
    for size, pairs in claims_by_size.items():
        log.info("  quotients size 2^%d (%d columns)", size, len(pairs))
        fri_inputs[size] = quotients.accumulate_quotients(
            size, [p[0] for p in pairs], [p[1] for p in pairs], alpha_q, ops=ops)
    mark("quotients")

    log.info("FRI")
    s_max = max(fri_inputs)
    fri_prover = fri.fri_commit(fri_inputs, channel, ops=ops)
    del fri_inputs
    mark("fri")

    log.info("PoW + queries")
    nonce = channel.grind_pow(config.pow_bits)
    channel.mix_u64(nonce)
    queries = channel.draw_queries(config.n_queries, s_max)
    mark("pow")

    log.info("Decommitment")
    decommitments = []
    for tree in trees:
        pos = query_positions_by_level(queries, s_max, sorted(tree.column_levels()))
        decommitments.append(merkle.decommit(tree.tree, pos))
    fri.fri_decommit(fri_prover, queries)
    mark("decommit")

    return {
        "config": config.to_json(),
        "claim": claim,
        "interaction_claim": {k: list(v) for k, v in iclaim.items()},
        "commitments": [t.root.hex() for t in trees],
        "sampled_values": [
            [[list(v) for v in cvals] for cvals in tvals] for tvals in sampled
        ],
        "fri": fri_prover.proof.to_json(),
        "pow_nonce": nonce,
        "decommitments": [d.to_json() for d in decommitments],
    }


def sampling_plan(layout: SystemLayout) -> Dict[tuple, list]:
    """(trace log, shift) -> [(tree, column, point index)] in walk order."""
    groups: Dict[tuple, list] = {}
    for ti, metas in enumerate(layout.trees):
        for ci, meta in enumerate(metas):
            for pi, s in enumerate(meta.shifts):
                groups.setdefault((meta.log_size, s), []).append((ti, ci, pi))
    return groups


def _sample_all_trees(trees, layout: SystemLayout, z, ops=None) -> List[List[List[tuple]]]:
    """OODS-sample every committed column of every tree at its mask points:
    columns are grouped by (trace log, shift) across trees; each group is
    one tensor-product contraction (poly.sample_tensor; with the mesh
    backend `ops`, per-shard partial contractions summed mod p) with the
    point's half-bases built on the host."""
    sampled: List[List[List[Optional[tuple]]]] = [
        [[None] * len(meta.shifts) for meta in metas] for metas in layout.trees
    ]
    sample = poly.sample_tensor if ops is None else ops.sample_tensor
    for (log_size, s), members in sampling_plan(layout).items():
        rows = [trees[ti].records[ci].coeffs for ti, ci, _ in members]
        b_lo, b_hi = poly.half_bases_at_point(log_size, shifted_point(z, log_size, s))
        arr = sample(rows, b_lo, b_hi).cpu().numpy()
        for c, (ti, ci, pi) in enumerate(members):
            sampled[ti][ci][pi] = tuple(int(arr[k, c]) for k in range(4))
    return sampled  # type: ignore[return-value]


# ---------------------------------------------------------------------------
# Verifier
# ---------------------------------------------------------------------------

MIN_SECURITY_CONFIG = PcsConfig(log_blowup=1, n_queries=8, pow_bits=4, log_max_rows=0)


def verify_brainfuck(proof: dict, min_config: Optional[PcsConfig] = None,
                     device="cuda") -> None:
    """Full verification; raises VerificationError on any failure.

    min_config pins the minimum acceptable security parameters; the proof's
    embedded config must meet or exceed them. `device` is where the
    preprocessed ladder root is recomputed; every other check runs on the
    host. The default device is the card: without one this raises
    RuntimeError (pass device="cpu" to verify on the CPU)."""
    device = canonical_device(device)
    try:
        _verify_brainfuck_inner(proof, min_config, str(device))
    except VerificationError:
        raise
    except Exception as exc:  # malformed proofs must never crash the verifier
        raise VerificationError(f"malformed proof ({type(exc).__name__}: {exc})")


def _verify_brainfuck_inner(proof: dict, min_config: Optional[PcsConfig], device: str) -> None:
    try:
        config = PcsConfig.from_json(proof["config"])
        claim = {k: int(v) for k, v in proof["claim"].items()}
        iclaim = {k: tuple(int(x) for x in v) for k, v in proof["interaction_claim"].items()}
        roots = [bytes.fromhex(r) for r in proof["commitments"]]
        sampled = [
            [[tuple(int(x) for x in v) for v in cvals] for cvals in tvals]
            for tvals in proof["sampled_values"]
        ]
        fri_proof = fri.FriProof.from_json(proof["fri"])
        nonce = int(proof["pow_nonce"])
        decs = [merkle.MerkleDecommitment.from_json(d) for d in proof["decommitments"]]
    except (KeyError, ValueError, TypeError) as exc:
        raise VerificationError(f"malformed proof: {exc}")

    floor = min_config or MIN_SECURITY_CONFIG
    # log_max_rows is capped at LOG_MAX_ROWS_CAP: larger values would force
    # a giant preprocessed recommit before any cryptographic check (DoS).
    if (config.log_blowup < max(1, floor.log_blowup)
            or config.n_queries < floor.n_queries
            or config.pow_bits < floor.pow_bits
            or not (0 <= config.log_max_rows <= LOG_MAX_ROWS_CAP)):
        raise VerificationError(f"insecure proof parameters: {config}")
    if len(roots) != N_TREES or len(decs) != N_TREES or len(sampled) != N_TREES:
        raise VerificationError("bad tree count")
    if set(claim) != {c.name for c in COMPONENT_CLASSES}:
        raise VerificationError("bad claim components")
    for name, lg in claim.items():
        if not (MIN_LOG_SIZE <= lg <= LOG_MAX_ROWS_CAP):
            raise VerificationError(f"claim log_size out of range: {name}={lg}")
    try:
        layout = build_layout(claim, config)
    except ProvingError as exc:
        raise VerificationError(str(exc))
    blow = config.log_blowup
    # the proof's shape first: the recompute below hashes a ladder of up to
    # 2^(24 + blowup) leaves, which a malformed proof must not cost
    for tvals, metas in zip(sampled, layout.trees):
        if len(tvals) != len(metas):
            raise VerificationError("bad sampled value count")
        for cvals, meta in zip(tvals, metas):
            if len(cvals) != len(meta.shifts):
                raise VerificationError("bad sample point count")

    # The preprocessed (is_first ladder) root is a deterministic function of
    # the config/claim — recomputed, never trusted from the proof.
    if _preprocessed_root(tuple(layout.ladder), blow, device) != roots[0]:
        raise VerificationError("preprocessed commitment mismatch")

    # transcript replay
    channel = Blake2sChannel()
    config.mix_into(channel)
    channel.mix_root(roots[0])
    mix_claim(channel, claim)
    channel.mix_root(roots[1])
    elements = draw_elements(channel)
    if not lookup_sum_valid(iclaim):
        raise VerificationError("invalid LogUp sum")
    mix_interaction_claim(channel, iclaim)
    channel.mix_root(roots[2])
    alpha_comp = channel.draw_felt()
    channel.mix_root(roots[3])
    z = point_from_t(channel.draw_felt())

    for tvals in sampled:
        for cvals in tvals:
            channel.mix_felts([tuple(v) for v in cvals])

    _check_composition_identity(layout, sampled, iclaim, elements, alpha_comp, z)

    alpha_q = channel.draw_felt()
    beta0 = channel.draw_felt()
    betas = []
    for root in fri_proof.layer_roots:
        channel.mix_root(root)
        betas.append(channel.draw_felt())
    channel.mix_felts([fri_proof.last_layer_value])

    if not channel.check_pow_nonce(config.pow_bits, nonce):
        raise VerificationError("invalid proof of work")
    channel.mix_u64(nonce)

    # largest commitment size that carries claims (= FRI max); unopened
    # ladder levels may be deeper but are witness-only
    s_max = max(m.log_size + blow for metas in layout.trees for m in metas if m.shifts)
    queries = channel.draw_queries(config.n_queries, s_max)

    values_by_size: Dict[int, List[Tuple[List[int], List[quotients.QuotientClaim]]]] = {}
    positions_by_size: Dict[int, List[int]] = {}
    aidx = 0
    for ti, (root, metas, tvals, dec) in enumerate(zip(roots, layout.trees, sampled, decs)):
        col_levels: Dict[int, int] = {}
        for meta in metas:
            lvl = meta.log_size + blow
            col_levels[lvl] = col_levels.get(lvl, 0) + 1
        levels = sorted(col_levels)
        pos = query_positions_by_level(queries, s_max, levels)
        try:
            got = merkle.verify(root, col_levels, pos, dec, max_log=max(levels))
        except merkle.MerkleVerificationError as exc:
            raise VerificationError(f"tree {ti} merkle: {exc}")
        seen_at_level: Dict[int, int] = {}
        for meta, cvals in zip(metas, tvals):
            lvl = meta.log_size + blow
            ci = seen_at_level.get(lvl, 0)
            seen_at_level[lvl] = ci + 1
            if not meta.shifts:
                continue  # committed but never opened
            claims = []
            for s, v in zip(meta.shifts, cvals):
                claims.append(quotients.QuotientClaim(
                    point=shifted_point(z, meta.log_size, s), value=v, alpha_index=aidx))
                aidx += 1
            positions_by_size[lvl] = pos[lvl]
            values_by_size.setdefault(lvl, []).append((got[lvl][ci], claims))

    qvals_by_size: Dict[int, dict] = {}
    for size, cols in values_by_size.items():
        prepared = quotients.prepare_point_groups([c[1] for c in cols], alpha_q)
        mat = np.array([c[0] for c in cols], np.uint64)
        qvals_by_size[size] = quotients.quotient_values_batch(
            size, positions_by_size[size], mat, prepared)

    def input_values_fn(size, position):
        d = qvals_by_size.get(size)
        return None if d is None else d[position]

    try:
        fri.fri_verify_queries(fri_proof, (beta0, betas), s_max, queries, input_values_fn)
    except fri.FriVerificationError as exc:
        raise VerificationError(f"FRI: {exc}")


def _check_composition_identity(layout, sampled, iclaim, elements, alpha_comp, z):
    """Recompute the composition value at z from sampled mask values and
    compare against the sampled composition columns."""
    ladder_index = {lg: i for i, lg in enumerate(layout.ladder)}
    alpha_idx = 0
    total = qm31.ZERO
    t1 = 0
    t2 = 0
    for comp in layout.components:
        n = comp.log_size
        main_vals = {}
        for col in comp.columns:
            main_vals[col] = sampled[1][t1][0]
            t1 += 1
        n_inter = comp.relation_count() + 1
        inter_vals = []
        for k in range(n_inter):
            coords = [sampled[2][t2 + 4 * k + c][0] for c in range(4)]
            inter_vals.append(qm31.h_recombine(coords))
        s_prev_coords = [sampled[2][t2 + 4 * (n_inter - 1) + c][1] for c in range(4)]
        s_prev = qm31.h_recombine(s_prev_coords)
        t2 += 4 * n_inter
        isf = sampled[0][ladder_index[n]][0]
        cons = evaluate_constraints_at_point(
            comp, main_vals, inter_vals, s_prev, isf, iclaim[comp.name], elements)
        v_inv = qm31.h_inv(poly.vanishing_at_point(n, z))
        for c in cons:
            term = qm31.h_mul(qm31.h_pow(alpha_comp, alpha_idx), qm31.h_mul(c, v_inv))
            total = qm31.h_add(total, term)
            alpha_idx += 1

    comp_val = qm31.h_recombine([sampled[3][c][0] for c in range(4)])
    if comp_val != total:
        raise VerificationError("OODS composition identity failed")
