"""Polynomial commitment scheme: per-phase commitment trees with blowup.

Counterpart of ``stwo_brainfuck_tpu/core/pcs.py`` (its host-channel
branch). Each phase (preprocessed / main / interaction / composition)
commits one Merkle tree over all its columns, each column low-degree
extended by the blowup and injected at its own tree level.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Sequence, Tuple

import torch

from .. import tracing
from . import fft, merkle
from .circle import M31_CIRCLE_LOG_ORDER, point_at_index, secure_point_add, secure_point_from_m31


@dataclass
class PcsConfig:
    log_blowup: int = 1
    n_queries: int = 20
    pow_bits: int = 10
    log_max_rows: int = 24

    def mix_into(self, channel) -> None:
        channel.mix_u32s([self.log_blowup, self.n_queries, self.pow_bits, self.log_max_rows])

    def to_json(self):
        return {
            "log_blowup": self.log_blowup,
            "n_queries": self.n_queries,
            "pow_bits": self.pow_bits,
            "log_max_rows": self.log_max_rows,
        }

    @staticmethod
    def from_json(obj) -> "PcsConfig":
        return PcsConfig(**obj)


@dataclass
class ColumnRecord:
    log_size: int            # trace domain log
    coeffs: torch.Tensor     # (2^log,) M31 coefficients (a row view)
    extended: torch.Tensor   # (2^(log+blowup),) evaluation (a row view)


def row(x, j: int):
    """Row j of a (C, N) tensor or mesh-sharded array."""
    return x[j] if isinstance(x, torch.Tensor) else x.rows(j)


class TreeProver:
    """One committed phase: extend columns, commit, mix the root."""

    def __init__(self, columns: Sequence[Tuple[int, torch.Tensor]], config: PcsConfig,
                 channel, ops=None):
        """columns: list of (log_size, (2^log_size,) int32 trace-domain
        evaluation). Columns of a common size are stacked and extended as
        one (C, N) batch. With `ops` (the mesh backend,
        parallel/prove.ShardedOps) the extends and the commitment run
        sharded, and the records hold sharded rows."""
        self.config = config
        with tracing.span("commit.extend"):
            groups: Dict[int, List[int]] = {}
            for i, (log_size, _) in enumerate(columns):
                groups.setdefault(log_size, []).append(i)
            coeffs_all: Dict[int, torch.Tensor] = {}
            ext_all: Dict[int, torch.Tensor] = {}
            for log_size, idxs in groups.items():
                cols = [columns[i][1] for i in idxs]
                if ops is None:
                    coeffs_all[log_size], ext_all[log_size] = fft.extend_with_coeffs(
                        torch.stack(cols), log_size, config.log_blowup)
                else:
                    coeffs_all[log_size], ext_all[log_size] = ops.extend_with_coeffs(
                        cols, log_size, config.log_blowup)
            self.records: List[ColumnRecord] = []
            pos: Dict[int, int] = {k: 0 for k in groups}
            for log_size, _ in columns:
                j = pos[log_size]
                pos[log_size] = j + 1
                self.records.append(ColumnRecord(
                    log_size, row(coeffs_all[log_size], j), row(ext_all[log_size], j)))
        self.tree = (merkle.commit if ops is None else ops.commit)(
            {lg + config.log_blowup: ext_all[lg] for lg in groups})
        channel.mix_root(self.tree.root)

    @classmethod
    def from_records(cls, records: List[ColumnRecord], config: PcsConfig) -> "TreeProver":
        """Commit a tree from precomputed (coeffs, extended) records, one
        column per level (the closed-form is_first ladder)."""
        self = object.__new__(cls)
        self.config = config
        self.records = list(records)
        by_level: Dict[int, torch.Tensor] = {}
        for rec in self.records:
            lvl = rec.log_size + config.log_blowup
            if lvl in by_level:
                raise ValueError("from_records: one column per level")
            by_level[lvl] = rec.extended[None]
        self.tree = merkle.commit(by_level)
        return self

    @property
    def root(self) -> bytes:
        return self.tree.root

    def decommit(self, positions_by_level: Dict[int, List[int]]) -> merkle.MerkleDecommitment:
        return merkle.decommit(self.tree, positions_by_level)

    def column_levels(self) -> Dict[int, int]:
        by_level: Dict[int, int] = {}
        for rec in self.records:
            lvl = rec.log_size + self.config.log_blowup
            by_level[lvl] = by_level.get(lvl, 0) + 1
        return by_level


def shifted_point(z, log_size: int, shift: int):
    """z - shift * g_{log_size} (the mask offset point for prefix-sum
    columns). g is the trace-domain step, index 2^(31-log_size)."""
    if shift == 0:
        return z
    idx = (-shift * (1 << (M31_CIRCLE_LOG_ORDER - log_size))) % (1 << M31_CIRCLE_LOG_ORDER)
    return secure_point_add(z, secure_point_from_m31(point_at_index(idx)))


def query_positions_by_level(
    queries: Sequence[int], s_max: int, levels: Sequence[int]
) -> Dict[int, List[int]]:
    """For each commitment level, the projected query positions expanded to
    their radix-4 fold QUAD (the FRI verifier folds twice per committed
    layer, and mid-layer injections consume the whole quad)."""
    out: Dict[int, List[int]] = {}
    for s in levels:
        if s > s_max:
            # deeper than any FRI input (unopened ladder sizes): nothing is
            # queried there — their digests enter via witness hashes.
            continue
        out[s] = sorted({((q >> (s_max - s)) & ~3) + j
                         for q in queries for j in range(4)})
    return out
