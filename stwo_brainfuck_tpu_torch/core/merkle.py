"""Blake2s Merkle vector commitment over mixed-size M31 columns.

Counterpart of ``stwo_brainfuck_tpu/core/merkle.py``. One tree commits a
whole commitment phase. Columns of commitment-domain size 2^k are injected
at tree level k (level k has 2^k nodes; level 0 is the root):

    node_{k,i} = blake2s( child_{k+1,2i} || child_{k+1,2i+1}
                          || col_values_at_level_k[i] ... )

The deepest level hashes each row of its (C, 2^k) column matrix as one
message of C words. A tree's levels are (8, 2^k) views of one buffer
(level k at word offset 8 * (2^k - 1)). On CUDA tensors the whole tree is
one launch of the Blake2s tree kernel (``ops/blake2s_kernels.py``,
``launch_plan``: a CTA hashes a 2^8-node subtree in shared memory and the
last CTA to finish carries the top; the JAX package runs a program a level
and fuses up to four digest-only levels, ``level_plan``; the digests are
the same). On CPU tensors every level is the plain ``hash_parts``
(``tree_plain``). Decommitment gathers the queried positions on the
device; verification runs on the host with hashlib.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass, field
from typing import Dict, List

import numpy as np
import torch

from . import blake2s
from ..ops import blake2s_kernels


@dataclass
class MerkleTree:
    root: bytes
    # level -> (8, 2^level) int32 digest words (32-bit patterns), on device
    # (mesh-sharded at the levels parallel/merkle_sharded.py hashes sharded)
    layers: Dict[int, torch.Tensor]
    # level -> (n_cols, 2^level) column matrix the caller committed (no
    # copy; a mesh-sharded array where the caller's was)
    column_mats: Dict[int, torch.Tensor]

    @property
    def max_log(self) -> int:
        return max(self.layers)


def commit(columns_by_log: Dict[int, torch.Tensor]) -> MerkleTree:
    """Build the tree on the matrices' device; only the 32-byte root comes
    to the host. columns_by_log: level -> (C, 2^level) int32 column
    matrix."""
    if not columns_by_log:
        raise ValueError("empty commitment")
    for k, mat in columns_by_log.items():
        if mat.dim() != 2 or mat.shape[1] != 1 << k:
            raise ValueError(f"level {k}: bad column matrix {tuple(mat.shape)}")
    layers = hash_levels(None, columns_by_log, max(columns_by_log))
    root = blake2s.digest_to_bytes(layers[0][:, 0])
    return MerkleTree(root=root, layers=layers, column_mats=dict(columns_by_log))


def hash_levels(children, columns_by_log: Dict[int, torch.Tensor],
                max_log: int) -> Dict[int, torch.Tensor]:
    """Levels max_log .. 0 of a tree, level -> (8, 2^level) int32 digests
    (views of one buffer), from the digests below max_log (children, (8,
    2^(max_log+1)), or None at the deepest level) and the column matrices
    at those levels: one tree kernel launch on a CUDA device, tree_plain
    (level by level) on the CPU."""
    devices = {t.device for t in [children, *columns_by_log.values()] if t is not None}
    if len(devices) != 1:
        raise ValueError(f"Merkle levels on several devices or none: {devices}")
    device = devices.pop()
    K = blake2s_kernels
    if device.type == "cuda":
        tree = K.KERNELS.tree
    elif device.type == "cpu":
        tree = K.tree_plain
    else:
        raise ValueError(f"Merkle commit: unsupported device {device}")
    plan = K.launch_plan([(k, m.shape[0]) for k, m in columns_by_log.items()], max_log)
    return K.walk_plan(plan, columns_by_log, children, tree)


def gather_columns(mat, positions) -> np.ndarray:
    """mat[:, positions] on the host, for a tensor or a mesh-sharded
    array (parallel/mesh.Sharded.gather)."""
    if isinstance(mat, torch.Tensor):
        idx = torch.as_tensor(list(positions), dtype=torch.int64, device=mat.device)
        return mat[:, idx].cpu().numpy()
    return mat.gather(positions).numpy()


@dataclass
class MerkleDecommitment:
    """Witness for a set of query positions (positions on the deepest level).

    column_values[k] = per column at level k, values at sorted needed
    positions of level k. witness_hashes: sibling digests (32B each) ordered
    by (level descending, position ascending)."""

    column_values: Dict[int, List[List[int]]] = field(default_factory=dict)
    witness_hashes: List[bytes] = field(default_factory=list)

    def to_json(self):
        return {
            "column_values": {str(k): v for k, v in self.column_values.items()},
            "witness_hashes": [h.hex() for h in self.witness_hashes],
        }

    @staticmethod
    def from_json(obj) -> "MerkleDecommitment":
        return MerkleDecommitment(
            column_values={int(k): [[int(x) for x in col] for col in v]
                           for k, v in obj["column_values"].items()},
            witness_hashes=[bytes.fromhex(h) for h in obj["witness_hashes"]],
        )


def _needed_positions(queries, max_log: int) -> Dict[int, List[int]]:
    """Expand query positions into per-level needed sets.

    `queries` is either a sequence of deepest-level positions, or an explicit
    dict {level: positions}. Every level's needed set additionally includes
    the parents of the level below (hash recomputation path)."""
    if not isinstance(queries, dict):
        queries = {max_log: list(queries)}
    needed: Dict[int, List[int]] = {}
    below: set = set()
    for k in range(max_log, -1, -1):
        cur = set(queries.get(k, ())) | {p >> 1 for p in below}
        needed[k] = sorted(cur)
        below = cur
    return needed


def decommit(tree: MerkleTree, queries, include_values: bool = True) -> MerkleDecommitment:
    """The witness for query positions: a list of positions at the deepest
    level, or a dict {level: positions}. include_values=False gives a
    witness-hash-only decommitment (FRI layer values travel separately)."""
    needed = _needed_positions(queries, tree.max_log)
    out = MerkleDecommitment()
    for k in range(tree.max_log, -1, -1):
        if include_values and k in tree.column_mats:
            got = gather_columns(tree.column_mats[k], needed[k])
            out.column_values[k] = [[int(v) for v in row] for row in got]
        if k < tree.max_log:
            child_needed = set(needed[k + 1])
            witness_pos = [child for p in needed[k] for child in (2 * p, 2 * p + 1)
                           if child not in child_needed]
            if witness_pos:
                got = gather_columns(tree.layers[k + 1], witness_pos)
                for j in range(got.shape[1]):
                    out.witness_hashes.append(blake2s.digest_to_bytes(got[:, j]))
    return out


class MerkleVerificationError(Exception):
    pass


def verify(
    root: bytes,
    column_log_sizes: Dict[int, int],
    queries,
    decommitment: MerkleDecommitment,
    max_log: int | None = None,
) -> Dict[int, List[List[int]]]:
    """Verify a decommitment against `root`.

    column_log_sizes: level -> number of columns at that level.
    queries: deepest-level positions or explicit {level: positions}.
    Returns the verified column values (level -> per-column values at the
    level's needed positions) for use by the FRI/quotient checks.
    Raises MerkleVerificationError on any mismatch.
    """
    if max_log is None:
        max_log = max(column_log_sizes)
    needed = _needed_positions(queries, max_log)
    witness = iter(decommitment.witness_hashes)
    prev_hashes: Dict[int, bytes] = {}
    for k in range(max_log, -1, -1):
        n_cols = column_log_sizes.get(k, 0)
        vals = decommitment.column_values.get(k, [])
        if len(vals) != n_cols or any(len(v) != len(needed[k]) for v in vals):
            raise MerkleVerificationError(f"bad column values at level {k}")
        # per-position value bytes in one numpy pass
        if vals:
            arr = np.array(vals, dtype=np.uint64)
            if (arr >> 32).any():
                # out-of-range cells must fail hard (silent wrapping would
                # admit equivalent encodings of one witness — malleability)
                raise MerkleVerificationError(
                    f"column value out of range at level {k}")
            val_bytes = np.ascontiguousarray(arr.T.astype("<u4"))
        cur: Dict[int, bytes] = {}
        for pi, p in enumerate(needed[k]):
            msg = b""
            if k < max_log:
                for child in (2 * p, 2 * p + 1):
                    if child in prev_hashes:
                        msg += prev_hashes[child]
                    else:
                        try:
                            msg += next(witness)
                        except StopIteration:
                            raise MerkleVerificationError("witness exhausted")
            if vals:
                msg += val_bytes[pi].tobytes()
            cur[p] = hashlib.blake2s(msg).digest()
        prev_hashes = cur

    if next(witness, None) is not None:
        raise MerkleVerificationError("unused witness hashes")
    if prev_hashes.get(0) != root:
        raise MerkleVerificationError("root mismatch")
    return decommitment.column_values
