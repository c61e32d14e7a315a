"""Sharded Blake2s Merkle commitment over a mesh.

Counterpart of ``stwo_brainfuck_tpu/parallel/merkle_sharded.py``. Nodes are
sharded as contiguous chunks, so the children (2i, 2i+1) of a shard's nodes
always lie in the same shard: a shard's nodes of the levels max_log ..
split (D = 2^split shards) form a subtree whose root is its one node of
level split. Each shard this process owns hashes that subtree as a tree of
its own (levels relabelled k - split, ``core/merkle.hash_levels``: on CUDA
one tree kernel launch a shard). One ``all_gather`` collects the D subtree
roots, and the top log2 D levels (with any columns injected there) are one
more ``merkle.hash_levels`` call in every process, on its own device. The
root is the single-device ``core/merkle.commit`` root for any D.
"""

from __future__ import annotations

from typing import Dict

from .. import tracing
from ..core import blake2s, merkle
from .mesh import Mesh, Sharded


def commit_sharded(mesh: Mesh, columns_by_log: Dict[int, object]) -> merkle.MerkleTree:
    """core/merkle.commit over the mesh. columns_by_log: level -> (C, 2^k)
    column matrix (a tensor or a Sharded array) or a list of (2^k,)
    columns. The tree's layers with at least D nodes and its column
    matrices at those levels are Sharded arrays; core/merkle.decommit
    reads them through Sharded.gather."""
    split = mesh.split_log
    mats = {k: mesh.stack(v) if isinstance(v, (list, tuple)) else v
            for k, v in columns_by_log.items()}
    for k, m in mats.items():
        if len(m.shape) != 2 or m.shape[1] != 1 << k:
            raise ValueError(f"level {k}: bad column matrix {tuple(m.shape)}")
    max_log = max(mats)
    if max_log < split:
        return merkle.commit({k: mesh.full(m) for k, m in mats.items()})
    mats = {k: mesh.as_sharded(m) if k >= split else mesh.full(m) for k, m in mats.items()}

    with tracing.span("commit.hash"):
        # each local shard's subtree: levels max_log .. split as max_log - split .. 0
        runs = mesh.each(lambda i: merkle.hash_levels(
            None, {k - split: m.shards[i] for k, m in mats.items() if k >= split},
            max_log - split))
        layers: Dict[int, object] = {
            k: Sharded(mesh, [None if r is None else r[k - split] for r in runs])
            for k in range(max_log, split - 1, -1)}
        # one node per shard: gather the D subtree roots into every process
        top = mesh.all_gather(mesh.each(lambda i: runs[i][0][:, 0]))[mesh.local[0]].T.contiguous()
        if split:
            layers.update(merkle.hash_levels(top, {k: m for k, m in mats.items() if k < split},
                                             split - 1))
            top = layers[0]
    root = blake2s.digest_to_bytes(tracing.pull("root", top[:, 0]))
    return merkle.MerkleTree(root=root, layers=layers, column_mats=mats)


def sharded_commit(mesh: Mesh, columns_by_log: Dict[int, object]) -> bytes:
    """Just the root of commit_sharded: equal to merkle.commit(...).root."""
    return commit_sharded(mesh, columns_by_log).root
