"""Sharded Blake2s Merkle commitment over a mesh.

Counterpart of ``stwo_brainfuck_tpu/parallel/merkle_sharded.py``. Nodes are
sharded as contiguous chunks, so the children (2i, 2i+1) of a shard's nodes
always lie in the same shard: every level with at least D nodes hashes
locally on each shard (``core/merkle.hash_level``) until one node per shard
is left. One ``all_gather`` collects the D subtree roots, and the top
log2 D levels (with any columns injected there) are hashed on the mesh's
first device. The root is the single-device ``core/merkle.commit`` root for
any D.
"""

from __future__ import annotations

from typing import Dict

import torch

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

    layers: Dict[int, object] = {}
    prev = [None] * mesh.size
    for k in range(max_log, split - 1, -1):
        cols = mats[k].shards if k in mats else [None] * mesh.size
        prev = [merkle.hash_level(c, m) for c, m in zip(prev, cols)]
        layers[k] = Sharded(mesh, prev)
    # one node per shard: gather the D subtree roots onto the first device
    top = mesh.all_gather([p[:, 0] for p in prev])[0].T
    for k in range(split - 1, -1, -1):
        top = merkle.hash_level(top, mats.get(k))
        layers[k] = top
    root = blake2s.digest_to_bytes(top[:, 0])
    return merkle.MerkleTree(root=root, layers=layers, column_mats=mats)


def sharded_commit(mesh: Mesh, columns_by_log: Dict[int, object]) -> bytes:
    """Just the root of commit_sharded: equal to merkle.commit(...).root."""
    return commit_sharded(mesh, columns_by_log).root
