"""Sharded Blake2s Merkle commitment over a mesh.

Counterpart of ``stwo_brainfuck_tpu/parallel/merkle_sharded.py``. Nodes are
sharded as contiguous chunks, so the children (2i, 2i+1) of a shard's nodes
always lie in the same shard: every level with at least D nodes hashes
locally on each shard this process owns (``core/merkle.hash_level``) until
one node per shard is left. One ``all_gather`` collects the D subtree roots,
and the top log2 D levels (with any columns injected there) are hashed in
every process, on its own device (``core/merkle.hash_levels``: on CUDA the
digest-only run of them is one tail launch). On CUDA shards every level is
a Blake2s kernel launch. The root is the single-device
``core/merkle.commit`` root for any D.
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
        prev = mesh.each(lambda i: merkle.hash_level(prev[i], cols[i]))
        layers[k] = Sharded(mesh, prev)
    # one node per shard: gather the D subtree roots into every process
    top = mesh.all_gather(mesh.each(lambda i: prev[i][:, 0]))[mesh.local[0]].T.contiguous()
    if split:
        layers.update(merkle.hash_levels(top, {k: m for k, m in mats.items() if k < split},
                                         split - 1))
        top = layers[0]
    root = blake2s.digest_to_bytes(top[:, 0])
    return merkle.MerkleTree(root=root, layers=layers, column_mats=mats)


def sharded_commit(mesh: Mesh, columns_by_log: Dict[int, object]) -> bytes:
    """Just the root of commit_sharded: equal to merkle.commit(...).root."""
    return commit_sharded(mesh, columns_by_log).root
