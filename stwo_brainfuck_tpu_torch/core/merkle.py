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
(``tree_plain``). Verification runs on the host with hashlib.

Decommitment (counterpart of the JAX package's ``decommit_async`` /
``finalize_with_extra``): ``decommit_async`` records each read a witness
needs as a ``Gather`` (column values, sibling digests) without touching
the device; ``finalize_with_extra`` serves any number of pending
decommitments and extra gathers (the FRI layer values) in one pass
(``serve``): the positions go up in one copy, each gather is one
index_select into its slots of one flat buffer, and the buffer comes to
the host in one pull (the recording's ``sync.decommit``, tracing.py).
Sharded sources go through
their mesh's ``gather_many``: one index_select a shard's part of a
gather, one copy a device, and on the process mesh one all_reduce.
"""

from __future__ import annotations

import hashlib
import itertools
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import tracing
from . import blake2s
from ..ops import blake2s_kernels
from ..ops.staging import PinnedRing


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
    with tracing.span("commit.hash"):
        layers = hash_levels(None, columns_by_log, max(columns_by_log))
    root = blake2s.digest_to_bytes(tracing.pull("root", layers[0][:, 0]))
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


# ---------------------------------------------------------------------------
# Batched reads: any number of gathers served in one pass
# ---------------------------------------------------------------------------

_STAGING = PinnedRing()


@dataclass(frozen=True)
class Gather:
    """One read, source[..., positions] of an (R, N) or (N,) array (a tensor
    or a mesh-sharded one, parallel/mesh.Sharded): the C columns of a
    committed matrix, the 8 digest words of a tree level, or the 4
    coordinates of an FRI layer."""

    source: object
    positions: Sequence[int]


@dataclass
class _Part:
    """Positions i0 .. i1 of one gather's sorted positions, read from one
    tensor at `columns`: slots lo .. hi of the buffer."""

    tensor: torch.Tensor
    columns: np.ndarray
    lo: int
    hi: int


def pull(t: torch.Tensor) -> np.ndarray:
    """A served batch on the host: one device->host copy, the recording's
    sync.decommit (on the CPU the copy is a no-op, still counted)."""
    return tracing.pull("decommit", t).numpy()


def _upload(values: np.ndarray, device: torch.device) -> torch.Tensor:
    """int64 host values as a tensor on `device`: on CUDA one non-blocking
    copy from a reused pinned buffer (ops/staging.py)."""
    if device.type != "cuda":
        return torch.from_numpy(values)
    with torch.cuda.device(device):
        return _STAGING.to_card(values, device).view(torch.int64)


def _take(src: torch.Tensor, columns: torch.Tensor, out: torch.Tensor) -> None:
    """out (m, R) = src[:, columns].T for an (R, N) src, in one launch of
    the index kernel the prover already uses (index_select's first call in
    a process costs ~0.1 s on an H100 host: tools/decommit_first_call.py)."""
    torch.ops.aten.index.Tensor_out(src.T, [columns], out=out)


class Reads:
    """A batch of gathers laid out in one flat buffer, position-major:
    gather j's n positions (sorted; `place` restores the order asked for)
    times R rows from bases[j], so the positions a shard owns, a run of
    the sorted positions, fill a run of slots. A part reads one such run
    from one tensor with one index_select."""

    def __init__(self, gathers: Sequence[Gather]):
        self.gathers = list(gathers)
        dtypes = {g.source.dtype for g in self.gathers}
        if len(dtypes) > 1:
            raise ValueError(f"one batch of gathers, several dtypes: {dtypes}")
        self.dtype = dtypes.pop() if dtypes else torch.int32
        counts = [len(g.positions) for g in self.gathers]
        ends = np.cumsum(counts, dtype=np.int64)
        flat = np.fromiter(itertools.chain.from_iterable(g.positions for g in self.gathers),
                           np.int64, int(ends[-1]) if counts else 0)
        # a gather whose positions descend somewhere is read sorted
        falls = flat[1:] < flat[:-1]
        falls[ends[:-1][(ends[:-1] > 0) & (ends[:-1] < flat.size)] - 1] = False  # gather to gather
        unsorted = set(np.searchsorted(ends, np.flatnonzero(falls) + 1, side="right").tolist())
        self.positions: List[np.ndarray] = []
        self.orders: List[Optional[np.ndarray]] = []
        self.rows: List[int] = []
        self.flat: List[bool] = []
        self.bases: List[int] = []
        self.total = 0
        for j, (g, end, n) in enumerate(zip(self.gathers, ends.tolist(), counts)):
            shape = tuple(g.source.shape)
            if len(shape) not in (1, 2):
                raise ValueError(f"gather from an array of shape {shape}")
            pos = flat[end - n:end]
            order = np.argsort(pos, kind="stable") if j in unsorted else None
            self.positions.append(pos if order is None else pos[order])
            self.orders.append(order)
            self.rows.append(shape[0] if len(shape) == 2 else 1)
            self.flat.append(len(shape) == 1)
            self.bases.append(self.total)
            self.total += n * self.rows[-1]

    def part(self, j: int, tensor: torch.Tensor, i0: int = 0, i1: Optional[int] = None,
             offset: int = 0) -> _Part:
        """Gather j's sorted positions i0 .. i1 (all by default), read from
        `tensor` at position - offset."""
        pos = self.positions[j]
        i1 = pos.size if i1 is None else i1
        r = self.rows[j]
        return _Part(tensor, pos[i0:i1] - offset, self.bases[j] + i0 * r,
                     self.bases[j] + i1 * r)

    def gather_into(self, parts: Sequence[_Part], buf: torch.Tensor) -> None:
        """Every part's values into its slots of `buf`: on each device the
        columns go up in one copy and each part is one index_select; the
        parts on another device than buf's are gathered there and moved
        with one copy a device."""
        by_device: Dict[torch.device, List[_Part]] = {}
        for p in parts:
            if p.hi > p.lo:
                by_device.setdefault(p.tensor.device, []).append(p)
        for dev, ps in by_device.items():
            cols = _upload(np.concatenate([p.columns for p in ps]), dev)
            local = dev == buf.device
            out = buf if local else torch.empty(sum(p.hi - p.lo for p in ps), dtype=buf.dtype,
                                                device=dev)
            a = o = 0
            for p in ps:
                m = p.columns.size
                src = p.tensor if p.tensor.dim() == 2 else p.tensor[None]
                lo = p.lo if local else o
                _take(src, cols[a:a + m], out[lo:lo + p.hi - p.lo].view(m, -1))
                a += m
                o += p.hi - p.lo
            if not local:
                moved, o = out.to(buf.device), 0
                for p in ps:
                    buf[p.lo:p.hi] = moved[o:o + p.hi - p.lo]
                    o += p.hi - p.lo

    def collect(self, parts: Sequence[_Part], home: torch.device) -> List[np.ndarray]:
        """The parts gathered into one buffer on `home`, pulled with one
        copy and placed."""
        buf = torch.empty(self.total, dtype=self.dtype, device=home)
        with tracing.span("decommit.gather"):
            self.gather_into(parts, buf)
        return self.place(pull(buf))

    def place(self, values: np.ndarray) -> List[np.ndarray]:
        """Each gather's values, (R, n) or (n,), from the pulled buffer, in
        the order of its positions."""
        out = []
        for pos, order, r, b, flat in zip(self.positions, self.orders, self.rows, self.bases,
                                          self.flat):
            got = values[b:b + pos.size * r].reshape(pos.size, r).T
            if order is not None:
                got = got[:, np.argsort(order)]
            out.append(got[0] if flat else got)
        return out


def serve(gathers: Sequence[Gather]) -> List[np.ndarray]:
    """Every gather's values on the host in one pass: through the mesh's
    gather_many where a source is mesh-sharded, else on the sources'
    device; one device->host pull either way."""
    meshes = {g.source.mesh for g in gathers if not isinstance(g.source, torch.Tensor)}
    if len(meshes) > 1:
        raise ValueError("gathers from arrays of several meshes")
    if meshes:
        return meshes.pop().gather_many(gathers)
    with tracing.span("decommit.layout"):
        reads = Reads(gathers)
    home = gathers[0].source.device if gathers else torch.device("cpu")
    return reads.collect([reads.part(j, g.source) for j, g in enumerate(gathers)], home)


def gather_columns(mat, positions) -> np.ndarray:
    """mat[:, positions] on the host, for a tensor or a mesh-sharded array."""
    return serve([Gather(mat, positions)])[0]


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


class PendingDecommitment:
    """A decommitment's gathers, recorded and not yet served: the column
    values by level descending, then the witness digests by level
    descending. finalize_many serves any number of them, with more
    gathers, in one pass."""

    def __init__(self, columns: List[Tuple[int, Gather]], witness: List[Gather]):
        self.columns = columns
        self.witness = witness

    def gathers(self) -> List[Gather]:
        return [g for _, g in self.columns] + self.witness

    def build(self, host_arrays: Sequence[np.ndarray]) -> MerkleDecommitment:
        """The decommitment from its gathers' host values, in gathers()
        order."""
        out = MerkleDecommitment()
        for (k, _), got in zip(self.columns, host_arrays):
            out.column_values[k] = got.tolist()
        for got in host_arrays[len(self.columns):]:
            words = np.ascontiguousarray(got.T).astype("<u4")  # (n, 8): a digest a row
            out.witness_hashes.extend(words.view("V32")[:, 0].tolist())
        return out


def decommit_async(tree: MerkleTree, queries, include_values: bool = True) -> PendingDecommitment:
    """Record the gathers of the witness for query positions (a list of
    positions at the deepest level, or a dict {level: positions}) without
    reading anything. include_values=False leaves the column values out (a
    witness-hash-only decommitment: FRI layer values travel separately)."""
    top = tree.max_log
    needed = _needed_positions(queries, top)
    columns: List[Tuple[int, Gather]] = []
    witness: List[Gather] = []
    for k in range(top, -1, -1):
        if include_values and k in tree.column_mats:
            columns.append((k, Gather(tree.column_mats[k], needed[k])))
        if k < top:
            child_needed = set(needed[k + 1])
            witness_pos = [child for p in needed[k] for child in (2 * p, 2 * p + 1)
                           if child not in child_needed]
            if witness_pos:
                witness.append(Gather(tree.layers[k + 1], witness_pos))
    return PendingDecommitment(columns, witness)


def finalize_with_extra(pendings: Sequence[PendingDecommitment], extra: Sequence[Gather]):
    """Serve every gather of the pending decommitments and the `extra`
    gathers in one pass (one device->host pull; on a process mesh one
    all_reduce). Returns (the decommitments, the extra gathers' host
    values)."""
    host = serve([g for p in pendings for g in p.gathers()] + list(extra))
    out, i = [], 0
    with tracing.span("decommit.build"):
        for p in pendings:
            n = len(p.columns) + len(p.witness)
            out.append(p.build(host[i:i + n]))
            i += n
    return out, host[i:]


def finalize_many(pendings: Sequence[PendingDecommitment]) -> List[MerkleDecommitment]:
    return finalize_with_extra(pendings, [])[0]


def decommit(tree: MerkleTree, queries, include_values: bool = True) -> MerkleDecommitment:
    """The witness for query positions: a list of positions at the deepest
    level, or a dict {level: positions}. include_values=False gives a
    witness-hash-only decommitment (FRI layer values travel separately)."""
    return finalize_many([decommit_async(tree, queries, include_values)])[0]

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
