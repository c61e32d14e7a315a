"""Meshes of shards for multi-device proving, their collectives, and the
sharded-array type.

Counterpart of ``stwo_brainfuck_tpu/parallel/mesh.py``. The sharding axis
is trace ROWS: an array is split along its last axis into D contiguous
chunks, chunk i being shard i. The JAX package's prover is one SPMD program
over a ``jax.sharding.Mesh`` whose runtime is either one process or many;
here the same split is two mesh types behind one surface:

- ``DeviceMesh`` (``make_mesh``): one process drives an ordered list of D
  devices and owns every shard; the collectives are copies between
  per-shard tensors (``Tensor.to``);
- ``ProcessGroupMesh`` (``multihost.global_mesh``): one process per shard
  over ``torch.distributed``; a process owns only its own shard and the
  collectives are ``torch.distributed`` calls.

A mesh's ``local`` lists the shards this process owns and ``home`` is its
own device. A per-shard list (``Sharded.shards``, a collective's input and
output) has D entries, None for the shards other processes own, so the body
of each JAX ``shard_map`` becomes a loop over ``local`` (``Mesh.each``).
A plain tensor in the mesh backend holds the same value in every process.

The collectives:

- ``all_gather``: every shard receives the stack of all shards' values;
- ``exchange``: shard i receives shard i ^ dist (the FFT's cross stages);
- ``shift``: shard i receives the last column of shard i - 1, cyclically;
- ``permute``: the global gather ``out[j] = x[perm[j]]``;
- ``sum``: the sum of every shard's value (the OODS partial contractions);
- ``full``: the whole array in every process (the last FRI layer);
- ``gather_many``: the values at some positions of any number of arrays,
  on the host in every process, in one pass (the decommitment's reads,
  ``core/merkle.serve``): one device->host pull, and on the process mesh
  one ``all_reduce``;
- ``pad``: a zero-padded copy, each chunk moved to the shard that owns its
  positions.

Inside a recording (``tracing.record``) each collective is a span
``mesh.<op>``, counted in the counter of that name, and the process mesh
adds the bytes of every payload it hands to ``torch.distributed`` to the
counter ``mesh.bytes`` (a one-process mesh copies between its shards and
counts none).

Shards may share a device (D shards on one card, or on the CPU): then
``t.to(device)`` returns the same tensor, so every collective builds a
new list of shards and none updates a shard in place.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as tdist

from .. import tracing
from ..core import merkle


def collective(op: str):
    """A mesh method as the span `mesh.<op>`, counted once a call."""
    name = "mesh." + op

    def wrap(fn):
        @functools.wraps(fn)
        def traced(*args, **kwargs):
            tracing.count(name)
            with tracing.span(name):
                return fn(*args, **kwargs)
        return traced
    return wrap


def _sent(payload: torch.Tensor) -> None:
    """The bytes this process hands to torch.distributed, in `mesh.bytes`."""
    tracing.count("mesh.bytes", int(payload.nbytes))


class Mesh:
    """D shards, D a power of two. Subclasses give ``size``, ``local``
    (the shards this process owns), ``home`` (this process's device),
    ``device(i)`` (where this process keeps shard i) and the collectives."""

    size: int

    def __post_init__(self):
        d = self.size
        if d < 1 or d & (d - 1):
            raise ValueError(f"a mesh has a power-of-two number of shards, got {d}")

    @property
    def split_log(self) -> int:
        return self.size.bit_length() - 1

    @property
    def local_devices(self) -> set:
        return {self.device(i) for i in self.local}

    def each(self, fn: Callable[[int], torch.Tensor]) -> List[Optional[torch.Tensor]]:
        """[fn(i) for every shard i this process owns, None for the others]."""
        return [fn(i) if i in self.local else None for i in range(self.size)]

    # -- placing arrays ---------------------------------------------------

    def shard(self, x: torch.Tensor) -> "Sharded":
        """Split x (the same in every process) along its last axis into D
        contiguous chunks, chunk i on shard i's device."""
        n = x.shape[-1]
        if n % self.size:
            raise ValueError(f"{n} elements do not split into {self.size} shards")
        c = n // self.size
        return Sharded(self, self.each(
            lambda i: x.narrow(-1, i * c, c).to(self.device(i)).contiguous()))

    def as_sharded(self, x) -> "Sharded":
        return x if isinstance(x, Sharded) else self.shard(x)

    def stack(self, items: Sequence) -> "torch.Tensor | Sharded":
        """torch.stack of equal-shape arrays: a tensor if every item is
        one, else a Sharded array (plain items are sharded first)."""
        if all(isinstance(x, torch.Tensor) for x in items):
            return torch.stack(list(items))
        items = [self.as_sharded(x) for x in items]
        return Sharded(self, self.each(lambda i: torch.stack([x.shards[i] for x in items])))

    @collective("pad")
    def pad(self, x, log_size: int) -> "Sharded":
        """x (a tensor or a Sharded array, 2^k elements on its last axis)
        zero-padded to 2^log_size elements and sharded: each chunk moves
        to the shard that owns its positions of the larger array."""
        c = (1 << log_size) // self.size
        if isinstance(x, Sharded):
            spans = [(s, s * x.chunk, x.chunk) for s in range(self.size)]
        else:
            spans = [(None, 0, int(x.shape[-1]))]
        moves = []  # (source shard or None, start in it, destination shard, start in it, length)
        for s, off, n in spans:
            pos, end = off, off + n
            while pos < end:
                j = pos // c
                stop = min(end, (j + 1) * c)
                moves.append((s, pos - off, j, pos - j * c, stop - pos))
                pos = stop
        lead = tuple(x.shape[:-1])
        out = self.each(lambda i: torch.zeros(lead + (c,), dtype=x.dtype, device=self.device(i)))
        self._place(x, moves, out)
        return Sharded(self, out)

    @collective("full")
    def full(self, x) -> torch.Tensor:
        """The whole array on this process's device."""
        return self._concat(x.shards) if isinstance(x, Sharded) else x.to(self.home)

    def _parts(self, reads: "merkle.Reads", replicated: bool) -> list:
        """What this process reads of a batch of gathers: of a sharded
        source, the run of sorted positions each shard it owns holds; of a
        plain one (the same in every process), all of them if
        `replicated`."""
        parts = []
        for j, g in enumerate(reads.gathers):
            if not isinstance(g.source, Sharded):
                if replicated:
                    parts.append(reads.part(j, g.source))
                continue
            c = g.source.chunk
            runs = np.searchsorted(reads.positions[j], np.arange(self.size + 1) * c)
            for i in self.local:
                parts.append(reads.part(j, g.source.shards[i], runs[i], runs[i + 1], i * c))
        return parts


@dataclass(frozen=True)
class DeviceMesh(Mesh):
    """One process over an ordered list of D devices (shard i on
    ``devices[i]``): it owns every shard."""

    devices: Tuple[torch.device, ...]

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def local(self) -> range:
        return range(self.size)

    @property
    def home(self) -> torch.device:
        return self.devices[0]

    def device(self, i: int) -> torch.device:
        return self.devices[i]

    def _place(self, x, moves, out) -> None:
        for s, s0, j, d0, n in moves:
            src = x if s is None else x.shards[s]
            out[j][..., d0:d0 + n] = src[..., s0:s0 + n].to(self.devices[j])

    def _concat(self, shards) -> torch.Tensor:
        return torch.cat([s.to(self.home) for s in shards], dim=-1)

    # -- collectives over per-shard tensors --------------------------------

    @collective("all_gather")
    def all_gather(self, shards: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """Every shard's value stacked (D, ...) on every shard's device."""
        return [torch.stack([s.to(dev) for s in shards]) for dev in self.devices]

    @collective("exchange")
    def exchange(self, shards: Sequence[torch.Tensor], dist: int,
                 out: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """Shard i receives shard i ^ dist into out[i] (a buffer of that
        shape on shard i's device). Every shard's value is read before any
        is written."""
        for i in range(self.size):
            out[i].copy_(shards[i ^ dist])
        return list(out)

    @collective("shift")
    def shift(self, shards: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """Shard i receives the last column of shard i - 1 (shard 0 that
        of shard D - 1)."""
        return [shards[i - 1][..., -1:].to(dev) for i, dev in enumerate(self.devices)]

    @collective("permute")
    def permute(self, shards: Sequence[torch.Tensor], perm) -> List[torch.Tensor]:
        """The global gather out[j] = x[perm[j]] over the concatenated
        shards. `perm` is a global index tensor or its Permutation."""
        if not isinstance(perm, Permutation):
            perm = Permutation(self, perm)
        out = []
        for i, dev in enumerate(self.devices):
            o = torch.empty(tuple(shards[i].shape[:-1]) + (perm.chunk,),
                            dtype=shards[i].dtype, device=dev)
            for s, dst, src in perm.moves[i]:
                o[..., dst] = shards[s][..., src].to(dev)
            out.append(o)
        return out

    @collective("sum")
    def sum(self, shards: Sequence[torch.Tensor]) -> torch.Tensor:
        """The sum of every shard's value, on this process's device."""
        return sum(s.to(self.home) for s in shards)

    @collective("gather_many")
    def gather_many(self, gathers: Sequence["merkle.Gather"]) -> List[np.ndarray]:
        """Every gather's values on the host (a sharded source's positions
        read on the shards that own them): one copy a device to `home`,
        one device->host pull."""
        with tracing.span("decommit.layout"):
            reads = merkle.Reads(gathers)
        return reads.collect(self._parts(reads, replicated=True), self.home)


@dataclass(frozen=True)
class ProcessGroupMesh(Mesh):
    """One shard per process of the default ``torch.distributed`` process
    group (shard i = rank i, D = world size): this process owns shard
    `rank` on `home`. Under NCCL, CUDA tensors go to the collectives as
    they are; under gloo, payloads are staged through host memory."""

    size: int
    rank: int
    home: torch.device
    backend: str

    @property
    def local(self) -> Tuple[int]:
        return (self.rank,)

    def device(self, i: int) -> torch.device:
        return self.home

    @property
    def _wire(self) -> torch.device:
        """Where payloads travel: host memory under gloo, the card under NCCL."""
        return torch.device("cpu") if self.backend == "gloo" else self.home

    def _stage(self, x: torch.Tensor) -> torch.Tensor:
        return x.to(self._wire).contiguous()

    def _gather_list(self, x: torch.Tensor) -> List[torch.Tensor]:
        x = self._stage(x)
        parts = [torch.empty_like(x) for _ in range(self.size)]
        _sent(x)
        tdist.all_gather(parts, x)
        return [p.to(self.home) for p in parts]

    def _sendrecv(self, x: torch.Tensor, to: int, frm: int, out: torch.Tensor) -> torch.Tensor:
        """Send x to rank `to` while receiving a tensor of x's shape from
        rank `frm` into `out`, a contiguous buffer on this process's device
        (under NCCL the receive lands there; under gloo it is staged through
        host memory). Returns `out`."""
        if to == self.rank and frm == self.rank:
            return out.copy_(x)
        x = self._stage(x)
        buf = out if out.device == x.device else torch.empty_like(x)
        _sent(x)
        for req in tdist.batch_isend_irecv([tdist.P2POp(tdist.isend, x, to),
                                           tdist.P2POp(tdist.irecv, buf, frm)]):
            req.wait()
        return out if buf is out else out.copy_(buf)

    def _all_to_all(self, sends: List[torch.Tensor], recv_counts: List[int]) -> List[torch.Tensor]:
        """sends[d] (lead..., k_d) goes to rank d; returns what each rank
        sent here, (lead..., recv_counts[s]) from rank s. One
        all_to_all_single over the element axis moved first."""
        inp = self._stage(torch.cat([s.movedim(-1, 0) for s in sends], dim=0))
        out = torch.empty((sum(recv_counts),) + tuple(inp.shape[1:]), dtype=inp.dtype,
                          device=inp.device)
        _sent(inp)
        tdist.all_to_all_single(out, inp, output_split_sizes=recv_counts,
                               input_split_sizes=[int(s.shape[-1]) for s in sends])
        return [p.movedim(0, -1).to(self.home) for p in torch.split(out, recv_counts, dim=0)]

    def _place(self, x, moves, out) -> None:
        me = self.rank
        o = out[me]
        if not isinstance(x, Sharded):  # the same input in every process: no traffic
            for _, s0, j, d0, n in moves:
                if j == me:
                    o[..., d0:d0 + n] = x[..., s0:s0 + n].to(self.home)
            return
        mine = x.shards[me]
        sends = [mine[..., :0]] * self.size
        counts = [0] * self.size
        lands = []  # (source rank, destination start, length) of what arrives here
        for s, s0, j, d0, n in moves:
            if s == me:
                sends[j] = torch.cat([sends[j], mine[..., s0:s0 + n]], dim=-1)
            if j == me:
                lands.append((s, d0, n))
                counts[s] += n
        got = self._all_to_all(sends, counts)
        taken = [0] * self.size
        for s, d0, n in lands:
            o[..., d0:d0 + n] = got[s][..., taken[s]:taken[s] + n]
            taken[s] += n

    def _concat(self, shards) -> torch.Tensor:
        return torch.cat(self._gather_list(shards[self.rank]), dim=-1)

    # -- collectives over per-shard tensors --------------------------------

    def _only(self, value: torch.Tensor) -> List[Optional[torch.Tensor]]:
        out = [None] * self.size
        out[self.rank] = value
        return out

    @collective("all_gather")
    def all_gather(self, shards: Sequence[torch.Tensor]) -> List[Optional[torch.Tensor]]:
        return self._only(torch.stack(self._gather_list(shards[self.rank])))

    @collective("exchange")
    def exchange(self, shards: Sequence[torch.Tensor], dist: int,
                 out: Sequence[Optional[torch.Tensor]]) -> List[Optional[torch.Tensor]]:
        peer = self.rank ^ dist
        return self._only(self._sendrecv(shards[self.rank], peer, peer, out[self.rank]))

    @collective("shift")
    def shift(self, shards: Sequence[torch.Tensor]) -> List[Optional[torch.Tensor]]:
        r, d = self.rank, self.size
        last = shards[r][..., -1:]
        return self._only(self._sendrecv(last, (r + 1) % d, (r - 1) % d,
                                         torch.empty(last.shape, dtype=last.dtype,
                                                     device=self.home)))

    @collective("permute")
    def permute(self, shards: Sequence[torch.Tensor], perm) -> List[Optional[torch.Tensor]]:
        if not isinstance(perm, Permutation):
            perm = Permutation(self, perm)
        me = self.rank
        x = shards[me]
        sends = [x[..., perm.sends[d]] if d in perm.sends else x[..., :0]
                 for d in range(self.size)]
        counts = [0] * self.size
        for s, dst, _ in perm.moves[me]:
            if s != me:
                counts[s] = int(dst.numel())
        got = self._all_to_all(sends, counts)
        o = torch.empty(tuple(x.shape[:-1]) + (perm.chunk,), dtype=x.dtype, device=self.home)
        for s, dst, src in perm.moves[me]:
            o[..., dst] = x[..., src] if s == me else got[s]
        return self._only(o)

    def _all_reduce(self, x: torch.Tensor) -> None:
        _sent(x)
        tdist.all_reduce(x)

    @collective("sum")
    def sum(self, shards: Sequence[torch.Tensor]) -> torch.Tensor:
        x = self._stage(shards[self.rank]).clone()
        self._all_reduce(x)
        return x.to(self.home)

    @collective("gather_many")
    def gather_many(self, gathers: Sequence["merkle.Gather"]) -> List[np.ndarray]:
        """Every gather's values on the host, the same in every process:
        each process writes the positions its shard owns (rank 0 also the
        gathers of plain arrays, which every process holds alike) into a
        zeroed buffer, and one all_reduce sums them (exact: one term a slot
        is non-zero). One device->host pull."""
        with tracing.span("decommit.layout"):
            reads = merkle.Reads(gathers)
        buf = torch.zeros(reads.total, dtype=reads.dtype, device=self.home)
        with tracing.span("decommit.gather"):
            reads.gather_into(self._parts(reads, replicated=self.rank == 0), buf)
        if self.backend == "gloo":
            host = torch.from_numpy(merkle.pull(buf))
            self._all_reduce(host)
            return reads.place(host.numpy())
        self._all_reduce(buf)
        return reads.place(merkle.pull(buf))


class Permutation:
    """A global index permutation split into per-shard moves. For each
    destination shard i this process owns, ``moves[i]`` lists (source shard
    s, positions in shard i, positions in shard s); for the destinations
    other processes own, ``sends[d]`` holds the positions of this process's
    shard that go there, in the order shard d places them."""

    def __init__(self, mesh: Mesh, perm: torch.Tensor):
        n = perm.numel()
        if n % mesh.size:
            raise ValueError(f"a permutation of {n} does not split into {mesh.size} shards")
        self.chunk = c = n // mesh.size
        self.moves = {}
        self.sends = {}
        for i in range(mesh.size):
            p = perm[i * c:(i + 1) * c].to(torch.int64)
            src = p // c
            order = torch.argsort(src, stable=True)
            counts = torch.bincount(src, minlength=mesh.size).tolist()
            moves, start = [], 0
            for s, k in enumerate(counts):
                if k:
                    sel = order[start:start + k]
                    if i in mesh.local:
                        moves.append((s, sel.to(mesh.device(i)), (p[sel] % c).to(mesh.device(s))))
                    elif s in mesh.local:
                        self.sends[i] = (p[sel] % c).to(mesh.device(s))
                start += k
            if i in mesh.local:
                self.moves[i] = moves


class Sharded:
    """An array split along its last axis into contiguous chunks, chunk i
    on the mesh's shard i (None where another process owns it). The
    consumers outside the mesh backend read it through ``rows``,
    ``gather`` and ``full``."""

    def __init__(self, mesh: Mesh, shards: List[Optional[torch.Tensor]]):
        if len(shards) != mesh.size:
            raise ValueError(f"{len(shards)} shards for a mesh of {mesh.size}")
        self.mesh = mesh
        self.shards = list(shards)

    @property
    def _first(self) -> torch.Tensor:
        return self.shards[self.mesh.local[0]]

    @property
    def chunk(self) -> int:
        return int(self._first.shape[-1])

    @property
    def shape(self) -> tuple:
        return tuple(self._first.shape[:-1]) + (self.chunk * self.mesh.size,)

    @property
    def dtype(self) -> torch.dtype:
        return self._first.dtype

    def rows(self, j: int) -> "Sharded":
        """Row j of a (C, N) array, as an (N,) Sharded array of views."""
        return Sharded(self.mesh, self.mesh.each(lambda i: self.shards[i][j]))

    def gather(self, positions: Sequence[int]) -> torch.Tensor:
        """x[..., positions] as a CPU tensor, the same in every process
        (one read of Mesh.gather_many)."""
        return torch.from_numpy(self.mesh.gather_many([merkle.Gather(self, positions)])[0])

    def full(self) -> torch.Tensor:
        """The concatenated array on this process's device."""
        return self.mesh.full(self)


def make_mesh(n_devices: Optional[int] = None, device="cuda") -> DeviceMesh:
    """A one-process mesh of `n_devices` shards (default: one per visible
    device of that type) over the visible devices of `device`'s type,
    round robin: on one card every shard is on cuda:0, on the CPU every
    shard is on cpu. An indexed device ("cuda:1") holds every shard. A CUDA
    mesh without a card raises."""
    from ..air import canonical_device

    dev = canonical_device(device)
    if dev.type == "cuda":
        visible = ([dev] if torch.device(device).index is not None else
                   [torch.device("cuda", k) for k in range(torch.cuda.device_count())])
    elif dev.type == "cpu":
        visible = [dev]
    else:
        raise ValueError(f"mesh on {device}: unsupported device type")
    n = len(visible) if n_devices is None else n_devices
    return DeviceMesh(tuple(visible[i % len(visible)] for i in range(n)))
