"""A mesh of torch devices for multi-device proving, its collectives, and
the sharded-array type.

Counterpart of ``stwo_brainfuck_tpu/parallel/mesh.py``. The sharding axis
is trace ROWS: an array is split along its last axis into D contiguous
chunks, chunk i on ``mesh.devices[i]``. The JAX package's prover is one
program over a ``jax.sharding.Mesh``; here one process drives an ordered
list of D devices, so the body of each JAX ``shard_map`` becomes a loop
over shards whose work runs on each shard's device, and the
collectives it uses are explicit copies between per-shard tensors:

- ``all_gather``: every shard receives the stack of all shards' values;
- ``exchange``: shard i receives shard i ^ dist (the FFT's cross stages);
- ``shift``: shard i receives the last column of shard i - 1, cyclically;
- ``permute``: the global gather ``out[j] = x[perm[j]]``.

Shards may share a device (D shards on one card, or on the CPU): then
``t.to(device)`` returns the same tensor, so every collective builds a
new list of shards and none updates a shard in place.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import torch


@dataclass(frozen=True)
class Mesh:
    """An ordered list of D devices, D a power of two (shard i on
    ``devices[i]``)."""

    devices: Tuple[torch.device, ...]

    def __post_init__(self):
        d = len(self.devices)
        if d < 1 or d & (d - 1):
            raise ValueError(f"a mesh has a power-of-two number of shards, got {d}")

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def split_log(self) -> int:
        return self.size.bit_length() - 1

    # -- placing arrays ---------------------------------------------------

    def shard(self, x: torch.Tensor) -> "Sharded":
        """Split x along its last axis into D contiguous chunks, chunk i on
        device i."""
        n = x.shape[-1]
        if n % self.size:
            raise ValueError(f"{n} elements do not split into {self.size} shards")
        c = n // self.size
        return Sharded(self, [x.narrow(-1, i * c, c).to(dev).contiguous()
                              for i, dev in enumerate(self.devices)])

    def as_sharded(self, x) -> "Sharded":
        return x if isinstance(x, Sharded) else self.shard(x)

    def full(self, x) -> torch.Tensor:
        """The whole array on the first device."""
        return x.full() if isinstance(x, Sharded) else x.to(self.devices[0])

    def stack(self, items: Sequence) -> "torch.Tensor | Sharded":
        """torch.stack of equal-shape arrays: a tensor if every item is
        one, else a Sharded array (plain items are sharded first)."""
        if all(isinstance(x, torch.Tensor) for x in items):
            return torch.stack(list(items))
        items = [self.as_sharded(x) for x in items]
        return Sharded(self, [torch.stack([x.shards[i] for x in items])
                              for i in range(self.size)])

    def pad(self, x, log_size: int) -> "Sharded":
        """x (a tensor or a Sharded array, 2^k elements on its last axis)
        zero-padded to 2^log_size elements and sharded: each chunk moves
        to the shard that owns its positions of the larger array."""
        pieces = ([(i * x.chunk, s) for i, s in enumerate(x.shards)]
                  if isinstance(x, Sharded) else [(0, x)])
        c = (1 << log_size) // self.size
        lead = tuple(pieces[0][1].shape[:-1])
        out = [torch.zeros(lead + (c,), dtype=pieces[0][1].dtype, device=dev)
               for dev in self.devices]
        for off, t in pieces:
            pos, end = off, off + t.shape[-1]
            while pos < end:
                j = pos // c
                stop = min(end, (j + 1) * c)
                out[j][..., pos - j * c: stop - j * c] = \
                    t[..., pos - off: stop - off].to(self.devices[j])
                pos = stop
        return Sharded(self, out)

    # -- collectives over per-shard tensors --------------------------------

    def all_gather(self, shards: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """Every shard's value stacked (D, ...) on every shard's device."""
        return [torch.stack([s.to(dev) for s in shards]) for dev in self.devices]

    def exchange(self, shards: Sequence[torch.Tensor], dist: int) -> List[torch.Tensor]:
        """Shard i receives shard i ^ dist."""
        return [shards[i ^ dist].to(dev) for i, dev in enumerate(self.devices)]

    def shift(self, shards: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """Shard i receives the last column of shard i - 1 (shard 0 that
        of shard D - 1)."""
        return [shards[i - 1][..., -1:].to(dev) for i, dev in enumerate(self.devices)]

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


class Permutation:
    """A global index permutation split into per-shard moves: for
    destination shard i, a list of (source shard s, positions in shard i,
    positions in shard s), each index tensor on the device it indexes."""

    def __init__(self, mesh: Mesh, perm: torch.Tensor):
        n = perm.numel()
        if n % mesh.size:
            raise ValueError(f"a permutation of {n} does not split into {mesh.size} shards")
        self.chunk = c = n // mesh.size
        self.moves = []
        for i, dev in enumerate(mesh.devices):
            p = perm[i * c:(i + 1) * c].to(torch.int64)
            src = p // c
            order = torch.argsort(src, stable=True)
            counts = torch.bincount(src, minlength=mesh.size).tolist()
            moves, start = [], 0
            for s, k in enumerate(counts):
                if k:
                    sel = order[start:start + k]
                    moves.append((s, sel.to(dev), (p[sel] % c).to(mesh.devices[s])))
                start += k
            self.moves.append(moves)


class Sharded:
    """An array split along its last axis into contiguous chunks, chunk i
    on the mesh's device i. The consumers outside the mesh backend read it
    through ``rows``, ``gather`` and ``full``."""

    def __init__(self, mesh: Mesh, shards: List[torch.Tensor]):
        if len(shards) != mesh.size:
            raise ValueError(f"{len(shards)} shards for a mesh of {mesh.size}")
        self.mesh = mesh
        self.shards = list(shards)

    @property
    def chunk(self) -> int:
        return int(self.shards[0].shape[-1])

    @property
    def shape(self) -> tuple:
        return tuple(self.shards[0].shape[:-1]) + (self.chunk * self.mesh.size,)

    @property
    def dtype(self) -> torch.dtype:
        return self.shards[0].dtype

    def rows(self, j: int) -> "Sharded":
        """Row j of a (C, N) array, as an (N,) Sharded array of views."""
        return Sharded(self.mesh, [s[j] for s in self.shards])

    def gather(self, positions: Sequence[int]) -> torch.Tensor:
        """x[..., positions] as a CPU tensor (the decommitment's reads)."""
        pos = torch.as_tensor(list(positions), dtype=torch.int64)
        out = torch.empty(self.shape[:-1] + (pos.numel(),), dtype=self.dtype)
        owner = pos // self.chunk
        for i, s in enumerate(self.shards):
            sel = torch.nonzero(owner == i).flatten()
            if sel.numel():
                local = (pos[sel] % self.chunk).to(s.device)
                out[..., sel] = s[..., local].cpu()
        return out

    def full(self, device: Optional[torch.device] = None) -> torch.Tensor:
        """The concatenated array on `device` (default: the first device)."""
        dev = self.mesh.devices[0] if device is None else device
        return torch.cat([s.to(dev) for s in self.shards], dim=-1)


def make_mesh(n_devices: Optional[int] = None, device="cuda") -> Mesh:
    """A mesh of `n_devices` shards (default: one per visible device of
    that type) over the visible devices of `device`'s type, round robin:
    on one card every shard is on cuda:0, on the CPU every shard is on
    cpu. A CUDA mesh without a card raises."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"mesh on {device}: no CUDA device is available")
        visible = ([dev] if dev.index is not None else
                   [torch.device("cuda", k) for k in range(torch.cuda.device_count())])
    elif dev.type == "cpu":
        visible = [torch.device("cpu")]
    else:
        raise ValueError(f"mesh on {device}: unsupported device type")
    n = len(visible) if n_devices is None else n_devices
    return Mesh(tuple(visible[i % len(visible)] for i in range(n)))
