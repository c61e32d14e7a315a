"""Pinned host staging for the kernels' small launch tables.

A wrapper packs a launch's pointers and constants on the host and copies
them to the card with one non-blocking copy, which needs pinned memory.
``PinnedRing`` keeps a few pinned buffers a device and hands them out in
turn, so a call writes into memory that is already pinned (no
``pin_memory()`` a call). A buffer is written again only after the copy
made from it has run: the ring records an event behind each copy and waits
on it before the buffer's next use, ``SLOTS`` calls later: the host waits
only when the card is that many of these copies behind it. ``stage`` writes
several arrays into one buffer back to back, so a bulk upload (the table
build's trace) is one copy too; such a ring keeps fewer slots.
"""

from __future__ import annotations

import warnings
from typing import Dict, List

import numpy as np
import torch

from .. import tracing

SLOTS = 8


class PinnedRing:
    """`slots` pinned int32 buffers a device, each grown to the largest
    table it has carried, and the event of its last copy."""

    def __init__(self, slots: int = SLOTS):
        self.slots = slots
        self._slots: Dict[torch.device, List[list]] = {}
        self._next: Dict[torch.device, int] = {}

    def to_card(self, words: np.ndarray, dev: torch.device) -> torch.Tensor:
        """The uint32 / int32 `words` as an int32 tensor on `dev` (a CUDA
        device, which must be current), copied from a pinned buffer with
        one non-blocking copy on the current stream."""
        return self.stage([words], dev)

    def stage(self, parts: List[np.ndarray], dev: torch.device) -> torch.Tensor:
        """The uint32 / int32 arrays `parts`, each flattened, back to back
        as one int32 tensor on `dev` (a CUDA device, which must be
        current): written into one pinned buffer, copied with one
        non-blocking copy on the current stream."""
        parts = [np.ascontiguousarray(p).reshape(-1).view(np.int32) for p in parts]
        size = sum(p.size for p in parts)
        slots = self._slots.setdefault(dev, [[None, None] for _ in range(self.slots)])
        k = self._next.get(dev, 0)
        self._next[dev] = (k + 1) % self.slots
        slot = slots[k]
        if slot[1] is not None and not slot[1].query():
            with tracing.sync("staging"):
                slot[1].synchronize()
        if slot[0] is None or slot[0].numel() < size:
            slot[0] = torch.empty(max(size, 256), dtype=torch.int32, pin_memory=True)
        host = slot[0][:size]
        off = 0
        with warnings.catch_warnings():  # a read-only array is only read here
            warnings.filterwarnings("ignore", "The given NumPy array is not writable")
            for p in parts:  # torch's copy runs on several threads
                host[off:off + p.size].copy_(torch.from_numpy(p))
                off += p.size
        out = host.to(dev, non_blocking=True)
        slot[1] = torch.cuda.Event()
        slot[1].record(torch.cuda.current_stream(dev))
        return out
