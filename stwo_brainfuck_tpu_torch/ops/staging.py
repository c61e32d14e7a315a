"""Pinned host staging for the kernels' small launch tables.

A wrapper packs a launch's pointers and constants on the host and copies
them to the card with one non-blocking copy, which needs pinned memory.
``PinnedRing`` keeps a few pinned buffers a device and hands them out in
turn, so a call writes into memory that is already pinned (no
``pin_memory()`` a call). A buffer is written again only after the copy
made from it has run: the ring records an event behind each copy and waits
on it before the buffer's next use, ``SLOTS`` calls later: the host waits
only when the card is that many of these copies behind it.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

SLOTS = 8


class PinnedRing:
    """SLOTS pinned int32 buffers a device, each grown to the largest table
    it has carried, and the event of its last copy."""

    def __init__(self):
        self._slots: Dict[torch.device, List[list]] = {}
        self._next: Dict[torch.device, int] = {}

    def to_card(self, words: np.ndarray, dev: torch.device) -> torch.Tensor:
        """The uint32 / int32 `words` as an int32 tensor on `dev` (a CUDA
        device, which must be current), copied from a pinned buffer with
        one non-blocking copy on the current stream."""
        words = np.ascontiguousarray(words).view(np.int32)
        slots = self._slots.setdefault(dev, [[None, None] for _ in range(SLOTS)])
        k = self._next.get(dev, 0)
        self._next[dev] = (k + 1) % SLOTS
        slot = slots[k]
        if slot[1] is not None and not slot[1].query():
            slot[1].synchronize()
        if slot[0] is None or slot[0].numel() < words.size:
            slot[0] = torch.empty(max(words.size, 256), dtype=torch.int32, pin_memory=True)
        host = slot[0][:words.size]
        host.numpy()[:] = words
        out = host.to(dev, non_blocking=True)
        slot[1] = torch.cuda.Event()
        slot[1].record(torch.cuda.current_stream(dev))
        return out
