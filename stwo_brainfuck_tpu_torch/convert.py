"""Conversions between the JAX package's arrays (numpy uint32) and the
port's tensors.

- M31 arrays: uint32 <-> int32 tensors (canonical values < 2^31 fit).
- QM31 arrays: the same, with the leading axis of 4 coordinates in both.
- Blake2s digests: the JAX package keeps (..., 8) uint32 word rows; the
  port keeps (8, N) int32 bit patterns (word-leading).
"""

from __future__ import annotations

import numpy as np
import torch


def to_torch(arr, device="cpu") -> torch.Tensor:
    """M31/QM31 uint32 array -> int32 tensor (values must be < 2^31)."""
    a = np.asarray(arr)
    if a.size and int(a.max()) >= 1 << 31:
        raise ValueError("M31 values must be < 2^31")
    return torch.as_tensor(a.astype(np.int32), device=device)


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """M31/QM31 tensor (int32 or canonical int64) -> uint32 array."""
    return t.detach().cpu().to(torch.int64).numpy().astype(np.uint32)


def digests_to_torch(words, device="cpu") -> torch.Tensor:
    """(N, 8) uint32 digest rows -> (8, N) int32 bit patterns."""
    a = np.ascontiguousarray(np.asarray(words, np.uint32).reshape(-1, 8).T)
    return torch.as_tensor(a.view(np.int32), device=device)


def digests_to_numpy(t: torch.Tensor) -> np.ndarray:
    """(8, N) digest words (any int dtype, 32-bit patterns) -> (N, 8) uint32."""
    a = t.detach().cpu().to(torch.int64).numpy() & 0xFFFFFFFF
    return np.ascontiguousarray(a.T.astype(np.uint32))
