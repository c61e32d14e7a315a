"""Blake2s Fiat-Shamir channel (host side).

Counterpart of ``stwo_brainfuck_tpu/core/channel.py`` (stwo's
``Blake2sChannel``). The transcript is tiny and strictly sequential, so it
runs on the host with hashlib.blake2s; the torch Blake2s (core/blake2s.py)
is bit-identical. Only a PoW grind above 2^13 expected hashes runs on a
device: on a CUDA device the grind kernel (ops/blake2s_kernels.py), on the
CPU batches of nonces hashed by the plain torch Blake2s.

Transcript rules (self-consistent; both prover and verifier call the same
methods in the same order):
- mix_*: digest <- blake2s(digest || data), draw counter resets;
- draw_*: stream blocks blake2s(digest || counter_le8), counter increments.
"""

from __future__ import annotations

import hashlib
import struct
from typing import List, Sequence, Tuple

import numpy as np
import torch

from . import blake2s
from .m31 import P_INT

QM31 = Tuple[int, int, int, int]


def _blake(data: bytes) -> bytes:
    return hashlib.blake2s(data).digest()


class Blake2sChannel:
    def __init__(self, device="cpu"):
        self.digest = bytes(32)
        self._counter = 0
        self.device = device  # where a large PoW grind runs

    # -- mixing ------------------------------------------------------------

    def mix_bytes(self, data: bytes) -> None:
        self.digest = _blake(self.digest + data)
        self._counter = 0

    def mix_root(self, root: bytes) -> None:
        assert len(root) == 32
        self.mix_bytes(root)

    def mix_u32s(self, values: Sequence[int]) -> None:
        self.mix_bytes(b"".join(struct.pack("<I", v & 0xFFFFFFFF) for v in values))

    def mix_u64(self, value: int) -> None:
        self.mix_bytes(struct.pack("<Q", value & 0xFFFFFFFFFFFFFFFF))

    def mix_felts(self, felts: Sequence[QM31]) -> None:
        self.mix_u32s([c for f in felts for c in f])

    # -- drawing -----------------------------------------------------------

    def _draw_block(self) -> bytes:
        out = _blake(self.digest + struct.pack("<Q", self._counter))
        self._counter += 1
        return out

    def draw_words(self, n: int) -> List[int]:
        words: List[int] = []
        while len(words) < n:
            block = self._draw_block()
            words.extend(struct.unpack("<8I", block))
        return words[:n]

    def draw_felt(self) -> QM31:
        w = self.draw_words(4)
        return tuple(v % P_INT for v in w)  # type: ignore[return-value]

    def draw_felts(self, n: int) -> List[QM31]:
        return [self.draw_felt() for _ in range(n)]

    def draw_queries(self, n_queries: int, log_domain_size: int) -> List[int]:
        """Exactly min(n_queries, domain) DISTINCT positions in
        [0, 2^log_domain_size), sorted. Keeps drawing until the target count
        is reached, so a duplicate draw never silently shrinks the query set
        (and with it the soundness margin)."""
        mask = (1 << log_domain_size) - 1
        target = min(n_queries, 1 << log_domain_size)
        positions: set = set()
        while len(positions) < target:
            for w in self.draw_words(8):
                positions.add(w & mask)
                if len(positions) >= target:
                    break
        return sorted(positions)

    # -- proof of work -----------------------------------------------------

    def check_pow_nonce(self, pow_bits: int, nonce: int) -> bool:
        return _check_pow(self.digest, pow_bits, nonce)

    def grind_pow(self, pow_bits: int) -> int:
        """Smallest valid nonce. Small grinds run on the host; beyond 2^13
        expected hashes the search runs on self.device."""
        if pow_bits <= 13:
            nonce = 0
            while not self.check_pow_nonce(pow_bits, nonce):
                nonce += 1
            return nonce
        return _device_grind(self.digest, pow_bits, self.device)


def _check_pow(digest: bytes, pow_bits: int, nonce: int) -> bool:
    h = _blake(digest + struct.pack("<Q", nonce))
    v = struct.unpack("<I", h[:4])[0]
    return (v & ((1 << pow_bits) - 1)) == 0


_POW_BATCH_LOG = 17


def _device_grind(digest: bytes, pow_bits: int, device) -> int:
    """Smallest nonce whose hash has pow_bits low zero bits (40-byte
    messages digest || nonce_le8): the grind kernel on a CUDA device, else
    the plain torch Blake2s on 2^17 nonces a batch. The answer is checked
    with hashlib."""
    if torch.device(device).type == "cuda":
        from ..ops import blake2s_kernels

        found = blake2s_kernels.KERNELS.grind(digest, pow_bits, device)
    else:
        found = _plain_grind(digest, pow_bits, device)
    if not _check_pow(digest, pow_bits, found):
        raise RuntimeError("device PoW grind disagrees with hashlib")
    return found


def _plain_grind(digest: bytes, pow_bits: int, device) -> int:
    batch = 1 << _POW_BATCH_LOG
    mask = (1 << pow_bits) - 1
    dw = torch.as_tensor(np.frombuffer(digest, dtype="<u4").astype(np.int64),
                         device=device)
    offs = torch.arange(batch, dtype=torch.int64, device=device)
    base = 0
    while base < 1 << 48:  # unreachable for sane pow_bits
        nonce = base + offs
        msg = torch.cat([dw[:, None].expand(8, batch),
                         (nonce & blake2s.MASK)[None], (nonce >> 32)[None]])
        ok = (blake2s.hash_parts([msg], n_bytes=40)[0] & mask) == 0
        hits = torch.nonzero(ok)
        if hits.numel():
            return base + int(hits[0, 0])
        base += batch
    raise RuntimeError("PoW grind exhausted")
